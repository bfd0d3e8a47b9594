"""Training of the port (reference: ``repro.train``): AdamW, gradient
compression, checkpoints in the reference's format, the train step and
host loop, and the elastic-restart policy. Every function works over the
reference's parameter trees (``repro_torch.utils``'s tree helpers)."""
