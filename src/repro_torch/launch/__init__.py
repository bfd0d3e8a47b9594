"""Per-family steps and model FLOPs (reference: ``repro.launch``)."""
