"""The ambient mesh (reference: ``repro.distributed``)."""
