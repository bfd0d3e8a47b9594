"""Test support of the port: deterministic fault injection (``faults``) and
baseline backends with exact integer distances (``exact``)."""
