"""Architecture registry of the port (``registry.get_arch``)."""
