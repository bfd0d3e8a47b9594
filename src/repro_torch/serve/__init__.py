"""Serving-side pieces of the port: atomic snapshot file I/O (``snapshot``)."""

from repro_torch.serve.snapshot import (  # noqa: F401
    FORMAT_VERSION,
    load_index,
    load_sidecar,
    publish_snapshot,
    save_index,
    segment_dir,
    snapshot_bytes,
    write_segmented_manifest,
)
