"""``repro_torch.serve`` — the serving runtime around a built index (reference:
``repro.serve``; DESIGN.md §9, §13, §15).

    snapshot   atomic, format-versioned, checksummed save/load (the
               reference's files, readable by either package)
    engine     SearchEngine: shape-bucketed search per (padded Q-shape ×
               SearchSpec) key, warmup(), QPS/latency/key telemetry with
               the scan/rerank cost split
    runtime    Runtime: continuous-batching scheduler — deadline-ordered
               request queue packed into warm keys, admission control, and
               background copy-on-write index mutation
    admission  AdmissionConfig/AdmissionController: queue-depth rejection,
               deadline shedding, and the SLO bookkeeping behind
               ``Runtime.stats()``
    handle     IndexHandle/Generation: snapshot-swap container — readers pin
               an immutable generation, mutators clone-apply-log-flip (with
               a WAL attached, a mutation is durable before it is acked)
    wal        WalWriter + scan: CRC32-framed append-only mutation log (the
               reference's frames, byte for byte) with group-commit fsync
               batching, rotation, and torn-tail drop
    recovery   init/attach/recover + Checkpointer: boot-time snapshot + WAL
               replay, background checkpointing, init_from_manifest, and
               the ``python -m repro_torch.serve.recovery`` CLI
    router     SegmentRouter: nearest-centroid fan-out over segments, merged
               by the shared two-stage rerank

Quickstart::

    from repro_torch.index import AnnIndex, SearchSpec
    from repro_torch import serve

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    serve.save_index("/var/idx/v1", index)                 # build once …
    index = serve.load_index("/var/idx/v1", device="cuda") # … serve forever
    spec = SearchSpec(k=10, ef=64, rerank="exact")
    engine = serve.SearchEngine(index, spec=spec).warmup()
    res = engine.search(queries)                           # warm keys only
    with serve.Runtime(index, max_queue=256) as rt:        # request traffic
        rt.warmup()
        fut = rt.submit(one_query, deadline_ms=20.0)
        print(fut.result(timeout=1.0).ids)
        rt.add(new_vectors).result(timeout=60.0)           # COW flip

Every entry point runs on the card unless the caller passes
``device="cpu"`` (``load_index``, ``recover``, ``attach``,
``init_from_manifest``) or hands in an index that lies on the CPU.
"""

from repro_torch.graph.rerank import SearchSpec  # noqa: F401 — serving config
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    DeadlineExceededError,
    QueueFullError,
)
from repro_torch.serve.engine import DEFAULT_BUCKETS, SearchEngine  # noqa: F401
from repro_torch.serve.handle import Generation, IndexHandle  # noqa: F401
from repro_torch.serve.recovery import (  # noqa: F401
    Checkpointer,
    RecoveryResult,
    attach,
    recover,
    verify_root,
)
from repro_torch.serve.recovery import init as init_durable  # noqa: F401
from repro_torch.serve.recovery import init_from_manifest  # noqa: F401
from repro_torch.serve.router import SegmentRouter  # noqa: F401
from repro_torch.serve.runtime import Runtime  # noqa: F401
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
from repro_torch.serve.wal import WalRecord, WalWriter, scan as scan_wal  # noqa: F401

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "Checkpointer",
    "DEFAULT_BUCKETS",
    "DeadlineExceededError",
    "FORMAT_VERSION",
    "Generation",
    "IndexHandle",
    "QueueFullError",
    "RecoveryResult",
    "Runtime",
    "SearchEngine",
    "SearchSpec",
    "SegmentRouter",
    "WalRecord",
    "WalWriter",
    "attach",
    "init_durable",
    "init_from_manifest",
    "load_index",
    "load_sidecar",
    "publish_snapshot",
    "recover",
    "save_index",
    "scan_wal",
    "segment_dir",
    "snapshot_bytes",
    "verify_root",
    "write_segmented_manifest",
]
