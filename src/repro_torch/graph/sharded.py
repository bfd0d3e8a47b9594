"""Sharded streaming index construction, in PyTorch (reference:
repro.graph.sharded).

The scale-out layer on top of :class:`repro_torch.graph.segmented.SegmentedAnnIndex`:

  assignment   the dataset streams from host numpy in chunks through
               nearest-centroid routing (``ops.l2_batch`` /
               ``ops.nearest_centroid``, kernel ``csrc/l2_batch.cu`` on the
               card) against a routing table bootstrapped by k-means on a
               reservoir sample. Only one chunk and its (m, S) distance
               block are on the card at a time; per-segment copies exist
               only as append-only spill files (the same raw float32 and
               int64 bytes, file names and ``plan.json`` as the reference's)
  build        every segment builds on the ordinary ``AnnIndex.build``
               path — the same per-segment program (and seed ``seed + s``)
               as ``SegmentedAnnIndex.build`` — inline, one after another,
               or with ``workers > 1`` in a ``spawn`` process pool whose
               workers share the card
  publish      with ``snapshot_path=`` (always, in the pool) every segment
               is saved with ``serve.snapshot.save_index`` into
               ``<path>.tmp/seg_NNN``, the coordinator writes the segmented
               manifest and publishes the whole in one rename; ``attach``
               loads it back. Disk is the worker → coordinator transport.

The mesh mode becomes multi-GPU ``torch.distributed`` work (ROADMAP queue
1, item 7) and raises ``NotImplementedError``; nothing falls back to
inline.

Global id contract: the i-th vector of the stream is global id i; routing
permutes vectors into segments and the coordinator's ``locate`` table maps
ids back.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import shutil
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.index import AnnIndex
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device, sync

#: spill-file names inside a :class:`ShardPlan` directory
_VEC_FMT = "seg_{:03d}.vec"
_GID_FMT = "seg_{:03d}.gid"
_PLAN_JSON = "plan.json"
_CENTROIDS_NPY = "centroids.npy"

_MESH_TODO = (
    "the mesh build (stacked shard_map programs) becomes multi-GPU "
    "torch.distributed work, not ported yet: ROADMAP queue 1, item 7"
)


# ---------------------------------------------------------------------------
# Chunk sources
# ---------------------------------------------------------------------------


def iter_chunks(source, chunk_size: int = 65536):
    """Normalize a dataset source into an iterator of (m, D) float32 chunks.

    ``source`` may be an (n, D) array (sliced lazily), an iterable of
    chunks, or a zero-arg callable returning such an iterable (the
    re-iterable form the two assignment passes need)."""
    if callable(source):
        source = source()
    if hasattr(source, "shape") and hasattr(source, "__getitem__"):
        n = int(source.shape[0])
        for i in range(0, n, chunk_size):
            yield np.asarray(source[i : i + chunk_size], np.float32)
        return
    for chunk in source:
        c = np.asarray(chunk, np.float32)
        if c.ndim == 1:
            c = c[None, :]
        if c.shape[0]:
            yield c


def _require_reiterable(source) -> None:
    if callable(source) or hasattr(source, "shape"):
        return
    raise TypeError(
        "streaming assignment makes two passes (sample, then route); pass "
        "an array or a zero-arg callable that re-creates the chunk "
        "iterator, not a one-shot iterator"
    )


def reservoir_sample(source, sample_size: int, *, seed: int = 0,
                     chunk_size: int = 65536) -> np.ndarray:
    """Uniform sample of ``sample_size`` rows over one streaming pass
    (Vitter's algorithm R, vectorized per chunk), draw for draw the
    reference's."""
    rng = np.random.default_rng(seed)
    sample = None
    seen = 0
    for chunk in iter_chunks(source, chunk_size):
        m = chunk.shape[0]
        if sample is None:
            sample = np.empty((sample_size, chunk.shape[1]), np.float32)
        take = min(m, max(0, sample_size - seen))
        if take:
            sample[seen : seen + take] = chunk[:take]
        if m > take:
            # each remaining row j (global position seen+j) replaces a
            # random reservoir slot with prob sample_size/(seen+j+1)
            pos = seen + np.arange(take, m) + 1
            draw = rng.integers(0, pos)
            hit = draw < sample_size
            rows = np.nonzero(hit)[0] + take
            sample[draw[hit]] = chunk[rows]
        seen += m
    if sample is None:
        raise ValueError("empty source: nothing to sample")
    if seen < sample_size:
        return sample[:seen].copy()
    return sample


def bootstrap_centroids(
    source,
    n_segments: int,
    *,
    sample_size: int = 16384,
    seed: int = 0,
    iters: int = 12,
    chunk_size: int = 65536,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(S, D) routing table: k-means (k-means++ seeding on a
    ``torch.Generator`` seeded with ``seed``, then Lloyd) over a reservoir
    sample of the stream, fitted on ``device``."""
    dev = resolve_device(device)
    sample = reservoir_sample(source, sample_size, seed=seed, chunk_size=chunk_size)
    if sample.shape[0] < n_segments:
        raise ValueError(
            f"sample of {sample.shape[0]} rows cannot seed {n_segments} "
            "segment centroids; raise sample_size or shrink n_segments"
        )
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    centroids, _ = kmeans_fit(gen, torch.from_numpy(sample).to(dev), k=n_segments, iters=iters)
    return centroids.cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Streaming assignment (pass 2): route chunks, spill per-segment files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardPlan:
    """A completed streaming assignment: per-segment spill files + routing
    state (the reference's layout on disk)."""

    spill_dir: str
    n: int
    d: int
    seg_sizes: list
    chunk_size: int
    balanced: bool

    def vec_path(self, s: int) -> str:
        return os.path.join(self.spill_dir, _VEC_FMT.format(s))

    def gid_path(self, s: int) -> str:
        return os.path.join(self.spill_dir, _GID_FMT.format(s))

    @property
    def n_segments(self) -> int:
        return len(self.seg_sizes)

    @property
    def centroids(self) -> np.ndarray:
        return np.load(os.path.join(self.spill_dir, _CENTROIDS_NPY))

    def load_segment(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        """(n_s, D) vectors + (n_s,) global ids of segment ``s``."""
        n_s = int(self.seg_sizes[s])
        vecs = np.fromfile(self.vec_path(s), np.float32).reshape(n_s, self.d)
        gids = np.fromfile(self.gid_path(s), np.int64)
        return vecs, gids

    def global_of(self) -> list:
        return [np.fromfile(self.gid_path(s), np.int64) for s in range(self.n_segments)]

    def locate(self) -> np.ndarray:
        """(N, 2) global id -> (segment, local id), the coordinator table."""
        out = np.empty((self.n, 2), np.int64)
        for s, gids in enumerate(self.global_of()):
            out[gids, 0] = s
            out[gids, 1] = np.arange(gids.shape[0])
        return out

    def save(self) -> str:
        path = os.path.join(self.spill_dir, _PLAN_JSON)
        with open(path, "w") as f:
            json.dump({
                "n": self.n, "d": self.d,
                "seg_sizes": [int(x) for x in self.seg_sizes],
                "chunk_size": self.chunk_size, "balanced": self.balanced,
            }, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, spill_dir: str) -> "ShardPlan":
        with open(os.path.join(spill_dir, _PLAN_JSON)) as f:
            meta = json.load(f)
        return cls(spill_dir=spill_dir, **meta)


def _route_balanced(d2: np.ndarray, remaining: np.ndarray) -> np.ndarray:
    """Capacity-capped greedy routing for one chunk (host numpy).

    Rows go to their nearest centroid; when a segment's remaining capacity
    overflows, the closest rows keep it and the rest fall through to their
    next-nearest open segment. ``remaining`` is mutated (it carries
    capacity across chunks)."""
    m, n_seg = d2.shape
    d2 = d2.copy()
    route = np.full(m, -1, np.int64)
    for _ in range(n_seg):
        undecided = np.nonzero(route < 0)[0]
        if undecided.size == 0:
            return route
        d2[:, remaining <= 0] = np.inf
        best = np.argmin(d2[undecided], axis=1)
        for s in np.unique(best):
            rows = undecided[best == s]
            cap = int(remaining[s])
            if cap >= rows.size:
                route[rows] = s
                remaining[s] -= rows.size
            elif cap > 0:
                order = np.argsort(d2[rows, s], kind="stable")
                route[rows[order[:cap]]] = s
                remaining[s] = 0
    if (route < 0).any():
        raise ValueError(
            "segment capacities exhausted mid-stream: total capacity is "
            "smaller than the dataset"
        )
    return route


def stream_assign(
    source,
    centroids: np.ndarray,
    spill_dir: str,
    *,
    chunk_size: int = 65536,
    balanced: bool = True,
    capacity: int | None = None,
    n_total: int | None = None,
    device: str | torch.device = "cuda",
) -> ShardPlan:
    """Pass 2: route every chunk to its segment, appending to spill files.

    Each chunk goes to ``device``, where one ``l2_batch`` (balanced: the
    (m, S) block then comes back for ``_route_balanced``) or one
    ``nearest_centroid`` (``balanced=False``, pure nearest centroid) routes
    it. ``balanced`` caps every segment at ``capacity`` (default ⌈n/S⌉ from
    ``n_total`` or an array source's length)."""
    dev = resolve_device(device)
    centroids = np.asarray(centroids, np.float32)
    n_seg = centroids.shape[0]
    d = centroids.shape[1]
    os.makedirs(spill_dir, exist_ok=True)
    if balanced:
        if n_total is None and hasattr(source, "shape"):
            n_total = int(source.shape[0])
        if capacity is None:
            if n_total is None:
                raise ValueError(
                    "balanced assignment needs a capacity: pass capacity= "
                    "or n_total= (unknown-length streams), or use an array "
                    "source"
                )
            capacity = -(-n_total // n_seg)
        remaining = np.full(n_seg, int(capacity), np.int64)
    cent_dev = torch.from_numpy(centroids).to(dev)
    vec_files = [open(os.path.join(spill_dir, _VEC_FMT.format(s)), "wb") for s in range(n_seg)]
    gid_files = [open(os.path.join(spill_dir, _GID_FMT.format(s)), "wb") for s in range(n_seg)]
    counts = np.zeros(n_seg, np.int64)
    next_gid = 0
    try:
        for chunk in iter_chunks(source, chunk_size):
            if chunk.shape[1] != d:
                raise ValueError(f"chunk dim {chunk.shape[1]} != centroid dim {d}")
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
            if balanced:
                d2 = ops.l2_batch(x, cent_dev).cpu().numpy()
                route = _route_balanced(d2, remaining)
            else:
                route, _ = ops.nearest_centroid(x, cent_dev)
                route = route.cpu().numpy().astype(np.int64)
            del x
            gids = next_gid + np.arange(chunk.shape[0], dtype=np.int64)
            order = np.argsort(route, kind="stable")
            bounds = np.searchsorted(route[order], np.arange(n_seg + 1))
            for s in range(n_seg):
                rows = order[bounds[s] : bounds[s + 1]]
                if rows.size == 0:
                    continue
                vec_files[s].write(np.ascontiguousarray(chunk[rows]).tobytes())
                gid_files[s].write(gids[rows].tobytes())
                counts[s] += rows.size
            next_gid += chunk.shape[0]
    finally:
        for f in vec_files + gid_files:
            f.close()
    if next_gid == 0:
        raise ValueError("empty source: nothing to assign")
    np.save(os.path.join(spill_dir, _CENTROIDS_NPY), centroids)
    plan = ShardPlan(
        spill_dir=spill_dir, n=int(next_gid), d=int(d),
        seg_sizes=[int(c) for c in counts], chunk_size=int(chunk_size),
        balanced=bool(balanced),
    )
    plan.save()
    return plan


# ---------------------------------------------------------------------------
# One segment's build
# ---------------------------------------------------------------------------


def build_segment_task(task: dict) -> dict:
    """Build one segment from its spill files on ``task["device"]``; runs
    inline or in a pool worker (module level: the spawn pool pickles it).

    With ``task["snapshot_dir"]`` the index leaves as a snapshot saved
    there. Returns the reference's metrics dict (``seg``, ``n_vectors``,
    ``pid``, ``wall_s`` — load, build and save, the card synchronised —,
    ``n_dists``, ``phases``, ``max_rss_mb``, ``snapshot``) plus the build's
    phase ``seconds`` and ``repair_unreachable`` counts, and the built index
    under ``"index"`` when ``keep_index`` is set (inline mode only)."""
    import resource

    dev = resolve_device(task["device"])
    t0 = time.perf_counter()
    n_s, d = int(task["n_s"]), int(task["d"])
    data = np.fromfile(task["vec_path"], np.float32).reshape(n_s, d)
    params = task["params"]
    index = AnnIndex.build(
        data,
        algo=task["algo"],
        backend=task["backend"],
        params=None if params is None else BuildParams(**params),
        seed=int(task["seed"]),
        backend_kwargs=task["backend_kwargs"],
        strategy=task["strategy"],
        device=dev,
        **task["algo_kwargs"],
    )
    snapshot_dir = task.get("snapshot_dir")
    if snapshot_dir is not None:
        from repro_torch.serve.snapshot import save_index  # lazy: avoids a cycle

        save_index(snapshot_dir, index)
    sync(dev)
    stats = index.last_stats
    metrics = {
        "seg": int(task["seg"]),
        "n_vectors": n_s,
        "pid": os.getpid(),
        "wall_s": time.perf_counter() - t0,
        "n_dists": 0.0 if stats is None else float(stats.n_dists),
        "phases": None if stats is None else stats.phase_dict(),
        "max_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "snapshot": snapshot_dir,
        "seconds": None if stats is None else stats.seconds,
        "repair_unreachable": None if stats is None else stats.repair_unreachable,
    }
    if task.get("keep_index"):
        metrics["index"] = index
    return metrics


def _record_segment_obs(m: dict) -> None:
    """Re-emit one segment build's metrics into this process's obs registry
    (a pool worker's spans die with the worker; the dict is the wire
    format)."""
    if not obs.enabled():
        return
    seg, pid = int(m["seg"]), m.get("pid")
    with obs.span("shard/segment", segment=seg, worker=pid, n=int(m["n_vectors"])) as sp:
        sp.add_cost(float(m.get("n_dists") or 0.0))
        sp.set(wall_s=m.get("wall_s"), phases=m.get("phases"), max_rss_mb=m.get("max_rss_mb"))
    obs.tick("shard_segments_built_total")
    obs.tick("shard_segment_vectors_total", n=int(m["n_vectors"]), segment=str(seg),
             worker=str(pid))
    for phase, v in (m.get("phases") or {}).items():
        if v:
            obs.tick("shard_build_dists_total", n=float(v), phase=phase, segment=str(seg))


# ---------------------------------------------------------------------------
# Parallel fan-out helper
# ---------------------------------------------------------------------------

_FANOUT_EXECUTOR = None


def _fanout_executor() -> ThreadPoolExecutor:
    global _FANOUT_EXECUTOR
    if _FANOUT_EXECUTOR is None:
        n = int(os.environ.get("REPRO_FANOUT_THREADS", "8"))
        _FANOUT_EXECUTOR = ThreadPoolExecutor(
            max_workers=max(1, n), thread_name_prefix="repro-fanout"
        )
    return _FANOUT_EXECUTOR


def fanout_map(fn, items, *, parallel: bool = True) -> list:
    """Map ``fn`` over ``items`` on the shared fan-out thread pool (eight
    threads, ``REPRO_FANOUT_THREADS``). Results come back in ``items``'
    order; ``parallel=False`` is a plain loop with the same results. Every
    thread enqueues on the default CUDA stream, so their kernels run one
    after another on the card; the threads overlap the host-side work."""
    items = list(items)
    if not parallel or len(items) <= 1:
        return [fn(item) for item in items]
    return list(_fanout_executor().map(fn, items))


def model_parallel_wall(walls, n_workers: int) -> float:
    """Greedy longest-processing-time schedule: the critical-path wall an
    ``n_workers``-wide pool needs for segments with the given measured
    per-segment build times (a model, for hosts that cannot run the pool
    at that width)."""
    loads = [0.0] * max(1, int(n_workers))
    for w in sorted((float(w) for w in walls), reverse=True):
        i = loads.index(min(loads))
        loads[i] += w
    return max(loads)


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Static configuration of a sharded build (the per-segment build knobs
    are exactly ``AnnIndex.build``'s)."""

    n_segments: int
    chunk_size: int = 65536
    algo: str = "hnsw"
    backend: str = "flash_blocked"
    params: BuildParams | None = None
    strategy: str = "bulk"
    backend_kwargs: dict | None = None
    algo_kwargs: dict | None = None
    seed: int = 0
    balanced: bool = True
    sample_size: int = 16384
    kmeans_iters: int = 12


@dataclasses.dataclass
class ShardedBuildResult:
    index: object  # SegmentedAnnIndex | None (None: published, not attached)
    plan: ShardPlan
    mode: str  # "pool" | "inline"
    snapshot_path: str | None
    segments: list  # per-segment metrics dicts
    wall_assign_s: float
    wall_build_s: float
    n_workers: int


class ShardedBuilder:
    """Streaming assignment + per-segment construction on ``device``.

    ``workers > 1`` runs a ``spawn`` process pool of workers that all build
    on ``device`` (the kernels are built first, in this process); otherwise
    every segment builds inline. ``mesh=`` raises ``NotImplementedError``."""

    def __init__(self, config: ShardConfig, *, workers: int | None = None,
                 mesh=None, workdir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.workers = workers
        self.mesh = mesh
        self.device = resolve_device(device)
        if workdir is None:
            workdir = tempfile.mkdtemp(prefix="repro-shard-")
        self.workdir = workdir
        #: the last ``assign``'s wall seconds by pass
        self.assign_seconds: dict = {}

    # ---- assignment -----------------------------------------------------

    def assign(self, source) -> ShardPlan:
        """Two streaming passes: reservoir sample + k-means bootstrap, then
        chunk routing into per-segment spill files."""
        cfg = self.config
        _require_reiterable(source)
        # the sampling pass streams the whole source, so count it there:
        # balanced routing needs n_total for its capacity
        seen = [0]

        def counted():
            for c in iter_chunks(source, cfg.chunk_size):
                seen[0] += c.shape[0]
                yield c

        with obs.span("shard/assign", segments=cfg.n_segments, chunk=cfg.chunk_size) as sp:
            t0 = time.perf_counter()
            centroids = bootstrap_centroids(
                counted, cfg.n_segments, sample_size=cfg.sample_size, seed=cfg.seed,
                iters=cfg.kmeans_iters, chunk_size=cfg.chunk_size, device=self.device,
            )
            t1 = time.perf_counter()
            plan = stream_assign(
                source, centroids, os.path.join(self.workdir, "spill"),
                chunk_size=cfg.chunk_size, balanced=cfg.balanced, n_total=seen[0],
                device=self.device,
            )
            sp.set(n=plan.n, seg_sizes=plan.seg_sizes)
        self.assign_seconds = {"bootstrap": t1 - t0, "stream": time.perf_counter() - t1}
        return plan

    # ---- build ----------------------------------------------------------

    def build(self, source=None, *, plan: ShardPlan | None = None,
              snapshot_path: str | None = None, attach: bool = True) -> ShardedBuildResult:
        """Assign (unless a ``plan`` is given) and build every segment.

        ``snapshot_path``: publish the build as a segmented snapshot there
        (the pool always publishes, by default under ``workdir/index``);
        ``attach=False`` leaves it on disk and returns ``index=None``."""
        if (source is None) == (plan is None):
            raise ValueError("pass exactly one of source= or plan=")
        if self.mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        pool = self.workers is not None and self.workers > 1
        t0 = time.perf_counter()
        if plan is None:
            plan = self.assign(source)
        wall_assign = time.perf_counter() - t0
        if pool and snapshot_path is None:
            snapshot_path = os.path.join(self.workdir, "index")
        n_workers = int(self.workers) if pool else 1
        with obs.span("shard/build", mode="pool" if pool else "inline", segments=plan.n_segments,
                      n=plan.n, workers=n_workers) as sp:
            t1 = time.perf_counter()
            index, metrics = self._build_local(plan, snapshot_path, pool=pool, attach=attach)
            wall_build = time.perf_counter() - t1
            for m in metrics:
                _record_segment_obs(m)
            sp.set(wall_build_s=wall_build)
            sp.add_cost(sum(m.get("n_dists", 0.0) for m in metrics))
        return ShardedBuildResult(
            index=index, plan=plan, mode="pool" if pool else "inline",
            snapshot_path=None if snapshot_path is None else os.path.abspath(snapshot_path),
            segments=metrics, wall_assign_s=wall_assign, wall_build_s=wall_build,
            n_workers=n_workers,
        )

    # ---- internals ------------------------------------------------------

    def _task(self, plan: ShardPlan, s: int, root: str | None, keep_index: bool) -> dict:
        from repro_torch.serve.snapshot import segment_dir  # lazy: avoids a cycle

        cfg = self.config
        return {
            "seg": s,
            "vec_path": plan.vec_path(s),
            "gid_path": plan.gid_path(s),
            "n_s": int(plan.seg_sizes[s]),
            "d": plan.d,
            "algo": cfg.algo,
            "backend": cfg.backend,
            "params": None if cfg.params is None else dataclasses.asdict(cfg.params),
            "strategy": cfg.strategy,
            "seed": cfg.seed + s,  # SegmentedAnnIndex.build's seed + s
            "backend_kwargs": cfg.backend_kwargs,
            "algo_kwargs": dict(cfg.algo_kwargs or {}),
            "device": str(self.device),
            "snapshot_dir": None if root is None else segment_dir(root, s),
            "keep_index": keep_index,
        }

    def _build_local(self, plan: ShardPlan, snapshot_path: str | None, *, pool: bool, attach: bool):
        from repro_torch.serve import snapshot as snap  # lazy: avoids a cycle

        root_tmp = None
        if snapshot_path is not None:
            snapshot_path = os.path.abspath(snapshot_path)
            root_tmp = snapshot_path + ".tmp"
            if os.path.lexists(root_tmp):
                shutil.rmtree(root_tmp)
            os.makedirs(root_tmp)
        keep = root_tmp is None  # no snapshot: the indexes come back in memory
        tasks = [self._task(plan, s, root_tmp, keep_index=keep and not pool)
                 for s in range(plan.n_segments)]
        if pool:
            if self.device.type == "cuda":
                # workers load the libraries; concurrent first builds would
                # each run nvcc, so build them once here
                from repro_torch.kernels import build

                build.build_all()
            # a worker's exception (a CUDA error included) re-raises here
            with ProcessPoolExecutor(max_workers=int(self.workers),
                                     mp_context=mp.get_context("spawn")) as ex:
                metrics = list(ex.map(build_segment_task, tasks))
        else:
            metrics = [build_segment_task(t) for t in tasks]
        if root_tmp is None:
            from repro_torch.graph.segmented import SegmentedAnnIndex

            segments = [m.pop("index") for m in metrics]
            index = SegmentedAnnIndex.from_parts(
                segments, plan.centroids, plan.global_of(), device=self.device
            )
            return index, metrics
        snap.write_segmented_manifest(
            root_tmp, centroids=plan.centroids, global_of=plan.global_of(), locate=plan.locate(),
        )
        snap.publish_snapshot(root_tmp, snapshot_path)
        index = snap.load_index(snapshot_path, device=self.device) if attach else None
        return index, metrics
