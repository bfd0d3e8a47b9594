"""Meshes of ranks and the rank launcher (reference: ``repro.launch.mesh``).

A JAX mesh of N devices is, here, a world of N ``torch.distributed``
ranks, one process each, each on its own device: SPMD code that every
rank runs on its own slice of the work. A :class:`Mesh` names the axes,
their sizes (``shape``: axis → size, as ``jax.sharding.Mesh.shape`` is)
and the ranks in row-major order over the axes (the reference's device
order), and gives this rank its coordinates, its device and, for any
subset of the axes, the process group of the ranks that share every other
coordinate (``dist.new_group``, made once and cached).

Topology of the reference's production meshes (TPU v5e-class):
  single pod : (16, 16)    axes ("data", "model")        = 256 devices
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 devices
"pod" composes with "data" for batch / segment sharding; "model" is the
tensor / expert axis.

With no process group (or a world of one), :func:`make_segment_mesh` is 1
wide: the reference's "no mesh" contract, which ``ShardedBuilder`` takes as
"build inline". :func:`run_ranks` starts a world on one host (``spawn``,
a ``FileStore`` rendezvous); a world that ``torchrun`` started works too:

    torchrun --nproc-per-node 2 script.py   # script: make_segment_mesh()

Nothing here touches a device or a process group when imported.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
import traceback
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from repro_torch.distributed.context import device_count, mesh_context
from repro_torch.utils import resolve_device

#: this process's device when ``run_ranks`` started it (else derived from
#: ``LOCAL_RANK``, see :func:`rank_device`)
_RANK_DEVICE: torch.device | None = None

#: the collectives' traffic in this process, read by the smoke and the
#: example: gathers made, bytes received by them, and seconds spent in
#: them; all-reduces made, bytes each contributed, and seconds;
#: all-to-alls made, bytes each sent (its own block included), and
#: seconds, and of those bytes the ones that backwards sent
#: (``distributed.collectives``); bytes copied through the host for a
#: ``gloo`` group on the card (every kind)
COMM = {"gathers": 0, "gathered_bytes": 0, "gather_s": 0.0, "reduces": 0, "reduced_bytes": 0, "reduce_s": 0.0,
        "all_to_alls": 0, "all_to_all_bytes": 0, "all_to_all_s": 0.0, "all_to_all_grad_bytes": 0,
        "staged_bytes": 0}


def reset_comm() -> None:
    COMM.update({k: type(v)() for k, v in COMM.items()})


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device() -> torch.device:
    """This rank's device: the one ``run_ranks`` gave it; in a world that
    another launcher started, ``cuda:{LOCAL_RANK mod cards}``; without a
    group, the card (``resolve_device("cuda")``, which raises without one)."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    world, rank = _world()
    if world > 1 and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device("cuda")


class Mesh:
    """``shape`` (axis → size, row-major) over ``ranks`` (the global rank at
    each row-major position); this process's place in it, its device and
    the groups of its sub-meshes."""

    def __init__(self, shape: Mapping[str, int], ranks: Sequence[int], device):
        self.axis_names = tuple(shape)
        self.shape = {a: int(n) for a, n in shape.items()}
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != math.prod(self.shape.values()):
            raise ValueError(f"{len(self.ranks)} ranks cannot fill a mesh of shape {self.shape}")
        self.device = torch.device(device)
        me = _world()[1]
        #: this rank's row-major position in the mesh (None: not a member)
        self.index = self.ranks.index(me) if me in self.ranks else None
        sizes = tuple(self.shape.values())
        self.coords = None if self.index is None else dict(
            zip(self.axis_names, (int(c) for c in np.unravel_index(self.index, sizes))))
        #: seconds from the launcher's spawn to this rank's entry and of its
        #: group's rendezvous (set by ``run_ranks``)
        self.launch: dict | None = None
        self._groups: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks)}, device={self.device}, coords={self.coords})"

    @property
    def size(self) -> int:
        return device_count(self)

    def _member(self) -> dict:
        if self.coords is None:
            raise ValueError(f"rank {_world()[1]} is not in {self!r}")
        return self.coords

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's {self.axis_names}")
        return axes

    def axis_index(self, axes) -> int:
        """This rank's row-major position along ``axes`` (in their order:
        the first is major), as ``NamedSharding(mesh, P(axes))`` numbers
        the shards."""
        coords = self._member()
        pos = 0
        for a in self._axes(axes):
            pos = pos * self.shape[a] + coords[a]
        return pos

    def members(self, axes) -> list[int]:
        """Global ranks that share this rank's coordinates off ``axes``,
        ordered by their :meth:`axis_index` along ``axes``."""
        axes, coords = self._axes(axes), self._member()
        out = []
        for pos in np.ndindex(*(self.shape[a] for a in axes)):
            c = dict(coords, **dict(zip(axes, pos)))
            out.append(self.ranks[int(np.ravel_multi_index(tuple(c[a] for a in self.axis_names),
                                                           tuple(self.shape.values())))])
        return out

    def group(self, axes):
        """The process group of :meth:`members` (the world's own when they
        are the whole world), made on first use by the members alone."""
        axes = self._axes(axes)
        if axes not in self._groups:
            members = self.members(axes)
            if sorted(members) == list(range(_world()[0])):
                self._groups[axes] = dist.group.WORLD
            else:
                self._groups[axes] = dist.new_group(members, use_local_synchronization=True)
        return self._groups[axes]

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every member's ``t`` (equal shapes), in :meth:`members` order, on
        this rank's device. A ``gloo`` group takes no card tensors, so
        there the tensor goes through the host (counted in
        ``COMM["staged_bytes"]``); nothing is computed there."""
        members = self.members(axes)
        if len(members) == 1:
            return [t]
        g = self.group(axes)
        t0 = time.perf_counter()
        staged = t.device.type == "cuda" and dist.get_backend(g) == "gloo"
        src = (t.cpu() if staged else t).contiguous()
        out = [torch.empty_like(src) for _ in members]
        dist.all_gather(out, src, group=g)
        out = [out[dist.get_group_rank(g, m)] for m in members]
        if staged:
            out = [x.to(t.device) for x in out]
            COMM["staged_bytes"] += src.nbytes * (1 + len(members))
        COMM["gathers"] += 1
        COMM["gathered_bytes"] += src.nbytes * len(members)
        COMM["gather_s"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of every member's ``t``
        (equal shapes) along ``axes``, a new tensor on this rank's device;
        ``t`` itself where the group is one rank wide. A ``gloo`` group takes
        no card tensors, so there the tensor goes through the host, as in
        :meth:`all_gather` (counted in ``COMM["staged_bytes"]``); ``nccl``
        reduces on the card. No gradient is carried
        (``distributed.collectives`` pairs it with autograd)."""
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        members = self.members(axes)
        if len(members) == 1:
            return t
        g = self.group(axes)
        t0 = time.perf_counter()
        staged = t.device.type == "cuda" and dist.get_backend(g) == "gloo"
        buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=reduce_op, group=g)
        if staged:
            buf = buf.to(t.device)
            COMM["staged_bytes"] += 2 * buf.nbytes
        COMM["reduces"] += 1
        COMM["reduced_bytes"] += buf.nbytes
        COMM["reduce_s"] += time.perf_counter() - t0
        return buf

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The exchange of blocks along ``axes``: ``t`` (G, ...) with G the
        group's size; block j goes to the member at position j of
        :meth:`members`, and block i of the result (G, ...) is the one that
        member i sent here (``jax.lax.all_to_all`` with ``split_axis =
        concat_axis = 0``, tiled). A new tensor on this rank's device; ``t``
        itself where the group is one rank wide. A ``gloo`` group on the
        card goes through the host, as in :meth:`all_gather` (counted in
        ``COMM["staged_bytes"]``). No gradient is carried."""
        members = self.members(axes)
        if len(members) == 1:
            return t
        if t.shape[0] != len(members):
            raise ValueError(f"all_to_all over {len(members)} ranks takes {len(members)} blocks, got {t.shape[0]}")
        g = self.group(axes)
        t0 = time.perf_counter()
        staged = t.device.type == "cuda" and dist.get_backend(g) == "gloo"
        # the process group orders its members by group rank
        order = torch.tensor([dist.get_group_rank(g, m) for m in members])
        src = torch.empty_like(t, device="cpu" if staged else t.device, memory_format=torch.contiguous_format)
        src[order.to(src.device)] = t.detach().to(src.device)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=g)
        out = out[order.to(out.device)]
        if staged:
            out = out.to(t.device)
            COMM["staged_bytes"] += 2 * src.nbytes
        COMM["all_to_alls"] += 1
        COMM["all_to_all_bytes"] += src.nbytes
        COMM["all_to_all_s"] += time.perf_counter() - t0
        return out

    def broadcast_object(self, obj):
        """``obj`` from the mesh's first rank to every rank (pickled,
        through the host); each rank returns it."""
        box = [obj]
        if self.size > 1:
            dist.broadcast_object_list(box, src=self.ranks[0], group=self.group(self.axis_names))
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group(self.axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's 256- or 512-device mesh; a smaller world raises, as
    ``jax.make_mesh`` does without the devices."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    need, have = math.prod(shape.values()), _world()[0]
    if have < need:
        raise ValueError(f"the production mesh {tuple(shape.values())} needs {need} ranks, have {have}")
    return Mesh(shape, range(need), rank_device() if device is None else device)


def make_host_mesh(model: int = 1, *, device=None) -> Mesh:
    """(world // model, model) over ("data", "model"): every rank."""
    n = _world()[0]
    if n % model:
        raise ValueError(f"{n} ranks do not divide into model axes of {model}")
    return Mesh({"data": n // model, "model": model}, range(n), rank_device() if device is None else device)


def make_segment_mesh(n: int | None = None, *, device=None) -> Mesh:
    """1-D ("data",) mesh over ranks [0, n) for segment-parallel builds,
    ``n`` defaulting to the whole world; without a process group it is 1
    wide, which ``ShardedBuilder`` takes as "no mesh" (inline or pool)."""
    have = _world()[0]
    if n is None:
        n = have
    if not 1 <= n <= have:
        raise ValueError(f"asked for {n} devices, have {have}")
    return Mesh({"data": n}, range(n), rank_device() if device is None else device)


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes a global batch shards over (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_devices(mesh) -> int:
    return device_count(mesh)


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def _to_host(obj):
    """``obj`` with every tensor moved to the CPU (dicts, lists, tuples and
    named tuples walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, n: int, fn, args, dev_type: str, backend: str, tmp: str, timeout: float,
               t_spawn: float) -> None:
    """One rank of :func:`run_ranks` (module level: ``spawn`` pickles it)."""
    global _RANK_DEVICE
    t_entry = time.time()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    if dev_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # the ranks share the host's cores
    _RANK_DEVICE = dev
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), n), rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=timeout),
                            device_id=dev if backend == "nccl" else None)
    try:
        mesh = make_segment_mesh(n, device=dev)
        mesh.barrier()
        mesh.launch = {"start_s": t_entry - t_spawn, "group_init_s": time.perf_counter() - t0}
        with mesh_context(mesh):
            out = fn(mesh, *args)
        if rank == 0:
            torch.save(_to_host(out), os.path.join(tmp, "result.pt"))
        mesh.barrier()  # rank 0's result is on disk before any rank leaves
    except BaseException:
        # the first rank to fail names the cause; its peers then fail in
        # their collectives, and the launcher reports the earliest
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(f"{time.time()!r}\nrank {rank}: {traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_error(tmp: str) -> str | None:
    """The traceback that the earliest failing rank left in ``tmp``."""
    errors = []
    for name in os.listdir(tmp):
        if name.startswith("error."):
            with open(os.path.join(tmp, name)) as f:
                stamp, text = f.read().split("\n", 1)
            errors.append((float(stamp), text))
    return min(errors)[1] if errors else None


def run_ranks(fn, n: int, *args, device: str | torch.device = "cuda", timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` on ``n`` ranks of one host and return rank
    0's result (its tensors on the CPU).

    The ranks are ``spawn``ed processes (``fn`` and ``args`` are pickled:
    keep ``fn`` at module level and a script's work under ``if __name__ ==
    "__main__"``) joined in one group through a ``FileStore`` in a temporary
    directory; ``timeout`` (seconds) bounds the rendezvous and every
    collective. Rank r runs on ``cuda:{r mod cards}`` (``device="cpu"``: on
    the CPU, with its share of the cores as torch threads) with ``mesh = make_segment_mesh(n)`` ambient. The group is
    ``nccl`` when every rank has a card of its own, else ``gloo`` (NCCL
    refuses two ranks on one card). NCCL with one rank a card has never
    run: no host this port was tested on had two cards (ROADMAP queue 1,
    item 7.6); ``gloo`` is the tested path. The kernels are built first, here.
    A rank that raises, or a collective that times out, raises here (a
    ``RuntimeError`` with the first failing rank's traceback); the other
    ranks are stopped."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"run_ranks needs at least one rank, got {n}")
    backend = "gloo"
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all()
        torch.cuda.empty_cache()
        if n <= torch.cuda.device_count():
            backend = "nccl"  # never run: no host had two cards (ROADMAP 7.6)
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        try:
            torch.multiprocessing.spawn(
                _rank_main, args=(n, fn, args, dev.type, backend, tmp, float(timeout), time.time()),
                nprocs=n, join=True,
            )
        except ProcessException as exc:
            first = _first_error(tmp)
            if first is None:
                raise
            raise RuntimeError(f"a rank of {n} failed; the first:\n{first}") from exc
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
