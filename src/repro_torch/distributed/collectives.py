"""Reductions across a mesh's ranks, with their gradients: what GSPMD
inserts into the reference's sharded programs, written out for the port's
step programs (``launch/steps.py``'s mesh cells).

A :class:`MeshAxes` names some axes of a ``launch.mesh.Mesh``: the ranks
that share this rank's coordinates off those axes form its group. On it:

* :meth:`MeshAxes.copy_to` — forward the identity, backward an all-reduce
  (sum) of the gradient. It marks where replicated state enters a sharded
  region (node state gathered onto a rank's edges, the input of a
  column-parallel product): each rank's gradient is then a partial sum.
* :meth:`MeshAxes.reduce_from` — forward an all-reduce (sum), backward the
  identity. It marks where a sharded region's partial sums leave it.
  ``torch.distributed.nn.functional.all_reduce`` all-reduces again in its
  backward, which, where every rank then computes the same replicated
  loss, scales the gradient by the group's size: it is not this.
* :meth:`MeshAxes.max` and :meth:`MeshAxes.sum` — all-reduces that carry
  no gradient (a softmax's shift, a count, a metric).
* :meth:`MeshAxes.share` — forward ``t / size``, backward the identity: a
  term that every member holds whole (made from ingredients summed by
  ``reduce_from``) entering each member's part of a loss that the group
  sums, as its share; each member's backward reaches only its own
  ingredients, so the gradient stays whole (the MoE aux losses across the
  batch axes, ``transformer.lm_loss``).
* :meth:`MeshAxes.sum_leaves` — one all-reduce (sum) of many tensors
  flattened into one buffer (partial gradients).
* :meth:`MeshAxes.gather` — every member's block concatenated. Its
  backward is one of two, by what consumes the gathered tensor. Consumers
  replicated over the group (every member computes the same thing from
  it, so every member's gradient of it is the whole one) take this
  member's own block of the gradient: the ep branch's chunks
  (``moe._moe_on_mesh``). Consumers that differ per member (each rank's
  own query heads reading the gathered k/v columns,
  ``layers._gather_columns``: ``per_rank=True``) leave each member a
  partial gradient: it is summed over the group, then this member's block
  is taken (a reduce-scatter). The wrong one scales the gradient by the
  group's size or drops the other members' partial sums.
* :meth:`MeshAxes.all_to_all` — the block exchange of the expert-parallel
  MoE and of the prefill's caches (``Mesh.all_to_all``). The tiled
  exchange (split and concatenate on dim 0) is its own adjoint, so its
  backward is the same exchange of the gradient; those bytes are counted
  in ``COMM["all_to_all_bytes"]`` too, and apart in
  ``COMM["all_to_all_grad_bytes"]``.

On a group one rank wide every one of them returns its input itself, with
no rendezvous, so a 1-wide mesh computes what no mesh computes, bit for
bit.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import COMM


class MeshAxes:
    """``axes`` (a name or a tuple of names) of ``mesh``."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.size = 1
        for a in self.axes:
            self.size *= mesh.shape[a]

    def __repr__(self) -> str:
        return f"MeshAxes({self.axes}, size={self.size})"

    @property
    def index(self) -> int:
        """This rank's position along the axes (the shard it holds)."""
        return self.mesh.axis_index(self.axes) if self.axes else 0

    def copy_to(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else _CopyTo.apply(t, self)

    def reduce_from(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else _ReduceFrom.apply(t, self)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else self.mesh.all_reduce(t, self.axes, "max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else self.mesh.all_reduce(t, self.axes, "sum")

    def share(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else _Share.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int = 0, *, per_rank: bool = False) -> torch.Tensor:
        """Every member's ``t`` (equal shapes) concatenated along ``dim`` in
        shard order. The backward takes this member's block of the
        gradient; with ``per_rank`` (consumers that differ per member) the
        gradient is first summed over the group (module docstring)."""
        return t if self.size == 1 else _Gather.apply(t, self, dim, per_rank)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block j of ``t`` (size, ...) to the member at shard j; block i of
        the result from the member at shard i. The backward sends block i of
        the gradient back to member i (the same exchange)."""
        return t if self.size == 1 else _AllToAll.apply(t, self)

    def sum_leaves(self, leaves: list) -> list:
        """The all-reduced sums of ``leaves`` (float32 tensors), through one
        flattened buffer."""
        if self.size == 1 or not leaves:
            return list(leaves)
        flat = self.sum(torch.cat([t.reshape(-1) for t in leaves]))
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in leaves]), leaves)]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ax.sum(grad), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        return ax.sum(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        return t / ax.size

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, dim, per_rank):
        ctx.ax, ctx.dim, ctx.per_rank, ctx.width = ax, dim, per_rank, t.shape[dim]
        return torch.cat(ax.mesh.all_gather(t.detach(), ax.axes), dim)

    @staticmethod
    def backward(ctx, grad):
        ax = ctx.ax
        if ctx.per_rank:
            grad = ax.mesh.all_reduce(grad, ax.axes)
        return grad.narrow(ctx.dim, ax.index * ctx.width, ctx.width).contiguous(), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return ax.mesh.all_to_all(t, ax.axes)

    @staticmethod
    def backward(ctx, grad):
        before = COMM["all_to_all_bytes"]
        out = ctx.ax.mesh.all_to_all(grad.contiguous(), ctx.ax.axes)
        COMM["all_to_all_grad_bytes"] += COMM["all_to_all_bytes"] - before
        return out, None


def axes_of(spec) -> tuple[str, ...]:
    """The mesh axes a ``PartitionSpec``-like spec (per dim: None, a name or
    a tuple of names) shards over, in order."""
    out: list[str] = []
    for names in spec or ():
        if names is None:
            continue
        out.extend((names,) if isinstance(names, str) else names)
    return tuple(out)
