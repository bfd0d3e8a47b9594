"""The GNN family (reference: ``repro.models.gnn``): GatedGCN, EGNN,
NequIP and Equiformer-v2 over padded edge-list batches (``common``), with
the SO(3) machinery of the equivariant two (``so3``).

The forwards are plain functions over a params tree in the reference's
layout (layers stacked on a leading axis, Equiformer's ``w_mr`` a list),
so :func:`params_from_jax` and :func:`params_to_jax` carry any of the
four trees across bit for bit.
"""

from repro_torch.models.gnn.common import params_from_jax, params_to_jax  # noqa: F401
