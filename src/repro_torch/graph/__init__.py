"""The port's graph layer: the six distance backends, the batched beam,
selection, the build engine, HNSW and the flat graphs (Vamana, NSG), the
two-stage rerank, the ``AnnIndex`` facade with its algorithm registry and
maintenance, exact k-NN, and the scale-out layer (``SegmentedAnnIndex``
with the sharded streaming builder)."""

from repro_torch.graph.backends import KINDS, make_backend  # noqa: F401
from repro_torch.graph.index import AnnIndex, SearchResult, SearchSpec, algos, register_algo  # noqa: F401
from repro_torch.graph.nsg import build_nsg  # noqa: F401
from repro_torch.graph.vamana import FlatIndex, build_vamana  # noqa: F401
from repro_torch.graph.knn import average_distance_ratio, exact_knn, recall_at_k  # noqa: F401

# The scale-out layer composes the facade, so it imports after it.
from repro_torch.graph.segmented import SegmentedAnnIndex  # noqa: E402, F401
from repro_torch.graph.sharded import (  # noqa: E402, F401
    ShardConfig,
    ShardedBuilder,
    ShardedBuildResult,
    ShardPlan,
    fanout_map,
    stream_assign,
)
