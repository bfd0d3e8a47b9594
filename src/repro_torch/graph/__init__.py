"""The port's graph layer: Flash backends, the batched beam, selection, the
build engine, HNSW, the two-stage rerank, the ``AnnIndex`` facade with
maintenance, exact k-NN, and the scale-out layer (``SegmentedAnnIndex``
with the sharded streaming builder)."""

from repro_torch.graph.index import AnnIndex, SearchResult, SearchSpec  # noqa: F401
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
