"""``repro_torch.index`` — canonical import path for the index facades.

    from repro_torch.index import AnnIndex, SegmentedAnnIndex

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    res = index.search(queries, k=10, ef=64)            # exact rerank
    flat = AnnIndex.build(data, algo="nsg", backend="pq")  # any of algos() × kinds
    coll = SegmentedAnnIndex.build_streaming(data, n_segments=64)
    res = coll.search(queries, k=10, ef=64)             # fan-out + merge
"""

from repro_torch.graph.index import (  # noqa: F401
    AlgoSpec,
    AnnIndex,
    SearchResult,
    SearchSpec,
    algos,
    register_algo,
)
from repro_torch.graph.knn import exact_knn, recall_at_k  # noqa: F401
from repro_torch.graph.segmented import SegmentedAnnIndex  # noqa: F401
from repro_torch.graph.sharded import ShardConfig, ShardedBuilder  # noqa: F401
