"""``repro_torch.index`` — canonical import path for the index facade.

    from repro_torch.index import AnnIndex

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    res = index.search(queries, k=10, ef=64)
"""

from repro_torch.graph.index import AnnIndex, SearchResult, SearchSpec  # noqa: F401
