"""repro_torch — the PyTorch/CUDA port of the Flash-HNSW indexing system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``graph/``, ``index.py``) so each counterpart sits
under the same path and name. It imports ``torch`` and ``numpy`` only.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises unless the caller asks for ``device="cpu"``. On a CUDA tensor
the kernels (``kernels/csrc/*.cu``) run; on a CPU tensor their plain
PyTorch versions (``kernels/ref.py``) do.

    from repro_torch.index import AnnIndex

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    res = index.search(queries, k=10, ef=64)            # exact rerank
"""
