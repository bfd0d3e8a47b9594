"""The Flash kernels: CUDA C++ sources in ``csrc/``, their build in
``build.py``, plain PyTorch versions in ``ref.py`` and the dispatching
wrappers with launch counters in ``ops.py``."""
