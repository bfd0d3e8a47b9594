"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all sources at once (one ``nvcc``
process each, started together). The libraries go to
``build/repro_torch_kernels/`` at the repository root (``.gitignore``
lists ``build/``), named by a hash of their sources so an edited kernel is
rebuilt. ``ctypes`` loads them; every entry point returns
``cudaGetLastError()`` after its launch.

Nothing here runs at import time: the CPU tests import this module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: kernel name -> its CUDA source in csrc/
SOURCES = {
    "flash_round": "flash_round.cu",
    "flash_expand": "flash_expand.cu",
    "flash_beam": "flash_beam.cu",
    "flash_scan_blocked": "flash_scan_blocked.cu",
    "l2_batch": "l2_batch.cu",
    "flash_scan": "flash_scan.cu",
    "sq_l2": "sq_l2.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signatures of the entry points (pointers and the stream as c_void_p)
SIGNATURES = {
    "flash_round": ("repro_flash_round", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "flash_expand": (
        "repro_flash_expand",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "flash_beam": ("repro_flash_beam", [_P] * 12 + [_I] * 12 + [_P]),
    "flash_scan_blocked": (
        "repro_flash_scan_blocked", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "l2_batch": ("repro_l2_batch", [_P, _P, _P] + [_I] * 6 + [_P]),
    "flash_scan": ("repro_flash_scan", [_P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "sq_l2": ("repro_sq_l2", [_P, _P, _P, _P, _L, _I, _I, _P]),
}

_FNS: dict = {}  # kernel name -> its loaded ctypes entry point
_LOAD_LOCK = threading.Lock()  # the fan-out threads may ask for a kernel at once
#: ptxas report (registers, shared memory, spills) of the last build, by kernel
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's machine")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], "flash_common.cuh"):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel.

    Returns the wall seconds spent; raises with nvcc's output on failure.
    """
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        PTXAS_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, building it if needed."""
    fn = _FNS.get(name)
    if fn is None:
        with _LOAD_LOCK:
            fn = _FNS.get(name)
            if fn is None:
                build_all()
                lib = ctypes.CDLL(str(_lib_path(name)))
                sym, argtypes = SIGNATURES[name]
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[name] = fn
    return fn
