"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root, and loaded with
``ctypes``. A library's file name carries a hash of its sources and
flags, so an edited kernel is rebuilt and a built one is reused.
Several kernels are built in parallel, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module, and
there is no ``nvcc`` without the CUDA toolkit.
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
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("crossbar_mvm", "int8_matmul")

# the activation codes of csrc/epilogue.cuh
ACTIVATION_CODES = {"linear": 0, "threshold": 1, "sigmoid": 2, "relu": 3,
                    "tanh": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point: (symbol, argtypes). An entry point
# lives in the library of its name, or of the name _LIBRARY gives.
_ENTRY = {
    # x, x_bf16, gp, gn, scale, bias, out, B, R, C, rows, cols,
    # activation, partials, stream
    "crossbar_mvm": ("crossbar_mvm_launch",
                     (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _P)),
    # x, x_signed, w, scale, offset, out, B, K, N, activation, fused,
    # stream
    "int8_matmul": ("int8_matmul_launch",
                    (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    # x (f32), w, scale, offset, out, B, K, N, activation, shift, inv,
    # top, stream
    "int8_matmul_dac": ("int8_matmul_dac_launch",
                        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                         _P)),
}
_LIBRARY = {"int8_matmul_dac": "int8_matmul"}

_lock = threading.Lock()
_entries: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("repro_torch: nvcc not found (need the CUDA "
                       "toolkit to build the kernels in kernels/csrc)")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: keyed by its sources and flags."""
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for one already built); raises with the compiler's
    output if any build fails."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, target,
                       time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("repro_torch: kernel build failed: " +
                           "\n".join(failed))
    return seconds


def library_of(name: str) -> str:
    """The kernel library that holds entry point ``name``."""
    return _LIBRARY.get(name, name)


def entry(name: str):
    """The ctypes entry point ``name`` (a key of ``_ENTRY``), building
    and loading its library on first use. Every pointer and the stream
    are ``c_void_p``; the function returns the launch's cudaError_t."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            lib = library_of(name)
            build((lib,))
            symbol, argtypes = _ENTRY[name]
            fn = getattr(ctypes.CDLL(str(library_path(lib))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def activation_code(activation: str) -> int:
    try:
        return ACTIVATION_CODES[activation]
    except KeyError:
        raise ValueError(f"unsupported fused activation: "
                         f"{activation!r}") from None
