"""Build and load the port's CUDA kernels (no counterpart in coregex_tpu).

The sources under ``coregex_tpu_torch/csrc/`` compile at first use into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libcoregex_cuda_<hash>.so csrc/*.cu

The library lands in ``coregex_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads the existing file.  It is loaded with ctypes; every entry point
returns a ``cudaError_t``, and :func:`check` raises on any non-zero code.
Nothing here falls back to the plain versions: a failed build or launch is an
error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("lane_scan.cu", "compact.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cgx_lane_count": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P],
    "cgx_lane_span": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P],
    "cgx_lane_flag": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                      _P, _P],
    "cgx_compact": [_P, ctypes.c_int64, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                    _P, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc run (None: loaded, not built)
build_log = ""         # nvcc's output of that run


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcoregex_cuda_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            so = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.cgx_error_string.argtypes = [ctypes.c_int]
            so.cgx_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        msg = lib().cgx_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> int:
    """Device pointer of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()


def stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
