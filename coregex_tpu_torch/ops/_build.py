"""Build and load the port's CUDA kernels (no counterpart in coregex_tpu).

The sources under ``coregex_tpu_torch/csrc/`` compile at first use into one
shared library with a plain C interface: one ``nvcc -c`` per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<source>.cu -o _build/<source>.<pid>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libcoregex_cuda_<hash>.so _build/*.<pid>.o

The library lands in ``coregex_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources, the headers they include and the flags, so an edited
source or header rebuilds and an unchanged tree loads the existing file.
It is loaded with ctypes; every entry point returns a ``cudaError_t``, and
:func:`check` raises on any non-zero code.  Nothing here falls back to the
plain versions: a failed build or launch is an error.
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
SOURCES = ("lane_scan.cu", "compact.cu", "needle_scan.cu",
           "window_scan.cu", "compact_exp.cu", "nfa_scan.cu",
           "nfa_scan_part1.cu", "nfa_scan_part2.cu", "nfa_scan_part3.cu",
           "nfa_scan_part4.cu", "onepass_scan.cu", "row_scan.cu",
           "transfer_scan.cu")
HEADERS = ("compact_common.cuh", "split_common.cuh")  # included; hashed too
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # the lane walk takes (pass, place, packed, vbytes, S, nseg, ...), the
    # window scan ([width,] packed, vbytes, S, nseg, ...)
    "cgx_lane_count": [_I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                       _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "cgx_lane_span": [_I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                      _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "cgx_lane_reset": [_I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                       _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "cgx_lane_occupancy": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int)],
    "cgx_lane_flag": [_I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P,
                      _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "cgx_lane_match": [_I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                       _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "cgx_window_flags": [_P, _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong,
                         _I, _P, _P, _I, _I, _P, _P, _P],
    "cgx_window_ends": [_I, _P, _I, _I, _I, _P, _P, _P, _P,
                        ctypes.c_longlong, _I, _P, _P, _P, _I, _I, _P, _P,
                        _I, _P],
    "cgx_window_plan": [_I, _I, _I, _I, ctypes.c_longlong, _I, _I]
                       + [ctypes.POINTER(ctypes.c_int)] * 3,
    "cgx_compact": [_P, ctypes.c_int64, _I, ctypes.c_int64, _I, _I, _P, _P,
                    _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "cgx_compact_exp": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                        _P, _I, _I, _I, _I, _P, _P, _P],
    "cgx_line_lanes": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P],
    "cgx_needles_bytes": [],
    "cgx_hits_lanes": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "cgx_seq_lanes": [_I, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                      _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "cgx_bitset_scan": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P],
    "cgx_bitset_occupancy": [_I, _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int)],
    "cgx_onepass_extract": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I,
                            _P, _P, _P],
    "cgx_rows_match": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P,
                       _P, _P, _P],
    "cgx_rows_rev_start": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P,
                           _P, _P, _P],
    "cgx_transfer_walk": [_P, _I, _I, _P, _P, ctypes.c_longlong,
                          ctypes.c_longlong, _I, _I, _P, _P, _P, _P, _P],
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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcoregex_cuda_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    tmp = f"{path}.{tag}.tmp"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [_nvcc(), *FLAGS, "-Xptxas", "-v", "-c", os.path.join(CSRC, s),
         "-o", o], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s, o in zip(SOURCES, objs)]
    logs, failed = [], []
    for s, pr in zip(SOURCES, procs):
        out, _ = pr.communicate(timeout=600)
        logs.append(out)
        if pr.returncode != 0:
            failed.append(f"{s} ({pr.returncode})")
    if not failed:
        r = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True, timeout=600)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"link ({r.returncode})")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
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
