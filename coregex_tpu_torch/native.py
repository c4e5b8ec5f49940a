# Copy of coregex_tpu/native.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""ctypes bridge to the C++ native core (csrc/coregex_native.cpp).

The native determinizer is the compile-time hot path (the reference
compiles `\\d+` in ~3µs, benchmark/baselines/v0.6.0.txt; eager
determinization in pure Python costs ms).  Falls back silently to the
Python implementation when the shared library is unavailable; builds it
on first use when a C++ toolchain is present.  The port builds its own
copy of the source into ``_build/`` (git-ignored), named by a hash of the
source, and never loads the reference's library.

Set COREGEX_TPU_NO_NATIVE=1 to force the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "coregex_native.cpp")


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_PKG, "_build", f"libcoregex_native_{h}.so")


def _build(so: str) -> Optional[str]:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("COREGEX_TPU_NO_NATIVE"):
            return None
        if not os.path.exists(_SRC):
            return None
        so = _so_path()
        path = so if os.path.exists(so) else _build(so)
        if not path:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.crx_determinize.restype = ctypes.c_int
            lib.crx_version.restype = ctypes.c_int
            if lib.crx_version() != 1:
                return None
            _lib = lib
        except OSError:
            return None
    return _lib


def flatten_nfa(nfa):
    """NFA -> (kinds, offsets, payload) int32 arrays for the C ABI."""
    from .nfa.nfa import Kind
    kinds = np.empty(len(nfa.states), dtype=np.int32)
    offsets = np.empty(len(nfa.states) + 1, dtype=np.int32)
    payload = []
    for i, st in enumerate(nfa.states):
        kinds[i] = st[0]
        offsets[i] = len(payload)
        if st[0] == Kind.RANGE:
            payload.extend((st[1], st[2], st[3]))
        elif st[0] == Kind.SPLIT:
            payload.extend(st[1:])
        elif st[0] in (Kind.LOOK, Kind.CAPTURE):
            payload.extend((st[1], st[2]))
    offsets[len(nfa.states)] = len(payload)
    return kinds, offsets, np.asarray(payload, dtype=np.int32)


def determinize_native(nfa, anchored: bool, break_at_match: bool,
                       state_limit: int, byte_classes=None):
    """Run the native determinizer; returns DenseDFA, raises DFAOverflow,
    or returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from .dfa.dense import DenseDFA
    from .dfa.determinize import DFAOverflow
    from .nfa.nfa import Look

    bc = byte_classes or nfa.byte_classes()
    C = bc.num_classes
    kinds, offsets, payload = flatten_nfa(nfa)
    classes = np.ascontiguousarray(bc.classes, dtype=np.int32)

    needs_word = nfa.has_look(Look.WORD_BOUNDARY, Look.NO_WORD_BOUNDARY)
    needs_prev = nfa.has_look(Look.BEGIN_TEXT, Look.BEGIN_LINE,
                              Look.WORD_BOUNDARY, Look.NO_WORD_BOUNDARY)
    needs_nl = nfa.has_look(Look.BEGIN_LINE, Look.END_LINE)

    delta_p = ctypes.POINTER(ctypes.c_int32)()
    match_p = ctypes.POINTER(ctypes.c_uint8)()
    eoi_p = ctypes.POINTER(ctypes.c_uint8)()
    starts = (ctypes.c_int32 * 4)()
    n_dfa = ctypes.c_int32()

    def arr_ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.crx_determinize(
        arr_ptr(kinds, ctypes.c_int32), arr_ptr(offsets, ctypes.c_int32),
        arr_ptr(payload, ctypes.c_int32), ctypes.c_int32(len(nfa.states)),
        ctypes.c_int32(nfa.start_anchored),
        ctypes.c_int32(nfa.start_unanchored),
        arr_ptr(classes, ctypes.c_int32), ctypes.c_int32(C),
        ctypes.c_int32(int(anchored)), ctypes.c_int32(int(break_at_match)),
        ctypes.c_int32(state_limit), ctypes.c_int32(int(needs_prev)),
        ctypes.c_int32(int(needs_word)), ctypes.c_int32(int(needs_nl)),
        ctypes.byref(delta_p), ctypes.byref(match_p), ctypes.byref(eoi_p),
        starts, ctypes.byref(n_dfa))
    if rc == 1:
        raise DFAOverflow(f"DFA exceeds {state_limit} states for pattern")
    if rc != 0:
        return None
    S = n_dfa.value
    try:
        delta = np.ctypeslib.as_array(delta_p, shape=(S, C)).copy()
        match = np.ctypeslib.as_array(match_p, shape=(S, C)).astype(bool)
        eoi = np.ctypeslib.as_array(eoi_p, shape=(S, 4)).astype(bool)
    finally:
        lib.crx_free(delta_p)
        lib.crx_free(match_p)
        lib.crx_free(eoi_p)
    return DenseDFA(
        delta=delta, match_on=match, match_eoi=eoi,
        starts=np.asarray(starts, dtype=np.int32).copy(),
        classes=classes.copy(), anchored=anchored,
        break_at_match=break_at_match, pattern=nfa.pattern,
        num_nfa_states=len(nfa.states))
