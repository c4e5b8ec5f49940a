"""Builds the JAX package's native library once for the whole test run.

``coregex_tpu.native`` builds native/coregex_native.cpp with g++ at first
use, into one shared ``_coregex_native.so.tmp`` path
(coregex_tpu/native.py:32-43).  Under pytest-xdist the workers that reach
that build together race on the path, and a worker that loses gives up on
the library for its whole run, so every case of tests/test_native.py
skips there.  The port's copy builds through a per-process file
(coregex_tpu_torch/native.py:41-49); the JAX package stays as it is.

This module runs while each worker collects its tests, before any test
runs (no test module sorted before it builds the library when imported):
it takes an exclusive fcntl lock on a file in the temporary directory and,
holding it, calls ``get_lib()``.  The first worker builds the library; the
others wait on the lock, then find the finished library and load it."""

import fcntl
import os
import shutil
import tempfile

import pytest

from coregex_tpu import native


def _load_once():
    path = os.path.join(tempfile.gettempdir(), "coregex_tpu_native.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return native.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_LIB = _load_once()


def test_reference_native_library_loads():
    if shutil.which("g++") is None or os.environ.get(
            "COREGEX_TPU_NO_NATIVE"):
        pytest.skip("no native library: the Python determinizer serves")
    assert _LIB is not None
    assert native.get_lib() is _LIB
