"""coregex_tpu_torch — the coregex_tpu regex engine on PyTorch and CUDA.

A port of ``coregex_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
host compile pipeline (parser, NFA, determinization, count transducer,
strategy selection, host engines) is imported from ``coregex_tpu``
unchanged, so both packages compute from identical tables; the device layer
is written anew, with hand-written CUDA kernels under ``csrc/`` where the
reference has Pallas kernels.  This package imports torch and never jax.

    import coregex_tpu_torch as ct
    rx = ct.compile(r"\\d+\\.\\d+\\.\\d+\\.\\d+", device="cuda")
    rx.count(corpus); rx.find_all_index(corpus)
"""

__version__ = "0.1.0"

from .api import Regex, compile, compile_posix, must_compile, quote_meta

__all__ = ["Regex", "compile", "compile_posix", "must_compile", "quote_meta",
           "__version__"]
