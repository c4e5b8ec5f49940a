"""coregex_tpu_torch — the coregex_tpu regex engine on PyTorch and CUDA.

A port of ``coregex_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
package stands alone: it keeps its own copy of the host compile pipeline
(parser, NFA, determinization, count transducer, strategy selection, host
engines), each copied file naming the reference file it copies, and
imports neither ``coregex_tpu`` nor jax.  The device layer is written
anew, with hand-written CUDA kernels under ``csrc/`` where the reference
has Pallas kernels or device loops.

    import coregex_tpu_torch as ct
    rx = ct.compile(r"\\d+\\.\\d+\\.\\d+\\.\\d+", device="cuda")
    rx.count(corpus); rx.find_all_index(corpus)
"""

__version__ = "0.1.0"

from .api import (Regex, compile, compile_posix, must_compile, quote_meta,
                  match, match_string)

__all__ = ["Regex", "compile", "compile_posix", "must_compile", "quote_meta",
           "match", "match_string", "__version__"]
