"""The compiled-pattern API over a torch device.

Subclasses ``coregex_tpu.meta.engine.Engine``: parsing, the host engines
(DFA search, PikeVM, backtracker) and the whole stdlib-compatible surface
are the reference's.  What changes:

  * ``batch_engine()`` (ref. :142-150) returns the torch BatchEngine on the
    engine's device, so corpus-scale ``count`` and ``find_all*`` run there;
  * ``count`` (ref. :312-337) asks the BatchEngine once: its count already
    covers nullable plans;
  * ``_batch_captures`` (ref. :418-443) and ``_batch_rows_ok`` (ref.
    :693-699) would run the JAX kernels whenever jax is importable; they
    stay on the host here until the capture and row-batch slices are
    ported (ROADMAP M8).

The device is explicit: "cpu" runs the kernels' plain torch versions,
"cuda" runs the CUDA kernels.  Nothing picks it by probing for a GPU.
"""

from __future__ import annotations

import torch

from coregex_tpu.meta.engine import Engine as _RefEngine
from coregex_tpu.meta.engine import _as_array
from coregex_tpu.meta.strategy import Strategy
from coregex_tpu.syntax.parser import Parsed, parse

from .batch import BatchEngine


class Engine(_RefEngine):
    """A compiled pattern whose corpus-scale calls run on a torch device."""

    def __init__(self, parsed: Parsed, longest: bool = False, config=None,
                 device="cuda"):
        self.device = torch.device(device)
        super().__init__(parsed, longest=longest, config=config)

    @classmethod
    def compile(cls, pattern: str, longest: bool = False, config=None,
                device="cuda", **kw) -> "Engine":
        return cls(parse(pattern), longest=longest, config=config,
                   device=device)

    def batch_engine(self) -> BatchEngine:
        if self._batch is None:
            self._batch = BatchEngine(self.parsed, self.parsed.ast,
                                      dfas_ok=self.fwd is not None,
                                      device=self.device,
                                      longest=self.longest)
        return self._batch

    def count(self, data) -> int:
        """Number of non-overlapping matches (ref. Engine.count).  The
        BatchEngine's count serves nullable plans itself, so the
        reference's second nullable_count attempt after a decline would
        only repeat it."""
        arr = _as_array(data)
        if len(arr) >= self.batch_threshold:
            be = self.batch_engine()
            if be.plan.strategy != Strategy.HOST or (
                    be.plan.nullable and not self.longest):
                with self._timed_scan(arr):
                    c = be.count(arr)
                if c is not None:
                    return c
        return len(self._all_spans(arr))

    def _batch_captures(self, arr, spans):
        return [None] * len(spans)

    def _batch_rows_ok(self) -> bool:
        return False

    def set_longest(self, longest: bool = True) -> None:
        if longest != self.longest:
            fresh = type(self)(self.parsed, longest=longest,
                               config=self.config, device=self.device)
            self.__dict__.update(fresh.__dict__)

    def __getstate__(self):
        return {"pattern": self.pattern, "longest": self.longest,
                "device": str(self.device)}

    def __setstate__(self, state):
        self.__init__(parse(state["pattern"]), longest=state["longest"],
                      device=state["device"])

    def __repr__(self) -> str:
        return f"coregex_tpu_torch.Regex({self.pattern!r}, {self.device})"
