"""Go's selection over verified candidate matches, on the device.

Ports from ``coregex_tpu/ops/span_kernels.py``: ``_go_select_round`` (:57),
``go_select_device`` (:73), ``go_select_flex_lazy`` (:97),
``_go_select_flex_round`` (:189) and ``go_select_flex`` (:211), torch ops
on hit-sized arrays (the reference jits them; no Pallas kernel).  The
candidate pipelines of ``meta/batch.py`` call them: ``go_select_flex``
through ``span_chain.inner_assemble`` (a class-run prefix admits every
start in [smin, smax]).  ``go_select_device``'s fixed-start selection is
what ``span_chain.chain_select`` computes exactly, with no round limit,
and the candidate pipeline calls that; ``tests/test_torch_m5.py`` holds
the two equal.  ``spans_from_masks``, ``multi_literal_span_masks`` and
``line_span_masks`` have no caller in the reference and are not ported.

Go's walk selects the unique fixed point of sel[i] = (starts[i] >= the
largest end of the selected j < i): iterating that equation converges in
one round per level of nested overlap; ``stable`` says whether
``rounds`` reached the fixed point.
"""

from __future__ import annotations

import torch

from .span_chain import cummax_fast


def _prev_max(sel, ends):
    """The largest end of the selected candidates before each one (-1
    before the first)."""
    e = torch.where(sel, ends, -1)
    return torch.cat([e.new_full((1,), -1), cummax_fast(e, -1)[:-1]])


def _go_select_round(starts, ends, live, rounds: int):
    def step(sel):
        return live & (starts >= _prev_max(sel, ends))

    sel = live
    for _ in range(rounds):
        sel = step(sel)
    return sel, (step(sel) == sel).all()


def go_select_device(starts, ends, cnt: int, cap: int,
                     max_rounds: int = 24):
    """Go's non-overlapping leftmost selection over verified candidates
    (start-sorted, non-empty, aligned; entries past cnt ignored).  Returns
    (sel mask [cap], ok): ok False when max_rounds did not reach the fixed
    point (one sync)."""
    live = torch.arange(cap, dtype=torch.int32, device=starts.device) < cnt
    sel, stable = _go_select_round(starts, ends, live, max_rounds)
    return sel, bool(stable)


def _go_select_flex_round(smin, smax, ends, live, rounds: int):
    def step(sel):
        return live & (_prev_max(sel, ends) <= smax)

    sel = live
    for _ in range(rounds):
        sel = step(sel)
    stable = (step(sel) == sel).all()
    return sel, stable, torch.maximum(smin, _prev_max(sel, ends))


def go_select_flex_lazy(smin, smax, ends, cnt: int, cap: int,
                        max_rounds: int = 24):
    """go_select_flex with no sync: (sel, stable, starts, selected count),
    the scalars as device tensors for the caller's one sync."""
    live = torch.arange(cap, dtype=torch.int32, device=ends.device) < cnt
    sel, stable, starts = _go_select_flex_round(smin, smax, ends, live,
                                                max_rounds)
    sel = sel & live
    return sel, stable, starts, sel.sum(dtype=torch.int32)


def go_select_flex(smin, smax, ends, cnt: int, cap: int,
                   max_rounds: int = 24):
    """Go's selection when candidate i may start anywhere in [smin[i],
    smax[i]] with a fixed end: from restart position pos Go takes the
    first candidate with smax >= pos and matches at max(smin, pos).
    Returns (sel mask, ok, starts) on the device (ok after one sync)."""
    live = torch.arange(cap, dtype=torch.int32, device=ends.device) < cnt
    sel, stable, starts = _go_select_flex_round(smin, smax, ends, live,
                                                max_rounds)
    return sel, bool(stable), starts
