# Copy of coregex_tpu/meta/nullable.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Nullable-pattern FindAll on device: non-empty core + empty fill-in.

The reference runs nullable patterns (`\\w*`, `(foo)?`, ...) through the
same lazy-DFA FindAll loop as everything else, applying the empty-match
rules of regexp's allMatches as it walks (its meta/findall.go:176-283,
regex.go:790-850).  A TPU batch scan can't walk; instead we exploit the
structure of leftmost-first priority:

For a nullable pattern R whose empty match is UNCONDITIONAL (no look
guards it) and whose priority order puts the empty match LAST (greedy
wrappers), the FindAll walk factorizes exactly:

  FindAll(R)  =  FindAll(core(R))  ∪  empty matches at every Go-walk
                 position not covered by a core match and not equal to a
                 core match end,

where core(R) is the non-nullable projection of R — same non-empty match
set, same priority order among non-empty alternatives:

  X*  (greedy)          -> X+          (the greedy chain IS X+'s match)
  X?  (greedy)          -> X
  X{0,k} (greedy)       -> X{1,k}
  X*? / X?? / (?:)      -> ALL_EMPTY   (empty outranks everything)
  (a|b|N|dead...)       -> (a|b|core(N))   N = first nullable branch;
                                            later branches are dead
  nullable bodies recurse (e.g. (a?)* -> (a)+).

Proof sketch of the factorization (each step mirrors regexp.allMatches):
at any walk position p the leftmost-first match of R starts AT p (empty
always available, no look); it is non-empty iff core matches anchored at
p, in which case it equals core's anchored leftmost-first match (the
greedy chain argument: every chain prefix accepts, so the backtracker
never revisits a rep choice, and the chain steps through core's
priority-first matches — which is exactly how FindAll(core)'s restart
loop proceeds).  Gap positions between core matches yield empty matches
at every Go rune-step position, except a rejected empty exactly at a
core match end (start == prevMatchEnd rule).

The walk's empty positions are Go RUNE boundaries (allMatches advances
by utf8.DecodeRune width).  rune_boundary_mask computes them vectorized:
a position is a boundary unless it lies strictly inside a valid UTF-8
sequence that starts at a boundary; since valid sequences can only start
on non-continuation bytes, validity marks never overlap and the mask is
a local 4-byte-window computation (differentially tested against
utils/utf8.go_rune_width walks).

Scope: leftmost-first only (POSIX-longest keeps the host loop — the
dead-branch cut is invalid under longest semantics), and the empty match
must not be look-guarded: decompose() returns None whenever a look
appears anywhere it could gate the nullable path (`(\\bfoo)?` is fine —
the look is inside the non-nullable core; `(foo)?\\b` is not).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..syntax.ast import Node, Op
from .literal import is_nullable

_LOOK_OPS = (Op.BEGIN_TEXT, Op.END_TEXT, Op.BEGIN_LINE, Op.END_LINE,
             Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY)


@dataclass(frozen=True)
class Decomp:
    """core is the non-nullable projection AST; None means every match
    of R is empty (lazy-star / pure-empty shapes)."""
    core: Optional[Node]


ALL_EMPTY = Decomp(core=None)


def _repeat1(sub: Node, kmax: int) -> Node:
    """sub{1,kmax} (kmax == -1 -> sub+)."""
    if kmax == -1:
        return Node(Op.PLUS, greedy=True, subs=(sub,))
    if kmax == 1:
        return sub
    return Node(Op.REPEAT, greedy=True, min=1, max=kmax, subs=(sub,))


def decompose(node: Node) -> Optional[Decomp]:
    """Non-empty-projection decomposition of a NULLABLE ast, or None when
    out of scope (looks on the nullable path, multi-part nullable
    concats like a*b*, lazy counted repeats)."""
    op = node.op
    if op == Op.EMPTY:
        return ALL_EMPTY
    if op == Op.LITERAL and len(node.runes) == 0:
        return ALL_EMPTY
    if op in _LOOK_OPS:
        return None  # context-guarded empty: walk rules don't factorize
    if op == Op.CAPTURE:
        return decompose(node.subs[0])  # span extraction ignores groups
    if op in (Op.STAR, Op.PLUS):
        sub = node.subs[0]
        if not node.greedy:
            if op == Op.STAR:
                return ALL_EMPTY  # lazy star: empty tried first
            # lazy X+? with nullable X: one priority-first rep
            d = decompose(sub)
            return d
        if not is_nullable(sub):
            # (PLUS with non-nullable sub is not nullable; STAR only)
            return Decomp(core=Node(Op.PLUS, greedy=True, subs=(sub,)))
        d = decompose(sub)
        if d is None:
            return None
        if d.core is None:
            return ALL_EMPTY
        return Decomp(core=Node(Op.PLUS, greedy=True, subs=(d.core,)))
    if op == Op.QUEST:
        sub = node.subs[0]
        if not node.greedy:
            return ALL_EMPTY
        if not is_nullable(sub):
            return Decomp(core=sub)
        return decompose(sub)
    if op == Op.REPEAT:
        sub = node.subs[0]
        if node.max == 0:
            return ALL_EMPTY
        if not node.greedy:
            if node.min == 0:
                return ALL_EMPTY
            return None  # lazy counted with nullable body: host
        if not is_nullable(sub):
            # nullable only via min == 0
            return Decomp(core=_repeat1(sub, node.max))
        d = decompose(sub)
        if d is None:
            return None
        if d.core is None:
            return ALL_EMPTY
        return Decomp(core=_repeat1(d.core, node.max))
    if op == Op.CONCAT:
        # R nullable => every part nullable.  Parts whose matches are all
        # empty contribute nothing; a single surviving part carries the
        # whole match set.  Two+ surviving parts (a*b*) need the chain
        # composition — out of scope, host.
        live = []
        for s in node.subs:
            d = decompose(s)
            if d is None:
                return None
            if d.core is not None:
                live.append(d)
        if not live:
            return ALL_EMPTY
        if len(live) == 1:
            return live[0]
        return None
    if op == Op.ALTERNATE:
        # branches up to the first nullable one; later branches can never
        # be reached (the nullable branch always succeeds)
        pre = []
        for s in node.subs:
            if is_nullable(s):
                d = decompose(s)
                if d is None:
                    return None
                if d.core is not None:
                    pre.append(d.core)
                break
            pre.append(s)
        if not pre:
            return ALL_EMPTY
        if len(pre) == 1:
            return Decomp(core=pre[0])
        return Decomp(core=Node(Op.ALTERNATE, subs=tuple(pre)))
    return None  # non-nullable leaf in a nullable context: defensive


def decompose_checked(node: Node) -> Optional[Decomp]:
    """decompose() + the invariant the span path relies on: the core, if
    any, is genuinely non-nullable."""
    d = decompose(node)
    if d is not None and d.core is not None and is_nullable(d.core):
        return None  # pragma: no cover - decomposition bug guard
    return d


# ---------------------------------------------------------------------------
# Go rune-step boundaries, vectorized
# ---------------------------------------------------------------------------

def rune_boundary_mask(data: np.ndarray) -> np.ndarray:
    """[n+1] bool: positions Go's allMatches empty-advance walk can
    visit — p is a boundary unless strictly inside a valid UTF-8
    sequence (per utf8.DecodeRune: overlongs, surrogates, >U+10FFFF and
    truncations all decode width-1 and break no boundary)."""
    n = len(data)
    out = np.ones(n + 1, dtype=bool)
    if n == 0:
        return out
    d = data
    hasc = int(d.max()) < 0x80 if n else True
    if hasc:
        return out
    pad = np.zeros(n + 3, dtype=np.uint8)
    pad[:n] = d
    cont = (pad & 0xC0) == 0x80
    s2, s3, s4 = pad[1:n + 1], pad[2:n + 2], pad[3:n + 3]
    c2, c3, c4 = cont[1:n + 1], cont[2:n + 2], cont[3:n + 3]
    two = (d >= 0xC2) & (d <= 0xDF) & c2
    three = (((d == 0xE0) & (s2 >= 0xA0) & (s2 <= 0xBF))
             | ((d >= 0xE1) & (d <= 0xEC) & c2)
             | ((d == 0xED) & (s2 >= 0x80) & (s2 <= 0x9F))
             | ((d >= 0xEE) & (d <= 0xEF) & c2)) & c3
    four = (((d == 0xF0) & (s2 >= 0x90) & (s2 <= 0xBF))
            | ((d >= 0xF1) & (d <= 0xF3) & c2)
            | ((d == 0xF4) & (s2 >= 0x80) & (s2 <= 0x8F))) & c3 & c4
    ge2 = two | three | four
    ge3 = three | four
    out[1:n + 1] &= ~ge2
    out[2:n + 1] &= ~ge3[:n - 1]
    out[3:n + 1] &= ~four[:n - 2]
    return out


def fill_empties(core_spans: np.ndarray, n: int, data: np.ndarray,
                 limit: int = -1) -> np.ndarray:
    """Merge core (non-empty) spans with the empty matches Go's walk
    accepts: every rune-boundary position in [0, n] not covered by a
    core span and not equal to a core span's end (the
    start == prevMatchEnd rejection)."""
    B = rune_boundary_mask(data)
    m = len(core_spans)
    if m:
        S = core_spans[:, 0].astype(np.int64)
        E = core_spans[:, 1].astype(np.int64)
        diff = np.zeros(n + 2, dtype=np.int32)
        diff[S] += 1
        diff[E] -= 1
        covered = np.cumsum(diff[:n + 1]) > 0
        B &= ~covered
        B[E] = False
    pos = np.flatnonzero(B).astype(np.int64)
    k = len(pos)
    if m == 0:
        out = np.stack([pos, pos], axis=1)
        return out[:limit] if limit >= 0 else out
    out = np.empty((m + k, 2), dtype=np.int64)
    idx_core = np.arange(m) + np.searchsorted(pos, S)
    idx_emp = np.arange(k) + np.searchsorted(S, pos)
    out[idx_core, 0] = S
    out[idx_core, 1] = E
    out[idx_emp, 0] = pos
    out[idx_emp, 1] = pos
    return out[:limit] if limit >= 0 else out


def all_empty_spans(n: int, data: np.ndarray, limit: int = -1
                    ) -> np.ndarray:
    """Every match is empty: one span per rune boundary (all accepted —
    prevMatchEnd is always the previous boundary, never the current)."""
    pos = np.flatnonzero(rune_boundary_mask(data)).astype(np.int64)
    out = np.stack([pos, pos], axis=1)
    return out[:limit] if limit >= 0 else out
