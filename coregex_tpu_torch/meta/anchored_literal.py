# Copy of coregex_tpu/meta/anchored_literal.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""AnchoredLiteral: fully-anchored literal shapes as pure byte ops.

Capability analogue of the reference's AnchoredLiteral strategy
(meta/anchored_literal.go:24-66 DetectAnchoredLiteral): patterns like
`^prefix.*suffix$` or `^prefix[class]+suffix$` need no automaton at all —
an O(1) length check, prefix/suffix comparison, and a vectorizable middle
class check.  Used by the host engine for small inputs and by the batch
layer for per-line anchored matching.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..syntax.ast import Node, Op
from .literal import ascii_class_table, exact_literals


@dataclass
class AnchoredLiteralInfo:
    prefix: bytes
    suffix: bytes
    # middle: None == empty (exact literal match), "any" == (?s).* ,
    # "any_nl" == .*, otherwise a 256-entry membership table with min count
    middle_kind: str            # "none" | "any" | "any_nl" | "class"
    middle_table: Optional[List[bool]] = None
    middle_min: int = 0
    middle_max: int = -1


def detect(root: Node) -> Optional[AnchoredLiteralInfo]:
    node = root
    while node.op == Op.CAPTURE:
        node = node.subs[0]
    if node.op != Op.CONCAT or len(node.subs) < 2:
        return None
    subs = list(node.subs)
    if subs[0].op != Op.BEGIN_TEXT or subs[-1].op != Op.END_TEXT:
        return None
    inner = subs[1:-1]
    if not inner:
        return AnchoredLiteralInfo(b"", b"", "none")

    def lit_of(nodes) -> Optional[bytes]:
        if not nodes:
            return b""
        from ..syntax.ast import concat
        lits = exact_literals(concat(nodes))
        if lits is not None and len(lits) == 1:
            return lits[0]
        return None

    # find a middle wildcard/class element
    for i, ch in enumerate(inner):
        kind = None
        table = None
        mmin, mmax = 0, -1
        if ch.op == Op.STAR and ch.greedy:
            sub = ch.subs[0]
            if sub.op == Op.ANY_CHAR:
                kind = "any"
            elif sub.op == Op.ANY_NOT_NL:
                kind = "any_nl"
            else:
                table = ascii_class_table(sub)
                if table is not None:
                    kind = "class"
                    mmin = 0
        elif ch.op == Op.PLUS and ch.greedy:
            sub = ch.subs[0]
            table = ascii_class_table(sub)
            if table is not None:
                kind = "class"
                mmin = 1
        if kind is None:
            continue
        prefix = lit_of(inner[:i])
        suffix = lit_of(inner[i + 1:])
        if prefix is None or suffix is None:
            continue
        return AnchoredLiteralInfo(prefix, suffix, kind, table, mmin, mmax)

    whole = lit_of(inner)
    if whole is not None:
        return AnchoredLiteralInfo(whole, b"", "none")
    return None


def match_span(info: AnchoredLiteralInfo, data: np.ndarray
               ) -> Optional[Tuple[int, int]]:
    """O(len) anchored check; returns (0, n) span or None."""
    n = len(data)
    p, s = info.prefix, info.suffix
    if info.middle_kind == "none":
        if n != len(p):
            return None
        if n and not np.array_equal(data, np.frombuffer(p, dtype=np.uint8)):
            return None
        return (0, n)
    if n < len(p) + len(s) + info.middle_min:
        return None
    if len(p) and not np.array_equal(
            data[:len(p)], np.frombuffer(p, dtype=np.uint8)):
        return None
    if len(s) and not np.array_equal(
            data[n - len(s):], np.frombuffer(s, dtype=np.uint8)):
        return None
    mid = data[len(p):n - len(s)]
    if info.middle_kind == "any":
        return (0, n)
    if info.middle_kind == "any_nl":
        if len(mid) and (mid == 10).any():
            return None
        return (0, n)
    table = np.array(info.middle_table, dtype=bool)
    if len(mid) and not table[mid].all():
        return None
    return (0, n)
