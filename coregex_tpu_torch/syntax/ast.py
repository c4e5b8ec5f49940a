# Copy of coregex_tpu/syntax/ast.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Regex AST for the Go `regexp/syntax` Perl dialect.

Mirrors the op set consumed by the reference NFA compiler
(its nfa/compile.go:177-232) but re-expressed as a small Python
dataclass tree.  Classes are codepoint ranges; case-folding and flag
resolution happen at parse time so the AST is flag-free.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

MAX_RUNE = 0x10FFFF


class Op(enum.IntEnum):
    EMPTY = 0          # matches empty string
    LITERAL = 1        # matches a fixed sequence of codepoints
    CHAR_CLASS = 2     # matches one codepoint from ranges
    ANY_CHAR = 3       # matches any codepoint including \n  ((?s:.))
    ANY_NOT_NL = 4     # matches any codepoint except \n  (.)
    BEGIN_LINE = 5     # (?m:^)
    END_LINE = 6       # (?m:$)
    BEGIN_TEXT = 7     # \A or ^ without m
    END_TEXT = 8       # \z or $ without m
    WORD_BOUNDARY = 9  # \b  (ASCII, like Go)
    NO_WORD_BOUNDARY = 10  # \B
    CAPTURE = 11       # (sub)
    STAR = 12          # sub*
    PLUS = 13          # sub+
    QUEST = 14         # sub?
    REPEAT = 15        # sub{m,n}
    CONCAT = 16
    ALTERNATE = 17
    NO_MATCH = 18      # matches nothing (empty class)


# ranges: sorted, non-overlapping, inclusive [(lo, hi), ...]
Ranges = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class Node:
    op: Op
    # LITERAL: runes = tuple of codepoints
    runes: Tuple[int, ...] = ()
    # CHAR_CLASS: ranges
    ranges: Ranges = ()
    # CAPTURE: group index (1-based) and optional name
    group: int = 0
    name: Optional[str] = None
    # STAR/PLUS/QUEST/REPEAT
    greedy: bool = True
    min: int = 0
    max: int = -1  # -1 == unbounded
    subs: Tuple["Node", ...] = ()

    def __repr__(self) -> str:  # compact, for debugging
        if self.op == Op.LITERAL:
            return f"Lit({''.join(chr(r) for r in self.runes)!r})"
        if self.op == Op.CHAR_CLASS:
            return f"Class({self.ranges})"
        if self.op in (Op.STAR, Op.PLUS, Op.QUEST):
            g = "" if self.greedy else "?"
            return f"{self.op.name}{g}({self.subs[0]!r})"
        if self.op == Op.REPEAT:
            g = "" if self.greedy else "?"
            return f"Repeat{{{self.min},{self.max}}}{g}({self.subs[0]!r})"
        if self.op == Op.CAPTURE:
            return f"Cap{self.group}({self.subs[0]!r})"
        if self.op in (Op.CONCAT, Op.ALTERNATE):
            sep = "" if self.op == Op.CONCAT else "|"
            return f"({sep.join(map(repr, self.subs))})" if sep else f"Cat{list(self.subs)!r}"
        return self.op.name


def lit(runes) -> Node:
    if isinstance(runes, str):
        runes = tuple(ord(c) for c in runes)
    return Node(Op.LITERAL, runes=tuple(runes))


def cls(ranges) -> Node:
    return Node(Op.CHAR_CLASS, ranges=normalize_ranges(ranges))


def concat(subs) -> Node:
    subs = tuple(subs)
    if not subs:
        return Node(Op.EMPTY)
    if len(subs) == 1:
        return subs[0]
    return Node(Op.CONCAT, subs=subs)


def alternate(subs) -> Node:
    subs = tuple(subs)
    if not subs:
        return Node(Op.NO_MATCH)
    if len(subs) == 1:
        return subs[0]
    return Node(Op.ALTERNATE, subs=subs)


def normalize_ranges(ranges) -> Ranges:
    """Sort + merge overlapping/adjacent inclusive ranges."""
    rs = sorted((int(lo), int(hi)) for lo, hi in ranges if lo <= hi)
    out: List[Tuple[int, int]] = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return tuple(out)


def negate_ranges(ranges, max_rune: int = MAX_RUNE) -> Ranges:
    ranges = normalize_ranges(ranges)
    out: List[Tuple[int, int]] = []
    next_lo = 0
    for lo, hi in ranges:
        if lo > next_lo:
            out.append((next_lo, lo - 1))
        next_lo = max(next_lo, hi + 1)
    if next_lo <= max_rune:
        out.append((next_lo, max_rune))
    return tuple(out)


def ranges_union(a, b) -> Ranges:
    return normalize_ranges(list(a) + list(b))


def ranges_contain(ranges, cp: int) -> bool:
    for lo, hi in ranges:
        if lo <= cp <= hi:
            return True
    return False


# Common classes (ASCII semantics, matching Go's Perl classes; Go \d\s\w are
# ASCII-only per regexp/syntax doc).
PERL_D: Ranges = ((ord("0"), ord("9")),)
PERL_S: Ranges = ((0x09, 0x0A), (0x0B, 0x0D), (0x20, 0x20))
PERL_W: Ranges = ((ord("0"), ord("9")), (ord("A"), ord("Z")),
                  (ord("_"), ord("_")), (ord("a"), ord("z")))

POSIX_CLASSES = {
    "alnum": ((0x30, 0x39), (0x41, 0x5A), (0x61, 0x7A)),
    "alpha": ((0x41, 0x5A), (0x61, 0x7A)),
    "ascii": ((0x00, 0x7F),),
    "blank": ((0x09, 0x09), (0x20, 0x20)),
    "cntrl": ((0x00, 0x1F), (0x7F, 0x7F)),
    "digit": ((0x30, 0x39),),
    "graph": ((0x21, 0x7E),),
    "lower": ((0x61, 0x7A),),
    "print": ((0x20, 0x7E),),
    "punct": ((0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)),
    "space": ((0x09, 0x0D), (0x20, 0x20)),
    "upper": ((0x41, 0x5A),),
    "word": ((0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)),
    "xdigit": ((0x30, 0x39), (0x41, 0x46), (0x61, 0x66)),
}
