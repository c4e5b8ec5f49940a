# Copy of coregex_tpu/meta/literal.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Literal analysis over the AST.

Capability analogue of the reference's literal/ package (extractor.go
prefix/suffix/inner extraction + Seq algebra) re-scoped for the TPU
strategies: exact-literal sets for the literal engines, inner-literal
splits (PrefixAST/SuffixAST, meta/reverse_inner.go:206-256 analogue) for
bidirectional candidate verification, and universal `.*` prefix/suffix
detection for the line-shape fast paths (the matchStartZero shortcut of
meta/reverse_suffix.go).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..syntax.ast import Node, Op, concat

MAX_LITERALS = 64
MAX_LIT_LEN = 64
MAX_CLASS_EXPAND = 8


def _rune_bytes(runes) -> Optional[bytes]:
    try:
        return "".join(chr(r) for r in runes).encode("utf-8")
    except (ValueError, UnicodeEncodeError):
        return None


def exact_literals(node: Node) -> Optional[List[bytes]]:
    """If `node` matches exactly a finite set of literals, return them in
    priority (alternation) order; else None.  Capture groups are
    transparent (spans are unaffected)."""
    op = node.op
    if op == Op.EMPTY:
        return [b""]
    if op == Op.LITERAL:
        b = _rune_bytes(node.runes)
        return None if b is None or len(b) > MAX_LIT_LEN else [b]
    if op == Op.CHAR_CLASS:
        if holds_invalid(node.ranges):
            return None
        chars = []
        for lo, hi in node.ranges:
            if hi - lo + 1 > MAX_CLASS_EXPAND:
                return None
            chars.extend(range(lo, hi + 1))
            if len(chars) > MAX_CLASS_EXPAND:
                return None
        return [_rune_bytes((c,)) for c in chars]
    if op == Op.CAPTURE:
        return exact_literals(node.subs[0])
    if op == Op.CONCAT:
        parts: List[List[bytes]] = []
        for sub in node.subs:
            p = exact_literals(sub)
            if p is None:
                return None
            parts.append(p)
        out = [b""]
        for p in parts:
            out = [a + b for a in out for b in p]
            if len(out) > MAX_LITERALS:
                return None
        return [o for o in out if len(o) <= MAX_LIT_LEN] \
            if all(len(o) <= MAX_LIT_LEN for o in out) else None
    if op == Op.ALTERNATE:
        out: List[bytes] = []
        for sub in node.subs:
            p = exact_literals(sub)
            if p is None:
                return None
            out.extend(p)
            if len(out) > MAX_LITERALS:
                return None
        return out
    return None


def ascii_class_table(node: Node) -> Optional[List[bool]]:
    """256-entry membership table for a single-byte-matching class node."""
    if node.op == Op.CHAR_CLASS:
        if not node.ranges or node.ranges[-1][1] >= 0x80:
            return None
        table = [False] * 256
        for lo, hi in node.ranges:
            for b in range(lo, hi + 1):
                table[b] = True
        return table
    if node.op == Op.LITERAL and len(node.runes) == 1 and node.runes[0] < 0x80:
        table = [False] * 256
        table[node.runes[0]] = True
        return table
    return None


@dataclass
class CharClassShape:
    """Pattern is exactly [class]{m,k} (greedy), m >= 1; k == -1 unbounded.

    `plus` marks the ([class]{m,k})+ whole-run form (the reference's "word
    repeat" benchmark class, README.md:79): one leftmost-first match per
    maximal class run of length L >= m, of length L - (L%k if L%k < m
    else 0) — greedy chunks of k plus a final remainder chunk iff it still
    satisfies {m,k}."""
    table: List[bool]
    min: int
    max: int  # -1 unbounded
    plus: bool = False


def _uncap(node: Node) -> Node:
    while node.op == Op.CAPTURE:
        node = node.subs[0]
    return node


def charclass_shape(node: Node) -> Optional[CharClassShape]:
    if node.op == Op.CAPTURE:
        inner = charclass_shape(node.subs[0])
        return inner
    if node.op == Op.PLUS and node.greedy:
        sub = _uncap(node.subs[0])
        t = ascii_class_table(sub)
        if t is not None:
            return CharClassShape(t, 1, -1)
        # ([class]{m,k})+  — whole-run with remainder adjustment.  With an
        # unbounded inner (k == -1) one greedy iteration eats the whole
        # run, so it degenerates to [class]{m,}.
        if sub.op == Op.REPEAT and sub.greedy and sub.min >= 1:
            ti = ascii_class_table(_uncap(sub.subs[0]))
            if ti is not None:
                if sub.max == -1:
                    return CharClassShape(ti, sub.min, -1)
                return CharClassShape(ti, sub.min, sub.max, plus=True)
        if sub.op == Op.PLUS and sub.greedy:
            ti = ascii_class_table(_uncap(sub.subs[0]))
            if ti is not None:
                return CharClassShape(ti, 1, -1)
    if node.op == Op.REPEAT and node.greedy and node.min >= 1:
        t = ascii_class_table(node.subs[0])
        if t is not None:
            return CharClassShape(t, node.min, node.max)
    t = ascii_class_table(node)
    if t is not None:
        return CharClassShape(t, 1, 1)
    return None


UNIV_NONE = 0
UNIV_LINE = 1   # (?-s) .*   — bounded by line
UNIV_ANY = 2    # (?s) .*    — unbounded


def _universality(node: Node) -> int:
    """Is this node a universal greedy star (`.*` / `(?s).*`)?"""
    if node.op == Op.STAR and node.greedy:
        sub = node.subs[0]
        if sub.op == Op.ANY_NOT_NL:
            return UNIV_LINE
        if sub.op == Op.ANY_CHAR:
            return UNIV_ANY
        if sub.op == Op.CHAR_CLASS:
            # [^x]* style is not universal; only full-range classes
            covered = sum(hi - lo + 1 for lo, hi in sub.ranges)
            if covered >= 0x110000 - 1:
                return UNIV_ANY
    return UNIV_NONE


@dataclass
class InnerSplit:
    """concat(A, lits, B) decomposition for candidate verification.

    `lits` is the full inner literal SET (1..8 needles — extraction
    through alternations and adjacent-child cross products, the
    ExtractInner-through-alternation capability of the reference's
    literal/extractor.go:1027-1165); `lit` is its first member and the
    only one consulted by the single-needle line-shape paths (which
    require len(lits) == 1)."""
    lit: bytes
    prefix_ast: Node           # A · lits  (reverse-DFA verification target)
    suffix_ast: Node           # B
    prefix_universal: int      # UNIV_* of A (when A is a single univ star)
    suffix_universal: int      # UNIV_* of B
    line_anchored: bool        # A begins with (?m)^
    prefix_literal: bytes      # literal bytes that must begin the line
    # (only meaningful when line_anchored and A == ^ P .*)
    lits: Optional[List[bytes]] = None

    def __post_init__(self):
        if self.lits is None:
            self.lits = [self.lit]


# Bytes common in natural text / logs: candidate scans keyed on one of
# these drown in false positives.  Everything else (mostly punctuation and
# control bytes: @ # $ % ^ & * | \ ~ { } [ ] < > = + ; ? !) is rare enough
# to anchor an inner-literal scan on — the TPU reframing of the
# reference's empirical byte-frequency ranking (simd/byte_frequencies.go:18
# SelectRareBytes), which serves the same purpose for memmem needles.
_COMMON_BYTES = frozenset(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    b" \t\n\r.,-_'\"/:)(")


def is_rare_byte(b: int) -> bool:
    return b not in _COMMON_BYTES


def inner_split(root: Node) -> Optional[InnerSplit]:
    """Find the best single inner literal in a top-level concatenation.

    Literals of length >= 2 are always usable; a length-1 literal is
    accepted only when its byte is rare (is_rare_byte), which unlocks the
    email class `[\\w.+-]+@[\\w.-]+\\.[\\w.-]+` — candidates keyed on the
    `@` (the reference routes this through its digit/rare-byte prefilter
    machinery, prefilter/prefilter.go:249-297)."""
    node = root
    while node.op == Op.CAPTURE:
        node = node.subs[0]
    if node.op != Op.CONCAT:
        # a lone literal with nothing around it is the LITERAL strategy;
        # here we only handle genuine splits
        return None
    children = list(node.subs)

    best_i = -1
    best_j = -1  # run end (exclusive); single children have j == i + 1
    best_lit: Optional[bytes] = None
    best_set: Optional[List[bytes]] = None
    rare_i = -1
    rare_lit: Optional[bytes] = None
    for i, ch in enumerate(children):
        lits = exact_literals(ch)
        if lits is None or len(lits) != 1:
            continue
        l = lits[0]
        if len(l) >= 2:
            if best_lit is None or len(l) > len(best_lit):
                best_i, best_j, best_lit = i, i + 1, l
        elif len(l) == 1 and is_rare_byte(l[0]) and rare_lit is None:
            rare_i, rare_lit = i, l
    # literal SET through alternations / adjacent-child cross products
    # (the reference's inner extraction through alternations,
    # literal/extractor.go:1027-1165): find the run of children whose
    # cross product is 2..8 literals of min length >= 2, maximizing the
    # shortest needle (rarer candidates).  The set wins over a single
    # exact literal only when its shortest needle is strictly longer.
    MAX_SET, MAX_SET_LEN = 8, 32
    set_i = set_j = -1
    set_lits: Optional[List[bytes]] = None
    for i in range(len(children)):
        prod = [b""]
        j = i
        while j < len(children):
            ls = exact_literals(children[j])
            if ls is None:
                break
            nxt = [a + b for a in prod for b in ls]
            if len(nxt) > MAX_SET or \
                    any(len(x) > MAX_SET_LEN for x in nxt):
                break
            prod = nxt
            j += 1
            score = min((len(x) for x in prod), default=0)
            if j > i and 2 <= len(prod) <= MAX_SET and score >= 2:
                if set_lits is None or score > min(
                        len(x) for x in set_lits):
                    set_i, set_j, set_lits = i, j, list(prod)
    if set_lits is not None and (
            best_lit is None
            or min(len(x) for x in set_lits) > len(best_lit) + 1):
        best_i, best_j, best_set = set_i, set_j, set_lits
        best_lit = best_set[0]
    if best_lit is None and rare_lit is not None:
        best_i, best_j, best_lit = rare_i, rare_i + 1, rare_lit
    if best_lit is None:
        return None

    A = children[:best_i]
    B = children[best_j:]
    prefix_ast = concat(children[:best_j])
    suffix_ast = concat(B)

    prefix_universal = UNIV_NONE
    line_anchored = False
    prefix_literal = b""
    if len(A) == 0:
        prefix_universal = UNIV_NONE  # literal starts the match
    elif len(A) == 1:
        prefix_universal = _universality(A[0])
    elif A and A[0].op == Op.BEGIN_LINE:
        # (?m)^ P .* lit...
        rest = A[1:]
        if rest and _universality(rest[-1]) != UNIV_NONE:
            plits = exact_literals(concat(rest[:-1])) if len(rest) > 1 \
                else [b""]
            if plits is not None and len(plits) == 1:
                line_anchored = True
                prefix_literal = plits[0]
                prefix_universal = _universality(rest[-1])

    suffix_universal = UNIV_NONE
    if len(B) == 1:
        suffix_universal = _universality(B[0])
    elif len(B) == 0:
        suffix_universal = UNIV_NONE

    return InnerSplit(
        lit=best_lit,
        prefix_ast=prefix_ast,
        suffix_ast=suffix_ast,
        prefix_universal=prefix_universal,
        suffix_universal=suffix_universal,
        line_anchored=line_anchored,
        prefix_literal=prefix_literal,
        lits=best_set if best_set is not None else [best_lit],
    )


@dataclass
class PrefixRunShape:
    """Pattern = [class]+ · rest (greedy, unbounded): match starts are
    closed leftward within class runs, so run starts are sufficient
    candidates (the DigitPrefilter analogue, prefilter/digit.go:15-60)."""
    table: List[bool]          # 256-entry membership of the leading class


def prefix_run_shape(root: Node) -> Optional[PrefixRunShape]:
    node = root
    while node.op == Op.CAPTURE:
        node = node.subs[0]
    if node.op != Op.CONCAT or not node.subs:
        return None
    head = node.subs[0]
    while head.op == Op.CAPTURE:
        head = head.subs[0]
    ok = (head.op == Op.PLUS and head.greedy) or (
        head.op == Op.REPEAT and head.greedy and head.min >= 1
        and head.max == -1)
    if not ok:
        return None
    t = ascii_class_table(head.subs[0])
    if t is None:
        return None
    return PrefixRunShape(t)


def is_nullable(node: Node) -> bool:
    """Can the pattern match the empty string?"""
    op = node.op
    if op in (Op.EMPTY, Op.STAR, Op.QUEST):
        return True
    if op in (Op.BEGIN_LINE, Op.END_LINE, Op.BEGIN_TEXT, Op.END_TEXT,
              Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY):
        return True
    if op == Op.LITERAL:
        return len(node.runes) == 0
    if op in (Op.CHAR_CLASS, Op.ANY_CHAR, Op.ANY_NOT_NL):
        return False
    if op == Op.PLUS:
        return is_nullable(node.subs[0])
    if op == Op.REPEAT:
        return node.min == 0 or is_nullable(node.subs[0])
    if op == Op.CAPTURE:
        return is_nullable(node.subs[0])
    if op == Op.CONCAT:
        return all(is_nullable(s) for s in node.subs)
    if op == Op.ALTERNATE:
        return any(is_nullable(s) for s in node.subs)
    return False


_LOOK_OPS = (Op.BEGIN_TEXT, Op.END_TEXT, Op.BEGIN_LINE, Op.END_LINE,
             Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY)


def has_looks(node: Node) -> bool:
    """Any look-around assertion anywhere in the AST (anchors, \\b/\\B).
    Gates the bitset-NFA device fallback, whose epsilon closure is
    context-free (ops/nfa_scan.py)."""
    if node.op in _LOOK_OPS:
        return True
    return any(has_looks(s) for s in (node.subs or ()))


def has_start_anchor(node: Node) -> bool:
    """Pattern can only match at text start (every alternative begins \\A/^
    non-multiline)."""
    op = node.op
    if op == Op.BEGIN_TEXT:
        return True
    if op == Op.CAPTURE:
        return has_start_anchor(node.subs[0])
    if op == Op.CONCAT:
        for s in node.subs:
            if has_start_anchor(s):
                return True
            if not is_nullable(s):
                return False
        return False
    if op == Op.ALTERNATE:
        return all(has_start_anchor(s) for s in node.subs)
    return False


def has_end_anchor(node: Node) -> bool:
    """Every match ends exactly at end of text (every alternative ends with
    `$`/`\\z` — Go's `$` is \\z outside (?m)).  Such patterns get the
    ReverseAnchoredSearcher treatment (meta/reverse_anchored.go:33): one
    O(match-length) backward scan from the end instead of an O(n) forward
    scan."""
    op = node.op
    if op == Op.END_TEXT:
        return True
    if op == Op.CAPTURE:
        return has_end_anchor(node.subs[0])
    if op == Op.CONCAT:
        for s in reversed(node.subs):
            if has_end_anchor(s):
                return True
            if not is_nullable(s):
                return False
        return False
    if op == Op.ALTERNATE:
        return all(has_end_anchor(s) for s in node.subs)
    return False


def holds_invalid(ranges) -> bool:
    """Whether a class holds U+FFFD, and so matches each invalid byte as one
    character (nfa/thompson.py): no finite literal set describes it (a
    change of the port; the reference expands it to EF BF BD)."""
    return any(lo <= 0xFFFD <= hi for lo, hi in ranges)


def _lead_bytes_of_range(lo: int, hi: int, out: set) -> None:
    """Add every possible UTF-8 lead byte of runes in [lo, hi] to `out`.
    Over-approximation is sound here (the set is used for rejection)."""
    bounds = [(0x00, 0x7F), (0x80, 0x7FF), (0x800, 0xFFFF),
              (0x10000, 0x10FFFF)]
    for blo, bhi in bounds:
        a, b = max(lo, blo), min(hi, bhi)
        if a > b:
            continue
        la = ("".join(chr(a)).encode("utf-8", "surrogatepass"))[0] \
            if a < 0xD800 or a > 0xDFFF else 0xED
        lb = ("".join(chr(b)).encode("utf-8", "surrogatepass"))[0] \
            if b < 0xD800 or b > 0xDFFF else 0xED
        for x in range(la, lb + 1):
            out.add(x)


def first_bytes(node: Node, budget: int = 200) -> Optional[set]:
    """Complete (possibly over-approximate) set of bytes a match can start
    with, or None when no useful set exists (FirstByteSet analogue,
    reference nfa/firstbytes.go:8-41).  None for nullable patterns (an
    empty match has no first byte) and for all-byte sets."""
    if is_nullable(node):
        return None

    def walk(n: Node) -> Optional[set]:
        op = n.op
        if op == Op.LITERAL:
            if not n.runes:
                return set()
            try:
                b = chr(n.runes[0]).encode("utf-8")
            except (ValueError, UnicodeEncodeError):
                return None
            return {b[0]}
        if op == Op.CHAR_CLASS:
            if holds_invalid(n.ranges):
                # an invalid byte (0x80-0xC1 among them) starts a match:
                # a skip to such a byte could land inside a valid rune (a
                # change of the port)
                return None
            out: set = set()
            for lo, hi in n.ranges:
                _lead_bytes_of_range(lo, hi, out)
                if len(out) > budget:
                    return None
            return out
        if op in (Op.ANY_CHAR, Op.ANY_NOT_NL):
            return None  # all/most bytes: not useful
        if op == Op.CAPTURE:
            return walk(n.subs[0])
        if op in (Op.STAR, Op.PLUS, Op.QUEST, Op.REPEAT):
            return walk(n.subs[0])
        if op in (Op.BEGIN_TEXT, Op.BEGIN_LINE, Op.END_TEXT, Op.END_LINE,
                  Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY, Op.EMPTY):
            return set()  # zero-width: contributes nothing
        if op == Op.CONCAT:
            acc: set = set()
            for s in n.subs:
                fb = walk(s)
                if fb is None:
                    return None
                acc |= fb
                if len(acc) > budget:
                    return None
                if not is_nullable(s):
                    return acc
            return acc
        if op == Op.ALTERNATE:
            acc = set()
            for s in n.subs:
                fb = walk(s)
                if fb is None:
                    return None
                acc |= fb
                if len(acc) > budget:
                    return None
            return acc
        return None

    out = walk(node)
    if not out or len(out) >= 256:
        return None  # IsUseful gate: complete and 0 < count < 256
    return out


@dataclass
class LineSetSplit:
    """Line shape around an exact literal ALTERNATION — the reference's
    ReverseSuffixSetSearcher shape (meta/reverse_suffix_set.go:
    `.*\\.(txt|log|md)`), generalized to any `[^|.*][lits](.*)` line form.
    One match per line containing any set member, so Count reduces to the
    any-of line-hit machine."""
    lits: List[bytes]
    prefix_literal: bytes
    line_anchored: bool


def line_set_split(root: Node) -> Optional[LineSetSplit]:
    node = root
    while node.op == Op.CAPTURE:
        node = node.subs[0]
    if node.op != Op.CONCAT:
        return None
    ch = list(node.subs)
    b_univ = UNIV_NONE
    if ch and _universality(ch[-1]) == UNIV_LINE:
        b_univ = UNIV_LINE
        ch = ch[:-1]
    line_anchored = False
    prefix = b""
    a_univ = UNIV_NONE
    if ch and ch[0].op == Op.BEGIN_LINE:
        rest = ch[1:]
        for k, c in enumerate(rest):
            if _universality(c) == UNIV_LINE:
                plits = (exact_literals(concat(rest[:k]))
                         if k else [b""])
                if plits is None or len(plits) != 1:
                    return None
                line_anchored = True
                prefix = plits[0]
                ch = rest[k + 1:]
                break
        else:
            return None
    elif ch and _universality(ch[0]) == UNIV_LINE:
        a_univ = UNIV_LINE
        ch = ch[1:]
    if not ch:
        return None
    lits = exact_literals(concat(ch))
    if lits is None or not (2 <= len(lits) <= 32):
        return None
    if any(len(l) == 0 for l in lits):
        return None
    if a_univ == UNIV_NONE and not line_anchored and b_univ == UNIV_NONE:
        return None  # pure alternation: MULTI_LITERAL's business
    return LineSetSplit(lits=lits, prefix_literal=prefix,
                        line_anchored=line_anchored)
