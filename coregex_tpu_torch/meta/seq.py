# Copy of coregex_tpu/meta/seq.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Literal sequence (Seq) algebra + prefix extractor.

Capability analogue of the reference's literal/ package: the `Seq` type
with its operations (literal/seq.go:93 — LongestCommonPrefix/Suffix :343,
:394, CrossForward :433, KeepFirstBytes :470, Dedup :491, Minimize :278)
and the prefix extractor (literal/extractor.go:128 ExtractPrefixes, with
the 250-entry overflow → trim + dedup + inexact marking of
extractor.go:177-365).  Re-designed for the TPU engine: the extracted
prefix set feeds the PREFIX_SET strategy, where candidate match *starts*
come from one multi-needle compare scan and verification is a batch of
forward-anchored DFA windows — no reverse scan at all (the reference
instead builds memmem/Teddy prefilters around these literals,
prefilter/prefilter.go:249-297).

A `Seq` is either *finite* (a list of `Lit`) or *infinite* (None): the
bottom element that poisons extraction.  A finite Seq is always
*complete* in the coverage sense: every string the pattern matches begins
with one of the sequence's literals.  (The reference additionally tracks
partial coverage for prefilter-only use, literal/seq.go:104; we poison
instead, because PREFIX_SET uses the set as the *only* source of
candidate starts.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..syntax.ast import Node, Op

MAX_LITS = 64          # overflow → minimize, then poison
MAX_LIT_LEN = 16       # longer literals are cut (still exact candidates
#                        for *starts*: a cut prefix stays a true prefix)
MAX_CLASS_EXPAND = 10  # reference expands classes ≤10 chars (extractor.go:963)


@dataclass(frozen=True)
class Lit:
    """One literal: `exact` means the pattern's match is exactly these
    bytes so far; inexact literals are true *prefixes* of any match but
    cannot be extended by cross products (literal/seq.go:27-44)."""
    b: bytes
    exact: bool = True

    def inexact(self) -> "Lit":
        return Lit(self.b, False) if self.exact else self


class Seq:
    """An ordered sequence of literals, or the infinite sequence (None).

    Order is alternation priority order, preserved through union and
    cross so leftmost-first candidate ranking survives extraction.
    """

    __slots__ = ("lits",)

    def __init__(self, lits: Optional[List[Lit]]):
        self.lits = lits

    # -- constructors --------------------------------------------------
    @staticmethod
    def infinite() -> "Seq":
        return Seq(None)

    @staticmethod
    def empty() -> "Seq":
        """Matches only the empty string (exact epsilon)."""
        return Seq([Lit(b"", True)])

    @staticmethod
    def singleton(b: bytes, exact: bool = True) -> "Seq":
        return Seq([Lit(b, exact)])

    # -- predicates ----------------------------------------------------
    @property
    def is_finite(self) -> bool:
        return self.lits is not None

    def all_exact(self) -> bool:
        return self.is_finite and all(l.exact for l in self.lits)

    def min_len(self) -> int:
        if not self.is_finite or not self.lits:
            return 0
        return min(len(l.b) for l in self.lits)

    def max_len(self) -> int:
        if not self.is_finite or not self.lits:
            return 0
        return max(len(l.b) for l in self.lits)

    # -- algebra (CrossForward, union — literal/seq.go:433, :236) ------
    def cross(self, other: "Seq") -> "Seq":
        """Concatenation product.  Inexact literals cannot be extended:
        they pass through unchanged (they already are true prefixes)."""
        if not self.is_finite:
            return self
        if not other.is_finite:
            # every exact literal becomes an inexact prefix
            return Seq([l.inexact() for l in self.lits]).dedup()
        out: List[Lit] = []
        for a in self.lits:
            if not a.exact:
                out.append(a)
                continue
            for b in other.lits:
                out.append(Lit(a.b + b.b, b.exact))
        if len(out) > MAX_LITS:
            return Seq(out).minimize()
        return Seq(out)

    def union(self, other: "Seq") -> "Seq":
        if not self.is_finite or not other.is_finite:
            return Seq.infinite()
        out = self.lits + other.lits
        if len(out) > MAX_LITS:
            return Seq(out).minimize()
        return Seq(out)

    def inexact(self) -> "Seq":
        if not self.is_finite:
            return self
        return Seq([l.inexact() for l in self.lits]).dedup()

    # -- normalization (KeepFirstBytes/Dedup/Minimize) ------------------
    def keep_first_bytes(self, k: int) -> "Seq":
        """Truncate every literal to its first k bytes; truncated literals
        become inexact (literal/seq.go:470)."""
        if not self.is_finite:
            return self
        out = [Lit(l.b[:k], l.exact and len(l.b) <= k) for l in self.lits]
        return Seq(out)

    def dedup(self) -> "Seq":
        """Drop duplicates and literals shadowed by an earlier *inexact*
        prefix (for start candidates, an inexact prefix subsumes every
        longer literal it prefixes)."""
        if not self.is_finite:
            return self
        out: List[Lit] = []
        for l in self.lits:
            dominated = False
            for p in out:
                if p.b == l.b or (not p.exact and l.b.startswith(p.b)):
                    dominated = True
                    break
            if not dominated:
                out.append(l)
        return Seq(out)

    def minimize(self, target: int = MAX_LITS, floor: int = 2) -> "Seq":
        """Shrink an over-long sequence by repeated truncate+dedup, the
        reference's 250-entry overflow handling (extractor.go:283-365);
        poison if it cannot reach `target` above the length floor."""
        if not self.is_finite:
            return self
        s = self.keep_first_bytes(MAX_LIT_LEN).dedup()
        k = s.max_len()
        while len(s.lits) > target and k > floor:
            k -= 1
            s = s.keep_first_bytes(k).dedup()
        if len(s.lits) > target:
            return Seq.infinite()
        return s

    # -- measures (literal/seq.go:343,394) -------------------------------
    def longest_common_prefix(self) -> bytes:
        if not self.is_finite or not self.lits:
            return b""
        p = self.lits[0].b
        for l in self.lits[1:]:
            m = 0
            for x, y in zip(p, l.b):
                if x != y:
                    break
                m += 1
            p = p[:m]
            if not p:
                break
        return p

    def longest_common_suffix(self) -> bytes:
        if not self.is_finite or not self.lits:
            return b""
        p = self.lits[0].b
        for l in self.lits[1:]:
            m = 0
            for x, y in zip(reversed(p), reversed(l.b)):
                if x != y:
                    break
                m += 1
            p = p[len(p) - m:] if m else b""
            if not p:
                break
        return p

    def __repr__(self) -> str:
        if not self.is_finite:
            return "Seq(∞)"
        return "Seq(%s)" % ", ".join(
            ("%r" % l.b) + ("" if l.exact else "~") for l in self.lits)


def _rune_bytes(runes) -> Optional[bytes]:
    try:
        return "".join(chr(r) for r in runes).encode("utf-8")
    except (ValueError, UnicodeEncodeError):
        return None


def _class_seq(node: Node) -> Seq:
    chars: List[int] = []
    for lo, hi in node.ranges:
        if hi - lo + 1 > MAX_CLASS_EXPAND:
            return Seq.infinite()
        chars.extend(range(lo, hi + 1))
        if len(chars) > MAX_CLASS_EXPAND:
            return Seq.infinite()
    lits = []
    for c in chars:
        b = _rune_bytes((c,))
        if b is None:
            return Seq.infinite()
        lits.append(Lit(b, True))
    return Seq(lits)


def prefixes(node: Node) -> Seq:
    """Prefix sequence of `node` (ExtractPrefixes analogue,
    literal/extractor.go:128): a Seq whose literals begin every possible
    match.  Infinite when no useful finite prefix set exists."""
    op = node.op
    if op == Op.EMPTY:
        return Seq.empty()
    if op == Op.LITERAL:
        b = _rune_bytes(node.runes)
        if b is None:
            return Seq.infinite()
        if len(b) > MAX_LIT_LEN:
            return Seq.singleton(b[:MAX_LIT_LEN], exact=False)
        return Seq.singleton(b, exact=True)
    if op == Op.CHAR_CLASS:
        return _class_seq(node)
    if op in (Op.ANY_CHAR, Op.ANY_NOT_NL):
        return Seq.infinite()
    if op == Op.CAPTURE:
        return prefixes(node.subs[0])
    if op in (Op.BEGIN_TEXT, Op.BEGIN_LINE, Op.END_TEXT, Op.END_LINE,
              Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY):
        # zero-width: contributes epsilon; anchor/assertion truth is
        # checked by the verification DFA, not the candidate scan
        return Seq.empty()
    if op == Op.CONCAT:
        acc = Seq.empty()
        consumed = 0
        for sub in node.subs:
            if not acc.is_finite or not acc.all_exact():
                break  # inexact literals cannot be extended
            acc = acc.cross(prefixes(sub))
            consumed += 1
        if acc.is_finite and consumed < len(node.subs):
            # stopped early: literals are prefixes, not whole matches
            acc = acc.inexact()
        return acc
    if op == Op.ALTERNATE:
        acc = Seq([])
        for sub in node.subs:
            acc = acc.union(prefixes(sub))
            if not acc.is_finite:
                return acc
        return acc
    if op == Op.QUEST or op == Op.STAR:
        # may match empty, then anything follows
        inner = prefixes(node.subs[0]).inexact()
        return Seq.empty().inexact().union(inner) if inner.is_finite \
            else Seq.singleton(b"", exact=False)
    if op == Op.PLUS:
        return prefixes(node.subs[0]).inexact()
    if op == Op.REPEAT:
        if node.min == 0:
            inner = prefixes(node.subs[0]).inexact()
            return Seq.empty().inexact().union(inner) if inner.is_finite \
                else Seq.singleton(b"", exact=False)
        return prefixes(node.subs[0]).inexact()
    return Seq.infinite()


def viable_prefix_set(root: Node, max_lits: int = 32, min_len: int = 2
                      ) -> Optional[List[bytes]]:
    """The PREFIX_SET gate: a complete, finite, all-nonempty prefix set
    small enough to scan and long enough to be selective.  Returns the
    literal bytes in priority order, or None."""
    s = prefixes(root)
    if not s.is_finite:
        return None
    s = s.minimize(target=max_lits, floor=min_len)
    if not s.is_finite or not s.lits:
        return None
    if len(s.lits) > max_lits:
        return None
    if any(len(l.b) < min_len for l in s.lits):
        return None
    # all-exact sets covering the whole pattern belong to LITERAL /
    # MULTI_LITERAL (selected earlier); reaching here with all-exact just
    # means anchors/zero-width ops intervened — still fine as candidates.
    out: List[bytes] = []
    seen = set()
    for l in s.lits:
        if l.b not in seen:
            seen.add(l.b)
            out.append(l.b)
    return out
