# Copy of coregex_tpu/syntax/fold.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Unicode simple case folding orbits.

Go's `(?i)` uses Unicode simple folding (regexp/syntax parse.go, unicode
package).  We reconstruct the fold orbits by grouping codepoints whose
single-codepoint casefold agrees, plus lower/upper closure; this matches the
simple-fold orbits for all practical characters (full-fold-only expansions
like ß→ss are not simple folds and are correctly excluded).

The orbit table over the full Unicode range costs ~0.5 s to build, so it is
built lazily and only when a pattern actually needs non-ASCII folding.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

_ORBITS: Dict[int, Tuple[int, ...]] = {}
_BUILT = False

_ASCII_ORBIT = {}
for _c in range(ord("a"), ord("z") + 1):
    _ASCII_ORBIT[_c] = (_c - 32, _c)
    _ASCII_ORBIT[_c - 32] = (_c - 32, _c)
# k and s have extra Unicode orbit members (K U+212A, ſ U+017F)
_ASCII_EXTRA = {
    ord("k"): (ord("K"), ord("k"), 0x212A),
    ord("K"): (ord("K"), ord("k"), 0x212A),
    ord("s"): (ord("S"), ord("s"), 0x17F),
    ord("S"): (ord("S"), ord("s"), 0x17F),
}


def _build() -> None:
    global _BUILT
    if _BUILT:
        return
    groups: Dict[str, List[int]] = {}
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        f = ch.casefold()
        if len(f) == 1:
            groups.setdefault(f, []).append(cp)
        else:
            groups.setdefault(ch, []).append(cp)
    for members in groups.values():
        if len(members) > 1:
            orbit = tuple(sorted(members))
            for cp in orbit:
                _ORBITS[cp] = orbit
    _BUILT = True


def fold_orbit(cp: int) -> Tuple[int, ...]:
    """All codepoints that case-fold to the same thing as cp (including cp)."""
    if cp < 0x80:
        if cp in _ASCII_EXTRA:
            return _ASCII_EXTRA[cp]
        if cp in _ASCII_ORBIT:
            return _ASCII_ORBIT[cp]
        return (cp,)
    _build()
    return _ORBITS.get(cp, (cp,))


def fold_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    """Close codepoint ranges under simple case folding.

    For ASCII-only ranges this is cheap; wide ranges trigger the orbit table.
    """
    from .ast import normalize_ranges

    out = list(ranges)
    for lo, hi in ranges:
        if hi - lo > 0x2000:
            # Wide ranges: fold via the grouped orbit table, iterating orbits
            # instead of every codepoint.
            _build()
            for cp, orbit in _ORBITS.items():
                if lo <= cp <= hi:
                    for o in orbit:
                        out.append((o, o))
        else:
            for cp in range(lo, hi + 1):
                for o in fold_orbit(cp):
                    if o != cp:
                        out.append((o, o))
    return normalize_ranges(out)
