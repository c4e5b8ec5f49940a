# Copy of coregex_tpu/syntax/unicode_tables.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Unicode class tables for \\p{...}.

General categories (L, Lu, Nd, ...) are derived lazily from
`unicodedata.category` over the full codepoint space and cached in-process.
Script properties use the vendored generated tables in _script_tables.py
(complete Unicode script coverage — every script Go's unicode.Scripts
knows; the reference inherits those via regexp/syntax,
its nfa/compile.go:600-975).  Regenerate the vendored data
with tools/gen_unicode_scripts.py.  Unknown names return None (parse
error), matching Go.
"""

from __future__ import annotations

import sys
import unicodedata
from typing import Dict, List, Optional, Tuple

from ._script_tables import SCRIPT_ALIASES, SCRIPT_RANGES

Ranges = Tuple[Tuple[int, int], ...]

_CATEGORY_RANGES: Dict[str, Ranges] = {}
_BUILT = False


def _build_categories() -> None:
    global _BUILT
    if _BUILT:
        return
    open_ranges: Dict[str, List[List[int]]] = {}
    prev_cat: Optional[str] = None
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))
        if cat == "Cn":
            cat = None  # unassigned
        if cat != prev_cat:
            if cat is not None:
                open_ranges.setdefault(cat, []).append([cp, cp])
            prev_cat = cat
        elif cat is not None:
            open_ranges[cat][-1][1] = cp
    for cat, rs in open_ranges.items():
        _CATEGORY_RANGES[cat] = tuple((a, b) for a, b in rs)
    # one-letter supercategories
    supers: Dict[str, List[Tuple[int, int]]] = {}
    for cat, rs in list(_CATEGORY_RANGES.items()):
        supers.setdefault(cat[0], []).extend(rs)
    from .ast import normalize_ranges
    for s, rs in supers.items():
        _CATEGORY_RANGES[s] = normalize_ranges(rs)
    _BUILT = True


_SPECIAL: Dict[str, Ranges] = {
    "Any": ((0, 0x10FFFF),),
}


def _script_ranges(name: str) -> Optional[Ranges]:
    """Vendored script lookup.  Accepts Go's canonical spellings
    (`Old_Italic`, `Yi`, ...) case/separator-insensitively, like the
    Unicode loose-matching rule; the leading-uppercase requirement in
    lookup() keeps Go's `\\p{latin}`-is-an-error behavior.

    DOCUMENTED DEVIATION (accept-superset only): Unicode loose matching
    admits spellings Go's exact `unicode.Scripts` map rejects
    (`\\p{LATIN}`, `\\p{Olditalic}`, 4-letter ISO codes).  Every pattern
    Go accepts parses identically; no Go-valid pattern is rejected or
    reinterpreted.  The generated tables carry only normalized alias
    keys, so exact-spelling enforcement would need the UCD
    PropertyValueAliases file vendored besides."""
    norm = "".join(ch for ch in name.upper() if ch.isalnum())
    idx = SCRIPT_ALIASES.get(norm)
    if idx is None:
        return None
    rs = SCRIPT_RANGES[idx]
    return rs if rs else None


def lookup(name: str) -> Optional[Ranges]:
    if name in _SPECIAL:
        return _SPECIAL[name]
    if not name[:1].isupper():
        return None
    if len(name) <= 2:
        _build_categories()
        cat = _CATEGORY_RANGES.get(name)
        if cat is not None:
            return cat
        # short script names (Yi, Lao, ...) fall through to scripts
    return _script_ranges(name)
