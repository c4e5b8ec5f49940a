# Copy of coregex_tpu/utils/utf8.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Go utf8.DecodeRune width, used for Go's empty-match advance rule.

Go's FindAll loop advances an empty match by the width of the rune at the
current position (regexp.go allMatches); utf8.DecodeRune returns width 1
for ANY invalid sequence — bad lead byte, truncated sequence, wrong
continuation byte, overlong encoding lead (0xC0/0xC1), or > U+10FFFF lead
(0xF5+).  The naive lead-byte table gets all of those wrong.
"""

from __future__ import annotations

# second-byte accept range per lead byte (lo, hi); width implied by lead
_ACCEPT = {}
for _b in range(0xC2, 0xE0):
    _ACCEPT[_b] = (0x80, 0xBF, 2)
_ACCEPT[0xE0] = (0xA0, 0xBF, 3)
for _b in range(0xE1, 0xED):
    _ACCEPT[_b] = (0x80, 0xBF, 3)
_ACCEPT[0xED] = (0x80, 0x9F, 3)  # no surrogates
for _b in range(0xEE, 0xF0):
    _ACCEPT[_b] = (0x80, 0xBF, 3)
_ACCEPT[0xF0] = (0x90, 0xBF, 4)
for _b in range(0xF1, 0xF4):
    _ACCEPT[_b] = (0x80, 0xBF, 4)
_ACCEPT[0xF4] = (0x80, 0x8F, 4)  # <= U+10FFFF


def go_rune_width(data, pos: int) -> int:
    """Width utf8.DecodeRune would report at data[pos]; 1 past the end
    (Go advances one position to terminate the loop)."""
    n = len(data)
    if pos >= n:
        return 1
    b = int(data[pos])
    if b < 0x80:
        return 1
    acc = _ACCEPT.get(b)
    if acc is None:
        return 1
    lo, hi, w = acc
    if pos + w > n:
        return 1
    if not (lo <= int(data[pos + 1]) <= hi):
        return 1
    for k in range(2, w):
        if not (0x80 <= int(data[pos + k]) <= 0xBF):
            return 1
    return w
