# Copy of coregex_tpu/utils/utf8.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made
# (go_normalize and StreamNormalizer are new).
"""Go utf8.DecodeRune width, used for Go's empty-match advance rule.

Go's FindAll loop advances an empty match by the width of the rune at the
current position (regexp.go allMatches); utf8.DecodeRune returns width 1
for ANY invalid sequence — bad lead byte, truncated sequence, wrong
continuation byte, overlong encoding lead (0xC0/0xC1), or > U+10FFFF lead
(0xF5+).  The naive lead-byte table gets all of those wrong.
"""

from __future__ import annotations

import codecs

import numpy as np

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


# ---------------------------------------------------------------------------
# Go's decoding of invalid UTF-8 as bytes the matchers read (no counterpart
# in the reference: its matchers stop at a valid lead byte that lacks its
# continuation bytes, ROADMAP P4 and F14)
# ---------------------------------------------------------------------------
# Go's matchers read the text rune by rune through utf8.DecodeRune, which
# decodes every byte that does not start a valid sequence as U+FFFD of width
# 1.  The port's NFA already takes the byte 0xFF as one such character of
# every class that holds U+FFFD (nfa/thompson.py), and no class takes 0xFF
# otherwise, so rewriting each of those bytes to 0xFF gives every table the
# text Go decodes, at the same byte offsets.  Valid sequences never overlap
# (their continuation bytes start none), and the decoder reaches every lead
# of one, so a byte >= 0x80 is invalid exactly when it starts no valid
# sequence and lies inside none: a rule of the three bytes on either side.

INVALID = 0xFF
_WIDTH = np.zeros(256, dtype=np.int8)   # width of a valid lead, else 0
_LO2 = np.zeros(256, dtype=np.uint8)    # its second byte's range
_HI2 = np.zeros(256, dtype=np.uint8)
for _b, (_lo, _hi, _w) in _ACCEPT.items():
    _WIDTH[_b], _LO2[_b], _HI2[_b] = _w, _lo, _hi
_CHUNK = 1 << 24   # bytes a step of go_invalid_positions reads


def _invalid_in(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Positions p in [lo, hi) of `a` that Go decodes as a width-1
    RuneError; a verdict reads up to three bytes of `a` on either side of
    p, and `a`'s ends are the text's."""
    n = len(a)
    wa, wb = max(0, lo - 3), min(n, hi + 3)
    w = np.zeros(wb - wa + 3, dtype=np.uint8)
    w[:wb - wa] = a[wa:wb]
    p = np.flatnonzero(w[:wb - wa] >= 0x80)
    if p.size == 0:
        return p
    b = w[p]
    wid = _WIDTH[b]
    s2 = w[p + 1]
    c3 = (w[p + 2] & 0xC0) == 0x80
    c4 = (w[p + 3] & 0xC0) == 0x80
    start = ((wid >= 2) & (s2 >= _LO2[b]) & (s2 <= _HI2[b])
             & ((wid < 3) | c3) & ((wid < 4) | c4))
    span = np.zeros(len(w), dtype=np.int8)
    span[p] = np.where(start, wid, 0)
    bad = ~start
    for k in (1, 2, 3):
        q = p - k
        ok = q >= 0
        bad[ok] &= span[q[ok]] <= k     # no sequence from q reaches p
    out = p[bad] + wa
    return out[(out >= lo) & (out < hi)]


def first_invalid(a: np.ndarray) -> int:
    """Offset of the first byte of `a` that lies in no valid UTF-8
    sequence, or len(a) when `a` is valid UTF-8: Python's strict decoder,
    _CHUNK bytes at a time, which takes Go's rule of validity (no
    surrogate, no overlong form, nothing past U+10FFFF) and is several
    times faster on valid text than the byte rule of _invalid_in."""
    flat = np.ascontiguousarray(a, np.uint8)
    n, pos = len(flat), 0
    while pos < n:
        end = min(n, pos + _CHUNK)
        try:
            _s, used = codecs.utf_8_decode(memoryview(flat[pos:end]),
                                           "strict", end == n)
        except UnicodeDecodeError as e:
            return pos + e.start
        pos += used     # a sequence cut at the chunk's end starts the next
    return n


def go_invalid_positions(a: np.ndarray, start: int = 0) -> np.ndarray:
    """Ascending positions at or past `start` of the bytes of `a` that Go's
    utf8.DecodeRune reads as a width-1 RuneError, _CHUNK bytes at a
    time."""
    parts = [_invalid_in(a, i, min(len(a), i + _CHUNK))
             for i in range(start, len(a), _CHUNK)]
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def go_normalize(a: np.ndarray) -> np.ndarray:
    """`a` with every byte that Go decodes as a width-1 RuneError set to
    0xFF: `a` itself when there is none (every ASCII or valid UTF-8 text,
    which pays one decoder pass), else a copy, the byte rule read from the
    first invalid byte on.  Widths do not change, so positions are
    `a`'s."""
    if a.size == 0 or int(a.max()) < 0x80:
        return a
    p = first_invalid(a)
    if p == len(a):
        return a
    bad = go_invalid_positions(a, p)
    out = np.array(a, dtype=np.uint8, copy=True)
    out[bad] = INVALID
    return out


class StreamNormalizer:
    """go_normalize over a stream read in chunks: a byte's verdict reads
    up to three bytes on either side, so each call returns the bytes whose
    verdict is known (all but the last three, which wait for the next
    chunk) and ``finish`` the rest."""

    def __init__(self):
        self._tail = np.empty(0, dtype=np.uint8)   # bytes not yet returned
        self._ctx = np.empty(0, dtype=np.uint8)    # up to 3 bytes before

    def _emit(self, upto: int) -> np.ndarray:
        a = np.concatenate([self._ctx, self._tail])
        c = len(self._ctx)
        out = np.array(self._tail[:upto], dtype=np.uint8, copy=True)
        if upto and int(out.max()) >= 0x80:
            bad = _invalid_in(a, c, c + upto)
            out[bad - c] = INVALID
        keep = a[:c + upto]
        self._ctx = keep[max(0, len(keep) - 3):]
        self._tail = self._tail[upto:]
        return out

    def feed(self, buf) -> np.ndarray:
        self._tail = np.concatenate(
            [self._tail, np.frombuffer(bytes(buf), dtype=np.uint8)])
        return self._emit(max(0, len(self._tail) - 3))

    def finish(self) -> np.ndarray:
        return self._emit(len(self._tail))
