# Copy of coregex_tpu/nfa/utf8.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Codepoint ranges -> UTF-8 byte-range sequences.

The standard utf8-ranges decomposition (capability analogue of the
reference's rune-to-byte-range compilation, nfa/compile.go:600-975): a
codepoint range becomes a small set of sequences of inclusive byte ranges,
such that the union of their cross-products is exactly the UTF-8 encodings
of the range.  Surrogates are excluded.

`reverse=True` emits each sequence in reversed byte order (trailing byte
first) for reverse-NFA compilation.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

ByteSeq = Tuple[Tuple[int, int], ...]  # sequence of inclusive byte ranges


def _encode(cp: int) -> bytes:
    return chr(cp).encode("utf-8")


# encoding length boundaries, with the surrogate gap
_BOUNDARIES = [(0x00, 0x7F), (0x80, 0x7FF), (0x800, 0xD7FF),
               (0xE000, 0xFFFF), (0x10000, 0x10FFFF)]


def utf8_sequences(lo: int, hi: int) -> Iterator[ByteSeq]:
    """Yield byte-range sequences covering codepoints [lo, hi]."""
    for blo, bhi in _BOUNDARIES:
        s, e = max(lo, blo), min(hi, bhi)
        if s <= e:
            yield from _same_len(_encode(s), _encode(e))


def _same_len(lo: bytes, hi: bytes) -> Iterator[ByteSeq]:
    n = len(lo)
    assert len(hi) == n
    if n == 1:
        yield ((lo[0], hi[0]),)
        return
    if lo[0] == hi[0]:
        for rest in _same_len(lo[1:], hi[1:]):
            yield ((lo[0], lo[0]),) + rest
        return
    # lo[0] < hi[0]
    min_rest = b"\x80" * (n - 1)
    max_rest = b"\xbf" * (n - 1)
    if lo[1:] != min_rest:
        for rest in _same_len(lo[1:], max_rest):
            yield ((lo[0], lo[0]),) + rest
        yield from _same_len(bytes([lo[0] + 1]) + min_rest, hi)
        return
    if hi[1:] != max_rest:
        yield from _same_len(lo, bytes([hi[0] - 1]) + max_rest)
        for rest in _same_len(min_rest, hi[1:]):
            yield ((hi[0], hi[0]),) + rest
        return
    yield ((lo[0], hi[0]),) + tuple((0x80, 0xBF) for _ in range(n - 1))


def class_to_byte_seqs(ranges, reverse: bool = False) -> List[ByteSeq]:
    """All byte sequences for a set of codepoint ranges."""
    out: List[ByteSeq] = []
    for lo, hi in ranges:
        hi = min(hi, 0x10FFFF)
        if lo > hi:
            continue
        for seq in utf8_sequences(lo, hi):
            out.append(tuple(reversed(seq)) if reverse else seq)
    return out
