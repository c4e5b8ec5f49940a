"""Invalid UTF-8 read as Go reads it (ROADMAP P4), on the CPU.

Go's matchers decode the text with utf8.DecodeRune: every byte that does
not start a valid sequence is one U+FFFD character of width 1, and the
search goes on after it.  The oracle here is a decoder written with that
rule: each such byte becomes U+FFFD in a str, Python's ``re`` (ASCII
classes, as Go's) runs on the str, and its character offsets map back to
byte offsets.  It is never the reference's answer: the JAX package stops at
a valid lead byte that lacks its continuation bytes (ROADMAP F14).

Every case runs on the port's device routes (``batch_threshold`` 0, the
plain torch forms on the CPU) and in its host loop, and outputs (matched
bytes, groups, replace_all's and split's text) must be the caller's bytes.
"""

import io
import re

import numpy as np
import pytest

import coregex_tpu_torch as ct
from coregex_tpu_torch.utils import corpus_cache
from coregex_tpu_torch.utils.utf8 import (StreamNormalizer, go_normalize,
                                          go_rune_width)


def go_decode(b: bytes):
    """(str as Go decodes b, byte offset of each character and of the
    end)."""
    chars, offs, p = [], [], 0
    while p < len(b):
        w = go_rune_width(b, p)
        chars.append("�" if w == 1 and b[p] >= 0x80
                     else b[p:p + w].decode())
        offs.append(p)
        p += w
    offs.append(len(b))
    return "".join(chars), offs


def go_matches(pattern: str, b: bytes):
    """re's matches of `pattern` on Go's decoding of b (pattern not
    nullable, so re's FindAll is Go's), as (span, group spans) in bytes."""
    s, offs = go_decode(b)
    out = []
    for m in re.finditer(pattern, s, re.ASCII):
        groups = [None if m.start(g) < 0 else
                  (offs[m.start(g)], offs[m.end(g)])
                  for g in range(1, (m.lastindex or 0) + 1)]
        out.append(((offs[m.start()], offs[m.end()]), groups))
    return out


def go_spans(pattern: str, b: bytes):
    return [sp for sp, _g in go_matches(pattern, b)]


def _engines(pattern: str, posix: bool = False):
    """The same pattern served by the device routes and by the host
    loop."""
    out = []
    for thr in (0, 1 << 30):
        eng = (ct.compile_posix if posix else ct.compile)(pattern,
                                                          device="cpu")
        eng.batch_threshold = thr
        out.append(eng)
    return out


MIXED = b"ab\xc3z cd\xffe \xe2\x82 gh " * 2000
LATIN1 = b"caf\xe9 au lait \xe9t\xe9 " * 1200
EMOJI = ("café naïve \U0001F600 x ".encode() * 300
         + b"caf\xe9 au lait \xf0\x9f\x98 " * 300)

# the six counts of ROADMAP P4 (Go's answer in the last column), then \S+
# over Latin-1 and 4-byte emoji text
CASES = [
    (r".\d", b"ab1 c\xc3d2 ef3 " * 1500, False, 4500),
    (r"[^ ]+", MIXED, False, 8000),
    (r"\W", MIXED, False, 16000),
    (r"[^a]", LATIN1, False, 16800),
    (r".", b"ab\xc3z" * 6000, True, 24000),
    (r"\S+", LATIN1, False, 4800),
    (r"\S+", EMOJI, False, 2400),
    (r"[^ ]+", EMOJI, True, 2400),
]
CASE_IDS = ["dot-digit", "nonspace", "nonword", "not-a", "posix-dot",
            "S-latin1", "S-emoji", "posix-nonspace-emoji"]


@pytest.mark.parametrize("pattern,text,posix,go", CASES, ids=CASE_IDS)
def test_counts_and_spans_are_gos(pattern, text, posix, go):
    corpus_cache.clear()
    exp = go_spans(pattern, text)
    assert len(exp) == go
    for eng in _engines(pattern, posix):
        assert eng.count(text) == go
        assert eng.find_all_index(text) == exp
        assert eng.find_all_index(text, 7) == exp[:7]
        got = eng.find_all(text)
        assert got == [text[s:e] for s, e in exp]
        if eng.batch_threshold == 0:
            assert eng.batch_engine().host_routes == 0


def test_single_match_after_an_invalid_byte():
    """find, find_index and is_match reach a match that only follows
    invalid bytes; find returns the caller's bytes."""
    text = b"ab c\xc3 " * 3000 + b"\xc39"
    n = len(text)
    assert go_spans(r".\d", text) == [(n - 2, n)]
    for eng in _engines(r".\d"):
        assert eng.find_index(text) == (n - 2, n)
        assert eng.find(text) == b"\xc39"
        assert eng.is_match(text)
        assert not eng.is_match(text[:-1])


def test_captures_replace_all_and_split_keep_the_callers_bytes():
    pattern = r"(.)(\d)"
    text = b"ab1 c\xc3d2 e\xe2\x823 " * 600
    ms = go_matches(pattern, text)
    exp_repl, last = bytearray(), 0
    for (s, e), g in ms:
        exp_repl += text[last:s] + b"<" + text[g[1][0]:g[1][1]] \
            + text[g[0][0]:g[0][1]] + b">"
        last = e
    exp_repl += text[last:]
    exp_split, beg = [], 0
    for (s, e), _g in ms:
        exp_split.append(text[beg:s])
        beg = e
    exp_split.append(text[beg:])
    for eng in _engines(pattern):
        subs = eng.find_all_submatch_index(text)
        assert [(tuple(gr[0]), [tuple(x) for x in gr[1:]]) for gr in subs] \
            == [(sp, g) for sp, g in ms]
        assert eng.find_all_submatch(text)[1] == [
            text[a:b] for a, b in (ms[1][0], *ms[1][1])]
        assert eng.replace_all(text, b"<$2$1>") == bytes(exp_repl)
        assert eng.replace_all_literal(text, b"#") == bytes(
            _splice(text, ms, b"#"))
        assert eng.replace_all_func(text, lambda m: m[::-1]) == bytes(
            _splice(text, ms, None))
        assert eng.split(text) == exp_split


def _splice(text, ms, repl):
    out, last = bytearray(), 0
    for (s, e), _g in ms:
        out += text[last:s] + (text[s:e][::-1] if repl is None else repl)
        last = e
    return out + text[last:]


def test_row_batches_normalize_each_row_alone():
    """A row that ends in a lead byte decodes it as U+FFFD, and the next
    row's continuation bytes do not complete it."""
    rows = [b"abc\xc3", b"\xa9x", b"caf\xc3\xa9", b"x\xe2\x82", b"\xacyz",
            b"plain"] * 12
    pattern = r"[^a-z]"
    exp = [next(iter(go_spans(pattern, r)), None) for r in rows]
    assert exp[:6] == [(3, 4), (0, 1), (3, 5), (1, 2), (0, 1), None]
    eng = ct.compile(pattern, device="cpu")
    assert eng.is_match_batch(rows) == [e is not None for e in exp]
    assert eng.find_index_batch(rows) == exp


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 7])
def test_reader_reads_leads_across_chunk_seams(chunk):
    """is_match_reader (the streamed DFA) and find_reader_index (the
    streamed PikeVM) see a sequence cut by a chunk seam whole."""
    valid = b"xxxx\xc3\xa9yy\xf0\x9f\x98\x80zz"
    bad = b"xxxx\xc3yy\xf0\x9f\x98zz"
    for pattern in (r"\x{FFFD}", r"[^a-z]{2}"):
        eng = ct.compile(pattern, device="cpu")
        for text in (valid, bad):
            exp = next(iter(go_spans("�" if "FFFD" in pattern
                                     else pattern, text)), None)
            assert eng.is_match_reader(io.BytesIO(text), chunk) == (
                exp is not None), (pattern, text)
            assert eng.find_reader_index(io.BytesIO(text), chunk) == exp
    sn = StreamNormalizer()
    parts = [sn.feed(bad[i:i + chunk]) for i in range(0, len(bad), chunk)]
    assert b"".join(p.tobytes() for p in parts + [sn.finish()]) == \
        go_normalize(np.frombuffer(bad, np.uint8)).tobytes()


def test_literal_fffd_matches_invalid_bytes():
    """A literal U+FFFD outside a class matches each invalid byte, as the
    class [\\x{FFFD}] does (Go compares decoded runes)."""
    text = b"a\xffb\xef\xbf\xbdc"
    for pattern in (r"\x{FFFD}", r"[\x{FFFD}]", "�"):
        for eng in _engines(pattern):
            assert eng.find_all_index(text) == [(1, 2), (3, 6)]
            assert eng.find_all_index(text * 3000)[:4] == [
                (1, 2), (3, 6), (8, 9), (10, 13)]
    for eng in _engines(r"a\x{FFFD}b"):
        assert eng.find_all_index(b"a\xffb a\xc3b a\xef\xbf\xbdb") == [
            (0, 3), (4, 7), (8, 13)]


def test_line_shape_takes_the_general_route_on_invalid_utf8():
    """The LINE_SHAPE plans that take the general fallback serve every
    corpus on the device: no UTF-8 gate declines them."""
    corpus_cache.clear()
    text = b"GET /a.php x\nfoo bar 1.2 a\xc3\n" * 300 + b"ab\xc3"
    eng = ct.compile(r"x\n.*", device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    assert be.plan.strategy.name == "LINE_SHAPE"
    assert be._spans_route(np.frombuffer(text, np.uint8))[0] == "full_scan"
    assert eng.find_all_index(text) == go_spans(r"x\n.*", text)
    assert be.host_routes == 0


def test_the_cache_hands_out_normalized_buffers_only():
    """Every device buffer holds the bytes the matchers read, whether the
    caller passes the raw corpus or its normalized copy (which names the
    same entry), and a direct BatchEngine call sees them too."""
    corpus_cache.clear()
    raw = np.frombuffer(MIXED, np.uint8)
    norm = go_normalize(raw)
    assert norm is not raw and (norm == 0xFF).sum() == 8000
    assert corpus_cache.go_bytes(raw, "cpu") is corpus_cache.go_bytes(
        norm, "cpu")
    assert bytes(corpus_cache.device_corpus(raw, "cpu").numpy()) == \
        norm.tobytes()
    assert corpus_cache.device_corpus(norm, "cpu") is \
        corpus_cache.device_corpus(raw, "cpu")
    eng = ct.compile(r"[^ ]+", device="cpu")
    spans, cnt = eng.batch_engine().find_all_spans_device(raw)
    assert [tuple(r) for r in spans[:cnt].tolist()] == go_spans(r"[^ ]+",
                                                                 MIXED)
    valid = np.frombuffer("café ".encode() * 5000, np.uint8)
    assert corpus_cache.go_bytes(valid, "cpu") is valid


def test_valid_utf8_pays_only_the_decoder_and_copies_take_no_slot(
        monkeypatch):
    """Valid multi-byte text is decided by the decoder alone (the byte
    rule never runs) and is its own normalized copy; the byte rule reads
    an invalid text from its first invalid byte on; the normalized copy of
    one corpus is an alias of its entry and takes no slot of the LRU."""
    from coregex_tpu_torch.utils import utf8
    valid = np.frombuffer("naïve café 日本 🙂 ".encode() * 3000, np.uint8)
    seen = []
    real = utf8._invalid_in

    def spy(a, lo, hi):
        seen.append(lo)
        return real(a, lo, hi)

    monkeypatch.setattr(utf8, "_invalid_in", spy)
    assert go_normalize(valid) is valid and not seen
    bad = valid.copy()
    bad[len(bad) // 2] = 0xC3   # a lead byte before an ASCII one
    bad[len(bad) // 2 + 1] = 0x20
    out = go_normalize(bad)
    assert seen and min(seen) == utf8.first_invalid(bad) > 0
    assert np.flatnonzero(out != bad).tolist() == [len(bad) // 2]
    corpus_cache.clear()
    corpora = [np.frombuffer(MIXED + bytes([65 + i]), np.uint8)
               for i in range(4)]
    for raw in corpora:
        corpus_cache.device_corpus(raw, "cpu")
    assert len(corpus_cache._cache) == 4
    for raw in corpora:   # every entry still cached: the same buffer
        norm = corpus_cache.go_bytes(raw, "cpu")
        assert corpus_cache.device_corpus(norm, "cpu") is \
            corpus_cache.device_corpus(raw, "cpu")
    assert len(corpus_cache._cache) == 4
