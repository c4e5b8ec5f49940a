"""coregex_tpu_torch's literal and literal-set find_all (LITERAL and
MULTI_LITERAL plans, and nullable patterns with such a core) against the
JAX package on the CPU: the word producers, the segmented set producer
(forced at KB scale by a small slice, with slice seams inside hits) and the
sparse span assembly as functions on the same inputs, then
find_all_spans_device and find_all_index through the public API against
Go's answer, the reference engine's host loop, on seeded ASCII and UTF-8
corpora of at least 16 KiB.  The reference hands overlapping hits, a
self-overlapping literal and dense sets to its host loop; the port serves
all of them on the device (host_routes == 0).  All outputs are integers:
exact equality."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.ops import bytescan as ref_bs
from coregex_tpu.ops import span_chain as ref_sc
import coregex_tpu_torch as ct
from coregex_tpu_torch.meta import batch
from coregex_tpu_torch.ops import bytescan as bs
from coregex_tpu_torch.ops import span_chain as sc
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import ALT32, _arr, _log_corpus

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _corpus(kind: str) -> bytes:
    t = _log_corpus(41, 18000)
    if kind == "ascii":
        return t
    if kind == "utf8":
        u = bytearray(t)
        for p in range(70, len(u) - 4, 523):
            u[p:p + 4] = "é☃\U0001F600".encode()[:4]
        return bytes(u)
    # hits that overlap: abab..., aaa..., deltalpha..., abcb...
    return {"abab": b"abab" * 4500, "aaaa": b"a" * 17000 + b"b" + b"a" * 7,
            "deltalpha": b"deltalpha " * 1800,
            "abcb": b"xabcbcab " * 2000}[kind]


def go_spans(pattern: str, text: bytes):
    """Go's FindAll: the reference engine's host loop."""
    eng = ref_ct.compile(pattern)
    eng.batch_threshold = 1 << 30
    return eng.find_all_index(text) or []


def _eq(got, exp):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(exp))


def _both(text: bytes):
    d = np.frombuffer(text, np.uint8)
    return torch.from_numpy(d.copy()), jnp.asarray(d)


@pytest.mark.parametrize("lit", [b"error", b"aa", b"0.0", b"abab", b"abcab",
                                 b"a", b"abc", b"aba"])
def test_literal_self_overlaps_matches_reference(lit):
    assert bs.literal_self_overlaps(lit) == ref_bs.literal_self_overlaps(lit)


@pytest.mark.parametrize("lit", [b"error", b"e", b"0.0", b"\xc3\xa9"])
def test_literal_words_match_reference(lit):
    for kind in ("ascii", "utf8"):
        d, jd = _both(_corpus(kind))
        for g, e in zip(sc.literal_words(d, lit),
                        ref_sc.literal_words(jd, tuple(lit))):
            _eq(g, e)


SETS = [[b"GET", b"POST", b"PUT", b"DELETE", b"HEAD", b"OPTIONS", b"PATCH"],
        [b"error", b"warning", b"notice", b"info", b"debug"],
        [w.encode() for w in ALT32.split("|")],
        [b"0.0", b".0."], [b"e", b"er", b"\xc3\xa9"]]


@pytest.mark.parametrize("lits", SETS)
def test_multi_literal_words_match_reference(lits):
    ref_lits = tuple(tuple(x) for x in lits)
    for kind in ("ascii", "utf8"):
        d, jd = _both(_corpus(kind))
        for g, e in zip(sc.multi_literal_words(d, lits),
                        ref_sc.multi_literal_words(jd, ref_lits)):
            _eq(g, e)


@functools.lru_cache(maxsize=None)
def _ref_big(si: int, n: int):
    _d, jd = _both(_corpus("ascii")[:n])
    return [np.asarray(x) for x in ref_sc.multi_literal_words_big(
        jd, tuple(tuple(x) for x in SETS[si]))]


# slices of 200 bytes (192 once cut to whole words) put seams inside hits;
# n = 32 * 512 ends the corpus on a word edge, where the [n+1] end domain
# needs one more word
@pytest.mark.parametrize("si", range(len(SETS)))
@pytest.mark.parametrize("seg,n", [(200, 32 * 512), (1000, 18000),
                                   (4096, 18000)])
def test_segmented_words_match_reference(monkeypatch, si, seg, n):
    """The reference slices at 32 MiB or more, so at KB scale it runs one
    slice; the port's slices of `seg` bytes must give its words."""
    d, _jd = _both(_corpus("ascii")[:n])
    monkeypatch.setattr(sc, "_ML_SEG", seg)
    got = sc.multi_literal_words_big(d, SETS[si])
    for g, e in zip(got, _ref_big(si, n)):
        _eq(g, e)


@pytest.mark.parametrize("lit", [b"error", b"e", b"delta"])
def test_literal_spans_sparse_matches_reference(lit):
    text = _corpus("ascii")
    n = len(text)
    d, jd = _both(text)
    words, cnt = sc.literal_words(d, lit)
    rwords, _ = ref_sc.literal_words(jd, tuple(lit))
    cnt = int(cnt)
    for cap in (16 * (cnt // 16 + 1), max(1, cnt // 2)):
        exp = ref_sc.literal_spans_sparse(rwords, n, cap, len(lit))
        for g, e in zip(sc.literal_spans_sparse(words, n, cap, len(lit)),
                        exp):
            _eq(g, e)
        if cap > cnt:       # K4 over the unpacked mask: the same spans
            for g, e in zip(sc.literal_spans_sparse(words, n, cap, len(lit),
                                                    dense=True), exp):
                _eq(g, e)


# (pattern, corpus, plan, branch): branch names what the corpus makes the
# device path take
FIND_ALL = [
    (r"error", "ascii", "literal", "sparse"),
    (r"error", "utf8", "literal", "sparse"),
    (r" ", "ascii", "literal", "dense"),
    (r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH", "ascii", "multi_literal",
     "sparse"),
    (r"error|warning|notice|info|debug", "utf8", "multi_literal", "sparse"),
    (ALT32, "ascii", "multi_literal", "sparse"),
    (r"e|a|o", "ascii", "multi_literal", "dense"),
    (r"ab|ba", "abab", "multi_literal", "select"),
    (r"delta|alpha", "deltalpha", "multi_literal", "select"),
    (r"abc|b", "abcb", "multi_literal", "select"),
    (r"0\.0|\.0\.", "ascii", "multi_literal", "select"),
    (r"aa", "aaaa", "literal", "select"),
    (r"0\.0", "ascii", "literal", "select"),
    (r"(error)?", "ascii", "nullable_core", "literal core"),
    (r"(error)?", "utf8", "nullable_core", "literal core"),
    (r"(GET|POST)?", "ascii", "nullable_core", "set core"),
]


@pytest.mark.parametrize("pattern,kind,plan,branch", FIND_ALL)
def test_find_all_matches_go(monkeypatch, pattern, kind, plan, branch):
    # the ASCII and UTF-8 corpora have one length: keep the corpus cache's
    # sampled fingerprint (ROADMAP F5) from serving one for the other
    corpus_cache.clear()
    text = _corpus(kind)
    selections = []
    select = batch.leftmost_first_spans
    monkeypatch.setattr(batch, "leftmost_first_spans",
                        lambda *a: selections.append(1) or select(*a))
    exp = go_spans(pattern, text)
    eng = ct.compile(pattern, device="cpu")
    be = eng.batch_engine()
    assert be.plan.strategy.value == plan
    if plan == "nullable_core":
        core = be._core().batch_engine().plan.strategy.value
        assert core == ("literal" if branch == "literal core"
                        else "multi_literal")
    else:
        lits = [bytes(x) for x in be.plan.literals]
        d = torch.from_numpy(_arr(text).copy())
        hits = int(sc.literal_words(d, lits[0])[1] if len(lits) == 1
                   else sc.multi_literal_words(d, lits)[2])
        if branch != "select":
            assert (hits / len(text) >= sc.SPARSE_OK) == (branch == "dense")
    spans, cnt = be.find_all_spans_device(_arr(text))
    assert [tuple(r) for r in spans[:cnt].tolist()] == exp
    assert bool(selections) == (branch == "select")
    assert (eng.find_all_index(text) or []) == exp
    assert be.host_routes == 0


@pytest.mark.parametrize("pattern,kind", [(ALT32, "utf8"),
                                          (r"delta|alpha", "deltalpha")])
def test_segmented_path_through_the_engine(monkeypatch, pattern, kind):
    """Past MULTI_FUSED_LIMIT the set's words come in slices: with slices
    of 96 bytes the whole path still gives Go's answer."""
    text = _corpus(kind)
    monkeypatch.setattr(batch, "MULTI_FUSED_LIMIT", 1000)
    monkeypatch.setattr(sc, "_ML_SEG", 96)
    eng = ct.compile(pattern, device="cpu")
    assert (eng.find_all_index(text) or []) == go_spans(pattern, text)
    assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("pattern,kind", [(r"error", "ascii"),
                                          (r"ab|ba", "abab"),
                                          (r"0\.0", "ascii")])
def test_warm_defer_path(pattern, kind):
    """The second call on a corpus takes its caps and branch from the
    count cache: no sync, count and ok on the device."""
    text = _corpus(kind)
    exp = go_spans(pattern, text)
    be = ct.compile(pattern, device="cpu").batch_engine()
    spans, cnt, ok = be.find_all_spans_device(_arr(text), defer_ok=True)
    assert isinstance(cnt, int) and ok is None and cnt == len(exp)
    spans, cnt, ok = be.find_all_spans_device(_arr(text), defer_ok=True)
    assert isinstance(cnt, torch.Tensor) and bool(ok)
    assert [tuple(r) for r in spans[:int(cnt)].tolist()] == exp


def test_leftmost_longest_sets_decline():
    """Leftmost-longest literal sets decline past the span limit before
    the upload; within it they are served with their literals sorted
    longest first, equal to the reference's host walk, also where hits
    overlap (`deltalpha`, `abab`)."""
    for pattern, kind in ((r"GET|GETS|POST", "ascii"),
                          (r"err|error|errors", "ascii"),
                          (r"delta|deltalpha|alpha", "deltalpha"),
                          (r"ab|aba|b", "abab")):
        text = _corpus(kind)
        corpus_cache.clear()
        eng = ct.compile_posix(pattern, device="cpu")
        ref = ref_ct.compile_posix(pattern)
        ref.batch_threshold = 1 << 30
        exp = ref.find_all_index(text)
        be = eng.batch_engine()
        be.SPARSE_SPANS_LIMIT = len(text) - 1
        assert eng.find_all_index(text) == exp
        assert be.host_routes == 1
        assert corpus_cache._entry(_arr(text), "cpu").buf is None
        del be.SPARSE_SPANS_LIMIT
        assert be._spans_route(_arr(text))[0] == "literal"
        assert eng.find_all_index(text) == exp
        assert eng.count(text) == len(exp or [])
        assert be.host_routes == 1


def test_span_limit_raises():
    """Past MAX_DEVICE_SPANS hits the literal-set route no longer raises:
    its start and end words are compacted in pieces of the limit, equal
    to the reference on the device."""
    eng = ct.compile(r"error|debug", device="cpu")
    be = eng.batch_engine()
    be.MAX_DEVICE_SPANS = 4
    ref = ref_ct.compile(r"error|debug")
    ref.batch_threshold = 1 << 30
    t = _corpus("ascii")
    assert eng.find_all_index(t) == ref.find_all_index(t)
    assert be.host_routes == 0 and be.pieces[0] >= 2
