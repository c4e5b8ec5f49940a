"""coregex_tpu_torch's general find_all and the routes that hang on it,
against the JAX package on the CPU: patterns with a look (the general
fallback: every match start from the unanchored reverse DFA on the flipped
corpus, each start's end from the forward window scan, Go's chain on the
device), {m,k} class runs (the class split), ALL_EMPTY, nullable patterns
whose core takes one of those routes, and find_all limits.

Every case is bit-equal to the reference's find_all_index on seeded
corpora of at least 16 KiB (so the port takes its batch path) and never
reaches the host loop (host_routes 0); the reference's spans are computed
once per pattern and corpus, with its exact host walk (an engine with
batch_threshold = 1 << 30), and cross-checked against its device path for
the look patterns.  The corpora hold the edge cases: a match at offset 0
(its start is the EOI flag of the flipped scan), a match ending at n, a
word run of 300 bytes before `@` (two escalations of the window scan),
overlapping candidate starts (`aaa@bbb.com`), multi-byte runes beside
`\\b`, and a corpus with no match.  The chain selection and the class
split are also compared as plain functions with the reference's
``go_select`` and its host split, on random inputs.  What still declines
(a BITSET_NFA plan out of the bitset scan's scope, leftmost-longest, a
reverse DFA that overflows, a leftmost-longest nullable plan) declines
before the upload and gets the reference's spans from the host loop; a
leftmost-longest look pattern takes the general route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.meta import batch as ref_batch
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import span_chain as sc
from coregex_tpu_torch.ops.bytescan import table_to_ranges
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus

torch.set_num_threads(1)

# (pattern, find_all route on the log corpus)
LOOKS = [(r"\b\d+\b", "full_scan"), (r"\berror\b", "full_scan"),
         (r"\w+@\w+\.com\b", "full_scan"), (r"a\b", "full_scan")]
ROUTES = LOOKS + [
    (r"\s\d+\s", "bidi"), (r"(\w+\s+){3}\d", "bidi"),
    (r"\d{3}", "charclass"), (r"[a-z]{2,5}", "charclass"),
    (r"x*?", "all_empty"), (r"(|a)", "all_empty"),
    (r"(\bfoo)?", "nullable"), (r"a{0,3}", "nullable")]
PATTERNS = [p for p, _ in ROUTES]
LIMITS = [0, 1, 3, "above"]


def _corpora():
    """The log corpus with the edge cases, an ASCII log corpus, a UTF-8 one
    with multi-byte runes beside word characters and digits, and one with
    no match for the non-nullable patterns (none of them matches
    punctuation and spaces)."""
    head = b"123 foo error aaa@bbb.com data a\n"
    tail = (b" x" + b"w" * 300 + b"@example.com foo.com\n"
            b"error\xc3\xa9 \xc3\xa9foo 12\xe2\x82\xac 456")
    log = head + _log_corpus(41, 20000) + tail
    rng = np.random.default_rng(42)
    runes = [b"\xc3\xa9", b"\xe2\x82\xac", b"\xf0\x9f\x98\x80", b"\xd0\xb6"]
    words = [b"foo", b"error", b"12", b"a", b"xx", b"bar@baz.com", b"aaa"]
    parts, total = [], 0
    while total < 17000:
        w = words[int(rng.integers(len(words)))]
        r = runes[int(rng.integers(len(runes)))]
        p = [w + r, r + w, w, r + b" " + w][int(rng.integers(4))]
        parts.append(p + b" \n"[int(rng.integers(2)):][:1])
        total += len(parts[-1])
    utf8 = b"".join(parts)
    none = bytes(rng.choice(np.frombuffer(b" ,;.-!?\n", np.uint8),
                            17000).tolist())
    ascii_ = _log_corpus(43, 17000) + b" foo x86 xxa a0 x foo"
    return {"log": log, "ascii": ascii_, "utf8": utf8, "none": none}


CORPORA = _corpora()


@pytest.fixture(scope="module")
def ref():
    """The reference's find_all_index of a (pattern, corpus) pair through
    its exact host walk, computed once."""
    memo = {}

    def spans(pattern, name, longest=False):
        key = (pattern, name, longest)
        if key not in memo:
            eng = ref_ct.compile(pattern, longest=longest)
            eng.batch_threshold = 1 << 30
            memo[key] = eng.find_all_index(CORPORA[name]) or []
        return memo[key]
    return spans


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("pattern,route", ROUTES)
def test_find_all_matches_reference(ref, pattern, route, name):
    t = CORPORA[name]
    eng = ct.compile(pattern, device="cpu")
    be = eng.batch_engine()
    got = be._spans_route(_arr(t))
    assert got is not None and got[0] == route
    assert (eng.find_all_index(t) or []) == ref(pattern, name)
    assert be.host_routes == 0


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_limits_take_the_device_route(ref, pattern, limit):
    t = CORPORA["log"]
    exp = ref(pattern, "log")
    k = len(exp) + 5 if limit == "above" else limit
    eng = ct.compile(pattern, device="cpu")
    assert eng.find_all_index(t, k) == (exp[:k] or None)
    assert eng.batch_engine().host_routes == 0


def test_limit_zero_uploads_nothing():
    corpus_cache.clear()
    t = CORPORA["log"]
    eng = ct.compile(r"\b\d+\b", device="cpu")
    assert eng.find_all_index(t, 0) is None
    assert eng.batch_engine().host_routes == 0
    assert corpus_cache._entry(_arr(t), "cpu").buf is None


@pytest.mark.parametrize("pattern", [p for p, _ in LOOKS])
def test_look_patterns_match_reference_device_path(ref, pattern):
    """The reference's own device route (its _full_scan_spans and INNER
    pipelines) gives the spans its host walk gives."""
    assert ref_ct.compile(pattern).find_all_index(CORPORA["log"]) == \
        ref(pattern, "log")


def test_edge_cases_of_the_general_route(ref):
    t = CORPORA["log"]
    n = len(t)
    be = ct.compile(r"\b\d+\b", device="cpu").batch_engine()
    rev, _fwd = be._full_scan_route()
    starts, m, ok = be._all_starts(rev, _arr(t))
    assert bool(ok) and int(starts[0]) == 0       # the flipped EOI start
    assert starts[:m].tolist() == sorted(set(starts[:m].tolist()))
    spans = be.find_all_spans(_arr(t))
    assert tuple(spans[0]) == (0, 3) and spans[-1][1] == n
    assert be.full_scan_stats == (m, 1)
    email = ct.compile(r"\w+@\w+\.com\b", device="cpu").batch_engine()
    spans = [tuple(x) for x in email.find_all_spans(_arr(t))]
    assert spans == ref(r"\w+@\w+\.com\b", "log")
    assert (14, 25) in spans                       # aaa@bbb.com
    starts, rounds = email.full_scan_stats
    assert starts > len(spans) and rounds == 3     # W = 64, 256, 1024
    assert any(e - s > 300 for s, e in spans)


def test_span_limit_raises_on_the_general_route(ref):
    """Past MAX_DEVICE_SPANS match starts the general route no longer
    raises (nor does ALL_EMPTY past as many boundaries): the starts, their
    ends and Go's selection go in pieces of the limit, equal to the
    reference."""
    be = ct.compile(r"\b\d+\b", device="cpu").batch_engine()
    be.MAX_DEVICE_SPANS = 8
    got = be.find_all_spans(_arr(CORPORA["log"]))
    assert [tuple(x) for x in got.tolist()] == ref(r"\b\d+\b", "log")
    assert be.pieces[0] >= 2
    empty = ct.compile(r"x*?", device="cpu").batch_engine()
    empty.MAX_DEVICE_SPANS = 8
    got = empty.find_all_spans(_arr(CORPORA["log"]))
    assert [tuple(x) for x in got.tolist()] == ref(r"x*?", "log")
    assert empty.pieces[0] >= 2
    assert be.host_routes == empty.host_routes == 0


@pytest.mark.parametrize("pattern,longest", [
    (r"\d[^\n]{16}ERROR", False), (r"\w*", True), (r"\b\d+\b", True),
    (r"\b[ab]{15}a", False)])
def test_what_still_declines_does_so_before_upload(ref, pattern, longest):
    """A BITSET_NFA plan whose reverse NFA is out of the bitset scan's
    scope (515 range states), a leftmost-longest nullable plan (its plan
    is HOST) and a pattern whose unanchored reverse DFA overflows
    (`\\b[ab]{15}a`, FULL_SCAN) decline before the upload; the host loop
    gives the reference's spans.  A leftmost-longest look pattern
    (`\\b\\d+\\b`) is served on the general route, equal to the
    reference, and declines before the upload only past the span
    limit."""
    corpus_cache.clear()
    t = CORPORA["log"]
    eng = (ct.compile_posix if longest else ct.compile)(pattern,
                                                        device="cpu")
    be = eng.batch_engine()
    served = be._spans_route(_arr(t)) is not None
    assert served == (pattern == r"\b\d+\b")
    if served:
        be.SPARSE_SPANS_LIMIT = len(t) - 1
    assert (eng.find_all_index(t) or []) == ref(pattern, "log", longest)
    if be.plan.strategy.name != "HOST":
        assert be.host_routes == 1
    assert corpus_cache._entry(_arr(t), "cpu").buf is None
    if served:
        del be.SPARSE_SPANS_LIMIT
        assert be._spans_route(_arr(t))[0] == "full_scan"
        assert (eng.find_all_index(t) or []) == ref(pattern, "log", longest)
        assert be.host_routes == 1


@pytest.mark.parametrize("seed", range(6))
def test_chain_select_matches_go_select(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 5000))
    m = int(rng.integers(1, min(n, 400)))
    starts = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
    ln = rng.integers(1, [2, 8, 60][seed % 3] + 1, m)
    ends = np.minimum(starts + ln, n)
    exp = ref_batch.go_select(starts, ends, n, np.zeros(n, np.uint8))
    cap = 1 << max(4, (m - 1).bit_length())
    st = torch.full((cap,), n, dtype=torch.int32)
    en = torch.full((cap,), n, dtype=torch.int32)
    st[:m] = torch.from_numpy(starts.astype(np.int32))
    en[:m] = torch.from_numpy(ends.astype(np.int32))
    spans, total, ok = sc.chain_select(st, en, m, n, cap)
    assert bool(ok) and int(total) == len(exp)
    np.testing.assert_array_equal(spans[:int(total)].numpy(), exp)
    assert (spans[int(total):] == n).all()


@pytest.mark.parametrize("pattern,limit", [
    (r"\d{3}", -1), (r"[ab]{2,5}", -1), (r"[ab]{2,5}", 7), (r"b{1,4}", 3),
    (r"[a-c]{4,}", -1), (r"a{2}", 11)])
def test_class_split_matches_reference_host_split(pattern, limit):
    """expand_class_runs on the maximal runs against the reference's
    _charclass_spans (its host split of each run) on random corpora over
    a small alphabet, so runs of every length occur."""
    rng = np.random.default_rng(len(pattern) * 31 + limit)
    data = rng.choice(np.frombuffer(b"aabbc1234 ", np.uint8), 4096)
    n = len(data)
    cc = ct.compile(pattern, device="cpu").batch_engine().plan.charclass
    sm, em = sc.class_run_masks_dense(
        torch.from_numpy(data), table_to_ranges(np.array(cc.table, bool)),
        cc.min)
    runs = torch.stack([torch.nonzero(sm).flatten(),
                        torch.nonzero(em).flatten() + 1], 1).to(torch.int32)
    spans, total = sc.expand_class_runs(runs, cc.min, cc.max, n, limit)
    exp = ref_ct.compile(pattern).batch_engine()._charclass_spans(
        jnp.asarray(data), n, limit)
    assert total == len(exp) > 0
    np.testing.assert_array_equal(spans[:total].numpy(), exp)
    assert (spans[total:] == n).all()


@pytest.mark.parametrize("pattern", [r"x*?", r"(|a)", r"x??", r"(\bfoo)?",
                                     r"a{0,3}", r"\b\d+\b"])
def test_chip_smoke_oracle_follows_go(ref, pattern):
    """chip_smoke.py's oracle (re.finditer, less re's departures from Go's
    FindAll: an empty match abutting the previous match, a non-empty match
    where a lazy pattern matched empty) gives the reference's spans on an
    ASCII corpus."""
    import chip_smoke
    assert chip_smoke.oracle_spans(pattern, CORPORA["ascii"]) == \
        ref(pattern, "ascii")
