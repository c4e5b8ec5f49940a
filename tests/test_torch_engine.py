"""The coregex_tpu_torch slice end to end on the CPU: compile(p,
device="cpu").count / find_all_index against coregex_tpu.compile(p) and
Python's re, plus the routing contract (declines go to the host loop and
are counted) and the engine seams.

Corpora are seeded numpy log lines of at least 16 KiB (the batch
threshold), so every call takes the batch path; results are integers and
must be exactly equal.
"""

import pickle
import re
import threading

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct
import coregex_tpu_torch as ct
from coregex_tpu_torch.utils import corpus_cache

torch.set_num_threads(1)

WORDS = [b"the", b"quick", b"fox", b"lorem", b"GET", b"POST", b"HTTP/1.1",
         b"200", b"404", b"alpha", b"delta42", b"x86_64", b"warning",
         b"ab", b"cdabe", b"aab", b"w03", b"w44 w69"]
SPECIALS = [b"192.168.1.10", b"10.0.0.255", b"error", b"keyword",
            b"user@example.com", b"admin@test.org", b"v1.2.3",
            b"/index.php", b"/home/user/www.php", b"file.txt",
            b"https://example.com/index.html?q=1", b"http://test.org/a/b",
            b"DELETE", b"2.14.7", b"1.2.3.4.5", b"fe12x", b"9.8.7.6543"]

ALT32 = "|".join(
    ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
     "lambda", "sigma", "omega", "error", "warning", "notice", "debug",
     "trace", "fatal", "panic", "abort", "retry", "timeout", "refused",
     "closed", "opened", "created", "deleted", "updated", "inserted",
     "removed", "flushed", "synced", "loaded", "stored"])
BENCH = [r".*keyword.*", r"\d+\.\d+\.\d+\.\d+", r"[\w.+-]+@[\w.-]+\.[\w.-]+",
         r"\w+://[^\s]+", r"(?m)^/.*\.php", r"\d+.\d+.\d+", r".*\.txt",
         r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH",
         r"error|warning|notice|info|debug", ALT32, r"[\w]+",
         r"(\w{2,8})+", r"error"]
BIDI = [r"\d+\.\d+\.\d+\.\d+", r"\d+.\d+.\d+", r"[\w.+-]+@[\w.-]+\.[\w.-]+",
        r"\w+://[^\s]+", "|".join("w%02d" % i for i in range(70)),
        r"[a-f]+\d+x", r"(ab|cd)+e"]


def _log_corpus(seed, size):
    rng = np.random.default_rng(seed)
    lines, total = [], 0
    while total < size:
        k = int(rng.integers(4, 12))
        line = b" ".join(
            SPECIALS[int(rng.integers(len(SPECIALS)))] if rng.random() < 0.15
            else WORDS[int(rng.integers(len(WORDS)))] for _ in range(k))
        lines.append(line + b"\n")
        total += len(line) + 1
    return b"".join(lines)[:size]


def _arr(t):
    return np.frombuffer(t, dtype=np.uint8)


@pytest.mark.parametrize("pattern", BIDI)
def test_slice_matches_reference_and_re(pattern):
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    for seed, size in ((1, 16384), (2, 20000)):
        t = _log_corpus(seed, size)
        exp = [m.span() for m in re.finditer(pattern.encode(), t)]
        assert eng.count(_arr(t)) == ref.count(_arr(t)) == len(exp)
        got = eng.find_all_index(t)
        assert got == ref.find_all_index(t)
        assert [tuple(s) for s in (got or [])] == exp
    assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("pattern", BENCH)
def test_bench_counts_match_reference_and_re(pattern):
    t = _log_corpus(3, 24000)
    eng = ct.compile(pattern, device="cpu")
    exp = len(re.findall(pattern.encode(), t))
    assert eng.count(t) == ref_ct.compile(pattern).count(t) == exp
    assert eng.batch_engine().host_routes == 0


# patterns the needle kernels count, with the route the BatchEngine picks:
# K5 for line shapes, K6 for literal sets (K7 when two hits overlap)
NEEDLE_ROUTES = [(r".*keyword.*", "line"), (r"(?m)^/.*\.php", "line"),
                 (r".*\.txt", "line"),
                 (r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH", "hits"),
                 (r"error|warning|notice|info|debug", "hits"),
                 (ALT32, "hits"), (r"error", "hits"), (r"0\.0", "hits")]


def _line_corpus(seed, size):
    """Log lines, a fifth of them starting with a path."""
    t = _log_corpus(seed, size)
    return b"\n".join(b"/www" + ln if i % 5 == 0 else ln
                      for i, ln in enumerate(t.split(b"\n")))


@pytest.mark.parametrize("pattern, route", NEEDLE_ROUTES)
def test_needle_routes_match_reference_and_re(pattern, route):
    t = _line_corpus(30, 24000)
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    be = eng.batch_engine()
    assert be._count_route(_arr(t))[0] == route
    exp = [m.span() for m in re.finditer(pattern.encode(), t)]
    assert eng.count(t) == ref.count(t) == len(exp)
    if route == "line":
        got = eng.find_all_index(t)
        assert got == ref.find_all_index(t)
        assert [tuple(s) for s in got] == exp
    assert be.host_routes == 0


def test_overlapping_literal_counts_through_k7():
    """0\\.0 overlaps itself in 10.0.0.255: K6 reports the overlap and
    K7 counts leftmost-first."""
    t = _log_corpus(31, 24000)
    eng = ct.compile(r"0\.0", device="cpu")
    be = eng.batch_engine()
    seq = be._seq_scanner()
    calls = []
    count = seq.count
    seq.count = lambda *a: calls.append(1) or count(*a)
    assert eng.count(t) == len(re.findall(rb"0\.0", t))
    assert calls == [1]
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    assert be._hits_scanner().count(torch.from_numpy(_arr(t).copy()),
                                    plan_geometry(len(t))) is None
    assert be.host_routes == 0


def test_line_shape_find_all_routes():
    """A (?s) line shape takes its at-most-one-match route on the device;
    the candidate chain has one form, whose sync for the candidate total
    sizes it cold and warm alike (measured no slower at 1536 MiB than the
    form that deferred it on a warm call); past MAX_DEVICE_SPANS
    candidates the chain goes in pieces."""
    t = _line_corpus(32, 20000)
    eng = ct.compile(r"(?s).*keyword", device="cpu")
    assert eng.batch_engine().plan.strategy.name == "LINE_SHAPE"
    assert eng.batch_engine()._spans_route(_arr(t))[0] == "line_any"
    assert eng.find_all_index(t) == [m.span() for m in
                                     re.finditer(rb"(?s).*keyword", t)]
    assert eng.batch_engine().host_routes == 0
    pattern = r".*\.txt"
    be = ct.compile(pattern, device="cpu").batch_engine()
    exp = [m.span() for m in re.finditer(pattern.encode(), t)]
    for _ in range(2):
        spans, cnt, ok = be.find_all_spans_device(_arr(t), defer_ok=True)
        assert isinstance(cnt, int) and ok is None and cnt == len(exp)
        assert [tuple(r) for r in spans[:cnt].tolist()] == exp
    be.MAX_DEVICE_SPANS = 4
    assert [tuple(x) for x in be.find_all_spans(_arr(t)).tolist()] == exp
    assert be.host_routes == 0 and be.pieces[0] >= 2


def test_warm_defer_path():
    """A second find_all on the same corpus sizes its caps from the
    cached count: count and ok come back as device scalars."""
    pattern = r"\d+\.\d+\.\d+\.\d+"
    be = ct.compile(pattern, device="cpu").batch_engine()
    t = _log_corpus(4, 20000)
    exp = [m.span() for m in re.finditer(pattern.encode(), t)]
    spans, cnt, ok = be.find_all_spans_device(_arr(t), defer_ok=True)
    assert isinstance(cnt, int) and ok is None and cnt == len(exp)
    spans, cnt, ok = be.find_all_spans_device(_arr(t), defer_ok=True)
    assert isinstance(cnt, torch.Tensor) and bool(ok)
    got = [tuple(r) for r in spans[:int(cnt)].tolist()]
    assert got == exp


def test_declines_are_counted_and_served_by_host():
    t = _log_corpus(5, 20000)
    eng = ct.compile(r"error", device="cpu")     # LITERAL
    be = eng.batch_engine()
    exp = [m.span() for m in re.finditer(rb"error", t)]
    assert eng.find_all_index(t) == exp           # literal chain: served
    assert be.host_routes == 0
    assert eng.find_all_index(t, 3) == exp[:3]    # limit: the same route
    assert be.host_routes == 0
    assert eng.find_index(t) == exp[0]            # find_first: no decline
    assert eng.is_match(t) is True                # is_match: no decline
    assert be.host_routes == 0
    assert eng.count(t) == len(exp)               # K6: no decline
    assert be.host_routes == 0
    # BITSET_NFA whose reverse NFA is out of the bitset scan's scope: host
    pattern = rb"\d[^\n]{16}ERROR"
    eng = ct.compile(pattern.decode(), device="cpu")
    exp = [m.span() for m in re.finditer(pattern, t)]
    assert eng.find_all_index(t) == (exp or None)
    assert eng.find_all_index(t, 3) == (exp[:3] or None)
    assert eng.batch_engine().host_routes == 2


def test_nullable_count_utf8_gate():
    """Nullable plans count through the empty-match transducer on ASCII
    corpora; past a multi-byte UTF-8 lead they count the device find_all.
    (Python's re is no oracle here: it admits an empty match right after a
    non-empty one, Go does not.)"""
    pattern = r"\w*"
    eng = ct.compile(pattern, device="cpu")
    t = _log_corpus(6, 17000)
    host = ct.compile(pattern, device="cpu")
    host.batch_threshold = 1 << 30
    assert eng.count(t) == ref_ct.compile(pattern).count(t) == host.count(t)
    assert eng.batch_engine().host_routes == 0
    u = t[:16500] + "é".encode() + t[16500:]
    assert eng.count(u) == ref_ct.compile(pattern).count(u)
    # no decline: the gate sends the count to the device find_all (and
    # is asked once)
    be = eng.batch_engine()
    assert be.host_routes == 0
    asked = []
    route = be._count_route
    be._count_route = lambda d: asked.append(1) or route(d)
    assert eng.count(t) == host.count(t)
    assert asked == [1]


def test_repair_settles_instead_of_declining():
    """Quote parity is long-range state: lane guesses stay wrong past the
    reference's 4 repair passes.  The device path keeps repairing until
    the fixpoint holds and serves the call itself."""
    pattern = r'"[^"]*"'
    t = (b'"' + b"x" * 299) * 100
    exp = [m.span() for m in re.finditer(pattern.encode(), t)]
    eng = ct.compile(pattern, device="cpu")
    assert eng.count(t) == len(exp) == 50
    assert eng.find_all_index(t) == exp
    assert eng.batch_engine().host_routes == 0


def test_declines_are_decided_before_upload():
    t = _log_corpus(10, 20000)
    pattern = r"\d[^\n]{16}ERROR"               # reverse NFA: 515 states
    eng = ct.compile(pattern, device="cpu")      # BITSET_NFA: host
    assert eng.batch_engine().plan.strategy.name == "BITSET_NFA"
    assert eng.find_all_index(t) == ([m.span() for m in re.finditer(
        pattern.encode(), t)] or None)
    assert eng.batch_engine().host_routes == 1
    assert corpus_cache._entry(_arr(t), "cpu").buf is None
    ct.compile(r"[a-z]{2,5}", device="cpu").count(t)  # served: uploads
    assert corpus_cache._entry(_arr(t), "cpu").buf is not None


def test_span_limit_raises_instead_of_declining():
    """Past MAX_DEVICE_SPANS matches the bidirectional path neither raises
    nor declines: its chains go in pieces of the limit, giving re's spans
    (the reference's, for a pattern with no empty match)."""
    pattern = r"\d+\.\d+\.\d+\.\d+"
    t = _log_corpus(11, 20000)
    eng = ct.compile(pattern, device="cpu")
    be = eng.batch_engine()
    be.MAX_DEVICE_SPANS = 4
    assert eng.find_all_index(t) == [m.span() for m in
                                     re.finditer(pattern.encode(), t)]
    assert be.host_routes == 0 and be.pieces[0] >= 2


def test_small_inputs_stay_on_host():
    eng = ct.compile(r"\d+\.\d+", device="cpu")
    assert eng.find_all_index(b"a 1.2 b 3.4") == [(2, 5), (8, 11)]
    assert eng.count(b"1.2 3.4 5.6") == 3
    assert eng._batch is None or eng._batch.host_routes == 0


def test_device_is_explicit():
    eng = ct.compile(r"a+b")                      # no GPU probe
    assert eng.device == torch.device("cuda")
    cpu = ct.compile(r"a+b", device="cpu")
    assert cpu.batch_engine().device == torch.device("cpu")
    cpu.set_longest(True)
    assert cpu.longest and cpu.device == torch.device("cpu")
    assert isinstance(cpu, ct.Regex)
    back = pickle.loads(pickle.dumps(cpu))
    assert back.device == torch.device("cpu") and back.longest
    assert ct.compile_posix(r"a+b", device="cpu").longest
    assert ct.must_compile(r"a+b", device="cpu").count(b"aab ab") == 2


def test_capture_and_row_seams_stay_on_host():
    """The two seams that stayed on the host until the captures and row
    batches were ported now serve on the engine's device: _batch_captures
    extracts every span of a corpus-scale FindAllSubmatch through the
    OnePass walk, and the row batches go through the row scans; the
    results are the reference engine's."""
    pattern = r"(\d+)\.(\d+)"
    t = _log_corpus(7, 20000)
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    spans = eng.find_all_index(t)
    assert len(spans) >= 64
    before = eng.stats.kernel_scans
    batched = eng._batch_captures(_arr(t), spans)
    assert eng.stats.kernel_scans == before + 1
    assert all(b is not None and b[:2] == sp for b, sp in zip(batched,
                                                              spans))
    assert eng._batch_rows_ok()
    assert eng.find_all_submatch_index(t) == ref.find_all_submatch_index(t)
    assert eng.replace_all(t, b"$2.$1") == ref.replace_all(t, b"$2.$1")
    rows = [b"x 1.2", b"nothing", b"3.4 5.6"]
    before = eng.stats.kernel_scans
    assert eng.find_index_batch(rows) == [(2, 5), None, (0, 3)]
    assert eng.is_match_batch(rows) == [True, False, True]
    assert eng.stats.kernel_scans == before + 2


def test_corpus_cache_contract():
    t = _log_corpus(8, 20000)
    a = _arr(t)
    d1 = corpus_cache.device_corpus(a, "cpu")
    assert corpus_cache.device_corpus(a, "cpu") is d1
    np.testing.assert_array_equal(
        corpus_cache.device_corpus_flipped(a, "cpu").numpy(), a[::-1])
    assert corpus_cache.corpus_is_ascii(a, "cpu")
    u = np.concatenate([a, np.array([0xC3, 0xA9], np.uint8)])
    assert not corpus_cache.corpus_is_ascii(u, "cpu")
    # sampled fingerprint: a copy with identical sampled bytes (here: the
    # same bytes) maps to the same entry; buffers are never mutated
    assert corpus_cache.device_corpus(a.copy(), "cpu") is d1
    # derived tiles live on the entry and go with it
    built = []

    def build():
        built.append(1)
        return d1[:64].clone()

    t1 = corpus_cache.corpus_tiles(a, "cpu", ("words", 1), build)
    assert corpus_cache.corpus_tiles(a, "cpu", ("words", 1), build) is t1
    assert built == [1]
    corpus_cache.release_flipped()
    assert corpus_cache.corpus_tiles(a, "cpu", ("words", 1), build) \
        is not t1
    assert corpus_cache.device_corpus(a, "cpu") is d1
    corpus_cache.clear()
    assert corpus_cache.device_corpus(a, "cpu") is not d1


def test_threads_share_one_engine():
    """Concurrent find_all calls on one engine with different corpora:
    the corpus travels as arguments, so no call sees another's."""
    pattern = r"\d+\.\d+\.\d+\.\d+"
    eng = ct.compile(pattern, device="cpu")
    corpora = [_log_corpus(20 + i, 17000 + 512 * i) for i in range(4)]
    exp = [[m.span() for m in re.finditer(pattern.encode(), t)]
           for t in corpora]
    errors = []

    def work(i):
        for _ in range(3):
            if eng.find_all_index(corpora[i]) != exp[i]:
                errors.append(i)

    threads = [threading.Thread(target=work, args=(i % 4,))
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_positions_past_int32_are_refused(monkeypatch):
    """Device positions are int32: a corpus past the limit raises instead
    of wrapping (the limit is lowered here to keep the corpus small)."""
    from coregex_tpu_torch.meta import batch
    monkeypatch.setattr(batch, "MAX_CORPUS", 20000)
    eng = ct.compile(r"\d+\.\d+\.\d+\.\d+", device="cpu")
    t = _log_corpus(9, 20001)
    with pytest.raises(ValueError, match="int32"):
        eng.count(t)
    with pytest.raises(ValueError, match="int32"):
        eng.find_all_index(t)
    assert eng.count(t[:20000]) == len(re.findall(
        rb"\d+\.\d+\.\d+\.\d+", t[:20000]))
