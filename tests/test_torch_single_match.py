"""The single-match entry points of coregex_tpu_torch on the CPU:
Engine.is_match and Engine.find_index (find, find_string and match run
through them) with device="cpu" against the JAX package's Engine, and
the routes they take (host_routes).

Corpora are seeded numpy log lines of 64 KiB, above batch_threshold, so
every call takes the batch path: an early match, a late match (spaces,
then a newline, then log lines), no match (spaces only) and a UTF-8
corpus.  All four have one length, since the JAX package compiles its
scans per corpus shape.  Results are spans and booleans: exact equality.
"""

import re

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct
import coregex_tpu_torch as ct
from coregex_tpu_torch.utils import corpus_cache

torch.set_num_threads(1)

N = 1 << 16
WORDS = [b"the", b"quick", b"GET", b"POST", b"200", b"alpha", b"x86_64",
         b"warning", b"ab", b"bbac", b"xa", b"a", b"z", b"foo"]
SPECIALS = [b"192.168.1.10", b"error", b"keyword", b"user@example.com",
            b"v1.2.3", b"/index.php", b"/home/user/www.php", b"file.txt",
            b"https://example.com/index.html?q=1", b"DELETE", b"2.14.7",
            b"deadbeef-12", b"4 5 6"]
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
EXTRA = [r"\s\d\s", r"(a|b)+c", r"[0-9a-f]{8}-",      # FULL_SCAN
         r"\d+$", r"foo$",                            # END_ANCHORED
         r"\w*",                                      # nullable
         r"a\b", r"x\B", r"(?m)z$"]                   # look-arounds at ends


def _lines(seed, size, specials=0.1):
    rng = np.random.default_rng(seed)
    out, total = [], 0
    while total < size:
        k = int(rng.integers(3, 10))
        line = b" ".join(
            SPECIALS[int(rng.integers(len(SPECIALS)))]
            if rng.random() < specials
            else WORDS[int(rng.integers(len(WORDS)))]
            for _ in range(k)) + b"\n"
        out.append(line)
        total += len(line)
    return b"".join(out)


def _corpora():
    body = _lines(1, N)
    early = body[:N - 6] + b" 12345"
    tail = _lines(2, 6000, specials=0.3)[:5000] + b" foo"
    late = b" " * (N - len(tail) - 1) + b"\n" + tail
    utf8 = "é日本".encode().join(_lines(3, N).split(b" the "))[:N - 2] \
        + "é".encode()
    out = {"early": early, "late": late, "none": b" " * N, "utf8": utf8}
    assert all(len(t) == N for t in out.values())
    return out


CORPORA = _corpora()


def _arr(t):
    return np.frombuffer(t, dtype=np.uint8)


@pytest.mark.parametrize("pattern", BENCH + EXTRA)
def test_single_match_equals_reference(pattern):
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    be = eng.batch_engine()
    for name, t in CORPORA.items():
        a = _arr(t)
        assert eng.is_match(a) == ref.is_match(a), name
        got = eng.find_index(a)
        assert got == ref.find_index(a), name
        assert eng.find(a) == (None if got is None
                               else bytes(a[got[0]:got[1]]))
    # nullable find_index is the one host route: the reference's FALLBACK
    assert be.host_routes == (len(CORPORA) * 2 if pattern == r"\w*" else 0)


def test_matches_found_and_missed():
    """The corpora exercise both answers: most patterns match the early
    corpus, none but the nullable one matches the spaces."""
    hits = {p: ct.compile(p, device="cpu").is_match(CORPORA["early"])
            for p in BENCH + EXTRA}
    assert sum(hits.values()) >= len(hits) - 2
    for p in BENCH + EXTRA:
        assert ct.compile(p, device="cpu").is_match(CORPORA["none"]) == (
            p == r"\w*"), p


EDGE_CASES = [
    (r"a\b", b"a ", False), (r"a\b", b"a", True),
    (r"x\B", b"xa", False), (r"x\B", b"x", True),
    (r"(?m)z$", b"z\n", False), (r"(?m)z$", b"z", True),
]


@pytest.mark.parametrize("pattern,first,at_end", EDGE_CASES)
def test_matches_ending_at_a_prefix_edge_and_at_n(pattern, first, at_end):
    """A match whose end is the first prefix's edge (its flag lies at the
    edge, read by the next prefix) or the corpus end (the EOI flag at the
    exit state).  Checked against re and the host engine.  The cases'
    corpora differ only at unsampled bytes, so the corpus cache (keyed on
    a sampled fingerprint, ROADMAP F5) is cleared first."""
    corpus_cache.clear()
    n = 20000
    if at_end:
        t = b"." * (n - len(first)) + first
    else:
        t = (b"." * (4096 - 1) + first).ljust(n, b".")
    eng = ct.compile(pattern, device="cpu")
    eng.batch_engine().FIRST_PREFIX = 4096
    host = ct.compile(pattern, device="cpu")
    host.batch_threshold = 1 << 40
    m = re.search(pattern.encode(), t)
    exp = None if m is None else m.span()
    assert eng.find_index(t) == host.find_index(t) == exp
    assert eng.is_match(t) == host.is_match(t) == (exp is not None)
    if not at_end:
        assert exp == (4095, 4096)
    assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("pattern", [r"[\w]+", r"(\w{2,8})+", r"\d{3,5}"])
def test_charclass_runs_across_prefix_edges(pattern):
    """A class run that crosses a prefix edge is read whole: the prefix
    grows until the run ends."""
    t = b"." * 4000 + b"x" * 300 + b"." + b"7" * 5000 + b"." * 12000
    eng = ct.compile(pattern, device="cpu")
    assert eng.strategy == "charclass"
    eng.batch_engine().FIRST_PREFIX = 4096
    ref = ref_ct.compile(pattern)
    assert eng.find_index(t) == ref.find_index(t) == \
        re.search(pattern.encode(), t).span()
    assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("pattern,tail", [(r"\d+$", b" 77"),
                                          (r"foo$", b" foo")])
def test_end_anchored_routes(pattern, tail):
    """END_ANCHORED count, find_all and find_index all take the host
    reverse scan from the end (no upload), as in the reference."""
    corpus_cache.clear()
    t = CORPORA["early"] + tail
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    assert eng.count(t) == ref.count(t) == 1
    assert eng.find_all_index(t) == ref.find_all_index(t)
    assert eng.find_all_index(t, 0) is None
    assert eng.find_index(t) == ref.find_index(t)
    be = eng.batch_engine()
    spans, cnt = be.find_all_spans_device(_arr(t))
    assert cnt == 1 and tuple(spans[0].tolist()) == ref.find_index(t)
    assert be.host_routes == 0
    assert corpus_cache._entry(_arr(t), "cpu").buf is None


@pytest.mark.parametrize("pattern", [r"(\d+$)?", r"(foo$)?"])
def test_nullable_end_anchored_core(pattern):
    """A nullable pattern whose core is END_ANCHORED: the core's find_all
    is the host reverse scan, so the nullable path now serves it on the
    device (it declined before)."""
    corpus_cache.clear()
    ref = ref_ct.compile(pattern)
    for t in (CORPORA["early"], CORPORA["utf8"] + b" foo"):
        eng = ct.compile(pattern, device="cpu")
        assert eng.find_all_index(t) == ref.find_all_index(t)
        assert eng.count(t) == ref.count(t)
        assert eng.is_match(t) is True
        assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("pattern", [r"(a|ab)(c|bcd)", r"\s\d\s",
                                     r"[\w]+@\w+"])
def test_leftmost_longest_is_match(pattern):
    """Whether a match exists does not depend on the rule: a POSIX engine's
    is_match takes the device routes; its find stays on the host."""
    eng = ct.compile_posix(pattern, device="cpu")
    ref = ref_ct.compile_posix(pattern)
    for t in (CORPORA["early"], CORPORA["none"]):
        assert eng.is_match(t) == ref.is_match(t)
    assert eng.batch_engine().host_routes == 0
    assert eng.find_index(CORPORA["early"]) == ref.find_index(
        CORPORA["early"])


def test_tables_too_large_decline_before_upload(monkeypatch):
    """A DFA that overflows declines before the corpus is uploaded; one
    whose packed table would not fit the kernels' shared memory takes
    their global-memory instance and stays on the device."""
    from coregex_tpu_torch.dfa.determinize import DFAOverflow
    from coregex_tpu_torch.ops import count_scan, dfa_scan
    corpus_cache.clear()
    t = CORPORA["early"]
    # every table past shared memory: the instance choice patched
    monkeypatch.setattr(count_scan, "table_fits", lambda *a: False)
    monkeypatch.setattr(dfa_scan, "window_fits", lambda *a: False)
    eng = ct.compile(r"\s\d\s", device="cpu")
    assert eng.is_match(t) is True
    assert eng.find_index(t) == re.search(rb"\s\d\s", t).span()
    assert eng.batch_engine().host_routes == 0
    assert corpus_cache._entry(_arr(t), "cpu").buf is not None
    monkeypatch.undo()
    corpus_cache.clear()
    eng = ct.compile(r"\d+\.\d+\.\d+\.\d+", device="cpu")
    be = eng.batch_engine()
    dense = be._dense

    def overflow(kind):
        if kind == "rev_anch":
            raise DFAOverflow("limit")
        return dense(kind)
    monkeypatch.setattr(be, "_dense", overflow)
    assert eng.find_index(t) == re.search(rb"\d+\.\d+\.\d+\.\d+", t).span()
    assert be.host_routes == 1


def test_find_string_and_match_run_through_the_device():
    t = CORPORA["late"].decode()
    eng = ct.compile(r"\d+\.\d+\.\d+", device="cpu")
    assert eng.find_string(t) == re.search(r"\d+\.\d+\.\d+", t).group()
    assert eng.match(t) is True
    assert eng.stats.kernel_scans == 2
    assert eng.batch_engine().host_routes == 0
