"""coregex_tpu_torch's leftmost-longest (POSIX) find_all and count against
the JAX package on the CPU.

A leftmost-longest engine (``compile_posix``) takes the port's find_all
routes with the rule in their tables and arithmetic: the general fallback
reads each start's end from the anchored all-matches DFA ``fwd_anch_all``
(its last flag is the longest end), BITSET_NFA does too (or asks the
Engine's longest host search where that DFA overflows), literal sets are
sorted longest first, ``([c]{m,k})+`` runs take their longest chop, and
line shapes and the other class runs give the same spans under both
rules.  Count is the length of that find_all.

Every case is equal to the reference's ``compile_posix`` through its exact
host walk (an engine with batch_threshold = 1 << 30) on seeded corpora,
with host_routes == 0 on the port: find_all_index, find_all_index with
limits 0, 3 and 2^20, count, find_all_submatch_index and a ``$``
replace_all.  The lazy patterns' POSIX spans differ from their
leftmost-first spans, which shows that ``fwd_anch_all`` is read.  The
reference's device route chops ``([c]{m,k})+`` runs leftmost-first under
POSIX (ROADMAP F12); the port is held to its host walk and to a
brute-force oracle there, never to that device answer.  What still
declines (a nullable plan, a DFA that overflows or does not fit, a
reverse NFA out of the bitset scan's scope) does so before the upload."""

import re

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct
from coregex_tpu.meta.config import Config as RefConfig
from coregex_tpu.meta.engine import Engine as RefEngine
from coregex_tpu.syntax.parser import parse as ref_parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.meta import batch
from coregex_tpu_torch.meta.config import Config
from coregex_tpu_torch.meta.engine import Engine
from coregex_tpu_torch.ops import count_scan, dfa_scan
from coregex_tpu_torch.ops.dfa_scan import DFATables
from coregex_tpu_torch.syntax.parser import parse
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus

torch.set_num_threads(1)

# the log corpus with the edge cases: runs of `a` for the ([c]{m,k})+
# runs, literals of the sets at shared starts, a line of 700 bytes (an
# `a` whose POSIX lane lives through three window rounds), and a match of
# `\b\d+\b` and of `a.*?b` that runs to the end of the corpus
CORPUS = (b"12 aaaa aaaaaaa aaaaa a aa x errors error err erro foobar "
          b"abcabc abcbcd 1.2.3.4.5 user@example.com\n"
          + _log_corpus(51, 17000)
          + b"a" + b"x" * 700 + b"b tail\n"
          + b"ab 10.0.0.255 0.1.2 ab")
# (pattern, the find_all route): the chip run's POSIX patterns first
CHIP = [(r"\b\d+\b", "full_scan"),
        (r"\d+?\.\d+?\.\d+?\.\d+?", "full_scan"),
        (r"a.*?b", "full_scan"),
        (r"[\w.+-]+@[\w.-]+\.[\w.-]+", "full_scan"),
        (r"[a-q][^u-z]{13}x", "bitset"),
        (r"err|error|errors", "literal"),
        (r"([a-z]{2,3})+", "charclass")]
LAZY = [(r"[a-z]+?", "full_scan"), (r"\d+?", "full_scan"),
        (r"[a-z]{2,3}?", "full_scan")]
OTHERS = [(r"\d+(\.\d+)*", "full_scan"), (r"(a|aa)+b?", "full_scan"),
          (r"\w+@\w+\.com", "full_scan"), (r"foo|foobar", "literal"),
          (r"ab|abc|abcabc", "literal"), (r"error", "literal"),
          (r"[\w]+", "charclass"), (r"[a-z]{2,5}", "charclass"),
          (r"([a]{2,3})+", "charclass"), (r"[a-z]+$", "end_anchored")]
ROUTES = CHIP + LAZY + OTHERS
LIMITS = [0, 3, 1 << 20]
# line shapes: the same spans under both rules
LINE_SHAPES = [r".*keyword.*", r"(?m)^/.*\.php", r".*\.txt", r"error.*",
               r"(?m)^GET.*HTTP", r".*error"]


@pytest.fixture(scope="module")
def ref():
    """The reference's spans of (pattern, text) through its exact host
    walk, POSIX by default, computed once."""
    memo = {}

    def spans(pattern, text=CORPUS, longest=True):
        key = (pattern, text, longest)
        if key not in memo:
            eng = ref_ct.compile(pattern, longest=longest)
            eng.batch_threshold = 1 << 30
            memo[key] = eng.find_all_index(text) or []
        return memo[key]
    return spans


def _posix(pattern):
    eng = ct.compile_posix(pattern, device="cpu")
    eng.batch_threshold = 0
    return eng


def _brute_longest(pattern: str, text: bytes):
    """Go's FindAll under leftmost-longest, by brute force: at each
    position the longest end whose slice `re` fully matches, the first
    position that has one; every pattern here is non-nullable."""
    rx = re.compile(pattern.encode())
    out, pos, n = [], 0, len(text)
    while pos < n:
        for s in range(pos, n):
            e = next((e for e in range(n, s, -1)
                      if rx.fullmatch(text, s, e)), None)
            if e is not None:
                out.append((s, e))
                pos = e
                break
        else:
            break
    return out


@pytest.mark.parametrize("pattern,route", ROUTES, ids=[p for p, _ in ROUTES])
def test_find_all_and_count_match_reference(ref, pattern, route):
    eng = _posix(pattern)
    be = eng.batch_engine()
    assert be._spans_route(_arr(CORPUS)) is not None
    exp = ref(pattern)
    assert exp
    assert (eng.find_all_index(CORPUS) or []) == exp
    # the route that served it (behind the bidirectional path, the general
    # fallback, or M5 where that declines the plan)
    assert be.route == route
    for k in LIMITS:
        assert eng.find_all_index(CORPUS, k) == (exp[:k] or None)
    assert eng.count(CORPUS) == len(exp)
    assert be.host_routes == 0


@pytest.mark.parametrize("pattern", [p for p, _ in LAZY] + [r"a.*?b"])
def test_lazy_spans_read_fwd_anch_all(ref, pattern):
    """The lazy plans are FULL_SCAN, not CHARCLASS: their POSIX spans are
    the longest and differ from their leftmost-first spans, on the port as
    on the reference."""
    eng = _posix(pattern)
    assert eng.strategy == "full_scan"
    got = eng.find_all_index(CORPUS)
    assert got == ref(pattern) != ref(pattern, longest=False)
    lf = ct.compile(pattern, device="cpu")
    lf.batch_threshold = 0
    assert lf.find_all_index(CORPUS) == ref(pattern, longest=False)
    assert eng.batch_engine().host_routes == lf.batch_engine().host_routes \
        == 0


def test_window_rounds_and_the_end_of_input():
    """A POSIX lane of `a.*?b` lives to its line's last `b`, 700 bytes on:
    window rounds at W = 64, 256 and 1024; `\\b\\d+\\b`'s last match and
    `a.*?b`'s run to the end of the corpus (the EOI flag)."""
    n = len(CORPUS)
    be = _posix(r"a.*?b").batch_engine()
    spans = be.find_all_spans(_arr(CORPUS))
    assert be.full_scan_stats[1] == 3
    assert any(e - s > 700 for s, e in spans)
    assert tuple(spans[-1]) == (n - 22, n)       # the whole last line
    assert tuple(_posix(r"\b\d+\b").batch_engine().find_all_spans(
        _arr(CORPUS))[0]) == (0, 2)


def test_small_texts_match_brute_force():
    """On short texts, the port's POSIX spans equal a brute-force
    leftmost-longest FindAll built on `re.fullmatch`."""
    text = (b"aaa@bb.com x1.22.3.4 abcab aab aaab err errors 12 3 "
            b"abcabcab aaaaaaa ab")
    for pattern, route in ROUTES + [(r"(a|ab)(c|bcd)", "literal")]:
        if route == "end_anchored":
            continue        # `$` at fullmatch's endpos is no text end
        assert (_posix(pattern).find_all_index(text) or []) == \
            _brute_longest(pattern, text), pattern


# -- ([c]{m,k})+ under POSIX (ROADMAP F12) ------------------------------------

def _runs_oracle(cls: bytes, m: int, k: int, text: bytes):
    """Each maximal run of the class cut to its longest prefix that
    `(?:[c]{m,k})+` fully matches."""
    plus = re.compile(b"(?:[" + cls + b"]{%d,%d})+" % (m, k))
    out = []
    for r in re.finditer(b"[" + cls + b"]+", text):
        s, e = r.span()
        x = next((x for x in range(e - s, 0, -1)
                  if plus.fullmatch(text, s, s + x)), None)
        if x is not None:
            out.append((s, s + x))
    return out


@pytest.mark.parametrize("cls,m,k", [(b"a", 2, 3), (b"a-z", 2, 3),
                                     (b"a", 3, 5), (b"a-z", 3, 3),
                                     (b"0-9", 2, 2)])
def test_plus_runs_take_the_longest_chop(ref, cls, m, k):
    pattern = "([" + cls.decode() + "]{%d,%d})+" % (m, k)
    rng = np.random.default_rng(m * 10 + k)
    text = b" ".join(cls[:1] * int(x) for x in rng.integers(1, 30, 600))
    text = text + b" " + CORPUS
    eng = _posix(pattern)
    assert eng.strategy == "charclass"
    got = eng.find_all_index(text) or []
    assert got == _runs_oracle(cls, m, k, text) == ref(pattern, text)
    assert eng.count(text) == len(got)
    assert eng.batch_engine().host_routes == 0


def test_f12_cases():
    """`([a]{2,3})+` on `aaaa` is (0, 4) and on `aaaaaaa` (0, 7) under
    POSIX, (0, 3) and (0, 6) leftmost-first; the reference's host walk
    agrees."""
    for text, lf, posix in ((b"aaaa", (0, 3), (0, 4)),
                            (b"aaaaaaa", (0, 6), (0, 7))):
        big = text + b" " * (1 << 14)
        assert _posix(r"([a]{2,3})+").find_all_index(big) == [posix]
        eng = ct.compile(r"([a]{2,3})+", device="cpu")
        assert eng.find_all_index(big) == [lf]
        ref = ref_ct.compile_posix(r"([a]{2,3})+")
        ref.batch_threshold = 1 << 30
        assert ref.find_all_index(big) == [posix]


def test_chop_runs_longest_arithmetic():
    """_chop_runs_longest against the brute-force longest split of every
    run length up to 60, for m <= k <= 7."""
    for m in range(1, 8):
        for k in range(m, 8):
            L = torch.arange(m, 61, dtype=torch.int32)
            spans = torch.stack([torch.zeros_like(L), L], dim=1)
            got = batch._chop_runs_longest(spans, m, k)[:, 1].tolist()
            exp = [max(x for x in range(1, ln + 1)
                       if any(j * m <= x <= j * k
                              for j in range(1, x // m + 1)))
                   for ln in L.tolist()]
            assert got == exp, (m, k)


# -- BITSET_NFA under POSIX ---------------------------------------------------

def _bitset_engines(pattern):
    """The port's POSIX engine with an overflowing DFA (state_limit 16,
    batch_threshold 0) and the reference's POSIX host walk."""
    eng = Engine(parse(pattern), longest=True,
                 config=Config(state_limit=16), device="cpu")
    ref = RefEngine(ref_parse(pattern), longest=True,
                    config=RefConfig(state_limit=16))
    eng.batch_threshold, ref.batch_threshold = 0, 1 << 30
    return eng, ref


def _answers(eng, data):
    return (eng.find_all_index(data), eng.count(data),
            eng.find_all_index(data, 3), eng.find_all_index(data, 1 << 20))


@pytest.mark.parametrize("pattern,unit", [
    (r"(ab|cd|ef){3,9}?", b"xx ababab yy cdefab zz abcdefabcdef "),
    (r"x[ab]{8,16}?", b"ss xababababy tt xaaaaaaaaaaaay uu xaby "),
    (r"\b[a-f]{2,8}?[0-9]{2,8}?", b"zz abc42 dd1x eee33 aa00x q9 ab12 ")])
def test_bitset_window_ends_over_fwd_anch_all(pattern, unit):
    corpus_cache.clear()
    data = unit * 150
    eng, ref = _bitset_engines(pattern)
    be = eng.batch_engine()
    route = be._spans_route(_arr(data))
    assert eng.strategy == "bitset_nfa" and route[0] == "bitset"
    assert route[1][1] is not None              # the fwd_anch_all tables
    got = _answers(eng, data)
    assert got == _answers(ref, data)
    assert be.host_routes == 0


def test_bitset_host_ends_are_the_longest():
    """`(a|b)*?a(a|b){15}`: its anchored DFAs overflow, so the Engine's
    host search gives the ends at the device's starts, the longest on a
    POSIX engine (leftmost-first they are the shortest)."""
    pattern = r"(a|b)*?a(a|b){15}"
    rng = np.random.default_rng(9)
    parts = []
    for i in range(40):
        parts.append(bytes(rng.choice(np.frombuffer(b"xyz ab", np.uint8),
                                      size=400)))
        parts.append(b"ab" * (i % 5) + b"a" * (16 + i % 3) + b"b" * (i % 2))
    data = b"".join(parts)
    eng = ct.compile_posix(pattern, device="cpu")
    ref = ref_ct.compile_posix(pattern)
    lf = ref_ct.compile(pattern)
    eng.batch_threshold, ref.batch_threshold = 0, 1 << 30
    lf.batch_threshold = 1 << 30
    be = eng.batch_engine()
    route = be._spans_route(_arr(data))
    assert eng.strategy == "bitset_nfa" and route[0] == "bitset"
    assert route[1][1] is None                  # no anchored tables
    got = _answers(eng, data)
    assert got == _answers(ref, data)
    assert len(got[0]) >= 40 and got[0] != lf.find_all_index(data)
    assert be.host_routes == 0


# -- line shapes, captures, replace ------------------------------------------

@pytest.mark.parametrize("pattern", LINE_SHAPES)
def test_line_shapes_are_rule_independent(ref, pattern):
    eng = _posix(pattern)
    be = eng.batch_engine()
    assert eng.strategy == "line_shape"
    assert be._spans_route(_arr(CORPUS))[0] == "line"
    exp = ref(pattern)
    assert exp == ref(pattern, longest=False)
    assert (eng.find_all_index(CORPUS) or []) == exp
    assert eng.find_all_index(CORPUS, 3) == (exp[:3] or None)
    assert eng.count(CORPUS) == len(exp)
    assert be.host_routes == 0


@pytest.mark.parametrize("pattern,template", [
    (r"(\d+?)\.(\d+?)", "[$2:$1]"), (r"(\w+)@(\w+)\.com", "<$2>"),
    (r"(a|ab)(c|bcd)", "$2$1")])
def test_submatch_and_replace_match_reference(pattern, template):
    """Captures keep the reference's gate: the spans come from the device
    route, the groups from the PikeVM under POSIX."""
    eng = _posix(pattern)
    ref = ref_ct.compile_posix(pattern)
    ref.batch_threshold = 1 << 30
    assert eng.find_all_submatch_index(CORPUS) == \
        ref.find_all_submatch_index(CORPUS)
    assert eng.find_all_submatch_index(CORPUS, 3) == \
        ref.find_all_submatch_index(CORPUS, 3)
    assert eng.replace_all(CORPUS, template) == \
        ref.replace_all(CORPUS, template)
    assert eng.batch_engine().host_routes == 0


# -- what still declines -----------------------------------------------------

@pytest.mark.parametrize("pattern", [
    r"\w*",                     # nullable: the plan is HOST
    r"\b[ab]{15}a",             # rev_all overflows
    r"\d[^\n]{16}ERROR"])       # reverse NFA: 515 range states
def test_declines_before_upload(ref, pattern):
    corpus_cache.clear()
    eng = _posix(pattern)
    be = eng.batch_engine()
    assert be._spans_route(_arr(CORPUS)) is None
    assert be.find_all_spans(_arr(CORPUS)) is None
    assert be.count(_arr(CORPUS)) is None
    assert be.host_routes == 2
    assert corpus_cache._entry(_arr(CORPUS), "cpu").buf is None
    if pattern != r"\w*":
        assert (eng.find_all_index(CORPUS) or []) == ref(pattern)


def test_a_table_that_does_not_fit_declines(monkeypatch, ref):
    """fwd_anch_all past the kernels' shared memory (every table taken
    past it: the instance choice patched) no longer declines the general
    route: the kernels read it from global memory, and the card gives the
    POSIX spans with no host loop."""
    corpus_cache.clear()
    monkeypatch.setattr(count_scan, "table_fits", lambda *a: False)
    monkeypatch.setattr(dfa_scan, "window_fits", lambda *a: False)
    eng = _posix(r"\d+?\.\d+?\.\d+?\.\d+?")
    be = eng.batch_engine()
    big = be._dense("fwd_anch_all")
    assert count_scan.lane_instance(count_scan.MODE_MATCH,
                                    *DFATables.from_dense(big).packed.shape
                                    ) == "global"
    assert be._spans_route(_arr(CORPUS))[0] == "full_scan"
    assert eng.find_all_index(CORPUS) == ref(r"\d+?\.\d+?\.\d+?\.\d+?")
    assert be.host_routes == 0
    assert corpus_cache._entry(_arr(CORPUS), "cpu").buf is not None
