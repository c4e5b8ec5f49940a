"""coregex_tpu_torch's find_all past its span limits, against the JAX
package on the CPU.

Every find_all route that chip_smoke.py drives at 2,145,381,040 bytes is
run here on a few KiB with the engine's limits patched down:
MAX_DEVICE_SPANS (the cap of one compaction) to 4, 7, 16 and 64, so that
each result is cut into output pieces whose seams fall in different
places, and DEVICE_SPANS_LIMIT (the corpus positions of one piece of the
nullable fill) to about 1 KiB, so that the general nullable path and
ALL_EMPTY also take corpus pieces.  Each case is bit-equal to the
reference engine's find_all with its default limits (its exact host walk,
an engine with batch_threshold = 1 << 30), takes at least two output
pieces and never reaches the host loop (host_routes 0); at the cap of 64
it also checks find_all with a limit, count, and, where the route serves
compile_posix, the leftmost-longest find_all and count against the
reference's.  The seam cases: overlapping literal hits (`aa` on a run of
a's), empty matches that abut a match on UTF-8 text (`\\w*`, `(error)?`),
word and rune boundaries of an odd-length corpus, captures and $
templates of the ip pattern with groups.  The line shapes whose event
chain declines take a device route: `(?s)error.*`, `(?s).*error` and
`a\\nb.*` equal the reference, `x\\n.*` and `r x\\n.*` equal re and the
port's host loop (the reference finds no match there: ROADMAP F13); on
invalid UTF-8, where the general route's DFAs are wrong (ROADMAP P4),
those that would take the general fallback decline before the upload.
Selections of about 30 bytes a candidate (overlapping literal hits, line
candidates, the general route's and the bidirectional chains) take
pieces of CHAIN_PIECE candidates even within the span limit.  Past a
patched MAX_CORPUS a call still raises.  Spans are integers: exact
equality."""

import re

import pytest
import torch

import coregex_tpu as ref_ct
import coregex_tpu_torch as ct
from coregex_tpu_torch.meta import batch
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus
from test_torch_invalid_utf8 import go_spans

torch.set_num_threads(1)

# one line holding a match of every route's pattern, UTF-8 runes beside
# words and digits, an abutting `error` pair and a run of a's
_FEATURES = ("GET /index.php 192.168.1.10 error user@example.com v1.2.3 "
             "été 12€ errorerror abcdefghijklmnx aaaa 7 10.0.0.1 "
             "POST a@b.org bcdefghijklmnox \U0001F600x\n").encode()


def _corpus() -> bytes:
    """About 7 KiB of valid UTF-8: a feature line after each seeded log
    line, odd length, ending inside a word after a two-byte rune."""
    logs = _log_corpus(61, 1500).split(b"\n")
    t = b"".join(line + b"\n" + _FEATURES for line in logs)
    t += "tail error xé".encode()
    return t if len(t) % 2 else t + b"z"


CORPUS = _corpus()

# (name, pattern, find_all route on CORPUS, served under compile_posix);
# chip_smoke.LIMITS drives the same list at full scale
ROUTES = [
    ("charclass_w", r"[\w]+", "charclass", True),
    ("lower2_5", r"[a-z]{2,5}", "charclass", True),
    ("inner_error", r".*error.*", "line", True),
    ("ip", r"\d+\.\d+\.\d+\.\d+", "bidi", True),
    ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+", "bidi", True),
    ("word_digits", r"\b\d+\b", "full_scan", True),
    ("nfa_u_z", r"[a-q][^u-z]{13}x", "bitset", True),
    ("literal_error", r"error", "literal", True),
    ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH", "literal",
     True),
    ("word_star", r"\w*", "nullable", False),
    ("error_opt", r"(error)?", "nullable", False),
    ("empty_lazy", r"x*?", "all_empty", False),
    ("dot", r".", "bidi", True),
    ("dotall_error", r"(?s)error.*", "line_any", True),
]
CAPS = [4, 7, 16, 64]
# the caps each route repeats at; the extra checks run at the last one.  The
# bitset scan's plain version costs about 4 s a call whatever the corpus,
# so its route runs at that cap only
EXTRA_CAP = 64
CASES = [(*r, cap) for r in ROUTES
         for cap in ((EXTRA_CAP,) if r[2] == "bitset" else CAPS)]
FILL_PIECE = 1024     # DEVICE_SPANS_LIMIT: about nine corpus pieces

_MEMO = {}


def ref_spans(pattern: str, text: bytes = CORPUS, longest: bool = False,
              what: str = "find_all_index"):
    """The reference engine's answer through its exact host walk, once per
    (pattern, text, rule, call)."""
    key = (pattern, text, longest, what)
    if key not in _MEMO:
        eng = ref_ct.compile(pattern, longest=longest)
        eng.batch_threshold = 1 << 30
        if what == "find_all_index":
            _MEMO[key] = eng.find_all_index(text) or []
        elif what == "submatch":
            _MEMO[key] = eng.find_all_submatch_index(text)
        else:
            _MEMO[key] = eng.replace_all(text, b"[$2:$1]")
    return _MEMO[key]


def _limited(eng, cap: int):
    """The engine's batch engine with its limits patched down; corpora of a
    few KiB take the batch path (the default threshold is 16 KiB)."""
    eng.batch_threshold = 0
    be = eng.batch_engine()
    be.MAX_DEVICE_SPANS = cap
    be.DEVICE_SPANS_LIMIT = FILL_PIECE + cap
    return be


@pytest.mark.parametrize("name,pattern,route,posix,cap", CASES,
                         ids=[f"{r[0]}-{r[4]}" for r in CASES])
def test_pieced_find_all_matches_reference(name, pattern, route, posix,
                                           cap):
    corpus_cache.clear()
    t = CORPUS
    exp = ref_spans(pattern)
    eng = ct.compile(pattern, device="cpu")
    be = _limited(eng, cap)
    assert be._spans_route(_arr(t))[0] == route
    assert eng.find_all_index(t) == exp
    # a (?s) line shape matches at most once: one span, one piece
    assert be.pieces[0] >= (1 if route == "line_any" else 2)
    if route in ("nullable", "all_empty"):
        assert be.pieces[1] >= 2
    if cap == EXTRA_CAP:
        k = len(exp) // 2 + 1
        assert eng.find_all_index(t, k) == exp[:k]
        assert eng.count(t) == len(exp)
        if posix:
            pe = ct.compile_posix(pattern, device="cpu")
            pbe = _limited(pe, cap)
            pexp = ref_spans(pattern, longest=True)
            assert pe.find_all_index(t) == pexp
            assert pe.count(t) == len(pexp)
            assert pbe.host_routes == 0
    assert be.host_routes == 0


def test_ascii_nullable_k8_pair_in_pieces():
    """`\\w*` on an ASCII corpus: the K8 mask pair, each column compacted
    in pieces."""
    t = _log_corpus(62, 9001)
    for cap in CAPS:
        eng = ct.compile(r"\w*", device="cpu")
        be = _limited(eng, cap)
        assert be._spans_route(_arr(t))[0] == "nullable_k8"
        assert eng.find_all_index(t) == ref_spans(r"\w*", t)
        assert be.pieces[0] >= 2 and be.host_routes == 0


@pytest.mark.parametrize("cap", [4, 7, 16])
def test_overlapping_hits_across_seams(cap):
    """`aa` and `aaa|aa` on runs of a's: every hit overlaps the next, so
    Go's selection carries the last accepted end across each seam;
    `aa\\B` on the same text takes the general route's chain across its
    seams."""
    t = (b"a" * 201 + b" b ") * 4 + b"a" * 700
    for pattern, route in (("aa", "literal"), ("aaa|aa", "literal"),
                           (r"aa\B", "full_scan")):
        eng = ct.compile(pattern, device="cpu")
        be = _limited(eng, cap)
        assert be._spans_route(_arr(t))[0] == route
        assert eng.find_all_index(t) == ref_spans(pattern, t)
        assert be.pieces[0] >= 2 and be.host_routes == 0


@pytest.mark.parametrize("pattern", [r"\w*", r"(error)?", r"(\bfoo)?",
                                     r"a{0,3}"])
def test_abutting_empties_on_utf8_seams(pattern):
    """Nullable patterns on UTF-8 text whose corpus pieces end right after
    a match (Go bars the empty match that abuts it) and inside runes."""
    t = ("erroréfoo a€aa \U0001F600errorerror foo " * 230
         ).encode() + b"x"
    for fill in (997, 1000, 1003):
        eng = ct.compile(pattern, device="cpu")
        be = _limited(eng, 7)
        be.DEVICE_SPANS_LIMIT = fill
        assert eng.find_all_index(t) == ref_spans(pattern, t)
        assert be.pieces[1] >= 2 and be.host_routes == 0


def test_captures_and_templates_in_pieces():
    """find_all_submatch_index and replace_all of the ip pattern with
    groups, whose spans come from the pieced bidirectional path."""
    pattern = r"(\d+)\.(\d+)\.(\d+)\.(\d+)"
    eng = ct.compile(pattern, device="cpu")
    be = _limited(eng, 7)
    assert eng.find_all_submatch_index(CORPUS) == ref_spans(
        pattern, what="submatch")
    assert eng.replace_all(CORPUS, b"[$2:$1]") == ref_spans(
        pattern, what="replace")
    assert be.pieces[0] >= 2 and be.host_routes == 0


F13_CORPUS = b"GET /a.php 10.0.0.1 error x\nfoo bar 1.2 abc\n" * 600


@pytest.mark.parametrize("pattern,oracle", [
    (r"(?s)error.*", "reference"), (r"(?s).*error", "reference"),
    (r"a\nb.*", "reference"), (r"x\n.*", "re"), (r"r x\n.*", "re")])
def test_declined_line_shapes_take_a_device_route(pattern, oracle):
    """LINE_SHAPE plans that the event chain declines: the (?s) shapes take
    their at-most-one-match route, a newline in the literal the general
    fallback.  `x\\n.*` and `r x\\n.*` hold to re (no empty match, so
    re's spans are Go's) and the port's host loop, not to the
    reference's empty answer."""
    t = F13_CORPUS
    eng = ct.compile(pattern, device="cpu")
    be = eng.batch_engine()
    assert be.plan.strategy.name == "LINE_SHAPE"
    assert be._spans_route(_arr(t)) is not None
    got = eng.find_all_index(t)
    if oracle == "re":
        exp = [m.span() for m in re.finditer(pattern.encode(), t)]
        assert len(exp) == 600
        host = ct.compile(pattern, device="cpu")
        host.batch_threshold = 1 << 30
        assert host.find_all_index(t) == exp
    else:
        exp = ref_spans(pattern, t)
    assert (got or []) == exp
    assert eng.count(t) == len(exp)
    assert be.host_routes == 0


def test_past_max_corpus_still_raises(monkeypatch):
    """Positions stay int32: past MAX_CORPUS (patched down here) count and
    find_all raise before the upload, as before."""
    corpus_cache.clear()
    monkeypatch.setattr(batch, "MAX_CORPUS", len(CORPUS) - 1)
    eng = ct.compile(r"\d+\.\d+\.\d+\.\d+", device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    with pytest.raises(ValueError, match="int32 position range"):
        eng.count(CORPUS)
    with pytest.raises(ValueError, match="int32 position range"):
        be.find_all_spans_device(_arr(CORPUS))
    assert corpus_cache._entry(_arr(CORPUS), "cpu").buf is None


def test_sparse_limit_is_max_corpus():
    """Every find_all route serves corpora up to MAX_CORPUS; the caps of
    one compaction stay at 2^30."""
    assert batch.BatchEngine.SPARSE_SPANS_LIMIT == batch.MAX_CORPUS
    assert batch.BatchEngine.MAX_DEVICE_SPANS == 2 ** 30
    assert batch.BatchEngine.CHAIN_PIECE <= batch.BatchEngine.MAX_DEVICE_SPANS


@pytest.mark.parametrize("pattern", [r"x\n.*", r"r x\n.*", r"a\nb.*"])
def test_line_shape_fallback_declines_on_invalid_utf8(pattern):
    """A line shape that takes the general fallback no longer declines on
    invalid UTF-8 (ROADMAP P4, repaired): every matcher reads the corpus as
    Go decodes it, so the device route serves it, with Go's answer (the
    Go-rule oracle of test_torch_invalid_utf8; the reference's host walk
    stops reading a line at its bad byte, F14)."""
    corpus_cache.clear()
    t = F13_CORPUS.replace(b"abc\n", b"a\xc3\n", 300) + b"ab\xc3"
    eng = ct.compile(pattern, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    assert be.plan.strategy.name == "LINE_SHAPE"
    assert be._spans_route(_arr(t))[0] == "full_scan"
    got = eng.find_all_index(t)
    assert be.host_routes == 0
    host = ct.compile(pattern, device="cpu")
    host.batch_threshold = 1 << 30
    assert (got or []) == (host.find_all_index(t) or []) == go_spans(
        pattern, t)
    # the same shape on valid UTF-8 keeps its device route
    v = t.replace(b"\xc3", "é".encode())
    assert be._spans_route(_arr(v)) is not None


@pytest.mark.parametrize("pattern,text,route", [
    ("aa", b"a" * 3001, "literal"),
    ("aaa|aa", b"a" * 3001, "literal"),
    (".*aa", (b"a" * 300 + b"\n") * 9, "line"),
    ("aa.*", (b"a" * 300 + b"\n") * 9, "line"),
    (r"\w\B", b"ab" * 1500, "full_scan"),
    (r"\d+\.\d+\.\d+\.\d+", CORPUS, "bidi")],
    ids=["aa", "aaa|aa", "bol_to_last", "first_to_eol", "general", "bidi"])
def test_chain_piece_bounds_selections_within_the_span_limit(pattern, text,
                                                             route):
    """A selection that holds about 30 bytes a candidate takes pieces of
    CHAIN_PIECE candidates even where the result fits one compaction
    (MAX_DEVICE_SPANS left at 2^30), so its peak stays bounded."""
    corpus_cache.clear()
    eng = ct.compile(pattern, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    be.CHAIN_PIECE = 16
    assert be._spans_route(_arr(text))[0] == route
    assert eng.find_all_index(text) == ref_spans(pattern, text)
    assert be.pieces[0] >= 2 and be.host_routes == 0
