"""coregex_tpu_torch's own copy of the host compile pipeline gives the JAX
package's results: the same strategy plan (strategy, reason and every
field of the plan, ASTs included) and the same count-transducer and dense
DFA tables, for the bench patterns, the nullable routes of
tests/test_nullable_spans.py and the bidirectional patterns of
tests/test_torch_engine.py (plans also for the BITSET_NFA tier's
patterns), and the general find_all's automata for its patterns, the
leftmost-longest ones' too.  Every
field is compared exactly.  Also pins
that the copy builds its own native library and keeps its own artifact
cache keys."""

import dataclasses
import enum
import os

import numpy as np
import pytest

from coregex_tpu.dfa import countdfa as ref_cd
from coregex_tpu.dfa import determinize as ref_det
from coregex_tpu.meta import strategy as ref_strategy
from coregex_tpu.nfa import thompson as ref_thompson
from coregex_tpu.syntax import parser as ref_parser
from coregex_tpu.utils import artifact_cache as ref_cache
from coregex_tpu_torch import native
from coregex_tpu_torch.dfa import countdfa as cd
from coregex_tpu_torch.dfa import determinize as det
from coregex_tpu_torch.meta import strategy
from coregex_tpu_torch.nfa import thompson
from coregex_tpu_torch.syntax import parser
from coregex_tpu_torch.utils import artifact_cache

from test_nullable_spans import ROUTES
from test_torch_engine import BENCH, BIDI

PATTERNS = list(dict.fromkeys(BENCH + [p for p, _ in ROUTES] + BIDI))
# plans of the BITSET_NFA tier's patterns (their forward DFAs overflow)
BITSET = [r"[a-q][^u-z]{13}x", r"[A-Za-z]\w{0,30}\d{2}\b",
          r"[A-Za-z]\w{0,30}\d{2}", r"(a|b)*a(a|b){15}",
          r"\d[^\n]{16}ERROR"]


def _same(a, b, where="") -> None:
    """Structural equality across the two packages' classes."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert isinstance(b, enum.Enum) and a.name == b.name, where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("pattern", PATTERNS + BITSET)
def test_plan_matches_reference(pattern):
    ast = parser.parse(pattern).ast
    ref_ast = ref_parser.parse(pattern).ast
    _same(ast, ref_ast, "ast")
    for dfas_ok in (True, False):
        plan = strategy.select(ast, dfas_ok)
        ref_plan = ref_strategy.select(ref_ast, dfas_ok)
        assert plan.strategy.value == ref_plan.strategy.value
        assert plan.reason == ref_plan.reason
        _same(plan, ref_plan, "plan")


def _tables(mods, pattern, nullable):
    """(forward DenseDFA, reverse anchored DenseDFA, count transducer) of
    one package, or None where a DFA overflows."""
    parse, thomp, deter, cdm = mods
    parsed = parse.parse(pattern)
    out = []
    try:
        nfa = thomp.compile_nfa(parsed, with_captures=False)
        out.append(deter.determinize(nfa, anchored=False,
                                     break_at_match=True))
        rnfa = thomp.compile_nfa(parsed, reverse=True)
        out.append(deter.determinize(rnfa, anchored=True,
                                     break_at_match=False, reverse=True))
        if nullable:
            u = deter.determinize_py(nfa, anchored=False,
                                     break_at_match=True, track_empty=True)
            out.append(cdm.build_count_dfa_nullable(u))
        else:
            out.append(cdm.build_count_dfa(out[0]))
    except deter.DFAOverflow:
        out.append(None)
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_match_reference(pattern):
    nullable = strategy.select(parser.parse(pattern).ast, True).nullable
    got = _tables((parser, thompson, det, cd), pattern, nullable)
    exp = _tables((ref_parser, ref_thompson, ref_det, ref_cd), pattern,
                  nullable)
    assert len(got) == len(exp) >= 3 or got[-1] is exp[-1] is None
    for g, e in zip(got, exp):
        _same(g, e, pattern)


# the general find_all's patterns: looks, {m,k} class runs, ALL_EMPTY, the
# nullable patterns whose cores take those routes, BITSET_NFA
FULL_SCAN = [r"\b\d+\b", r"a\b", r"\s\d+\s", r"(\w+\s+){3}\d",
             r"\berror\b", r"\w+@\w+\.com\b", r"\d{3}", r"[a-z]{2,5}",
             r"x*?", r"(|a)", r"(\bfoo)?", r"a{0,3}", r"[a-q][^u-z]{13}x"]


@pytest.mark.parametrize("pattern", FULL_SCAN)
def test_full_scan_tables_match_reference(pattern):
    """The general find_all's two automata, the unanchored reverse DFA
    (``rev_all``) and the anchored break-at-match forward DFA
    (``fwd_anch_break``), equal the reference BatchEngine's tables of the
    same kinds."""
    import coregex_tpu as ref_ct
    import coregex_tpu_torch as ct
    be = ct.compile(pattern, device="cpu").batch_engine()
    ref_be = ref_ct.compile(pattern).batch_engine()
    for kind in ("rev_all", "fwd_anch_break"):
        ref_be._dense(kind)
        _same(be._dense(kind), ref_be._host_dense[kind], f"{pattern} {kind}")


# the leftmost-longest routes' patterns (tests/test_torch_posix.py's chip
# run patterns and lazy ones)
POSIX = [r"\b\d+\b", r"\d+?\.\d+?\.\d+?\.\d+?", r"a.*?b",
         r"[\w.+-]+@[\w.-]+\.[\w.-]+", r"[a-q][^u-z]{13}x",
         r"err|error|errors", r"([a-z]{2,3})+", r"[a-z]+?", r"\d+?",
         r"[a-z]{2,3}?"]


@pytest.mark.parametrize("pattern", POSIX)
def test_posix_tables_match_reference(pattern):
    """A leftmost-longest engine's plan (literal sets sorted longest
    first), its verify kind and its tables (``rev_all`` and the anchored
    all-matches DFA ``fwd_anch_all``) equal the reference POSIX
    BatchEngine's."""
    import coregex_tpu as ref_ct
    import coregex_tpu_torch as ct
    be = ct.compile_posix(pattern, device="cpu").batch_engine()
    ref_be = ref_ct.compile_posix(pattern).batch_engine()
    _same(be.plan, ref_be.plan, pattern)
    assert be._verify_kind() == ref_be._verify_kind() == "fwd_anch_all"
    for kind in ("rev_all", "fwd_anch_all"):
        ref_be._dense(kind)
        _same(be._dense(kind), ref_be._host_dense[kind], f"{pattern} {kind}")


# the capture slice's patterns (the OnePass walk) and one that is not
# one-pass
ONEPASS = [r"(\d+)\.(\d+)\.(\d+)\.(\d+)", r"([a-z]+)=(\d+)",
           r"(\d+)-(\w+)", r"(\d+)\.(\d+)", r"(\w+)(@\w+)?", r"(a)(b)?c",
           r"(a)|(a)b"]


@pytest.mark.parametrize("pattern", ONEPASS)
def test_onepass_tables_match_reference(pattern):
    """build_onepass gives the reference's OnePass tables (delta, slot
    masks, match conditions and slots, classes), or rejects the same
    patterns."""
    from coregex_tpu.dfa import onepass as ref_onepass
    from coregex_tpu_torch.dfa import onepass
    out = []
    for mod, prs, th in ((onepass, parser, thompson),
                         (ref_onepass, ref_parser, ref_thompson)):
        nfa = th.compile_nfa(prs.parse(pattern), with_captures=True)
        try:
            out.append(mod.build_onepass(nfa))
        except mod.NotOnePass as ex:
            out.append(str(ex))
    _same(out[0], out[1], pattern)
    assert isinstance(out[0], str) == (pattern == r"(a)|(a)b")


def test_native_library_is_the_ports_own():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain: the Python determinizer serves")
    pkg = os.path.dirname(native.__file__)
    assert os.path.dirname(lib._name) == os.path.join(pkg, "_build")


def test_artifact_cache_keys_are_namespaced(tmp_path):
    parsed = parser.parse(r"\d+x")
    nfa = thompson.compile_nfa(parsed, with_captures=False)
    dfa = det.determinize(nfa, anchored=False, break_at_match=True)
    artifact_cache.save_dense(r"\d+x", "fwd:False", dfa, str(tmp_path))
    assert ref_cache.load_dense(r"\d+x", "fwd:False", str(tmp_path)) is None
    back = artifact_cache.load_dense(r"\d+x", "fwd:False", str(tmp_path))
    np.testing.assert_array_equal(back.delta, dfa.delta)


# a literal U+FFFD: the port compiles it as the class [\x{FFFD}], which
# matches each invalid byte (Go compares decoded runes), and keeps such a
# class out of literal sets; the reference compiles the three bytes EF BF
# BD.  (pattern, its class form)
FFFD = [(r"\x{FFFD}", r"[\x{FFFD}]"), (r"a\x{FFFD}b", r"a[\x{FFFD}]b"),
        ("�+", "[�]+")]


@pytest.mark.parametrize("pattern,as_class", FFFD,
                         ids=["lone", "inside", "plus"])
def test_literal_fffd_differs_from_reference(pattern, as_class):
    """The pinned differences: the port's AST is the reference's AST of
    the class form, and the port plans no literal or prefix set where the
    reference does (LITERAL, PREFIX_SET); patterns without U+FFFD plan
    alike (test_plan_matches_reference)."""
    ast = parser.parse(pattern).ast
    _same(ast, ref_parser.parse(as_class).ast, "ast")
    assert ref_parser.parse(pattern).ast != ref_parser.parse(as_class).ast
    got = strategy.select(ast, True).strategy.value
    exp = ref_strategy.select(ref_parser.parse(pattern).ast, True)
    assert got == "full_scan"
    assert exp.strategy.value in ("literal", "prefix_set")
