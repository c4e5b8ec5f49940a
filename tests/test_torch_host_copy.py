"""coregex_tpu_torch's own copy of the host compile pipeline gives the JAX
package's results: the same strategy plan (strategy, reason and every
field of the plan, ASTs included) and the same count-transducer and dense
DFA tables, for the bench patterns, the nullable routes of
tests/test_nullable_spans.py and the bidirectional patterns of
tests/test_torch_engine.py.  Every field is compared exactly.  Also pins
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


@pytest.mark.parametrize("pattern", PATTERNS)
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
