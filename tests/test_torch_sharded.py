"""coregex_tpu_torch's multi-device layer (parallel/shard.py,
parallel/sharded_count.py and the Engine's hooks) against the JAX
package's on the CPU, case by case after its tests/test_sharded.py.

The reference runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port on virtual meshes of 8, 1 and 3 CPU devices (``Mesh(["cpu"] *
D)``).  Inputs are seeded numpy corpora fed to both; outputs are integers
and masks, compared for equality.  The Engine's hooks are reached by
replacing ``parallel.shard.default_mesh`` with a virtual mesh, as on one
card, where the visible mesh holds one device and the hooks stay off.
"""

import re

import jax
import numpy as np
import pytest
import torch

from coregex_tpu.dfa.countdfa import build_count_dfa as ref_build_count
from coregex_tpu.dfa.determinize import determinize as ref_determinize
from coregex_tpu.meta.engine import Engine as RefEngine
from coregex_tpu.nfa.thompson import compile_nfa as ref_compile_nfa
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.parallel import shard as ref_shard
from coregex_tpu.parallel import sharded_count as ref_sc
from coregex_tpu.syntax.parser import parse as ref_parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.dfa.countdfa import CountDFA, build_count_dfa
from coregex_tpu_torch.dfa.determinize import determinize
from coregex_tpu_torch.nfa.thompson import compile_nfa
from coregex_tpu_torch.ops.dfa_scan import DFATables
from coregex_tpu_torch.parallel import shard, sharded_count
from coregex_tpu_torch.syntax.parser import parse

torch.set_num_threads(1)

MESHES = (8, 1, 3)
COUNT_PATTERNS = [r"abc", r"\d+\.\d+", r"\bfoo\b", r"(?m)^x.*"]
N = 16_368     # divisible by 8 and by 3


def _mesh(D):
    return shard.Mesh(["cpu"] * D)


def _fwd_all(pattern):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    return determinize(nfa, anchored=False, break_at_match=False)


def _ref_fwd_all(pattern):
    nfa = ref_compile_nfa(ref_parse(pattern), with_captures=False)
    return ref_determinize(nfa, anchored=False, break_at_match=False)


def _cds(pattern):
    """(reference CountDFA, port CountDFA) of a pattern."""
    ref = ref_build_count(ref_determinize(
        ref_compile_nfa(ref_parse(pattern), with_captures=False),
        anchored=False, break_at_match=True))
    port = build_count_dfa(determinize(
        compile_nfa(parse(pattern), with_captures=False), anchored=False,
        break_at_match=True))
    return ref, port


def _text(seed, alphabet, n):
    rng = np.random.default_rng(seed)
    return rng.choice(list(alphabet), size=n).astype(np.uint8)


@pytest.mark.parametrize("pattern", COUNT_PATTERNS)
def test_sharded_count_matches_reference(pattern):
    assert len(jax.devices()) == 8
    text = _text(1, b"abc foo 12.5\nx9 ", N)
    ref = int(ref_shard.make_sharded_count(
        ref_shard.default_mesh(), DeviceDFA.from_dense(
            _ref_fwd_all(pattern)))(text))
    dense = _fwd_all(pattern)
    assert ref == int(dense.scan_all_ends(text).sum())
    t = DFATables.from_dense(dense)
    for D in MESHES:
        assert shard.make_sharded_count(_mesh(D), t)(text) == ref, D
    vec = shard.make_sharded_count(_mesh(8), t, vector_out=True)(text)
    assert vec.tolist() == [ref] * 8


def test_sharded_flags_exact():
    text = _text(2, b"ab 12.5 cd\n", 8_184)
    ref = np.asarray(jax.device_get(ref_shard.make_sharded_flags(
        ref_shard.default_mesh(), DeviceDFA.from_dense(
            _ref_fwd_all(r"\d+\.\d+")))(text)))
    dense = _fwd_all(r"\d+\.\d+")
    assert np.array_equal(ref, dense.scan_all_ends(text)[:-1])
    t = DFATables.from_dense(dense)
    for D in MESHES:
        got = shard.make_sharded_flags(_mesh(D), t)(text)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)


def test_sharded_ends_with_an_overflowing_shard():
    """Per-shard compaction into cap slots: global positions padded with
    D*m and full counts, one shard over cap (its first cap ends kept), as
    the reference's; cap = 64 here."""
    text = np.frombuffer((b"x" * 1000 + b" 1.2 3.4" * 200 + b"y" * 1400)
                         [:4096], dtype=np.uint8).copy()
    cap = 64
    rpos, rcnt = (np.asarray(x) for x in jax.device_get(
        ref_shard.make_sharded_ends(
            ref_shard.default_mesh(),
            DeviceDFA.from_dense(_ref_fwd_all(r"\d+\.\d+")), cap)(text)))
    assert (rcnt > cap).any() and (rcnt <= cap).any()
    t = DFATables.from_dense(_fwd_all(r"\d+\.\d+"))
    pos, cnt = shard.make_sharded_ends(_mesh(8), t, cap)(text)
    assert pos.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), rpos)
    np.testing.assert_array_equal(cnt.numpy(), rcnt)
    # every mesh finds the same ends where nothing overflows
    exp = np.flatnonzero(_fwd_all(r"\d+\.\d+").scan_all_ends(text)[:-1])
    for D in (1, 3):
        n = len(text) // D * D
        pos, cnt = shard.make_sharded_ends(_mesh(D), t, 4096)(text[:n])
        got = pos[pos < n].numpy()
        np.testing.assert_array_equal(got, exp[exp < n])
        assert int(cnt.sum()) == len(got)


TAIL_TEXTS = (b"", b"ab", b"abbb xx ab a abb" * 37 + b"ab", b"x" * 8 + b"abb",
              b"abab ab")


@pytest.mark.parametrize("D", MESHES)
def test_sharded_go_count_tail_and_empty(D):
    """ShardedGoCount on b"", b"ab" and n < D (the host scan), tails of
    fewer bytes than shards, against the reference's ShardedGoCount and
    its host engine."""
    ref_cd, cd = _cds(r"ab+")
    ref = ref_sc.ShardedGoCount(ref_cd, ref_shard.default_mesh())
    shc = sharded_count.ShardedGoCount(cd, _mesh(D))
    host = RefEngine.compile(r"ab+")
    host.batch_threshold = 1 << 60
    for text in TAIL_TEXTS:
        arr = np.frombuffer(text, np.uint8)
        want = host.count(text)
        assert ref.count(arr) == want
        assert shc.count(arr) == want, (D, text[:20])
        assert shc.count(torch.from_numpy(arr.copy())) == want


def test_phase1_state_gate():
    S = 600
    cd = CountDFA(delta=np.zeros((S, 2), dtype=np.int32),
                  emit=np.zeros((S, 2), dtype=np.int16),
                  eoi_commits=np.zeros((S, 4), dtype=np.int16),
                  starts=np.zeros(4, dtype=np.int32),
                  classes=np.zeros(256, dtype=np.int32))
    assert sharded_count.PHASE1_STATE_LIMIT == ref_sc.PHASE1_STATE_LIMIT
    with pytest.raises(sharded_count.Phase1TooWide):
        sharded_count.ShardedGoCount(cd, _mesh(8))
    sharded_count.ShardedGoCount(cd, _mesh(8), state_limit=S)


def test_phase_probe_count():
    """The probe's count of the cut region (no EOI commit, no host tail),
    and its three phases, as the reference's probe gives them."""
    ref_cd, cd = _cds(r"ab+c")
    # 8208 bytes: whole shards of 8 and of 3, ending where no match is open
    data = np.frombuffer(b"xx abc abbbc zabc " * 456, dtype=np.uint8)
    rm = ref_sc.ShardedPhaseProbe(ref_cd, ref_shard.default_mesh()).measure(
        data, reps=1)
    for D in (8, 3):
        m = sharded_count.ShardedPhaseProbe(cd, _mesh(D)).measure(data,
                                                                  reps=1)
        assert m["count"] == cd.count_scan(data)
        assert set(m) >= {"phase1_scan", "collective", "phase2_fold"}
        assert all(m[k] >= 0 for k in ("phase1_scan", "collective",
                                       "phase2_fold"))
        if D == 8:
            assert m["count"] == rm["count"]


def test_sharded_multi_count_three_patterns():
    pats = [r"\d+\.\d+", r"abc", r"(?m)^x.*"]
    text = _text(5, b"abc foo 12.5\nx9 ", N)
    ref_dd = [DeviceDFA.from_dense(_ref_fwd_all(p)) for p in pats]
    stacked = ref_shard.pad_and_stack(ref_dd)
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(8, 1),
                             ("data", "pattern"))
    ref = np.asarray(ref_shard.make_sharded_multi_count(
        mesh, stacked, max(d.num_states for d in ref_dd))(text))
    tables = [DFATables.from_dense(_fwd_all(p)) for p in pats]
    st = shard.pad_and_stack(tables)
    assert st[0].shape[0] == 3
    for D in MESHES:
        got = shard.make_sharded_multi_count(
            _mesh(D), st, max(t.packed.shape[0] for t in tables))(text)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture
def virtual_mesh(monkeypatch):
    """default_mesh answers a virtual mesh of D CPU devices."""
    def use(D):
        monkeypatch.setattr(shard, "default_mesh",
                            lambda n_devices=None, device=None,
                            axis="data": shard.Mesh([device] * D, axis))
    return use


@pytest.mark.parametrize("D", (8, 3))
def test_engine_count_through_the_hook(virtual_mesh, D):
    virtual_mesh(D)
    text = (b"a1.2.3b 10.0.0.1 v9.9.9 xx 1.2 " * 257)[:-5]
    host = RefEngine.compile(r"\d+\.\d+\.\d+")
    host.batch_threshold = 1 << 60
    want = host.count(text)
    assert want == len(re.findall(rb"\d+\.\d+\.\d+", text))
    eng = ct.compile(r"\d+\.\d+\.\d+", device="cpu")
    eng.batch_threshold = 0
    assert eng.count(text) == want
    be = eng.batch_engine()
    assert be._sharded_counter(), \
        "a multi-device mesh must activate the sharded counter"
    # a nullable plan inside its transducer's gate takes the hook too
    eng = ct.compile(r"\w*", device="cpu")
    eng.batch_threshold = 0
    host = RefEngine.compile(r"\w*")
    host.batch_threshold = 1 << 60
    assert eng.count(text) == host.count(text)
    assert eng.batch_engine()._sharded_counter()


def test_hooks_stay_off_on_one_device():
    eng = ct.compile(r"\d+", device="cpu")
    be = eng.batch_engine()
    assert be._mesh() is None and be._sharded_counter() is False
    assert shard.default_mesh(device="cpu").size == 1


@pytest.mark.parametrize("D", (8, 3))
def test_engine_find_all_sharded_starts(virtual_mesh, D):
    """find_all's start discovery runs sharded (make_sharded_ends over the
    flipped corpus) and the spans equal re's and the reference Engine's
    host loop."""
    virtual_mesh(D)
    rng = np.random.default_rng(4)
    corpus = (b" ".join(
        [b"aa@bb", b"3.14", b"xy", b"zz@q", b"9.9.9",
         bytes(rng.choice(list(b"abc @.123"), size=20))]) + b"\n") * 1500
    corpus = b"3.1 aa@b " + corpus
    arr = np.frombuffer(corpus, np.uint8)
    assert len(arr) >= 1 << 16
    for pat in [r"[a-z]+@[a-z]+", r"\d+\.\d+"]:
        e = ct.compile(pat, device="cpu")
        e.batch_threshold = 0
        be = e.batch_engine()
        route = be._full_scan_route()
        assert route is not None, pat
        st = be._sharded_starts(route[0], arr)
        assert st is not None, "sharded start discovery must be active"
        spans, cnt, _ = be._full_scan_spans_dev(*route, arr)
        got = [tuple(x) for x in spans[:cnt].tolist()]
        exp = [m.span() for m in re.finditer(pat.encode(), corpus)]
        host = RefEngine.compile(pat)
        host.batch_threshold = 1 << 60
        assert len(exp) > 0 and got == exp == host.find_all_index(corpus)
        assert e.find_all_index(corpus) == exp
        assert be.host_routes == 0
    # below 2^16 bytes, the hook declines to the single-device scan
    assert be._sharded_starts(route[0], arr[:1 << 15]) is None
