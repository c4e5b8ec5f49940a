"""The candidate and INNER pipelines (ROADMAP M5) against the JAX package on
the CPU.

The reset scan's plain version (``dfa_scan.ResetScanner``, the counterpart
of ``_chunk_scan_reset``) against the reference's ``ResetScanner`` with
``impl="gather"`` on random DFAs and reset masks, at the scan's own
geometry and at a small forced one of many lanes;
K3's interference mode (``scan_words_syms``) against the reference's; the
sieve, the PREFIX_RUN candidates and bulk count, the INNER producers,
``inner_assemble`` and the Go selections against theirs; the two pipelines
(``_candidate_spans_dev``, ``_inner_spans_dev``) against the reference's on
its POSIX routes and on ``[A-Z]+ \\d+``; the Engine's find_all and count of
``compile_posix(r"[a-z]+ [^ ]{20,60}x")`` on the card's routes; and the
order of the routes behind the bidirectional path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.dfa.dense import DEAD
from coregex_tpu.dfa.dense import DenseDFA as RefDense
from coregex_tpu.meta import batch as ref_batch
from coregex_tpu.ops import flag_scan as ref_fs
from coregex_tpu.ops import sieve as ref_sieve
from coregex_tpu.ops import span_chain as ref_sc
from coregex_tpu.ops import span_kernels as ref_sk
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.ops.dfa_scan import ResetScanner as RefResetScanner

import coregex_tpu_torch as ct
from coregex_tpu_torch.dfa.dense import DenseDFA
from coregex_tpu_torch.meta.batch import BatchEngine
from coregex_tpu_torch.ops import bytescan as bs
from coregex_tpu_torch.ops.count_scan import table_fits
from coregex_tpu_torch.ops import sieve
from coregex_tpu_torch.ops import span_chain as sc
from coregex_tpu_torch.ops import span_kernels as sk
from coregex_tpu_torch.ops.dfa_scan import ResetScanner
from coregex_tpu_torch.ops.flag_scan import FlagResetScanner
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus

torch.set_num_threads(1)

CORPUS = _log_corpus(31, 30000)
# the reference's candidate (PREFIX_RUN) and INNER routes: POSIX ip,
# version, email and url, and [A-Z]+ \d+ under both rules
M5_CASES = [(r"\d+\.\d+\.\d+\.\d+", True, "candidate"),
            (r"\d+.\d+.\d+", True, "candidate"),
            (r"[\w.+-]+@[\w.-]+\.[\w.-]+", True, "inner"),
            (r"\w+://[^\s]+", True, "inner"),
            (r"[A-Z]+ \d+", True, "candidate"),
            (r"[A-Z]+ \d+", False, "candidate"),
            (r"[a-z]+ error [^ ]{8,30}[a-z]", True, "inner")]
M5_IDS = ["ip", "version", "email", "url", "upper_digits",
          "upper_digits_lf", "inner_gap"]


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _eq(got, exp):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(exp))


def _rand_dfa(rng, S: int, nb: int):
    """The same random anchored DFA for both packages: S states (DEAD row
    0), nb + 1 byte segments."""
    bounds = np.sort(rng.choice(np.arange(1, 256), nb, replace=False))
    classes = np.searchsorted(bounds, np.arange(256),
                              side="right").astype(np.int32)
    delta = rng.integers(0, S, (S, nb + 1)).astype(np.int32)
    delta[0] = 0
    match = rng.random((S, nb + 1)) < 0.2
    match[0] = False
    eoi = rng.random((S, 4)) < 0.3
    eoi[0] = False
    kw = dict(delta=delta, match_on=match, match_eoi=eoi,
              starts=rng.integers(1, S, 4).astype(np.int32),
              classes=classes, anchored=True, break_at_match=False)
    return RefDense(**kw), DenseDFA(**{k: (v.copy() if isinstance(
        v, np.ndarray) else v) for k, v in kw.items()})


def _unpack(fw, T: int):
    w = fw.numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (w[:, :, None] >> np.arange(32)) & 1
    return bits.reshape(fw.shape[0], -1)[:, :T].astype(bool)


def _ref_reset(rd, data, mask):
    """The reference's ResetScanner (impl="gather") on data: its scan at
    its own geometry, (flags [n], converged, interfered), and its walk of
    the corpus as one lane with no warmup, which needs no repair: (flags
    [n], interfered, the state after the corpus)."""
    ref = RefResetScanner(DeviceDFA.from_dense(rd), impl="gather")
    jd, jm = jnp.asarray(data), jnp.asarray(mask)
    n = len(data)
    rf, _rex, rcv, rinf, _g = ref.scan_device(jd, jm)
    ef, eex, ecv, einf = ref._scan_one(jd, ref._aux(jd, jm),
                                       jnp.int32(DEAD), 1, n, 0)
    assert bool(ecv)
    return ((np.asarray(rf).reshape(-1)[:n], bool(rcv), bool(rinf)),
            (np.asarray(ef)[0], bool(einf), int(eex[0])))


@pytest.mark.parametrize("S,nb,n,dens,geom", [
    (3, 2, 100, 0.1, None), (9, 7, 3000, 0.02, None),
    (40, 20, 20000, 0.005, None), (12, 31, 9000, 0.3, None),
    (20, 9, 9000, 0.01, (64, 256, 16))],
    ids=["one_lane", "sparse", "wide", "dense_32_columns", "many_lanes"])
def test_reset_scan_plain_matches_reference(monkeypatch, S, nb, n, dens,
                                            geom):
    """Every flag bit, interfered and the state at n equal the reference's
    ResetScanner (impl="gather"), and the scan converges wherever the
    reference's does.  The port's lanes and exits are no longer the
    reference's: it walks plan_geometry's lanes, split into lane_split's
    sub-lanes and repaired by split_fixpoint, in one pass over the corpus
    where the reference takes 1024-byte lanes a 2^29-byte segment at a
    time.  So the flags, interference and state are held to the
    reference's walk of the corpus as one lane, which is exact, and to its
    own scan where that converges; `geom` forces a small geometry of
    many lanes and sub-lanes (64 lanes of 256 bytes, a 16-byte warmup, 4
    sub-lanes a lane)."""
    rng = np.random.default_rng(S * 1000 + n)
    rd, pd = _rand_dfa(rng, S, nb)
    data = rng.integers(0, 256, n).astype(np.uint8)
    mask = rng.random(n) < dens
    if geom:
        monkeypatch.setattr(ResetScanner, "geometry",
                            staticmethod(lambda n1: geom))
    (rf, rcv, rinf), (ef, einf, estate) = _ref_reset(rd, data, mask)
    fw, cv, inf, state = ResetScanner(pd, "cpu").scan_device(_t(data),
                                                            _t(mask))
    bits = _unpack(fw.reshape(1, -1), n)[0]
    _eq(bits, ef)
    assert inf == einf and int(state) == estate
    assert cv or not rcv
    if rcv:
        _eq(bits, rf)
        assert inf == rinf


def test_reset_scan_gate():
    """More than 32 table columns raise ValueError (the route declines)."""
    rng = np.random.default_rng(3)
    _rd, pd = _rand_dfa(rng, 5, 40)
    with pytest.raises(ValueError, match="C <= 32"):
        ResetScanner(pd, "cpu")


def _engines(pattern, posix):
    eng = (ct.compile_posix if posix else ct.compile)(pattern, device="cpu")
    eng.batch_threshold = 0
    ref = (ref_ct.compile_posix if posix else ref_ct.compile)(pattern)
    return eng, eng.batch_engine(), ref.batch_engine()


@pytest.mark.parametrize("pattern", [r"\d+\.\d+\.\d+\.\d+", r"[A-Z]+ \d+",
                                     r"[a-z]+ [^ ]{20,60}x"])
def test_sieve_and_prefix_run_candidates_match_reference(pattern):
    _eng, be, rbe = _engines(pattern, True)
    assert be._sieve_ranges() == [tuple(r) for r in rbe._sieve_ranges()]
    dev = _t(_arr(CORPUS))
    for depth in range(len(be._sieve_ranges()) + 1):
        ranges = be._sieve_ranges()[:depth]
        _eq(sieve.sieve_mask(dev, ranges), ref_sieve.sieve_mask(
            jnp.asarray(_arr(CORPUS)), ranges))
    m, c = be._prefix_run_candidates_mask(dev)
    rm, rc = rbe._prefix_run_candidates_mask(jnp.asarray(_arr(CORPUS)))
    _eq(m, rm)
    assert int(c) == int(rc)


def test_bulk_count_matches_reference():
    rng = np.random.default_rng(9)
    data = _arr(CORPUS)
    n = len(data)
    table = np.zeros(256, bool)
    table[ord("0"):ord("9") + 1] = True
    starts = np.sort(rng.choice(n, 200, replace=False)).astype(np.int32)
    for lens in (rng.integers(1, 20, 200), rng.integers(1, 3, 200)):
        ends = np.where(rng.random(200) < 0.2, -1,
                        np.minimum(starts + lens, n)).astype(np.int32)
        got = bs.bulk_count(_t(starts), _t(ends), _t(data), _t(table), n)
        exp = ref_batch._bulk_count_kernel(
            jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(data),
            jnp.asarray(table), jnp.int32(n))
        assert [int(x) for x in got] == [int(x) for x in exp]


@pytest.mark.parametrize("pattern", [r"[\w.+-]+@[\w.-]+\.[\w.-]+",
                                     r"\w+://[^\s]+", r"[a-z]{2,5}=\d+",
                                     r"\d+x", r"(?:ab|cd)+@x"])
def test_class_run_prefix_matches_reference(pattern):
    eng = ct.compile(pattern, device="cpu").batch_engine()
    ref = ref_ct.compile(pattern).batch_engine()
    if eng.plan.split is None:
        assert ref.plan.split is None
        return
    sp, rsp = eng.plan.split, ref.plan.split
    got = BatchEngine._class_run_prefix(sp.prefix_ast, bytes(sp.lit))
    exp = ref_batch.BatchEngine._class_run_prefix(rsp.prefix_ast,
                                                  bytes(rsp.lit))
    assert (got is None) == (exp is None)
    if got is not None:
        _eq(got[0], exp[0])
        assert got[1:] == exp[1:]


def _inner_inputs(pattern, posix=True):
    """The port's INNER producers, and the reference's, on CORPUS."""
    _eng, be, rbe = _engines(pattern, posix)
    (table, m, M), fsc = be._inner_route()
    lit = bytes(be.plan.split.lit)
    ranges = bs.table_to_ranges(table)
    data = _arr(CORPUS)
    return be, rbe, (table, m, M), fsc, lit, ranges, data


def test_inner_producers_match_reference():
    be, rbe, (table, m, M), fsc, lit, ranges, data = _inner_inputs(
        r"[\w.+-]+@[\w.-]+\.[\w.-]+")
    dev, jdev = _t(data), jnp.asarray(data)
    bounds = fsc.byte_bounds()
    got = sc.inner_cand_symbols(dev, ranges, lit, m, bounds)
    exp = ref_sc.inner_cand_symbols(jdev, ranges, tuple(lit), m, bounds)
    for g, e in zip(got, exp):
        _eq(g, e)
    got = sc.inner_cand_arrays(dev, ranges, lit, m)
    exp = ref_sc.inner_cand_arrays(jdev, ranges, tuple(lit), m)
    for g, e in zip(got, exp):
        _eq(g, e)
    nwb1 = sc._bucket_up(-(-(len(data) + 1) // 32))
    for k in (1, 5, 31, 32, 33, 70):
        _eq(sc._shift_words(got[0], k, nwb1),
            ref_sc._shift_words(jnp.asarray(got[0].numpy()), k, nwb1))
    flag = np.random.default_rng(4).random(len(data)) < 0.05
    for g, e in zip(sc.inner_flag_arrays(_t(flag), True),
                    ref_sc.inner_flag_arrays(jnp.asarray(flag),
                                             jnp.bool_(True))):
        _eq(g, e)


def test_interference_mode_matches_reference():
    """K3 over the suffix DFA with resets at the candidates (flag_pre_reset
    False): flag words, interference count and convergence as the
    reference's scan_words_syms."""
    be, rbe, (table, m, M), fsc, lit, ranges, data = _inner_inputs(
        r"[\w.+-]+@[\w.-]+\.[\w.-]+", posix=False)
    rsc = ref_fs.FlagResetScanner(rbe._dense("fwd_suffix"),
                                  fsc_ctx := 3, impl="gather")
    port = FlagResetScanner(be._dense("fwd_suffix"), fsc_ctx, "cpu")
    syms = sc.inner_cand_symbols(_t(data), ranges, lit, m,
                                 port.byte_bounds())[3]
    rng = np.random.default_rng(2)
    for extra in (0.0, 0.02):
        s = syms.clone()
        s[:len(data)] |= _t(rng.random(len(data)) < extra).to(torch.uint8)
        fw, interf, conv, _h = port.scan_words_syms(s, len(data))
        rfw, rinterf, rconv, _rh = rsc.scan_words_syms(
            jnp.asarray(s.numpy()), len(data))
        nw = min(int(fw.shape[0]), int(rfw.shape[0]))
        _eq(fw[:nw], np.asarray(rfw)[:nw])
        assert int(interf) == int(rinterf) and conv == bool(rconv)
    assert int(interf) > 0


def test_go_selections_match_reference():
    """go_select_device (and chain_select, which the candidate pipeline
    calls for it) and go_select_flex against the reference's."""
    rng = np.random.default_rng(11)
    for trial in range(6):
        cnt = int(rng.integers(1, 300))
        cap = bs._bucket(cnt, 16)
        starts = np.sort(rng.choice(5000, cnt, replace=False)).astype(
            np.int32)
        ends = (starts + rng.integers(1, 60, cnt)).astype(np.int32)
        s = np.full(cap, 6000, np.int32)
        e = np.full(cap, 6000, np.int32)
        s[:cnt], e[:cnt] = starts, ends
        sel, ok = sk.go_select_device(_t(s), _t(e), cnt, cap)
        rsel, rok = ref_sk.go_select_device(jnp.asarray(s), jnp.asarray(e),
                                            cnt, cap)
        _eq(sel, rsel)
        assert ok == rok
        spans, total, okc = sc.chain_select(_t(s), _t(e), cnt, 6000, cap)
        idx = np.flatnonzero(np.asarray(rsel)[:cnt])
        assert bool(okc) and int(total) == len(idx)
        _eq(spans[:len(idx)], np.stack([s[idx], e[idx]], 1))
        smin = (s - rng.integers(0, 10, cap)).astype(np.int32)
        got = sk.go_select_flex(_t(smin), _t(s), _t(e), cnt, cap)
        exp = ref_sk.go_select_flex(jnp.asarray(smin), jnp.asarray(s),
                                    jnp.asarray(e), cnt, cap)
        _eq(got[0], exp[0])
        assert got[1] == exp[1]
        _eq(got[2], exp[2])
        lazy = sk.go_select_flex_lazy(_t(smin), _t(s), _t(e), cnt, cap)
        rlazy = ref_sk.go_select_flex_lazy(jnp.asarray(smin),
                                           jnp.asarray(s), jnp.asarray(e),
                                           cnt, cap)
        for g, x in zip(lazy, rlazy):
            _eq(g, x)


def test_inner_assemble_matches_reference():
    """inner_assemble on the same chained payloads as the reference's."""
    be, rbe, (table, m, M), fsc, lit, ranges, data = _inner_inputs(
        r"[\w.+-]+@[\w.-]+\.[\w.-]+")
    n, k = len(data), len(lit)
    candw, mw, lastnm_w, syms, cnt = sc.inner_cand_symbols(
        _t(data), ranges, lit, m, fsc.byte_bounds())
    cap = bs._bucket(int(cnt), 16)
    c_pos, mw_i, lastnm_i, cntA, okA = sc.sparse_chain_payloads(
        candw, [mw, lastnm_w], n, cap)
    fw, interf, conv, _h = fsc.scan_words_syms(syms, n)
    nwb1 = sc._bucket_up(-(-(n + 1) // 32))
    flagw, lastflag_w, glob = sc.inner_flag_arrays_words(fw, nwb1)
    r_pos, flagw_i, lastflag_i, cntB, okB = sc.sparse_chain_payloads(
        sc._shift_words(candw, k, nwb1), [flagw, lastflag_w], n + 1, cap)
    args = [c_pos, mw_i, lastnm_i, r_pos, flagw_i, lastflag_i, cntA, cntB,
            okA & okB, glob]
    yes = torch.ones((), dtype=torch.bool)
    no = torch.zeros((), dtype=torch.bool)
    for b_empty in (False, True):
        ends = torch.where(torch.arange(cap) < cntA, c_pos + k, 0)
        got = sc.inner_assemble(*args, yes, no, n, cap, k, m, M,
                                b_empty=b_empty, fixed_ends=ends)
        exp = ref_sc.inner_assemble(
            *[jnp.asarray(a.numpy()) for a in args], jnp.bool_(True),
            jnp.bool_(False), jnp.int32(n), cap, k, m, M, b_empty=b_empty,
            fixed_ends=jnp.asarray(ends.numpy()))
        for g, e in zip(got, exp):
            _eq(g, e)


def _spans(r):
    return [tuple(x) for x in r[0][:r[1]].tolist()]


@pytest.mark.parametrize("pattern,posix,kind", M5_CASES, ids=M5_IDS)
def test_pipelines_match_reference(pattern, posix, kind):
    """The port's _candidate_spans_dev / _inner_spans_dev against the
    reference's, and both against the reference's host walk (Go's
    answer)."""
    corpus_cache.clear()
    eng, be, rbe = _engines(pattern, posix)
    data = _arr(CORPUS)
    m5 = be._m5_route()
    assert m5 is not None and m5[0] == kind
    if kind == "inner":
        got = be._inner_spans_dev(m5[1], data)
        exp = rbe._inner_spans_dev(jnp.asarray(data), len(data))
    else:
        got = be._candidate_spans_dev(m5[1], data)
        exp = rbe._candidate_spans_dev(jnp.asarray(data), len(data))
    host = (ref_ct.compile_posix if posix else ref_ct.compile)(pattern)
    host.batch_threshold = 1 << 30
    assert _spans(got) == [tuple(x) for x in np.asarray(exp[0])[:exp[1]]] \
        == (host.find_all_index(CORPUS) or [])


def test_prefix_run_count_device_matches_reference():
    """The bulk count, or its decline (a candidate dropped by Go's
    selection, a restart inside a run: ip on this corpus) as the
    reference's."""
    got = []
    for pattern in (r"\d+\.\d+\.\d+\.\d+", r"[A-Z]+ \d+"):
        _eng, be, rbe = _engines(pattern, True)
        data = _arr(CORPUS)
        got.append(be._prefix_run_count_device(data))
        assert got[-1] == rbe._prefix_run_count_device(
            jnp.asarray(data), data, len(data))
    assert got[0] is None and got[1] is not None


def test_posix_prefix_run_served_on_the_card_routes():
    """compile_posix(r"[a-z]+ [^ ]{20,60}x"): its unanchored reverse DFA
    overflows, so the general fallback declines, and M5's candidate route
    serves find_all and count (no host loop), equal to the reference's
    host walk."""
    pattern = r"[a-z]+ [^ ]{20,60}x"
    corpus_cache.clear()
    text = CORPUS + b" abc " + b"Q" * 40 + b"x tail"
    eng, be, _rbe = _engines(pattern, True)
    host = ref_ct.compile_posix(pattern)
    host.batch_threshold = 1 << 30
    exp = host.find_all_index(text) or []
    assert be._full_scan_route() is None
    assert be._spans_route(_arr(text))[0] == "m5"
    for _ in range(2):   # the second call after the prefilter's verdict
        assert eng.find_all_index(text) == exp and len(exp) > 20
        assert be.route == "candidate"
        assert eng.count(text) == len(exp)
    assert be.host_routes == 0


def test_route_order_behind_the_bidirectional_path(monkeypatch):
    """With bidi declined, the general fallback serves where it takes the
    plan; where it declines the plan, M5 serves; M5 declining too sends
    the call to the host loop."""
    pattern = r"\d+\.\d+\.\d+\.\d+"
    text = CORPUS
    exp = ref_ct.compile(pattern).find_all_index(text)
    eng, be, _rbe = _engines(pattern, False)
    monkeypatch.setattr(be, "_bidi_route", lambda ascii_ok: None)
    assert eng.find_all_index(text) == exp and be.route == "full_scan"
    monkeypatch.setattr(be, "_full_scan_route", lambda: None)
    assert eng.find_all_index(text) == exp and be.route == "candidate"
    assert be.host_routes == 0
    monkeypatch.setattr(be, "_DEV_FILTER_LIMIT", 1)   # M5 declines
    assert eng.find_all_index(text) == exp
    assert be.host_routes == 1


def test_posix_inner_served_on_the_card_routes():
    """compile_posix(r"[a-z]+ error [^ ]{8,30}[a-z]"): the general fallback
    declines it (its reverse DFA overflows), so the public find_all and
    count take the INNER pipeline, equal to the reference's host walk.
    Its suffix table fits K3's shared memory (`{8,60}`'s does not: K3
    reads it from global memory, tests/test_torch_big_tables.py)."""
    pattern = r"[a-z]+ error [^ ]{8,30}[a-z]"
    corpus_cache.clear()
    text = CORPUS + b" abc error " + b"Q" * 20 + b"x tail"
    eng, be, _rbe = _engines(pattern, True)
    host = ref_ct.compile_posix(pattern)
    host.batch_threshold = 1 << 30
    exp = host.find_all_index(text) or []
    assert be._full_scan_route() is None and len(exp) >= 2
    t = be._inner_route()[1].tables   # K3 on the card takes this table
    assert table_fits(t.S, t.NSEG)
    assert eng.find_all_index(text) == exp and be.route == "inner"
    assert eng.count(text) == len(exp)
    assert be.host_routes == 0


def test_posix_prefix_run_bulk_count_through_count():
    """compile_posix(r"[a-z]+ [^ ]{20,60}x\\b"): no find_all route serves
    it (its reverse DFA overflows and the look keeps the candidate
    pipeline off), so Engine.count takes the bulk count, equal to the
    reference's host walk, with no host loop."""
    pattern = r"[a-z]+ [^ ]{20,60}x\b"
    corpus_cache.clear()
    text = CORPUS + b" abc " + b"Q" * 40 + b"x tail"
    eng, be, _rbe = _engines(pattern, True)
    host = ref_ct.compile_posix(pattern)
    host.batch_threshold = 1 << 30
    exp = host.find_all_index(text) or []
    assert be._spans_route(_arr(text)) is None and len(exp) > 20
    assert eng.count(text) == len(exp)
    assert be.host_routes == 0


@pytest.mark.parametrize("n,whole", [(1 << 21, 1 << 21),
                                     ((1 << 21) - 1, 1 << 21),
                                     ((3 << 21) - 1, 3 << 21)],
                         ids=["pow2", "whole_segments", "whole_lanes"])
def test_candidate_pipeline_at_whole_geometry_lengths(n, whole):
    """Lengths the lanes fill exactly (`whole` = L x T of plan_geometry):
    n itself, the corpus's own geometry (2 MiB: 8192 lanes of 256 bytes),
    and n + 1, the reset scan's (2 MiB and 6 MiB: the pad byte is the last
    position of the last lane).  The scan's pad byte still gives the flag
    at n, so the pipeline serves, equal to re's spans (the pattern's
    leftmost-first and leftmost-longest spans agree), which the
    reference's host walk gives on the first 32 KiB."""
    import re
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    pattern = r"[A-Z]+ \d+"
    L, T, _W, _Lc = plan_geometry(whole)
    assert L * T == whole
    text = (CORPUS * (n // len(CORPUS) + 1))[:n - 8] + b" ABC 123"
    assert len(text) == n
    corpus_cache.clear()
    _eng, be, _rbe = _engines(pattern, True)
    host = ref_ct.compile_posix(pattern)
    host.batch_threshold = 1 << 30
    exp = [m.span() for m in re.finditer(pattern.encode(), text)]
    head = 1 << 15
    assert (host.find_all_index(text[:head]) or []) == [
        sp for sp in exp if sp[1] <= head]
    m5 = be._m5_route()
    got = be._candidate_spans_dev(m5[1], _arr(text))
    assert got is not None
    assert _spans(got) == exp and exp[-1][1] == n


@pytest.mark.parametrize("posix", [True, False], ids=["posix", "lf"])
def test_candidate_pipeline_declines_a_restart_inside_a_run(posix):
    """A match that ends inside a class run makes Go restart there, at no
    candidate; where a match starts at that restart the candidate pipeline
    declines and the other route serves Go's answer."""
    pattern = r"[a-z]+ [a-z]"
    text = b"ab cd ef gh ij 12 " * 1500
    corpus_cache.clear()
    eng, be, _rbe = _engines(pattern, posix)
    host = (ct.compile_posix if posix else ct.compile)(pattern,
                                                      device="cpu")
    host.batch_threshold = 1 << 40
    m5 = be._m5_route()
    assert m5[0] == "candidate"
    assert be._candidate_spans_dev(m5[1], _arr(text)) is None
    assert eng.find_all_index(text) == host.find_all_index(text)
    assert be.route in ("full_scan", "bidi") and be.host_routes == 0
