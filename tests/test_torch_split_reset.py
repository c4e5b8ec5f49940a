"""The reset scan's split walk (``count_scan`` in ``MODE_RESET``, the plain
version of ``csrc/lane_scan.cu``'s ``cgx_lane_reset``) against one walk
of its sub-lanes in order and against the JAX package's ``ResetScanner``.

``dfa_scan.ResetScanner`` walks k sub-lanes a lane, each entering DEAD
after a warmup, and repairs them through ``count_scan.split_fixpoint``.
Here the plain walk runs at k = 1, 2, 4 and 8 on 16 lanes of 1 and 4 KiB
(a 16-byte warmup), on random DFAs and corpora made from numpy seeds:
resets on a sub-lane's first byte, inside its warmup and at position 0;
runs that never die, so that sub-lane and lane passes run; four distinct
start states; 32-column tables.  Each sub-lane's entry, exit and
interference count must equal a walk of the corpus in order, the flags
every position's, and the flags, interference and state at n the
reference's walk of the corpus as one lane (impl="gather").  Every output
is a state, a count or a flag word: exact equality.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.dense import DenseDFA as RefDense
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.ops.dfa_scan import ResetScanner as RefResetScanner

import coregex_tpu_torch as ct
from coregex_tpu_torch.dfa.dense import DEAD, DenseDFA
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import dfa_scan
from coregex_tpu_torch.ops.dfa_scan import ResetScanner
from coregex_tpu_torch.ops.span_scan import to_global

torch.set_num_threads(1)

SPLITS = [1, 2, 4, 8]
GEOMS = {1: (16, 1024, 16), 4: (16, 4096, 16)}   # KiB a lane -> (L, T, W)
KINDS = ["seams", "runs", "starts", "columns_32"]


def _dfa(seed: int, S: int, C: int, live: bool):
    """The same random anchored DFA for both packages: S states (DEAD row
    0), C byte segments, four distinct start states; live: no live state
    ever dies, so a run lasts until the next reset."""
    rng = np.random.default_rng(seed)
    bounds = np.sort(rng.choice(np.arange(1, 256), C - 1, replace=False))
    classes = np.searchsorted(bounds, np.arange(256),
                              side="right").astype(np.int32)
    delta = rng.integers(1 if live else 0, S, (S, C)).astype(np.int32)
    delta[0] = 0
    match = rng.random((S, C)) < 0.2
    match[0] = False
    eoi = rng.random((S, 4)) < 0.3
    eoi[0] = False
    kw = dict(delta=delta, match_on=match, match_eoi=eoi,
              starts=rng.choice(np.arange(1, S), 4,
                                replace=False).astype(np.int32),
              classes=classes, anchored=True, break_at_match=False)
    return RefDense(**kw), DenseDFA(**{k: (v.copy() if isinstance(
        v, np.ndarray) else v) for k, v in kw.items()})


@functools.lru_cache(maxsize=None)
def _input(kind: str, kib: int):
    """(ref DFA, port DFA, data, reset mask) of a kind under GEOMS[kib];
    the corpus ends 40 bytes into the last lane's last sub-lane."""
    L, T, W = GEOMS[kib]
    n = L * T - 40
    seed = 1000 * kib + KINDS.index(kind)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n).astype(np.uint8)
    if kind == "seams":
        # a reset on every sub-lane's first byte at k = 8 (so at every
        # k), one inside each warmup, and one at position 0 (the start of
        # text's start state)
        rd, pd = _dfa(seed, 9, 6, live=False)
        mask = np.zeros(n, bool)
        Tk = T // max(SPLITS)
        mask[Tk::2 * Tk] = True
        mask[2 * Tk - W // 2::2 * Tk] = True
        mask[0] = True
    elif kind == "runs":
        # runs outlive several sub-lanes: a reset every 700 bytes or so
        rd, pd = _dfa(seed, 12, 8, live=True)
        mask = rng.random(n) < 1 / 700
    elif kind == "starts":
        # every context before a reset: words, newlines, other bytes
        rd, pd = _dfa(seed, 16, 8, live=False)
        data[rng.random(n) < 0.1] = 10
        mask = rng.random(n) < 0.02
    else:
        rd, pd = _dfa(seed, 12, 32, live=False)
        mask = rng.random(n) < 0.05
    return rd, pd, data, mask


def _in_order(sc: ResetScanner, packed: np.ndarray, n: int, Tk: int):
    """One walk of the corpus's sub-lanes of Tk bytes in order, from DEAD:
    (flags [n], entries, exits and interference counts of each sub-lane
    that holds a byte, in corpus order)."""
    tbl = sc.walk.packed.numpy().tolist()
    starts = sc.walk.segmap.numpy().tolist()
    flags = np.zeros(n, bool)
    s = DEAD
    entries, exits, hits = [], [], []
    for p in range(n):
        if p % Tk == 0:
            entries.append(s)
            hits.append(0)
        x = int(packed[p])
        if x & 1:
            hits[-1] += s != DEAD
            s = starts[(x >> 1) & 3]
        v = tbl[s][x >> 3]
        flags[p] = v & 1
        s = v >> 5
        if p % Tk == Tk - 1 or p == n - 1:
            exits.append(s)
    return flags, entries, exits, hits


@functools.lru_cache(maxsize=None)
def _ref_one_lane(kind: str, kib: int):
    """The reference's ResetScanner walking the corpus as one lane with no
    warmup (exact, no repair): (flags [n], interfered, state at n)."""
    rd, _pd, data, mask = _input(kind, kib)
    ref = RefResetScanner(DeviceDFA.from_dense(rd), impl="gather")
    jd, jm = jnp.asarray(data), jnp.asarray(mask)
    fl, ex, cv, inf = ref._scan_one(jd, ref._aux(jd, jm), jnp.int32(DEAD),
                                    1, len(data), 0)
    assert bool(cv)
    return np.asarray(fl)[0], bool(inf), int(ex[0])


def _split(sc, packed, n, geom, k, max_repair):
    """split_fixpoint in MODE_RESET over k sub-lanes a lane: (outputs,
    converged, sub-lane passes, lane passes)."""
    L, T, W = geom
    tiles = cs.make_word_tiles(packed, L, T // 4)
    e0 = torch.full((k, L), DEAD, dtype=torch.int32)
    o0 = torch.zeros(L, dtype=torch.int32)
    o0[0] = W
    lim = (n - torch.arange(L) * T).clamp(0, T).to(torch.int32)
    c = dfa_scan.RESET_KERNEL
    before = (c.sub_passes, c.lane_passes)
    out, conv = cs.split_fixpoint(cs.MODE_RESET, c, sc.walk, tiles, W, e0,
                                  o0, lim, max_repair)
    return out, conv, c.sub_passes - before[0], c.lane_passes - before[1]


def _bits(fw, n):
    w = fw.numpy().astype(np.int64) & 0xFFFFFFFF
    return ((w[:, None] >> np.arange(32)) & 1).reshape(-1)[:n].astype(bool)


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("kib", sorted(GEOMS))
@pytest.mark.parametrize("kind", KINDS)
def test_split_reset_matches_in_order_walk_and_reference(kind, kib, k):
    """The settled split walk: every real sub-lane's sync (its entry),
    exit and interference count equal a walk of the sub-lanes in order,
    every flag bit the walk's (bits from n on clear), and the flags,
    interference and state at n the reference's one-lane walk.  Runs that
    outlive several sub-lanes take sub-lane and lane passes."""
    rd, pd, data, mask = _input(kind, kib)
    L, T, W = GEOMS[kib]
    n = len(data)
    sc = ResetScanner(pd, "cpu")
    packed = sc.packed(torch.from_numpy(data), torch.from_numpy(mask))
    (cnts, exits, sync, fw, aux), conv, subs, lanes = _split(
        sc, packed, n, GEOMS[kib], k, L + cs.SUB_PASSES)
    assert conv and aux is None
    Tk = T // k
    flags, entries, ex, hits = _in_order(sc, packed.numpy(), n, Tk)
    q = len(entries)              # real sub-lanes, q = l * k + j
    order = lambda x: x.t().reshape(-1)[:q].tolist()   # noqa: E731
    assert order(sync) == entries and order(exits) == ex
    assert order(cnts) == hits and int(cnts.sum()) == sum(hits)
    g = to_global(fw, n)
    assert (_bits(g, n) == flags).all()
    assert int(g.shape[0]) == L * T // 32 and flags.any()
    assert not (_bits(fw.t().reshape(-1), L * T)[n:]).any()
    eflags, einf, estate = _ref_one_lane(kind, kib)
    assert (flags == eflags).all()
    assert (sum(hits) > 0) == einf
    assert int(cs.state_at_end(exits, n, L, T)) == estate
    if kind == "runs" and k >= 4:
        assert subs == cs.SUB_PASSES and lanes > 0
    if kind == "seams":
        assert subs + lanes <= 1


@pytest.mark.parametrize("k", [4, 8])
def test_too_few_repairs_do_not_converge(k):
    """Runs that outlive several sub-lanes need more than one repair pass:
    with max_repair = 1 the fixpoint reports converged False (the scan
    declines); with L + SUB_PASSES it settles."""
    rd, pd, data, mask = _input("runs", 1)
    L, T, W = GEOMS[1]
    sc = ResetScanner(pd, "cpu")
    packed = sc.packed(torch.from_numpy(data), torch.from_numpy(mask))
    _o, conv, _s, _l = _split(sc, packed, len(data), GEOMS[1], k, 1)
    assert conv is False
    _o, conv, _s, _l = _split(sc, packed, len(data), GEOMS[1], k,
                              L + cs.SUB_PASSES)
    assert conv


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("maps", [True, False], ids=["maps", "in_order"])
def test_lane_pass_entries_both_ways(maps, k, monkeypatch):
    """The plain lane pass finds each sub-lane's entry by composing the
    sub-lanes' exit maps under the reset step (or, past MAP_COLUMNS, by
    walking them in order): both settle where the walk in order does."""
    if not maps:
        monkeypatch.setattr(cs, "MAP_COLUMNS", 0)
    rd, pd, data, mask = _input("runs", 4)
    L, T, W = GEOMS[4]
    n = len(data)
    sc = ResetScanner(pd, "cpu")
    packed = sc.packed(torch.from_numpy(data), torch.from_numpy(mask))
    (cnts, exits, sync, fw, _a), conv, subs, lanes = _split(
        sc, packed, n, GEOMS[4], k, L + cs.SUB_PASSES)
    flags, entries, ex, hits = _in_order(sc, packed.numpy(), n, T // k)
    q = len(entries)
    assert conv and lanes > 0
    assert exits.t().reshape(-1)[:q].tolist() == ex
    assert cnts.t().reshape(-1)[:q].tolist() == hits
    assert (_bits(to_global(fw, n), n) == flags).all()


def test_unconverged_scan_declines_the_candidate_pipeline(monkeypatch):
    """A reset scan that does not settle within max_repair passes makes
    _interleaved_ends decline (None), so the call goes to another route,
    as the reference's does; with the default 4 passes it serves."""
    pattern = r"[A-Z]+ \d+"
    text = (b"ABC 123 xyz " * 400)[:4000] + b"QQ 99"
    eng = ct.compile_posix(pattern, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    kind, sc = be._m5_route()
    got = be._candidate_spans_dev(sc, np.frombuffer(text, np.uint8))
    assert kind == "candidate" and got is not None
    assert [tuple(x) for x in got[0][:got[1]].tolist()] == [
        m.span() for m in re.finditer(pattern.encode(), text)]
    # a long run with no reset cuts across many small sub-lanes
    monkeypatch.setattr(ResetScanner, "geometry",
                        staticmethod(lambda n1: (64, 256, 16)))
    monkeypatch.setattr(sc, "max_repair", 0)
    assert be._candidate_spans_dev(sc, np.frombuffer(
        b"A" * 3000 + b" 1" + b"." * 1000, np.uint8)) is None


def test_reset_wrapper_checks():
    """The wrapper refuses what cgx_lane_reset cannot walk (more than 32
    columns, a byte map in the start states' place) before it builds or
    launches anything, and takes a table past shared memory, which the
    kernel reads from global memory."""
    T4, L, k = 64, 16, 2
    tiles = torch.zeros((T4, L), dtype=torch.int32)
    lanes = torch.zeros(L, dtype=torch.int32)
    entries = torch.zeros((k, L), dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32 columns"):
        cs.lane_walk_cuda(cs.MODE_RESET, torch.zeros((4, 33), dtype=torch.int32),
                          starts, tiles, 4, entries, lanes, lanes)
    with pytest.raises(ValueError, match=r"shape \(4,\)"):
        cs.lane_walk_cuda(cs.MODE_RESET, torch.zeros((4, 8), dtype=torch.int32),
                          torch.zeros(256, dtype=torch.int32), tiles, 4,
                          entries, lanes, lanes)
    big = torch.zeros((4096, 32), dtype=torch.int32)
    assert not cs.table_fits(4096, 32)
    cs._check_lane_args(cs.MODE_RESET, big, starts, tiles, 4, entries, lanes,
                        lanes)


def test_scanner_serves_tables_past_shared_memory():
    """ResetScanner takes an S x C table past the card's shared memory
    (the kernel reads it from global memory) and scans it as any other:
    the flags equal a walk in order."""
    rd, pd = _dfa(5, 2048, 32, live=False)
    sc = ResetScanner(pd, "cpu")
    S, C = (int(x) for x in sc.walk.packed.shape)
    assert not cs.table_fits(S, C)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 5000).astype(np.uint8)
    mask = rng.random(5000) < 0.05
    fw, conv, inf, state = sc.scan_device(torch.from_numpy(data),
                                          torch.from_numpy(mask))
    packed = sc.packed(torch.from_numpy(data), torch.from_numpy(mask))
    flags, _e, ex, hits = _in_order(sc, packed.numpy(), 5000, 5000)
    assert conv and (_bits(fw, 5000) == flags).all()
    assert inf == (sum(hits) > 0) and int(state) == ex[-1]
