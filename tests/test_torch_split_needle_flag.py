"""The sub-lane split of K6 (the literal-set hit scan, csrc/needle_scan.cu)
and of K3 (the reverse reset flag scan, csrc/lane_scan.cu), against the JAX
package's HitsScanner and flag scan on the CPU.

K6 walks k sub-lanes a lane with no fixpoint, and ``line_scan.hits_verdict``
combines its [k, L] outputs on the device; K3 walks k sub-lanes a lane
through ``count_scan.split_fixpoint``, and a hinted scan walks no warmup.
Here the plain versions run at k = 1, 2, 4, 8 and 16 on 16 lanes of 1-4 KiB
(a 16-byte warmup), on corpora made from numpy seeds, against the
reference's Pallas kernels in interpret mode, its gather path and its host
oracles.  Every output is an integer, a state or a flag word: exact
equality.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.dense import CTX_OTHER, DEAD
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import flag_scan as ref_fs
from coregex_tpu.ops import line_scan as ref_ls
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.ops.seq_scan import multi_count_host
from coregex_tpu.syntax.parser import parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import flag_scan as fs
from coregex_tpu_torch.ops import line_scan as ls

torch.set_num_threads(1)

SPLITS = [1, 2, 4, 8, 16]
GEOMS = {1: (16, 1024, 16, 2), 4: (16, 4096, 16, 2)}   # KiB a lane -> geom
ALT = [b"alpha", b"beta", b"gamma", b"delta", b"error", b"warning",
       b"GET", b"POST", b"DELETE", b"abcdefghijklm"]


def _t(arr):
    return torch.from_numpy(np.array(arr, dtype=np.uint8))


def _words_corpus(seed, n, words):
    """Needles and filler words joined by spaces, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pool = list(words) + [b"lorem", b"x", b"10.0.0.1", b"\n", b"ip"]
    out = b" ".join(pool[i] for i in rng.integers(0, len(pool), n // 3))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _placed(n, placements, fill=b"."):
    """A corpus of `fill` with each (position, bytes) written in."""
    buf = bytearray(fill * n)
    for p, w in placements:
        buf[p:p + len(w)] = w
    return np.frombuffer(bytes(buf), dtype=np.uint8)


# -- K6: the plain split against the reference ---------------------------------

def _ref_count(needles, arr, geom):
    """The reference HitsScanner's count (None on an overlap), its Pallas
    kernel in interpret mode (once per input: every split compares with
    it)."""
    return _ref_count_of(tuple(needles), arr.tobytes(), geom)


@functools.lru_cache(maxsize=None)
def _ref_count_of(needles, data, geom):
    # 8 tile rows a grid step (the reference's own knob): the interpreted
    # kernel then traces in a fraction of the time
    old = os.environ.get("COREGEX_TPU_HITS_TT4")
    os.environ["COREGEX_TPU_HITS_TT4"] = "8"
    try:
        return ref_ls.HitsScanner(list(needles), interpret=True).count(
            jnp.asarray(np.frombuffer(data, dtype=np.uint8)), geometry=geom)
    finally:
        if old is None:
            del os.environ["COREGEX_TPU_HITS_TT4"]
        else:
            os.environ["COREGEX_TPU_HITS_TT4"] = old


def _port_count(needles, arr, geom, k):
    """(count, overlap) of the plain split walk combined by hits_verdict,
    and the same through HitsScanner.count at lane_split's k."""
    sc = ls.HitsScanner(needles)
    L, T = geom[:2]
    tiles = cs.make_word_tiles(_t(arr), L, T // 4)
    total, over = ls.hits_verdict(
        T, *ls.hits_lanes(sc.tbl, sc.lens, tiles, k))
    return int(total), bool(over), sc.count(_t(arr), geom, tiles)


def _seam_corpora(geom, k):
    """Needles across a sub-lane seam, across a lane seam, an overlap
    whose reach crosses a sub-lane seam into the next one's first hit,
    and one across a lane seam (sub-lane (k-1, l) into (0, l+1))."""
    L, T = geom[:2]
    Tk = T // k
    n = L * T - 100
    across_sub = [(Tk - 2, b"delta"), (3 * Tk - 4, b"abcdefghijklm"),
                  (T + Tk - 1, b"GET")]
    across_lane = [(T - 3, b"error"), (2 * T - 1, b"POST"),
                   (5 * T - 12, b"abcdefghijklm")]
    # "deltalpha": delta's reach covers alpha's start (overlap)
    over_sub = [(2 * T + Tk - 4, b"deltalpha")]
    over_lane = [(3 * T - 2, b"betalpha")]
    return [_placed(n, across_sub), _placed(n, across_lane),
            _placed(n, over_sub), _placed(n, over_lane),
            _placed(n, across_sub + across_lane)]


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("kib", [1, 4])
def test_hits_split_matches_reference(kib, k):
    """The split plain outputs, combined, give the reference's count and
    overlap verdict (its K6 in interpret mode, on 1 KiB lanes) and,
    without an overlap, the host oracle's count: on seeded corpora and on
    needles and overlaps placed across sub-lane and lane seams."""
    geom = GEOMS[kib]
    corpora = [_words_corpus(100 * kib + s, n, ALT)
               for s, n in enumerate([700, geom[0] * geom[1] - 33])]
    corpora += _seam_corpora(geom, k) if kib == 1 else []
    for arr in corpora:
        # the words corpora hold no overlap
        exp = (_ref_count(ALT, arr, geom) if kib == 1
               else multi_count_host(arr.tobytes(), ALT))
        total, over, cnt = _port_count(ALT, arr, geom, k)
        assert over == (exp is None)
        assert cnt == exp
        if exp is not None:
            assert total == exp == multi_count_host(arr.tobytes(), ALT)


def test_seam_overlaps_are_seen_only_across_seams():
    """The placed overlaps sit across a seam at k = 16: no sub-lane sees
    both hits, so only the combine's running max finds them."""
    geom = GEOMS[1]
    L, T = geom[:2]
    sc = ls.HitsScanner(ALT)
    for arr in _seam_corpora(geom, 16)[2:4]:
        tiles = cs.make_word_tiles(_t(arr), L, T // 4)
        _c, ov, _f, _r = ls.hits_lanes(sc.tbl, sc.lens, tiles, 16)
        assert not bool(ov.any())
        assert _port_count(ALT, arr, geom, 16)[1]


@pytest.mark.parametrize("k", [1, 4, 16])
def test_overlapping_literal_falls_to_k7(k):
    r"""`0\.0` overlaps itself in 10.0.0.1: K6's verdict is an overlap at
    every split, also when the only overlap straddles a sub-lane seam, and
    the engine's count (K6, then K7's leftmost-first count) equals the
    host oracle."""
    geom = GEOMS[1]
    T = geom[1]
    arr = _placed(geom[0] * T - 64, [(T // k - 3, b"10.0.0.1")], b"x")
    assert _port_count([b"0.0"], arr, geom, k)[1]
    assert _ref_count([b"0.0"], arr, geom) is None
    text = _words_corpus(7 + k, 20000, [b"0.0", b"10.0.0.1"])
    eng = ct.compile(r"0\.0", device="cpu")
    assert eng.batch_engine()._count_route(text)[0] == "hits"
    assert eng.count(text) == multi_count_host(text.tobytes(), [b"0.0"])


def test_hits_scanner_splits_as_lane_split(monkeypatch):
    """HitsScanner.count walks lane_split(T, W) sub-lanes a lane."""
    seen = []
    real = ls.hits_lanes

    def spy(tbl, lens, tiles, k):
        seen.append(k)
        return real(tbl, lens, tiles, k)

    monkeypatch.setattr(ls, "hits_lanes", spy)
    for geom in GEOMS.values():
        arr = _words_corpus(3, 5000, ALT)
        assert ls.HitsScanner(ALT).count(_t(arr), geom) == \
            multi_count_host(arr.tobytes(), ALT)
    assert seen == [cs.lane_split(g[1], g[2]) for g in GEOMS.values()]
    assert seen == [16, 64]


# -- K6: the device combine ---------------------------------------------------

@pytest.mark.parametrize("k", SPLITS)
def test_hits_verdict_matches_cross_lane_overlap(k):
    """hits_verdict on random [k, L] outputs equals cnt.sum() and the
    plain cross_lane_overlap over the k*L sub-lanes in corpus order (or
    any sub-lane's own overlap); reaches run up to three sub-lanes past
    their own."""
    rng = np.random.default_rng(40 + k)
    for _ in range(200):
        L = int(rng.integers(1, 9))
        Tk = int(rng.integers(4, 40))
        T = Tk * k
        shape = (k, L)
        cnt = rng.integers(0, 5, shape).astype(np.int32)
        ov = (rng.random(shape) < 0.02).astype(np.int32)
        fh = np.where(rng.random(shape) < 0.6, rng.integers(0, Tk, shape),
                      ls.BIG).astype(np.int32)
        reach = np.where(rng.random(shape) < 0.7,
                         rng.integers(0, 3 * Tk, shape),
                         ls.NEG).astype(np.int32)
        total, over = ls.hits_verdict(
            T, *(torch.from_numpy(x) for x in (cnt, ov, fh, reach)))
        order = [x.T.reshape(-1).astype(np.int64) for x in (fh, reach)]
        assert int(total) == int(cnt.sum())
        assert bool(over) == (bool(ov.any())
                              or ls.cross_lane_overlap(Tk, *order))


# -- K6: the kernel's reads, restated -----------------------------------------

def _hits_reads(T4, L, k):
    """The stream words csrc/needle_scan.cu's hits_kernel reads, as a dict
    from sub-lane (j, l) to its list of (word, lane) in read order (None
    for a zero past the last lane).  This restates the kernel's index
    arithmetic (i -> j, l; t0 = j*T4/k; scan_groups' first four words and
    load8's words g+4..g+11 while g + jj < t1; stream_word's lane change
    past T4) and must change with it."""
    reads = {}
    for i in range(k * L):
        j, l = divmod(i, L)
        t0 = j * (T4 // k)
        t1 = t0 + T4 // k
        idx = [t0 + jj for jj in range(4)]
        for g in range(t0, t1 + 8, 8):      # load8(next, t0), then g + 8
            idx += [g + jj + 4 for jj in range(8) if g + jj < t1]

        def word(x):
            if x < T4:
                return (x, l)
            return (x - T4, l + 1) if l + 1 < L else None
        reads[(j, l)] = [word(x) for x in idx]
    return reads


@pytest.mark.parametrize("T4,L,k", [(64, 16, 1), (64, 16, 8), (256, 16, 16),
                                    (128, 32, 4), (48, 8, 2),
                                    (49152, 8, 64)])
def test_hits_kernel_reads_cover_each_word_once(T4, L, k):
    """Each sub-lane reads its own T4/k words in corpus order, every tile
    word belongs to exactly one sub-lane, and its 16-byte look-ahead is the
    next sub-lane's first four words in corpus order (its own lane's, the
    last sub-lane's the next lane's, zeros after the last lane)."""
    reads = _hits_reads(T4, L, k)
    seen = np.zeros((T4, L), dtype=np.int64)
    Tk = T4 // k

    def corpus_word(r):
        return None if r is None else r[1] * T4 + r[0]

    for (j, l), rs in reads.items():
        own, ahead = rs[:Tk], rs[Tk:]
        for t, ll in own:
            seen[t, ll] += 1
        first = l * T4 + j * Tk
        assert [corpus_word(r) for r in own] == list(range(first,
                                                           first + Tk))
        want = [first + Tk + a for a in range(4)]
        assert [corpus_word(r) for r in ahead] == [
            w if w < L * T4 else None for w in want]
    assert (seen == 1).all()


# -- K3: the split flag scan against the reference ------------------------------

BIDI = {"ip": r"\d+\.\d+\.\d+\.\d+", "email": r"[\w.+-]+@[\w.-]+\.[\w.-]+",
        "url": r"\w+://[^\s]+", "version": r"\d+.\d+.\d+"}
FLAG_WORDS = [b"ip 10.0.0.1", b"version 1.22.3", b"u@x.com", b"lorem",
              b"9.8.7.6543", b"http://a.b/c", b"1.2.3.4.5", b"\n",
              b"e@f.g", b"ab"]


def _rev_dfa(pattern):
    nfa = compile_nfa(parse(pattern), reverse=True, ascii_only=True)
    return determinize(nfa, anchored=True, break_at_match=False,
                       reverse=True).minimized()


def _match_resets(pattern, arr):
    """Reversed positions of the pattern's match ends, ascending."""
    ends = [m.end() for m in re.finditer(pattern.encode(), arr.tobytes())]
    return np.asarray(sorted(len(arr) - e for e in ends), dtype=np.int32)


def _flag_inputs(pattern, arr, geom, pre=True):
    """(port tables, port reset tiles, ref scanner, ref reset tiles)
    under geom."""
    dfa = _rev_dfa(pattern)
    L, T = geom[:2]
    rq = _match_resets(pattern, arr)
    t = fs.ResetFlagTables.from_host(dfa, CTX_OTHER, "cpu",
                                     flag_pre_reset=pre)
    rsc = ref_fs.FlagResetScanner(DeviceDFA.from_dense(dfa), CTX_OTHER,
                                  impl="gather", flag_pre_reset=pre)
    flipped = _t(arr[::-1])
    tiles = fs.scatter_reset_tiles(
        fs.sym_base_tiles(flipped, rsc.byte_bounds(), L, T // 4),
        torch.from_numpy(rq), L, T // 4)
    rtiles = ref_fs.scatter_reset_tiles(
        ref_fs._sym_base_tiles(jnp.asarray(arr[::-1].copy()),
                               rsc.byte_bounds(), L, T // 4),
        jnp.asarray(rq), L, T // 4)
    return t, tiles, rsc, rtiles


@functools.lru_cache(maxsize=None)
def _ref_flag_of(pattern, seed, n, pre):
    """The reference's settled gather scan of a seeded corpus under
    GEOMS[1] (once per input: every split compares with it)."""
    arr = _words_corpus(seed, n, FLAG_WORDS)
    _t3, _tiles, rsc, rtiles = _flag_inputs(pattern, arr, GEOMS[1], pre)
    return _ref_flag(rsc, rtiles, n, GEOMS[1], False)


def _ref_flag(rsc, rtiles, n, geom, interpret):
    """The reference's _flag_full at geom, run until it settles."""
    L, T, W, Lc = geom
    t = rsc.tables
    if interpret:
        rsc.impl = "pallas"
    return [np.asarray(x) for x in ref_fs._flag_full(
        t.packed_rc, t.packed_full, rtiles, n + 1,
        jnp.full((L,), DEAD, jnp.int32), L=L, T=T, W=W, S=t.S,
        NSEG=t.NSEG, Tt4=8, Lc=Lc, impl=rsc.impl,
        col_of=t.col_of, row_of=t.row_of, R=t.R, Cp=t.Cp, max_repair=L,
        interpret=interpret)]


def _real_lanes(n, geom):
    return np.arange(geom[0]) * geom[1] < n + 1


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("name", sorted(BIDI))
def test_flag_split_matches_reference(name, k):
    """flag_full over k sub-lanes: the flag words and interference equal
    the reference's settled scan at the same geometry (its gather path),
    on the bidi patterns' reversed corpora with a reset at each reversed
    match end; the hint's row 0 is the reference's hint in every lane that
    holds symbols."""
    pattern = BIDI[name]
    geom = GEOMS[1]
    L, T, W, _ = geom
    for seed, n in enumerate([3000, L * T - 40]):
        arr = _words_corpus(seed, n, FLAG_WORDS)
        t, tiles, _rsc, _rt = _flag_inputs(pattern, arr, geom,
                                           pre=seed == 0)
        fw, interf, conv, hint = fs.flag_full(
            t.packed_full, tiles, n + 1, None, L, T, W, k,
            max_repair=L + cs.SUB_PASSES)
        efw, einterf, econv, ehint = _ref_flag_of(pattern, seed, n,
                                                  seed == 0)
        assert conv and bool(econv)
        np.testing.assert_array_equal(fw.numpy(), efw)
        assert int(interf) == int(einterf)
        assert tuple(hint.shape) == (k, L)
        real = _real_lanes(n, geom)
        np.testing.assert_array_equal(hint[0].numpy()[real], ehint[real])
        assert bool(fw.any())


@pytest.mark.parametrize("k", [2, 16])
def test_flag_split_matches_pallas_interpret(k):
    r"""As above, against the reference's K3 in interpret mode, on 8 lanes
    of 512 bytes, for `[a-f]+\d+x` (whose small reverse DFA the
    interpreter traces fastest)."""
    geom = (8, 512, 16, 1)
    L, T, W, _ = geom
    n = 2000
    arr = _words_corpus(77 + k, n, FLAG_WORDS + [b"fe12x", b"cdab3x"])
    t, tiles, rsc, rtiles = _flag_inputs(r"[a-f]+\d+x", arr, geom)
    fw, interf, conv, _h = fs.flag_full(
        t.packed_full, tiles, n + 1, None, L, T, W, k,
        max_repair=L + cs.SUB_PASSES)
    efw, einterf, econv, _eh = _ref_flag(rsc, rtiles, n, geom, True)
    assert conv and bool(econv)
    np.testing.assert_array_equal(fw.numpy(), efw)
    assert int(interf) == int(einterf)


# -- K3: the repair and the hint ------------------------------------------------

QUOTES = r'"[^"]*"'


def _quote_inputs(n=9000):
    """A reversed quote-parity corpus (`"` + 299 x, repeated) with a reset
    at each reversed match end: inside a match the reverse state reaches
    back 300 bytes, across several 64-byte sub-lanes."""
    arr = np.frombuffer(((b'"' + b"x" * 299) * (n // 300 + 1))[:n],
                        dtype=np.uint8)
    return arr, _flag_inputs(QUOTES, arr, GEOMS[1], pre=False)


def _full_rescan(walk, tiles, W, e0, o0, lim):
    """The repair with no selection: after pass 0, every real sub-lane
    walks again from the previous pass's exits until none is unsettled."""
    counts, exits, sync, fw, aux = cs.lane_walk_plain(
        cs.MODE_FLAG, walk.packed, None, tiles, W // 4, e0, o0, lim)
    k = int(e0.shape[0])
    T = int(tiles.shape[0]) * 4
    walked = torch.zeros(1, dtype=torch.int32)
    real = cs.sub_limits(lim, k, T // k).reshape(k, -1) > 0
    for _ in range(int(tiles.shape[1]) * k + 1):
        if not bool(cs.unsettled(exits, sync, lim, DEAD, T).any()):
            return counts, exits, sync, fw
        spare = torch.empty_like(exits)
        sync.masked_fill_(real, -1)
        cs.lane_repair_plain(cs.MODE_FLAG, False, walk.packed, None, tiles,
                             DEAD, lim, exits, spare, counts, sync, fw,
                             aux, walked)
        exits = spare
    raise AssertionError("full rescans did not settle")


@pytest.mark.parametrize("k", [1, 4, 16])
def test_flag_selective_repair_equals_full_rescans(k):
    """K3's selective fixpoint ends where full rescans of every sub-lane
    end (counts, flag words, and exits and syncs of the sub-lanes that
    hold symbols), and matches the reference's flag words and
    interference; at k = 16 it needs lane passes."""
    arr, (t, tiles, rsc, rtiles) = _quote_inputs()
    L, T, W, _ = GEOMS[1]
    n = len(arr)
    lim = (n + 1 - torch.arange(L) * T).clamp(0, T).to(torch.int32)
    e0 = torch.full((k, L), DEAD, dtype=torch.int32)
    o0 = torch.zeros(L, dtype=torch.int32)
    o0[0] = W
    walk = fs.FlagWalk(t.packed_full)
    before = (fs.FLAG_KERNEL.sub_passes, fs.FLAG_KERNEL.lane_passes)
    got, conv = cs.split_fixpoint(cs.MODE_FLAG, fs.FLAG_KERNEL, walk, tiles,
                                  W, e0, o0, lim, L + cs.SUB_PASSES)
    assert conv
    subs = fs.FLAG_KERNEL.sub_passes - before[0]
    lanes = fs.FLAG_KERNEL.lane_passes - before[1]
    counts, exits, sync, fw = _full_rescan(walk, tiles, W, e0, o0, lim)
    real = cs.sub_limits(lim, k, T // k).reshape(k, L) > 0
    assert torch.equal(got[0], counts) and torch.equal(got[3], fw)
    assert torch.equal(got[1][real], exits[real])
    assert torch.equal(got[2][real], sync[real])
    efw, einterf, _c, _h = _ref_flag(rsc, rtiles, n, GEOMS[1], False)
    np.testing.assert_array_equal(
        fs.to_global(got[3], n + 1).numpy(), efw)
    assert int(got[0].sum()) == int(einterf)
    assert subs + lanes > 0
    if k == 16:
        assert subs == cs.SUB_PASSES and lanes > 0


@pytest.mark.parametrize("k", [4, 16])
def test_hinted_scan_is_one_pass(k, monkeypatch):
    """A converged scan's [k, L] hint makes the next scan one pass that
    walks no warmup (W4 = 0, so each sync is its hint) with the same
    outputs, also where the fresh scan needed repair passes."""
    warmups = []
    real = cs.lane_walk

    def walk(mode, counter, packed, segmap, tiles, W4, *args):
        warmups.append(W4)
        return real(mode, counter, packed, segmap, tiles, W4, *args)

    monkeypatch.setattr(cs, "lane_walk", walk)
    words = _words_corpus(5, 12000, FLAG_WORDS)
    L, T, W, _ = GEOMS[1]
    for arr, (t, tiles, _rsc, _rt) in (
            _quote_inputs(),
            (words, _flag_inputs(BIDI["version"], words, GEOMS[1]))):
        n = len(arr)
        fresh = fs.flag_full(t.packed_full, tiles, n + 1, None, L, T, W, k,
                             max_repair=L + cs.SUB_PASSES)
        c = fs.FLAG_KERNEL
        before = (c.sub_passes, c.lane_passes)
        hinted = fs.flag_full(t.packed_full, tiles, n + 1, fresh[3], L, T,
                              W, k, max_repair=L + cs.SUB_PASSES)
        assert (c.sub_passes, c.lane_passes) == before
        assert warmups[-2:] == [W // 4, 0]
        for a, b in zip(fresh, hinted):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_hint_of_another_shape_is_dropped():
    """scan_tiles drops a hint whose shape is not (k, L) of its geometry,
    as a fresh scan, and returns a (k, L) hint."""
    arr = _words_corpus(9, 6000, FLAG_WORDS)
    n = len(arr)
    geom = fs.reset_geometry(n)
    t, tiles, _r, _rt = _flag_inputs(BIDI["ip"], arr, geom)
    sc = fs.FlagResetScanner(_rev_dfa(BIDI["ip"]), CTX_OTHER, "cpu",
                             flag_pre_reset=True)
    L, T, W, _ = geom
    k = cs.lane_split(T, W)
    fresh = sc.scan_tiles(tiles, n)
    assert tuple(fresh[3].shape) == (k, L)
    junk = torch.full((2, L), 3, dtype=torch.int32)
    for wrong in (junk, junk[:, :-1], fresh[3][0]):
        got = sc.scan_tiles(tiles, n, entries_hint=wrong)
        for a, b in zip(fresh, got):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_bidi_find_all_caches_split_hints():
    """The bidi find_all keeps one [k, L] reverse-scan hint per corpus
    (k = 2 at 4 MiB), and its warm call, which enters through the hint,
    gives the cold call's spans."""
    line = b"ip 10.0.0.1 x 1.2.3.4 version 1.22.3\n"
    arr = np.frombuffer((line * ((4 << 20) // len(line) + 1))[:4 << 20],
                        dtype=np.uint8)
    eng = ct.compile(BIDI["ip"], device="cpu")
    be = eng.batch_engine()
    cold = be.find_all_spans_device(arr)
    (hint,) = be._rev_hint_cache.values()
    L, T, W, _ = fs.reset_geometry(len(arr))
    assert tuple(hint.shape) == (cs.lane_split(T, W), L) == (2, L)
    warm = be.find_all_spans_device(arr)
    assert int(cold[1]) == int(warm[1]) == len(
        re.findall(BIDI["ip"].encode(), arr.tobytes()))
    assert torch.equal(cold[0][:int(cold[1])], warm[0][:int(warm[1])])
