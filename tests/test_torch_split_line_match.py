"""The sub-lane split of K5 (the line-needle scan, csrc/needle_scan.cu) and
of K9 (the chunked DFA match scan, csrc/lane_scan.cu), against the JAX
package's LineScanner and ChunkScanner on the CPU.

K5 walks k sub-lanes a lane with no fixpoint, and ``LineScanner.verdict``
stitches its [k, L] outputs on the device; K9 walks k sub-lanes a lane
through ``count_scan.split_fixpoint``, whose dead cut ends a scan at the
first exact sub-lane that dies.  Here the plain versions run at k = 1, 2,
4, 8 and 16 on 16 lanes of 1-4 KiB (a 16-byte warmup), on corpora made
from numpy seeds and on needles, newlines, prefixes and deaths placed at
sub-lane seams, against the reference's K5 in interpret mode (at the
geometry whose lanes are these sub-lanes), its ChunkScanner (impl="gather")
and its host oracles.  Every output is an integer, a state or a flag:
exact equality.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import dfa_scan as ref_ds
from coregex_tpu.ops import line_scan as ref_ls
from coregex_tpu.ops.seq_scan import line_count_host
from coregex_tpu.syntax.parser import parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import dfa_scan
from coregex_tpu_torch.ops import line_scan as ls
from coregex_tpu_torch.ops.span_scan import to_global

torch.set_num_threads(1)

SPLITS = [1, 2, 4, 8, 16]
GEOMS = {1: (16, 1024, 16, 2), 4: (16, 4096, 16, 2)}   # KiB a lane -> geom


def _t(arr):
    return torch.from_numpy(np.array(arr, dtype=np.uint8))


def _placed(n, placements, fill=b"."):
    """A corpus of `fill` with each (position, bytes) written in."""
    buf = bytearray(fill * n)
    for p, w in placements:
        buf[p:p + len(w)] = w
    return np.frombuffer(bytes(buf[:n]), dtype=np.uint8)


# -- K5 -----------------------------------------------------------------------

LINE_KINDS = {"plain": ([b"key", b"ab"], b"", False),
              "anchored": ([b"ab"], b"/x", True)}
LINE_WORDS = [b"ab", b"/x", b"/xab", b"key", b"a", b"b", b"x", b"/", b"lorem"]


def _line_corpus(seed, n):
    """Words joined by spaces, nothing or newlines, from a numpy seed."""
    rng = np.random.default_rng(seed)
    seps = [b" ", b"", b"\n", b"\n"]
    out = b"".join(LINE_WORDS[i] + seps[j] for i, j in zip(
        rng.integers(0, len(LINE_WORDS), n // 2),
        rng.integers(0, len(seps), n // 2)))
    return np.frombuffer(out[:n].ljust(n, b"."), dtype=np.uint8)


def _line_seams(geom, k):
    """Placements at the sub-lane seams of geom's lanes: a needle across a
    seam, a newline on a sub-lane's last byte with the prefix at the next
    one's byte 0, a line over sub-lanes that hold no newline, and an
    unterminated last line at an n that cuts a sub-lane."""
    L, T = geom[:2]
    Tk = T // k
    n = L * T - 100
    across = [(Tk - 4, b"\n/xab"), (3 * Tk - 2, b"key")]
    last_byte = [(2 * Tk - 1, b"\n/xab"), (T + Tk - 1, b"\n/xkey")]
    no_newline = [(4 * Tk - 3, b"\n/x"), (6 * Tk + 7, b"ab"),
                  (8 * Tk + 2, b"\n")]
    tail = [(n - 6, b"\n/xab")]
    return [_placed(n, across), _placed(n, last_byte),
            _placed(n, no_newline + tail),
            _placed(n, across + last_byte + no_newline)]


@functools.lru_cache(maxsize=None)
def _ref_line_of(kind, data, geom):
    """(count, per-lane outputs [5][L]) of the reference's LineScanner, its
    K5 in interpret mode, at geom."""
    needles, prefix, anchored = LINE_KINDS[kind]
    ref = ref_ls.LineScanner(needles, prefix=prefix, anchored=anchored,
                             interpret=True)
    lanes = {}
    orig = ref._combine

    def grab(n, L, T, *outs):
        lanes["out"] = outs[:5]
        return orig(n, L, T, *outs)

    ref._combine = grab
    arr = np.frombuffer(data, dtype=np.uint8)
    return ref.count(jnp.asarray(arr), data_host=arr, geometry=geom), \
        lanes["out"]


def _port_line(kind, arr, geom, k):
    """(count through verdict, outputs [5][k, L]) of the plain split walk."""
    needles, prefix, anchored = LINE_KINDS[kind]
    sc = ls.LineScanner(needles, prefix=prefix, anchored=anchored)
    L, T = geom[:2]
    data = _t(arr)
    args = sc.lane_args(data, geom, None, k)
    outs = ls.line_lanes(*args)
    return int(sc.verdict(data, T, args[5], *outs)), outs, sc


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("kind", sorted(LINE_KINDS))
def test_line_split_matches_reference(kind, k):
    """The plain split outputs, read in corpus order, equal the reference
    K5's (interpret mode) at the geometry whose lanes are the sub-lanes
    (k*L lanes of T/k bytes), and the device combine gives its count and
    the host oracle's, on seeded corpora and on seam placements."""
    needles, prefix, anchored = LINE_KINDS[kind]
    L, T, W, _ = GEOMS[1]
    sub_geom = (k * L, T // k, W, k * L // 8)
    corpora = [_line_corpus(7, L * T - 100), _line_corpus(8, L * T - 100)]
    for arr in corpora + _line_seams(GEOMS[1], k):
        cnt, outs, _sc = _port_line(kind, arr, GEOMS[1], k)
        exp, ref_outs = _ref_line_of(kind, arr.tobytes(), sub_geom)
        for g, e in zip(outs, ref_outs):
            np.testing.assert_array_equal(
                g.t().reshape(-1).numpy().astype(np.int64), e)
        assert cnt == exp == line_count_host(arr.tobytes(), needles, prefix,
                                             anchored)


@pytest.mark.parametrize("k", SPLITS)
def test_line_split_4kib_lanes_match_host_oracle(k):
    """On 4 KiB lanes, both kinds: the device combine equals the numpy
    _combine over the k*L sub-lanes in corpus order and the host oracle,
    on seeded corpora and on seam placements."""
    geom = GEOMS[4]
    L, T = geom[:2]
    for kind, (needles, prefix, anchored) in sorted(LINE_KINDS.items()):
        for arr in [_line_corpus(20 + k, L * T - 33)] + \
                _line_seams(geom, k):
            cnt, outs, sc = _port_line(kind, arr, geom, k)
            flat = [x.t().reshape(-1).numpy().astype(np.int64)
                    for x in outs]
            assert cnt == sc._combine(len(arr), k * L, T // k, *flat, arr) \
                == line_count_host(arr.tobytes(), needles, prefix, anchored)


@pytest.mark.parametrize("k", SPLITS)
def test_line_verdict_matches_numpy_combine(k):
    """verdict on random [k, L] outputs equals the numpy _combine over the
    k*L sub-lanes in corpus order, anchored (a two-byte prefix, checked at
    the sub-lane bases on the data) and not."""
    rng = np.random.default_rng(60 + k)
    NEG = ls.NEG
    for anchored in (False, True):
        sc = ls.LineScanner([b"xy"], prefix=b"/a" if anchored else b"",
                            anchored=anchored)
        for _ in range(60):
            L, Tk = int(rng.integers(1, 9)), int(rng.integers(4, 24))
            T = Tk * k
            n = int(rng.integers(1, L * T + 1))
            arr = rng.choice(np.frombuffer(b"/a\nx", np.uint8), n)

            def pos():
                return np.where(rng.random((k, L)) < 0.5,
                                rng.integers(0, Tk, (k, L)), NEG)

            outs = [rng.integers(0, 3, (k, L)), pos(), pos(), pos(),
                    np.where(rng.random((k, L)) < 0.5,
                             rng.integers(0, Tk, (k, L)), -1)]
            data = _t(arr)
            pnl = sc.lane_starts(data, L, T, k)
            got = sc.verdict(data, T, pnl, *(torch.from_numpy(
                x.astype(np.int32)) for x in outs))
            flat = [x.T.reshape(-1).astype(np.int64) for x in outs]
            assert int(got) == sc._combine(n, k * L, Tk, *flat, arr)


def test_line_count_walks_lane_split(monkeypatch):
    """LineScanner.count walks lane_split(T, W) sub-lanes a lane (16 and
    64 on GEOMS), and a line-shape Engine.count on 4 MiB walks 2."""
    seen = []
    real = ls.line_lanes

    def spy(tbl, lens, jh, anchored, plen, pnl, tiles):
        seen.append(int(pnl.shape[0]))
        return real(tbl, lens, jh, anchored, plen, pnl, tiles)

    monkeypatch.setattr(ls, "line_lanes", spy)
    needles, prefix, anchored = LINE_KINDS["anchored"]
    sc = ls.LineScanner(needles, prefix=prefix, anchored=anchored)
    for geom in GEOMS.values():
        arr = _line_corpus(3, 5000)
        assert sc.count(_t(arr), geom) == line_count_host(
            arr.tobytes(), needles, prefix, anchored)
    assert seen == [cs.lane_split(g[1], g[2]) for g in GEOMS.values()]
    assert seen == [16, 64]
    line = b"GET /index.php x\n/home/a.php 1\n/x.txt y.php\n"
    big = np.frombuffer(line * ((4 << 20) // len(line)), dtype=np.uint8)
    eng = ct.compile(r"(?m)^/.*\.php", device="cpu")
    assert eng.batch_engine()._count_route(big)[0] == "line"
    assert eng.count(big) == 2 * (len(big) // len(line))
    assert seen[-1] == 2


@pytest.mark.parametrize("pnl_shape,jh,msg", [
    ((16,), 1, "pnl must be"), ((3, 16), 1, "power of two"),
    ((2, 16), 2, "jh needles plus the prefix")])
def test_line_cuda_wrapper_validates_before_launch(pnl_shape, jh, msg):
    """The K5 wrapper refuses a pnl that is not [k, L], a k that is not a
    power of two whose sub-lanes hold whole 8-word groups, and a table
    that is not the jh needles plus the anchored prefix, before it builds
    or launches anything."""
    needles, prefix, anchored = LINE_KINDS["anchored"]
    sc = ls.LineScanner(needles, prefix=prefix, anchored=anchored)
    tiles = torch.zeros((64, 16), dtype=torch.int32)
    pnl = torch.zeros(pnl_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        ls.line_lanes_cuda(sc.tbl, sc.lens, jh, True, 2, pnl, tiles)


# -- K9 -----------------------------------------------------------------------

# per pattern: a match, and a match whose flag comes at n (the EOI flag)
MATCHES = {r"\s\d\s": (b" 5 ", b" 5 "), r"a\b": (b"a ", b" a"),
           r"(?m)z$": (b"z\n", b" z"), r"\d+\.\d+": (b"12.5 ", b" 7.25"),
           r"(a|b)+c": (b"abc", b" bac"), r"ab": (b"ab", b" ab")}
KINDS = {"fwd_all": [r"\s\d\s", r"a\b", r"(?m)z$"],
         "fwd_break": [r"\d+\.\d+", r"(a|b)+c", r"ab"]}
MATCH_WORDS = [b"abc 12.5 x", b"0.7", b"z\n", b"a ", b"xa", b"ab", b"1 2 3",
               b"\n", b"lorem", b"bbac", b"10.0.0.1"]


def _dfa(pattern, brk):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    return determinize(nfa, anchored=False, break_at_match=brk)


def _match_corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(MATCH_WORDS[i]
                    for i in rng.integers(0, len(MATCH_WORDS), n // 3))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _match_placements(pattern, geom, k):
    """Corpora of filler at an n that cuts a sub-lane: a first match in
    sub-lane 2 of lane 0 (a death there for a break-at-match DFA), one in
    lane 1's last sub-lane, none, and one whose flag is the EOI flag at
    n."""
    L, T = geom[:2]
    Tk = T // k
    n = L * T - 77
    hit, at_end = MATCHES[pattern]
    return [_placed(n, [(2 * Tk + 5, hit), (9 * T, hit)]),
            _placed(n, [(2 * T - Tk + 3, hit)]), _placed(n, []),
            _placed(n, [(n - len(at_end), at_end)])]


@functools.lru_cache(maxsize=None)
def _ref_scan(pattern, brk, data):
    """The reference ChunkScanner's (flags [n+1], exit at n), gather."""
    rsc = ref_ds.ChunkScanner(ref_ds.DeviceDFA.from_dense(_dfa(pattern, brk)),
                              impl="gather")
    flags, exit_n = rsc.scan(jnp.asarray(np.frombuffer(data, np.uint8)))
    return np.asarray(flags), int(exit_n)


def _port_scan(mt, arr, geom, k):
    """match_full at k sub-lanes a lane: (flags [n+1], exit at n, scan)."""
    L, T, W, _ = geom
    n = len(arr)
    data = _t(arr)
    out = dfa_scan.match_full(mt, data, cs.make_word_tiles(data, L, T // 4),
                              n, L, T, W, k)
    scan = dfa_scan.MatchScan(*out, n, L, T)
    words = to_global(scan.flagw, n).numpy()
    flags = np.zeros(n + 1, dtype=bool)
    flags[:n] = np.unpackbits(words.view(np.uint8), bitorder="little")[:n]
    exit_n = int(dfa_scan.exit_at_end(scan))
    flags[n] = bool(mt.eoi[exit_n, 0])
    assert int(dfa_scan.flags_count_upto(scan)) == int(flags[:n].sum())
    pos = np.nonzero(flags[:n])[0]
    assert int(dfa_scan.flags_last(scan)) == (pos[-1] if len(pos) else -1)
    return flags, exit_n, scan


def _tables(pattern, brk):
    return dfa_scan.MatchTables(
        dfa_scan.DFATables.from_dense(_dfa(pattern, brk)), "cpu")


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_match_split_matches_reference(kind, k):
    """The settled split scan's flags and exit state at n equal the
    reference's (ChunkScanner, gather), with flags_count_upto and
    flags_last equal to the flags' count and last position: on a seeded
    corpus and on placed first matches (a death in sub-lane 2, in a lane's
    last sub-lane, none, the EOI flag at n), each at an n that cuts a
    sub-lane."""
    brk = kind == "fwd_break"
    geom = GEOMS[1]
    for pattern in KINDS[kind]:
        mt = _tables(pattern, brk)
        corpora = [_match_corpus(5, geom[0] * geom[1] - 77)]
        for arr in corpora + _match_placements(pattern, geom, k):
            flags, exit_n, _s = _port_scan(mt, arr, geom, k)
            want, wexit = _ref_scan(pattern, brk, arr.tobytes())
            np.testing.assert_array_equal(flags, want)
            assert exit_n == wexit


def _quotes(n):
    return np.frombuffer(((b'"' + b"x" * 299) * (n // 300 + 1))[:n],
                         dtype=np.uint8)


def _fixpoint(mt, arr, geom, k, dead):
    """split_fixpoint in MODE_MATCH from match_full's first pass."""
    L, T, W, _ = geom
    data = _t(arr)
    e0, o0, lim = cs.first_pass_inputs(mt.starts, data, len(arr), L, T, W,
                                       k)
    tiles = cs.make_word_tiles(data, L, T // 4)
    got, conv = cs.split_fixpoint(cs.MODE_MATCH, dfa_scan.MATCH_KERNEL, mt,
                                  tiles, W, e0, o0, lim, L + cs.SUB_PASSES,
                                  dead=dead)
    return got, conv, tiles, e0, o0, lim


def _full_rescan(mt, tiles, W, e0, o0, lim):
    """The repair with no selection: after pass 0, every real sub-lane
    walks again from the previous pass's exits until none is unsettled."""
    counts, exits, sync, fw, last = cs.lane_walk_plain(
        cs.MODE_MATCH, mt.packed, mt.segmap, tiles, W // 4, e0, o0, lim)
    k = int(e0.shape[0])
    T = int(tiles.shape[0]) * 4
    walked = torch.zeros(1, dtype=torch.int32)
    real = cs.sub_limits(lim, k, T // k).reshape(k, -1) > 0
    for _ in range(int(tiles.shape[1]) * k + 1):
        if not bool(cs.unsettled(exits, sync, lim, mt.sot, T).any()):
            return counts, exits, sync, fw, last
        spare = torch.empty_like(exits)
        sync.masked_fill_(real, -1)
        cs.lane_repair_plain(cs.MODE_MATCH, False, mt.packed, mt.segmap,
                             tiles, mt.sot, lim, exits, spare, counts, sync,
                             fw, last, walked)
        exits = spare
    raise AssertionError("full rescans did not settle")


@pytest.mark.parametrize("k", [1, 4, 16])
def test_match_selective_repair_equals_full_rescans(k):
    r"""K9's selective fixpoint on quote parity (`"[^"]*"` fwd_all, whose
    state reaches back 300 bytes, across many 64-byte sub-lanes, and never
    dies) ends where full rescans of every sub-lane end, and its flags
    equal the reference's; at k = 16 it needs lane passes."""
    mt = _tables(r'"[^"]*"', False)
    L, T, W, _ = GEOMS[1]
    arr = _quotes(9000)
    c = dfa_scan.MATCH_KERNEL
    before = (c.sub_passes, c.lane_passes)
    got, conv, tiles, e0, o0, lim = _fixpoint(mt, arr, GEOMS[1], k,
                                              dfa_scan.DEAD)
    assert conv
    subs, lanes = c.sub_passes - before[0], c.lane_passes - before[1]
    counts, exits, sync, fw, last = _full_rescan(mt, tiles, W, e0, o0, lim)
    real = cs.sub_limits(lim, k, T // k).reshape(k, L) > 0
    for g, w in ((got[0], counts), (got[3], fw), (got[4], last)):
        assert torch.equal(g, w)
    assert torch.equal(got[1][real], exits[real])
    assert torch.equal(got[2][real], sync[real])
    want, _wexit = _ref_scan(r'"[^"]*"', False, arr.tobytes())
    flags = np.unpackbits(to_global(got[3], len(arr)).numpy().view(
        np.uint8), bitorder="little")[:len(arr)].astype(bool)
    np.testing.assert_array_equal(flags, want[:len(arr)])
    assert subs + lanes > 0
    if k == 16:
        assert subs == cs.SUB_PASSES and lanes > 0


@pytest.mark.parametrize("k", [2, 4, 16])
def test_cut_ends_split_scan_after_pass_0(k, monkeypatch):
    """A break-at-match DFA whose first match lies in sub-lane (0, 0) dies
    there on the exact chain: the cut ends the k > 1 scan after pass 0,
    with no repair pass, and sets every later sub-lane DEAD with no flags,
    as the reference's scan has them."""
    calls = []
    walk, repair = cs.lane_walk, cs.lane_repair
    monkeypatch.setattr(cs, "lane_walk",
                        lambda *a: calls.append("walk") or walk(*a))
    monkeypatch.setattr(cs, "lane_repair",
                        lambda *a: calls.append("repair") or repair(*a))
    geom = GEOMS[1]
    n = geom[0] * geom[1] - 77
    for pattern in KINDS["fwd_break"]:
        mt = _tables(pattern, True)
        hit = MATCHES[pattern][0]
        arr = _placed(n, [(3, hit), (5 * geom[1], hit)], b"x")
        calls.clear()
        flags, exit_n, scan = _port_scan(mt, arr, geom, k)
        assert calls == ["walk"]
        want, wexit = _ref_scan(pattern, True, arr.tobytes())
        np.testing.assert_array_equal(flags, want)
        assert exit_n == wexit == dfa_scan.DEAD
        assert int(scan.counts.sum()) == 1
        assert bool((scan.exits.t().reshape(-1)[1:] == dfa_scan.DEAD).all())


@pytest.mark.parametrize("k", [4, 16])
def test_cut_waits_for_the_exact_chain(k):
    r"""Quote parity under its break-at-match DFA dies after the first
    quoted run (byte 300), in a sub-lane whose warmup guessed its entry
    wrong: the scan repairs up to it, then the cut ends it, and the flags
    and exit equal the reference's."""
    mt = _tables(r'"[^"]*"', True)
    arr = _quotes(9000)
    c = dfa_scan.MATCH_KERNEL
    before = c.sub_passes + c.lane_passes
    flags, exit_n, _s = _port_scan(mt, arr, GEOMS[1], k)
    assert c.sub_passes + c.lane_passes > before
    want, wexit = _ref_scan(r'"[^"]*"', True, arr.tobytes())
    np.testing.assert_array_equal(flags, want)
    assert exit_n == wexit == dfa_scan.DEAD


def test_match_scan_walks_lane_split(monkeypatch):
    """ChunkScanner.scan_device walks lane_split(T, W) sub-lanes a lane:
    16 and 64 on GEOMS."""
    seen = []
    real = cs.lane_walk

    def spy(mode, counter, *args):
        seen.append(int(args[4].shape[0]))
        return real(mode, counter, *args)

    monkeypatch.setattr(cs, "lane_walk", spy)
    sc = dfa_scan.ChunkScanner(
        dfa_scan.DFATables.from_dense(_dfa(r"\s\d\s", False)), "cpu")
    arr = _match_corpus(9, 9000)
    for geom in GEOMS.values():
        scan = sc.scan_device(_t(arr), geom)
        assert int(dfa_scan.flags_count_upto(scan)) == int(
            _ref_scan(r"\s\d\s", False, arr.tobytes())[0][:-1].sum())
    assert seen == [16, 64]


SINGLE = [r"\s\d\s", r"\d+\.\d+\.\d+\.\d+", r"(a|b)+c"]


def _single_corpora():
    """About 2.5 MiB (lane_split gives 2): spaces, a newline and a tail
    with the matches (late), and spaces only (none)."""
    n = (5 << 19) + 1000
    tail = b"\n1.2 ab 4 5 bbc 10.0.0.1 z\n a x"
    return {"late": (b" " * (n - len(tail)) + tail),
            "none": b" " * n}


@pytest.mark.parametrize("pattern", SINGLE)
def test_batch_single_match_matches_reference(pattern):
    """BatchEngine.is_match and find_first (through Engine.is_match and
    find_index) at k = 2 equal the reference Engine's, with no host
    route."""
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    for name, t in _single_corpora().items():
        a = np.frombuffer(t, dtype=np.uint8)
        L, T, W, _ = cs.plan_geometry(len(a))
        assert cs.lane_split(T, W) == 2
        assert eng.is_match(a) == ref.is_match(a), name
        assert eng.find_index(a) == ref.find_index(a), name
    assert eng.batch_engine().host_routes == 0


@pytest.mark.parametrize("k", [4, 16])
def test_no_cut_at_an_unsettled_dead_sub_lane(k):
    r"""`"[^"]*"|z` break-at-match: inside a quoted run a `z` raises a flag
    and lives on, outside it matches and dies.  The run opens in sub-lane
    1's warmup window (so sub-lane 1 is settled) and holds a `z` in
    sub-lane 2, whose warmup over x's guesses "outside": sub-lane 2 dies
    but is unsettled, so the scan repairs instead of cutting there, and
    keeps the run's closing flag in sub-lane 5."""
    geom = GEOMS[1]
    Tk = geom[1] // k
    n = geom[0] * geom[1] - 77
    arr = _placed(n, [(Tk - 8, b'"'), (2 * Tk + 10, b"z"), (5 * Tk, b'"')],
                  b"x")
    mt = _tables(r'"[^"]*"|z', True)
    flags, exit_n, _s = _port_scan(mt, arr, geom, k)
    want, wexit = _ref_scan(r'"[^"]*"|z', True, arr.tobytes())
    np.testing.assert_array_equal(flags, want)
    assert exit_n == wexit
    assert bool(want[5 * Tk + 1])
