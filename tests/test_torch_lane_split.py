"""The sub-lane split of K1 and K2 (csrc/lane_scan.cu) and its repair
fixpoint, against the JAX package's count and span scans on the CPU.

K1 and K2 split each lane of the shared [T4, L] word tiles into k
consecutive sub-lanes (``count_scan.lane_split``), and ``split_fixpoint``
walks again only the unsettled sub-lanes, then whole lanes.  Here the plain
split walk runs at k = 1, 2, 4, 8 and 16 on 16 lanes of 1 KiB with a 16-byte
warmup, on seeded corpora, against the reference's ``CountScanner`` and
``SpanScanner`` (impl="gather"), its count kernel in interpret mode and the
host oracle ``CountDFA.count_scan``.  Every output is an integer, a state or
a flag word: exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.countdfa import build_count_dfa
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import count_scan as ref
from coregex_tpu.ops import span_scan as ref_ss
from coregex_tpu.syntax.parser import parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import flag_scan
from coregex_tpu_torch.ops import span_scan as ss

torch.set_num_threads(1)

GEOM = (16, 1024, 16, 2)        # L, T, W, Lc: 16 lanes of 1 KiB
SPLITS = [1, 2, 4, 8, 16]
WORDS = [b"ip 10.0.0.1", b"version 1.22.3", b"error", b"u@x.com", b"lorem",
         b"9.8.7.6543", b"a.b.c", b"http://a.b/c", b"1.2.3.4.5", b"\n",
         b'"q"', b"/x.php", b"keyword"]


def _cd(pattern, spans=False):
    nfa = compile_nfa(parse(pattern), with_captures=False, ascii_only=True)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    assert cd is not None
    return cd.minimized() if spans else cd.without_spans().minimized()


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 3))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _quotes(n):
    return np.frombuffer(((b'"' + b"x" * 299) * (n // 300 + 1))[:n],
                         dtype=np.uint8)


# -- the split rule ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4096, 70000, 1 << 20, 4 << 20, 16 << 20,
                               1 << 28, 1536 << 20, 1610608640,
                               2 ** 31 - 33])
def test_lane_split_rule(n):
    """k is the largest power of two up to MAX_SPLIT that divides the
    lane's T/32 flag groups and keeps T/k >= 4W; 1 below T = 8W."""
    L, T, W, _ = cs.plan_geometry(n)
    k = cs.lane_split(T, W)
    assert k & (k - 1) == 0 and 1 <= k <= cs.MAX_SPLIT
    assert (T // 32) % k == 0 and (k == 1 or T // k >= 4 * W)
    k2 = 2 * k
    assert (k2 > cs.MAX_SPLIT or (T // 32) % k2 or T // k2 < 4 * W)
    if T < 8 * W:
        assert k == 1
    if n >= 1536 << 20:
        assert k == 64 and k * L > 8192


# -- the kernel's reads, restated --------------------------------------------

def _kernel_reads(T4, L, W4, k):
    """The words csrc/lane_scan.cu's lane_walk_kernel reads in pass 0, as
    (walk, warm): dicts from sub-lane (j, l) to its list of (word, lane).
    This restates the kernel's own index arithmetic (G, the warmup's `src`
    and `w0`, `walk`'s `(g0 + g) * 8 + j`) and must change with it: the
    tests hold the split to this copy, and only chip_smoke.py holds the
    CUDA code to the plain walk, on the card."""
    G = T4 // 8 // k
    walk, warm = {}, {}
    for i in range(k * L):
        j, l = divmod(i, L)
        src = (L - 1 if l == 0 else l - 1) if j == 0 else l
        w0 = (T4 if j == 0 else j * G * 8) - W4
        warm[(j, l)] = [(w0 + tw, src) for tw in range(W4)]
        walk[(j, l)] = [((j * G + g) * 8 + jj, l) for g in range(G)
                        for jj in range(8)]
    return walk, warm


@pytest.mark.parametrize("T4,L,W4,k", [(64, 16, 16, 1), (64, 16, 16, 4),
                                       (256, 16, 4, 16), (128, 32, 8, 8),
                                       (48, 8, 6, 2), (49152, 8, 16, 64)])
def test_kernel_reads_cover_each_word_once(T4, L, W4, k):
    """Every tile word is walked by exactly one sub-lane, in corpus order;
    every warmup reads the W4 words just before its sub-lane (sub-lane
    (0, 0) reads lane L-1's tail, which its offset skips)."""
    walk, warm = _kernel_reads(T4, L, W4, k)
    seen = np.zeros((T4, L), dtype=np.int64)
    for reads in walk.values():
        for t, l in reads:
            seen[t, l] += 1
    assert (seen == 1).all()

    def corpus_word(t, l):
        return l * T4 + t

    for (j, l), reads in walk.items():
        first = corpus_word(*reads[0])
        assert first == l * T4 + j * (T4 // k)
        assert [corpus_word(*r) for r in reads] == list(
            range(first, first + T4 // k))
        want = [(first - W4 + tw) % (L * T4) for tw in range(W4)]
        assert [corpus_word(*r) for r in warm[(j, l)]] == want
    # a lane pass walks sub-lanes 0..k-1 of a lane back to back: its whole
    # lane, in order
    for l in range(L):
        words = [corpus_word(*r) for j in range(k) for r in walk[(j, l)]]
        assert words == list(range(l * T4, (l + 1) * T4))


# -- the plain split walk against the reference -------------------------------

COUNT_PATTERNS = [r"\d+\.\d+\.\d+\.\d+", r"[\w.+-]+@[\w.-]+\.[\w.-]+",
                  r"(?m)^/.*\.php", r"[\w]+"]


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("pattern", COUNT_PATTERNS)
def test_split_count_matches_reference(pattern, k):
    """count_full over k sub-lanes equals the reference CountScanner at the
    same geometry and the host oracle, on corpora that fill 1, 5 and all
    16 lanes."""
    cd = _cd(pattern)
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    rsc = ref.CountScanner(cd, impl="gather")
    L, T, W, _ = GEOM
    for seed, n in enumerate([700, 5000, 16000]):
        arr = _corpus(seed + 31 * k, n)
        dev = torch.from_numpy(arr.copy())
        tiles = cs.make_word_tiles(dev, L, T // 4)
        total, conv = cs.count_full(d, dev, tiles, n, L, T, W,
                                    max_repair=L + cs.SUB_PASSES, k=k)
        assert conv
        exp = cd.count_scan(arr)
        assert int(total) == exp
        got_ref = rsc.count(jnp.asarray(arr), geometry=GEOM)
        assert got_ref is None or got_ref == exp


def _settled_lanes(cd, arr, k):
    """(per-lane aggregates of a settled split count, tiles, inputs)."""
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    L, T, W, _ = GEOM
    n = len(arr)
    dev = torch.from_numpy(arr.copy())
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(d.starts, dev, n, L, T, W, k)
    (counts, exits, sync, _f, _a), conv = cs.split_fixpoint(
        cs.MODE_COUNT, cs.COUNT_KERNEL, d, tiles, W, e0, o0, lim,
        L + cs.SUB_PASSES)
    assert conv
    return cs.lane_aggregates(counts, exits, sync), tiles, lim


@pytest.mark.parametrize("k", [2, 8])
def test_split_lanes_match_pallas_interpret(k):
    """The per-lane aggregates of a settled split walk (counts summed over
    the sub-lanes, the last one's exit, the first one's sync) equal one
    pass of the reference's count kernel in interpret mode entered at the
    same lane states with no warmup, whose exits chain into those entries:
    the reference's converged lanes."""
    cd = _cd(r"[\w]+")
    arr = _corpus(5, 12000)
    (counts, exits, sync), tiles, lim = _settled_lanes(cd, arr, k)
    L, T, W, Lc = GEOM
    T4, W4 = T // 4, W // 4
    r = ref.DeviceCountDFA(cd)
    jt = jnp.asarray(tiles.numpy().reshape(T4, 8, Lc))
    warm = jnp.roll(jt[T4 - W4:].reshape(W4, L), 1, axis=1).reshape(
        W4, 8, Lc)

    def lanes(x):
        return jnp.asarray(x.numpy().reshape(8, Lc))

    rc, rx, rs = ref._pallas_count_once(
        r.packed_rc, r.bounds, jt, warm, lanes(sync),
        lanes(torch.full((L,), W, dtype=torch.int32)), lanes(lim),
        S=r.S, NSEG=r.NSEG, NB=r.NB, T4=T4, Tt4=min(64, T4), W4=W4, Lc=Lc,
        col_of=r.col_of, row_of=r.row_of, R=r.R, Cp=r.Cp, interpret=True)
    rx = np.asarray(rx).reshape(L)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc).reshape(L))
    np.testing.assert_array_equal(exits.numpy(), rx)
    np.testing.assert_array_equal(sync.numpy(), np.asarray(rs).reshape(L))
    # the reference's lanes are settled there: each enters at its
    # predecessor's exit
    np.testing.assert_array_equal(sync.numpy()[1:], rx[:-1])


SPAN_PATTERNS = [r"\d+\.\d+\.\d+\.\d+", r"\d+.\d+.\d+", r"\w+://[^\s]+"]


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("pattern", SPAN_PATTERNS)
def test_split_span_matches_reference(pattern, k):
    """span_full over k sub-lanes: position-major flag and first words,
    total and EOI kind equal the reference SpanScanner's at the same
    geometry (where its 4 rescans converge) and the unsplit walk's."""
    cd = _cd(pattern, spans=True)
    d = ss.DeviceSpanDFA.from_host(cd, "cpu")
    rsc = ref_ss.SpanScanner(cd, impl="gather")
    L, T, W, _ = GEOM
    for seed, n in enumerate([3000, 16000]):
        arr = _corpus(seed + 7 * k, n)
        dev = torch.from_numpy(arr.copy())
        tiles = cs.make_word_tiles(dev, L, T // 4)
        fw, gw, total, kind, conv = ss.span_full(
            d, dev, tiles, n, L, T, W, max_repair=L + cs.SUB_PASSES, k=k)
        assert conv and int(total) == cd.count_scan(arr)
        one = ss.span_full(d, dev, tiles, n, L, T, W, max_repair=L)
        for a, b in zip((fw, gw, total, kind), one[:4]):
            assert torch.equal(a, b)
        efw, egw, _nev, etotal, ekind, econv = (
            np.asarray(x) for x in rsc.scan(jnp.asarray(arr), geometry=GEOM))
        if bool(econv):
            np.testing.assert_array_equal(fw.numpy(), efw)
            np.testing.assert_array_equal(gw.numpy(), egw)
            assert int(total) == int(etotal) and int(kind) == int(ekind)


# -- the repair ----------------------------------------------------------------

def _full_rescan(mode, d, tiles, W, e0, o0, lim):
    """The repair with no selection: after pass 0, every real sub-lane
    walks again from the previous pass's exits until none is unsettled
    (a sync that no state equals marks them all unsettled)."""
    counts, exits, sync, fw, aux = cs.lane_walk_plain(
        mode, d.packed, d.segmap, tiles, W // 4, e0, o0, lim)
    T = int(tiles.shape[0]) * 4
    walked = torch.zeros(1, dtype=torch.int32)
    for _ in range(int(tiles.shape[1]) * int(e0.shape[0]) + 1):
        if not bool(cs.unsettled(exits, sync, lim, d.sot, T).any()):
            return counts, exits, sync, fw, aux
        spare = torch.empty_like(exits)
        real = cs.sub_limits(lim, int(e0.shape[0]), T // int(e0.shape[0]))
        sync.masked_fill_(real.reshape(sync.shape) > 0, -1)
        cs.lane_repair_plain(mode, False, d.packed, d.segmap, tiles, d.sot,
                             lim, exits, spare, counts, sync, fw, aux,
                             walked)
        exits = spare
    raise AssertionError("full rescans did not settle")


@pytest.mark.parametrize("mode", [cs.MODE_COUNT, cs.MODE_SPAN])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("what", ["words", "quotes"])
def test_selective_repair_equals_full_rescans(what, k, mode):
    """The selective fixpoint (sub-lane passes, then lane passes) ends
    where full rescans of every sub-lane end: the same counts, exits and
    syncs of every sub-lane and the same flag words."""
    pattern = r'"[^"]*"' if what == "quotes" else r"\d+\.\d+\.\d+\.\d+"
    cd = _cd(pattern, spans=mode == cs.MODE_SPAN)
    d = (ss.DeviceSpanDFA if mode == cs.MODE_SPAN
         else cs.DeviceCountDFA).from_host(cd, "cpu")
    arr = _quotes(9000) if what == "quotes" else _corpus(11, 15000)
    L, T, W, _ = GEOM
    n = len(arr)
    dev = torch.from_numpy(arr.copy())
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(d.starts, dev, n, L, T, W, k)
    got, conv = cs.split_fixpoint(mode, cs.COUNT_KERNEL, d, tiles, W, e0,
                                  o0, lim, L + cs.SUB_PASSES)
    assert conv
    want = _full_rescan(mode, d, tiles, W, e0, o0, lim)
    _assert_real_equal(got, want, lim, T)


def _assert_real_equal(got, want, lim, T):
    """counts, exits, sync, flagw, aux equal; exits and sync only where
    the sub-lane holds corpus bytes (nothing reads the others, which the
    repair leaves as pass 0 wrote them)."""
    k = int(got[0].shape[0])
    real = cs.sub_limits(lim, k, T // k).reshape(k, -1) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None
        elif i in (1, 2):
            assert torch.equal(a[real], b[real])
        else:
            assert torch.equal(a, b)


def _rescan_every_lane(scan_once, entries0, offsets0, first_entry, real,
                       W: int, max_repair: int):
    """The unsplit repair (the reference's _count_full loop): run
    scan_once(entries, offsets) -> (..., exits, sync) until every real
    lane's post-warmup state equals the previous lane's exit, at most
    max_repair rescans of every lane, each entering lane l at lane l-1's
    exit with full warmup.  Returns (outputs of the last pass,
    converged)."""
    def want_of(exits):
        return torch.cat([first_entry.reshape(1).to(torch.int32),
                          exits[:-1]])

    out = scan_once(entries0, offsets0)
    full_w = torch.full_like(offsets0, W)
    k = 0
    while True:
        exits, sync = out[-2], out[-1]
        bad = bool((real & (want_of(exits) != sync)).any())
        if not bad or k >= max_repair:
            return out, not bad
        out = scan_once(want_of(exits).contiguous(), full_w)
        k += 1


def test_unsplit_repair_equals_rescans_of_every_lane():
    """At k = 1 the selective passes give the outputs of rescans of every
    lane, pass for pass (in the lanes that hold corpus bytes): here with
    the reference's bound of 4 rescans, which quote parity exceeds."""
    cd = _cd(r'"[^"]*"')
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    arr = _quotes(12000)
    L, T, W, _ = GEOM
    n = len(arr)
    dev = torch.from_numpy(arr.copy())
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(d.starts, dev, n, L, T, W)
    real = torch.arange(L) * T < n

    def scan_once(entries, offsets):
        return [x[0] for x in cs.count_lanes(
            d.packed, d.segmap, tiles, W // 4, entries[None], offsets, lim)]

    for max_repair in (0, 4, L):
        want, wconv = _rescan_every_lane(scan_once, e0[0], o0,
                                         d.starts[cs.CTX_SOT],
                                         real, W, max_repair)
        got, conv = cs.split_fixpoint(cs.MODE_COUNT, cs.COUNT_KERNEL, d,
                                      tiles, W, e0, o0, lim,
                                      max_repair)
        assert conv == wconv == (max_repair == L)
        _assert_real_equal(got[:3], [x[None] for x in want], lim, T)


@pytest.mark.parametrize("k", [4, 16])
def test_quote_parity_escalates_to_lane_passes(k):
    """Quote parity reaches back to the corpus start, so the sub-lane
    passes cannot settle it: the fixpoint escalates to whole-lane passes
    and the count is exact."""
    cd = _cd(r'"[^"]*"')
    arr = _quotes(16 * 1024)
    L, T, W, _ = GEOM
    before = (cs.COUNT_KERNEL.sub_passes, cs.COUNT_KERNEL.lane_passes)
    dev = torch.from_numpy(arr.copy())
    total, conv = cs.count_full(
        cs.DeviceCountDFA.from_host(cd, "cpu"), dev,
        cs.make_word_tiles(dev, L, T // 4), len(arr), L, T, W,
        max_repair=L + cs.SUB_PASSES, k=k)
    assert conv and int(total) == cd.count_scan(arr) == len(arr) // 600
    assert cs.COUNT_KERNEL.sub_passes - before[0] == cs.SUB_PASSES
    assert 0 < cs.COUNT_KERNEL.lane_passes - before[1] <= L


def test_words_settle_without_lane_passes():
    """A state that reaches back less than a sub-lane (a line's `^/` under
    `(?m)^/.*\\.php` on lines longer than the warmup) settles in sub-lane
    passes alone."""
    cd = _cd(r"(?m)^/.*\.php")
    line = b"/" + b"a" * 100 + b".php\n"
    arr = np.frombuffer((line * 200)[:16000], dtype=np.uint8)
    L, T, W, _ = GEOM
    before = (cs.COUNT_KERNEL.sub_passes, cs.COUNT_KERNEL.lane_passes)
    dev = torch.from_numpy(arr.copy())
    total, conv = cs.count_full(
        cs.DeviceCountDFA.from_host(cd, "cpu"), dev,
        cs.make_word_tiles(dev, L, T // 4), len(arr), L, T, W,
        max_repair=L + cs.SUB_PASSES, k=8)
    assert conv and int(total) == cd.count_scan(arr)
    assert cs.COUNT_KERNEL.sub_passes - before[0] >= 1
    assert cs.COUNT_KERNEL.lane_passes == before[1]


def test_state_at_end_picks_the_sub_lane_of_the_last_byte():
    L, T = 4, 256
    exits = torch.arange(4 * L, dtype=torch.int32).reshape(4, L)
    for n, (j, l) in ((1, (0, 0)), (64, (0, 0)), (65, (1, 0)), (256, (3, 0)),
                      (257, (0, 1)), (1024, (3, 3)), (0, (0, 0))):
        assert int(cs.state_at_end(exits, n, L, T)) == int(exits[j, l])
        assert int(cs.state_at_end(exits[:1], n, L, T)) == int(
            exits[0, min(max((n - 1) // T, 0), L - 1)])


# -- callers and checks ----------------------------------------------------------

def test_flag_and_match_scans_keep_one_walker_a_lane(monkeypatch):
    """K9 (a FULL_SCAN is_match) launches with entries [k, L] at
    lane_split's k of the corpus geometry, 2 for this 4 MiB corpus; K3
    (the reverse flag scan of a bidi find_all) at lane_split's k of its
    reset geometry, which is 1 for this 17,600-byte corpus."""
    seen = {}
    real = cs.lane_walk

    def walk(mode, counter, *args):
        seen.setdefault(mode, set()).add(tuple(args[4].shape))
        return real(mode, counter, *args)

    # K3's and K9's split_fixpoint call count_scan.lane_walk
    monkeypatch.setattr(cs, "lane_walk", walk)
    arr = np.frombuffer((b"ip 10.0.0.1 x 1.2.3.4 " * 800), dtype=np.uint8)
    ip = ct.compile(r"\d+\.\d+\.\d+\.\d+", device="cpu")
    assert ip.find_all_index(arr)[:2] == [(3, 11), (14, 21)]
    big = np.frombuffer(b"ip 10.0.0.1 x " * ((4 << 20) // 14),
                        dtype=np.uint8)
    full = ct.compile(r"\s\d\s", device="cpu")
    assert full.batch_engine().plan.strategy.name == "FULL_SCAN"
    assert full.is_match(big) is False
    _L, T, W, _ = flag_scan.reset_geometry(len(arr))
    assert cs.lane_split(T, W) == 1
    assert all(len(s) == 2 and s[0] == 1 for s in seen[cs.MODE_FLAG])
    L, T, W, _ = cs.plan_geometry(len(big))
    assert seen[cs.MODE_MATCH] == {(cs.lane_split(T, W), L)} == {(2, 8192)}


@pytest.mark.parametrize("mode,shape,W4,msg", [
    (cs.MODE_FLAG, (3, 16), 4, "power of two"),
    (cs.MODE_MATCH, (3, 16), 4, "power of two"),
    (cs.MODE_COUNT, (3, 16), 4, "power of two"),
    (cs.MODE_COUNT, (16, 16), 4, "divides"),
    (cs.MODE_SPAN, (8, 16), 9, "geometry"),
    (cs.MODE_COUNT, (2, 15), 4, "shape"),
])
def test_cuda_wrapper_rejects_bad_splits(mode, shape, W4, msg):
    """The wrapper refuses a split the kernel cannot walk before it builds
    or launches anything: k a power of two dividing T4/8 (for K9 too), a
    warmup within a sub-lane."""
    T4, L = 64, 16
    tiles = torch.zeros((T4, L), dtype=torch.int32)
    lanes = torch.zeros(L, dtype=torch.int32)
    seg = torch.zeros(256, dtype=torch.int32)
    packed = torch.zeros((4, 4), dtype=torch.int32)
    entries = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        cs.lane_walk_cuda(mode, packed, seg, tiles, W4, entries, lanes,
                          lanes)



def test_split_helpers_live_in_one_hashed_header(tmp_path, monkeypatch):
    """The split walks' seam limit and walker count are defined once, in
    split_common.cuh, which both split sources include and the library's
    name hashes."""
    from coregex_tpu_torch.ops import _build
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes(
            open(f"{_build.CSRC}/{name}", "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build.library_path()
    with open(tmp_path / "split_common.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before
    for src in ("lane_scan.cu", "needle_scan.cu"):
        text = open(tmp_path / src).read()
        assert '#include "split_common.cuh"' in text
        assert "int sub_limit(" not in text
        assert "void count_walker(" not in text
    assert "int sub_limit(" in open(tmp_path / "split_common.cuh").read()


@pytest.mark.parametrize("maps", [True, False], ids=["maps", "in_order"])
@pytest.mark.parametrize("mode", [cs.MODE_COUNT, cs.MODE_SPAN])
@pytest.mark.parametrize("what", ["words", "quotes"])
def test_lane_pass_equals_sequential_walk(what, mode, maps, monkeypatch):
    """The plain lane pass finds each sub-lane's entry by composing the
    sub-lanes' exit maps (or, past MAP_COLUMNS, by walking them in order)
    and then walks all sub-lanes at once: its outputs equal a walk of the
    sub-lanes one after another, each from the previous one's exit, from
    exits of which a third are random (some of them the count DFA's
    absorbing state 0, which no later byte leaves; quote parity never
    syncs); the corpus ends inside the last lane."""
    if not maps:
        monkeypatch.setattr(cs, "MAP_COLUMNS", 0)
    k = 8
    pattern = r'"[^"]*"' if what == "quotes" else r"\d+\.\d+\.\d+\.\d+"
    cd = _cd(pattern, spans=mode == cs.MODE_SPAN)
    d = (ss.DeviceSpanDFA if mode == cs.MODE_SPAN
         else cs.DeviceCountDFA).from_host(cd, "cpu")
    arr = _quotes(9000) if what == "quotes" else _corpus(12, 15000)
    L, T, W, _ = GEOM
    dev = torch.from_numpy(arr.copy())
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(d.starts, dev, len(arr), L, T, W, k)
    counts, exits, sync, fw, aux = cs.lane_walk_plain(
        mode, d.packed, d.segmap, tiles, W // 4, e0, o0, lim)
    g = torch.Generator().manual_seed(3)
    prev = torch.where(torch.rand(exits.shape, generator=g) < 1 / 3,
                       torch.randint(0, int(d.packed.shape[0]), exits.shape,
                                     generator=g, dtype=torch.int32), exits)
    got = [torch.empty_like(prev), counts.clone(), sync.clone(),
           None if fw is None else fw.clone(),
           None if aux is None else aux.clone(),
           torch.zeros(1, dtype=torch.int32)]
    cs.lane_repair_plain(mode, True, d.packed, d.segmap, tiles, d.sot, lim,
                         prev, *got)
    g_exits, g_counts, g_sync, g_fw, g_aux, walked = got
    T4k = T // 4 // k
    G = T4k // 8
    lsub = cs.sub_limits(lim, k, T // k).reshape(k, L)
    want = cs.want_of(prev, d.sot)
    lanes = ((lsub > 0) & (sync != want)).any(dim=0)
    assert lanes.any() and int(walked) == int(lanes.sum())
    tbl = d.packed.reshape(-1).long()
    seg = None if d.segmap is None else d.segmap.long()
    s = want[0].long()
    for j in range(k):
        c, s2, w, a = cs._walk_plain(
            mode, tbl, seg, int(d.packed.shape[1]),
            lambda t: tiles[j * T4k + t], T4k, s, lsub[j])
        for out, exp, old in ((g_counts, c, counts), (g_sync, s, sync),
                              (g_exits, s2, prev)):
            assert torch.equal(out[j], torch.where(lanes, exp.to(
                torch.int32), old[j]))
        for out, exp, old in ((g_fw, w, fw), (g_aux, a, aux)):
            if mode == cs.MODE_SPAN:
                rows = slice(j * G, (j + 1) * G)
                assert torch.equal(out[rows], torch.where(lanes, exp,
                                                          old[rows]))
        s = s2
