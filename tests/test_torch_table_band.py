"""The lane walk's and the window scan's tables of keyword lists (16-230
KB as int32) on the CPU: 16-bit table values, the block size and the
instance the residency rules give them.

Every mode's packed value is delta*32 + 5 flag bits, so a table of at
most ``count_scan.MAX16_ROWS`` rows holds them in 16 bits: an int16 tensor
that the kernels read as uint16 and the plain versions as ``& 0xFFFF``.
Here, at KB scale, with chip_smoke.py's band (``\\b(?:w1|...|wN)\\b`` over
``chip_smoke.big_words``):

* the 16-bit packing decodes to the int32 table, for every table a band
  list builds and for seeded tables of every mode, and is refused past
  MAX16_ROWS rows;
* the plain lane walks over a 16-bit table equal those over its int32
  table (pass 0 and both repair passes, k = 1, 4 and 16), and so do the
  window scan's plain forms;
* the port's CountScanner and ChunkScanner, on 16-bit tables, equal the
  reference's on its gather path for the 25- and 50-word lists (not its
  Pallas kernels in interpret mode, whose select trees unroll S x C);
* the place (shared memory at which value width, or global memory),
  block-size, row-pitch and stage-slice rules over the band's shapes.

Every output is a count, a flag word, a position or a state: the tolerance
is bit-equality.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.countdfa import build_count_dfa as ref_build_count
from coregex_tpu.dfa.determinize import determinize as ref_determinize
from coregex_tpu.nfa.thompson import compile_nfa as ref_compile_nfa
from coregex_tpu.ops import count_scan as ref_cs
from coregex_tpu.ops import dfa_scan as ref_ds
from coregex_tpu.syntax.parser import parse as ref_parse

import chip_smoke
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import dfa_scan as ds

torch.set_num_threads(1)

GEOM = (16, 1024, 16)     # L, T, W: 16 lanes of 1 KiB
MODES = {"count": cs.MODE_COUNT, "span": cs.MODE_SPAN, "flag": cs.MODE_FLAG,
         "match": cs.MODE_MATCH, "reset": cs.MODE_RESET}


@pytest.fixture(scope="module")
def band():
    """(the band's patterns by name, a 64 KiB corpus of its base)."""
    base = chip_smoke.build_base(size=chip_smoke.BIG_CUT + (64 << 10))
    tile = chip_smoke.big_cut(base)
    return (dict(chip_smoke.band_patterns(tile)),
            np.frombuffer(tile[:64 << 10], np.uint8))


def _seeded(seed, S, nseg):
    """An [S, nseg] packed table: next state * 32 + 5 flag bits."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, S, (S, nseg)) * 32
            + rng.integers(0, 32, (S, nseg))).astype(np.int32)


# -- the 16-bit packing ------------------------------------------------------

@pytest.mark.parametrize("S, nseg", [(1, 1), (3, 5), (517, 64),
                                     (cs.MAX16_ROWS, 128)])
def test_pack16_decodes_to_the_int32_table(S, nseg):
    """pack16's int16 bits read back (table_values, wide) as the int32
    values; packed_device stores such a table as int16."""
    x = _seeded(S * nseg, S, nseg)
    t = cs.packed_device(x, "cpu")
    assert t.dtype == torch.int16 and tuple(t.shape) == (S, nseg)
    assert cs.value_bytes(S) == 2
    np.testing.assert_array_equal(cs.table_values(t).numpy(),
                                  x.reshape(-1))
    w = cs.wide(t)
    assert w.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), x)


def test_pack16_is_refused_past_its_rows():
    """S >= 2048 rows (a value delta*32 + 31 past 2^16) stays int32, and
    pack16 and the wrappers' checks refuse a 16-bit table of that size."""
    x = _seeded(1, cs.MAX16_ROWS + 1, 4)
    assert cs.value_bytes(cs.MAX16_ROWS + 1) == 4
    with pytest.raises(ValueError, match="at most"):
        cs.pack16(x)
    with pytest.raises(ValueError, match=r"\[0, 2\^16\)"):
        cs.pack16(np.array([[1 << 16]], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 2\^16\)"):
        cs.pack16(np.array([[-1]], np.int32))
    t = cs.packed_device(x, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), x)
    bad = torch.zeros((cs.MAX16_ROWS + 1, 4), dtype=torch.int16)
    L, T, W = GEOM
    lanes = torch.zeros(L, dtype=torch.int32)
    tiles = torch.zeros((T // 4, L), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-bit"):
        cs._check_lane_args(cs.MODE_FLAG, bad, None, tiles, W // 4,
                            lanes[None], lanes, lanes)


@pytest.mark.parametrize("name", ["KW25", "KW50"])
def test_band_tables_are_16_bit(monkeypatch, band, name):
    """Every table a band list's routes take (count, span, flag, fwd_all,
    rev_all, the window scan's ends table) is stored as int16 and decodes
    to the int32 table the host built."""
    pats, _ = band
    built = []
    pack = cs.pack16

    def spy(x):
        out = pack(x)
        built.append((np.asarray(x).astype(np.int64), out))
        return out
    monkeypatch.setattr(cs, "pack16", spy)
    be = ct.compile(pats[name], device="cpu").batch_engine()
    tabs = chip_smoke.band_tables(be, "cpu")
    assert [k for k, _m, _t in tabs] == ["count", "span", "flag", "fwd_all",
                                         "rev_all", "ends"]
    for x, out in built:
        np.testing.assert_array_equal(
            out.view(np.uint16).astype(np.int64), x)
    for kind, _mode, t in tabs:
        assert t.packed.dtype == torch.int16, kind
        vals = cs.table_values(t.packed).numpy()
        assert any(x.shape == tuple(t.packed.shape)
                   and np.array_equal(x.reshape(-1), vals)
                   for x, _ in built), kind


# -- the plain walks over 16-bit and int32 tables -----------------------------

def _mode_inputs(mode, corpus, nseg, k, seed):
    """Pass-0 arguments after the table: (segmap, tiles, W4, entries,
    offsets, limits) over GEOM at k sub-lanes a lane.  Bytes for the modes
    with a byte map, symbols below nseg for K3, and the reset mode's
    column << 3 | context << 1 | reset bytes (a reset at 1 % of them)."""
    L, T, W = GEOM
    rng = np.random.default_rng(seed)
    n = L * T - 100
    if mode == cs.MODE_FLAG:
        sym = rng.integers(0, nseg, n)
    elif mode == cs.MODE_RESET:
        sym = (rng.integers(0, nseg, n) << 3 | rng.integers(0, 4, n) << 1
               | (rng.random(n) < 0.01))
    else:
        sym = corpus[:n]
    data = torch.from_numpy(np.asarray(sym, np.uint8).copy())
    tiles = cs.make_word_tiles(data, L, T // 4)
    if mode == cs.MODE_RESET:
        segmap = torch.from_numpy(rng.integers(0, 8, 4).astype(np.int32))
    elif mode == cs.MODE_FLAG:
        segmap = None
    else:
        segmap = torch.from_numpy(rng.integers(0, nseg, 256)
                                  .astype(np.int32))
    entries = torch.from_numpy(rng.integers(0, 8, (k, L)).astype(np.int32))
    offsets = torch.zeros(L, dtype=torch.int32)
    offsets[0] = W
    limits = torch.full((L,), T, dtype=torch.int32)
    limits[-1] = n - (L - 1) * T
    return segmap, tiles, W // 4, entries, offsets, limits


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_walks_equal_over_16_and_32_bits(band, mode, k):
    """lane_walk_plain and both repair passes (lane_repair_plain, sub-lane
    and lane) over a seeded 16-bit table equal them over its int32 table,
    every output bit-equal.  1500 rows: values past 2^15, which int16
    holds as negative bits."""
    m = MODES[mode]
    _, corpus = band
    S, nseg = 1500, 32 if m == cs.MODE_RESET else 64
    x = _seeded(17 + m, S, nseg)
    narrow, wide = cs.packed_device(x, "cpu"), torch.from_numpy(x)
    assert narrow.dtype == torch.int16
    rest = _mode_inputs(m, corpus, nseg, k, 5 + m)
    outs = []
    for t in (narrow, wide):
        args = (t,) + rest
        d = SimpleNamespace(packed=t, segmap=rest[0], sot=3)
        run = chip_smoke.repair_case(m, d, args)
        outs.append([cs.lane_walk_plain(m, *args)]
                    + [run(cs.lane_repair_plain, whole)
                       for whole in (False, True)])
    for a, b in zip(*outs):
        assert chip_smoke.max_abs_err(a, b) == 0


def test_window_forms_equal_over_16_and_32_bits(band):
    """window_flags_plain and window_ends_plain over KW50's general
    find_all ends table as stored (16-bit) equal them over the table
    widened to int32, forward and reverse."""
    pats, corpus = band
    be = ct.compile(pats["KW50"], device="cpu").batch_engine()
    rev, fwd = be._full_scan_route()
    assert fwd.packed.dtype == torch.int16
    data = torch.from_numpy(corpus.copy())
    n = int(data.shape[0])
    starts = torch.from_numpy(np.random.default_rng(3).integers(
        0, n + 1, 3000).astype(np.int32))
    for reverse in (False, True):
        a = ds.window_args(fwd, data, starts, None, 64, reverse)
        w = (cs.wide(a[0]),) + a[1:]
        for fn in (ds.window_flags_plain, ds.window_ends_plain):
            assert chip_smoke.max_abs_err(fn(*a), fn(*w)) == 0
        ds._check_window_args(*a[:5], *a[6:])


# -- the scanners on 16-bit tables against the reference ---------------------

@pytest.mark.parametrize("name", ["KW25", "KW50"])
def test_scanners_equal_the_reference_gather_path(band, name):
    """CountScanner (K1's plain walk) and ChunkScanner (K9's) on the
    list's 16-bit tables equal the reference's CountScanner and
    ChunkScanner (impl="gather") on the same DFAs, repairs included."""
    pats, corpus = band
    nfa = ref_compile_nfa(ref_parse(pats[name]), with_captures=False,
                          ascii_only=True)
    cd = ref_build_count(ref_determinize(nfa, anchored=False,
                                         break_at_match=True))
    cd = cd.without_spans().minimized()
    sc = cs.CountScanner(cd, "cpu")
    assert sc.dcd.packed.dtype == torch.int16
    rsc = ref_cs.CountScanner(cd, impl="gather")
    fwd = ref_determinize(ref_compile_nfa(ref_parse(pats[name]),
                                          with_captures=False),
                          anchored=False, break_at_match=False)
    ch = ds.ChunkScanner(ds.DFATables.from_dense(fwd), "cpu")
    assert ch.mt.packed.dtype == torch.int16
    rch = ref_ds.ChunkScanner(ref_ds.DeviceDFA.from_dense(fwd),
                              impl="gather")
    for n in (4096, 40000):
        arr = corpus[:n]
        assert sc.count(torch.from_numpy(arr.copy())) == \
            rsc.count(jnp.asarray(arr)) == cd.count_scan(arr)
        got, gexit = ch.scan(torch.from_numpy(arr.copy()))
        want, wexit = rch.scan(jnp.asarray(arr))
        np.testing.assert_array_equal(got, np.asarray(want))
        assert gexit == wexit


# -- the residency rules over the band's shapes -------------------------------

# (list, count table K1, fwd_all table K9, general find_all ends table) as
# the port builds them for the band over chip_smoke.big_words, and KW_HUGE's
BAND_SHAPES = [("KW10", (67, 51), (74, 51), (72, 51)),
               ("KW25", (137, 59), (150, 59), (148, 59)),
               ("KW50", (265, 64), (291, 64), (288, 64)),
               ("KW100", (443, 64), (513, 64), (517, 64)),
               ("KW150", (589, 64), (720, 64), (700, 64)),
               ("KW200", (716, 64), (906, 64), (907, 64)),
               ("KW400", (1282, 64), (1716, 64), (1716, 64)),
               ("KW_HUGE", (2677, 64), (3980, 64), (3980, 64))]


@pytest.mark.parametrize("name, count, fwd_all, ends", BAND_SHAPES)
def test_band_residency(name, count, fwd_all, ends):
    """K1 and K9 of every band list keep MIN_SHARED_WARPS warps an SM or
    more: 16-bit tables in shared memory at the block size lane_block picks
    (128 threads where 16 blocks fit, up to 1024), KW_HUGE's int32 ones in
    global memory at 128 threads; as int32 at 128 threads (the parent's
    rule) a 50-word list or larger keeps fewer warps.  The window scan's
    block of 1024 threads holds the table in shared memory up to KW200
    (int32, a 16-bit table widened, up to KW50 at 1024-byte slices), at
    the slice the starts want where either width fits, and reads it from
    global memory for KW400 and KW_HUGE."""
    for mode, (S, nseg) in ((cs.MODE_COUNT, count),
                            (cs.MODE_MATCH, fwd_all)):
        vb = cs.value_bytes(S)
        shared = cs.table_fits(S, nseg, mode)
        smem = cs.lane_smem_bytes(mode, S, nseg, vb if shared else 0)
        th, warps = cs.lane_block(smem)
        assert warps >= cs.MIN_SHARED_WARPS and th in cs.LANE_THREADS
        assert cs.lane_warps(smem) == warps
        assert cs.lane_instance(mode, S, nseg) == ("shared" if shared
                                                   else "global")
        if name == "KW_HUGE":
            assert (vb, shared, th, warps) == (4, False, 128, 64)
            continue
        assert vb == 2 and shared
        if smem <= cs.SM_SMEM // 16 - cs.BLOCK_RESERVED:
            assert (th, warps) == (128, 64)
        # the parent's rule: an int32 table in shared memory at 128 threads
        old = min(16, cs.SM_SMEM // (-(-(S * nseg * 4 + 1024) // 128) * 128
                                    + cs.BLOCK_RESERVED)) * 4
        if S * nseg * 4 + 1024 > 50 << 10:
            assert old < warps

    def fits(width, stage):
        return ds.window_smem_bytes(width, *ends, stage) <= cs.SMEM_LIMIT
    for stage in ds.WINDOW_STAGES:
        plan = ds.window_plan(*ends, stage=stage)
        assert plan.shared is (name not in ("KW400", "KW_HUGE"))
        assert ds.window_fits(*ends) is plan.shared
        if not plan.shared:
            assert plan.stage == stage
            continue
        # the wanted slice where either width fits, int32 first
        assert plan.stage == (stage if fits(2, stage) else
                              ds.WINDOW_STAGES[-1])
        assert plan.width == (4 if fits(4, plan.stage) else 2)
    # at 1024-byte slices int32 up to KW50, 16-bit for KW100-KW200
    assert ds.window_plan(*ends, stage=1024).width == (
        4 if name in ("KW10", "KW25", "KW50") else
        2 if name in ("KW100", "KW150", "KW200") else 0)


@pytest.mark.parametrize("nseg, width, pitch", [
    (64, 4, 65), (65, 4, 65), (13, 4, 13), (64, 2, 66), (66, 2, 66),
    (51, 2, 51), (128, 2, 130), (32, 4, 33), (64, 0, 64)])
def test_row_pitch_skews_even_rows(nseg, width, pitch):
    """lane_pitch: a row of a table in shared memory spans an odd number
    of words (or, 16-bit with an odd nseg, a half word more), so one
    column of two rows lies in two banks; global memory keeps nseg."""
    got = cs.lane_pitch(nseg, width) if width else nseg
    assert got == pitch
    if width:
        assert got >= nseg and got - nseg <= 2
        assert (got * width) % 8 != 0


@pytest.mark.parametrize("n, B, W, stage", [
    (1610608640, 54772224, 64, 2048),    # `\b\d+\b`: 30 bytes apart
    (1610608640, 1 << 26, 64, 1024),     # a keyword list's first 2^26
    (1610608640, 41312512, 64, 2048),    # KW10: 39 bytes apart
    (4 << 20, 16, 256, 2048),            # find_first's 16 reverse lanes
    (29 * 1024, 1024, 64, 1024)])
def test_window_stage_by_density(n, B, W, stage):
    """window_stage: 1024-byte slices where 32 starts n / B bytes apart,
    the window and the chunks' alignment fit in them, else 2048."""
    assert ds.window_stage(n, B, W) == stage


@pytest.mark.parametrize("smem, block", [
    (1024, (128, 64)),          # a headline table: 16 blocks of 128
    (13 << 10, (128, 64)),
    (20 << 10, (256, 64)),
    (60 << 10, (1024, 64)),
    (120 << 10, (1024, 32)),
    (cs.SMEM_LIMIT, (1024, 32)),
    (cs.SMEM_LIMIT + 1, (0, 0))])
def test_lane_block_rule(smem, block):
    """lane_block: the smallest block that keeps the most warps, by
    shared memory (at most 32 registers a thread)."""
    assert cs.lane_block(smem) == block
