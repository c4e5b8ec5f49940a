"""coregex_tpu_torch line and hits scans (K5 and K6 plain versions) against
the JAX package on the CPU.

The same seeded corpora go through both packages: per-lane outputs against
the reference's Pallas kernels in interpret mode at its 8-lane x 64-byte
torture geometry, counts against its sequential host oracles at several
geometries, and the host stitching against the reference's loops.  Every
output is an integer, so the tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coregex_tpu.ops import line_scan as ref_ls
from coregex_tpu.ops.count_scan import corpus_word_tiles
from coregex_tpu.ops.seq_scan import line_count_host, multi_count_host
from coregex_tpu_torch.ops import line_scan as ls
from coregex_tpu_torch.ops.count_scan import plan_geometry

torch.set_num_threads(1)

SMALL_GEO = (8, 64, 8, 1)        # 8 lanes x 64 bytes, as tests/test_line_scan
GEOS = [SMALL_GEO, (16, 256, 64, 2), None]   # None: plan_geometry(n)


def _text(rng, alphabet, n):
    return bytes(rng.choice(alphabet) for _ in range(n))


def _t(data):
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def _lane_corpora(anchored):
    """Corpora that put needles, prefixes and newlines across the 64-byte
    lane seams, with an unterminated last line."""
    rng = random.Random(40 + anchored)
    out = []
    seam = bytearray(b"." * 300)
    seam[0] = ord("/")
    seam[62:64] = b"ab"           # needle ending at the first seam
    seam[100] = 10
    seam[101] = ord("/")
    seam[127:129] = b"ab"         # needle across the second seam
    seam[191] = 10                # newline at a lane's last byte
    seam[192] = ord("/")          # prefix at the next lane's byte 0
    seam[200:202] = b"ab"
    out.append(bytes(seam))
    for _ in range(5):
        t = _text(rng, b"ab/\n x", rng.randrange(380, 512))
        out.append(t.rstrip(b"\n") + b"xab")
    return out


@pytest.mark.parametrize("anchored", [False, True])
def test_line_lanes_match_reference_interpret(anchored):
    needles, prefix = [b"ab"], (b"/" if anchored else b"")
    ref = ref_ls.LineScanner(needles, prefix=prefix, anchored=anchored,
                             interpret=True)
    got_lanes = {}
    orig = ref._combine

    def grab(n, L, T, cnt, lnl, lpe, lhe, mpre, data_host):
        got_lanes["ref"] = (cnt, lnl, lpe, lhe, mpre)
        return orig(n, L, T, cnt, lnl, lpe, lhe, mpre, data_host)

    ref._combine = grab
    sc = ls.LineScanner(needles, prefix=prefix, anchored=anchored)
    for data in _lane_corpora(anchored):
        arr = np.frombuffer(data, dtype=np.uint8)
        exp = ref.count(jnp.asarray(arr), data_host=arr, geometry=SMALL_GEO)
        # [1, L]: one walker a lane
        outs = ls.line_lanes(*sc.lane_args(_t(data), SMALL_GEO))
        for g, e in zip(outs, got_lanes["ref"]):
            np.testing.assert_array_equal(g[0].numpy().astype(np.int64), e)
        assert sc._combine(len(data), 8, 64, *got_lanes["ref"], arr) == exp
        assert sc.count(_t(data), SMALL_GEO) == exp == \
            line_count_host(data, needles, prefix, anchored)


def _ref_hits_lanes(ref, data, geo):
    """The reference's per-lane K6 outputs (cnt, ov, fh, reach) in
    interpret mode, as HitsScanner.count computes them."""
    L, T, _W, Lc = geo
    dev = jnp.asarray(np.frombuffer(data, dtype=np.uint8))
    tiles = corpus_word_tiles(dev, L, T)
    heads = ref_ls._lane_heads(tiles, ref.M, L, Lc)
    outs = ref_ls._pallas_hits(ref.masks, ref.vals, heads, tiles,
                               groups=ref.groups, M=ref.M, T4=T // 4,
                               Tt4=min(64, T // 4), Lc=Lc, nw=ref.nw,
                               interpret=True)
    return [np.asarray(v).reshape(L).astype(np.int64) for v in outs]


@pytest.mark.parametrize("needles", [[b"delta", b"abort"],
                                     [b"ab", b"cd", b"abc"]])
def test_hits_lanes_match_reference_interpret(needles):
    rng = random.Random(len(needles))
    corpora = [b"xx deltabort yy delta abort" * 9,
               bytes(b"." * 60 + b"deltabort" + b"." * 131),
               b"." * 61 + b"abc" + b"." * 100 + b"cdab"]
    corpora += [_text(rng, b"abcd ", rng.randrange(300, 512))
                for _ in range(3)]
    ref = ref_ls.HitsScanner(needles, interpret=True)
    sc = ls.HitsScanner(needles)
    for data in corpora:
        exp_lanes = _ref_hits_lanes(ref, data, SMALL_GEO)
        got = sc.lanes(_t(data), SMALL_GEO)     # [1, L]: one walker a lane
        for g, e in zip(got, exp_lanes):
            np.testing.assert_array_equal(g[0].numpy().astype(np.int64), e)
        exp = ref.count(jnp.asarray(np.frombuffer(data, np.uint8)),
                        geometry=SMALL_GEO)
        assert sc.count(_t(data), SMALL_GEO) == exp
        if exp is not None:
            assert exp == multi_count_host(data, needles)


@pytest.mark.parametrize("geo", GEOS)
@pytest.mark.parametrize("case", [
    ([b"keyword"], b"", False, b"keyword xy\n"),
    ([b".txt", b".log"], b"", False, b"a.txt.logx\n /"),
    ([b".php"], b"/", True, b"/.phpx\n "),
    ([b"xy"], b"ab", True, b"abxy\n z"),
])
def test_line_count_matches_host_oracle(geo, case):
    needles, prefix, anchored, alphabet = case
    rng = random.Random(len(alphabet) * 100 + (geo or (0,))[0])
    sc = ls.LineScanner(needles, prefix=prefix, anchored=anchored)
    for _ in range(12):
        data = _text(rng, alphabet, rng.randrange(
            1, geo[0] * geo[1] if geo else 2000))
        g = geo or plan_geometry(len(data))
        assert sc.count(_t(data), g) == \
            line_count_host(data, needles, prefix, anchored), data


@pytest.mark.parametrize("geo", GEOS)
@pytest.mark.parametrize("needles", [[b"error"], [b"aa"],
                                     [b"GET", b"POST", b"PUT", b"DELETE"],
                                     [b"ab", b"a", b"ba"]])
def test_hits_count_matches_host_oracle(geo, needles):
    rng = random.Random(len(needles) * 7 + (geo or (0,))[0])
    sc = ls.HitsScanner(needles)
    exact = 0
    for _ in range(12):
        data = _text(rng, b"errorGETPOSTDLab \n", rng.randrange(
            1, geo[0] * geo[1] if geo else 2000))
        g = geo or plan_geometry(len(data))
        got = sc.count(_t(data), g)
        if got is not None:
            exact += 1
            assert got == multi_count_host(data, needles), data
    assert exact > 0


def _ref_cross_lane_loop(T, fh, reach):
    """The reference's cross-lane overlap loop (line_scan.py:603-610)."""
    run = ref_ls.NEG
    for i in range(len(fh)):
        base = i * T
        if fh[i] < (1 << 30) and run >= base + fh[i]:
            return True
        if reach[i] > ref_ls.NEG // 2:
            run = max(run, base + reach[i])
    return False


def test_cross_lane_overlap_matches_reference_loop():
    rng = np.random.default_rng(5)
    for _ in range(300):
        L, T = int(rng.integers(1, 12)), int(rng.integers(4, 40))
        fh = np.where(rng.random(L) < 0.6, rng.integers(0, T, L), 1 << 30)
        reach = np.where(rng.random(L) < 0.7,
                         rng.integers(0, T + 15, L), ref_ls.NEG)
        assert ls.cross_lane_overlap(T, fh, reach) == \
            _ref_cross_lane_loop(T, fh, reach)


@pytest.mark.parametrize("anchored", [False, True])
def test_combine_matches_reference(anchored):
    """The host stitching on arbitrary per-lane outputs, with the anchored
    prefix check at the lane bases vectorized."""
    rng = np.random.default_rng(6 + anchored)
    prefix = b"/a" if anchored else b""
    ref = ref_ls.LineScanner([b"xy"], prefix=prefix, anchored=anchored)
    sc = ls.LineScanner([b"xy"], prefix=prefix, anchored=anchored)
    NEG = ls.NEG
    for _ in range(200):
        L, T = int(rng.integers(1, 10)), int(rng.integers(4, 24))
        n = int(rng.integers(1, L * T + 1))
        data = rng.choice(np.frombuffer(b"/a\nx", np.uint8), n)

        def lane_pos():
            return np.where(rng.random(L) < 0.5, rng.integers(0, T, L), NEG)

        cnt = rng.integers(0, 3, L)
        mpre = np.where(rng.random(L) < 0.5, rng.integers(0, T, L), -1)
        args = (n, L, T, cnt, lane_pos(), lane_pos(), lane_pos(), mpre, data)
        assert sc._combine(*args) == ref._combine(*args)


def test_scope_gates():
    assert ls.LineScanner.supported([b"abc"], b"/")
    assert not ls.LineScanner.supported([b"a\nb"])
    assert not ls.LineScanner.supported([b"ab"], b"\n")
    assert not ls.HitsScanner.supported([b"a\x00"])
    assert not ls.HitsScanner.supported([b"x" * 14])
    assert not ls.HitsScanner.supported([b"a"] * 65)
    with pytest.raises(ValueError, match="scope"):
        ls.HitsScanner([b""])
