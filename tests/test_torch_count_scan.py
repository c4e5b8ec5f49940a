"""coregex_tpu_torch count scan (K1 and its plain version) against the JAX
package's count scan on the CPU.

Inputs are seeded numpy corpora fed to both packages; every output is an
integer, so the tolerance is exact equality.  The JAX side runs its
impl="gather" path, and once its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.countdfa import build_count_dfa
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import count_scan as ref
from coregex_tpu.syntax.parser import parse
from coregex_tpu_torch.ops import count_scan as cs

torch.set_num_threads(1)

PATTERNS = [
    r"\d+\.\d+\.\d+\.\d+",
    r"(?m)^/.*\.php",
    r".*keyword.*",
    r"[\w]+",
    r"error",
    r"\bword\b",
    r"a+b",
]
ALPHABET = np.frombuffer(b"ab.0123456789 keyword/xyzphtw\nerror",
                         dtype=np.uint8)


def _cd(pattern):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    assert cd is not None
    return cd.without_spans().minimized()


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    return ALPHABET[rng.integers(0, len(ALPHABET), n)]


@pytest.mark.parametrize("n", [0, 1, 63, 4096, 4097, 70000, 1 << 24,
                               1610612736, 1610612736 + 33])
def test_geometry_identical(n):
    assert cs.size_bucket(n) == ref.size_bucket(n)
    assert cs.plan_geometry(n) == ref.plan_geometry(n)
    assert cs.plan_geometry(n, lc=128) == ref.plan_geometry(n, lc=128)


@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_word_tiles_match_reference(n):
    arr = _corpus(n, n)
    L, T, _W, _Lc = cs.plan_geometry(n)
    exp = np.asarray(ref._make_word_tiles(jnp.asarray(arr), L, T // 4))
    got = cs.make_word_tiles(torch.from_numpy(arr.copy()), L, T // 4)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), exp.reshape(T // 4, L))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_match_reference(pattern):
    cd = _cd(pattern)
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    r = ref.DeviceCountDFA(cd)
    np.testing.assert_array_equal(d.packed.numpy(), r.packed_host)
    # the byte map replaces the reference's boundary compares
    exp_seg = np.searchsorted(r.bounds_host, np.arange(256), side="right")
    np.testing.assert_array_equal(d.segmap.numpy(), exp_seg)
    np.testing.assert_array_equal(d.eoi.numpy(), cd.eoi_commits)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_count_matches_reference(pattern):
    cd = _cd(pattern)
    sc = cs.CountScanner(cd, "cpu")
    rsc = ref.CountScanner(cd, impl="gather")
    for seed, n in enumerate([0, 1, 3, 255, 4096, 9999, 40000]):
        arr = _corpus(seed, n)
        got = sc.count(torch.from_numpy(arr.copy()))
        exp = rsc.count(jnp.asarray(arr))
        assert got == exp == cd.count_scan(arr), (pattern, n)


@pytest.mark.parametrize("pattern,data", [
    (r"\d+\.\d+\.\d+\.\d+",
     b"ip 10.1.2.3 and 192.168.0.255 plus 1.2.3.4.5.6 " * 200),
    (r"a+b", b"a" * 5000 + b"b" + b"a" * 3000 + b"b" + b"c" * 100),
    (r"\d+\.\d+\.\d+\.\d+", b"x" * 500 + b"10.0.0.1"),
])
def test_count_full_matches_reference_many_lanes(pattern, data):
    """Tiny tiles -> many lane seams: totals, convergence and repair
    behaviour (including honest non-convergence) agree."""
    cd = _cd(pattern)
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    L, T, W, Lc = cs.plan_geometry(n, lc=128)
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    dev = torch.from_numpy(arr.copy())
    total, conv = cs.count_full(d, dev, cs.make_word_tiles(dev, L, T // 4),
                                n, L, T, W)
    r = ref.DeviceCountDFA(cd)
    jdev = jnp.asarray(arr)
    rtot, rconv = ref._count_full(
        r.packed, r.packed_rc, r.bounds, r.starts, r.eoi, jdev,
        ref._make_word_tiles(jdev, L, T // 4), n, L=L, T=T, W=W, S=r.S,
        NSEG=r.NSEG, NB=r.NB, Tt4=min(64, T // 4), Lc=Lc, impl="gather")
    assert conv == bool(rconv)
    assert int(total) == int(rtot)
    if conv:
        assert int(total) == cd.count_scan(arr)


def test_lane_walk_matches_pallas_interpret():
    """One pass of the plain lane walk against the Mosaic kernel run in
    interpret mode, on identical entries, offsets and limits."""
    cd = _cd(r"[\w]+")
    arr = _corpus(7, 2000)
    n = len(arr)
    L, T, W, Lc = cs.plan_geometry(n, lc=128)
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    dev = torch.from_numpy(arr.copy())
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(d.starts, dev, n, L, T, W)
    counts, exits, sync = (x[0] for x in cs.count_lanes(
        d.packed, d.segmap, tiles, W // 4, e0, o0, lim))
    r = ref.DeviceCountDFA(cd)
    T4, W4 = T // 4, W // 4
    jt = jnp.asarray(tiles.numpy().reshape(T4, 8, Lc))
    warm = jnp.roll(jt[T4 - W4:].reshape(W4, L), 1, axis=1).reshape(
        W4, 8, Lc)

    def lanes(x):
        return jnp.asarray(x.numpy().reshape(8, Lc))

    rc, rx, rs = ref._pallas_count_once(
        r.packed_rc, r.bounds, jt, warm, lanes(e0), lanes(o0), lanes(lim),
        S=r.S, NSEG=r.NSEG, NB=r.NB, T4=T4, Tt4=min(64, T4), W4=W4, Lc=Lc,
        col_of=r.col_of, row_of=r.row_of, R=r.R, Cp=r.Cp, interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc).reshape(L))
    np.testing.assert_array_equal(exits.numpy(), np.asarray(rx).reshape(L))
    np.testing.assert_array_equal(sync.numpy(), np.asarray(rs).reshape(L))


def test_cuda_wrapper_validates_before_launch():
    """The CUDA wrapper rejects what the kernel cannot take before it
    builds or launches anything: a wrong dtype, mismatched lane shapes.  A
    table over the shared-memory limit passes: the kernel reads it from
    global memory."""
    L, T4 = 1024, 64
    tiles = torch.zeros((T4, L), dtype=torch.int32)
    lanes = torch.zeros(L, dtype=torch.int32)
    seg = torch.zeros(256, dtype=torch.int32)
    big = torch.zeros((4096, 64), dtype=torch.int32)
    cs._check_lane_args(cs.MODE_COUNT, big, seg, tiles, 16, lanes[None],
                        lanes, lanes)
    assert cs.lane_instance(cs.MODE_COUNT, 4096, 64) == "global"
    ok = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cs.lane_walk_cuda(cs.MODE_COUNT, ok, seg, tiles.long(), 16, lanes,
                          lanes, lanes)
    with pytest.raises(ValueError, match="shape"):
        cs.lane_walk_cuda(cs.MODE_COUNT, ok, seg, tiles, 16, lanes[:-1],
                          lanes, lanes)
    assert cs.table_fits(128, 64) and not cs.table_fits(4096, 64)


def test_tables_too_large_for_the_kernel_raise_at_build():
    """A table the kernels cannot index with int32 raises ValueError before
    anything reaches the device, on any device; a table past shared memory
    builds and takes the kernels' global-memory instance."""
    huge = np.broadcast_to(np.zeros((1, 64), np.int32), (2 ** 25, 64))
    args = (huge, np.zeros(256, np.int32), np.zeros(4, np.int32),
            np.broadcast_to(np.zeros((1, 4), np.int32), (2 ** 25, 4)))
    for dev in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="int32"):
            cs.DeviceCountDFA(*args, dev)
    big = np.zeros((4096, 64), dtype=np.int32)
    d = cs.DeviceCountDFA(big, np.zeros(256, np.int32),
                          np.zeros(4, np.int32),
                          np.zeros((4096, 4), np.int32), "cpu")
    assert d.S == 4096 and cs.lane_instance(cs.MODE_COUNT, d.S,
                                            d.NSEG) == "global"


def test_count_scanner_repairs_until_settled():
    """Quote parity defeats the reference's 4 repair passes; the scanner
    repairs until the fixpoint holds and gives the sequential count."""
    cd = _cd(r'"[^"]*"')
    arr = np.frombuffer((b'"' + b"x" * 299) * 100, dtype=np.uint8)
    dev = torch.from_numpy(arr.copy())
    n = len(arr)
    L, T, W, _Lc = cs.plan_geometry(n)
    d = cs.DeviceCountDFA.from_host(cd, "cpu")
    _total, conv = cs.count_full(d, dev, cs.make_word_tiles(dev, L, T // 4),
                                 n, L, T, W)
    assert not conv
    assert cs.CountScanner(cd, "cpu").count(dev) == cd.count_scan(arr) == 50
