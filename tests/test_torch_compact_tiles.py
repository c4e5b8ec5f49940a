"""The launch plan and argument checks of csrc/compact.cu (K4 and K8, one
single-pass ordered compaction) and the compactions on masks at any byte
offset, against the JAX package on the CPU.

``_tile_plan`` is the kernel's launch arithmetic in Python: these tests hold
it to what the kernel needs (head, aligned body and tail cover the mask
exactly once; every bulk copy is 16-byte aligned in address and length; the
tiles cover the mask; shared memory fits a Hopper block).  The compactions
run their plain versions here, on offset views of seeded numpy masks,
against ``_compact_pay_xla`` / ``_compact_xla`` and, for two shapes, K4's
Pallas kernel in interpret mode.  Outputs are integers: exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.ops import compact as ref_k8
from coregex_tpu.ops import compact2 as ref_k4
from coregex_tpu_torch.ops import _build
from coregex_tpu_torch.ops import compact, compact2 as c2

torch.set_num_threads(1)

TILE = c2.TILE
RAGGED = [1, 15, 16, 17, 4095, 4096, 4097, TILE - 1, TILE, TILE + 1, 1 << 26,
          2 ** 31 - 1]


def _kernel_reads(plan, n: int):
    """The byte ranges csrc/compact.cu reads, tile by tile: [(tile, lo, hi,
    bulk)] in mask indices.  This restates the kernel's own arithmetic
    (``load_tile``'s bulk range and the head and tail byte groups at the top
    of the worker warps' branch in ``compact_kernel``) and must change with
    it: the tests here hold ``_tile_plan`` to this copy, not to the CUDA
    code, which only chip_smoke.py's sweep on the card exercises."""
    lead = -plan.head % 16
    body_end = plan.head + plan.body
    out = []
    for t in range(plan.tiles):
        t0 = t * TILE - lead
        if t == 0 and plan.head:
            out.append((t, max(t0, 0), min(t0 + 16, n), False))
        lo, hi = max(t0, plan.head), min(t0 + TILE, body_end)
        if hi > lo:
            out.append((t, lo, hi, True))
        if t == plan.tiles - 1 and body_end < n:
            g = body_end - t0
            out.append((t, max(t0 + g, 0), min(t0 + g + 16, n), False))
    return out


@pytest.mark.parametrize("offset", [0, 1, 7, 15])
@pytest.mark.parametrize("n", RAGGED)
def test_tile_plan_covers_the_mask_once(n, offset):
    plan = c2._tile_plan(offset, n)
    assert plan.head + plan.body + plan.tail == n
    assert 0 <= plan.head < 16 and 0 <= plan.tail < 16
    assert plan.body % 16 == 0
    if plan.body:
        assert (offset + plan.head) % 16 == 0
    reads = _kernel_reads(plan, n)
    # every byte of [0, n) read exactly once, nothing outside it
    covered = 0
    for t, lo, hi, bulk in reads:
        assert 0 <= lo < hi <= n
        assert lo == covered, f"gap or overlap at {lo} (tile {t})"
        covered = hi
        if bulk:
            assert (offset + lo) % 16 == 0 and (hi - lo) % 16 == 0
            assert hi - lo <= TILE
            # the copy lands on a 16-byte boundary of the tile buffer
            assert (lo - (t * TILE - (-plan.head % 16))) % 16 == 0
        else:
            assert hi - lo <= 16
    assert covered == n
    assert sum(hi - lo for _, lo, hi, bulk in reads if not bulk) \
        == plan.head + plan.tail
    assert {t for t, *_ in reads} == set(range(plan.tiles))
    assert plan.scratch_words == plan.tiles + 1
    # the dynamic shared memory a Hopper block may use: 227 KiB
    assert plan.smem <= 227 * 1024


def test_tile_plan_shared_memory_is_the_kernels():
    # TILE and _STAGE mirror kTile and kStage (the kernel refuses a tile
    # count made with another TILE); smem is kSmem, two tiles and two
    # rounds of staged int32 positions
    src = open(f"{_build.CSRC}/compact.cu").read()
    assert f"constexpr int kTile = {TILE // 1024} * 1024;" in src
    assert f"constexpr int kStage = {c2._STAGE};" in src
    assert "constexpr int kSmem = 2 * kTile + 2 * kStage * 4;" in src
    assert c2._tile_plan(0, 100).smem == 2 * TILE + 2 * c2._STAGE * 4


def _meta(n):
    return torch.empty(n, dtype=torch.uint8, device="meta")


@pytest.mark.parametrize("case,match", [
    ("bool mask", "uint8"),
    ("int8 mask", "uint8"),
    ("strided mask", "contiguous"),
    ("int64 payload", "int32"),
    ("strided payload", "int32"),
    ("short payload", r"\[n\]"),
    ("five payloads", "at most 4"),
    ("empty mask", "outside"),
    ("n = 2^31", "outside"),
])
def test_check_args_rejects(case, match):
    m = torch.ones(64, dtype=torch.uint8)
    pay = torch.zeros(64, dtype=torch.int32)
    mask, pays = {
        "bool mask": (m.bool(), []),
        "int8 mask": (m.to(torch.int8), []),
        "strided mask": (m[::2], []),
        "int64 payload": (m, [pay.long()]),
        "strided payload": (m[:32], [pay[::2]]),
        "short payload": (m, [pay[:63]]),
        "five payloads": (m, [pay] * 5),
        "empty mask": (m[:0], []),
        "n = 2^31": (_meta(2 ** 31), []),
    }[case]
    with pytest.raises(ValueError, match=match):
        c2._check_args(mask, pays)


def test_check_args_takes_offsets_and_the_largest_n():
    buf = torch.ones(80, dtype=torch.uint8)
    pay = torch.zeros(64, dtype=torch.int32)
    for o in range(16):
        c2._check_args(buf[o:o + 64], [pay] * 4)
    c2._check_args(_meta(2 ** 31 - 1), [])


def test_library_hash_covers_the_header(tmp_path, monkeypatch):
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes(
            open(f"{_build.CSRC}/{name}", "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build.library_path()
    with open(tmp_path / "compact_common.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before
    src = open(tmp_path / "compact.cu").read()
    assert '#include "compact_common.cuh"' in src
    assert '#include "compact_common.cuh"' in open(
        tmp_path / "compact_exp.cu").read()


def _offset_mask(seed: int, n: int, o: int, dens: float):
    """A uint8 view at byte offset o of a buffer whose bytes outside the
    view are set, and the same bytes as numpy."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random(n) < dens, rng.integers(1, 256, n), 0).astype(
        np.uint8)
    buf = np.ones(n + o + 5, dtype=np.uint8)
    buf[o:o + n] = m
    t = torch.from_numpy(buf)[o:o + n]
    assert t.storage_offset() == o
    return t, m, rng


def _caps(cnt: int, n: int):
    return sorted({c for c in (1, cnt - 1, cnt, cnt + 1, n + 5) if c >= 1})


def _eq(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(e))


@pytest.mark.parametrize("o", [1, 2, 3])
@pytest.mark.parametrize("n,dens", [(1, 1.0), (17, 0.5), (4097, 0.01),
                                    (70001, 0.3)])
def test_compact_pay_at_offsets_matches_xla(n, dens, o):
    mask, m, rng = _offset_mask(n + o, n, o, dens)
    npay = (n + o) % 5
    pays = [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(
        np.int32) for _ in range(npay)]
    cnt = int((m != 0).sum())
    for cap in _caps(cnt, n):
        got = c2.compact_pay(mask, [torch.from_numpy(p) for p in pays], cap)
        exp = ref_k4._compact_pay_xla_jit(
            jnp.asarray(m.view(np.int8)), tuple(jnp.asarray(p) for p in pays),
            cap, n)
        _eq(got, exp)
        assert int(got[-2]) == cnt and bool(got[-1]) == (cnt <= cap)


@pytest.mark.parametrize("o", [1, 2, 3])
@pytest.mark.parametrize("n,dens", [(1, 1.0), (16, 0.5), (4096, 0.002),
                                    (65537, 0.6)])
def test_compact_positions_at_offsets_matches_xla(n, dens, o):
    mask, m, _ = _offset_mask(3 * n + o, n, o, dens)
    cnt = int((m != 0).sum())
    for cap in _caps(cnt, n):
        pos, c = compact.compact_positions(mask, cap)
        epos, ec = ref_k8._compact_xla_jit(jnp.asarray(m.view(np.int8)), cap)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(epos))
        assert int(c) == int(ec) == cnt


@pytest.mark.parametrize("n,o,npay,dens", [
    (4 * ref_k4.R_DEF * 128 + 77, 1, 2, 0.01),
    (4 * ref_k4.R_DEF * 128 + 3, 3, 4, 0.4)])
def test_compact_pay_at_offsets_matches_pallas_interpret(n, o, npay, dens):
    mask, m, rng = _offset_mask(n, n, o, dens)
    pays = [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(
        np.int32) for _ in range(npay)]
    cap = int((m != 0).sum()) + 5
    got = c2.compact_pay(mask, [torch.from_numpy(p) for p in pays], cap)
    exp = ref_k4.compact_pay(jnp.asarray(m.view(np.int8)),
                             [jnp.asarray(p) for p in pays], cap,
                             interpret=True)
    _eq(got, exp)
