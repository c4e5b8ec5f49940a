"""coregex_tpu_torch.ops.compact_exp (K10's plain version and its
dispatch) against the JAX compaction rig on the CPU: the rig's Pallas
kernel in interpret mode (tools/_compact_exp.py:compact_exp) on the rig's
own check cases, then np.flatnonzero on more shapes, payload counts and
masks, the errors, and the torch rig's command-line tool
(tools/profile_compact_torch.py) in its CPU check.  Positions, payloads
and counts are integers: exact equality below the count, and past it
positions equal n (payloads there are 0 in the port, undefined in the
rig)."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu_torch.ops import compact_exp as ce

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_rig = _load("_compact_exp")
torch_rig = _load("profile_compact_torch")


def _case(seed, R, nc, dens, npay):
    rng = np.random.default_rng(seed)
    n = nc * R * 128
    mask = (rng.random(n) < dens).astype(np.int8)
    pays = [rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int32)
            for _ in range(npay)]
    return mask, pays


def _check(out, mask, pays, cap):
    exp = np.flatnonzero(mask)
    *got, cnt = (o.numpy() for o in out)
    pos, gp = got[0], got[1:]
    assert pos.dtype == np.int32 and pos.shape == (cap,)
    assert int(cnt) == len(exp)
    k = min(cap, len(exp))
    np.testing.assert_array_equal(pos[:k], exp[:k])
    assert (pos[k:] == len(mask)).all()
    assert len(gp) == len(pays)
    for g, p in zip(gp, pays):
        np.testing.assert_array_equal(g[:k], p[exp[:k]])
        assert (g[k:] == 0).all()


# the rig's check cases (profile_compact.py:104-128): R, blocks, density,
# one payload, plain and with cond_dma + skip_empty
RIG_CASES = [(128, 2, 0.001, {}), (256, 1, 0.05, {}),
             (128, 1, 0.5, {}), (256, 3, 0.0, {}),
             (128, 3, 0.001, dict(cond_dma=True, skip_empty=True)),
             (256, 2, 0.05, dict(cond_dma=True, skip_empty=True)),
             (128, 2, 0.5, dict(cond_dma=True, skip_empty=True)),
             (256, 1, 0.0, dict(cond_dma=True, skip_empty=True))]


@pytest.mark.parametrize("R,nc,dens,kw", RIG_CASES)
def test_plain_matches_rig_kernel(R, nc, dens, kw):
    mask, pays = _case(nc * 7 + R, R, nc, dens, 1)
    nh = int(mask.sum())
    cap = max(16, -(-nh // 16) * 16 + 16)
    ref = ref_rig.compact_exp(jnp.asarray(mask), jnp.asarray(pays[0]),
                              cap=cap, R=R, npay=1, interpret=True, **kw)
    rpos, rpay, rcnt = (np.asarray(o) for o in ref)
    got = ce.compact_exp(torch.from_numpy(mask), torch.from_numpy(pays[0]),
                         cap=cap, R=R, npay=1, **kw)
    pos, pay, cnt = (o.numpy() for o in got)
    assert int(cnt) == int(rcnt) == nh
    np.testing.assert_array_equal(pos, rpos)      # padded with n alike
    np.testing.assert_array_equal(pay[:nh], rpay[:nh])
    _check(got, mask, pays, cap)


def _tiled_mask(seed, R, nc, kinds):
    """nc tiles of CH = R*128 entries, each all zero, all one or random at
    density 0.02, drawn from `kinds` with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    ch = R * 128
    pick = rng.integers(0, len(kinds), nc)
    mask = np.zeros((nc, ch), dtype=np.int8)
    for i, kd in enumerate(kinds):
        rows = pick == i
        if kd == "one":
            mask[rows] = 1
        elif kd == "random":
            mask[rows] = rng.random((int(rows.sum()), ch)) < 0.02
    return mask.reshape(-1)


# tiles in mixed kinds, the first four of each case named; at R = 128 the
# persistent grid has 132 SMs x 4 blocks (R = 256: x 2, R = 512: x 1) on an
# H100, so these hold more tiles than blocks
@pytest.mark.parametrize("R,nc", [(128, 600), (256, 300), (512, 150)])
def test_plain_many_tiles(R, nc):
    """More tiles than a persistent grid has blocks, mixing all-zero,
    all-one and random tiles, one payload, caps over and under the
    count, plain and with cond_dma + skip_empty."""
    mask = _tiled_mask(R + nc, R, nc, ["zero", "one", "random"])
    mask[:3 * R * 128] = np.repeat(np.int8([0, 1, 0]), R * 128)
    rng = np.random.default_rng(nc)
    pays = [rng.integers(-2 ** 31, 2 ** 31 - 1, len(mask), dtype=np.int32)]
    nh = int(mask.sum())
    for cap in (nh + 16, nh // 3):
        for kw in ({}, dict(cond_dma=True, skip_empty=True)):
            out = ce.compact_exp(torch.from_numpy(mask),
                                 torch.from_numpy(pays[0]), cap=cap, R=R,
                                 npay=1, **kw)
            _check(out, mask, pays, cap)


@pytest.mark.parametrize("kw", [{}, dict(cond_dma=True, skip_empty=True)])
def test_plain_matches_rig_kernel_zero_one_tiles(kw):
    """All-zero and all-one tiles between random ones against the rig's
    Pallas kernel in interpret mode, with one payload."""
    R = 128
    mask = _tiled_mask(3, R, 4, ["random"])
    ch = R * 128
    mask[:ch] = 0
    mask[ch:2 * ch] = 1
    mask[3 * ch:] = 0
    pay = np.random.default_rng(4).integers(-2 ** 31, 2 ** 31 - 1, len(mask),
                                            dtype=np.int32)
    nh = int(mask.sum())
    cap = -(-nh // 16) * 16 + 16
    rpos, rpay, rcnt = (np.asarray(o) for o in ref_rig.compact_exp(
        jnp.asarray(mask), jnp.asarray(pay), cap=cap, R=R, npay=1,
        interpret=True, **kw))
    got = ce.compact_exp(torch.from_numpy(mask), torch.from_numpy(pay),
                         cap=cap, R=R, npay=1, **kw)
    pos, gpay, cnt = (o.numpy() for o in got)
    assert int(cnt) == int(rcnt) == nh
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(gpay[:nh], rpay[:nh])
    _check(got, mask, [pay], cap)


@pytest.mark.parametrize("npay", [0, 1, 2])
@pytest.mark.parametrize("R", [128, 256, 512])
@pytest.mark.parametrize("kind", ["random", "ones", "zeros"])
def test_plain_matches_flatnonzero(npay, R, kind):
    nc = 2 if R < 512 else 1
    mask, pays = _case(R + npay, R, nc, 0.03, npay)
    if kind == "ones":
        mask[:] = 1
    elif kind == "zeros":
        mask[:] = 0
    nh = int(mask.sum())
    args = [torch.from_numpy(p) for p in pays]
    for cap in {max(16, nh + 16), max(1, nh // 3)}:
        out = ce.compact_exp(torch.from_numpy(mask != 0), *args, cap=cap,
                             R=R, npay=npay, skip_empty=kind == "random")
        _check(out, mask, pays, cap)


@pytest.mark.parametrize("n,kw,what", [
    (128 * 128 + 32, {}, "multiple"),
    (0, {}, "multiple"),
    (128 * 128, dict(R=64), "R must be"),
    (128 * 128, dict(do_route=False), "ablations"),
    (128 * 128, dict(do_dma=False), "ablations"),
    (128 * 128, dict(npay=5), "at most 4"),
    (128 * 128, dict(npay=1), "must equal"),
])
def test_errors(n, kw, what):
    mask = torch.zeros(n, dtype=torch.bool)
    npay = kw.get("npay", 0)
    pays = [torch.zeros(n, dtype=torch.int32)] * (npay if npay > 1 else 0)
    with pytest.raises(ValueError, match=what):
        ce.compact_exp(mask, *pays, cap=16, **kw)


def test_cpu_dispatch_counts_no_launch():
    mask, _ = _case(9, 128, 1, 0.1, 0)
    before = ce.COMPACT_EXP_KERNEL.launches
    for m in (torch.from_numpy(mask), torch.from_numpy(mask != 0)):
        _check(ce.compact_exp(m, cap=4096), mask, [], 4096)
    assert ce.COMPACT_EXP_KERNEL.launches == before


def test_torch_rig_tool():
    """The torch rig's check passes on the CPU, and it offers the JAX
    rig's 15 variants."""
    assert len(torch_rig.check("cpu")) == 8
    text = (ROOT / "tools" / "profile_compact.py").read_text()
    names = re.findall(r'^\s+"(\w+)": dict\(', text, re.M)
    assert len(names) == 15 and list(torch_rig.VARIANTS) == names
