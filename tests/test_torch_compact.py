"""coregex_tpu_torch.ops.compact.compact_positions (K8's plain version)
against the JAX package on the CPU: its XLA scatter (_compact_xla) and its
Pallas kernel in interpret mode (_compact_call), at several block counts
and densities, cap overflow included.  Positions and counts are integers:
exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.ops import compact as ref
from coregex_tpu_torch.ops import compact

torch.set_num_threads(1)


def _mask(seed, n, dens):
    return (np.random.default_rng(seed).random(n) < dens).astype(np.int8)


def _check(h, cap, pos, cnt):
    """Positions ascending and padded with n, the count the full total."""
    exp = np.flatnonzero(h)
    pos = pos.numpy()
    assert pos.dtype == np.int32 and pos.shape == (cap,)
    assert int(cnt) == len(exp)
    take = min(cap, len(exp))
    np.testing.assert_array_equal(pos[:take], exp[:take])
    assert (pos[take:] == len(h)).all()


@pytest.mark.parametrize("n", [1, 1000, 3 * ref.CH + 17])
@pytest.mark.parametrize("dens", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("over", [False, True])
def test_plain_matches_xla(n, dens, over):
    h = _mask(n + int(dens * 100), n, dens)
    full = int(h.sum())
    cap = max(1, full // 2) if over else 1 << max(4, full.bit_length())
    pos, cnt = compact.compact_positions(torch.from_numpy(h), cap)
    epos, ecnt = ref._compact_xla_jit(jnp.asarray(h), cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(epos))
    assert int(cnt) == int(ecnt)
    _check(h, cap, pos, cnt)


@pytest.mark.parametrize("blocks,dens,over", [
    (4, 0.003, False), (4, 0.97, False), (5, 0.25, True)])
def test_plain_matches_pallas_interpret(blocks, dens, over):
    n = blocks * ref.CH
    h = _mask(blocks * 7 + int(dens * 100), n, dens)
    full = int(h.sum())
    cap = full // 3 if over else 1 << max(4, full.bit_length())
    pos, cnt = compact.compact_positions(torch.from_numpy(h), cap)
    epos, ecnt = ref._compact_call(jnp.asarray(h), cap, interpret=True)
    assert int(cnt) == int(ecnt) == full
    take = min(cap, full)
    np.testing.assert_array_equal(pos.numpy()[:take], np.asarray(epos)[:take])
    _check(h, cap, pos, cnt)


def test_dtypes_chunks_and_empty(monkeypatch):
    h = _mask(3, 50_000, 0.2)
    exp_pos, exp_cnt = compact.compact_positions(torch.from_numpy(h), 16384)
    for m in (torch.from_numpy(h).bool(), torch.from_numpy(h).to(torch.int32),
              torch.from_numpy(h * 7).to(torch.uint8)):
        pos, cnt = compact.compact_positions(m, 16384)
        assert torch.equal(pos, exp_pos) and int(cnt) == int(exp_cnt)
    # the plain version's running rank across chunks
    monkeypatch.setattr(compact, "_PLAIN_CHUNK", 4096)
    pos, cnt = compact.compact_positions(torch.from_numpy(h), 16384)
    assert torch.equal(pos, exp_pos) and int(cnt) == int(exp_cnt)
    pos, cnt = compact.compact_positions(torch.from_numpy(h), 100)
    assert torch.equal(pos, exp_pos[:100]) and int(cnt) == int(exp_cnt)
    pos, cnt = compact.compact_positions(torch.zeros(0, dtype=torch.bool), 16)
    assert pos.shape == (16,) and int(cnt) == 0


def test_no_launch_and_no_fallback_off_the_cpu():
    before = compact.COMPACT_POS_KERNEL.launches
    compact.compact_positions(torch.ones(100, dtype=torch.bool), 128)
    assert compact.COMPACT_POS_KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        compact.compact_positions(torch.ones(100, dtype=torch.bool,
                                             device="meta"), 128)
