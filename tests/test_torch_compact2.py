"""coregex_tpu_torch compaction (K4's plain version), sparse chain and
bidirectional span assembly against the JAX package on the CPU.

Seeded numpy masks and int32 payloads (bit-31 words included) go through
both packages; every output is an integer, so the tolerance is exact
equality.  The JAX side runs its XLA path, and once its Pallas kernel in
interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.ops import compact2 as ref
from coregex_tpu.ops import span_chain as ref_sc
from coregex_tpu_torch.ops import compact2 as c2
from coregex_tpu_torch.ops import span_chain as sc

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _pays(rng, npay, n):
    return [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(
        np.int32) for _ in range(npay)]


def _assert_outputs_equal(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(_np(g), _np(e))


@pytest.mark.parametrize("npay", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dens", [0.0, 0.002, 0.3, 1.0])
def test_compact_pay_matches_reference(npay, dens):
    rng = np.random.default_rng(int(dens * 1000) * 10 + npay)
    n = 5000 + npay
    mask = rng.random(n) < dens
    pays = _pays(rng, npay, n)
    nset = int(mask.sum())
    for cap in sorted({16, nset + 3, max(1, nset // 2)}):
        got = c2.compact_pay(torch.from_numpy(mask),
                             [torch.from_numpy(p) for p in pays], cap)
        exp = ref.compact_pay(jnp.asarray(mask),
                              [jnp.asarray(p) for p in pays], cap)
        _assert_outputs_equal(got, exp)
        assert bool(got[-1]) == (nset <= cap)


def test_compact_pay_empty_and_uint8():
    got = c2.compact_pay(torch.zeros(0, dtype=torch.bool),
                         [torch.zeros(0, dtype=torch.int32)], 8)
    exp = ref.compact_pay(jnp.zeros(0, bool), [jnp.zeros(0, jnp.int32)], 8)
    _assert_outputs_equal(got, exp)
    m = np.array([0, 3, 0, 255, 1], dtype=np.uint8)
    got = c2.compact_pay(torch.from_numpy(m), (), 4)
    np.testing.assert_array_equal(got[0].numpy(), [1, 3, 4, 5])
    assert int(got[1]) == 3 and bool(got[2])


def test_compact_pay_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    n = 4 * 256 * 128 + 77          # above the reference's XLA size cut
    mask = rng.random(n) < 0.01
    pays = _pays(rng, 2, n)
    cap = int(mask.sum()) + 5
    got = c2.compact_pay(torch.from_numpy(mask),
                         [torch.from_numpy(p) for p in pays], cap)
    exp = ref.compact_pay(jnp.asarray(mask), [jnp.asarray(p) for p in pays],
                          cap, interpret=True)
    _assert_outputs_equal(got, exp)


def test_cuda_wrapper_validates_before_launch():
    m = torch.ones(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="payloads"):
        c2.compact_pay_cuda(m, [torch.zeros(10, dtype=torch.int32)] * 5, 4)
    with pytest.raises(ValueError, match="int32"):
        c2.compact_pay_cuda(m, [torch.zeros(10, dtype=torch.int64)], 4)
    with pytest.raises(ValueError, match="uint8"):
        c2.compact_pay_cuda(m.bool(), [], 4)


def _words(rng, nw, dens):
    bits = rng.random(nw * 32) < dens
    # clustered hits exercise multi-bit words; bit 31 set in some words
    for c in rng.integers(0, nw * 32 - 40, 6):
        bits[c:c + 9] = True
    w = np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1)
    return w.view(">u4").reshape(-1).astype(np.uint32).view(np.int32), bits


@pytest.mark.parametrize("P", [0, 1, 2])
@pytest.mark.parametrize("nw", [100, 3000])
@pytest.mark.parametrize("l3", [None, 7], ids=["one_block", "blocks"])
def test_sparse_chain_payloads_matches_reference(P, nw, l3, monkeypatch):
    """`l3` patches the rows of the last level's blocks (2^27 bytes: a cap
    of 2^28 would pass the compaction's 2^31 - 1 entries in one)."""
    if l3:
        monkeypatch.setattr(c2, "_L3_ROWS", l3)
    rng = np.random.default_rng(60 + P + nw)
    words, bits = _words(rng, nw, 0.004)
    assert (words < 0).any()
    pays = _pays(rng, P, nw)
    exp_pos = np.flatnonzero(bits)
    n = nw * 32 - 3
    for cap in (len(exp_pos) + 9, max(1, len(exp_pos) // 2)):
        got = c2.sparse_chain_payloads(torch.from_numpy(words),
                                       [torch.from_numpy(p) for p in pays],
                                       n, cap)
        exp = ref.sparse_chain_payloads(jnp.asarray(words),
                                        [jnp.asarray(p) for p in pays], n,
                                        cap)
        _assert_outputs_equal(got, exp)
        fits = cap >= len(exp_pos)
        assert bool(got[-1]) == fits
        if fits:
            assert int(got[1 + P]) == len(exp_pos)
            np.testing.assert_array_equal(got[0][:len(exp_pos)].numpy(),
                                          exp_pos)


def test_floor_log2_and_lastpos_bit31():
    v = np.array([0, 1, 2, 3, 2 ** 30, 2 ** 31 - 1, -2 ** 31, -1, 96],
                 dtype=np.int32)
    np.testing.assert_array_equal(
        sc._floor_log2(torch.from_numpy(v)).numpy(),
        np.asarray(ref_sc._floor_log2(jnp.asarray(v))))
    rng = np.random.default_rng(3)
    w, _ = _words(rng, 500, 0.001)
    np.testing.assert_array_equal(
        sc._word_lastpos_table(torch.from_numpy(w), 500).numpy(),
        np.asarray(ref_sc._word_lastpos_table(jnp.asarray(w), 500)))
    fw, lf, glob = sc.inner_flag_arrays_words(torch.from_numpy(w), 1024)
    efw, elf, eglob = ref_sc.inner_flag_arrays_words(jnp.asarray(w), 1024)
    _assert_outputs_equal((fw, lf, glob), (efw, elf, eglob))


def _bidi_inputs(seed, n, ngroups, kind):
    """Forward event words for `ngroups` consecutive matches: flag bits at
    each match's candidate ends, a first bit at each group's first flag."""
    rng = np.random.default_rng(seed)
    flag = np.zeros(n, bool)
    first = np.zeros(n, bool)
    starts = np.sort(rng.choice(n // 8, ngroups, replace=False)) * 8
    for s in starts:
        k = int(rng.integers(1, 5))
        flag[s:s + k] = True
        first[s] = True
    nw = -(-n // 32)

    def pack(b):
        b = np.pad(b, (0, nw * 32 - n))
        w = np.packbits(b.reshape(-1, 32)[:, ::-1], axis=1)
        return w.view(">u4").reshape(-1).astype(np.uint32).view(np.int32)

    total = ngroups + (1 if kind == 2 else 0)
    return pack(flag), pack(first), total


@pytest.mark.parametrize("ngroups", [1, 6, 37])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_bidi_ends_matches_reference(ngroups, kind):
    n = 6000
    fw, gw, total = _bidi_inputs(ngroups * 10 + kind, n, ngroups, kind)
    from coregex_tpu.ops.bytescan import _bucket
    capM = _bucket(total + 1, 16)
    nwb = c2._bucket_up(-(-n // 32))
    nwb1 = c2._bucket_up(-(-(n + 1) // 32))
    got = sc.bidi_ends(torch.from_numpy(fw), torch.from_numpy(gw), n,
                       torch.tensor(total, dtype=torch.int32),
                       torch.tensor(kind, dtype=torch.int32), capM, nwb,
                       nwb1)
    exp = ref_sc.bidi_ends(jnp.asarray(fw), jnp.asarray(gw), jnp.int32(n),
                           jnp.int32(total), jnp.int32(kind), capM, nwb,
                           nwb1)
    ends, cntF, rq, rw, ok = got
    eends, ecntF, erq, erw, eok = exp
    _assert_outputs_equal((ends, cntF, rq, ok), (eends, ecntF, erq, eok))
    # the reference's scatter sends each dead rq = -1 to its last word
    # (JAX wraps negative indices): bit 31 there when the dead count is odd
    erw = np.asarray(erw).copy()
    dead = capM - int(ecntF)
    if dead % 2:
        erw[-1] ^= np.int32(-2 ** 31)
    np.testing.assert_array_equal(rw.numpy(), erw)
    assert bool(ok) and int(cntF) == total


def test_bidi_assemble_matches_reference():
    """Reverse flag words that put each match's start 1-3 bytes before its
    end; spans, count and ok agree, and a broken input fails ok alike."""
    n = 6000
    fw, gw, total = _bidi_inputs(5, n, 20, 0)
    from coregex_tpu.ops.bytescan import _bucket
    capM = _bucket(total + 1, 16)
    nwb = c2._bucket_up(-(-n // 32))
    nwb1 = c2._bucket_up(-(-(n + 1) // 32))
    ends, cntF, rq, rw, _ok = sc.bidi_ends(
        torch.from_numpy(fw), torch.from_numpy(gw), n, total, 0, capM, nwb,
        nwb1)
    rng = np.random.default_rng(8)
    rflag = np.zeros(n + 1, bool)
    for r in rq.numpy()[:int(cntF)]:
        rflag[min(r + int(rng.integers(1, 4)), n - 1)] = True
    rflag[n] = False
    nwr = -(-(n + 1) // 32)
    pad = np.pad(rflag, (0, nwr * 32 - (n + 1)))
    fw_rev = np.packbits(pad.reshape(-1, 32)[:, ::-1], axis=1).view(
        ">u4").reshape(-1).astype(np.uint32).view(np.int32)
    for fr in (fw_rev, np.zeros_like(fw_rev)):
        got = sc.bidi_assemble(ends, cntF, rw, torch.from_numpy(fr), n,
                               capM, nwb1)
        exp = ref_sc.bidi_assemble(
            jnp.asarray(ends.numpy()), jnp.asarray(cntF.numpy()),
            jnp.asarray(rw.numpy()), jnp.asarray(fr), jnp.int32(n), capM,
            nwb1)
        _assert_outputs_equal(got, exp)
    assert not bool(got[2])


@pytest.mark.parametrize("m", [1, 1023, 1024, 5000])
def test_cummax_fast_matches_reference(m):
    rng = np.random.default_rng(m)
    x = rng.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    x[rng.random(m) < 0.5] = -1
    np.testing.assert_array_equal(
        sc.cummax_fast(torch.from_numpy(x), -2 ** 31).numpy(),
        np.asarray(ref_sc.cummax_fast(jnp.asarray(x), -2 ** 31)))
