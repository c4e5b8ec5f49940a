"""coregex_tpu_torch sequential needle count (K7's plain version) and needle
tables against the JAX package on the CPU.

Totals and convergence against the reference's ``_seq_full`` with its Pallas
kernel in interpret mode (both modes, an overlapping literal set, a case
that needs repair), and breadth against its sequential host oracles.  Every
output is an integer, so the tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coregex_tpu.ops import seq_scan as ref_ss
from coregex_tpu_torch.ops import seq_scan as ss

torch.set_num_threads(1)

GEO = (8, 64, 16, 1)      # 8 lanes x 64 bytes, warmup widened to 4M + 4


def _text(rng, alphabet, n):
    return bytes(rng.choice(alphabet) for _ in range(n))


def _t(data):
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def _passes(monkeypatch):
    """Counts the K7 passes that walk: pass 0 plus each repair pass with
    a walker (the split fixpoint ends on a pass that walks nothing)."""
    calls = []
    plain, repair = ss.seq_lanes_plain, ss.seq_repair_plain

    def counted(*a):
        calls.append(1)
        return plain(*a)

    def counted_repair(*a):
        repair(*a)
        walked = a[15]
        if int(walked[0]):
            calls.append(1)

    monkeypatch.setattr(ss, "seq_lanes_plain", counted)
    monkeypatch.setattr(ss, "seq_repair_plain", counted_repair)
    return calls


@pytest.mark.parametrize("mode, needles, prefix, alphabet, needs_repair", [
    (ss.MODE_MULTI, [b"aa", b"ab", b"ba"], b"", b"ab ", True),
    (ss.MODE_LINE, [b".php"], b"/", b"/.phpx\n", False),
    (ss.MODE_LINE, [b"keyword", b"key"], b"", b"keyword \n", False),
])
def test_seq_full_matches_reference_interpret(monkeypatch, mode, needles,
                                              prefix, alphabet, needs_repair):
    """Corpora fill the 512 bytes of the geometry, so the reference
    compiles once per case."""
    anchored = bool(prefix)
    ref = ref_ss.SeqScanner(mode, needles, prefix=prefix, anchored=anchored,
                            interpret=True)
    sc = ss.SeqScanner(mode, needles, prefix=prefix, anchored=anchored)
    rng = random.Random(mode * 10 + len(needles))
    corpora = [_text(rng, alphabet, 512) for _ in range(3)]
    if needs_repair:
        # a run of a's from byte 1 across lanes 0-2: the match parity at
        # each lane start lies beyond its warmup
        corpora.append((b" " + b"a" * 150 + b" " + b"ab" * 200)[:512])
    calls = _passes(monkeypatch)
    repaired = False
    for data in corpora:
        del calls[:]
        exp = ref.count(jnp.asarray(np.frombuffer(data, np.uint8)),
                        geometry=GEO)
        assert exp is not None
        assert sc.count(_t(data), GEO) == exp
        oracle = (ref_ss.multi_count_host(data, needles)
                  if mode == ss.MODE_MULTI else
                  ref_ss.line_count_host(data, needles, prefix, anchored))
        assert exp == oracle
        repaired |= len(calls) > 1
    assert repaired or not needs_repair


def test_repair_settles_past_the_reference_bound(monkeypatch):
    """A parity chain across every lane needs L - 1 repair passes (here
    lane passes: GEO's lanes are too short to split); the reference stops
    after 4 rescans and reports non-convergence, the port settles."""
    data = b"b" + b"a" * 500
    calls = _passes(monkeypatch)
    sc = ss.SeqScanner(ss.MODE_MULTI, [b"aa"])
    assert sc.count(_t(data), GEO) == ref_ss.multi_count_host(data, [b"aa"])
    assert len(calls) > 5


@pytest.mark.parametrize("geo", [GEO, (16, 256, 128, 2), None])
@pytest.mark.parametrize("mode, needles, prefix, alphabet", [
    (ss.MODE_MULTI, [b"error"], b"", b"error x"),
    (ss.MODE_MULTI, [b"0.0"], b"", b"0.1 "),
    (ss.MODE_MULTI, [b"alpha", b"beta", b"alp"], b"", b"alphbet "),
    (ss.MODE_LINE, [b".txt", b".log"], b"", b"a.txtlog\n"),
    (ss.MODE_LINE, [b"xy"], b"ab", b"abxy\n z"),
])
def test_seq_count_matches_host_oracle(geo, mode, needles, prefix,
                                       alphabet):
    anchored = bool(prefix)
    sc = ss.SeqScanner(mode, needles, prefix=prefix, anchored=anchored)
    rng = random.Random(len(alphabet) * 10 + (geo or (0,))[0])
    for _ in range(6):
        data = _text(rng, alphabet, rng.randrange(
            1, geo[0] * geo[1] if geo else 1500))
        exp = (ref_ss.multi_count_host(data, needles)
               if mode == ss.MODE_MULTI else
               ref_ss.line_count_host(data, needles, prefix, anchored))
        assert sc.count(_t(data), geo) == exp, data


def test_needle_tables_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        nds = [bytes(rng.integers(1, 256, int(rng.integers(1, 14)),
                                  dtype=np.uint8)) for _ in range(4)]
        assert ss.needle_phase_plans(nds[0]) == \
            ref_ss.needle_phase_plans(nds[0])
        for got, exp in zip(ss.build_mask_tables(nds, 4),
                            ref_ss.build_mask_tables(nds, 4)):
            np.testing.assert_array_equal(got, exp)
        tbl, lens = ss.needle_table(nds, "cpu")
        assert ss.host_needles(tbl, lens) == nds
    assert (ss.M_MAX, ss.LEN_MAX) == (ref_ss.M_MAX, ref_ss.LEN_MAX)


def test_supported_gates_match_reference():
    cases = [([b"abc"], b"", False), ([b"a\x00b"], b"", False),
             ([b"a\nb"], b"", False), ([b"a\nb"], b"", True),
             ([b"x" * 13], b"", False), ([b"x" * 14], b"", False),
             ([b""], b"", False), ([b"ab"], b"/", True),
             ([b"ab"], b"\n", True), ([b"a"] * 64, b"", False),
             ([b"a"] * 65, b"", False)]
    for needles, prefix, line_mode in cases:
        assert ss.SeqScanner.supported(needles, prefix, line_mode) == \
            ref_ss.SeqScanner.supported(needles, prefix, line_mode)


def test_cuda_wrapper_validates_before_launch():
    tbl, lens = ss.needle_table([b"ab"], "cpu")
    tiles = torch.zeros((2, 8), dtype=torch.int32)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="lookahead"):
        ss.seq_lanes_cuda(ss.MODE_MULTI, tbl, lens, 1, False, 0, tiles, 1,
                          z, z, z)
    tiles = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ss.seq_lanes_cuda(ss.MODE_MULTI, tbl.long(), lens, 1, False, 0,
                          tiles, 4, z, z, z)
    with pytest.raises(ValueError, match="entries"):
        ss.seq_lanes_cuda(ss.MODE_MULTI, tbl, lens, 1, False, 0, tiles, 4,
                          z[:4], z, z)
