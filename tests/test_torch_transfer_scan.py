"""coregex_tpu_torch's all-entries transfer walk (ops/transfer_scan.py, the
plain version of cgx_transfer_walk and its composition tree) against the
JAX package's phase-1 loops on the CPU: ``parallel/shard.py``'s
``_local_transfer_fn`` (F) and ``_local_flag_scan`` (each entry's flag
total), and ``parallel/sharded_count.py``'s count-transducer scan ((F, E),
through its probe's phase 1 on a one-device mesh).

Inputs are seeded numpy tables and corpora fed to both packages: random
tables of 1, 7, 33 and 512 states and the bench patterns' tables; shards
whose length is no multiple of the piece split, G = 1, trees of odd depth.
Every output is an integer, so the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coregex_tpu.dfa.countdfa import CountDFA as RefCountDFA
from coregex_tpu.dfa.countdfa import build_count_dfa as ref_build_count
from coregex_tpu.dfa.determinize import determinize as ref_determinize
from coregex_tpu.nfa.thompson import compile_nfa as ref_compile_nfa
from coregex_tpu.parallel import shard as ref_shard
from coregex_tpu.parallel.sharded_count import ShardedPhaseProbe
from coregex_tpu.syntax.parser import parse as ref_parse
from coregex_tpu_torch.dfa.countdfa import build_count_dfa
from coregex_tpu_torch.dfa.determinize import determinize
from coregex_tpu_torch.nfa.thompson import compile_nfa
from coregex_tpu_torch.ops import transfer_scan as ts
from coregex_tpu_torch.ops.count_scan import DeviceCountDFA, segment_map
from coregex_tpu_torch.ops.dfa_scan import DFATables
from coregex_tpu_torch.syntax.parser import parse

from test_torch_engine import BENCH

torch.set_num_threads(1)

ALPHABET = np.frombuffer(b"ab.0123456789 keyword/xyzphtw\nerror@:GET",
                         dtype=np.uint8)


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    return ALPHABET[rng.integers(0, len(ALPHABET), n)]


def _seg_table(delta, emit, classes):
    """(packed, segmap) over byte segments of class tables [S, C]."""
    bounds, segmap = segment_map(np.asarray(classes))
    seg_cls = np.asarray(classes)[np.concatenate([[0], bounds])]
    packed = delta[:, seg_cls].astype(np.int32) * 32 + \
        emit[:, seg_cls].astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(packed)),
            torch.from_numpy(segmap))


def _random(S, C, seed):
    rng = np.random.default_rng(seed)
    delta = rng.integers(0, S, (S, C)).astype(np.int32)
    emit = rng.integers(0, 3, (S, C)).astype(np.int32)
    classes = rng.integers(0, C, 256).astype(np.int32)
    if S > 100:
        # few byte segments, so that the table fits the kernel's shared
        # memory as the CUDA wrapper requires
        classes.sort()
    return delta, emit, classes


def _ref_dfa(delta, match_on, classes, data):
    """The reference's F (_local_transfer_fn) and every entry's flag total
    (_local_flag_scan from each entry) over one shard."""
    S = delta.shape[0]
    d, mo = jnp.asarray(delta), jnp.asarray(match_on.astype(bool))
    cls = jnp.asarray(classes)[jnp.asarray(data)]
    F = ref_shard._local_transfer_fn(d, cls, S)
    fin, cnt = jax.vmap(lambda e: ref_shard._local_flag_scan(d, mo, cls, e))(
        jnp.arange(S, dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(fin), np.asarray(F))
    return np.asarray(F), np.asarray(cnt)


def _ref_count(delta, emit, classes, data):
    """The reference's count-transducer phase 1 (F, E) over one shard,
    through ShardedPhaseProbe's phase-1 program on a one-device mesh."""
    S = delta.shape[0]
    cd = RefCountDFA(delta=delta, emit=emit.astype(np.int16),
                     eoi_commits=np.zeros((S, 4), np.int16),
                     starts=np.zeros(4, np.int32), classes=classes)
    probe = ShardedPhaseProbe(cd, ref_shard.default_mesh(1))
    F, E = probe._p1(jnp.asarray(data), *probe._tables)
    return np.asarray(F), np.asarray(E)


def _port(packed, segmap, data, D, G):
    F, E = ts.transfer_maps(ts.MODE_DFA, packed, segmap,
                            torch.from_numpy(np.ascontiguousarray(data)), D,
                            G)
    return F.numpy(), E.numpy()


# (S, C, shard length, pieces a shard): lengths no multiple of the split,
# G = 1, trees of odd depth (3, 5 and 7 pieces), empty last pieces (37 / 4)
CASES = [(1, 3, 1000, 7), (7, 5, 1000, 3), (7, 5, 37, 4), (33, 4, 999, 5),
         (33, 9, 512, 1), (512, 6, 300, 3)]


@pytest.mark.parametrize("S,C,m,G", CASES)
def test_random_tables_dfa_mode(S, C, m, G):
    delta, match, classes = _random(S, C, S * 7 + m)
    match = (match == 1).astype(np.int32)
    data = _corpus(S + m, m)
    packed, segmap = _seg_table(delta, match, classes)
    F, E = _port(packed, segmap, data, 1, G)
    rF, rE = _ref_dfa(delta, match, classes, data)
    np.testing.assert_array_equal(F[0], rF)
    np.testing.assert_array_equal(E[0], rE)


@pytest.mark.parametrize("S,C,m,G", CASES)
def test_random_tables_count_mode(S, C, m, G):
    delta, emit, classes = _random(S, C, S * 11 + m)
    data = _corpus(S * 3 + m, m)
    packed, segmap = _seg_table(delta, emit, classes)
    F, E = ts.transfer_maps(ts.MODE_COUNT, packed, segmap,
                            torch.from_numpy(data), 1, G)
    rF, rE = _ref_count(delta, emit, classes, data)
    np.testing.assert_array_equal(F[0].numpy(), rF)
    np.testing.assert_array_equal(E[0].numpy(), rE)


def test_pieces_and_shards_against_the_reference():
    """Every piece's own (F, E), of D = 3 shards at once, equals the
    reference's over that piece's bytes, and each shard's composed map
    the reference's over the shard: the shards' launch shares nothing."""
    delta, match, classes = _random(7, 5, 3)
    match = (match == 1).astype(np.int32)
    packed, segmap = _seg_table(delta, match, classes)
    D, m, G = 2, 401, 3
    data = _corpus(9, D * m)
    pl = ts.piece_len(m, G)
    F, E = ts.transfer_walk_plain(packed, segmap, torch.from_numpy(data), m,
                                  D, G)
    for d in range(D):
        for g in range(G):
            lo, hi = d * m + min(g * pl, m), d * m + min((g + 1) * pl, m)
            rF, rE = ((np.arange(7), np.zeros(7)) if lo == hi else
                      _ref_dfa(delta, match, classes, data[lo:hi]))
            np.testing.assert_array_equal(F[d * G + g].numpy(), rF)
            np.testing.assert_array_equal(E[d * G + g].numpy(), rE)
    Fc, Ec = _port(packed, segmap, data, D, G)
    for d in range(D):
        rF, rE = _ref_dfa(delta, match, classes, data[d * m:(d + 1) * m])
        np.testing.assert_array_equal(Fc[d], rF)
        np.testing.assert_array_equal(Ec[d], rE)


def _ref_tables(pattern):
    nfa = ref_compile_nfa(ref_parse(pattern), with_captures=False)
    dense = ref_determinize(nfa, anchored=False, break_at_match=False)
    cd = ref_build_count(ref_determinize(nfa, anchored=False,
                                         break_at_match=True))
    return dense, cd.without_spans().minimized()


def _port_tables(pattern):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    dense = determinize(nfa, anchored=False, break_at_match=False)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    return dense, cd.without_spans().minimized()


@pytest.mark.parametrize("pattern", BENCH)
def test_bench_tables_both_modes(pattern):
    """The bench patterns: the DFA mode over the unanchored forward DFA's
    match table (dfa_scan.DFATables, as K9 reads it) and the count mode
    over the count transducer's table (count_scan.DeviceCountDFA, as K1
    reads it), with the split sub_lanes picks, against the reference."""
    data = _corpus(len(pattern), 3001)
    rdense, rcd = _ref_tables(pattern)
    dense, cd = _port_tables(pattern)
    t = DFATables.from_dense(dense)
    packed = torch.from_numpy(np.ascontiguousarray(t.packed, np.int32))
    segmap = torch.from_numpy(t.segmap)
    F, E = _port(packed, segmap, data, 1, None)
    rF, rE = _ref_dfa(rdense.delta, rdense.match_on, rdense.classes, data)
    np.testing.assert_array_equal(F[0], rF)
    np.testing.assert_array_equal(E[0], rE)
    dcd = DeviceCountDFA.from_host(cd, "cpu")
    F, E = ts.transfer_maps(ts.MODE_COUNT, dcd.packed, dcd.segmap,
                            torch.from_numpy(data), 1)
    rF, rE = _ref_count(rcd.delta, rcd.emit, rcd.classes, data)
    np.testing.assert_array_equal(F[0].numpy(), rF)
    np.testing.assert_array_equal(E[0].numpy(), rE)


def test_split_rule_and_arguments():
    """sub_lanes aims at K1's 524,288 walkers in pieces of at least 256
    bytes and at most 2^26; pieces are multiples of 16; the walk rejects
    data that is not D shards of m bytes."""
    assert ts.sub_lanes(20, 384 << 20, 4) == -(-ts.WALKERS // 80)
    assert ts.sub_lanes(20, 4 << 20, 1) == (4 << 20) // 256
    assert ts.sub_lanes(3, 100, 1) == 1
    assert ts.sub_lanes(1, 1 << 30, 1) == 1 << 19
    assert ts.sub_lanes(512, 1 << 30, 1) == 1024
    assert ts.sub_lanes(1 << 15, 1 << 30, 1) == 16 and \
        ts.piece_len(1 << 30, 16) == ts.MAX_PIECE
    assert ts.piece_len(1000, 7) == 144 and ts.piece_len(5, 4) == 16
    packed = torch.zeros((2, 2), dtype=torch.int32)
    segmap = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="shards"):
        ts.transfer_maps(ts.MODE_DFA, packed, segmap,
                         torch.zeros(10, dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="int32"):
        ts.transfer_pieces(ts.MODE_DFA, packed.long(), segmap,
                           torch.zeros(8, dtype=torch.uint8), 4, 2, 1)
