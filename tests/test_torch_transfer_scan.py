"""coregex_tpu_torch's all-entries transfer walk (ops/transfer_scan.py, the
plain version of cgx_transfer_walk, the plain model of its merging
walkers and the composition tree) against the JAX package's phase-1 loops
on the CPU: ``parallel/shard.py``'s ``_local_transfer_fn`` (F) and
``_local_flag_scan`` (each entry's flag total), and
``parallel/sharded_count.py``'s count-transducer scan ((F, E), through its
probe's phase 1 on a one-device mesh).

Inputs are seeded numpy tables and corpora fed to both packages: random
tables of 1, 7, 33 and 512 states and the bench patterns' tables; shards
whose length is no multiple of the piece split, G = 1, trees of odd depth;
for the merge model also permutation tables (walkers that never merge),
tables whose walkers merge only at a rare byte many chunks in, a silent
state other than 0 and a table with none, pieces shorter than a chunk and
empty ones, and the many-walkers threshold at 1 and at S.  Every output
is an integer, so the tolerance is exact equality.
"""

import os
import re

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
from coregex_tpu_torch.ops.count_scan import (SMEM_LIMIT, DeviceCountDFA,
                                              segment_map)
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


def _merged(packed, segmap, data, D, G, **kw):
    """The merge model's shard maps, after holding its pieces' maps to the
    plain version's."""
    t = torch.from_numpy(np.ascontiguousarray(data))
    m = len(data) // D
    F, E = ts.transfer_walk_merged(packed, segmap, t, m, D, G, **kw)
    pF, pE = ts.transfer_walk_plain(packed, segmap, t, m, D, G)
    assert torch.equal(F, pF) and torch.equal(E, pE)
    F, E = ts.compose(F, E, D)
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
    F, E = _merged(packed, segmap, data, 1, G)
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
    F, E = _merged(packed, segmap, data, 1, G)
    np.testing.assert_array_equal(F[0], rF)
    np.testing.assert_array_equal(E[0], rE)


def _merge_table(kind, S, seed):
    """(delta, emit, classes, byte pool, rare bytes) of a merge case;
    classes are byte % C."""
    rng = np.random.default_rng(seed)
    C = 4
    classes = (np.arange(256) % C).astype(np.int32)
    pool = np.array([b for b in range(32, 127) if b % C != C - 1],
                    dtype=np.uint8)
    rare = np.array([b for b in range(32, 127) if b % C == C - 1],
                    dtype=np.uint8)
    emit = rng.integers(0, 3, (S, C)).astype(np.int32)
    if kind in ("perm", "late", "funnel", "parity"):
        # permutations on the common bytes ("funnel": of 12 states, into
        # which every state falls); the rare bytes collapse every state
        # into state 1 ("late", "funnel"), or swap states 0 and 1
        # ("parity": state 2 is dead)
        delta = np.stack([rng.permutation(S) for _ in range(C)], 1)
        if kind == "funnel":
            delta = np.stack([rng.permutation(12)[np.arange(S) % 12]
                              for _ in range(C)], 1)
        if kind in ("late", "funnel"):
            delta[:, C - 1] = 1
        if kind == "parity":
            delta = np.tile(np.array([[0], [1], [2]]), (1, C))
            delta[:2, C - 1] = [1, 0]
            emit[2] = 0
    else:
        delta = rng.integers(0, S, (S, C)).astype(np.int32)
        if kind == "silent":
            # state S - 2 goes nowhere and emits nothing; most states reach
            # it on the rare bytes
            delta[:, C - 1] = S - 2
            delta[S - 2], emit[S - 2] = S - 2, 0
        elif kind == "none":
            delta[:, 0] = (np.arange(S) + 1) % S
    if kind not in ("perm", "parity", "funnel"):
        pool = np.concatenate([pool, rare])
    return delta.astype(np.int32), emit, classes, pool, rare


def _merge_data(kind, pool, rare, n, seed):
    """n bytes of the pool; for "late", "funnel" and "parity" a rare byte
    about every 150 bytes (so walkers merge, or swap, many chunks into a
    sub-piece)."""
    rng = np.random.default_rng(seed)
    data = pool[rng.integers(0, len(pool), n)]
    if kind in ("late", "funnel", "parity"):
        at = np.flatnonzero(rng.random(n) < 1 / 150)
        data[at] = rare[rng.integers(0, len(rare), len(at))]
    return data


# (kind, S, shard length, D, G, merge arguments): permutation tables that
# never merge; walkers that merge at a rare byte many chunks in (also with
# a short early stretch and test interval, and with 48 entries that fall
# into 12 states at once, which the kernel then walks in their place);
# quote parity's shape, two live
# walkers that swap, at max_reps 1 (never merged) and S (merged once EARLY
# bytes are walked); a silent state other than 0; a table with none; S = 1
# and S = 512; pieces shorter than a chunk and empty ones
MERGE_CASES = [
    pytest.param("perm", 64, 700, 2, 2, {}, id="perm64"),
    pytest.param("perm", 5, 3000, 1, 1, {}, id="perm5"),
    pytest.param("late", 12, 6000, 1, 1, {}, id="late"),
    pytest.param("late", 40, 5000, 1, 1, dict(early=32, late=48),
                 id="late-short-early"),
    pytest.param("funnel", 48, 6000, 1, 1, {}, id="compact"),
    pytest.param("parity", 3, 4000, 1, 1, dict(max_reps=1), id="parity-1"),
    pytest.param("parity", 3, 4000, 1, 1, dict(max_reps=3), id="parity-S"),
    pytest.param("silent", 9, 1500, 2, 3, {}, id="silent"),
    pytest.param("none", 9, 1500, 1, 2, {}, id="no-silent"),
    pytest.param("random", 1, 900, 2, 2, {}, id="S1"),
    pytest.param("random", 512, 600, 1, 1, dict(max_reps=512),
                 id="S512-threshold-S"),
    pytest.param("random", 7, 37, 1, 4, dict(max_reps=1), id="short-empty"),
    pytest.param("random", 7, 5, 3, 2, {}, id="tiny"),
]


@pytest.mark.parametrize("mode", ["dfa", "count"])
@pytest.mark.parametrize("kind,S,m,D,G,kw", MERGE_CASES)
def test_merge_model(kind, S, m, D, G, kw, mode):
    """The plain model of the kernel's merging walk (transfer_walk_merged):
    every piece's map equal to the plain version's, and each shard's map,
    composed, to the reference's in the DFA mode (_local_transfer_fn,
    _local_flag_scan) and the count mode (the probe's phase 1)."""
    delta, emit, classes, pool, rare = _merge_table(kind, S, S * 13 + m)
    if mode == "dfa":
        emit = (emit == 1).astype(np.int32)
    data = _merge_data(kind, pool, rare, D * m, S + m)
    packed, segmap = _seg_table(delta, emit, classes)
    silent = ts.silent_states(packed).numpy()
    if kind == "silent":
        assert silent.tolist() == [s == S - 2 for s in range(S)]
    if kind in ("none", "perm"):
        assert not silent.any()
    F, E = _merged(packed, segmap, data, D, G, **kw)
    for d in range(D):
        part = data[d * m:(d + 1) * m]
        rF, rE = (_ref_dfa(delta, emit, classes, part) if mode == "dfa"
                  else _ref_count(delta, emit, classes, part))
        np.testing.assert_array_equal(F[d], rF)
        np.testing.assert_array_equal(E[d], rE)


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
    """sub_lanes aims at WALKERS sub-pieces (SUB a piece, one merged walker
    each, whatever S) of at least MIN_SUB bytes, pieces of at most 2^26
    bytes; pieces and sub-pieces are multiples of 16; the walk rejects
    data that is not D shards of m bytes, tables over 512 states on the
    card and tables whose walk does not fit shared memory."""
    assert ts.sub_lanes(384 << 20, 4) == ts.WALKERS // (ts.SUB * 4) == 1024
    assert ts.sub_lanes(4 << 20, 1) == (4 << 20) // (ts.SUB * ts.MIN_SUB)
    assert ts.sub_lanes(100, 1) == 1
    assert ts.sub_lanes(1 << 30, 1) == ts.WALKERS // ts.SUB
    assert ts.sub_lanes(1 << 30, 1, 1 << 19) == 1 << 14
    assert ts.sub_lanes(1 << 30, 1, 32) == 16 and \
        ts.piece_len(1 << 30, 16) == ts.MAX_PIECE
    assert ts.piece_len(1000, 7) == 144 and ts.piece_len(5, 4) == 16
    assert ts.sub_len(144) == 16 and ts.sub_len(8192) == 256 and \
        ts.sub_len(8208) == 272
    packed = torch.zeros((2, 2), dtype=torch.int32)
    segmap = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="shards"):
        ts.transfer_maps(ts.MODE_DFA, packed, segmap,
                         torch.zeros(10, dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="int32"):
        ts.transfer_pieces(ts.MODE_DFA, packed.long(), segmap,
                           torch.zeros(8, dtype=torch.uint8), 4, 2, 1)
    with pytest.raises(ValueError, match="513 states"):
        ts.transfer_walk_cuda(torch.zeros((513, 1), dtype=torch.int32),
                              segmap, torch.zeros(64, dtype=torch.uint8),
                              64, 1, 1)
    with pytest.raises(ValueError, match="shared-memory"):
        ts.transfer_pieces(ts.MODE_DFA,
                           torch.zeros((512, 112), dtype=torch.int32),
                           segmap, torch.zeros(8, dtype=torch.uint8), 8, 1, 1)


def test_kernel_constants_and_shared_memory():
    """The merge rule's constants and the shared-memory layout of
    csrc/transfer_scan.cu are the wrapper's and the model's."""
    src = open(os.path.join(os.path.dirname(ts.__file__), "..", "csrc",
                            "transfer_scan.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("kSub"), const("kItems"), const("kMaxReps"),
            const("kEarly"), const("kLate"), const("kMaxStates"),
            const("kByteStates")) == (
        ts.SUB, ts.ITEMS, ts.MAX_REPS, ts.EARLY, ts.LATE, ts.MAX_STATES,
        ts.BYTE_STATES)
    assert const("kMaxWarps") == ts.MAX_WARPS
    assert int(re.search(r"kSmemLimit = (\d+);", src)[1]) == SMEM_LIMIT
    # segment map and table, the int16 byte table up to 128 states, silent
    # flags, each warp's worklist, compacted walkers and owners
    assert ts.smem_bytes(10, 5) == 4 * 306 + 2 * 256 * 10 + 16 + \
        (2048 + 128 + 24)
    assert ts.smem_bytes(3, 3, 16) == 1064 + 2 * 256 * 3 + 8 + \
        16 * (2048 + 128 + 8)
    assert ts.smem_bytes(112, 27, 4) == 4 * (256 + 3024) + 2 * 256 * 112 \
        + 112 + 4 * (2048 + 128 + 224)
    assert ts.smem_bytes(512, 6, 2) == 4 * (256 + 3072) + 512 + \
        2 * (2048 + 128 + 1024)
    packed = torch.tensor([[0, 1, 0], [32, 32, 32], [64, 64, 0]],
                          dtype=torch.int32)
    assert ts.silent_states(packed).tolist() == [False, True, False]
