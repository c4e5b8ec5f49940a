"""coregex_tpu_torch chunked match scan (K9's plain version and
ChunkScanner) against the JAX package on the CPU.

Both packages get the same dense DFA (built by the JAX package's host
pipeline) and the same seeded corpora.  Every output is a flag, a count, a
position or a state, so the tolerance is exact equality: the plain lane
walk in MODE_MATCH against the Pallas kernel K9 (`pallas_scan_once`) in
interpret mode on the lane layout of tests/test_pallas.py, and the settled
ChunkScanner against the reference's ChunkScanner (impl="gather") on
multi-lane corpora, repairs included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import dfa_scan as ref
from coregex_tpu.ops import pallas_scan
from coregex_tpu.syntax.parser import parse
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import dfa_scan

torch.set_num_threads(1)


def _dfa(pattern, break_at_match=False):
    nfa = compile_nfa(parse(pattern), with_captures=False)
    return determinize(nfa, anchored=False, break_at_match=break_at_match)


WORDS = [b"abc 12.5 x", b"0.7", b"z\n", b"a ", b"xa", b"x ", b"ab", b"1 2 3",
         b"deadbeef-", b"10.0.0.1", b"\n", b"lorem", b"\"q\""]


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 3))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


@pytest.mark.parametrize("pattern", [r"\d+\.\d+", r"abc", r"[a-c]+x?"])
def test_match_walk_matches_pallas_interpret(pattern):
    """One MODE_MATCH pass against K9 in interpret mode: 16 lanes of 128
    bytes after a 64-byte warmup over the previous lane's tail (the class
    stream K9 reads is warmup + lane), lane 0's first 5 steps gated by its
    offset, every lane limited to T - 3 bytes (K9's true_steps)."""
    d = _dfa(pattern)
    dd = ref.DeviceDFA.from_dense(d)
    t = dfa_scan.DFATables.from_dense(d)
    rng = np.random.default_rng(3)
    L, T, W = 16, 128, 64
    text = rng.choice(list(b"abc 12.5 x\n0.7"), size=L * T).astype(np.uint8)
    tiles = cs.make_word_tiles(torch.from_numpy(text.copy()), L, T // 4)
    entries = torch.full((L,), int(d.starts[0]), dtype=torch.int32)
    offsets = torch.zeros(L, dtype=torch.int32)
    offsets[0] = 5
    limits = torch.full((L,), T - 3, dtype=torch.int32)
    counts, exits, sync, fw, last = cs.lane_walk(
        cs.MODE_MATCH, dfa_scan.MATCH_KERNEL,
        cs.device_table(t.packed, "cpu"), cs.device_table(t.segmap, "cpu"),
        tiles, W // 4, entries.reshape(1, L), offsets, limits)
    counts, exits, last = counts[0], exits[0], last[0]

    chunks = text.reshape(L, T)
    xs = np.concatenate([np.roll(chunks, 1, axis=0)[:, T - W:], chunks], 1)
    cls = np.asarray(dd.classes)[xs]                       # [L, W + T]
    Lc = L // 8
    flags_r, exits_r = pallas_scan.pallas_scan_once(
        dd.delta, dd.match_on, jnp.asarray(cls.T.reshape(W + T, 8, Lc)),
        jnp.asarray(entries.numpy().reshape(8, Lc)),
        jnp.asarray(offsets.numpy().reshape(8, Lc)),
        jnp.asarray(np.array([W + T - 3], np.int32)), S=dd.num_states,
        C=dd.num_classes, TT=W + T, Lc=Lc, Tt=64, interpret=True)
    want = np.asarray(flags_r).reshape(W + T, L)[W:].T.astype(bool)
    got = np.unpackbits(fw.t().contiguous().numpy().view(np.uint8),
                        bitorder="little").reshape(L, T).astype(bool)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(exits.numpy(),
                                  np.asarray(exits_r).reshape(L))
    np.testing.assert_array_equal(counts.numpy(), want.sum(1))
    lastw = np.where(want.any(1), T - 1 - np.argmax(want[:, ::-1], 1), -1)
    np.testing.assert_array_equal(last.numpy(), lastw)


def _quotes(n):
    return np.frombuffer(((b'"' + b"x" * 299) * (n // 300 + 1))[:n],
                         dtype=np.uint8)


SCAN_CASES = [(r"\s\d\s", False), (r"a\b", False), (r"x\B", False),
              (r"(?m)z$", False), (r"[0-9a-f]{8}-", False),
              (r"\d+\.\d+", True), (r"(a|b)+c", True), (r"a\b", True),
              (r'"[^"]*"', False), (r'"[^"]*"', True)]


@pytest.mark.parametrize("pattern,brk", SCAN_CASES)
def test_chunk_scanner_matches_reference(pattern, brk):
    """Settled flags [n+1] and the exit state at n equal the reference's
    on multi-lane corpora (n > 2048: several lanes in both geometries).
    Quote parity defeats the warmup guess in every lane, so the port
    repairs many times (and the reference scans on its host)."""
    d = _dfa(pattern, brk)
    sc = dfa_scan.ChunkScanner(dfa_scan.DFATables.from_dense(d), "cpu")
    rsc = ref.ChunkScanner(ref.DeviceDFA.from_dense(d), impl="gather")
    for arr in (_corpus(7, 5000), _quotes(5000)):
        got, gexit = sc.scan(torch.from_numpy(arr.copy()))
        want, wexit = rsc.scan(jnp.asarray(arr))
        np.testing.assert_array_equal(got, np.asarray(want))
        assert gexit == wexit


def test_dead_lane_ends_the_fixpoint(monkeypatch):
    """A break-at-match DFA that dies in lane 0 leaves every later lane
    DEAD; the fixpoint (count_scan.split_fixpoint, which match_full runs)
    stops at the dead lane after pass 0, with no repair pass, instead of
    carrying DEAD one lane per rescan."""
    d = _dfa(r"ab", True)
    sc = dfa_scan.ChunkScanner(dfa_scan.DFATables.from_dense(d), "cpu")
    arr = np.frombuffer(b"xxab" + b"a" * 9000, dtype=np.uint8)
    passes = []
    walk, repair = cs.lane_walk, cs.lane_repair
    monkeypatch.setattr(cs, "lane_walk",
                        lambda *a: passes.append("walk") or walk(*a))
    monkeypatch.setattr(cs, "lane_repair",
                        lambda *a: passes.append("repair") or repair(*a))
    scan = sc.scan_device(torch.from_numpy(arr.copy()))
    assert passes == ["walk"]
    assert int(dfa_scan.flags_last(scan)) == 4
    assert int(dfa_scan.flags_count_upto(scan)) == 1
    assert int(dfa_scan.exit_at_end(scan)) == 0
    flags, exit_n = sc.scan(torch.from_numpy(arr.copy()))
    want, wexit = ref.ChunkScanner(ref.DeviceDFA.from_dense(d),
                                   impl="gather").scan(jnp.asarray(arr))
    np.testing.assert_array_equal(flags, np.asarray(want))
    assert exit_n == wexit == 0


@pytest.mark.parametrize("pattern", [r"\s\d\s", r"(?m)z$", r"\d+\.\d+"])
def test_flag_reductions(pattern):
    """flags_count_upto and flags_last equal the host flags' count and
    last position below n; the flag at n is the EOI flag at the exit."""
    d = _dfa(pattern)
    sc = dfa_scan.ChunkScanner(dfa_scan.DFATables.from_dense(d), "cpu")
    arr = _corpus(11, 4099)
    data = torch.from_numpy(arr.copy())
    flags, exit_n = sc.scan(data)
    scan = sc.scan_device(data)
    n = len(arr)
    assert int(dfa_scan.flags_count_upto(scan)) == int(flags[:n].sum())
    pos = np.nonzero(flags[:n])[0]
    assert int(dfa_scan.flags_last(scan)) == (pos[-1] if len(pos) else -1)
    assert int(dfa_scan.exit_at_end(scan)) == exit_n
    assert flags[n] == bool(d.match_eoi[exit_n, 0])


@pytest.mark.parametrize("pattern", [r"\s\d\s", r"\w+://[^\s]+"])
def test_tables_match_reference(pattern):
    """The padded segment tables equal the reference's DeviceDFA; the
    packed table is delta*32 + match over the unpadded segments."""
    d = _dfa(pattern)
    t = dfa_scan.DFATables.from_dense(d)
    dd = ref.DeviceDFA.from_dense(d)
    np.testing.assert_array_equal(t.delta, np.asarray(dd.delta))
    np.testing.assert_array_equal(t.match_on, np.asarray(dd.match_on))
    np.testing.assert_array_equal(t.bounds, np.asarray(dd.bounds))
    np.testing.assert_array_equal(t.segmap, np.asarray(dd.classes))
    S, nseg = t.packed.shape
    np.testing.assert_array_equal(
        t.packed, t.delta[:S, :nseg] * 32 + t.match_on[:S, :nseg])
    np.testing.assert_array_equal(t.match_eoi, d.match_eoi)
    assert cs.lane_instance(cs.MODE_MATCH, S, nseg) == "shared"


def test_cuda_wrapper_validates_before_launch():
    """The match mode shares the lane walk's checks, made before anything
    is built or launched."""
    L, T4 = 1024, 64
    tiles = torch.zeros((T4, L), dtype=torch.int32)
    lanes = torch.zeros(L, dtype=torch.int32)
    seg = torch.zeros(256, dtype=torch.int32)
    big = torch.zeros((4096, 64), dtype=torch.int32)
    # past shared memory: the kernel's global-memory instance takes it
    cs._check_lane_args(cs.MODE_MATCH, big, seg, tiles, 16, lanes[None],
                        lanes, lanes)
    assert cs.lane_instance(cs.MODE_MATCH, 4096, 64) == "global"
    with pytest.raises(ValueError, match="shape"):
        cs.lane_walk_cuda(cs.MODE_MATCH, big[:4].contiguous(), seg, tiles,
                          16, lanes[:-1], lanes, lanes)
