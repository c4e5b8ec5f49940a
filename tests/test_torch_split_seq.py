"""K7's sub-lane split (csrc/needle_scan.cu's cgx_seq_lanes) and its repair
through the split fixpoint's passes (count_scan.split_passes), against the
JAX package on the CPU.

K7 walks k sub-lanes a lane; each warms up over the W bytes before it from
a guessed state, and repair passes walk again only the unsettled sub-lanes,
then the lanes holding one.  A line-mode sub-lane whose warmup holds a
newline is clean: exact whatever its entry, never walked again.  Here the
plain split walk runs at k = 1, 2, 4 and 16 on 16 lanes of 1 KiB, on
seeded corpora, against the reference's ``SeqScanner`` with its Pallas
kernel in interpret mode, its host oracles ``multi_count_host`` and
``line_count_host``, and a sequential walk of the machine's state.  Every
output is an integer or a state: exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coregex_tpu.ops import seq_scan as ref_ss
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import seq_scan as ss

torch.set_num_threads(1)

L, T, W = 16, 1024, 16          # 16 lanes of 1 KiB, a 16-byte warmup
GEO = (L, T, W, 2)
SPLITS = [1, 2, 4, 16]
ALT32 = [w.encode() for w in (
    "alpha beta gamma delta epsilon zeta theta lambda sigma omega error "
    "warning notice debug trace fatal panic abort retry timeout refused "
    "closed opened created deleted updated inserted removed flushed synced "
    "loaded stored").split()]
CONFIGS = {
    "multi_0.0": (ss.MODE_MULTI, [b"0.0"], b""),
    "multi_aa_ab_ba": (ss.MODE_MULTI, [b"aa", b"ab", b"ba"], b""),
    "multi_alt32": (ss.MODE_MULTI, ALT32, b""),
    "line_php": (ss.MODE_LINE, [b".php"], b""),
    "line_anchored_php": (ss.MODE_LINE, [b".php"], b"/"),
}
_REF = {}


def _corpus(name, seed, n):
    """Seeded text for a configuration: overlapping hits for the literal
    sets, lines of 1-300 bytes (many longer than the warmup) for the line
    machines."""
    rng = random.Random(seed)
    mode, needles, _prefix = CONFIGS[name]
    out = bytearray()
    while len(out) < n:
        if name == "multi_0.0":
            out += rng.choice([b"10.0.0.1 ", b"0.0.0", b"1.0", b"0", b" "])
        elif name == "multi_aa_ab_ba":
            out += bytes(rng.choice(b"ab ") for _ in range(rng.randrange(1,
                                                                        40)))
        elif name == "multi_alt32":
            out += rng.choice(ALT32 + [b"x", b"alp", b"de"])
            out += rng.choice([b"", b" ", b"\n"])
        else:
            line = bytearray(b"/" if rng.random() < 0.5 else b"")
            size = rng.randrange(1, 300)
            while len(line) < size:
                line += rng.choice([b"x", b".php", b"ab", b" ", b"/", b".ph"])
            out += line + b"\n"
    return bytes(out[:n])


def _oracle(name, data):
    mode, needles, prefix = CONFIGS[name]
    if mode == ss.MODE_MULTI:
        return ref_ss.multi_count_host(data, needles)
    return ref_ss.line_count_host(data, needles, prefix, bool(prefix))


def _scanner(name):
    mode, needles, prefix = CONFIGS[name]
    return ss.SeqScanner(mode, needles, prefix=prefix, anchored=bool(prefix))


def _t(data):
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def _scan(sc, data, k):
    """(counts, exits, sync, clean) [k, L] of K7 over k sub-lanes a lane
    on GEO, settled, with the passes that walked: (sub-lane, lane)."""
    dev = _t(data)
    Wk = min(max(W, 4 * sc.M + 4), T)
    tiles = cs.make_word_tiles(dev, L, T // 4)
    before = (ss.SEQ_KERNEL.sub_passes, ss.SEQ_KERNEL.lane_passes)
    out, conv = sc.scan(tiles, dev, len(data), T, Wk, k,
                        max_repair=L + cs.SUB_PASSES)
    assert conv
    return out, (ss.SEQ_KERNEL.sub_passes - before[0],
                 ss.SEQ_KERNEL.lane_passes - before[1])


def _states(name, data):
    """The machine's state after each position of a sequential walk from
    the true start: K7's step restated over Python bytes."""
    mode, needles, prefix = CONFIGS[name]
    plen = len(prefix)
    s = 0 if mode == ss.MODE_MULTI else 1
    out = []
    for p in range(len(data)):
        if mode == ss.MODE_MULTI:
            wl = next((len(nd) for nd in needles if data.startswith(nd, p)),
                      0)
            s = wl - 1 if wl and s == 0 else max(s - 1, 0)
        else:
            nl = int(data[p] == 10)
            hit = any(data.startswith(nd, p) for nd in needles)
            prev_nl = s & 1
            seen = bool((s >> 2) & 1) and not prev_nl
            if not prefix:
                s = nl | (int(seen or hit) << 2)
            else:
                valid = (data.startswith(prefix, p) if prev_nl
                         else bool((s >> 1) & 1))
                slc = 0 if prev_nl else min(((s >> 3) & 31) + 1, 31)
                seen = seen or (hit and valid and slc >= plen)
                s = nl | (int(valid) << 1) | (int(seen) << 2) | (slc << 3)
        out.append(s)
    return out


# -- the count against the reference and the host oracles --------------------

@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_count_matches_reference_interpret(name, k):
    """The split count equals the reference's SeqScanner (its Pallas
    kernel in interpret mode, on GEO's 16 unsplit lanes) and the host
    oracle, on corpora filling GEO (one trace a configuration)."""
    mode, needles, prefix = CONFIGS[name]
    sc = _scanner(name)
    for seed in (1, 2):
        data = _corpus(name, seed, L * T)
        if (name, seed) not in _REF:
            ref = ref_ss.SeqScanner(mode, needles, prefix=prefix,
                                    anchored=bool(prefix), interpret=True)
            _REF[name, seed] = ref.count(
                jnp.asarray(np.frombuffer(data, np.uint8)), geometry=GEO)
        exp = _REF[name, seed]
        assert exp == _oracle(name, data)
        (counts, _e, _s, _c), _passes = _scan(sc, data, k)
        assert int(counts.sum()) == exp


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_count_matches_host_oracle(name, k):
    """Random lengths up to GEO's capacity, through SeqScanner.scan at k
    and, at lane_split's k, through SeqScanner.count."""
    sc = _scanner(name)
    rng = random.Random(f"{name}/{k}")
    for i in range(3):
        data = _corpus(name, 100 * k + i, rng.randrange(1, L * T + 1))
        exp = _oracle(name, data)
        (counts, _e, _s, _c), _passes = _scan(sc, data, k)
        assert int(counts.sum()) == exp
    assert sc.count(_t(data), GEO) == exp


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("name", ["multi_aa_ab_ba", "line_anchored_php"])
def test_settled_exits_are_the_sequential_states(name, k):
    """After settling, every real sub-lane's exit, read in corpus order
    (sub-lane (j, l) is the l*k + j-th), is the sequential walk's state at
    its last byte, and every real sub-lane that is not clean entered at
    the state before its first byte."""
    sc = _scanner(name)
    Tk = T // k
    data = _corpus(name, 7 * k, L * T - 333)
    n = len(data)
    states = _states(name, data)
    (_c, exits, sync, clean), _passes = _scan(sc, data, k)
    entry0 = 0 if CONFIGS[name][0] == ss.MODE_MULTI else 1
    for lane in range(L):
        for j in range(k):
            base = lane * T + j * Tk
            if base >= n:
                continue
            assert int(exits[j, lane]) == states[min(base + Tk, n) - 1]
            if not clean[j, lane]:
                want = states[base - 1] if base else entry0
                assert int(sync[j, lane]) == want


# -- the repair's passes -----------------------------------------------------

@pytest.mark.parametrize("k", [2, 4, 16])
def test_parity_chain_across_sub_lanes(k):
    """`aa` over a run of a's inside lane 5: each of its sub-lanes' match
    parity lies beyond the warmup, so the chain settles one sub-lane a
    pass; past SUB_PASSES one lane pass walks the rest."""
    data = bytearray(b" " * (L * T))
    data[5 * T] = ord("b")
    data[5 * T + 1:6 * T - 10] = b"a" * (T - 11)
    data = bytes(data)
    sc = ss.SeqScanner(ss.MODE_MULTI, [b"aa"])
    (counts, _e, _s, _c), (subs, lanes) = _scan(sc, data, k)
    assert int(counts.sum()) == ref_ss.multi_count_host(data, [b"aa"])
    assert subs == min(k - 1, cs.SUB_PASSES) <= cs.SUB_PASSES
    assert lanes == (1 if k - 1 > cs.SUB_PASSES else 0)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_parity_chain_across_lanes(k):
    """`aa` over b + a's: the parity reaches back to the corpus start, so
    the sub-lane passes cannot settle it and the fixpoint escalates to
    lane passes, at most L of them."""
    data = b"b" + b"a" * (L * T - 1)
    sc = ss.SeqScanner(ss.MODE_MULTI, [b"aa"])
    (counts, _e, _s, _c), (subs, lanes) = _scan(sc, data, k)
    assert int(counts.sum()) == (len(data) - 1) // 2
    assert subs == (0 if k == 1 else cs.SUB_PASSES)
    assert 0 < lanes <= L


@pytest.mark.parametrize("k", [4, 16])
def test_clean_sub_lane_after_an_unsettled_one_is_not_walked(k):
    """A `^/` line that starts in sub-lane (0, 3) and ends with a newline
    at the last byte of (1, 3): (1, 3) is unsettled (its line start lies
    beyond its warmup), (2, 3) is clean.  The first sub-lane pass repairs
    (1, 3), whose new exit then differs from (2, 3)'s sync; the clean
    sub-lane is not walked again, so one sub-lane pass walks and its
    sync stays pass 0's."""
    Tk = T // k
    b1, b2 = 3 * T + Tk, 3 * T + 2 * Tk
    data = bytearray(b" " * (L * T))
    data[b1 - 41] = 10
    data[b1 - 40] = ord("/")
    data[b1 + 20:b1 + 24] = b".php"
    data[b2 - 1] = 10
    data = bytes(data)
    sc = _scanner("line_anchored_php")
    Wk = min(max(W, 4 * sc.M + 4), T)
    dev = _t(data)
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim, _entry0 = sc.first_pass(dev, len(data), L, T, Wk, k)
    _c0, _x0, sync0, clean0 = ss.seq_lanes_plain(
        sc.mode, sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen, tiles,
        Wk // 4, e0, o0, lim)
    assert not clean0[1, 3] and clean0[2, 3]
    (counts, _e, sync, clean), (subs, lanes) = _scan(sc, data, k)
    assert int(counts.sum()) == _oracle("line_anchored_php", data) == 1
    assert (subs, lanes) == (1, 0)
    assert torch.equal(clean, clean0)
    assert int(sync[2, 3]) == int(sync0[2, 3])


@pytest.mark.parametrize("k", [2, 4, 16])
def test_lane_pass_walks_a_clean_first_sub_lane_from_its_own_sync(k):
    """A lane pass enters a lane at the previous lane's exit, but a clean
    sub-lane 0 at its own sync: here lane 3 ends with a newline and lane 4
    opens with `/x.php`, and the exit the pass reads for lane 3 is wrong
    (0: no line start).  Sub-lane (0, 4) keeps pass 0's count, sync and
    exit; the lane's other sub-lanes walk on from that exit."""
    data = bytearray(b" " * (L * T))
    data[4 * T - 1] = 10
    data[4 * T:4 * T + 6] = b"/x.php"
    data = bytes(data)
    sc = _scanner("line_anchored_php")
    Wk = min(max(W, 4 * sc.M + 4), T)
    dev = _t(data)
    tiles = cs.make_word_tiles(dev, L, T // 4)
    e0, o0, lim, entry0 = sc.first_pass(dev, len(data), L, T, Wk, k)
    args = (sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen, tiles)
    counts, exits, sync, clean = ss.seq_lanes_plain(sc.mode, *args, Wk // 4,
                                                    e0, o0, lim)
    assert clean[0, 4] and int(counts[0, 4]) == 1
    prev = exits.clone()
    prev[k - 1, 3] = 0
    sync2 = sync.clone()
    sync2[k - 1, 4] ^= 4               # lane 4 holds an unsettled sub-lane
    out, c2, walked = torch.empty_like(prev), counts.clone(), \
        torch.zeros(1, dtype=torch.int32)
    ss.seq_repair_plain(sc.mode, True, *args, entry0, lim, prev, out, c2,
                        sync2, clean, walked)
    assert int(walked[0]) == 1
    assert int(c2[0, 4]) == 1 and int(sync2[0, 4]) == int(sync[0, 4])
    assert int(out[0, 4]) == int(exits[0, 4])
    assert torch.equal(c2, counts)
    states = _states("line_anchored_php", data)
    assert [int(x) for x in out[:, 4]] == [
        states[4 * T + (j + 1) * (T // k) - 1] for j in range(k)]


@pytest.mark.parametrize("k", SPLITS)
def test_corpus_ending_mid_sub_lane(k):
    """Corpora ending inside a sub-lane, so later sub-lanes and lanes lie
    past the end (limit 0): they stay out of the repair and the count."""
    Tk = T // k
    for name in ("multi_aa_ab_ba", "line_anchored_php"):
        sc = _scanner(name)
        for lane, j, r in ((0, 0, 7), (6, k - 1, Tk - 3), (11, k // 2, 1)):
            n = lane * T + j * Tk + r
            data = _corpus(name, n, n)
            (counts, _e, _s, _c), _passes = _scan(sc, data, k)
            assert int(counts.sum()) == _oracle(name, data)
            assert int(counts.reshape(-1)[
                cs.sub_limits(torch.full((L,), n, dtype=torch.int32)
                              - torch.arange(L, dtype=torch.int32) * T,
                              k, Tk) == 0].abs().sum()) == 0


# -- the CUDA wrappers' checks, before any launch ----------------------------

def _args(k=2, W4=4, entries=None):
    sc = _scanner("multi_aa_ab_ba")
    tiles = torch.zeros((64, L), dtype=torch.int32)
    if entries is None:
        entries = torch.zeros((k, L), dtype=torch.int32)
    z = torch.zeros(L, dtype=torch.int32)
    return (sc.mode, sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen, tiles, W4,
            entries, z, z)


@pytest.mark.parametrize("bad, match", [
    (dict(entries=torch.zeros((L, 2), dtype=torch.int32).t()),
     "contiguous"),
    (dict(entries=torch.zeros((2, L - 1), dtype=torch.int32)), "shape"),
    (dict(k=16), "whole 8-word groups"),
    (dict(k=3), "power of two"),
    (dict(k=4, W4=17), "warmup"),
])
def test_cuda_wrapper_validates_split_before_launch(bad, match):
    with pytest.raises(ValueError, match=match):
        ss.seq_lanes_cuda(*_args(**bad))


def test_cuda_repair_needs_pass_zero_image():
    a = _args()
    prev = torch.zeros((2, L), dtype=torch.int32)
    outs = [torch.zeros_like(prev) for _ in range(4)]
    walked = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needle image"):
        ss.seq_repair_cuda(a[0], False, *a[1:7], 0, a[10], prev, *outs,
                           walked, None)
    with pytest.raises(ValueError, match="int32 like prev"):
        ss.seq_repair_cuda(a[0], True, *a[1:7], 0, a[10], prev,
                           outs[0][:1], *outs[1:], walked, None)
