"""coregex_tpu_torch's BITSET_NFA tier against the JAX package on the CPU.

The tier serves patterns whose forward DFA overflows: a bitset-NFA scan
(ops/nfa_scan.py) finds every match start on the flipped corpus, the
window scan over the anchored break-at-match DFA finds their ends (the
host search does when that DFA overflows too), Go's chain selects.  Held
to the reference, with tolerance 0:

* the tables: DeviceBitsetNFA's host tables bit-equal to the reference's,
  forward and reverse, and the kernel's packed bitsets unpacking to them;
  the scope gate raising where the reference's does;
* the scan: the flags of the plain version equal the reference's
  ``_bitset_scan`` at the reference's own geometry wherever it converged,
  and the same flags at other geometries (lanes of 64-256 bytes with
  matches across the seams, sub-lanes, tiny warmups); where the
  reference stops at its 4 repair passes, the port's flags equal the
  oracle's (every end of some match, from ``re``);
* the entry points: find_all_index, count, is_match and find_index of an
  engine whose DFA overflows (state_limit 16, batch_threshold 0) equal the
  reference engine's and ``re``'s, with host_routes 0; the host-ends
  route; what declines (a nullable plan, a reverse NFA past 512 states);
* the plans at the default state limit of the patterns the chip run
  drives.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.meta.config import Config as RefConfig
from coregex_tpu.meta.engine import Engine as RefEngine
from coregex_tpu.nfa.thompson import compile_nfa as ref_compile_nfa
from coregex_tpu.ops import nfa_scan as ref_ns
from coregex_tpu.syntax.parser import parse as ref_parse
import coregex_tpu as ref_ct
import coregex_tpu_torch as ct
from coregex_tpu_torch.meta.config import Config
from coregex_tpu_torch.meta.engine import Engine
from coregex_tpu_torch.nfa.thompson import compile_nfa
from coregex_tpu_torch.ops import nfa_scan as ns
from coregex_tpu_torch.syntax.parser import parse
from coregex_tpu_torch.utils import corpus_cache

from test_bitset_nfa import CASES, LOOK_CASES

torch.set_num_threads(1)

# the patterns chip_smoke.py drives (forward DFAs past 20,000 states),
# the host-ends one (its anchored DFA overflows too) and one whose
# reverse NFA has 515 range states (out of the scan's scope)
CHIP = [r"[a-q][^u-z]{13}x", r"[A-Za-z]\w{0,30}\d{2}\b",
        r"[A-Za-z]\w{0,30}\d{2}", r"(a|b)*a(a|b){15}",
        r"\d[^\n]{16}ERROR"]
HOST_ENDS = r"[a-h]{2,10}[0-9]{2,10}[a-h]{2,10}"
SEAMS = r"q[a-p]{20,40}q"
TABLE_PATTERNS = [p for p, _ in CASES + LOOK_CASES] + CHIP + [HOST_ENDS,
                                                               SEAMS]


def _tables(pattern, reverse):
    """(reference DeviceBitsetNFA or its LookUnsupported, the port's)."""
    out = []
    for mod, comp, prs in ((ref_ns, ref_compile_nfa, ref_parse),
                           (ns, compile_nfa, parse)):
        nfa = comp(prs(pattern), reverse=reverse, with_captures=False)
        args = (nfa,) if mod is ref_ns else (nfa, "cpu")
        try:
            out.append(mod.DeviceBitsetNFA(*args))
        except mod.LookUnsupported as ex:
            out.append(str(ex))
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("pattern", TABLE_PATTERNS)
def test_tables_match_reference(pattern, reverse):
    ref, got = _tables(pattern, reverse)
    if isinstance(ref, str):
        assert got == ref                   # the same scope decision
        return
    for f in ("S", "G", "Gs", "nullable", "has_looks"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("lo", "hi", "ct", "start", "bot", "cmap", "smap"):
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f)
        assert have.dtype == want.dtype and have.shape == want.shape, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    # the kernel's bitsets unpack to the same tables, bit j = state order[j]
    S = got.S
    t = got.tables
    o = got.order
    assert sorted(o) == list(range(S))

    def unpack(x):
        return ns.unpack_sets(x.reshape(-1, got.NW), S).numpy()
    lo, hi = got.lo[o], got.hi[o]
    b = np.arange(256)[:, None]
    np.testing.assert_array_equal(unpack(t.cover), (lo <= b) & (b <= hi))
    np.testing.assert_array_equal(
        unpack(t.rows).reshape(got.G, S, S), got.ct[:, o][:, :, o])
    np.testing.assert_array_equal(unpack(t.mbits), got.ct[:, o, S])
    np.testing.assert_array_equal(unpack(t.startw), got.start[:, o])
    np.testing.assert_array_equal(unpack(t.botw), got.bot[:, o])


# the scans chip_smoke.py times (its BITSET and BITSET_HOST_ENDS) and this
# file's patterns with looks: the tables the kernel's ASCII step and its
# look-free specialisation read
STEP_PATTERNS = CHIP[:4] + [p for p, _ in LOOK_CASES]


def _step_tables(pattern, reverse):
    return ns.DeviceBitsetNFA(
        compile_nfa(parse(pattern), reverse=reverse, with_captures=False),
        "cpu")


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("pattern", STEP_PATTERNS)
def test_packed_order_and_mode(pattern, reverse):
    """The packed order puts the states that take a byte < 128 first;
    when at most 64 do (and a set has more than one word), no byte < 128
    touches a word past the first, as the kernel's ASCII step assumes.
    The kernel's table mode follows G and Gs, and the look-free mode
    (G = Gs = 1) has cmap and smap all 0, as every pattern without looks
    has."""
    d = _step_tables(pattern, reverse)
    takes_ascii = d.lo[d.order] < 128
    n_ascii = int(takes_ascii.sum())
    assert takes_ascii[:n_ascii].all() and not takes_ascii[n_ascii:].any()
    assert d.ascii_word == (d.NW > 1 and n_ascii <= 64)
    if d.ascii_word:
        assert not d.cover[:128, 1:].any()
    look_free = d.G == 1 and d.Gs == 1
    assert d.mode == (ns.MODE_FREE if look_free else ns.MODE_LOOK)
    if look_free:
        assert not d.cmap.any() and not d.smap.any()
    if not d.has_looks:
        assert look_free
    chunks = (d.G * 8 * 256 if d.ascii_word else
              d.G * d.NW * 256 * d.NW if d.NW <= 2 else 0)
    assert ns.smem_bytes(d.S, d.NW, d.G, d.Gs, d.ascii_word) == (
        8 * (d.NW * (256 + d.G * d.S + d.G + d.Gs) + chunks) + 256)
    # states of one byte range side by side, in range order
    key = list(zip(d.lo[d.order], d.hi[d.order]))
    assert key == sorted(key)


def _or_rows(rows, m):
    """OR of rows [S, NW] int64 over the states set in m [NW] int64."""
    out = np.zeros(rows.shape[1], dtype=np.int64)
    for s in np.flatnonzero(np.unpackbits(m.view(np.uint8),
                                          bitorder="little")):
        out |= rows[s]
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("pattern", STEP_PATTERNS)
def test_packed_step_equals_plain_step(pattern, reverse):
    """The kernel's step on the packed tables, m = a & cover[b], flag = m &
    mbits[cmap[ctx]], next = startw[smap[ctx]] | OR over s in m of
    rows[cmap[ctx]][s], equals one plain step (the reference's float32
    step) from random sets, for every byte in each of the 12 contexts; on
    ascii_word tables m of a byte < 128 lies in word 0, so the next set's
    other words follow from that m alone (the kernel's deferred words)."""
    d = _step_tables(pattern, reverse)
    rng = np.random.default_rng(len(pattern) + reverse)
    sets = ns.pack_sets_np(rng.random((3, d.S)) < 0.2)
    b, cx, k = np.meshgrid(np.arange(256), np.arange(12), np.arange(3),
                           indexing="ij")
    b, cx, k = b.ravel(), cx.ravel(), k.ravel()
    M = len(b)
    act = ns.unpack_sets(torch.from_numpy(sets[k]), d.S)
    nxt, flags = ns._walk_plain(
        ns.plain_tables(d, "cpu"), torch.from_numpy(b.astype(np.uint8)),
        torch.from_numpy(cx.astype(np.uint8)), torch.arange(M), 1, act,
        torch.ones(M, dtype=torch.int64), 0, True)
    got = ns.pack_sets(nxt).numpy()
    for i in range(M):
        g, sg = d.cmap[cx[i]], d.smap[cx[i]]
        m = sets[k[i]] & d.cover[b[i]]
        if d.ascii_word and b[i] < 128:
            assert not m[1:].any()
        want = d.startw[sg] | _or_rows(d.rows[g], m)
        np.testing.assert_array_equal(got[i], want)
        assert bool(flags[i, 0]) == bool((m & d.mbits[g]).any())


def test_packing_round_trips():
    rng = np.random.default_rng(4)
    for S in (1, 63, 64, 65, 421, 512):
        bits = rng.random((9, S)) < 0.3
        w = ns.pack_sets(torch.from_numpy(bits))
        np.testing.assert_array_equal(w.numpy(), ns.pack_sets_np(bits))
        np.testing.assert_array_equal(ns.unpack_sets(w, S).numpy(), bits)


# -- the scan -----------------------------------------------------------------

def _ref_flags(pattern, data, reverse, max_repair=4):
    """(flags [n] bool, converged) of the reference's _bitset_scan at its
    own geometry."""
    d = ref_ns.DeviceBitsetNFA(ref_compile_nfa(ref_parse(pattern),
                                               reverse=reverse,
                                               with_captures=False))
    n = len(data)
    L, T = ref_ns.plan_bitset_geometry(n, d.S)
    f, conv = ref_ns._bitset_scan(
        d.lo, d.hi, d.ct, d.start, d.bot, d.cmap, d.smap,
        jnp.asarray(np.frombuffer(data, np.uint8)), jnp.int32(n), S=d.S, L=L,
        T=T, G=d.G, Gs=d.Gs, max_repair=max_repair)
    return np.asarray(f)[:n], bool(conv), (L, T)


def _scanner(pattern, reverse):
    return ns.BitsetNFAScanner(
        compile_nfa(parse(pattern), reverse=reverse, with_captures=False),
        "cpu")


def _t(data):
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def _oracle_ends(pattern, data):
    """Flags of every boundary where some match of a look-free pattern
    ends: the last byte of data[s:e] for every matching slice."""
    rx = re.compile(f"(?:{pattern})\\Z".encode())
    out = np.zeros(len(data), dtype=bool)
    for e in range(1, len(data) + 1):
        out[e - 1] = rx.search(data, 0, e) is not None
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("pattern,unit", CASES + LOOK_CASES,
                         ids=[c[0] for c in CASES + LOOK_CASES])
def test_scan_matches_reference(pattern, unit, reverse):
    """At the reference's geometry (one lane a thread, no split) and at two
    others: plan_geometry's lanes split into sub-lanes, and short lanes
    whose 16-byte warmup misses live attempts, so the repair passes run."""
    data = unit * 37
    if reverse:
        data = data[::-1]
    want, conv, (L, T) = _ref_flags(pattern, data, reverse)
    assert conv
    sc = _scanner(pattern, reverse)
    x = _t(data)
    for geom, k in (((L, T, min(64, T)), 1), (None, None),
                    ((64, 64, 16), 2)):
        np.testing.assert_array_equal(sc.flags(x, geom, k), want,
                                      err_msg=str((geom, k)))


@pytest.mark.parametrize("T", [64, 128, 256])
def test_scan_seams(T):
    """Matches of 22-42 bytes across the seams of lanes of T bytes, as
    test_bitset_lane_boundary_matches places them, at a warmup of 16 bytes
    (every seam inside a match is repaired) and of 64."""
    rng = np.random.default_rng(T)
    filler = rng.integers(ord("r"), ord("z") + 1, size=6007,
                          dtype=np.uint8).tobytes()
    ins = b"q" + b"abcdefghop" * 3 + b"q"
    data = b"".join(filler[i:i + 97] + ins * (1 + i % 2)
                    for i in range(0, len(filler), 97))
    want, conv, _g = _ref_flags(SEAMS, data, False)
    assert conv and want.sum() > 30
    sc = _scanner(SEAMS, False)
    L = -(-len(data) // T)
    for W, k in ((16, 1), (64, 1), (16, 2)):
        np.testing.assert_array_equal(sc.flags(_t(data), (L, T, W), k), want)
    rwant, rconv, _g = _ref_flags(SEAMS, data[::-1], True)
    assert rconv
    np.testing.assert_array_equal(
        _scanner(SEAMS, True).flags(_t(data[::-1]), (L, T, 16), 2), rwant)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_scan_settles_where_reference_stops(reverse):
    """A thread that lives across about 20 lanes: the reference stops
    after 4 repair passes (converged False), the port's passes run on and
    give the oracle's flags."""
    pattern = r"a[^b]*b"
    data = (b"a" + b"x" * 1300 + b"b" + b"y" * 77) * 2
    if reverse:
        data = data[::-1]
    _f, conv, (L, T) = _ref_flags(pattern if not reverse else r"b[^b]*a",
                                  data, False)
    assert not conv
    want = _oracle_ends(pattern if not reverse else r"b[^b]*a", data)
    assert want.sum() >= 2
    sc = _scanner(pattern, reverse)
    ns.BITSET_KERNEL.sub_passes = ns.BITSET_KERNEL.lane_passes = 0
    np.testing.assert_array_equal(sc.flags(_t(data), (L, T, 64), 1), want)
    assert ns.BITSET_KERNEL.lane_passes > 4
    np.testing.assert_array_equal(sc.flags(_t(data), (L, T, 16), 2), want)


def test_scanner_ends_unit():
    """ends() reports exactly the boundaries where some match ends (ref.
    test_bitset_scanner_unit)."""
    data = b"xabcx abbbbc abc"
    sc = _scanner(r"ab+c", False)
    want = sorted({m.end() for m in re.finditer(rb"ab+c", data)})
    assert list(sc.ends(_t(data))) == want


def test_wrapper_checks_its_arguments():
    sc = _scanner(r"ab+c", False)
    x = _t(b"xabcx abbbbc abc" * 8)
    n = int(x.shape[0])
    from coregex_tpu_torch.ops import count_scan as cs
    tiles = cs.make_word_tiles(x, 4, 64 // 4)
    e0, o0, lim, first = ns.first_inputs(sc.d, x, n, 4, 64, 16, 2)
    with pytest.raises(ValueError, match="entries"):
        ns.bitset_walk_cuda(sc.d, tiles, 4, e0[:, :2].contiguous(),
                            o0, lim, n)
    with pytest.raises(ValueError, match="geometry"):
        ns.bitset_walk_cuda(sc.d, tiles, 9, e0, o0, lim, n)
    with pytest.raises(ValueError, match="tiles"):
        ns.bitset_walk_cuda(sc.d, tiles.long(), 4, e0, o0, lim, n)


# -- the entry points ---------------------------------------------------------

def _engines(pattern, **kw):
    ref = RefEngine(ref_parse(pattern), config=RefConfig(state_limit=16))
    eng = Engine(parse(pattern), config=Config(state_limit=16),
                 device="cpu", **kw)
    ref.batch_threshold = eng.batch_threshold = 0
    return ref, eng


def _answers(eng, data):
    return (eng.find_all_index(data), eng.count(data), eng.is_match(data),
            eng.find_index(data), eng.find_all_index(data, 3))


@pytest.mark.parametrize(
    "pattern,unit",
    CASES + LOOK_CASES + [(CASES[0][0], b"no digits here at all, words "),
                          (HOST_ENDS, b"zzzz abcd1234efgh zz hh00hh z ")],
    ids=[c[0] for c in CASES + LOOK_CASES] + ["no_match",
                                               "ref_host_ends_case"])
def test_entry_points_match_reference(pattern, unit):
    corpus_cache.clear()
    data = unit * 150
    ref, eng = _engines(pattern)
    assert eng.strategy == ref.strategy == "bitset_nfa"
    want = [m.span() for m in re.finditer(pattern.encode(), data)]
    got = _answers(eng, data)
    assert got == _answers(ref, data)
    assert got == (want or None, len(want), bool(want),
                   want[0] if want else None, want[:3] or None)
    be = eng.batch_engine()
    assert be.host_routes == 0
    assert be._spans_route(np.frombuffer(data, np.uint8))[0] == "bitset"


def test_lane_seams_through_the_engine():
    """test_bitset_lane_boundary_matches on the port: matches of 32 bytes
    every 997 across the scan's seams."""
    rng = np.random.default_rng(3)
    filler = rng.integers(ord("r"), ord("z") + 1, size=40_013,
                          dtype=np.uint8).tobytes()
    ins = b"q" + b"abcdefghop" * 3 + b"q"
    data = b"".join(filler[i:i + 997] + ins
                    for i in range(0, len(filler), 997))
    _ref, eng = _engines(SEAMS)
    want = [m.span() for m in re.finditer(SEAMS.encode(), data)]
    assert len(want) > 30
    assert eng.find_all_index(data) == want
    assert eng.count(data) == len(want)
    assert eng.find_index(data) == want[0]
    assert eng.batch_engine().host_routes == 0


def test_host_ends_route():
    """`(a|b)*a(a|b){15}` (default state limit): its anchored DFA
    overflows, so the host search finds each match's end at the device's
    starts (ref. _spans_from_starts_host); Go's restart walk skips the
    starts inside a match, and a limit stops it."""
    pattern = r"(a|b)*a(a|b){15}"
    rng = np.random.default_rng(9)
    parts = []
    for i in range(40):
        parts.append(bytes(rng.choice(np.frombuffer(b"xyz ab", np.uint8),
                                      size=400)))
        parts.append(b"ab" * (i % 5) + b"a" * (16 + i % 3) + b"b" * (i % 2))
    data = b"".join(parts)
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    eng.batch_threshold = ref.batch_threshold = 0
    be = eng.batch_engine()
    route = be._spans_route(np.frombuffer(data, np.uint8))
    assert eng.strategy == "bitset_nfa" and route[0] == "bitset"
    assert route[1][1] is None                  # no anchored tables
    want = [m.span() for m in re.finditer(pattern.encode(), data)]
    assert len(want) >= 40
    got = _answers(eng, data)
    assert got == (want, len(want), True, want[0], want[:3])
    assert got == _answers(ref, data)
    assert be.host_routes == 0


@pytest.mark.parametrize("pattern,plan", [
    (r"([a-f]{2,9}[0-9]{2,9})*", "host"),      # nullable: no bitset plan
    (r"\d[^\n]{16}ERROR", "bitset_nfa")])      # reverse NFA: 515 states
def test_declines_match_reference(pattern, plan):
    corpus_cache.clear()
    data = b"x 1 abcdefghijklmnopERROR ab12cd34 9 ERROR\n" * 300
    ref, eng = _engines(pattern)
    assert eng.strategy == ref.strategy == plan
    assert _answers(eng, data) == _answers(ref, data)
    be = eng.batch_engine()
    if plan == "host":
        return                                  # never asks the batch
    assert be._spans_route(np.frombuffer(data, np.uint8)) is None
    # find_all, count (and its find_all), find_index and find_all(t, 3)
    # decline; is_match takes the forward scan (328 states, in scope)
    assert be.host_routes == 5
    assert be._bitset_scanner("fwd") and not be._bitset_scanner("rev")


@pytest.mark.parametrize("pattern", CHIP)
def test_plans_at_the_default_limit(pattern):
    """The chip run's patterns plan BITSET_NFA at the default state limit,
    as in the reference."""
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    assert eng.strategy == ref.strategy == "bitset_nfa"
    assert eng.strategy_reason == ref.strategy_reason
