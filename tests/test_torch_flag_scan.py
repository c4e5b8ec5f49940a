"""coregex_tpu_torch reset flag scan (K3 and its plain version) against the
JAX package's flag scan on the CPU.

Both packages get the same minimized reverse DFA, the same corpus and the
same reset positions; position-major flag words, interference, convergence
and the lane-entry hint must be exactly equal, with and without a hint.
The JAX side runs its impl="gather" path, and once its Pallas kernel in
interpret mode.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.dense import CTX_OTHER
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import flag_scan as ref
from coregex_tpu.ops.dfa_scan import DeviceDFA
from coregex_tpu.syntax.parser import parse
from coregex_tpu_torch.ops import dfa_scan
from coregex_tpu_torch.ops import flag_scan as fs

torch.set_num_threads(1)

PATTERNS = [
    r"\d+\.\d+\.\d+\.\d+",
    r"\d+.\d+.\d+",
    r"[\w.+-]+@[\w.-]+\.[\w.-]+",
    r"\w+://[^\s]+",
    r"[a-f]+\d+x",
]


def _rev_dfa(pattern):
    nfa = compile_nfa(parse(pattern), reverse=True, ascii_only=True)
    return determinize(nfa, anchored=True, break_at_match=False,
                       reverse=True).minimized()


WORDS = [b"ip 10.0.0.1", b"version 1.22.3", b"error", b"u@x.com",
         b"lorem", b"9.8.7.6543", b"a.b.c", b"http://a.b/c", b"fe12x",
         b"1.2.3.4.5", b"ab", b"\n", b"cdabe", b"e@f.g"]


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 4))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _match_resets(pattern, arr, dead=0):
    """Reversed positions of the pattern's match ends (where the bidi path
    resets the reverse scan), ascending, then `dead` -1s."""
    ends = [m.end() for m in re.finditer(pattern.encode(), arr.tobytes())]
    rq = sorted(len(arr) - e for e in ends)
    return np.asarray(rq + [-1] * dead, dtype=np.int32)


def _resets(seed, n, k, dead=0):
    """k unique ascending reset positions in [0, n], then `dead` -1s."""
    rng = np.random.default_rng(seed + 1)
    pos = np.sort(rng.choice(n + 1, size=min(k, n + 1), replace=False))
    return np.concatenate([pos, -np.ones(dead, np.int64)]).astype(np.int32)


def _both_tiles(dfa, arr, rq, pre):
    """(port scanner, port reset tiles, ref scanner, ref reset tiles)."""
    n = len(arr)
    L, T, _W, Lc = fs.reset_geometry(n)
    sc = fs.FlagResetScanner(dfa, CTX_OTHER, "cpu", flag_pre_reset=pre)
    rsc = ref.FlagResetScanner(DeviceDFA.from_dense(dfa), CTX_OTHER,
                               impl="gather", flag_pre_reset=pre)
    flipped = torch.from_numpy(arr[::-1].copy())
    tiles = fs.scatter_reset_tiles(
        fs.sym_base_tiles(flipped, sc.byte_bounds(), L, T // 4),
        torch.from_numpy(rq), L, T // 4)
    rbase = ref._sym_base_tiles(jnp.asarray(arr[::-1].copy()),
                                rsc.byte_bounds(), L, T // 4)
    rtiles = ref.scatter_reset_tiles(rbase, jnp.asarray(rq), L, T // 4)
    return sc, tiles, rsc, rtiles


def _assert_same(got, exp):
    fw, interf, conv, hint = got
    efw, einterf, econv, ehint = (np.asarray(x) for x in exp)
    assert conv == bool(econv)
    np.testing.assert_array_equal(fw.numpy(), efw)
    assert int(interf) == int(einterf)
    np.testing.assert_array_equal(hint.numpy().reshape(-1), ehint)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("pre", [True, False])
def test_flag_scan_matches_reference(pattern, pre):
    dfa = _rev_dfa(pattern)
    n = 20000
    arr = _corpus(len(pattern), n)
    rq = _match_resets(pattern, arr, dead=5)
    sc, tiles, rsc, rtiles = _both_tiles(dfa, arr, rq, pre)
    got = sc.scan_tiles(tiles, n)
    _assert_same(got, rsc.scan_tiles(rtiles, n))
    assert len(rq) > 5 and bool(got[0].any())
    # a converged scan's hint makes the next scan one pass; same outputs
    got2 = sc.scan_tiles(tiles, n, entries_hint=got[3])
    _assert_same(got2, rsc.scan_tiles(rtiles, n,
                                      entries_hint=jnp.asarray(
                                          got[3].numpy().reshape(-1))))
    np.testing.assert_array_equal(got2[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_match_reference(pattern):
    dfa = _rev_dfa(pattern)
    for pre in (True, False):
        t = fs.ResetFlagTables.from_host(dfa, CTX_OTHER, "cpu",
                                         flag_pre_reset=pre)
        r = ref.ResetFlagTables(DeviceDFA.from_dense(dfa), CTX_OTHER,
                                flag_pre_reset=pre)
        np.testing.assert_array_equal(t.packed_full.numpy(),
                                      np.asarray(r.packed_full))
        np.testing.assert_array_equal(t.bounds, r.bounds)


def test_dense_tables_match_reference():
    for pattern in PATTERNS:
        dfa = _rev_dfa(pattern)
        t = dfa_scan.DFATables.from_dense(dfa)
        r = DeviceDFA.from_dense(dfa)
        for name in ("delta", "match_on", "bounds"):
            np.testing.assert_array_equal(getattr(t, name),
                                          np.asarray(getattr(r, name)))
        np.testing.assert_array_equal(t.host_starts, r.host_starts)


@pytest.mark.parametrize("dead", [0, 1, 2])
def test_reset_tiles_match_reference(dead):
    """The reset scatter equals the reference's except where the reference
    sends a dead entry (-1) to its last tile word; the port drops it."""
    dfa = _rev_dfa(r"\d+\.\d+\.\d+\.\d+")
    n = 5000
    arr = _corpus(9, n)
    rq = _resets(9, n, 200, dead=dead)
    _sc, tiles, _rsc, rtiles = _both_tiles(dfa, arr, rq, True)
    got = tiles.numpy().reshape(-1)
    exp = np.asarray(rtiles).reshape(-1)
    np.testing.assert_array_equal(got[:-1], exp[:-1])
    rtiles_live = ref.scatter_reset_tiles(
        ref._sym_base_tiles(jnp.asarray(arr[::-1].copy()),
                            _sc.byte_bounds(), *_geom_lt4(n)),
        jnp.asarray(rq[rq >= 0]), *_geom_lt4(n))
    np.testing.assert_array_equal(got, np.asarray(rtiles_live).reshape(-1))


def _geom_lt4(n):
    L, T, _W, _Lc = fs.reset_geometry(n)
    return L, T // 4


def test_flag_scan_matches_pallas_interpret():
    dfa = _rev_dfa(r"[a-f]+\d+x")
    n = 700
    arr = _corpus(4, n)
    rq = _resets(4, n, 40)
    sc, tiles, rsc, rtiles = _both_tiles(dfa, arr, rq, True)
    rsc.impl = "pallas"
    _assert_same(sc.scan_tiles(tiles, n),
                 rsc.scan_tiles(rtiles, n, interpret=True))
