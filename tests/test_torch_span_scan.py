"""coregex_tpu_torch span-event scan (K2 and its plain version) against the
JAX package's span scan on the CPU.

Seeded numpy corpora go through both packages; flag words, first words,
total, EOI kind and convergence must be exactly equal.  The
JAX side runs its impl="gather" path, and once its Pallas kernel in
interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.countdfa import build_count_dfa
from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import count_scan as ref_cs
from coregex_tpu.ops import span_scan as ref
from coregex_tpu.syntax.parser import parse
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import span_scan as ss

torch.set_num_threads(1)

PATTERNS = [
    r"\d+\.\d+\.\d+\.\d+",
    r"\d+.\d+.\d+",
    r"[\w.+-]+@[\w.-]+\.[\w.-]+",
    r"\w+://[^\s]+",
    r"[a-f]+\d+x",
]
WORDS = [b"ip 10.0.0.1", b"version 1.22.3", b"error", b"u@x.com",
         b"lorem", b"9.8.7.6543", b"a.b.c", b"http://a.b/c", b"fe12x",
         b"1.2.3.4.5", b"ab", b"\n", b"cdabe", b"e@f.g"]


def _span_cd(pattern, ascii_only=True):
    nfa = compile_nfa(parse(pattern), with_captures=False,
                      ascii_only=ascii_only)
    cd = build_count_dfa(determinize(nfa, anchored=False,
                                     break_at_match=True))
    assert cd is not None and cd.spans_simple
    cd = cd.minimized()
    assert cd.spans_simple
    return cd


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 4))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _ref_full(cd, arr, geom, impl="gather", interpret=False):
    L, T, W, Lc = geom
    d = ref.DeviceSpanDFA(cd)
    jdev = jnp.asarray(arr)
    tiles = ref_cs._make_word_tiles(jdev, L, T // 4)
    Tt4 = min(64, max(8, (T // 4) // 4))
    out = ref._span_full(d.packed, d.packed_rc, d.bounds, d.starts, d.eoi,
                         d.eoi_kind, jdev, tiles, len(arr), L=L, T=T, W=W,
                         S=d.S, NSEG=d.NSEG, NB=d.NB, Tt4=Tt4, Lc=Lc,
                         impl=impl, col_of=d.col_of, row_of=d.row_of,
                         R=d.R, Cp=d.Cp, interpret=interpret)
    return [np.asarray(x) for x in out]


def _assert_same(got, exp):
    fw, gw, total, kind, conv = got
    # the reference's event count is the popcount of its flag words,
    # which are compared bit for bit
    efw, egw, _enev, etotal, ekind, econv = exp
    assert conv == bool(econv)
    np.testing.assert_array_equal(fw.numpy(), efw)
    np.testing.assert_array_equal(gw.numpy(), egw)
    assert int(total) == int(etotal)
    assert int(kind) == int(ekind)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,lc", [(300, 1024), (20000, 1024), (9000, 128)])
def test_span_full_matches_reference(pattern, n, lc):
    cd = _span_cd(pattern)
    arr = _corpus(len(pattern) * 7 + n, n)
    geom = cs.plan_geometry(n, lc=lc)
    sc = ss.SpanScanner(cd, "cpu")
    got = sc.scan(torch.from_numpy(arr.copy()), geometry=geom)
    _assert_same(got, _ref_full(cd, arr, geom))
    # the events reconstruct the host oracle's match ends
    assert int(got[2]) == cd.count_scan(arr)


def test_tables_match_reference():
    for pattern in PATTERNS:
        cd = _span_cd(pattern)
        d = ss.DeviceSpanDFA.from_host(cd, "cpu")
        np.testing.assert_array_equal(d.packed.numpy(),
                                      ref.DeviceSpanDFA(cd).packed_host)
        np.testing.assert_array_equal(d.eoi_kind.numpy(), cd.eoi_kind)


def test_rejects_non_simple_tables():
    cd = _span_cd(r"\d+\.\d+\.\d+\.\d+").without_spans()
    with pytest.raises(ValueError):
        ss.DeviceSpanDFA.from_host(cd, "cpu")


def test_span_full_matches_pallas_interpret():
    cd = _span_cd(r"[a-f]+\d+x")
    arr = _corpus(3, 1500)
    geom = cs.plan_geometry(len(arr), lc=128)
    got = ss.SpanScanner(cd, "cpu").scan(torch.from_numpy(arr.copy()),
                                        geometry=geom)
    _assert_same(got, _ref_full(cd, arr, geom, impl="pallas",
                                interpret=True))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_to_global_masks_bits_past_n(n):
    """Bits at positions >= n clear, bit 31 included (INT32_MIN words)."""
    L, T4 = 4, 8
    words = torch.full((T4 // 8, L), -1, dtype=torch.int32)
    g = ss.to_global(words, n).numpy().astype(np.uint32)
    bits = np.unpackbits(g.view(np.uint8), bitorder="little")
    assert bits.sum() == n and bits[:n].all()
