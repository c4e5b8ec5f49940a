"""coregex_tpu_torch window-flag scan (the plain version of
csrc/window_scan.cu) against the JAX package's _window_scan_flags
(impl="gather") on the CPU, and the reverse start search of find_first
against the host's find_rev_start.

Both packages get the same dense DFA (built by the JAX package's host
pipeline), the same corpus and the same seeded random starts and edge
limits; the flag bitmap [B, W + 1] and alive must be exactly equal.  The
port's reverse mode reads the forward corpus backwards and must equal the
reference's scan of the flipped copy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.dfa.search import find_rev_start
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import dfa_scan as ref
from coregex_tpu.syntax.parser import parse
from coregex_tpu_torch.ops import dfa_scan

torch.set_num_threads(1)

WORDS = [b"ip 10.0.0.1", b"a.b.txt", b"error", b"u@x.com", b"lorem\n",
         b"9.8.7.6543", b"x_y", b"/www/a.php", b"fe12x", b"keyword", b"ab"]


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    out = b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 4))
    return np.frombuffer(out[:n].ljust(n, b" "), dtype=np.uint8)


def _dfa(pattern, reverse):
    nfa = compile_nfa(parse(pattern), with_captures=False, reverse=reverse)
    return determinize(nfa, anchored=True, break_at_match=False,
                       reverse=reverse)


def _unpack(flagw, W):
    B = int(flagw.shape[1])
    bits = np.unpackbits(flagw.t().contiguous().numpy().view(np.uint8),
                         bitorder="little").reshape(B, -1)
    return bits[:, :W + 1].astype(bool)


CASES = [(r"\d+\.\d+", True), (r".*\.txt", True), (r"\w+\b", False),
         (r"(?m)^/.*\.php$", True)]


@pytest.mark.parametrize("W", [64, 256])
@pytest.mark.parametrize("pattern,reverse", CASES)
def test_window_flags_match_reference(pattern, reverse, W):
    d = _dfa(pattern, reverse)
    dd = ref.DeviceDFA.from_dense(d)
    mt = dfa_scan.MatchTables(dfa_scan.DFATables.from_dense(d), "cpu")
    arr = _corpus(5, 3000)
    n = len(arr)
    rng = np.random.default_rng(W)
    B = 32
    starts = rng.integers(0, n + 1, B).astype(np.int32)
    starts[:3] = [0, n, n - 1]
    edge = np.minimum(starts + rng.integers(0, 2 * W, B),
                      n + 8).astype(np.int32)
    edge[:4] = n
    # the reference scans a flipped copy in reverse; the port reads the
    # forward corpus backwards
    scanned = arr[::-1].copy() if reverse else arr
    fr, ar = ref._window_scan_flags(
        dd.delta, dd.match_on, dd.comb, dd.match_eoi, dd.starts, dd.bounds,
        jnp.asarray(scanned), jnp.asarray(starts), jnp.int32(n),
        jnp.asarray(edge), B=B, W=W, S=dd.num_states, C=dd.num_classes,
        impl="gather")
    flagw, alive = dfa_scan.window_flags(
        mt, torch.from_numpy(arr.copy()), torch.from_numpy(starts),
        torch.from_numpy(edge), W, reverse=reverse)
    assert flagw.dtype == torch.int32
    assert tuple(flagw.shape) == (dfa_scan.window_words(W), B)
    np.testing.assert_array_equal(_unpack(flagw, W), np.asarray(fr))
    np.testing.assert_array_equal(alive.numpy().astype(bool),
                                  np.asarray(ar))


@pytest.mark.parametrize("pattern", [r"\d+\.\d+\.\d+", r".*\.txt",
                                     r"(a|b)+\b"])
def test_rev_start_matches_host(pattern):
    """BatchEngine._rev_start (window kernel from the end, x4 windows)
    gives the host's find_rev_start for every match end; a short first
    window forces escalation."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.utils.corpus_cache import device_corpus
    be = ct.compile(pattern, device="cpu").batch_engine()
    be.REV_WINDOW = 4
    rev = be._chunk_scanner("rev_anch")
    arr = _corpus(9, 2000)
    ends = [e for e in range(len(arr) + 1)
            if find_rev_start(be._dense("rev_anch"), arr, 0, e) >= 0]
    assert ends
    dev = device_corpus(arr, "cpu")
    for e in ends[:40] + ends[-5:]:
        assert be._rev_start(rev, dev, e) == find_rev_start(
            be._dense("rev_anch"), arr, 0, e), e


def test_cuda_wrapper_validates_before_launch():
    d = _dfa(r"ab", True)
    mt = dfa_scan.MatchTables(dfa_scan.DFATables.from_dense(d), "cpu")
    data = torch.zeros(100, dtype=torch.uint8)
    lanes = torch.zeros(16, dtype=torch.int32)
    args = dfa_scan.window_args(mt, data, lanes, lanes, 64)
    with pytest.raises(ValueError, match="int32"):
        dfa_scan.window_flags_cuda(*args[:6], lanes.long(), *args[7:])
    with pytest.raises(ValueError, match="uint8"):
        dfa_scan.window_flags_cuda(*args[:4], data.int(), *args[5:])
    with pytest.raises(ValueError, match="shapes"):
        dfa_scan.window_flags_cuda(*args[:7], lanes[:3], *args[8:])
