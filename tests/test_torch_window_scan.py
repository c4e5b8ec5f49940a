"""coregex_tpu_torch window scan (the plain versions of
csrc/window_scan.cu's two forms) against the JAX package's
_window_scan_flags (impl="gather") on the CPU, the round loop window_ends
against the flags-form rounds it replaced and the reference's
WindowScanner.ends_for_starts_device, and the reverse start search of
find_first against the host's find_rev_start.

Both packages get the same dense DFA (built by the JAX package's host
pipeline), the same corpus and the same seeded random starts and edge
limits; the flag bitmap [B, W + 1] and alive must be exactly equal, and
the ends form's ends must equal start + the reference's last flag (or -1).
The port's reverse mode reads the forward corpus backwards and must equal
the reference's scan of the flipped copy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coregex_tpu.dfa.determinize import determinize
from coregex_tpu.dfa.search import find_rev_start
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.ops import dfa_scan as ref
from coregex_tpu.ops.bytescan import _bucket
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


def _lanes(kind, n, B, seed):
    """Seeded starts in [0, n]: the first 16 within 16 bytes of 0 and of
    n, then random, sorted for "ascending"."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n + 1, B).astype(np.int32)
    starts[:16] = np.r_[np.arange(8), n - np.arange(8)]
    if kind == "ascending":
        starts.sort()
    return starts


def _ref_ends(dd, scanned, starts, edge, W):
    """The reference's flags (flags bitmap, alive) and its composition with
    the last flag: start + the last set column, or -1."""
    n = len(scanned)
    B = len(starts)
    fr, ar = ref._window_scan_flags(
        dd.delta, dd.match_on, dd.comb, dd.match_eoi, dd.starts, dd.bounds,
        jnp.asarray(scanned), jnp.asarray(starts), jnp.int32(n),
        jnp.asarray(edge), B=B, W=W, S=dd.num_states, C=dd.num_classes,
        impl="gather")
    fr = np.asarray(fr)
    cols = np.arange(W + 1)[None, :]
    last = np.where(fr, cols, -1).max(axis=1)
    return (np.where(last >= 0, starts + last, -1).astype(np.int32),
            np.asarray(ar))


@pytest.mark.parametrize("kind", ["ascending", "random"])
@pytest.mark.parametrize("W", [64, 256, 1024])
@pytest.mark.parametrize("pattern,reverse", CASES)
def test_window_ends_plain_match_reference(pattern, reverse, W, kind):
    """window_ends_plain (the ends form's plain version) against the
    reference's _window_scan_flags and a numpy last flag, bit-equal, with
    and without edge limits (edge None: n for every lane), as a direct
    write and as an idx scatter, on a corpus whose length is not a multiple
    of 16 and starts within 16 bytes of 0 and of n."""
    d = _dfa(pattern, reverse)
    dd = ref.DeviceDFA.from_dense(d)
    mt = dfa_scan.MatchTables(dfa_scan.DFATables.from_dense(d), "cpu")
    arr = _corpus(7, 3001)
    n = len(arr)
    B = 48
    starts = _lanes(kind, n, B, W)
    rng = np.random.default_rng(W + 1)
    edge = np.minimum(starts + rng.integers(0, 2 * W, B), n + 8).astype(
        np.int32)
    scanned = arr[::-1].copy() if reverse else arr
    data = torch.from_numpy(arr.copy())
    st = torch.from_numpy(starts)
    for e in (None, edge):
        want, alive = _ref_ends(dd, scanned, starts,
                                np.full(B, n, np.int32) if e is None else e,
                                W)
        args = dfa_scan.window_args(mt, data, st,
                                    None if e is None else torch.from_numpy(e),
                                    W, reverse)
        ends, al = dfa_scan.window_ends_plain(*args)
        assert ends.dtype == torch.int32 and al.dtype == torch.int32
        np.testing.assert_array_equal(ends.numpy(), want)
        np.testing.assert_array_equal(al.numpy().astype(bool), alive)
        _e, al8 = dfa_scan.window_ends_plain(*args, alive_u8=True)
        assert al8.dtype == torch.uint8
        np.testing.assert_array_equal(al8.numpy().astype(bool), alive)
        idx = rng.permutation(B + 5)[:B].astype(np.int32)
        out = torch.full((B + 5,), -9, dtype=torch.int32)
        got, _a = dfa_scan.window_ends_round(
            mt, data, st, W, edge=args[7], reverse=reverse,
            idx=torch.from_numpy(idx), out=out)
        assert got is out
        exp = np.full(B + 5, -9, np.int32)
        exp[idx] = want
        np.testing.assert_array_equal(out.numpy(), exp)


def _flag_rounds(mt, data, starts, W):
    """window_ends as the flags form computed it before the ends form: each
    round's flag bitmap reduced by window_last, the live lanes rerun from
    their starts at 4W."""
    n = int(data.shape[0])
    ends = torch.full((len(starts),), -1, dtype=torch.int32)
    todo = torch.arange(len(starts))
    while len(todo):
        Wc = min(W, n + 1)
        st = starts[todo]
        flagw, alive = dfa_scan.window_flags_plain(
            *dfa_scan.window_args(mt, data, st,
                                  torch.full_like(st, n), Wc))
        top = dfa_scan.window_last(flagw)
        ends[todo] = torch.where(top >= 0, st + top, -1).to(torch.int32)
        todo = todo[alive != 0]
        W *= 4
    return ends


@pytest.mark.parametrize("pattern", [r"\b\d+\b", r"\w+@\w+\.com\b",
                                     r"\w+\s\w+", r"a[^\n]*b"])
def test_window_ends_rounds(pattern):
    """window_ends (the ends form a round, the live lanes compacted and
    rerun at 4W) from every position of a corpus, W = 4 so that runs take
    several rounds: equal to the flags-form rounds and to the reference's
    WindowScanner.ends_for_starts_device, which hits no cap here."""
    nfa = compile_nfa(parse(pattern), with_captures=False)
    d = determinize(nfa, anchored=True, break_at_match=True)
    mt = dfa_scan.MatchTables(dfa_scan.DFATables.from_dense(d), "cpu")
    arr = _corpus(11, 1500)
    n = len(arr)
    data = torch.from_numpy(arr.copy())
    starts = torch.arange(n + 1, dtype=torch.int32)
    ends, rounds = dfa_scan.window_ends(mt, data, starts, 4)
    assert ends.dtype == torch.int32 and rounds >= 2
    np.testing.assert_array_equal(ends.numpy(),
                                  _flag_rounds(mt, data, starts, 4).numpy())
    B = _bucket(n + 1, 16)
    padded = np.full(B, n, np.int32)
    padded[:n + 1] = starts.numpy()
    scanner = ref.WindowScanner(ref.DeviceDFA.from_dense(d), init_window=4,
                                impl="gather")
    want = np.asarray(scanner.ends_for_starts_device(
        jnp.asarray(arr), jnp.asarray(padded), n + 1))[:n + 1]
    np.testing.assert_array_equal(ends.numpy(), want)
    out = torch.full((n + 1,), 7, dtype=torch.int32)
    got, rounds2 = dfa_scan.window_ends(mt, data, starts, 4, out=out)
    assert got is out and rounds2 == rounds
    np.testing.assert_array_equal(out.numpy(), ends.numpy())


@pytest.mark.parametrize("window", [1, 16, 64])
@pytest.mark.parametrize("pattern", [r"\d+\.\d+\.\d+", r"\w+\b"])
def test_rev_start_ends_form(pattern, window):
    """_rev_start through the ends form (one lane, x4 windows from
    REV_WINDOW) gives the host's find_rev_start for every match end, and
    its launches count on WINDOW_ENDS_KERNEL only on a card."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.utils.corpus_cache import device_corpus
    be = ct.compile(pattern, device="cpu").batch_engine()
    be.REV_WINDOW = window
    rev = be._chunk_scanner("rev_anch")
    arr = _corpus(13, 1200)
    ends = [e for e in range(len(arr) + 1)
            if find_rev_start(be._dense("rev_anch"), arr, 0, e) >= 0]
    assert ends
    dev = device_corpus(arr, "cpu")
    before = dfa_scan.WINDOW_ENDS_KERNEL.launches
    for e in ends[:30] + ends[-5:]:
        assert be._rev_start(rev, dev, e) == find_rev_start(
            be._dense("rev_anch"), arr, 0, e), e
    assert dfa_scan.WINDOW_ENDS_KERNEL.launches == before


def test_cuda_ends_wrapper_validates_before_launch():
    """window_ends_cuda rejects bad arguments with ValueError before it
    builds or launches anything."""
    d = _dfa(r"ab", True)
    mt = dfa_scan.MatchTables(dfa_scan.DFATables.from_dense(d), "cpu")
    data = torch.zeros(100, dtype=torch.uint8)
    lanes = torch.zeros(16, dtype=torch.int32)
    args = dfa_scan.window_args(mt, data, lanes, None, 64)
    out = torch.zeros(20, dtype=torch.int32)
    bad = [
        ((*args[:6], lanes.long(), *args[7:]), {}, "int32"),
        ((*args[:4], data.int(), *args[5:]), {}, "uint8"),
        ((*args[:7], lanes[:3], *args[8:]), {}, "shapes"),
        (args, dict(idx=lanes), "needs its out"),
        (args, dict(idx=lanes.long(), out=out), "int32"),
        (args, dict(idx=lanes[:5], out=out), "shapes"),
        (args, dict(out=out), "shapes"),
        (args, dict(out=torch.zeros(16, dtype=torch.int64)), "int32"),
        ((*args[:8], 0), {}, "window width"),
        ((*args[:6], lanes[::2].clone().t(), *args[7:]), dict(
            idx=torch.zeros(16, dtype=torch.int32)[::2], out=out),
         "contiguous"),
    ]
    for a, kw, what in bad:
        with pytest.raises(ValueError, match=what):
            dfa_scan.window_ends_cuda(*a, **kw)
