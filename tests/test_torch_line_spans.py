"""coregex_tpu_torch line-shape extraction on the candidate chain, and the
sparse chain with 3 and 5 word payloads, against the JAX package (its XLA
path on the CPU) and Python's re.

Spans, counts and ok flags are integers, so the tolerance is exact
equality.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coregex_tpu.ops import compact2 as ref_c2
from coregex_tpu.ops import span_chain as ref_sc
from coregex_tpu.ops.bytescan import _bucket
from coregex_tpu_torch.ops import compact2 as c2
from coregex_tpu_torch.ops import span_chain as sc

torch.set_num_threads(1)

# (mode, literal, prefix, anchored, the pattern with these semantics)
SHAPES = [
    ("bol_to_eol", b"keyword", b"", False, rb".*keyword.*"),
    ("bol_to_last", b".txt", b"", False, rb".*\.txt"),
    ("first_to_eol", b"keyword", b"", False, rb"keyword.*"),
    ("bol_to_last", b".php", b"/", True, rb"(?m)^/.*\.php"),
    ("bol_to_eol", b".php", b"/", True, rb"(?m)^/.*\.php.*"),
]
WORDS = [b"keyword", b".txt", b"/x.php", b".php", b"a", b"bc", b"/", b"x.t"]


def _corpus(seed, size, tail=True):
    """Seeded lines of needle-ish words; the last line is unterminated
    when `tail`."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < size:
        k = int(rng.integers(0, 6))
        line = b" ".join(WORDS[int(i)] for i in
                         rng.integers(0, len(WORDS), k)) + b"\n"
        if rng.random() < 0.2:
            line = b"/" + line
        parts.append(line)
        total += len(line)
    t = b"".join(parts)[:size]
    return t.rstrip(b"\n") + b" .txt keyword" if tail else t


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _spans(spans, cnt):
    return [tuple(s) for s in _np(spans)[:int(cnt)].tolist()]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[4].decode())
def test_line_spans_match_re(shape):
    mode, lit, prefix, anchored, pattern = shape
    for seed, tail in ((1, True), (2, False), (3, True)):
        t = _corpus(seed, 6000, tail)
        dev = torch.from_numpy(np.frombuffer(t, np.uint8).copy())
        words, cnts = sc.line_event_words(dev, lit, prefix, anchored)
        exp = [m.span() for m in re.finditer(pattern, t)]
        # one run of every candidate, then runs whose seams split lines
        for limit in (1 << 30, 64, 7):
            spans, cnt, ok, _runs = sc.line_spans_pieces(
                list(words), len(t), int(cnts[1]), limit, mode, anchored,
                len(lit), len(prefix))
            assert bool(ok)
            assert _spans(spans, cnt) == exp


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[3],
                                   SHAPES[4]],
                         ids=lambda s: s[4].decode())
def test_line_spans_match_reference(shape):
    """Words, counts, spans and ok against the reference's fused producer
    and line_spans_candidates (_line_cand_spans_jit)."""
    mode, lit, prefix, anchored, _pattern = shape
    t = _corpus(4, 9000)
    arr = np.frombuffer(t, np.uint8)
    words, cnts = sc.line_event_words(torch.from_numpy(arr.copy()), lit,
                                      prefix, anchored)
    ewords, ecnts = ref_sc.line_event_words(jnp.asarray(arr), tuple(lit),
                                            tuple(prefix), anchored)
    for g, e in zip(words + cnts, ewords + ecnts):
        np.testing.assert_array_equal(_np(g), np.asarray(e))
    cap = _bucket(int(cnts[1]), 16)
    spans, cnt, ok, runs = sc.line_spans_pieces(
        list(words), len(t), int(cnts[1]), 1 << 30, mode, anchored, len(lit),
        len(prefix))
    e_spans, e_cnt, e_ok = ref_sc.line_spans_candidates(
        list(ewords), len(t), cap, mode, anchored, len(lit), len(prefix))
    # one run: the reference's count, ok and live spans (its rows past the
    # count are padding the port does not keep)
    assert runs == 1 and cnt == int(e_cnt) > 0
    assert bool(ok) and bool(e_ok)
    np.testing.assert_array_equal(_np(spans), np.asarray(e_spans)[:cnt])


def test_line_cand_spans_bit31_and_unterminated_line():
    """A candidate at bit 31 of its word, and a last line with no newline:
    its end comes from the INT32_MAX next-newline sentinel, clamped to n."""
    nwb = 1024
    nlw = np.zeros(nwb, np.int32)
    candw = np.zeros(nwb, np.int32)
    nlw[3] = 1 << 4             # newline at 100
    candw[1] = 1 << 2           # candidate at 34 (first line)
    candw[10] = -2 ** 31        # candidate at 351, bit 31 (last line)
    out = sc.line_spans_pieces(
        [torch.from_numpy(nlw), torch.from_numpy(candw)], 400, 2, 16,
        "bol_to_eol", False, 3, 0)
    assert _spans(out[0], out[1]) == [(0, 100), (101, 400)]
    assert bool(out[2])


def test_ctz_nextpos_and_pack_match_reference():
    rng = np.random.default_rng(7)
    v = np.array([0, 1, 2, 12, 2 ** 30, 2 ** 31 - 1, -2 ** 31, -1, 96,
                  -2 ** 30], dtype=np.int32)
    np.testing.assert_array_equal(sc._ctz32(torch.from_numpy(v)).numpy(),
                                  np.asarray(ref_sc._ctz32(jnp.asarray(v))))
    bits = rng.random(1024 * 32) < 0.003
    bits[31::32] |= rng.random(1024) < 0.3         # bit 31 of some words
    w = c2.pack_words(torch.from_numpy(bits), 1024)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(ref_c2.pack_words(jnp.asarray(bits), 1024)))
    np.testing.assert_array_equal(
        sc._word_nextpos_table(w, 1024).numpy(),
        np.asarray(ref_sc._word_nextpos_table(jnp.asarray(w.numpy()), 1024)))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 1000, 32 * 1024 + 5])
def test_pad_pack_matches_reference(n):
    """Word packing padded to the bucket, at and around word edges."""
    m = np.random.default_rng(n).random(n) < 0.3
    np.testing.assert_array_equal(
        sc._pad_pack(torch.from_numpy(m), n).numpy(),
        np.asarray(ref_sc._pad_pack(jnp.asarray(m), n)))


@pytest.mark.parametrize("P", [3, 5])
def test_sparse_chain_word_payloads_match_reference(P):
    """The line chain's payload counts: the port gathers word payloads
    after the last level, the reference routes them through each level."""
    rng = np.random.default_rng(70 + P)
    nw = 2000
    bits = rng.random(nw * 32) < 0.01
    bits[31::32] |= rng.random(nw) < 0.2
    words = c2.pack_words(torch.from_numpy(bits), nw).numpy()
    pays = [rng.integers(-2 ** 31, 2 ** 31, nw, dtype=np.int64).astype(
        np.int32) for _ in range(P)]
    total = int(bits.sum())
    for cap in (total + 7, total // 3):
        got = c2.sparse_chain_payloads(torch.from_numpy(words),
                                       [torch.from_numpy(p) for p in pays],
                                       2 ** 31 - 1, cap)
        exp = ref_c2.sparse_chain_payloads(jnp.asarray(words),
                                           [jnp.asarray(p) for p in pays],
                                           2 ** 31 - 1, cap)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(_np(g), np.asarray(e))
        assert bool(got[-1]) == (cap >= total)
