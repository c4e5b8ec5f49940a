"""coregex_tpu_torch's class-run find_all (CHARCLASS plans) against the JAX
package on the CPU: the class masks, run words, sparse chain and pair
assembly as functions on the same inputs, then find_all_spans_device and
find_all_index through the public API on seeded corpora of at least 16 KiB,
with the sparse-chain and the dense-pair branch both taken.  All outputs
are integers: exact equality."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.meta import batch as ref_batch
from coregex_tpu.ops import bytescan as ref_bs
from coregex_tpu.ops import compact2 as ref_c2
from coregex_tpu.ops import span_chain as ref_sc
import coregex_tpu_torch as ct
from coregex_tpu_torch.meta import batch
from coregex_tpu_torch.ops import bytescan as bs
from coregex_tpu_torch.ops import compact2 as c2
from coregex_tpu_torch.ops import span_chain as sc
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus

torch.set_num_threads(1)

W_TABLE = np.zeros(256, dtype=bool)
for lo, hi in ((48, 57), (65, 90), (95, 95), (97, 122)):
    W_TABLE[lo:hi + 1] = True


def _soup(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _eq(got, exp):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(exp))


def test_class_masks_match_reference():
    data = _soup(1, 20000)
    d, jd = torch.from_numpy(data), jnp.asarray(data)
    for table in (W_TABLE, np.arange(256) % 3 == 0, np.zeros(256, bool)):
        ranges = bs.table_to_ranges(table)
        assert ranges == ref_bs.table_to_ranges(table)
        _eq(bs._range_mask(d, ranges), ref_bs._range_mask(jd, ranges))
        _eq(bs._class_mask_from_table(d, table),
            ref_bs._class_mask_from_table(jd, table))
        assert int(bs.mask_count(bs._range_mask(d, ranges))) == int(
            ref_bs.mask_count(ref_bs._range_mask(jd, ranges)))


@pytest.mark.parametrize("mmin", [1, 2, 3])
@pytest.mark.parametrize("n", [20000, 3])
def test_class_run_words_match_reference(mmin, n):
    data = np.frombuffer(_log_corpus(2, 20000), np.uint8)[:n].copy()
    ranges = bs.table_to_ranges(W_TABLE)
    d, jd = torch.from_numpy(data), jnp.asarray(data)
    for g, e in zip(sc.class_run_words(d, ranges, mmin),
                    ref_sc.class_run_words(jd, ranges, mmin)):
        _eq(g, e)
    for g, e in zip(sc.class_run_masks_dense(d, ranges, mmin),
                    ref_sc.class_run_masks_dense(jd, ranges, mmin)):
        _eq(g, e)


@pytest.mark.parametrize("dens", [0.0005, 0.01])
def test_sparse_positions_and_pairs_match_reference(dens):
    data = _soup(3, 40000)
    table = np.zeros(256, bool)
    table[:max(1, int(256 * dens * 20))] = True
    ranges = bs.table_to_ranges(table)
    n = len(data)
    d, jd = torch.from_numpy(data), jnp.asarray(data)
    ws, we, cs, _ce = sc.class_run_words(d, ranges, 1)
    rws, rwe, _rcs, _rce = ref_sc.class_run_words(jd, ranges, 1)
    for cap in (16 * (int(cs) // 16 + 1), max(1, int(cs) // 2)):
        for g, e in zip(c2.sparse_positions_words(ws, n, cap),
                        ref_c2.sparse_positions_words(rws, n, cap)):
            _eq(g, e)
        for g, e in zip(sc.pair_spans_sparse(ws, we, n, n, cap, 1),
                        ref_sc.pair_spans_sparse(rws, rwe, n, n, cap, 1)):
            _eq(g, e)


def test_chop_runs_matches_reference():
    rng = np.random.default_rng(4)
    s = np.sort(rng.choice(10000, 300, replace=False)).astype(np.int32)
    e = s + rng.integers(0, 30, 300).astype(np.int32)
    spans = np.stack([s, e], 1)
    for mn, mx in ((2, 8), (1, 3), (3, 3)):
        _eq(batch._chop_runs(torch.from_numpy(spans), mn, mx),
            ref_batch._chop_runs(jnp.asarray(spans), 300, 300, mn, mx))


# (pattern, branch taken for the ASCII log corpus)
CASES = [(r"[\w]+", "dense"), (r"(\w{2,8})+", "dense"),
         (r"[0-9]+", "dense"), (r"(\d{3,4})+", "sparse"),
         (r"[A-Z]+", "sparse"), (r"[/:]+", "sparse")]


def _corpora():
    t = _log_corpus(12, 20000)
    u = bytearray(t)
    for p in range(100, len(u) - 4, 997):
        u[p:p + 3] = "é☃".encode()[:3]
    return {"ascii": t, "utf8": bytes(u), "soup": _soup(5, 20000).tobytes()}


@pytest.mark.parametrize("pattern,branch", CASES)
def test_find_all_matches_reference(pattern, branch):
    for name, t in _corpora().items():
        eng = ct.compile(pattern, device="cpu")
        be = eng.batch_engine()
        assert be.plan.strategy.value == "charclass"
        exp = ref_ct.compile(pattern).find_all_index(t)
        if name == "ascii":
            assert exp == [m.span() for m in re.finditer(pattern.encode(), t)]
            runs = int(sc.class_run_words(
                torch.from_numpy(_arr(t).copy()),
                bs.table_to_ranges(np.array(be.plan.charclass.table)),
                max(1, be.plan.charclass.min))[2])
            assert (runs / len(t) < sc.SPARSE_OK) == (branch == "sparse")
        spans, cnt = be.find_all_spans_device(_arr(t))
        assert [tuple(r) for r in spans[:cnt].tolist()] == (exp or []), name
        assert eng.find_all_index(t) == exp, name
        assert be.host_routes == 0


def test_warm_defer_path():
    """The class-run route has one form, whose one sync for the run count
    sizes each column (measured faster at 1536 MiB than the form that
    deferred it on a warm call): cold and warm calls alike return an int
    count, validated (ok None), and the same spans."""
    t = _log_corpus(13, 20000)
    eng = ct.compile(r"(\w{2,8})+", device="cpu")
    be = eng.batch_engine()
    exp = ref_ct.compile(r"(\w{2,8})+").find_all_index(t)
    for _ in range(2):
        spans, cnt, ok = be.find_all_spans_device(_arr(t), defer_ok=True)
        assert isinstance(cnt, int) and ok is None and cnt == len(exp)
        assert [tuple(r) for r in spans[:cnt].tolist()] == exp


@pytest.mark.parametrize("pattern,longest", [
    (r"[a-z]{2,5}", False), (r"\w{3,}", False), (r"[\w]+", True)])
def test_declines_are_counted_before_upload(pattern, longest):
    """Class plans, leftmost-longest ones among them, decline past the span
    limit before the upload and are counted; within it they are served on
    the device, equal to the reference (leftmost-longest: its host walk),
    and the leftmost-first {m,k} splits too."""
    t = _log_corpus(14, 20000)
    corpus_cache.clear()
    eng = ct.compile(pattern, device="cpu", longest=True)
    ref = ref_ct.compile(pattern, longest=True)
    ref.batch_threshold = 1 << 30
    be = eng.batch_engine()
    be.SPARSE_SPANS_LIMIT = len(t) - 1
    exp = ref.find_all_index(t)
    assert eng.find_all_index(t) == exp
    assert be.host_routes == 1
    assert corpus_cache._entry(_arr(t), "cpu").buf is None
    del be.SPARSE_SPANS_LIMIT
    assert be._spans_route(_arr(t))[0] == "charclass"
    assert eng.find_all_index(t) == exp
    assert eng.count(t) == len(exp)
    assert be.host_routes == 1
    if not longest:
        eng = ct.compile(pattern, device="cpu")
        ref = ref_ct.compile(pattern)
        ref.batch_threshold = 1 << 30
        assert eng.find_all_index(t) == ref.find_all_index(t)
        assert eng.batch_engine().host_routes == 0


def test_span_limit_raises():
    """Past MAX_DEVICE_SPANS runs the class-run route no longer raises: it
    compacts its run starts and ends in pieces of the limit, and gives
    the reference's spans on the device."""
    t = _log_corpus(15, 20000)
    eng = ct.compile(r"[\w]+", device="cpu")
    be = eng.batch_engine()
    be.MAX_DEVICE_SPANS = 8
    ref = ref_ct.compile(r"[\w]+")
    ref.batch_threshold = 1 << 30
    assert eng.find_all_index(t) == ref.find_all_index(t)
    assert be.host_routes == 0 and be.pieces[0] >= 2
