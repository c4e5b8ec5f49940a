"""coregex_tpu_torch's nullable find_all (NULLABLE_CORE plans) against the
JAX package on the CPU: the rune-boundary mask, the empty fill and the
merge as functions on the same inputs, then find_all_spans_device and
find_all_index through the public API on seeded ASCII, UTF-8 and byte-soup
corpora of at least 16 KiB, and the routing contract (served patterns
never reach the host loop; a literal core, a {m,k} class core and
leftmost-longest decline and are counted), and chip_smoke.py's scaling of
that oracle from one tile to many.  All outputs are integers: exact
equality.

Python's re is no oracle for nullable patterns as it stands: it admits an
empty match right after a non-empty one, Go does not.  `go_spans` drops
those matches; on ASCII corpora (every position a rune boundary) it is
then Go's FindAll."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.ops import compact2 as ref_c2
from coregex_tpu.ops import span_chain as ref_sc
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import compact2 as c2
from coregex_tpu_torch.ops import span_chain as sc
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import _arr, _log_corpus

torch.set_num_threads(1)

# (pattern, route on an ASCII corpus)
SERVED = [(r"\w*", "nullable_k8"), (r"\d*", "nullable_k8"),
          (r"[a-z]*", "nullable_k8"), (r"(\d+\.\d+\.\d+\.\d+)?", "nullable"),
          (r"(?:ab|cd)*", "nullable"), (r"(ab|a)*", "nullable"),
          (r"(?m)(^/.*\.php)?", "nullable")]


def go_spans(pattern: str, text: bytes):
    """Go's FindAll from re.finditer: drop each empty match that abuts the
    previous match."""
    out, prev_end = [], -1
    for m in re.finditer(pattern.encode(), text):
        s, e = m.span()
        if not (s == e == prev_end):
            out.append((s, e))
        prev_end = e
    return out


def ref_spans(pattern: str, text: bytes):
    """The JAX package's exact FindAll: its host walk (its device path on
    the CPU compiles for seconds per pattern and corpus length)."""
    eng = ref_ct.compile(pattern)
    eng.batch_threshold = 1 << 30
    return eng.find_all_index(text)


def _corpora():
    t = _log_corpus(21, 17000)
    u = bytearray(t)
    for p in range(50, len(u) - 4, 601):
        u[p:p + 4] = "é☃\U0001F600".encode()[:4]
    soup = np.random.default_rng(22).integers(0, 256, 17000, dtype=np.uint8)
    return {"ascii": t, "utf8": bytes(u), "soup": soup.tobytes()}


def test_rune_boundaries_match_reference():
    for t in _corpora().values():
        for n in (4, 5, 1000, len(t)):
            d = np.frombuffer(t[:n], np.uint8)
            np.testing.assert_array_equal(
                sc._rune_boundaries(torch.from_numpy(d.copy()), n).numpy(),
                np.asarray(ref_sc._rune_boundaries(jnp.asarray(d), n)))


@pytest.mark.parametrize("core", [r"\d+\.\d+\.\d+\.\d+", r"[a-z]+",
                                  r"(?:ab|cd)+"])
@pytest.mark.parametrize("corpus", ["ascii", "utf8", "soup"])
def test_fill_and_merge_match_reference(core, corpus):
    t = _corpora()[corpus]
    d = np.frombuffer(t, np.uint8)
    n = len(d)
    # the core is not nullable, so re gives Go's spans of it
    core_spans = np.array([m.span() for m in re.finditer(core.encode(), t)],
                          dtype=np.int32).reshape(-1, 2)
    cnt = len(core_spans)
    capC = 16 * (cnt // 16 + 2)
    spans_c = np.full((capC, 2), n, dtype=np.int32)
    spans_c[:cnt] = core_spans
    ascii_ok = corpus == "ascii"
    nwb1 = c2._bucket_up(-(-(n + 1) // 32))
    words, ne = sc.nullable_fill_words(torch.from_numpy(spans_c), cnt,
                                       torch.from_numpy(d.copy()), ascii_ok)
    rwords, rne = ref_sc.nullable_fill_words(
        jnp.asarray(spans_c), jnp.int32(cnt), jnp.asarray(d), ascii_ok, nwb1)
    np.testing.assert_array_equal(words.numpy(), np.asarray(rwords))
    assert int(ne) == int(rne) > 0
    ne = int(ne)
    capK = 16 * (ne // 16 + 1)
    emp, ke, ok = c2.sparse_positions_words(words, n + 1, capK)
    remp, rke, rok = ref_c2.sparse_positions_words(rwords, n + 1, capK)
    np.testing.assert_array_equal(emp.numpy(), np.asarray(remp))
    assert int(ke) == int(rke) == ne and bool(ok) and bool(rok)
    capT = 16 * ((cnt + ne) // 16 + 1)
    spans, total = sc.nullable_merge(torch.from_numpy(spans_c), cnt, emp,
                                     ne, n, capT)
    rspans, rtotal = ref_sc.nullable_merge(
        jnp.asarray(spans_c), jnp.int32(cnt), remp, jnp.int32(ne),
        jnp.int32(n), capT)
    np.testing.assert_array_equal(spans.numpy(), np.asarray(rspans))
    assert total == int(rtotal) == cnt + ne


@pytest.mark.parametrize("pattern,route", SERVED)
def test_find_all_matches_reference(pattern, route):
    for name, t in _corpora().items():
        eng = ct.compile(pattern, device="cpu")
        be = eng.batch_engine()
        assert be.plan.strategy.value == "nullable_core"
        exp = ref_spans(pattern, t)
        if name == "ascii":
            assert exp == go_spans(pattern, t)
            assert be._spans_route(_arr(t))[0] == route
        elif route == "nullable_k8":
            assert be._spans_route(_arr(t))[0] == "nullable"
        spans, cnt = be.find_all_spans_device(_arr(t))
        assert [tuple(r) for r in spans[:cnt].tolist()] == exp, name
        assert eng.find_all_index(t) == exp, name
        # the count: the nullable transducer, or outside its gate (UTF-8
        # leads, some transducers) the device find_all
        assert eng.count(t) == len(exp), name
        assert be.host_routes == 0, name


@pytest.mark.parametrize("pattern", [r"\w*", r"[a-z]*"])
def test_k8_route_matches_reference_device_path(pattern):
    t = _corpora()["ascii"]
    spans, cnt = ct.compile(pattern, device="cpu").batch_engine() \
        .find_all_spans_device(_arr(t))
    rspans, rcnt = ref_ct.compile(pattern).batch_engine() \
        .find_all_spans_device(_arr(t))
    assert cnt == rcnt
    np.testing.assert_array_equal(spans[:cnt].numpy(),
                                  np.asarray(rspans)[:rcnt])


@pytest.mark.parametrize("pattern", [r"(foo)?", r"a{0,3}"])
def test_unserved_cores_decline_before_upload(pattern):
    t = _log_corpus(23, 17000)
    eng = ct.compile(pattern, device="cpu")
    assert eng.batch_engine().plan.strategy.value == "nullable_core"
    assert eng.find_all_index(t) == ref_spans(pattern, t)
    assert eng.batch_engine().host_routes == 1
    assert corpus_cache._entry(_arr(t), "cpu").buf is None


def test_leftmost_longest_stays_on_host():
    t = _log_corpus(24, 17000)
    eng = ct.compile_posix(r"\w*", device="cpu")
    ref = ref_ct.compile_posix(r"\w*")
    assert eng.find_all_index(t) == ref.find_all_index(t)
    assert eng.batch_engine().plan.strategy.value == "host"


def test_limits_decline_or_raise():
    c = _corpora()
    eng = ct.compile(r"\w*", device="cpu")
    be = eng.batch_engine()
    be.DEVICE_SPANS_LIMIT = 1000          # the general path only
    assert eng.find_all_index(c["utf8"]) == ref_spans(r"\w*", c["utf8"])
    assert be.host_routes == 1
    assert eng.find_all_index(c["ascii"]) == go_spans(r"\w*", c["ascii"])
    assert be.host_routes == 1
    be.MAX_DEVICE_SPANS = 100
    for t in (c["ascii"], _log_corpus(25, 17000)):
        with pytest.raises(ValueError, match="span limit"):
            be.find_all_spans_device(_arr(t))
    gen = ct.compile(r"(\d+\.\d+\.\d+\.\d+)?", device="cpu").batch_engine()
    gen.MAX_DEVICE_SPANS = 100
    with pytest.raises(ValueError, match="span limit"):
        gen.find_all_spans_device(_arr(c["ascii"]))


@pytest.mark.parametrize("pattern", [p for p, _ in SERVED] + [r"[\w]+"])
def test_chip_smoke_tiled_oracle(pattern):
    """chip_smoke.py scales the Go-rule spans of one line-aligned tile to
    many; on three tiles the scaled list and its digest equal the oracle's
    own."""
    import chip_smoke
    base = _log_corpus(26, 5000)
    base = base[:base.rfind(b"\n") + 1]
    B, reps = len(base), 3
    spans0 = chip_smoke.oracle_spans(pattern, base)
    assert spans0 == go_spans(pattern, base)
    inner, tail = chip_smoke.tiled_spans(spans0, B, reps)
    exp = chip_smoke.oracle_spans(pattern, base * reps)
    assert chip_smoke.expand_tiles(inner, tail, B, reps) == exp
    cnt, ss, es, sidx, samp = chip_smoke.tiled_digest(
        inner, tail, B, reps, np.random.default_rng(0))
    assert cnt == len(exp)
    assert ss == sum(s for s, _ in exp) % 2 ** 32
    assert es == sum(e for _, e in exp) % 2 ** 32
    np.testing.assert_array_equal(samp, np.array([exp[i] for i in sidx]))
