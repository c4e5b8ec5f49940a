"""coregex_tpu_torch's batched OnePass capture extraction against the JAX
package on the CPU, with tolerance 0.

* the walk: the port's plain version (``onepass_plain``, what
  ``OnePassScanner.extract`` runs on CPU tensors) against the reference's
  jitted ``_onepass_window`` at one bucket and against its
  ``OnePassScanner.extract`` (width buckets, its MAX_WINDOW cut) on the
  same seeded spans: match spans from ``re``, spans that end in a
  non-match state or die, empty spans, spans at the corpus end, spans of
  MAX_WINDOW and wider; slots and ok bit-equal;
* the engine: ``find_all_submatch_index``, ``find_all_submatch`` and
  ``replace_all`` with ``$`` templates against the reference engine, with
  ``_batch_captures`` serving on both sides (the reference's spans from its
  host walk, whose device find_all takes seconds to trace here, but once
  on its device path); what stays on the host (fewer than 64 spans,
  leftmost-longest, a pattern that is not one-pass);
* the kernel's contract: the wrapper's constants and shared memory
  against ``csrc/onepass_scan.cu``'s, its table modes (shared memory
  where the tables fit, global memory past it).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import coregex_tpu as ref_ct
from coregex_tpu.dfa.onepass import build_onepass as ref_build_onepass
from coregex_tpu.nfa.thompson import compile_nfa as ref_compile_nfa
from coregex_tpu.ops import onepass_scan as ref_ops
from coregex_tpu.syntax.parser import parse as ref_parse
import coregex_tpu_torch as ct
from coregex_tpu_torch.dfa.onepass import build_onepass
from coregex_tpu_torch.nfa.thompson import compile_nfa
from coregex_tpu_torch.ops import onepass_scan as ops
from coregex_tpu_torch.syntax.parser import parse

torch.set_num_threads(1)

IP = r"(\d+)\.(\d+)\.(\d+)\.(\d+)"
PATTERNS = [r"(\d+)-(\w+)", IP, r"([a-z]+)=(\d+)", r"(\w+)(@\w+)?",
            r"(a)(b)?c"]
WORDS = [b"a12-foo", b"b345-xy", b"q=12", b"key=7", b"10.0.0.255",
         b"192.168.1.10", b"1.2.3", b"user@example", b"abc", b"ac", b"x",
         b"c6-zz", b"9.8.7.6543", b"--", b"=5"]


def _text(seed: int, size: int) -> bytes:
    rng = np.random.default_rng(seed)
    out, total = [], 0
    while total < size:
        w = WORDS[int(rng.integers(len(WORDS)))]
        sep = b"\n" if rng.random() < 0.1 else b" "
        out.append(w + sep)
        total += len(w) + 1
    return b"".join(out)[:size]


def _ops(pattern):
    """(reference OnePassDFA, the port's) of the pattern."""
    ref = ref_build_onepass(ref_compile_nfa(ref_parse(pattern),
                                            with_captures=True))
    port = build_onepass(compile_nfa(parse(pattern), with_captures=True))
    return ref, port


def _spans(pattern: str, text: bytes, seed: int, walk_wide: bool
           ) -> np.ndarray:
    """re's match spans, then seeded spans of widths in several buckets
    (most end in a non-match state or die), empty spans, spans at the
    corpus end, and spans wider than MAX_WINDOW; with walk_wide also spans
    of MAX_WINDOW - 1 and MAX_WINDOW (walked: 16K steps of both scans)."""
    n = len(text)
    rng = np.random.default_rng(seed)
    sp = [m.span() for m in re.finditer(pattern.encode(), text)]
    for w in (0, 1, 3, 9, 17, 40, 100, 300, 700):
        for _ in range(6):
            s = int(rng.integers(0, n - w + 1))
            sp.append((s, s + w))
    sp += [(n, n), (n - 1, n), (max(n - 12, 0), n), (0, 0)]
    W = ops.MAX_WINDOW
    sp += [(1, W + 1), (3, n)]
    if walk_wide:
        sp += [(0, W - 1), (0, W), (5, W + 5)]
    return np.array(sp, dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_extract_matches_reference(pattern, seed):
    ref_op, op = _ops(pattern)
    text = _text(seed, ops.MAX_WINDOW + 4000)
    spans = _spans(pattern, text, seed, (pattern, seed) == (IP, 0))
    arr = np.frombuffer(text, dtype=np.uint8)
    exp_slots, exp_ok = ref_ops.OnePassScanner(ref_op).extract(
        jnp.asarray(arr), spans)
    got_slots, got_ok = ops.OnePassScanner(op, "cpu").extract(
        torch.from_numpy(arr.copy()), spans)
    assert got_slots.dtype == exp_slots.dtype == np.int64
    np.testing.assert_array_equal(got_slots, exp_slots)
    np.testing.assert_array_equal(got_ok, exp_ok)
    widths = spans[:, 1] - spans[:, 0]
    assert not got_ok[widths > ops.MAX_WINDOW].any()
    assert (got_slots[widths > ops.MAX_WINDOW] == -1).all()
    n_re = len(list(re.finditer(pattern.encode(), text)))
    assert got_ok[:n_re].all() and not got_ok.all()
    # a leftmost-first match span walks to a match; its group 0 is the span
    np.testing.assert_array_equal(got_slots[:n_re, :2], spans[:n_re])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_walk_matches_reference_window(pattern):
    """The plain version against _onepass_window itself at one bucket (B,
    W), padding lanes (end -1) included."""
    ref_op, op = _ops(pattern)
    text = _text(7, 4096)
    arr = np.frombuffer(text, dtype=np.uint8)
    rng = np.random.default_rng(7)
    B, W = 64, 32
    starts = rng.integers(0, len(text) - W, B).astype(np.int32)
    ends = (starts + rng.integers(0, W + 1, B)).astype(np.int32)
    ms = [m.span() for m in re.finditer(pattern.encode(), text)][:B // 2]
    starts[:len(ms)] = [s for s, _ in ms]
    ends[:len(ms)] = [e for _, e in ms]
    ends[-3:] = -1
    d = ref_ops.DeviceOnePass(ref_op)
    exp_slots, exp_ok = ref_ops._onepass_window(
        d.comb, d.bounds, jnp.asarray(arr), jnp.asarray(starts),
        jnp.asarray(ends), B=B, W=W, S=d.S, C=d.C,
        NS=max(d.num_slots, 1), start=d.start)
    spans = torch.from_numpy(np.stack([starts, ends], axis=1))
    got_slots, got_ok = ops.onepass_plain(ops.DeviceOnePass(op, "cpu"),
                                          torch.from_numpy(arr.copy()),
                                          spans)
    np.testing.assert_array_equal(got_slots.numpy(), np.asarray(exp_slots))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(exp_ok))


def test_tables_and_wrapper_contract():
    _, op = _ops(IP)
    d = ops.DeviceOnePass(op, "cpu")
    S, C = op.delta.shape
    assert d.trans.dtype == d.fin.dtype == torch.int32
    assert tuple(d.trans.shape) == (S, C, 2) and tuple(d.fin.shape) == (S, 2)
    np.testing.assert_array_equal(d.trans[..., 0].numpy(), op.delta)
    np.testing.assert_array_equal(
        d.trans[..., 1].numpy().view(np.uint32), op.slotmask)
    assert d.mode == "class" and d.NS == op.num_slots == 10
    # past shared memory the kernel reads the tables from global memory
    assert not ops.smem_bytes(4096, 64, 32, True) <= ops.SMEM_LIMIT
    data = torch.zeros(16, dtype=torch.uint8)
    spans = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.onepass_extract(d, data, spans.long())
    with pytest.raises(ValueError):
        ops.onepass_extract(d, data.int(), spans)
    with pytest.raises(ValueError):
        ops.OnePassScanner(op, "cpu").extract(data, np.array([[0, 17]]))
    slots, ok = ops.OnePassScanner(op, "cpu").extract(
        data, np.zeros((0, 2), np.int64))
    assert slots.shape == (0, 10) and ok.shape == (0,)


def _ref_engine(pattern, longest=False, device_spans=False):
    """The reference engine; unless device_spans, its spans come from its
    host walk (its OnePassScanner still extracts the captures)."""
    ref = ref_ct.compile(pattern, longest=longest)
    if not device_spans:
        ref.batch_threshold = 1 << 60
    return ref


@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_submatch_matches_reference(pattern):
    text = _text(3, 20000)
    eng = ct.compile(pattern, device="cpu")
    ref = _ref_engine(pattern, device_spans=pattern == IP)
    spans = eng.find_all_index(text)
    assert spans and len(spans) >= 64
    arr = np.frombuffer(text, dtype=np.uint8)
    before = eng.stats.kernel_scans
    batched = eng._batch_captures(arr, spans)
    assert eng.stats.kernel_scans == before + 1
    assert all(b is not None for b in batched)
    for sp, b in zip(spans, batched):
        assert b == tuple(eng._captures_in_span(arr, text, sp))
    assert eng.find_all_submatch_index(text) == \
        ref.find_all_submatch_index(text)
    assert eng.find_all_submatch(text) == ref.find_all_submatch(text)
    assert eng.find_all_submatch_index(text, 70) == \
        ref.find_all_submatch_index(text, 70)


@pytest.mark.parametrize("template", [b"[$2:$1]", b"${1}x$$", b"<$0|${2}>",
                                      b"$9-$name"])
@pytest.mark.parametrize("pattern", [r"(\d+)-(\w+)", r"([a-z]+)=(\d+)",
                                     r"(\w+)(@\w+)?"])
def test_engine_replace_all_matches_reference(pattern, template):
    text = _text(4, 16384)
    eng = ct.compile(pattern, device="cpu")
    ref = _ref_engine(pattern)
    got = eng.replace_all(text, template)
    assert got == ref.replace_all(text, template)
    rx = re.compile(pattern.encode())
    if template == b"[$2:$1]":
        assert got == rx.sub(
            lambda m: b"[" + (m.group(2) or b"") + b":"
            + (m.group(1) or b"") + b"]", text)


@pytest.mark.parametrize("case", ["few_spans", "longest", "not_onepass"])
def test_host_cases_stay_on_host(case):
    """Fewer than 64 spans, leftmost-longest and a pattern that is not
    one-pass take the host walk (all None), with the reference's
    results."""
    pattern, longest, text = {
        "few_spans": (r"(\d+)-(\w+)", False, b"a1-b c22-dd " * 20),
        "longest": (r"(\d+)-(\w+)", True, _text(5, 16384)),
        "not_onepass": (r"(a)|(a)b", False, b"ab a xab " * 400),
    }[case]
    eng = ct.compile(pattern, longest=longest, device="cpu")
    ref = _ref_engine(pattern, longest)
    spans = eng.find_all_index(text)
    arr = np.frombuffer(text, dtype=np.uint8)
    before = eng.stats.kernel_scans
    assert eng._batch_captures(arr, spans) == [None] * len(spans)
    assert eng.stats.kernel_scans == before
    assert (len(spans) < 64) == (case == "few_spans")
    assert eng.find_all_submatch_index(text) == \
        ref.find_all_submatch_index(text)
    assert eng.replace_all(text, b"<$1|$2>") == \
        ref.replace_all(text, b"<$1|$2>")


CSRC = pathlib.Path(ops.__file__).resolve().parent.parent / "csrc"


def _constants(source: str):
    text = (CSRC / source).read_text()
    return {k: (1 << int(v) if sh else int(v)) for k, sh, v in re.findall(
        r"constexpr int (k\w+) = (1 << )?(\d+);", text)}


@pytest.mark.parametrize("pattern", [IP, r"([a-z]+)=(\d+)", r"a{300}(b)"])
def test_smem_and_mode_choice_follow_the_kernel(pattern):
    """The wrapper's constants are onepass_scan.cu's, its shared memory
    sums the slab (NS | 1 words a thread) and the classes, and fin and
    trans in shared memory; the mode holds the tables in shared memory
    where they fit (the bench's capture patterns, and a one-pass DFA of
    302 states), else in global memory; the kernel takes either."""
    k = _constants("onepass_scan.cu")
    assert (k["kThreads"], k["kMaxWindow"], k["kMaxSlots"]) == (
        ops.THREADS, ops.MAX_WINDOW, ops.MAX_SLOTS)
    assert ops.MODES == ("global", "class")
    slab = 4 * ops.THREADS * 11
    assert ops.smem_bytes(8, 3, 10, False) == slab + 1024
    assert ops.smem_bytes(8, 3, 10, True) == slab + 1024 + 64 + 192
    # NS = 32 keeps an odd row stride: 33 words
    assert ops.smem_bytes(1, 1, 32, False) == 4 * 256 * 33 + 1024
    d = ops.DeviceOnePass(_ops(pattern)[1], "cpu")
    assert d.modes == ("class", "global") and d.mode == "class"
    assert ops.smem_bytes(d.S, d.C, d.NS, True) <= ops.SMEM_LIMIT
    # 4096 states (dfa/onepass.py's cap) of 64 classes: global memory only
    assert not ops.smem_bytes(4096, 64, 32, True) <= ops.SMEM_LIMIT
    d.mode = "byte"
    with pytest.raises(ValueError, match="table mode"):
        ops.onepass_cuda(d, torch.zeros(16, dtype=torch.uint8),
                         torch.zeros((4, 2), dtype=torch.int32))
