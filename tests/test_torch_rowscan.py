"""coregex_tpu_torch's row batches against the JAX package on the CPU, with
tolerance 0.

* ``pack_rows``: the same [B, L] matrix and lengths as the reference's
  (power-of-two buckets of B and L, empty rows, rows of length L);
* ``RowBatch.match_ends`` and ``rev_starts``: the port's plain versions
  (what the row batch runs on CPU tensors) bit-equal to the reference's
  jitted ``_rows_scan`` and ``_rows_rev_scan`` for
  ``test_round2b.TestRowBatch``'s patterns and texts, and on seeded rows;
  the reverse pass's entry states (``rev_start_states``) equal to the
  reference's per-row ``DenseDFA.context_of`` loop, at ends before word
  bytes, newlines, other bytes and the row's end, and at no end (-1);
* the engine: ``is_match_batch`` and ``find_index_batch`` against the
  reference engine and ``re``; leftmost-longest stays on the host loop;
* the forward kernel's tables: the byte-indexed ``tbl_b`` against
  ``tbl[s, classes[byte]]`` for every state and byte, the table modes
  (byte-indexed, class-indexed, global) and the shared memory against
  ``csrc/row_scan.cu``'s constants.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct
from coregex_tpu.dfa.dense import DenseDFA as RefDenseDFA
from coregex_tpu.ops import rowscan as ref_rs
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import rowscan as rs

import test_round2b

torch.set_num_threads(1)

TEXTS = test_round2b.TestRowBatch.TEXTS
PATTERNS = [r"\d+\.\d+", r"[a-z]+", r"^\d+", r"world$", r"\bfoo\b",
            r"a*b", r"(GET|POST) /", r"x+", r"^(\d+|[0-9a-f]{4})$",
            r"\d\.\d", r"\berror\b"]
ALPHABET = list(b"ab1.2 xy\nfoGETPOS/")


def _rows(seed: int, count: int, longest: int):
    """Seeded rows of 0..longest bytes, some exactly `longest` (the padded
    width when longest is a power of two)."""
    rng = np.random.default_rng(seed)
    out = [bytes(rng.choice(ALPHABET, size=int(rng.integers(0, longest))))
           for _ in range(count)]
    out[::7] = [bytes(rng.choice(ALPHABET, size=longest))
                for _ in out[::7]]
    return out


def _batches(pattern):
    """(reference RowBatch, the port's) of the pattern's DFAs."""
    ref = ref_ct.compile(pattern)
    eng = ct.compile(pattern, device="cpu")
    return (ref_rs.RowBatch(ref.fwd, ref.rev),
            rs.RowBatch(eng.fwd, eng.rev, "cpu"))


@pytest.mark.parametrize("texts", [
    [], [b""], [b"a"], [b"x" * 8], [b"x" * 9, b""], [b"ab"] * 9,
    [b"q" * 16, b"r" * 17, b""], [bytes(range(256))],
    _rows(1, 1000, 40)], ids=lambda t: f"{len(t)}rows")
def test_pack_rows_matches_reference(texts):
    rows, lens = rs.pack_rows(texts)
    exp_rows, exp_lens = ref_rs.pack_rows(texts)
    assert rows.dtype == exp_rows.dtype and lens.dtype == exp_lens.dtype
    np.testing.assert_array_equal(rows, exp_rows)
    np.testing.assert_array_equal(lens, exp_lens)


@pytest.mark.parametrize("which", ["round2b", "seeded"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_match_ends_and_starts_match_reference(pattern, which):
    texts = TEXTS if which == "round2b" else _rows(2, 300, 32)
    ref_rb, rb = _batches(pattern)
    rows, lens = rs.pack_rows(texts)
    exp_found, exp_last = ref_rb.match_ends(rows, lens)
    found, last = rb.match_ends(rows, lens)
    np.testing.assert_array_equal(found, np.asarray(exp_found))
    np.testing.assert_array_equal(last, np.asarray(exp_last))
    ends = np.where(found, last, -1).astype(np.int32)
    exp = np.asarray(ref_rb.rev_starts(rows, lens, ends))
    got = rb.rev_starts(rows, lens, ends)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, exp)
    for t, f, s, e in zip(texts, found, got, last):
        m = re.search(pattern.encode(), t)
        assert bool(f) == (m is not None)
        if m is not None:
            assert (int(s), int(e)) == m.span()


@pytest.mark.parametrize("pattern", [r"\bfoo\b", r"a*b", r"(GET|POST) /",
                                     r"world$", r"\d+\.\d+"])
def test_rev_starts_entry_contexts(pattern):
    """rev_starts at every end 0..len of each row and at none (-1): the
    entry states equal the reference's context_of loop, the starts its
    _rows_rev_scan's."""
    ref_rb, rb = _batches(pattern)
    texts = [b"foo bar\nfoo", b"GET /x a\nb", b"world 1.2", b"xaab b", b""]
    rows, lens = rs.pack_rows(texts)
    B, L = rows.shape
    for end in range(-1, L + 1):
        ends = np.minimum(np.full(B, end, dtype=np.int32), lens)
        if end % 2:
            ends[::3] = -1
        e = np.maximum(ends, 0)
        nxt = rows[np.arange(B), np.minimum(e, L - 1)]
        ctx = np.array([RefDenseDFA.context_of(None if e[b] >= lens[b]
                                               else int(nxt[b]))
                        for b in range(B)])
        s0 = rs.rev_start_states(rb.rev, torch.from_numpy(rows),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(ends))
        np.testing.assert_array_equal(s0.numpy(), ref_rb.rev.starts[ctx])
        np.testing.assert_array_equal(
            rb.rev_starts(rows, lens, ends),
            np.asarray(ref_rb.rev_starts(rows, lens, ends)))


def test_tables_and_wrapper_contract():
    eng = ct.compile(r"\d+\.\d+", device="cpu")
    tb = rs.RowTables(eng.fwd, "cpu")
    S, C = eng.fwd.delta.shape
    assert tb.tbl.dtype == torch.int32 and tuple(tb.tbl.shape) == (S, C)
    np.testing.assert_array_equal(tb.tbl.numpy() >> 1, eng.fwd.delta)
    np.testing.assert_array_equal((tb.tbl.numpy() & 1) > 0,
                                  eng.fwd.match_on)
    assert tb.stop_dead and tb.mode in tb.modes
    # past shared memory the kernels read the tables from global memory
    assert not rs.match_smem_bytes(20000, 16, "class") <= rs.SMEM_LIMIT
    rows = torch.zeros((8, 8), dtype=torch.uint8)
    lens = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        rs.rows_match(tb, rows, lens.long())
    with pytest.raises(ValueError):
        rs.rows_match(tb, rows.t(), lens)
    with pytest.raises(ValueError):
        rs.rows_rev_start(tb, rows, lens[:4], lens)


# a DFA of more states than the byte-indexed table takes (514)
BIG = r"(a|b)*a(a|b){7}"
CSRC = pathlib.Path(rs.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("pattern", PATTERNS + [BIG])
def test_byte_table_matches_class_table(pattern):
    """tbl_b[s, byte] = tbl[s, classes[byte]] for every state and byte of
    the forward DFA (the bench's row patterns are PATTERNS' `\\d+\\.\\d+`
    and `\\berror\\b`), where the table fits; the mode falls back to the
    class-indexed table otherwise."""
    eng = ct.compile(pattern, device="cpu")
    tb = rs.RowTables(eng.fwd, "cpu")
    S = eng.fwd.delta.shape[0]
    packed = (eng.fwd.delta.astype(np.int64) << 1) | eng.fwd.match_on
    if pattern == BIG:
        assert S > rs.BYTE_MAX_S and tb.tbl_b is None
        assert tb.modes == ("class", "global") and tb.mode == "class"
        return
    assert tb.modes == ("byte", "class", "global") and tb.mode == "byte"
    b = tb.tbl_b.numpy()
    assert tb.tbl_b.dtype == torch.uint8 and b.shape == (S, rs.BYTE_ROW)
    assert not b[:, 256:].any()
    np.testing.assert_array_equal(b[:, :256],
                                  packed[:, eng.fwd.classes])
    np.testing.assert_array_equal(
        rs.byte_table(tb.tbl.numpy(), tb.classes.numpy()), b)


def test_smem_and_mode_choice_follow_the_kernel():
    """The wrapper's constants are row_scan.cu's, cgx_rows_match's shared
    memory sums the warps' stages, match_eoi's column and the table of
    each mode, and the mode is the byte-indexed table where S <= 128 and
    a block stays within BYTE_SMEM, the class-indexed one within
    SMEM_LIMIT, else global memory."""
    text = (CSRC / "row_scan.cu").read_text()
    k = {n: int(v) for n, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert k["kThreads"] == rs.THREADS and k["kByteRow"] == rs.BYTE_ROW
    assert k["kByteMaxS"] == rs.BYTE_MAX_S
    # kStageRow = kCols + 16
    assert rs.STAGE_BYTES == (k["kThreads"] // 32) * k["kStages"] * 32 * \
        (k["kCols"] + 16)
    assert rs.MODES == ("global", "class", "byte")
    st = rs.STAGE_BYTES
    assert rs.match_smem_bytes(7, 3, "global") == st + 16 + 1024
    assert rs.match_smem_bytes(7, 3, "class") == st + 16 + 84 + 1024
    assert rs.match_smem_bytes(17, 3, "byte") == st + 32 + 17 * 260
    # 128 states would leave room for fewer blocks an SM than BYTE_SMEM
    assert rs.match_smem_bytes(106, 9, "byte") <= rs.BYTE_SMEM < \
        rs.match_smem_bytes(rs.BYTE_MAX_S, 9, "byte")
    # the reverse kernel takes the same tables with no stages: the modes
    # that fit the forward kernel fit it too
    assert "match_smem_bytes(a.t.S, a.t.C, kMode, kStageBytes)" in text
    assert "match_smem_bytes(a.t.S, a.t.C, kMode, 0)" in text
    for pattern, mode in ((r"\d+\.\d+", "byte"), (BIG, "class")):
        tb = rs.RowTables(ct.compile(pattern, device="cpu").fwd, "cpu")
        assert tb.mode == mode
    # a DFA of 20,000 states and 16 classes: global memory for both
    assert rs.match_smem_bytes(20000, 16, "class") > rs.SMEM_LIMIT
    tb = rs.RowTables(ct.compile(r"\d+", device="cpu").fwd, "cpu")
    tb.mode = "wide"
    rows, vec = (torch.zeros((8, 16), dtype=torch.uint8),
                 torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="table mode"):
        rs.rows_match_cuda(tb, rows, vec)
    with pytest.raises(ValueError, match="table mode"):
        rs.rows_rev_cuda(tb, rows, vec, vec)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_batches_match_reference(pattern):
    texts = TEXTS + _rows(3, 200, 24)
    eng = ct.compile(pattern, device="cpu")
    ref = ref_ct.compile(pattern)
    assert eng._batch_rows_ok()
    before = eng.stats.kernel_scans
    got_m = eng.is_match_batch(texts)
    got_f = eng.find_index_batch(texts)
    assert eng.stats.kernel_scans == before + 2
    assert got_m == ref.is_match_batch(texts)
    assert got_f == ref.find_index_batch(texts)
    for t, gm, gf in zip(texts, got_m, got_f):
        m = re.search(pattern.encode(), t)
        assert gm == (m is not None), (pattern, t)
        assert gf == (m.span() if m else None), (pattern, t)
    # bytes-like rows: str, bytearray, numpy
    mixed = [texts[0].decode(), bytearray(texts[1]),
             np.frombuffer(texts[4], dtype=np.uint8)]
    assert eng.find_index_batch(mixed) == got_f[:2] + got_f[4:5]


def test_host_fallback_longest():
    eng = ct.compile(r"a|ab", longest=True, device="cpu")
    assert not eng._batch_rows_ok()
    before = eng.stats.kernel_scans
    assert eng.is_match_batch([b"xaby"]) == [True]
    assert eng.find_index_batch([b"xaby"]) == [(1, 3)]
    assert eng.stats.kernel_scans == before


@pytest.mark.parametrize("pattern", [r"x+", r"world$", r"\bfoo\b"])
def test_upload_pads_columns_to_16(pattern):
    """RowBatch.upload pads pack_rows' matrix to a multiple of 16 columns
    (the kernels' 16-byte chunks); both scans give the unpadded matrix's
    results, rows of length L included, and the kernels' wrappers refuse
    an unpadded matrix before launching."""
    _, rb = _batches(pattern)
    texts = [b"xx", b"a world", b"foo", b"", b"xxxxxxxx", b"foo bar!"]
    rows, lens = rs.pack_rows(texts)
    assert rows.shape[1] == 8
    rt, lt = rb.upload(rows, lens)
    assert tuple(rt.shape) == (8, 16) and not rt[:, 8:].any()
    bare = torch.from_numpy(rows)
    found, last = rs.rows_match(rb.fwd, rt, lt)
    exp_found, exp_last = rs.rows_match_plain(rb.fwd, bare, lt)
    assert torch.equal(found, exp_found) and torch.equal(last, exp_last)
    ends = torch.where(found, last, -1)
    assert torch.equal(
        rb.rev_starts_device(rt, lt, ends),
        rs.rows_rev_plain(rb.rev, bare, ends,
                          rs.rev_start_states(rb.rev, bare, lt, ends)))
    for text, f, e in zip(texts, found.tolist(), last.tolist()):
        m = re.search(pattern.encode(), text)
        assert f == (m is not None) and (not f or e == m.end())
    with pytest.raises(ValueError, match="multiple of 16"):
        rs.rows_match_cuda(rb.fwd, bare, lt)
    with pytest.raises(ValueError, match="multiple of 16"):
        rs.rows_rev_cuda(rb.rev, bare, ends, lt)
