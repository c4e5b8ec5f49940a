"""DFA tables past the card's shared memory (ROADMAP P5) on the CPU.

Lists of hundreds of keywords give DFAs of 1,000-4,000 states over 60-90
byte segments: packed tables of 0.3-1.2 MB, past the 232,448 bytes of
shared memory a Hopper block can take.  The lane walk (K1, K2, K3, K9) and
the window scan read such a table from global memory, so every route
serves them on the card.  Here, at KB scale:

* each table the routes build for these patterns is past shared memory as
  int32, is held as 16-bit values where it has at most
  ``count_scan.MAX16_ROWS`` rows, takes the instance its residency picks
  (shared memory only where that keeps ``MIN_SHARED_WARPS`` warps an SM),
  and passes the CUDA wrappers' own argument checks (run on the arguments
  of every plain walk);
* the route of every entry point is a device route (``host_routes`` 0);
* count, find_all_index, find_all_submatch_index, is_match and find_index
  equal ``re`` (POSIX: the port's host walk), and the JAX package's on the
  CPU for KW400 and KWI200;
* the INNER pipeline serves ``compile_posix(r"[a-z]+ error [^ ]{8,60}[a-z]")``,
  whose 1024 x 64 suffix table, global as int32, takes K3's shared-memory
  instance with 16-bit values.
"""

import os
import re

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct

import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import count_scan as cs
from coregex_tpu_torch.ops import dfa_scan as ds
from coregex_tpu_torch.utils import corpus_cache

from test_torch_engine import WORDS, _arr, _log_corpus

torch.set_num_threads(1)


def _words(n: int, seed: int = 5):
    """test_torch_engine.WORDS, escaped, then seeded random lowercase words
    of 4-9 letters, n in all."""
    out = [re.escape(w.decode()) for w in WORDS]
    rng = np.random.default_rng(seed)
    seen = set(out)
    while len(out) < n:
        w = "".join(chr(97 + int(c))
                    for c in rng.integers(0, 26, int(rng.integers(4, 10))))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


W400, W200 = "|".join(_words(400)), "|".join(_words(200))
# name: (pattern, POSIX, compared with the JAX package)
PATTERNS = {
    "KW400": (r"\b(?:%s)\b" % W400, False, True),
    "KW400_FIELD": (r"\b(?:%s) \w+" % W400, False, False),
    "KWI200": (r"(?i)(?:%s)\s\d+" % W200, False, True),
    "KWI200_POSIX": (r"(?i)(?:%s)\s\d+" % W200, True, False),
    "KWI200_CAP": (r"(?i)((?:%s))\s(\d+)" % W200, False, False),
}
INNER = r"[a-z]+ error [^ ]{8,60}[a-z]"
CORPUS = _log_corpus(3, 6000)
# INNER matches: a suffix of 20 and of 58 bytes after " error "
INNER_CORPUS = (CORPUS + b" abc error " + b"Q" * 20 + b"x tail\n"
                + b"zz error " + b"R" * 57 + b"y end\n")


class _Spy:
    """Records every table the routes build and runs the CUDA wrappers'
    argument checks on the arguments of every plain lane walk and window
    scan (the CPU runs the plain versions; the checks are the kernels')."""

    def __init__(self, monkeypatch):
        self.tables = []    # (what, S, nseg, value bytes)
        self.walks = []     # (mode, S, nseg, value bytes)
        self.windows = []   # (S, nseg, value bytes)
        for cls, what in ((cs.DeviceCountDFA, "count"),
                          (ds.MatchTables, "match")):
            self._spy_init(monkeypatch, cls, what)
        from coregex_tpu_torch.ops.flag_scan import ResetFlagTables
        self._spy_init(monkeypatch, ResetFlagTables, "flag")
        walk = cs.lane_walk_plain

        def lane_walk_plain(mode, packed, segmap, tiles, W4, entries, offsets,
                            limits):
            cs._check_lane_args(mode, packed, segmap, tiles, W4, entries,
                                offsets, limits)
            self.walks.append((mode, *packed.shape, packed.element_size()))
            return walk(mode, packed, segmap, tiles, W4, entries, offsets,
                        limits)
        monkeypatch.setattr(cs, "lane_walk_plain", lane_walk_plain)
        ends = ds.window_ends_plain

        def window_ends_plain(packed, segmap, eoi, starts_tbl, data, reverse,
                              starts, edge, W, idx=None, out=None,
                              alive_u8=False):
            ds._check_window_args(packed, segmap, eoi, starts_tbl, data,
                                  starts, edge, W, idx, out)
            self.windows.append((*packed.shape, packed.element_size()))
            return ends(packed, segmap, eoi, starts_tbl, data, reverse,
                        starts, edge, W, idx, out, alive_u8)
        monkeypatch.setattr(ds, "window_ends_plain", window_ends_plain)

    def _spy_init(self, monkeypatch, cls, what):
        init = cls.__init__

        def spied(obj, *args, **kw):
            init(obj, *args, **kw)
            packed = getattr(obj, "packed", None)
            if packed is None:
                packed = obj.packed_full
            self.tables.append((what, obj.S, obj.NSEG,
                                packed.element_size()))
        monkeypatch.setattr(cls, "__init__", spied)


def _mode_of(what):
    return {"count": cs.MODE_COUNT, "match": cs.MODE_MATCH,
            "flag": cs.MODE_FLAG}[what]


def _host(pattern, posix):
    """The port's host walk: an engine that never takes the device."""
    eng = (ct.compile_posix if posix else ct.compile)(pattern, device="cpu")
    eng.batch_threshold = 1 << 30
    return eng


def _groups(pattern, text):
    return [[m.span(g) if m.start(g) >= 0 else None
             for g in range(re.compile(pattern.encode()).groups + 1)]
            for m in re.finditer(pattern.encode(), text)]


@pytest.mark.parametrize("name", list(PATTERNS))
def test_keyword_lists_on_the_device_routes(monkeypatch, name):
    """Every entry point serves the keyword list on a device route, with
    tables past shared memory as int32 held as 16-bit values and each in
    the instance its residency picks, equal to re (POSIX: the port's host
    walk)."""
    pattern, posix, _ = PATTERNS[name]
    corpus_cache.clear()
    spy = _Spy(monkeypatch)
    eng = (ct.compile_posix if posix else ct.compile)(pattern, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    arr = _arr(CORPUS)
    if not posix:
        assert be._count_route(arr)[0] == "dfa"
    route = be._spans_route(arr)
    assert route is not None and route[0] in ("full_scan", "bidi")
    if posix:
        host = _host(pattern, True)
        spans = host.find_all_index(CORPUS) or []
        groups = host.find_all_submatch_index(CORPUS) or []
        first = host.find_index(CORPUS)
    else:
        spans = [m.span() for m in re.finditer(pattern.encode(), CORPUS)]
        groups = _groups(pattern, CORPUS)
        m = re.search(pattern.encode(), CORPUS)
        first = m.span() if m else None
    assert len(spans) >= 50
    assert eng.count(CORPUS) == len(spans)
    assert eng.find_all_index(CORPUS) == spans
    assert be.route == route[0]
    assert eng.find_all_submatch_index(CORPUS) == [
        [tuple(g) if g is not None else None for g in gs] for gs in groups]
    assert eng.is_match(CORPUS) is True
    assert eng.find_index(CORPUS) == first
    assert be.host_routes == 0
    # every table built is past shared memory as int32 (where it would take
    # the global-memory instance), is held as 16-bit values where it has at
    # most MAX16_ROWS rows, and every kernel that walks it keeps
    # MIN_SHARED_WARPS warps an SM in the shared-memory instance or takes
    # the global-memory one
    assert spy.tables and spy.walks and spy.windows
    for what, S, nseg, vb in spy.tables:
        assert (S * nseg + 256) * 4 > cs.SMEM_LIMIT, (what, S, nseg)
        assert cs.lane_instance(_mode_of(what), S, nseg, 4) == "global"
        assert vb == cs.value_bytes(S), (what, S, nseg)
    for mode, S, nseg, vb in spy.walks:
        smem = cs.lane_smem_bytes(mode, S, nseg, vb)
        assert (cs.lane_instance(mode, S, nseg, vb) == "shared") == (
            cs.lane_warps(smem) >= cs.MIN_SHARED_WARPS)
    for S, nseg, vb in spy.windows:
        plan = ds.window_plan(S, nseg, vb, ds.WINDOW_STAGES[-1])
        assert not plan.shared or ds.window_smem_bytes(
            plan.width, S, nseg, plan.stage) <= cs.SMEM_LIMIT
        assert not ds.window_fits(S, nseg, 4)


@pytest.mark.parametrize("name", [n for n, v in PATTERNS.items() if v[2]])
def test_keyword_lists_equal_the_reference(name):
    """count, find_all_index, is_match and find_index equal the JAX
    package's device path on the CPU."""
    pattern, _, _ = PATTERNS[name]
    corpus_cache.clear()
    eng = ct.compile(pattern, device="cpu")
    eng.batch_threshold = 0
    ref = ref_ct.compile(pattern)
    ref.batch_threshold = 0
    for fn in ("count", "find_all_index", "is_match", "find_index"):
        assert getattr(eng, fn)(CORPUS) == getattr(ref, fn)(CORPUS), fn
    assert eng.batch_engine().host_routes == 0


def test_inner_suffix_past_shared_memory(monkeypatch):
    """compile_posix(r"[a-z]+ error [^ ]{8,60}[a-z]"): the general fallback
    declines it (its reverse DFA overflows); the INNER pipeline takes its
    1024 x 64 suffix table, past shared memory as int32, as 16-bit values
    in K3's shared-memory instance (one 1024-thread block, 32 warps an SM),
    equal to the port's host walk, where the card used to decline it."""
    corpus_cache.clear()
    spy = _Spy(monkeypatch)
    eng = ct.compile_posix(INNER, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    exp = _host(INNER, True).find_all_index(INNER_CORPUS) or []
    assert be._full_scan_route() is None and len(exp) == 2
    t = be._inner_route()[1].tables
    assert (t.S, t.NSEG) == (1024, 64)
    assert t.packed_full.dtype == torch.int16
    assert cs.lane_instance(cs.MODE_FLAG, t.S, t.NSEG, 4) == "global"
    assert cs.lane_instance(cs.MODE_FLAG, t.S, t.NSEG) == "shared"
    assert eng.find_all_index(INNER_CORPUS) == exp and be.route == "inner"
    assert eng.count(INNER_CORPUS) == len(exp)
    assert eng.is_match(INNER_CORPUS) is True
    assert be.host_routes == 0
    assert (cs.MODE_FLAG, 1024, 64, 2) in spy.walks


def test_instances_follow_the_sources():
    """The instance choice mirrors the kernels' own: the sources' residency
    constants are the host's; the lane walk takes shared memory while the
    table (16-bit or int32, in rows of lane_pitch, plus the byte map for
    the modes that take one) keeps MIN_SHARED_WARPS warps an SM there,
    which a block of 1024 threads does up to kSmemLimit; the window scan
    while its block of 1024 threads fits with 1024-byte stage slices."""
    root = os.path.join(os.path.dirname(ct.__file__), "csrc")
    with open(os.path.join(root, "lane_scan.cu")) as f:
        lane = f.read()
    with open(os.path.join(root, "window_scan.cu")) as f:
        win = f.read()

    def const(src, name):
        return int(re.search(r"\b" + name + r" = (\d+);", src)[1])
    for src in (lane, win):
        assert const(src, "kSmemLimit") == cs.SMEM_LIMIT
        assert const(src, "kMax16") == cs.MAX16_ROWS
    assert const(lane, "kSmemPerSM") == cs.SM_SMEM
    assert const(lane, "kBlockReserved") == cs.BLOCK_RESERVED
    assert const(lane, "kSmemUnit") == cs.SMEM_UNIT
    assert (const(lane, "kThreads"), const(lane, "kMaxThreads")) == \
        (cs.LANE_THREADS[0], cs.LANE_THREADS[-1])
    assert const(lane, "kMinSharedWarps") == cs.MIN_SHARED_WARPS
    assert const(lane, "kMaxBlocksPerSM") == cs.SM_BLOCKS
    assert const(lane, "kMaxThreadsPerSM") == cs.SM_THREADS
    assert const(win, "kThreads") == ds.WINDOW_THREADS
    assert (const(win, "kWarpStage"), const(win, "kMinStage")) == \
        (ds.WINDOW_STAGES[0], ds.WINDOW_STAGES[-1])
    assert const(win, "kSlots") == ds.WINDOW_SLOTS
    for mode, byte_map in ((cs.MODE_COUNT, 1024), (cs.MODE_SPAN, 1024),
                           (cs.MODE_MATCH, 1024), (cs.MODE_FLAG, 0),
                           (cs.MODE_RESET, 0)):
        for vb, nseg in ((4, 64), (2, 128)):
            S = (cs.SMEM_LIMIT - byte_map) // (cs.lane_pitch(nseg, vb) * vb)
            assert cs.lane_instance(mode, S, nseg, vb) == "shared"
            assert cs.lane_instance(mode, S + 1, nseg, vb) == "global"
    ring = ds.WINDOW_THREADS // 32 * ds.WINDOW_SLOTS * ds.WINDOW_STAGES[-1]
    for vb in (4, 2):
        S = (cs.SMEM_LIMIT - ring - 1024) // (cs.lane_pitch(64, vb) * vb)
        assert ds.window_fits(S, 64, vb)
        assert not ds.window_fits(S + 1, 64, vb)
    with pytest.raises(ValueError, match="int32"):
        cs.check_table(2 ** 25, 64)
