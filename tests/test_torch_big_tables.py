"""DFA tables past the card's shared memory (ROADMAP P5) on the CPU.

Lists of hundreds of keywords give DFAs of 1,000-4,000 states over 60-90
byte segments: packed tables of 0.3-1.2 MB, past the 232,448 bytes of
shared memory a Hopper block can take.  The lane walk (K1, K2, K3, K9) and
the window scan read such a table from global memory, so every route
serves them on the card.  Here, at KB scale:

* each table the routes build for these patterns is past shared memory,
  takes the kernels' global-memory instance, and passes the CUDA wrappers'
  own argument checks (run on the arguments of every plain walk);
* the route of every entry point is a device route (``host_routes`` 0);
* count, find_all_index, find_all_submatch_index, is_match and find_index
  equal ``re`` (POSIX: the port's host walk), and the JAX package's on the
  CPU for KW400 and KWI200;
* the INNER pipeline serves ``compile_posix(r"[a-z]+ error [^ ]{8,60}[a-z]")``,
  whose 1024 x 64 suffix table takes K3's global-memory instance.
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
        self.tables = []    # (what, S, nseg)
        self.walks = []     # (mode, S, nseg)
        self.windows = []   # (S, nseg)
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
            self.walks.append((mode, *packed.shape))
            return walk(mode, packed, segmap, tiles, W4, entries, offsets,
                        limits)
        monkeypatch.setattr(cs, "lane_walk_plain", lane_walk_plain)
        ends = ds.window_ends_plain

        def window_ends_plain(packed, segmap, eoi, starts_tbl, data, reverse,
                              starts, edge, W, idx=None, out=None,
                              alive_u8=False):
            ds._check_window_args(packed, segmap, eoi, starts_tbl, data,
                                  starts, edge, W, idx, out)
            self.windows.append(tuple(packed.shape))
            return ends(packed, segmap, eoi, starts_tbl, data, reverse,
                        starts, edge, W, idx, out, alive_u8)
        monkeypatch.setattr(ds, "window_ends_plain", window_ends_plain)

    def _spy_init(self, monkeypatch, cls, what):
        init = cls.__init__

        def spied(obj, *args, **kw):
            init(obj, *args, **kw)
            self.tables.append((what, obj.S, obj.NSEG))
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
    tables past shared memory in the kernels' global-memory instance,
    equal to re (POSIX: the port's host walk)."""
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
    # every table built is past shared memory and takes the global-memory
    # instance of every kernel that walks it
    assert spy.tables and spy.walks and spy.windows
    for what, S, nseg in spy.tables:
        assert (S * nseg + 256) * 4 > cs.SMEM_LIMIT, (what, S, nseg)
        assert cs.lane_instance(_mode_of(what), S, nseg) == "global"
    for mode, S, nseg in spy.walks:
        assert cs.lane_instance(mode, S, nseg) == "global"
    for S, nseg in spy.windows:
        assert not ds.window_fits(S, nseg)


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
    1024 x 64 suffix table in K3's global-memory instance, equal to the
    port's host walk, where the card used to decline it."""
    corpus_cache.clear()
    spy = _Spy(monkeypatch)
    eng = ct.compile_posix(INNER, device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    exp = _host(INNER, True).find_all_index(INNER_CORPUS) or []
    assert be._full_scan_route() is None and len(exp) == 2
    t = be._inner_route()[1].tables
    assert (t.S, t.NSEG) == (1024, 64)
    assert cs.lane_instance(cs.MODE_FLAG, t.S, t.NSEG) == "global"
    assert eng.find_all_index(INNER_CORPUS) == exp and be.route == "inner"
    assert eng.count(INNER_CORPUS) == len(exp)
    assert eng.is_match(INNER_CORPUS) is True
    assert be.host_routes == 0
    assert (cs.MODE_FLAG, 1024, 64) in spy.walks


def test_instances_follow_the_sources():
    """The instance choice mirrors the kernels' own: shared memory while
    the table (plus the byte map, for the modes that take one) fits
    kSmemLimit, and for the window scan beside its 8 warps' stage rings."""
    root = os.path.join(os.path.dirname(ct.__file__), "csrc")
    with open(os.path.join(root, "lane_scan.cu")) as f:
        lane = f.read()
    with open(os.path.join(root, "window_scan.cu")) as f:
        win = f.read()
    for src in (lane, win):
        assert int(re.search(r"kSmemLimit = (\d+);", src)[1]) == \
            cs.SMEM_LIMIT
    stage = 1
    for name in ("kThreads", "kSlots", "kWarpStage"):
        stage *= int(re.search(name + r" = (\d+);", win)[1])
    assert stage // 32 == ds.WINDOW_STAGE_BYTES
    for mode, byte_map in ((cs.MODE_COUNT, 256), (cs.MODE_SPAN, 256),
                           (cs.MODE_MATCH, 256), (cs.MODE_FLAG, 0),
                           (cs.MODE_RESET, 0)):
        words = cs.SMEM_LIMIT // 4 - byte_map
        assert cs.lane_instance(mode, words // 64, 64) == "shared"
        assert cs.lane_instance(mode, words // 64 + 1, 64) == "global"
    words = (cs.SMEM_LIMIT - ds.WINDOW_STAGE_BYTES) // 4 - 256
    assert ds.window_fits(words // 4, 4)
    assert not ds.window_fits(words // 4 + 1, 4)
    with pytest.raises(ValueError, match="int32"):
        cs.check_table(2 ** 25, 64)
