#!/usr/bin/env python3
r"""Smoke run of coregex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. device  - requires torch.cuda; prints the card's name and power limit
  2. build   - builds coregex_tpu_torch/csrc/*.cu with nvcc for sm_90a
  3. kernels - each CUDA kernel against its plain torch version on the card,
               on the same inputs at main-path shapes, bit-equal per lane;
               times both.  The lane walks (K1-K3) and the needle kernels
               (K5-K7) run on a 4 MiB sample (several patterns) and on the
               whole 1536 MiB corpus (one pattern each); the compaction (K4)
               on 2^22- and 2^26-entry masks, and the sparse chain with 3
               and 5 word payloads at the 2^26-word shape of its first level
  4. e2e     - the public API on a 1536 MiB log corpus (the JAX package's
               bench corpus): count for the 13 bench patterns and for
               `0\.0` (whose hits overlap, so K6 hands over to K7), device
               find_all for the 4 bidirectional patterns and the 3 line
               shapes, checked against a Python `re` oracle on the 6 MiB
               base tile scaled by the tile count; find_all_index on a
               64 MiB slice compared span by span.  The 7 patterns that
               count through K5 or K6 are also counted through K1, timed
               side by side
  5. routes  - every kernel K1-K7 was launched during phase 4 and no slice
               call was declined to the host loop

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.  Imports no jax.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# -- the JAX package's bench corpus and patterns (bench.py:58-120) -----------

def build_base(size=6 * 1024 * 1024, seed=7) -> bytes:
    """Log-like base corpus (paths, IPs, emails, URLs, versions, verbs,
    keywords), trimmed to the last full line so tiling is line-aligned."""
    rng = np.random.default_rng(seed)
    words = [
        b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
        b"dog", b"lorem", b"ipsum", b"dolor", b"sit", b"amet", b"consec",
        b"GET", b"POST", b"HTTP/1.1", b"200", b"404", b"useragent",
        b"alpha", b"beta", b"gamma", b"delta42", b"x86_64", b"warning",
    ]
    specials = [
        b"192.168.1.10", b"10.0.0.255", b"error", b"keyword",
        b"user@example.com", b"admin@test.org", b"v1.2.3",
        b"/index.php", b"/home/user/www.php", b"file.txt", b"notes.log",
        b"https://example.com/index.html?q=1", b"http://test.org/a/b",
        b"DELETE", b"2.14.7",
    ]
    lines = []
    total = 0
    while total < size:
        k = int(rng.integers(4, 12))
        line = []
        for _ in range(k):
            if rng.random() < 0.08:
                line.append(specials[int(rng.integers(len(specials)))])
            else:
                line.append(words[int(rng.integers(len(words)))])
        ln = b" ".join(line) + b"\n"
        lines.append(ln)
        total += len(ln)
    base = b"".join(lines)[:size]
    return base[:base.rfind(b"\n") + 1]


ALT32 = "|".join(
    ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
     "lambda", "sigma", "omega", "error", "warning", "notice", "debug",
     "trace", "fatal", "panic", "abort", "retry", "timeout", "refused",
     "closed", "opened", "created", "deleted", "updated", "inserted",
     "removed", "flushed", "synced", "loaded", "stored"])

CONFIGS = [
    ("inner_keyword", r".*keyword.*"),
    ("ip", r"\d+\.\d+\.\d+\.\d+"),
    ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
    ("url", r"\w+://[^\s]+"),
    ("multiline_php", r"(?m)^/.*\.php"),
    ("version", r"\d+.\d+.\d+"),
    ("suffix_txt", r".*\.txt"),
    ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH"),
    ("alt_literal", r"error|warning|notice|info|debug"),
    ("multi_literal32", ALT32),
    ("charclass_w", r"[\w]+"),
    ("word_repeat", r"(\w{2,8})+"),
    ("literal_error", r"error"),
]
# counted with the bench patterns, outside bench.py's list
EXTRA_COUNTS = [("overlap_0.0", r"0\.0")]
FIND_ALL = ("ip", "version", "email", "url", "inner_keyword", "multiline_php",
            "suffix_txt")
# the patterns the needle kernels count (K5: line shapes, K6: literal sets)
REROUTED = ("inner_keyword", "multiline_php", "suffix_txt", "http_methods",
            "alt_literal", "multi_literal32", "literal_error")
PATTERNS = dict(CONFIGS + EXTRA_COUNTS)
DEVICE = "cuda"
CORPUS_MIB = 1536
SLICE_MIB = 64
BIG_WORDS = 1 << 26     # K4 mask / chain word count of a 1536 MiB find_all


def oracle_spans(pattern: str, base: bytes):
    return [m.span() for m in re.finditer(pattern.encode("ascii"), base)]


# -- timing ------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warmup."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(xs, ys) -> int:
    """Largest |x - y| over paired integer tensors; fails if any pair
    differs in shape or dtype."""
    import torch
    err = 0
    for x, y in zip(xs, ys):
        if (x is None) != (y is None):
            fail("kernel and plain version return different outputs")
        if x is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"shape/dtype mismatch {x.shape}/{x.dtype} vs "
                 f"{y.shape}/{y.dtype}")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


# -- phases ----------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from coregex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    wall = time.perf_counter() - t0
    how = (f"nvcc {' '.join(_build.FLAGS)} in {_build.build_seconds:.2f} s"
           if _build.build_seconds is not None else "already built")
    print(f"[build] {_build.library_path()} from {_build.CSRC}/"
          f"{{{','.join(_build.SOURCES)}}}: {how} (load {wall:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")
    return _build.build_seconds


def phase_kernels(base: bytes, corpus: np.ndarray):
    """Each kernel against its plain version at main-path shapes: the lane
    walks and needle kernels on a 4 MiB sample for several patterns and on
    the whole corpus for one each, the compaction and the sparse chain on
    masks and words of the sizes the span chains give them."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import (compact2, flag_scan, line_scan,
                                       seq_scan, span_chain)
    from coregex_tpu_torch.ops.bytescan import _bucket
    from coregex_tpu_torch.ops.compact2 import _bucket_up
    from coregex_tpu_torch.ops.flag_scan import DEAD

    dev = torch.device(DEVICE)
    results = {}

    def compare(kind, label, run_kernel, run_plain, reps=5,
                headline=False):
        """Bit-equality of kernel and plain version on one input; the
        plain run is timed once, the kernel over reps launches.  The
        headline comparison's times go into the JSON line."""
        k = run_kernel()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        p = run_plain()
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = max_abs_err(k, p)
        if err:
            fail(f"{kind} kernel differs from its plain version on {label}"
                 f" (max abs err {err})")
        ms = cuda_ms(run_kernel, reps)
        print(f"[kernels] {kind:11} {label:20} bit-equal (tolerance 0)  "
              f"kernel {ms:9.3f} ms  plain {plain_ms:10.3f} ms", flush=True)
        r = results.setdefault(kind, dict(max_abs_err=0, ms=None,
                                          plain_ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if headline or r["ms"] is None:
            r["ms"], r["plain_ms"] = ms, plain_ms

    def lane_kernels(name, data, label, headline):
        """K1, K2 and K3 on one corpus under the main path's geometry."""
        n = int(data.shape[0])
        L, T, W, _ = cs.plan_geometry(n)
        tiles = cs.make_word_tiles(data, L, T // 4)
        print(f"[kernels] {label}: {n} bytes, geometry L={L} T={T} W={W}")
        be = ct.compile(dict(CONFIGS)[name], device=DEVICE).batch_engine()
        sc = be._count_scanner_ascii()
        if not sc:
            fail(f"{name}: no ASCII count transducer")
        d = sc.dcd
        e0, o0, lim = cs.first_pass_inputs(d.starts, data, n, L, T, W)
        args = (d.packed, d.segmap, tiles, W // 4, e0, o0, lim)
        compare("count_scan", label,
                lambda: cs.lane_walk_cuda(cs.MODE_COUNT, *args),
                lambda: cs.lane_walk_plain(cs.MODE_COUNT, *args),
                headline=headline)
        ssc = be._span_scanner(True)
        if not ssc:
            return
        s = ssc.dsd
        e0, o0, lim = cs.first_pass_inputs(s.starts, data, n, L, T, W)
        sargs = (s.packed, s.segmap, tiles, W // 4, e0, o0, lim)
        compare("span_scan", label,
                lambda: cs.lane_walk_cuda(cs.MODE_SPAN, *sargs),
                lambda: cs.lane_walk_plain(cs.MODE_SPAN, *sargs),
                headline=headline)
        rsc = be._rev_flag_scanner(True)
        if not rsc:
            return
        # reset symbols at the reversed match ends, as the bidi path
        fw, gw, total, kind, _conv = ssc.scan(data)
        total = int(total)
        capM = _bucket(total + 1, 16)
        nwb = _bucket_up(-(-n // 32))
        nwb1 = _bucket_up(-(-(n + 1) // 32))
        _e, _c, rq, _rw, _ok = span_chain.bidi_ends(
            fw, gw, n, total, int(kind), capM, nwb, nwb1)
        del fw, gw
        Lr, Tr, Wr, _ = flag_scan.reset_geometry(n)
        symt = flag_scan.scatter_reset_tiles(
            flag_scan.sym_base_tiles(torch.flip(data, [0]),
                                     rsc.byte_bounds(), Lr, Tr // 4),
            rq, Lr, Tr // 4)
        lanes = torch.arange(Lr, dtype=torch.int64, device=dev)
        entries = torch.full((Lr,), DEAD, dtype=torch.int32, device=dev)
        offs = torch.zeros(Lr, dtype=torch.int32, device=dev)
        offs[0] = Wr
        flim = (n + 1 - lanes * Tr).clamp(0, Tr).to(torch.int32)
        fargs = (rsc.tables.packed_full, None, symt, Wr // 4, entries, offs,
                 flim)
        compare("flag_scan", label,
                lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fargs),
                lambda: cs.lane_walk_plain(cs.MODE_FLAG, *fargs),
                headline=headline)

    n = 4 * 1024 * 1024
    sample = base[:base.rfind(b"\n", 0, n) + 1]
    data = torch.from_numpy(np.frombuffer(sample, np.uint8).copy()).to(dev)
    for name in ("ip", "email", "multi_literal32"):
        lane_kernels(name, data, name, headline=False)
    # the main path's lane length: the whole corpus, one pattern
    data = torch.from_numpy(corpus).to(dev)
    lane_kernels("ip", data, f"ip {CORPUS_MIB} MiB", headline=True)
    del data
    for kind in ("count_scan", "span_scan", "flag_scan"):
        if kind not in results:
            fail(f"no {kind} comparison ran")

    def needle_kernels(data, label, k5=(), k6=(), k7=(), headline=False):
        """K5, K6 and K7 on one corpus under the main path's geometry."""
        n = int(data.shape[0])
        geom = cs.plan_geometry(n)
        L, T = geom[:2]
        tiles = cs.make_word_tiles(data, L, T // 4)
        print(f"[kernels] {label}: {n} bytes, geometry L={L} T={T}")
        for name in k5:
            sc = ct.compile(PATTERNS[name], device=DEVICE) \
                .batch_engine()._line_scanner()
            args = sc.lane_args(data, geom, tiles)
            compare("line_scan", f"{name} {label}",
                    lambda: line_scan.line_lanes_cuda(*args),
                    lambda: line_scan.line_lanes_plain(*args),
                    headline=headline)
        for name in k6:
            sc = ct.compile(PATTERNS[name], device=DEVICE) \
                .batch_engine()._hits_scanner()
            args = (sc.tbl, sc.lens, tiles)
            compare("hits_scan", f"{name} {label}",
                    lambda: line_scan.hits_lanes_cuda(*args),
                    lambda: line_scan.hits_lanes_plain(*args),
                    headline=headline)
        for what, sc in k7:
            L, T, W, _ = seq_scan.seq_geometry(n, sc.M)
            e0, o0, lim, _e = sc.first_pass(data, n, L, T, W)
            args = (sc.mode, sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen,
                    tiles, W // 4, e0, o0, lim)
            compare("seq_scan", f"{what} {label}",
                    lambda: seq_scan.seq_lanes_cuda(*args),
                    lambda: seq_scan.seq_lanes_plain(*args),
                    headline=headline)

    def seq(mode, needles, prefix=b""):
        return seq_scan.SeqScanner(mode, needles, prefix=prefix,
                                   anchored=bool(prefix), device=dev)

    sample = torch.from_numpy(np.frombuffer(sample, np.uint8).copy()).to(dev)
    alt32 = [w.encode() for w in ALT32.split("|")]
    needle_kernels(
        sample, "4 MiB", k5=("inner_keyword", "multiline_php", "suffix_txt"),
        k6=("http_methods", "multi_literal32", "literal_error"),
        k7=[("multi 0.0", seq(seq_scan.MODE_MULTI, [b"0.0"])),
            ("multi alt32", seq(seq_scan.MODE_MULTI, alt32)),
            ("line keyword", seq(seq_scan.MODE_LINE, [b"keyword"])),
            ("line ^/ .php", seq(seq_scan.MODE_LINE, [b".php"], b"/"))])
    data = torch.from_numpy(corpus).to(dev)
    needle_kernels(data, f"{CORPUS_MIB} MiB", k5=("multiline_php",),
                   k6=("multi_literal32",),
                   k7=[("multi 0.0", seq(seq_scan.MODE_MULTI, [b"0.0"]))],
                   headline=True)
    del data
    for kind in ("line_scan", "hits_scan", "seq_scan"):
        if kind not in results:
            fail(f"no {kind} comparison ran")

    # the sparse chain with 3 and 5 word payloads (line shapes, plain and
    # anchored) at the 2^26-word shape of a 1536 MiB corpus's first level
    nw = BIG_WORDS
    g = torch.Generator(device=dev).manual_seed(9)
    evw = torch.where(torch.rand(nw, device=dev, generator=g) < 0.02,
                      torch.randint(-2 ** 31, 2 ** 31 - 1, (nw,),
                                    device=dev, dtype=torch.int32,
                                    generator=g), 0).to(torch.int32)
    wpays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (nw,), device=dev,
                           dtype=torch.int32, generator=g)
             for _ in range(5)]
    u = evw.to(torch.int64) & 0xFFFFFFFF
    nbits = int(sum(((u >> k) & 1).sum() for k in range(32)))
    del u
    for P in (3, 5):
        cap = nbits + 16
        compare("chain", f"n=2^{nw.bit_length() - 1} words P={P}",
                lambda: compact2.sparse_chain_payloads(
                    evw, wpays[:P], 2 ** 31 - 1, cap),
                lambda: chain_plain(evw, wpays[:P], 2 ** 31 - 1, cap),
                reps=2)
    del evw, wpays

    # K4 on masks of several densities with 0-4 payloads (bit-31 words)
    rng = np.random.default_rng(5)
    m = 1 << 22
    pays = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, m,
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]
    for dens in (0.0, 1e-4, 0.05, 1.0):
        mask = torch.from_numpy(rng.random(m) < dens).to(dev)
        nset = int(mask.sum())
        for npay in range(5):
            for cap in {max(16, nset + 5), max(1, nset // 2)}:
                compare("compact_pay", f"d={dens} p={npay} cap={cap}",
                        lambda: compact2.compact_pay_cuda(
                            mask.view(torch.uint8), pays[:npay], cap),
                        lambda: compact2.compact_pay_plain(
                            mask.view(torch.uint8), pays[:npay], cap),
                        reps=2)
    # the level-1 chain shape of a 1536 MiB find_all: 2^26 entries, so the
    # block-offset carry runs across many chunks
    big = BIG_WORDS
    bpays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (big,), dtype=torch.int32,
                           device=dev) for _ in range(4)]
    for dens in (1.0, 0.01):
        mask = torch.rand(big, device=dev) < dens
        cap = int(mask.sum()) + 16
        for npay in (4, 3):
            compare("compact_pay", f"n=2^26 d={dens} p={npay}",
                    lambda: compact2.compact_pay_cuda(
                        mask.view(torch.uint8), bpays[:npay], cap),
                    lambda: compact2.compact_pay_plain(
                        mask.view(torch.uint8), bpays[:npay], cap),
                    headline=True)
    return results


def chain_plain(evw, wpays, n: int, cap: int):
    """Plain sparse chain: the set-bit positions of the event words in
    order, each with its word's payloads; slots past the count hold n and
    0 (the contract of compact2.sparse_chain_payloads)."""
    import torch
    dev = evw.device
    widx = torch.nonzero(evw != 0).reshape(-1)
    w = evw[widx].to(torch.int64) & 0xFFFFFFFF
    r, c = torch.nonzero((w[:, None] >> torch.arange(32, device=dev)) & 1,
                         as_tuple=True)
    cnt = int(r.numel())
    k = min(cnt, cap)
    pos = torch.full((cap,), n, dtype=torch.int32, device=dev)
    pos[:k] = (widx[r[:k]] * 32 + c[:k]).to(torch.int32)
    pays = []
    for q in wpays:
        o = torch.zeros(cap, dtype=torch.int32, device=dev)
        o[:k] = q[widx[r[:k]]]
        pays.append(o)
    return (pos, *pays, torch.tensor(cnt, dtype=torch.int32, device=dev),
            torch.tensor(cnt <= cap, device=dev))


def bench_corpus(base: bytes) -> np.ndarray:
    """The base tiled to CORPUS_MIB (whole tiles, so line-aligned)."""
    reps = (CORPUS_MIB * 1024 * 1024) // len(base)
    return np.tile(np.frombuffer(base, dtype=np.uint8), reps)


def phase_e2e(base: bytes, arr: np.ndarray):
    """Counts and find_all at corpus scale through the public API."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    B = len(base)
    reps = len(arr) // B
    n = len(arr)
    print(f"[e2e] corpus {n} bytes = {reps} line-aligned tiles of {B}")
    engines = []
    routes = {}     # host_routes of each pattern's slice calls
    rng = np.random.default_rng(123)
    for name, pattern in CONFIGS + EXTRA_COUNTS:
        spans0 = oracle_spans(pattern, base)
        m0 = len(spans0)
        eng = ct.compile(pattern, device=DEVICE)
        engines.append((name, eng))
        t0 = time.perf_counter()
        got = eng.count(arr)
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            eng.count(arr)
            best = min(best, time.perf_counter() - t0)
        if got != reps * m0:
            fail(f"{name}: count {got} != oracle {reps * m0}")
        be = eng.batch_engine()
        route = be._count_route(arr)[0]
        line = (f"[e2e] {name:16} {eng.strategy:13} count {got:>10} ok  "
                f"{n / best / 1e9:7.2f} GB/s ({best * 1e3:.1f} ms via "
                f"{route}, first {first:.2f} s)")
        if name in REROUTED:
            # the same count through K1, the count transducer; these
            # launches are a comparison, not the main path's
            k1_launches = count_scan.COUNT_KERNEL.launches
            sc1 = be._count_scanner_for(True)
            geom = plan_geometry(n)
            dev, tiles = device_corpus(arr, DEVICE), be._word_tiles(
                arr, *geom[:2])
            k1_best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got1 = sc1.count(dev, geom, tiles)
                k1_best = min(k1_best, time.perf_counter() - t0)
            count_scan.COUNT_KERNEL.launches = k1_launches
            if got1 != got:
                fail(f"{name}: K1 count {got1} != {got}")
            line += (f" | K1 {n / k1_best / 1e9:7.2f} GB/s "
                     f"({k1_best * 1e3:.1f} ms)")
        if name in FIND_ALL:
            M = 1 << 32
            exp_s = (reps * sum(s for s, _ in spans0)
                     + B * m0 * (reps * (reps - 1) // 2)) % M
            exp_e = (reps * sum(e for _, e in spans0)
                     + B * m0 * (reps * (reps - 1) // 2)) % M
            sidx = np.sort(rng.integers(0, reps * m0, 64))
            exp_samp = np.array([(spans0[j][0] + t * B, spans0[j][1] + t * B)
                                 for t, j in (divmod(int(g), m0)
                                              for g in sidx)])
            sidx_d = torch.from_numpy(sidx).to(DEVICE)

            def run():
                r = be.find_all_spans_device(arr, defer_ok=True)
                if r is None:
                    fail(f"{name}: find_all declined")
                spans, cnt, ok = r
                cnt = int(cnt)
                ok = True if ok is None else bool(ok)
                sp = spans[:cnt].to(torch.int64)
                return (cnt, ok, int(sp[:, 0].sum()) % M,
                        int(sp[:, 1].sum()) % M,
                        spans[sidx_d].cpu().numpy().astype(np.int64))

            t0 = time.perf_counter()
            res = run()
            fa_first = time.perf_counter() - t0
            fa_best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                res = run()
                fa_best = min(fa_best, time.perf_counter() - t0)
            cnt, ok, ss, es, samp = res
            if not ok or cnt != reps * m0 or ss != exp_s or es != exp_e:
                fail(f"{name}: find_all digest ({cnt}, {ok}, {ss}, {es}) "
                     f"!= oracle ({reps * m0}, True, {exp_s}, {exp_e})")
            if not (samp == exp_samp).all():
                fail(f"{name}: sampled spans differ from the oracle")
            line += (f" | find_all {cnt} spans digest+64 samples ok  "
                     f"{n / fa_best / 1e9:7.2f} GB/s ({fa_best * 1e3:.1f} ms,"
                     f" first {fa_first:.2f} s)")
        print(line, flush=True)
        routes[name] = eng.batch_engine().host_routes
    # exact spans through the public API on a slice
    sreps = (SLICE_MIB * 1024 * 1024) // B
    sl = arr[:sreps * B]
    for name, eng in engines:
        if name not in FIND_ALL:
            continue
        spans0 = oracle_spans(PATTERNS[name], base)
        exp = [(s + t * B, e + t * B) for t in range(sreps)
               for s, e in spans0]
        got = eng.find_all_index(sl)
        routes[name] += eng.batch_engine().host_routes
        if [tuple(x) for x in got] != exp:
            fail(f"{name}: find_all_index on the {len(sl)}-byte slice "
                 f"differs from the oracle")
        print(f"[e2e] {name:16} find_all_index on {len(sl)} bytes: "
              f"{len(got)} spans equal the oracle")
    return routes


def main():
    card = phase_device()
    import torch
    try:
        import coregex_tpu_torch  # noqa: F401
    except ImportError as ex:
        fail(f"cannot import coregex_tpu_torch: {ex}")
    from coregex_tpu_torch.ops import (compact2, count_scan, flag_scan,
                                       line_scan, seq_scan, span_scan)
    counters = [
        (count_scan.COUNT_KERNEL, "lane_scan.cu", "count_scan.py:211"),
        (span_scan.SPAN_KERNEL, "lane_scan.cu", "span_scan.py:108"),
        (flag_scan.FLAG_KERNEL, "lane_scan.cu", "flag_scan.py:164"),
        (compact2.COMPACT_KERNEL, "compact.cu", "compact2.py:91"),
        (line_scan.LINE_KERNEL, "needle_scan.cu", "line_scan.py:78"),
        (line_scan.HITS_KERNEL, "needle_scan.cu", "line_scan.py:407"),
        (seq_scan.SEQ_KERNEL, "needle_scan.cu", "seq_scan.py:103"),
    ]
    build_s = phase_build()
    base = build_base()
    corpus = bench_corpus(base)
    kres = phase_kernels(base, corpus)

    for c, _, _ in counters:
        c.launches = 0
    t0 = time.perf_counter()
    routes = phase_e2e(base, corpus)
    e2e_s = time.perf_counter() - t0
    launches = {c.name: c.launches for c, _, _ in counters}
    print(f"[routes] launches during the e2e phase ({e2e_s:.1f} s): "
          f"{launches}")
    for c, _, _ in counters:
        if c.launches <= 0:
            fail(f"kernel {c.name} was not launched on the main path")
    if any(routes.values()):
        fail(f"slice calls declined to the host loop: {routes}")
    print(f"[routes] host_routes 0 for all {len(routes)} patterns; "
          f"build {build_s} s on {card}")
    print(json.dumps({"kernels": [
        {"name": c.name, "route": "cuda",
         "source": f"coregex_tpu_torch/csrc/{src}",
         "replaces": f"coregex_tpu/ops/{ref}", "launches": c.launches,
         "max_abs_err": kres[c.name]["max_abs_err"],
         "ms": kres[c.name]["ms"], "plain_ms": kres[c.name]["plain_ms"]}
        for c, src, ref in counters]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
