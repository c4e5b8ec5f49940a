#!/usr/bin/env python3
r"""Device time of the capture, row and transfer walks at chip_smoke.py's
phase 3 shapes, for one checkout's kernels or for variants of their
sources, on one GPU.

    python3 tools/time_walks_torch.py [--root CHECKOUT] [--sources DIR]
        [--what onepass,rows,rev,transfer] [--reps N] [--live]
        [--one-walker W,...] [NAME=DEFINES ...]

The shapes: ``cgx_onepass_extract`` on every span of chip_smoke.CAPTURES'
patterns over the 1536 MiB bench corpus (``find_all_spans_device``'s
spans, as phase 3 gives them), ``cgx_rows_match`` of
chip_smoke.ROW_PATTERNS on the first 2^20 lines packed to [2^20, 256],
and ``cgx_rows_rev_start`` from that scan's ends (with ``--live`` also
over the rows that have an end only, compacted).  ``rows`` also times
the forward scan on the same rows ordered by the bytes their walks need
(chip_smoke.row_walk_need), which shows what a warp loses to its longest
row; the order is a measurement only, the kernel's outputs follow its
rows.  ``transfer`` times ``cgx_transfer_walk`` at the split the
checkout's ``sub_lanes`` picks: ip over the 1536 MiB corpus in 4 shards in
both modes (the DFA mode over the forward DFA's match table, the count
mode over the count transducer's), version and multi_literal32 in the
count mode there, and chip_smoke.TRANSFER_EXTRA (quote parity, a random
permutation table of 64 states, multi_literal32) on 256 MiB in 4 shards
in both modes; each line also gives ``compose``'s time over the walk's
maps (the tree of phase 1) and S x n table steps a ms.  ``--one-walker``
also times each variant at G = ``sub_lanes(1, m, D, W)`` for each W (an
ablation hook that walks one entry a piece reads at that split as one
walker a lane), and the tree over random [D, G, S] maps of that G at S =
10 and 112.

``--root`` imports coregex_tpu_torch from another checkout, an unpacked
earlier commit say; this script's own chip_smoke.py builds the corpus and
the rows.  Each NAME=DEFINES builds the checkout's ``onepass_scan.cu``,
``row_scan.cu`` and ``transfer_scan.cu`` (or the copies of them in
``--sources``, scratch copies with -D ablation hooks say) with nvcc, the
package's flags plus the -D defines (space-separated, none after a bare
``NAME=``), into its own library under ``--out`` (default the package's
ignored ``_build/time_walks``; with nvcc's register report), so that
variants are timed in one process on one corpus.  A variant's sources
must take the checkout's wrappers' C arguments.  Where a checkout's
tables offer several table modes
(``modes``: the byte-indexed and class-indexed shared tables, global
memory), each is timed.  Every variant is timed twice, the variants in
turn and then in reverse order, each reading the mean of ``--reps``
launches after a warm-up (chip_smoke.cuda_ms); the line gives the best
and both readings, and each variant's output is compared with the first
variant's (an ablation that drops part of the walk differs).  Prints the
card's name and power limit.  Imports no jax.
"""

import argparse
import ctypes
import importlib.util
import inspect
import os
import subprocess
import sys
import time

OWN = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("onepass_scan.cu", "row_scan.cu", "transfer_scan.cu")
ENTRIES = ("cgx_onepass_extract", "cgx_rows_match", "cgx_rows_rev_start",
           "cgx_transfer_walk")


def build(variants, sources, csrc, out, tag, nvcc, flags, arch):
    """Start one nvcc a variant and source (from `sources` where it holds
    the file, else the checkout's `csrc`); returns a function that waits
    for them, links each variant and returns {name: library path}."""
    procs = []
    paths = [os.path.join(sources, s) if os.path.exists(
        os.path.join(sources, s)) else os.path.join(csrc, s)
        for s in SOURCES]
    for name, defs in variants:
        objs = [os.path.join(out, f"{tag}_{name}.{s}.o") for s in SOURCES]
        procs.append((name, objs, [subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-c", *defs, "-o", o, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, o in zip(paths, objs)]))

    def wait():
        libs = {}
        for name, objs, ps in procs:
            so = os.path.join(out, f"{tag}_{name}.so")
            logs = [p.communicate(timeout=900)[0] for p in ps]
            ok = all(p.returncode == 0 for p in ps)
            if ok:
                r = subprocess.run([nvcc, *arch, "-shared", "-o", so, *objs],
                                   capture_output=True, text=True,
                                   timeout=600)
                logs.append(r.stdout + r.stderr)
                ok = r.returncode == 0
            with open(os.path.join(out, f"{tag}_{name}.log"), "w") as f:
                f.write("".join(logs))
            if not ok:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{''.join(logs)}")
            libs[name] = so
        return libs
    return wait


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=OWN)
    ap.add_argument("--sources")
    ap.add_argument("--what", default="onepass,rows,rev,transfer")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--one-walker", default="")
    ap.add_argument("variants", nargs="*", default=["kernel="])
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    out = os.path.abspath(a.out) if a.out else None
    sources = os.path.abspath(a.sources) if a.sources else None
    what = a.what.split(",")
    variants = [(v.partition("=")[0], v.partition("=")[2].split())
                for v in a.variants]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(OWN, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import _build
    from coregex_tpu_torch.ops import onepass_scan as ops
    from coregex_tpu_torch.ops import rowscan as rs
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    cs.phase_device()
    out = out or os.path.join(_build.BUILD_DIR, "time_walks")
    os.makedirs(out, exist_ok=True)
    tag = os.path.basename(root.rstrip("/"))
    sources = sources or _build.CSRC
    t0 = time.perf_counter()
    wait = build(variants, sources, _build.CSRC, out, tag, _build._nvcc(),
                 _build.FLAGS, _build.ARCH)
    # the checkout's library, for the spans (the transfer walk alone needs
    # none: its first variant stands in)
    main_lib = _build.lib() if set(what) - {"transfer"} else None
    libs = {}
    for name, so in wait().items():
        lib = ctypes.CDLL(so)
        for fn in ENTRIES:
            f = getattr(lib, fn)
            f.argtypes = _build._SIGNATURES[fn]
            f.restype = ctypes.c_int
        libs[name] = lib
    main_lib = main_lib or libs[variants[0][0]]
    _build._lib = main_lib
    print(f"[time_walks] {len(libs)} variant(s) of {sources}/"
          f"{{{','.join(SOURCES)}}} built in "
          f"{time.perf_counter() - t0:.1f} s (root {root})", flush=True)

    def timed(label, tables, fn):
        """Every variant (and table mode) of fn, in turn, then in reverse
        order; the first variant's output is the one returned."""
        modes = getattr(tables, "modes", (None,))
        chosen = getattr(tables, "mode", None)
        first = None
        for mode in modes:
            if mode is not None:
                tables.mode = mode
            ms, ref = {}, None
            for rnd in range(2):
                for vname, _ in (variants if rnd == 0 else variants[::-1]):
                    _build._lib = libs[vname]
                    ms.setdefault(vname, []).append(cs.cuda_ms(fn, a.reps))
                    if rnd == 0:
                        o = fn()
                        o = o if isinstance(o, tuple) else (o,)
                        ref = o if ref is None else ref
                        eq = cs.max_abs_err(o, ref) == 0
                        if not eq:
                            print(f"[time_walks]   {vname} differs from "
                                  f"{variants[0][0]}", flush=True)
            _build._lib = main_lib
            if first is None or mode == chosen:
                first = ref
                timed.ms = ms
            tm = "" if mode is None else f" {mode}" + (
                " (chosen)" if mode == chosen else "")
            print(f"[time_walks] {label}{tm}: " + "  ".join(
                f"{v} {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})"
                for v, t in ms.items()), flush=True)
        if chosen is not None:
            tables.mode = chosen
        return first

    base = cs.build_base()
    if "onepass" in what:
        corpus = cs.bench_corpus(base)
        data = device_corpus(corpus, "cuda")
        for name, pattern in cs.CAPTURES:
            eng = ct.compile(pattern, device="cuda")
            d = ops.DeviceOnePass(eng._onepass_dfa(), "cuda")
            r = eng.batch_engine().find_all_spans_device(corpus)
            sp = r[0][:int(r[1])]
            walked = int((sp[:, 1] - sp[:, 0]).sum(dtype=torch.int64))
            timed(f"onepass_extract {name} {sp.shape[0]} spans, {walked} "
                  f"bytes, S={d.S} C={d.C} NS={d.NS}", d,
                  lambda: ops.onepass_cuda(d, data, sp))
            del sp, r
        del data, corpus
        torch.cuda.empty_cache()
    if "rows" in what or "rev" in what:
        rows, lens = rs.pack_rows(cs.bench_lines(base))
        for name, pattern in cs.ROW_PATTERNS:
            eng = ct.compile(pattern, device="cuda")
            rb = rs.RowBatch(eng.fwd, eng.rev, "cuda")
            rt, lt = rb.upload(rows, lens)
            label = f"{name} {rt.shape[0]}x{rt.shape[1]} S={rb.fwd.S}"
            found, last = timed(
                f"rows_match {label}", rb.fwd,
                lambda: rs.rows_match_cuda(rb.fwd, rt, lt))
            if "rows" in what:
                need = cs.row_walk_need(
                    rb.fwd, rt, torch.full_like(lt, rb.fwd.start), lt)
                order = torch.argsort(need, stable=True)
                srt, slt = rt[order].contiguous(), lt[order].contiguous()
                timed(f"rows_match {label} ordered by need (needs "
                      f"{int(need.sum())} bytes)", rb.fwd,
                      lambda: rs.rows_match_cuda(rb.fwd, srt, slt))
                del srt, slt, need, order
            if "rev" in what:
                ends = torch.where(found, last, -1)
                s0 = rs.rev_start_states(rb.rev, rt, lt, ends)
                # a checkout whose reverse kernel takes the table modes
                rev_modes = rb.rev if hasattr(rs, "_check_mode") else None
                timed(f"rows_rev_start {name} {int(found.sum())} ends",
                      rev_modes,
                      lambda: rs.rows_rev_cuda(rb.rev, rt, ends, s0))
                if a.live:
                    live = ends >= 0
                    rl, el, sl = (x[live].contiguous() for x in
                                  (rt, ends, s0))
                    timed(f"rows_rev_start {name} live rows only "
                          f"({rl.shape[0]} rows)", rev_modes,
                          lambda: rs.rows_rev_cuda(rb.rev, rl, el, sl))
                    del rl, el, sl
            del rt, lt, found, last
            torch.cuda.empty_cache()
    if "transfer" in what:
        transfer(cs, a, torch, timed, variants)


def transfer(cs, a, torch, timed, variants):
    """The transfer walk's cases (see the module's docstring)."""
    from coregex_tpu_torch.ops import transfer_scan as ts
    D = cs.MESH_SHARDS
    corpus = cs.bench_corpus(cs.build_base())
    ones = [int(w) for w in a.one_walker.split(",") if w]
    gen = torch.Generator(device=cs.DEVICE).manual_seed(18)

    def tree_ms(G, S):
        F = torch.randint(0, S, (D * G, S), generator=gen, device=cs.DEVICE,
                          dtype=torch.int32)
        E = torch.randint(0, 3, (D * G, S), generator=gen, device=cs.DEVICE,
                          dtype=torch.int32)
        return cs.cuda_ms(lambda: ts.compose(F, E, D), a.reps)

    cases = [("ip", m, None) for m in (ts.MODE_DFA, ts.MODE_COUNT)]
    cases += [(nm, ts.MODE_COUNT, None) for nm in ("version",
                                                   "multi_literal32")]
    cases += [(nm, m, cs.TRANSFER_EXTRA_MIB) for nm in cs.TRANSFER_EXTRA
              for m in (ts.MODE_DFA, ts.MODE_COUNT)
              if not (nm == "perm64" and m == ts.MODE_COUNT)]
    old_rule = "S" in inspect.signature(ts.sub_lanes).parameters

    def split(S, m, walkers=None):
        """G as the checkout's sub_lanes picks it (a rule before the
        merging walk also takes S)."""
        args = (S, m, D) if old_rule else (m, D)
        return ts.sub_lanes(*args, *([walkers] if walkers else []))

    big = cs.transfer_data("ip", corpus, len(corpus) >> 20)
    for name, mode, mib in cases:
        packed, segmap = cs.transfer_tables(name, mode)
        data = big if mib is None else cs.transfer_data(name, corpus, mib)
        S, n = int(packed.shape[0]), int(data.shape[0])
        m = n // D
        mname = ("dfa", "count")[mode]
        for G in [split(S, m)] + [split(1, m, w) for w in ones]:
            label = (f"transfer {name} {mname} S={S} "
                     f"{n / 2 ** 20:.0f} MiB D={D} G={G}")
            F, E = timed(label, None, lambda: ts.transfer_walk_cuda(
                packed, segmap, data, m, D, G))
            t = cs.cuda_ms(lambda: ts.compose(F, E, D), a.reps)
            best = min(timed.ms[variants[0][0]])
            print(f"[time_walks]   compose {t:.4f} ms over [{D * G}, "
                  f"{int(F.shape[1])}] maps; {S * n / best / 1e9:.2f} G "
                  f"table steps/ms", flush=True)
            del F, E
        del data
        torch.cuda.empty_cache()
    for w in ones:
        G = split(1, int(big.shape[0]) // D, w)
        print(f"[time_walks] compose over random [{D}, {G}, S] maps: "
              + "  ".join(f"S={S} {tree_ms(G, S):.4f} ms"
                          for S in (10, 112)), flush=True)


if __name__ == "__main__":
    main()
