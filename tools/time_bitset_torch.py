#!/usr/bin/env python3
r"""Device time of the bitset-NFA scan's pass 0 at chip_smoke.py's main
path shape (the 1536 MiB bench corpus, k = 64 sub-lanes a lane), for one
checkout's kernel or for variants of a kernel source, on one GPU.

    python3 tools/time_bitset_torch.py [--root CHECKOUT] [--source FILE]
        [--patterns I,J] [--kinds rev,fwd] [NAME=DEFINES ...]

``--root`` imports coregex_tpu_torch (and its chip_smoke.py, which builds
the corpus) from another checkout, an unpacked earlier commit say; its
``csrc/nfa_scan.cu`` is timed unless ``--source`` names another copy of
the kernel.  Each NAME=DEFINES builds that source with nvcc (the
package's flags plus the -D defines, space-separated, none after a bare
``NAME=``; once a CGX_NFA_PART where the source splits its kernels so)
into its own library under ``--out`` (default
``chiprun_out/time_bitset``, with nvcc's register report), so that
variants of one source (ablations with -D hooks in a scratch copy) are
timed in one process on one corpus.  For each of chip_smoke.BITSET's
patterns picked by ``--patterns`` (indices, default 0) and each kind
(``rev`` is the scan over the flipped corpus), every variant's pass 0 is
timed twice, the variants in turn and then in reverse order, each reading
the mean of 3 launches after a warm-up (chip_smoke.cuda_ms); the line
gives the best and both readings, and each variant's first output is
compared with the first variant's (equal or not: an ablation that drops
part of the step is not).  Prints the card's name and power limit.
Imports no jax.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--source")
    ap.add_argument("--patterns", default="0")
    ap.add_argument("--kinds", default="rev,fwd")
    ap.add_argument("--out", default="chiprun_out/time_bitset")
    ap.add_argument("variants", nargs="*", default=["kernel="])
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    out = os.path.abspath(a.out)
    source = os.path.abspath(a.source) if a.source else os.path.join(
        root, "coregex_tpu_torch", "csrc", "nfa_scan.cu")
    variants = [(v.partition("=")[0], v.partition("=")[2].split())
                for v in a.variants]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import _build
    from coregex_tpu_torch.ops import count_scan as cnt
    from coregex_tpu_torch.ops import nfa_scan as ns

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    os.makedirs(out, exist_ok=True)
    tag = os.path.basename(root.rstrip("/"))
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    with open(source) as f:
        parts = range(5) if "CGX_NFA_PART" in f.read() else [0]
    t0 = time.perf_counter()
    procs = []
    for name, defs in variants:
        objs = [os.path.join(out, f"{tag}_{name}.{q}.o") for q in parts]
        procs.append((name, objs, [subprocess.Popen(
            [nvcc, *_build.FLAGS, "-Xptxas", "-v", "-c", "-I",
             os.path.dirname(source), "-I", _build.CSRC, *defs,
             f"-DCGX_NFA_PART={q}", "-o", o, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for q, o in zip(parts, objs)]))
    libs = {}
    for name, objs, ps in procs:
        so = os.path.join(out, f"{tag}_{name}.so")
        logs = [p.communicate(timeout=900)[0] for p in ps]
        if all(p.returncode == 0 for p in ps):
            r = subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", so,
                                *objs], capture_output=True, text=True,
                               timeout=600)
            logs.append(r.stdout + r.stderr)
        with open(os.path.join(out, f"{tag}_{name}.log"), "w") as f:
            f.write("".join(logs))
        if any(p.returncode for p in ps) or r.returncode:
            cs.fail(f"nvcc failed for {name}:\n{''.join(logs)}")
        lib = ctypes.CDLL(so)
        for fn in ("cgx_bitset_scan", "cgx_bitset_occupancy"):
            f = getattr(lib, fn)
            f.argtypes = _build._SIGNATURES[fn]
            f.restype = ctypes.c_int
        libs[name] = lib
    print(f"[time_bitset] {len(libs)} variant(s) of {source} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cs.phase_device()
    corpus = torch.from_numpy(cs.bench_corpus(cs.build_base())).cuda()
    for pi in (int(x) for x in a.patterns.split(",")):
        name, pattern = cs.BITSET[pi]
        be = ct.compile(pattern, device="cuda").batch_engine()
        for kind in a.kinds.split(","):
            d = be._bitset_scanner(kind).d
            x = corpus if kind == "fwd" else torch.flip(corpus, [0])
            L, T, W, _ = cnt.plan_geometry(int(x.shape[0]))
            k = cnt.lane_split(T, W)
            tiles = cnt.make_word_tiles(x, L, T // 4)
            args, _first = cs.bitset_args(d, x, (L, T, W), tiles, k)
            ms, ref = {}, None
            for rnd in range(2):
                for vname, _defs in (variants if rnd == 0
                                     else variants[::-1]):
                    _build._lib = libs[vname]
                    ms.setdefault(vname, []).append(cs.cuda_ms(
                        lambda: ns.bitset_walk_cuda(*args), 3))
                    if rnd == 0:
                        o = ns.bitset_walk_cuda(*args)
                        ref = o if ref is None else ref
                        info = (ns.kernel_info(d)
                                if hasattr(ns, "kernel_info") else "")
                        print(f"[time_bitset]   {vname}: {info} equal to "
                              f"{variants[0][0]}: "
                              f"{cs.max_abs_err(o, ref) == 0}", flush=True)
                        del o
            _build._lib = None
            print(f"[time_bitset] {name} {kind} S={d.S} NW={d.NW} G={d.G} "
                  f"Gs={d.Gs} L={L} T={T} W={W} k={k}: " + "  ".join(
                      f"{v} {min(t):.3f} ({'/'.join(f'{u:.3f}' for u in t)})"
                      for v, t in ms.items()), flush=True)
            del tiles, args, x, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
