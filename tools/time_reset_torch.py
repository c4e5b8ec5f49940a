#!/usr/bin/env python3
"""Device times of one checkout's reset scan, and the candidate pipeline's
walls it serves, at chip_smoke.py's 1536 MiB shapes, so that two
checkouts can be timed on one GPU in one run.

    python3 tools/time_reset_torch.py [--root CHECKOUT] [--reps N]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the inputs are built by this checkout's
chip_smoke.py, the same in both.  For POSIX ip and run_gap_x
(chip_smoke.M5) on the 1536 MiB bench corpus, the first K = 2 reset subset
of the candidates, as ``_interleaved_ends`` makes it: pass 0 of the scan
in the checkout's form (the split lane walk's one launch over the corpus,
or the earlier form's one launch a 2^29-byte segment) as the mean of REPS
launches behind a device sleep (chip_smoke.cuda_ms), and the whole scan
with its repair passes, host syncs and the subset's copy and scatter
(host clock, best of 3 after a first call).  Then the warm walls of the
candidate pipeline (``_candidate_spans_dev``, best of 3 after a first
call) of ip, version, upper_digits and run_gap_x, each with the reset
scan's launches a call.  Imports no jax.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = ("ip", "run_gap_x")
WALLS = ("ip", "version", "upper_digits", "run_gap_x")


def best_of(fn, k: int = 3) -> float:
    """Best host wall (ms) of k calls of fn() after a first one, each
    ending in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan, flag_scan
    from coregex_tpu_torch.ops.compact import compact_positions

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}", flush=True)
    base = chip_smoke.build_base()
    corpus = chip_smoke.bench_corpus(base)
    data = torch.from_numpy(corpus).cuda()
    n = len(corpus)
    split = hasattr(dfa_scan.ResetScanner, "scan_tiles")
    pats = {nm: (p, posix) for nm, p, posix, _o in chip_smoke.M5}

    def line(label, ms, extra=""):
        print(f"[time] {label:44} {ms:9.3f} ms{extra}  ({card})", flush=True)

    for name in SCANS:
        p, posix = pats[name]
        be = (ct.compile_posix if posix else ct.compile)(
            p, device="cuda").batch_engine()
        sc = be._reset_scanner()
        smask, cnt = be._prefix_run_candidates_mask(data)
        cand, _c = compact_positions(smask, int(cnt) + 16)
        r = cand[:int(cnt)][0::2].clone()
        del smask, cand
        if split:
            base_t = sc.tiles(sc.packed(data, pad=1))
            L, T, W = sc.geometry(n + 1)
            k = cs.lane_split(T, W)
            tiles = flag_scan.scatter_reset_tiles(base_t, r, L, T // 4)
            offs = torch.zeros(L, dtype=torch.int32, device="cuda")
            offs[0] = W
            lim = (n + 1 - torch.arange(L, device="cuda") * T).clamp(
                0, T).to(torch.int32)
            wargs = (sc.walk.packed, sc.walk.segmap, tiles, W // 4,
                     torch.full((k, L), dfa_scan.DEAD, dtype=torch.int32,
                                device="cuda"), offs, lim)

            def pass0():
                return cs.lane_walk_cuda(cs.MODE_RESET, *wargs)

            def scan():
                return sc.scan_tiles(flag_scan.scatter_reset_tiles(
                    base_t, r, L, T // 4), n + 1)
            form = f"split: L={L} T={T} W={W} k={k}, one launch"
        else:
            base_p = sc.packed(data, pad=1)
            packed = base_p.clone()
            packed[r.long()] |= 1
            L, T, W = dfa_scan.reset_plan_geometry(sc.SEG_LIMIT)
            segs = []
            for off in range(0, n + 1, L * T):
                m = min(n + 1, off + L * T) - off
                Lk = L if m == L * T else -(-m // T)
                buf = torch.zeros(Lk * T, dtype=torch.uint8, device="cuda")
                buf[:m] = packed[off:off + m]
                offs = torch.zeros(Lk, dtype=torch.int32, device="cuda")
                offs[0] = W
                segs.append((sc.tbl, sc.starts, buf, Lk, T, W,
                             torch.zeros(Lk, dtype=torch.int32,
                                         device="cuda"), offs))
            del packed

            def pass0():
                return [dfa_scan.reset_scan_cuda(*a) for a in segs]

            def scan():
                pk = base_p.clone()
                pk[r.long()] |= 1
                return sc.scan_packed(pk)
            form = (f"segments: {len(segs)} launches of L={L} T={T} W={W}")
        line(f"reset pass 0 {name}", chip_smoke.cuda_ms(pass0, args.reps),
             f"  ({int(r.shape[0])} resets; {form})")
        rk = dfa_scan.RESET_KERNEL
        l0 = rk.launches
        line(f"reset scan {name} (passes, syncs, glue)", best_of(scan),
             f"  ({(rk.launches - l0) / 4:.1f} launches a scan)")
        del pass0, scan
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()
    for name in WALLS:
        p, posix = pats[name]
        be = (ct.compile_posix if posix else ct.compile)(
            p, device="cuda").batch_engine()
        kind, margs = be._m5_route()
        rk = dfa_scan.RESET_KERNEL
        l0 = rk.launches
        ms = best_of(lambda: be._candidate_spans_dev(margs, corpus))
        line(f"candidate pipeline {name}", ms,
             f"  ({(rk.launches - l0) / 4:.1f} reset launches a call)")


if __name__ == "__main__":
    main()
