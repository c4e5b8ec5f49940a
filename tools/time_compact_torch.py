#!/usr/bin/env python3
r"""Device times of one checkout's ordered compactions (K4 ``compact_pay``,
K8 ``compact_positions``, K10 ``compact_exp``) and window scan at
chip_smoke.py's headline shapes, so that two checkouts can be timed on one
GPU in one run.

    python3 tools/time_compact_torch.py [--root CHECKOUT] [--what LIST]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the inputs are built by this checkout's
chip_smoke.py, the same in both.  ``--what`` picks groups (comma list,
default all):
  k4k8    K4 on 2^26 entries at density 0.01 with 3 payloads
          (``chain_level``), K4 on charclass_w's unpacked run-start mask of
          the 1536 MiB bench corpus (``class_run_starts``), K8 on the start
          mask of `\w*` over that corpus at the main path's cap and at 2^30
          (``word_starts``);
  window  the window scan from all 54.8M match starts of `\b\d+\b` on
          that corpus at W = 64 (the general find_all's round): the flags
          form in one launch over every lane, the ends form where the
          checkout has one, and ``dfa_scan.window_ends``, the whole round
          with its glue; 2^16 random reverse starts at W = 256 (half with
          edge limits) under `.*keyword.*`'s anchored reverse DFA, both
          forms; one live lane of 16, reverse, at W = 64 (find_first's
          reverse start search);
  k10     K10 on the rig's 256 MiB mask (density 1/200, seed 11): R = 128
          with no payload, R = 256 with two payloads under cond_dma +
          skip_empty, R = 512;
  wall    the warm wall of `\b\d+\b`'s device find_all on the corpus
          (best of 3, host clock, after a first call).
Each kernel line gives the mean device time of REPS launches of the entry
point after a warm-up (chip_smoke.cuda_ms: CUDA events, launches queued
behind a device sleep so that host overhead is not timed); chip_smoke.py
times the same shapes beside their bound and ``torch.nonzero``.  Imports
no jax.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--what", default="k4k8,window,k10,wall")
    args = ap.parse_args()
    what = set(args.what.split(","))
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import compact, compact2, compact_exp, dfa_scan

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}")
    dev = torch.device("cuda")

    def line(label, fn, reps=REPS):
        ms = chip_smoke.cuda_ms(fn, reps)
        print(f"[time] {label:40} {ms:9.3f} ms  ({card})", flush=True)

    corpus = chip_smoke.bench_corpus(chip_smoke.build_base())
    mib = chip_smoke.CORPUS_MIB
    if "k4k8" in what:
        torch.manual_seed(21)
        mask, pays, cap = chip_smoke.chain_level(dev, 0.01)
        line("K4 n=2^26 d=0.01 p=3",
             lambda: compact2.compact_pay(mask, pays[:3], cap))
        del mask, pays
        runs, cap = chip_smoke.class_run_starts(corpus, dev)
        line(f"K4 charclass_w run starts {mib} MiB",
             lambda: compact2.compact_pay(runs, (), cap))
        del runs
        smask, cap = chip_smoke.word_starts(corpus, dev)
        for c in (cap, 1 << 30):
            line(f"K8 \\w* starts {mib} MiB cap=2^{c.bit_length() - 1}",
                 lambda: compact.compact_positions(smask, c))
        del smask
    if "window" in what:
        window_lines(ct, dfa_scan, corpus, dev, line)
    if "k10" in what:
        from tools import profile_compact_torch as rig
        mask, _nset, cap = rig.rig_mask(256, 1 / 200, "cuda")
        m8 = mask.view(torch.uint8)
        g = torch.Generator(device=dev).manual_seed(13)
        pays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (mask.numel(),),
                              dtype=torch.int32, device=dev, generator=g)
                for _ in range(2)]
        for R, npay, kw in ((128, 0, {}),
                            (256, 2, dict(cond_dma=True, skip_empty=True)),
                            (512, 0, {})):
            line(f"K10 256 MiB R={R} p={npay}" + (" cond+skip" if kw
                                                  else ""),
                 lambda: compact_exp.compact_exp_cuda(m8, pays[:npay], cap,
                                                      R, **kw))
        del mask, m8, pays
    if "wall" in what:
        be = ct.compile(r"\b\d+\b", device="cuda").batch_engine()
        be.find_all_spans_device(corpus)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            be.find_all_spans_device(corpus)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        label = "find_all \\b\\d+\\b wall (best of 3)"
        print(f"[time] {label:40} {best * 1e3:9.3f} ms  ({card})",
              flush=True)


def window_lines(ct, dfa_scan, corpus, dev, line):
    """The window scan's lines (see the module docstring)."""
    import torch
    data = torch.from_numpy(corpus).to(dev)
    n = int(data.shape[0])
    be = ct.compile(r"\b\d+\b", device="cuda").batch_engine()
    rev, fwd_mt = be._full_scan_route()
    starts, m, _ok = be._all_starts(rev, corpus)
    st = starts[:m].contiguous()
    del starts
    ends_cuda = getattr(dfa_scan, "window_ends_cuda", None)
    edge = torch.full((m,), n, dtype=torch.int32, device=dev)
    fargs = dfa_scan.window_args(fwd_mt, data, st, edge, 64)
    line(f"window flags {m} starts W=64",
         lambda: dfa_scan.window_flags_cuda(*fargs))
    del fargs, edge
    if ends_cuda:
        eargs = dfa_scan.window_args(fwd_mt, data, st, None, 64)
        line(f"window ends {m} starts W=64",
             lambda: ends_cuda(*eargs, alive_u8=True))
        del eargs
    line(f"window_ends round, {m} starts, glue included",
         lambda: dfa_scan.window_ends(fwd_mt, data, st, 64), reps=5)
    del st
    import chip_smoke
    rmt = ct.compile(chip_smoke.PATTERNS["inner_keyword"],
                     device="cuda").batch_engine()._chunk_scanner(
                         "rev_anch").mt
    g = torch.Generator(device=dev).manual_seed(11)
    B, W = 1 << 16, 256
    rs = torch.randint(0, n + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    redge = torch.full((B,), n, dtype=torch.int32, device=dev)
    redge[B // 2:] = (rs[B // 2:].long() + torch.randint(
        0, 2 * W, (B - B // 2,), generator=g, device=dev)).clamp(
            max=n).to(torch.int32)
    ra = dfa_scan.window_args(rmt, data, rs, redge, W, True)
    line("window flags 2^16 reverse W=256",
         lambda: dfa_scan.window_flags_cuda(*ra))
    if ends_cuda:
        line("window ends 2^16 reverse W=256", lambda: ends_cuda(*ra))
    one = torch.full((16,), n, dtype=torch.int32, device=dev)
    one[0] = n - 12345
    oedge = torch.full((16,), n, dtype=torch.int32, device=dev)
    if ends_cuda:
        oa = dfa_scan.window_args(rmt, data, one, None, 64, True)
        line("window ends one live lane of 16 W=64",
             lambda: ends_cuda(*oa))
    else:
        oa = dfa_scan.window_args(rmt, data, one, oedge, 64, True)
        line("window flags one live lane of 16 W=64",
             lambda: dfa_scan.window_flags_cuda(*oa))


if __name__ == "__main__":
    main()
