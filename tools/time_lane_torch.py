#!/usr/bin/env python3
r"""Device times of one checkout's lane walks and the walls they carry, at
chip_smoke.py's headline shapes, so that two checkouts can be timed on one
GPU in one run.

    python3 tools/time_lane_torch.py [--root CHECKOUT]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the inputs are built by this checkout's
chip_smoke.py, the same in both.  On the 1536 MiB bench corpus (ip): K1
and K2 pass 0 as that checkout's count and span scans launch it (at its
split, where it has one) and, where it has a split, also at k = 16, 32, 64
and 128 sub-lanes a lane; K3 on the bidi path's reset tiles and K9 over
`\s\d\s`'s fwd_all DFA, through their callers' wrappers; then the warm
walls (best of 3, host clock, after a first call) of ip's count and
find_all, best of 10 of find_index on early matches (K9 on a 4 MiB
prefix, then the window kernel) and of a FULL_SCAN is_match (one K9 pass,
no match), and quote parity (`"[^"]*"` on 16 MiB, chip_smoke.quote_parity)
with its repair passes.  Kernel lines give the mean of REPS launches after
a warm-up, with CUDA events; chip_smoke.py times the same shapes beside
their bound.  Imports no jax.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan, flag_scan

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}")
    dev = torch.device("cuda")
    split = getattr(cs, "lane_split", None)

    def line(label, ms, extra=""):
        print(f"[time] {label:44} {ms:9.3f} ms{extra}  ({card})", flush=True)

    base = chip_smoke.build_base()
    corpus = chip_smoke.bench_corpus(base)
    mib = chip_smoke.CORPUS_MIB
    data = torch.from_numpy(corpus).to(dev)
    L, T, W, _ = cs.plan_geometry(int(data.shape[0]))
    tiles = cs.make_word_tiles(data, L, T // 4)
    ip = ct.compile(chip_smoke.PATTERNS["ip"], device="cuda")
    be = ip.batch_engine()
    walks = ((cs.MODE_COUNT, be._count_scanner_ascii().dcd),
             (cs.MODE_SPAN, be._span_scanner(True).dsd))

    for mode, d in walks:
        k = None if split is None else split(T, W)
        for kk in [k] if k is None else sorted({k, 16, 32, 64, 128}):
            a = chip_smoke.split_args(d, data, (L, T, W), tiles, kk)
            ms = chip_smoke.cuda_ms(lambda: cs.lane_walk_cuda(mode, *a),
                                    REPS)
            line(f"K{mode + 1} ip {mib} MiB"
                 + ("" if kk is None else f" k={kk}"), ms,
                 "  (lane_split's k)" if kk == k and k else "")

    # K3 on the bidi path's reset tiles, K9 over a FULL_SCAN fwd_all DFA,
    # through the wrappers their scans call (entries [L] in every checkout)
    packed, _seg, symt, w4, entries, offs, flim = chip_smoke.flag_args(
        be, data)
    line(f"K3 ip {mib} MiB", chip_smoke.cuda_ms(
        lambda: flag_scan.flag_lanes(packed, symt, w4, entries.reshape(-1),
                                     offs, flim), REPS))
    del symt
    margs = chip_smoke.match_args("ws_digit_ws", "fwd_all", data, (L, T, W),
                                  tiles)
    line(f"K9 \\s\\d\\s fwd_all {mib} MiB", chip_smoke.cuda_ms(
        lambda: dfa_scan.match_lanes(*margs), REPS))
    del data, tiles, margs
    torch.cuda.empty_cache()

    def wall(fn, reps=3):
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    line(f"ip count {mib} MiB (wall)", wall(lambda: ip.count(corpus)))
    line(f"ip find_all {mib} MiB (wall)", wall(
        lambda: int(be.find_all_spans_device(corpus, defer_ok=True)[1])))
    # K9 on the single-match paths, early match (a 4 MiB prefix) and none
    for name in ("ws_digits_ws", "a_word_end", "multiline_php"):
        eng = ct.compile(chip_smoke.PATTERNS[name], device="cuda")
        line(f"{name} find_index early {mib} MiB (wall)",
             wall(lambda: eng.find_index(corpus), 10))
    eng = ct.compile(chip_smoke.PATTERNS["ws_digit_ws"], device="cuda")
    line(f"ws_digit_ws is_match {mib} MiB (wall)",
         wall(lambda: eng.is_match(corpus), 10))
    eng = ct.compile(chip_smoke.QUOTES, device="cuda")
    got, want, ms, subs, lanes, launches = chip_smoke.quote_parity(eng)
    if got != want:
        sys.exit(f"quote parity: count {got} != {want}")
    line("quote parity 16 MiB count (wall)", ms,
         f"  repair passes {subs}+{lanes}, {launches} K1 launches")


if __name__ == "__main__":
    main()
