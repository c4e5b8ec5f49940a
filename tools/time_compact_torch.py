#!/usr/bin/env python3
r"""Device times of one checkout's ordered compaction (K4 ``compact_pay``,
K8 ``compact_positions``) at chip_smoke.py's headline shapes, so that two
checkouts can be timed on one GPU in one run.

    python3 tools/time_compact_torch.py [--root CHECKOUT]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the inputs are built by this checkout's
chip_smoke.py, the same in both: K4 on 2^26 entries at density 0.01 with 3
payloads (``chain_level``), K4 on charclass_w's unpacked run-start mask of
the 1536 MiB bench corpus (``class_run_starts``), K8 on the start mask of
`\w*` over that corpus at the main path's cap and at 2^30
(``word_starts``).  Each line gives the mean of REPS launches of the
public entry point after a warm-up, with CUDA events; chip_smoke.py times
the same shapes beside their bound and ``torch.nonzero``.  Imports no
jax.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import compact, compact2

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}")
    dev = torch.device("cuda")

    def line(label, fn):
        ms = chip_smoke.cuda_ms(fn, REPS)
        print(f"[time] {label:40} {ms:9.3f} ms  ({card})", flush=True)

    torch.manual_seed(21)
    mask, pays, cap = chip_smoke.chain_level(dev, 0.01)
    line("K4 n=2^26 d=0.01 p=3",
         lambda: compact2.compact_pay(mask, pays[:3], cap))
    del mask, pays

    corpus = chip_smoke.bench_corpus(chip_smoke.build_base())
    mib = chip_smoke.CORPUS_MIB
    runs, cap = chip_smoke.class_run_starts(corpus, dev)
    line(f"K4 charclass_w run starts {mib} MiB",
         lambda: compact2.compact_pay(runs, (), cap))
    del runs
    smask, cap = chip_smoke.word_starts(corpus, dev)
    for c in (cap, 1 << 30):
        line(f"K8 \\w* starts {mib} MiB cap=2^{c.bit_length() - 1}",
             lambda: compact.compact_positions(smask, c))


if __name__ == "__main__":
    main()
