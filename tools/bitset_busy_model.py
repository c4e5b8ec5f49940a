#!/usr/bin/env python3
r"""How often the bitset-NFA scan's walkers are busy on the bench corpus,
for one walker and for a warp of 32: a model on the CPU, from the port's
own tables (no kernel, no card).

    python3 tools/bitset_busy_model.py [--bytes N] [--warps W] [I[,rev] ...]

Each argument picks chip_smoke.BITSET[I], forward or with ",rev" the
reverse scan over the flipped corpus (default: 0,rev and 0).  The bench
corpus (chip_smoke.build_base tiled four times) feeds W warps (default 4)
of 32 walkers, each on its own lane T = 196,608 bytes after the previous
one, as the main path's lanes are, for N bytes each (default 3072, a
sub-lane at 1536 MiB), stepping the float32 step of the plain version
from the seed.  A walker is busy at a byte when its set before the byte
is not its seed or the byte enters a state from the seed; the model
prints the share of busy bytes a walker, the share of a warp's bytes on
which any of its walkers is busy, and how many of the 32 are busy then.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from coregex_tpu_torch.nfa.thompson import compile_nfa  # noqa: E402
from coregex_tpu_torch.ops import nfa_scan as ns  # noqa: E402
from coregex_tpu_torch.syntax.parser import parse  # noqa: E402

LANE = 196_608


def model(pattern: str, reverse: bool, steps: int, warps: int):
    d = ns.DeviceBitsetNFA(compile_nfa(parse(pattern), reverse=reverse,
                                       with_captures=False), "cpu")
    corpus = np.tile(np.frombuffer(chip_smoke.build_base(), np.uint8), 4)
    x = corpus[::-1] if reverse else corpus
    cls = np.array([ns._cls3(b) for b in range(256)])
    b = np.arange(256)[:, None]
    takes = (d.lo[None, :] <= b) & (b <= d.hi[None, :])
    ct = d.ct > 0
    start = d.start > 0
    n = 32 * warps
    pos = np.arange(n) * LANE + 5000
    a = start[d.smap[0]][None].repeat(n, 0)
    idle = np.zeros(n, dtype=bool)
    busy = np.zeros((n, steps), dtype=bool)
    for q in range(steps):
        c = x[pos + q]
        ctx = cls[c] * 4 + cls[x[pos + q + 1]]
        m = a & takes[c]
        took = m.any(axis=1)
        busy[:, q] = ~idle | took
        nxt = np.zeros_like(a)
        g = d.cmap[ctx]
        for gg in range(d.G):
            sel = g == gg
            if sel.any():
                nxt[sel] = (m[sel].astype(np.float32)
                            @ ct[gg, :, :d.S].astype(np.float32)) > 0
        a = nxt | start[d.smap[ctx]]
        idle = ~took
    warp = busy.reshape(warps, 32, steps)
    any_busy = warp.any(axis=1)
    return (d, float(busy.mean()), float(any_busy.mean()),
            float(warp.sum(axis=1)[any_busy].mean()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bytes", type=int, default=3072)
    ap.add_argument("--warps", type=int, default=4)
    ap.add_argument("scans", nargs="*", default=["0,rev", "0"])
    a = ap.parse_args()
    for scan in a.scans:
        i, _, kind = scan.partition(",")
        name, pattern = chip_smoke.BITSET[int(i)]
        d, walker, warp, lanes = model(pattern, kind == "rev", a.bytes,
                                       a.warps)
        print(f"{name} {'rev' if kind == 'rev' else 'fwd'} (S={d.S} "
              f"NW={d.NW} G={d.G} Gs={d.Gs}): busy bytes a walker "
              f"{walker:.3f}, a warp's bytes with a busy walker {warp:.3f}, "
              f"busy walkers then {lanes:.1f} of 32", flush=True)


if __name__ == "__main__":
    main()
