#!/usr/bin/env python3
"""Profiling tool for K10, coregex_tpu_torch's single-pass compaction
(``coregex_tpu_torch/ops/compact_exp.py``), with the command line of
``tools/profile_compact.py``.

    python3 tools/profile_compact_torch.py VARIANT [MB] [density]

VARIANT is one of the 15 in VARIANTS (the rig's ablations and shapes),
``check`` (the kernel against np.flatnonzero on the rig's random small
cases: R of 128 and 256, 1-3 blocks, densities 0-0.5, one payload, plain
and with cond_dma + skip_empty) or ``prod`` (the port's production
compactions on the same mask: K4's compact_pay, and pack_words followed by
the sparse chain, sparse_positions_words).  The mask holds MB MiB (default
256) at the given hit density (default 1/200, literal_error-like), drawn
with numpy from seed 11 as in the JAX rig.  Each variant prints its mean
device time over 3 runs after a warm-up (CUDA events), the mask bytes per
second, and, for the variants whose results are valid, ``ok`` or
``MISMATCH`` against torch.nonzero of the mask (the first 100,000
positions, the count, and payloads, which are the positions).  Needs a
CUDA card; imports no jax.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = {
    "baseline": dict(),
    "noroute": dict(do_route=False),
    "nodma": dict(do_dma=False),
    "noroute_nodma": dict(do_route=False, do_dma=False),
    "skipempty": dict(skip_empty=True),
    "conddma": dict(cond_dma=True),
    "condskip": dict(cond_dma=True, skip_empty=True),
    "r256": dict(R=256),
    "r512": dict(R=512),
    "r256cond": dict(R=256, cond_dma=True, skip_empty=True),
    "r512cond": dict(R=512, cond_dma=True, skip_empty=True),
    "pay1": dict(npay=1),
    "pay2": dict(npay=2),
    "pay1cond": dict(npay=1, cond_dma=True, skip_empty=True),
    "pay2cond": dict(npay=2, cond_dma=True, skip_empty=True),
}
CHECKED = 100000


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
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


def rig_mask(mb: int, dens: float, device="cuda"):
    """(mask, hit count, cap): MB MiB of bool at `dens`, seed 11, and the
    rig's cap (the count rounded up to 16, at least 16)."""
    import torch
    n = mb * 1024 * 1024
    mask = np.random.default_rng(11).random(n) < dens
    nhits = int(mask.sum())
    return (torch.from_numpy(mask).to(device), nhits,
            -(-max(nhits, 16) // 16) * 16)


def _valid(pos, cnt, pays, expect, nhits) -> bool:
    k = min(CHECKED, nhits)
    ok = int(cnt) == nhits and bool((pos[:k] == expect[:k]).all())
    return ok and all(bool((p[:k] == expect[:k]).all()) for p in pays)


def run_variant(variant: str, mask, nhits: int, cap: int, expect=None):
    """(ms, ok): ok is None for the ablations, whose results are
    invalid.  `expect` is torch.nonzero of the mask (computed if None)."""
    import torch
    from coregex_tpu_torch.ops.compact_exp import compact_exp
    kw = dict(VARIANTS[variant])
    n = int(mask.shape[0])
    pays = [torch.arange(n, dtype=torch.int32, device=mask.device)] \
        * kw.get("npay", 0)
    ms = cuda_ms(lambda: compact_exp(mask, *pays, cap=cap, **kw))
    if not (kw.get("do_route", True) and kw.get("do_dma", True)):
        return ms, None
    if expect is None:
        expect = torch.nonzero(mask).flatten().to(torch.int32)
    out = compact_exp(mask, *pays, cap=cap, **kw)
    return ms, _valid(out[0], out[-1], out[1:-1], expect, nhits)


def prod(mask, nhits: int, cap: int, expect=None):
    """[(name, ms, ok)] for the port's production compactions: K4 over the
    mask ("dense") and pack_words + the sparse chain ("sparse")."""
    import torch
    from coregex_tpu_torch.ops.compact2 import (compact_pay, pack_words,
                                                sparse_positions_words)
    n = int(mask.shape[0])
    if expect is None:
        expect = torch.nonzero(mask).flatten().to(torch.int32)
    res = []
    for name, fn in (
            ("sparse", lambda: sparse_positions_words(
                pack_words(mask, n // 32), n, cap)),
            ("dense", lambda: compact_pay(mask, (), cap))):
        ms = cuda_ms(fn)
        pos, cnt, ok = fn()
        res.append((name, ms, bool(ok) and _valid(pos, cnt, [], expect,
                                                   nhits)))
    return res


def check(device="cuda"):
    """The rig's check: 8 random cases (seed 5), each plain and with
    cond_dma + skip_empty, against np.flatnonzero.  Returns the lines."""
    import torch
    from coregex_tpu_torch.ops.compact_exp import compact_exp
    rng = np.random.default_rng(5)
    lines = []
    for trial in range(8):
        R = [128, 256][trial % 2]
        n = int(rng.integers(1, 4)) * R * 128
        dens = [0.001, 0.05, 0.5, 0.0][trial % 4]
        mask = (rng.random(n) < dens).astype(np.int8)
        pay = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int32)
        nh = int(mask.sum())
        cap = max(16, -(-nh // 16) * 16 + 16)
        exp = np.flatnonzero(mask)
        for kw in (dict(), dict(cond_dma=True, skip_empty=True)):
            pos, pv, cnt = (o.cpu().numpy() for o in compact_exp(
                torch.from_numpy(mask).to(device),
                torch.from_numpy(pay).to(device), cap=cap, R=R, npay=1,
                **kw))
            if not (int(cnt) == nh and (pos[:nh] == exp).all()
                    and (pv[:nh] == pay[exp]).all()
                    and (pos[nh:] >= n).all()):
                raise AssertionError(f"check: trial {trial} {kw} differs")
        lines.append(f"trial {trial} R={R} n={n} hits={nh}: ok")
    return lines


def main():
    import torch
    variant = sys.argv[1] if len(sys.argv) > 1 else "baseline"
    mb = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    dens = float(sys.argv[3]) if len(sys.argv) > 3 else 1.0 / 200
    if variant not in VARIANTS and variant not in ("check", "prod"):
        sys.exit(f"unknown variant {variant}; one of {sorted(VARIANTS)}, "
                 f"check, prod")
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: K10 runs on a card")
    if variant == "check":
        for line in check():
            print(line)
        print("check: all ok")
        return
    mask, nhits, cap = rig_mask(mb, dens)
    n = int(mask.shape[0])
    print(f"{variant}: n={n} hits={nhits} cap={cap} "
          f"kw={VARIANTS.get(variant, {})}", file=sys.stderr)
    if variant == "prod":
        for name, ms, ok in prod(mask, nhits, cap):
            print(f"{name}: {ms:.3f} ms ({n / 1e9 / (ms / 1e3):.2f} GB/s) "
                  f"{'ok' if ok else 'MISMATCH'}")
        return
    ms, ok = run_variant(variant, mask, nhits, cap)
    print(f"{variant}: {ms:.3f} ms ({n / 1e9 / (ms / 1e3):.2f} GB/s)"
          + ("" if ok is None else " ok" if ok else " MISMATCH"))


if __name__ == "__main__":
    main()
