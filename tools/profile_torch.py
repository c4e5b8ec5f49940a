#!/usr/bin/env python3
"""Where the time of coregex_tpu_torch's device find_all goes, on one GPU.

    python3 tools/profile_torch.py [name ...]

Builds the JAX package's bench corpus as chip_smoke.py does (the 6 MiB
base tile, seed 7, tiled to 1536 MiB, or to the largest whole-tile corpus
the span limits admit for the general nullable patterns), makes one warm
find_all_spans_device call per pattern, then profiles one more with
torch.profiler.  Prints the wall time, the device's busy time (the sum of
the kernels' times; one stream, so they do not overlap), its idle share,
the call's peak device memory above what was allocated before it,
the port's own kernels, and the eight operators whose kernels took the
most device time.  Names
come from chip_smoke.CLASS_NULLABLE and chip_smoke.CONFIGS; default: the
class-run and nullable patterns.  Needs a CUDA card; imports no jax.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(names):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.meta.batch import BatchEngine
    from coregex_tpu_torch.utils import corpus_cache

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = chip_smoke.phase_device()
    base = chip_smoke.build_base()
    corpus = chip_smoke.bench_corpus(base)
    B = len(base)
    sizes = {nm: size for nm, _, size in chip_smoke.CLASS_NULLABLE}
    for name in names:
        pattern = chip_smoke.PATTERNS[name]
        reps = len(corpus) // B
        if sizes.get(name) == "limit":
            reps = min(reps, BatchEngine.DEVICE_SPANS_LIMIT // B)
        arr = corpus[:reps * B]
        corpus_cache.clear()
        be = ct.compile(pattern, device="cuda").batch_engine()
        be.find_all_spans_device(arr)          # tables, upload, warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            spans, cnt = be.find_all_spans_device(arr)
            int(spans[:16].sum())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        del spans
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, k = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (ms + e.device_time_total / 1e3, k + 1)
        busy = sum(ms for ms, _ in kernels.values())
        print(f"[profile] {name} ({pattern}) on {len(arr)} bytes, {cnt} "
              f"spans, {card}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
              f"peak {peak:.2f} GiB above the {held / 2 ** 30:.2f} GiB "
              f"held before the call")
        # the port's own kernels (launched through ctypes, so under no
        # operator), then operators by the device time of their kernels
        anon = "(anonymous namespace)::"
        for kname, (ms, k) in sorted(kernels.items(), key=lambda x: -x[1][0]):
            if kname.replace("void ", "").startswith(anon):
                short = kname.split(anon, 1)[1].split("(")[0]
                print(f"[profile]   {ms:9.2f} ms {k:5d} x kernel {short}")
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:5d} x {e.key[:70]}")
        sys.stdout.flush()


if __name__ == "__main__":
    main(sys.argv[1:] or [nm for nm, _, _ in chip_smoke.CLASS_NULLABLE])
