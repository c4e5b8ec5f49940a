#!/usr/bin/env python3
"""Where the time of coregex_tpu_torch's device find_all goes, on one GPU.

    python3 tools/profile_torch.py [--single | --count] [name ...]
    python3 tools/profile_torch.py --limit [name ... | aa]

Builds the JAX package's bench corpus as chip_smoke.py does (the 6 MiB
base tile, seed 7, tiled to 1536 MiB, or to the largest whole-tile corpus
the span limits admit for the general nullable patterns), makes one warm
find_all_spans_device call per pattern, then profiles one more with
torch.profiler.  With --single it does the same for is_match and
find_index on chip_smoke's late-match corpus (spaces, a newline, one base
tile), names from chip_smoke.SINGLE_EXTRA too; with --count, for one warm
count on the corpus find_all would take.  Prints the wall time, the
device's busy time (the sum of
the kernels' times; one stream, so they do not overlap), its idle share,
the call's peak device memory above what was allocated before it,
the port's own kernels, and the eight operators whose kernels took the
most device time.  Names
come from chip_smoke.PATTERNS (the bench, class-run, nullable, literal,
general find_all and BITSET_NFA patterns; the general slice's sizes as
chip_smoke's GENERAL gives them); default: the class-run and nullable
patterns.  With
--limit it profiles each find_all route at its largest size instead: one
pattern of each route (chip_smoke.LIMITS, or the names given) on
chip_smoke.LIMITS_TILES base tiles (2,145,381,040 bytes), the corpus cache
cleared before each, then the literal route's leftmost-first selection
in pieces: `aa` on MAX_CORPUS bytes of `a`, whose 2^31 - 34 hits all
overlap.  Needs a CUDA card; imports no jax.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(names, single=False, count=False):
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.meta.batch import BatchEngine
    from coregex_tpu_torch.utils import corpus_cache

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = chip_smoke.phase_device()
    base = chip_smoke.build_base()
    corpus = chip_smoke.bench_corpus(base)
    B = len(base)
    sizes = {nm: size for nm, _, size in (chip_smoke.CLASS_NULLABLE
                                          + chip_smoke.LITERAL_NULLABLE
                                          + chip_smoke.GENERAL)}
    if single:
        late = chip_smoke.single_corpora(base, corpus)[1][1]
    whats = (("is_match", "find_index") if single
             else ("count",) if count else ("find_all",))
    for name, what in [(nm, w) for nm in names for w in whats]:
        pattern = chip_smoke.PATTERNS[name]
        reps = len(corpus) // B
        if sizes.get(name) == "limit":
            reps = min(reps, BatchEngine.DEVICE_SPANS_LIMIT // B)
        elif sizes.get(name) == "slice":
            reps = min(reps, (chip_smoke.SLICE_MIB << 20) // B)
        arr = late if single else corpus[:reps * B]
        corpus_cache.clear()
        eng = ct.compile(pattern, device="cuda")
        be = eng.batch_engine()

        def call():
            if what != "find_all":
                return getattr(eng, what)(arr)
            spans, cnt = be.find_all_spans_device(arr)
            int(spans[:16].sum())
            return f"{cnt} spans"

        profile_call(f"{name} ({pattern}) {what} on {len(arr)} bytes",
                     call, card)


def profile_call(label, call, card):
    """One warm-up call, then one profiled call: prints the wall, busy and
    idle share, the peak device memory above what the warm-up left
    allocated, the port's kernels and the eight costliest operators."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()                                 # tables, upload, warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    top = torch.cuda.max_memory_allocated() / 2 ** 30
    peak = top - held / 2 ** 30
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, k = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.device_time_total / 1e3, k + 1)
    busy = sum(ms for ms, _ in kernels.values())
    print(f"[profile] {label}, {out}, {card}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"peak {peak:.2f} GiB above the {held / 2 ** 30:.2f} GiB "
          f"held before the call ({top:.2f} GiB in all)")
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


def limit(names):
    """Each LIMITS route at LIMITS_TILES tiles, then the selection past the
    span limit: MAX_CORPUS bytes of `a`, whose hits of `aa` all overlap;
    Go keeps every other one."""
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.meta.batch import MAX_CORPUS
    from coregex_tpu_torch.utils import corpus_cache

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = chip_smoke.phase_device()
    base = chip_smoke.build_base()
    big = np.tile(np.frombuffer(base, dtype=np.uint8),
                  chip_smoke.LIMITS_TILES)
    for name, pattern in chip_smoke.LIMITS:
        if names and name not in names:
            continue
        corpus_cache.clear()
        torch.cuda.empty_cache()
        be = ct.compile(pattern, device="cuda").batch_engine()

        def call():
            spans, cnt = be.find_all_spans_device(big)
            int(spans[:16].sum())
            return (f"{cnt} spans, route {be._spans_route(big)[0]}, pieces "
                    f"{be.pieces[0]} output / {be.pieces[1]} corpus")

        profile_call(f"limit {name} ({pattern}) find_all on {len(big)} "
                     f"bytes", call, card)
        del be
    del big
    corpus_cache.clear()
    torch.cuda.empty_cache()
    if names and "aa" not in names:
        return
    n = MAX_CORPUS
    arr = np.full(n, ord("a"), dtype=np.uint8)
    be = ct.compile("aa", device="cuda").batch_engine()

    def call():
        spans, cnt = be.find_all_spans_device(arr)
        if cnt != n // 2 or spans[cnt - 1].tolist() != [n - 3, n - 1]:
            chip_smoke.fail(f"aa on {n} bytes of a: {cnt} spans")
        return f"{cnt} spans, pieces {be.pieces[0]} output"

    profile_call(f"limit (aa) find_all on {n} bytes of a", call, card)


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--limit" in args:
        limit([a for a in args if a != "--limit"])
        sys.exit(0)
    single, count = "--single" in args, "--count" in args
    names = [a for a in args if a not in ("--single", "--count")]
    main(names or [nm for nm, _, _ in chip_smoke.CLASS_NULLABLE], single,
         count)
