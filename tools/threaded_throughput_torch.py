#!/usr/bin/env python3
"""Aggregate count() throughput of coregex_tpu_torch from several threads,
and what the per-device lock costs them.

    python3 tools/threaded_throughput_torch.py [--mib N] [--threads 1,2,4,8]
                                               [--seconds S] [--repeats K]
                                               [--device cuda]

The counterpart of the JAX package's tools/threaded_throughput.py.  Every
device entry point of the port serializes on its device's lock
(coregex_tpu_torch/utils/device_lock.py), so the question is how much of
a threaded server's host work overlaps the card's.  For each thread count
T, T threads each own one Engine (the reference's eight patterns in turn)
and count one slice of N MiB (default 192) of the bench corpus
(chip_smoke.build_base, seed 7, tiled; slice j rotated by j x 4099 bytes,
so that each is its own corpus on the device).  The corpus cache keeps
_MAX_ENTRIES (4) corpora a device, so T threads share min(T, 4) slices,
thread t slice t mod 4: more slices than that would evict each other and
upload a corpus on most counts, which times the cache and not the lock.
Warm-up (tables built, slices uploaded) is outside the clock.  In a
window every thread counts its slice until S seconds (default 1) have
passed since the window began, so a window lasts S seconds and at most
one count more; each thread count runs K windows (default 3).  Prints a
table: the counts of the median window, its wall, the median aggregate
GB/s (counts x slice bytes over the wall) with the smallest and largest
of the K windows, its ratio to one thread's median, and the time the
threads spent waiting for the device lock (summed over threads, through
a timing wrapper around each engine's lock) with its share of T x wall,
medians of the K windows.  --device cpu runs the plain versions on the
CPU (the tests do, on 64 KiB slices).  Imports no jax.
"""

import argparse
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PATTERNS = [r"\d+\.\d+\.\d+\.\d+", r"error", r"[\w]+", r"\w+://[^\s]+",
            r"GET|POST|PUT|DELETE", r".*\.txt", r"\d+.\d+.\d+",
            r"error|warning|notice"]


class TimedLock:
    """A device lock that adds the time each acquire waited to `wait`; the
    engines of one device share the lock underneath."""

    def __init__(self, lock):
        self.lock = lock
        self.wait = 0.0

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.acquire()
        self.wait += time.perf_counter() - t0
        return self

    def __exit__(self, *exc):
        self.lock.release()


def slices(mib: float, count: int):
    """`count` slices of about `mib` MiB of the bench corpus, whole base
    tiles (a shorter base when a slice is below one tile), slice j rotated
    by j x 4099 bytes so that each is its own corpus on the device."""
    import chip_smoke
    size = int(mib * 2 ** 20)
    base = chip_smoke.build_base(size=min(size, 6 * 2 ** 20))
    reps = max(1, size // len(base))
    one = np.frombuffer(base * reps, dtype=np.uint8)
    return [np.roll(one, 4099 * j) for j in range(count)]


def window(engines, data, want, seconds: float, device: str):
    """One timed window: every engine counts its slice in its own thread
    until `seconds` have passed since the window began.  Returns (wall
    seconds, counts made, lock wait seconds summed over the threads)."""
    import torch
    for e in engines:
        e.batch_engine()._lock.wait = 0.0
    errs = []
    made = [0] * len(engines)

    def worker(i, e, d, c, deadline):
        try:
            while time.perf_counter() < deadline:
                if e.count(d) != c:
                    errs.append("a count changed between calls")
                made[i] += 1
        except Exception as ex:  # reported below
            errs.append(repr(ex))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker,
                                args=(i, e, d, c, t0 + seconds))
               for i, (e, d, c) in enumerate(zip(engines, data, want))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errs:
        raise SystemExit(f"threads={len(engines)}: {errs[0]}")
    return wall, sum(made), sum(e.batch_engine()._lock.wait
                                for e in engines)


def main(argv=None):
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.utils import corpus_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=float, default=192)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    counts = [int(x) for x in a.threads.split(",")]
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    cache = corpus_cache._MAX_ENTRIES
    data = slices(a.mib, min(max(counts), cache))
    n = len(data[0])
    print(f"[threads] {n} bytes a slice on {a.device}, at most {cache} "
          f"slices, windows of {a.seconds} s, {a.repeats} a thread count",
          flush=True)
    rows = []
    for nt in counts:
        engines, mine = [], []
        for t in range(nt):
            e = ct.compile(PATTERNS[t % len(PATTERNS)], device=a.device)
            e.batch_threshold = 0
            be = e.batch_engine()
            be._lock = TimedLock(be._lock)
            mine.append(data[t % cache])
            e.count(mine[-1])                     # tables, upload, warm-up
            engines.append(e)
        want = [e.count(d) for e, d in zip(engines, mine)]
        runs = sorted(window(engines, mine, want, a.seconds, a.device)
                      for _ in range(max(1, a.repeats)))
        aggs = sorted(k * n / w / 1e9 for w, k, _ in runs)
        shares = sorted(wt / (nt * w) for w, _, wt in runs)
        waits = sorted(wt for _, _, wt in runs)
        mid = len(runs) // 2
        wall, made = runs[mid][:2]
        rows.append((nt, wall, aggs[mid], waits[mid], aggs[0], aggs[-1],
                     shares[mid], min(nt, cache), made))
    one = rows[0][2]
    print("[threads] threads | slices | counts | median wall s | aggregate "
          "GB/s (min-max) | x one thread | lock wait s | lock share")
    for nt, wall, agg, wait, lo, hi, share, ns, made in rows:
        print(f"[threads] {nt:7d} | {ns:6d} | {made:6d} | {wall:13.3f} | "
              f"{agg:.3f} ({lo:.3f}-{hi:.3f}) | {agg / one:12.2f} | "
              f"{wait:11.3f} | {share:10.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
