#!/usr/bin/env python3
"""Per-stage times of coregex_tpu_torch's bidirectional span path.

    python3 tools/profile_bidi_torch.py [--mib N] [--device cuda] [name ...]

The counterpart of the JAX package's tools/profile_bidi.py, written
against the port's own stages with their real arguments (the reference's
tool calls its bidi_ends with arguments it no longer takes: ROADMAP F4).
For each pattern (chip_smoke.PATTERNS names; default ip, email, url and
version) on N MiB (default 256) of the bench corpus (chip_smoke.build_base,
seed 7, tiled), warm, best of 3, each stage fenced by a device sync:

  scan      the forward span-event scan (K2, SpanScanner.scan)
  ends      span_chain.bidi_ends: the group chain, the ends and the reset
            words
  reverse   the reset tiles and the reverse flag scan (K3)
  assemble  span_chain.bidi_assemble: the reset chain and the checks

then the whole BatchEngine.find_all_spans_device, whose spans the stages'
must equal.  Prints a table of ms and each stage's share.  --device cpu
runs the plain versions (the tests do, on a few KiB).  Imports no jax.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STAGES = ("scan", "ends", "reverse", "assemble")


def stages(be, data):
    """The four stages of BatchEngine._bidi_spans_dev on a corpus within
    the span limit, as closures over the previous stage's outputs."""
    from coregex_tpu_torch.meta.batch import BatchEngine
    from coregex_tpu_torch.ops.bytescan import _bucket
    from coregex_tpu_torch.ops.compact2 import _bucket_up
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    from coregex_tpu_torch.ops.flag_scan import (reset_geometry,
                                                 scatter_reset_tiles)
    from coregex_tpu_torch.ops.span_chain import bidi_assemble, bidi_ends
    from coregex_tpu_torch.utils.corpus_cache import (corpus_is_ascii,
                                                      device_corpus)

    route = be._bidi_route(corpus_is_ascii(data, be.device))
    if route is None:
        raise SystemExit("the pattern does not take the bidirectional path")
    ssc, rsc = route
    n = len(data)
    geom = plan_geometry(n)
    dev = device_corpus(data, be.device)
    tiles = be._word_tiles(data, *geom[:2])
    nwb = _bucket_up(max(-(-n // 32), 1))
    nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
    Lr, Tr, _W, _Lc = reset_geometry(n)
    sym = be._sym_tiles(rsc, data, Lr, Tr)
    st = {}

    def scan():
        fw, gw, total_d, kind_d, _conv = ssc.scan(dev, geom, tiles)
        total = int(total_d)
        if total + 1 > min(BatchEngine.MAX_DEVICE_SPANS,
                           BatchEngine.CHAIN_PIECE):
            raise SystemExit("the result passes one piece: profile a "
                             "smaller corpus")
        st.update(fw=fw, gw=gw, total_d=total_d, kind_d=kind_d,
                  capM=_bucket(total + 1, 16))
        return total_d

    def ends():
        out = bidi_ends(st["fw"], st["gw"], n, st["total_d"], st["kind_d"],
                        st["capM"], nwb, nwb1)
        st.update(ends=out[0], cntF=out[1], rq=out[2], rw=out[3], okA=out[4])
        return out[1]

    def reverse():
        tiles_r = scatter_reset_tiles(sym, st["rq"], Lr, Tr // 4)
        fw_rev = rsc.scan_tiles(tiles_r, n)[0]
        st.update(fw_rev=fw_rev)
        return fw_rev

    def assemble():
        spans, cnt, ok = bidi_assemble(st["ends"], st["cntF"], st["rw"],
                                       st["fw_rev"], n, st["capM"], nwb1)
        st.update(spans=spans, cnt=cnt, ok=ok & st["okA"])
        return cnt

    return dict(zip(STAGES, (scan, ends, reverse, assemble))), st


def timed(fn, sync, reps: int = 3) -> float:
    """Best wall of fn() over reps calls after one warm-up, each fenced by
    sync()."""
    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    import torch

    import chip_smoke
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.utils import corpus_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=float, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("names", nargs="*",
                    default=["ip", "email", "url", "version"])
    a = ap.parse_args(argv)
    cuda = a.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    size = int(a.mib * 2 ** 20)
    base = chip_smoke.build_base(size=min(size, 6 * 2 ** 20))
    data = np.frombuffer(base * max(1, size // len(base)), dtype=np.uint8)
    n = len(data)
    corpus_cache.clear()
    print(f"[bidi] {n} bytes on {a.device}")
    print("[bidi] pattern | spans | " + " | ".join(f"{s} ms" for s in STAGES)
          + " | sum ms | find_all ms | shares")
    rows = []
    for name in a.names:
        be = ct.compile(chip_smoke.PATTERNS[name],
                        device=a.device).batch_engine()
        fns, st = stages(be, data)
        ms = [timed(fns[s], sync) * 1e3 for s in STAGES]
        spans, cnt = be.find_all_spans_device(data)
        if not bool(st["ok"]) or int(st["cnt"]) != cnt or not torch.equal(
                st["spans"][:cnt], spans[:cnt]):
            raise SystemExit(f"{name}: the stages' spans differ from "
                             f"find_all_spans_device's")
        whole = timed(lambda: be.find_all_spans_device(data), sync) * 1e3
        tot = sum(ms)
        print(f"[bidi] {name} | {cnt} | "
              + " | ".join(f"{m:.3f}" for m in ms)
              + f" | {tot:.3f} | {whole:.3f} | "
              + " ".join(f"{m / tot:.2f}" for m in ms), flush=True)
        rows.append((name, cnt, ms, whole))
    return rows


if __name__ == "__main__":
    main()
