#!/usr/bin/env python3
"""Phase shares of coregex_tpu_torch's sharded count, and the two-host
efficiency they predict.

    python3 tools/scaling_report_torch.py [--shards D] [--mib N]
                                          [--reps R] [--device cuda|cpu]

The counterpart of the JAX package's tools/scaling_report.py.  The sharded
count (parallel/sharded_count.py) is phase 1 (each shard's all-entries
walk to its transfer map and emissions), one collective (the maps gathered
on the first device) and phase 2 (the fold and the sum);
ShardedPhaseProbe times the three apart, each the best of R runs
(default 3).  For the reference's four
patterns, on its token corpus (32 MiB / 8 tokens drawn with seed 3,
tiled to N MiB; N defaults to its 32), on a virtual mesh of D shards
(default 8) on the card (cuda:0), or on the CPU with --device cpu; with
no card and no --device cpu it stops.  Prints per pattern and mesh the
count transducer's states, the three phases' ms, the scan's
share and the two-host efficiency t_scan / (t_scan + 10 t_gather +
t_fold), the reference's model (a collective across hosts about ten
times slower than within one).  It writes no file: docs/SCALING.md is the
JAX package's.  Imports no jax.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DCN_PENALTY = 10.0
PATTERNS = [("literal_error", r"error"),
            ("alt_literal", r"error|warning|notice|info|debug"),
            ("ip", r"\d+\.\d+\.\d+\.\d+"),
            ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+")]


def token_corpus(mib: float) -> np.ndarray:
    """The reference's scaling corpus: min(mib, 32) MiB / 8 tokens drawn
    with seed 3, tiled to about mib MiB."""
    rng = np.random.default_rng(3)
    toks = [b"error ", b"warning ", b"lorem ", b"ipsum ", b"a@b.cd ",
            b"10.0.0.1 ", b"x1 ", b"\n"]
    reps = int(min(mib, 32) * 2 ** 20) // 8
    one = b"".join(toks[i] for i in rng.integers(0, len(toks), size=reps))
    return np.frombuffer(one * max(1, round(mib * 2 ** 20 / len(one))),
                         dtype=np.uint8)


def main(argv=None):
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.parallel.shard import Mesh
    from coregex_tpu_torch.parallel.sharded_count import ShardedPhaseProbe

    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--mib", type=float, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if a.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    devices = ["cpu" if a.device == "cpu" else "cuda:0"]
    data = token_corpus(a.mib)
    print(f"[scaling] {len(data)} bytes, virtual meshes of {a.shards} "
          f"shards on {', '.join(devices)}")
    print("[scaling] mesh | pattern | S | scan ms | gather ms | fold ms | "
          "scan share | predicted 2-host eff | count")
    rows = []
    for dev in devices:
        mesh = Mesh([dev] * a.shards)
        for name, pattern in PATTERNS:
            sc = ct.compile(pattern, device=dev).batch_engine() \
                ._count_scanner_for(True)
            if not sc:
                print(f"[scaling] {dev} | {name} | no count transducer")
                continue
            cd = sc.cd
            m = ShardedPhaseProbe(cd, mesh).measure(data, a.reps)
            t1, tg, t2 = m["phase1_scan"], m["collective"], m["phase2_fold"]
            tot = t1 + tg + t2
            eff2 = t1 / (t1 + tg * DCN_PENALTY + t2)
            rows.append((dev, name, cd.num_states, t1, tg, t2, eff2,
                         m["count"]))
            print(f"[scaling] {dev} | {name} | {cd.num_states} | "
                  f"{t1 * 1e3:.3f} | {tg * 1e3:.3f} | {t2 * 1e3:.3f} | "
                  f"{t1 / tot:.3f} | {eff2:.3f} | {m['count']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
