#!/usr/bin/env python3
r"""Warm find_all walls of one checkout's device routes on the 1536 MiB bench
corpus, and each pieced form at one piece beside the form its route takes
below the span limit, so that two checkouts can be timed on one GPU in one
run.

    python3 tools/time_pieces_torch.py [--root CHECKOUT] [--reps R]
                                       [--what walls,pieces]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the corpus is built by this checkout's chip_smoke.py
(``bench_corpus``), the same in both.  ``--what`` picks groups (comma
list, default both):
  walls   for each ROUTES pattern, ``find_all_spans_device(defer_ok=True)``
          and its count read back: the first call (tables, upload), then
          the best of R (default 5) warm calls, host clock after a
          synchronize; the route and, where the checkout keeps them, the
          output and corpus pieces;
  pieces  where the checkout has the pieced forms (``line_spans_pieces``),
          for the routes that keep two forms (literals and sets, the
          bidirectional path): the route's own call as in ``walls`` and
          the route's pieced form at one piece (limit 2^30: the same
          producer, then ``_literal_pieces`` or ``_bidi_pieces``),
          alternated R times on the same corpus, each the best of R, with
          their spans checked equal.
Prints the card's name and power limit first.  Imports no jax.
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one pattern or more per find_all route of the bench corpus
ROUTES = [("charclass_w", r"[\w]+"), ("lower2_5", r"[a-z]{2,5}"),
          ("word_repeat", r"(\w{2,8})+"), ("inner_error", r".*error.*"),
          ("suffix_txt", r".*\.txt"), ("multiline_php", r"(?m)^/.*\.php"),
          ("ip", r"\d+\.\d+\.\d+\.\d+"),
          ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
          ("version", r"\d+.\d+.\d+"), ("word_digits", r"\b\d+\b"),
          ("nfa_u_z", r"[a-q][^u-z]{13}x"), ("literal_error", r"error"),
          ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH"),
          ("overlap_0.0", r"0\.0"), ("word_star", r"\w*"),
          ("error_opt", r"(error)?"), ("empty_lazy", r"x*?")]
TWO_FORMS = ("literal", "bidi")
BIG = 1 << 30


def one_piece(be, arr):
    """A function that runs the route's pieced form at one piece on arr and
    returns (spans, count), or None where the route keeps one form."""
    import torch
    from coregex_tpu_torch.ops import span_chain as sc
    from coregex_tpu_torch.ops.bytescan import literal_self_overlaps
    from coregex_tpu_torch.ops.compact2 import _bucket_up
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    from coregex_tpu_torch.ops.flag_scan import reset_geometry
    from coregex_tpu_torch.utils.corpus_cache import (_fingerprint,
                                                      device_corpus)
    kind, args = be._spans_route(arr)
    if kind not in TWO_FORMS:
        return None
    n = len(arr)
    dev = device_corpus(arr, be.device)

    if kind == "literal":
        lits = args

        def run():
            if len(lits) == 1:
                ws, cnt_d = sc.literal_words(dev, lits[0])
                we, cnt = None, int(cnt_d)
                select = literal_self_overlaps(lits[0])
            else:
                ws, we, cnt_d, ce_d = sc.multi_literal_words_big(dev, lits) \
                    if n > sc.MULTI_FUSED_LIMIT \
                    else sc.multi_literal_words(dev, lits)
                cnt, ce = torch.stack([cnt_d, ce_d]).tolist()
                select = cnt != ce
            return be._literal_pieces(lits, dev, ws, we, cnt, select)[:2]
    else:
        ssc, rsc = args

        def run():
            geom = plan_geometry(n)
            fw, gw, total_d, kind_d, _c = ssc.scan(
                dev, geom, be._word_tiles(arr, *geom[:2]))
            total, k = int(total_d), int(kind_d)
            nwb = _bucket_up(max(-(-n // 32), 1))
            nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
            Lr, Tr, _W, _Lc = reset_geometry(n)
            return be._bidi_pieces(rsc, arr, _fingerprint(arr), fw, gw,
                                   total, k, BIG, nwb, nwb1, Lr, Tr)[:2]
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--what", default="walls,pieces")
    args = ap.parse_args()
    what = set(args.what.split(","))
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import span_chain
    from coregex_tpu_torch.utils import corpus_cache

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}", flush=True)
    arr = chip_smoke.bench_corpus(chip_smoke.build_base())
    n = len(arr)
    has_pieces = hasattr(span_chain, "line_spans_pieces")

    def find_all(be):
        spans, cnt, _ok = be.find_all_spans_device(arr, defer_ok=True)
        return spans, int(cnt)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, r

    for name, pattern in ROUTES:
        corpus_cache.release_flipped()
        be = ct.compile(pattern, device="cuda").batch_engine()
        route = be._spans_route(arr)
        if route is None:
            print(f"[pieces] {name:14} declined", flush=True)
            continue
        first, (spans, cnt) = timed(lambda: find_all(be))
        if "walls" in what:
            best = min(timed(lambda: find_all(be))[0]
                       for _ in range(args.reps))
            pieces = getattr(be, "pieces", None)
            print(f"[pieces] {name:14} route {route[0]:11} wall "
                  f"{best * 1e3:9.3f} ms  first {first:6.2f} s  {cnt:>10} "
                  f"spans  {n / best / 1e9:7.2f} GB/s  pieces {pieces}  "
                  f"({card})", flush=True)
        run = one_piece(be, arr) if has_pieces and "pieces" in what \
            else None
        if run is None:
            continue
        sp1, c1 = run()
        c1 = int(c1)
        if c1 != cnt or not torch.equal(sp1[:c1], spans[:cnt]):
            raise SystemExit(f"{name}: the pieced form's {c1} spans differ "
                             f"from find_all's {cnt}")
        del sp1, spans
        t_route, t_piece = [], []
        for _ in range(args.reps):
            t_route.append(timed(lambda: find_all(be))[0])
            t_piece.append(timed(lambda: run()[1])[0])
        a, b = min(t_route), min(t_piece)
        print(f"[pieces] {name:14} route {route[0]:11} route's form "
              f"{a * 1e3:9.3f} ms  one piece {b * 1e3:9.3f} ms  ratio "
              f"{b / a:6.3f}  ({card})", flush=True)
        del be


if __name__ == "__main__":
    main()
