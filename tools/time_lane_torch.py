#!/usr/bin/env python3
r"""Device times of one checkout's lane walks and needle scans and the
walls they carry, at chip_smoke.py's headline shapes, so that two
checkouts can be timed on one GPU in one run.

    python3 tools/time_lane_torch.py [--root CHECKOUT] [--quote N]

``--root`` imports coregex_tpu_torch from another checkout (an unpacked
earlier commit, say); the inputs are built by this checkout's
chip_smoke.py, the same in both.  On the 1536 MiB bench corpus: K1 and K2
pass 0 (ip) as that checkout's count and span scans launch it (at its
split, where it has one) and, where it has a split, also at k = 16, 32, 64
and 128 sub-lanes a lane; K3 pass 0 on ip's bidi reset tiles and K6 on
multi_literal32, literal_error and http_methods, each at the checkout's
split and, where it splits them, also at k = 16, 32 and 64; K5 on
multiline_php, inner_keyword and suffix_txt and K9 pass 0 over
`\s\d\s`'s fwd_all DFA, each at the checkout's split and, where it
splits them, also at k = 16, 32 and 64 (an unsplit K5 or K9 through its
own wrapper); then the warm walls (best of 3, host clock, after a first
call) of the counts of ip, the four literal configs (literal_error,
http_methods, alt_literal, multi_literal32) and the three line shapes
(K5), of the find_alls of ip and version, and of ip_opt's find_all at the
span limits' corpus (170 tiles), best of 10 of find_index on early matches
(K9 on a 4 MiB prefix, then the window kernel) and of the FULL_SCAN
is_match of `\s\d\s` and `(a|b)+c` (one K9 scan) on the bench corpus and
on spaces, best of 3 of is_match and find_index of the seven DFA-route
patterns on the late- and no-match corpora (chip_smoke.single_corpora:
K9 on prefixes of 4 MiB x8 to the whole), with K9's repair passes of the
last call, and quote parity (`"[^"]*"` on 16 MiB,
chip_smoke.quote_parity) with its repair passes.  K7: pass 0 on `0\.0`
(MODE_MULTI) at the checkout's split and, where it splits K7, at k = 16,
32 and 64 (an unsplit K7 through its own wrapper), the warm wall of the
`0\.0` count (K6, then K7) and, best of 2, of K7's parity chain (`aa`
over chip_smoke.parity_corpus, whose parity settles one lane a pass),
each with K7's launches and repair passes of the last call.  Kernel lines give the mean of REPS launches after a warm-up, with
CUDA events; chip_smoke.py times the same shapes beside their bound.
``--quote N`` times quote parity alone, N readings of its best-of-2
wall, so that runs of two checkouts can alternate in one call.

``--band`` times the headline tables' pass 0 (K1, K2 and K3 on ip, K9 on
`\s\d\s`'s fwd_all) and window ends form (every start of `\b\d+\b`'s
general find_all), then the band: for each keyword list of
chip_smoke.BAND_WORDS (`\b(?:w1|...|wN)\b` over chip_smoke.big_words)
and KW_HUGE, every mode's table with its shape, bytes, place, block size
and resident warps as that checkout stores and launches it
(chip_smoke.table_residency), then pass 0 of K1 (count) and K9 (fwd_all)
over the 1536 MiB bench corpus, their sub-lane and lane repair passes
(as the headline K1's and K2's) and the window ends form from the general
find_all's first chip_smoke.BAND_STARTS starts, each beside its bound.  A
checkout with 16-bit tables also times, on the same inputs, each lane
walk in the other place (global or shared memory) and over its table
widened to int32, and the window scan in each place its table fits
(global memory, shared memory with 16-bit or int32 values; the
wrappers' `place` and `width`), each equal to the rule's outputs: the
measurements the rules rest on.  ``--band --root _chip/parent`` times a
checkout before 16-bit tables (an unpacked parent) in the same call.
Imports no jax.
"""

import argparse
import inspect
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--quote", type=int, default=0,
                    help="time only quote parity, this many readings")
    ap.add_argument("--band", action="store_true",
                    help="time only the band's keyword-list tables")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan, flag_scan, line_scan

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: the kernels run on a "
                 "card")
    card = chip_smoke.phase_device()
    print(f"package: {os.path.dirname(ct.__file__)}")
    dev = torch.device("cuda")
    split = getattr(cs, "lane_split", None)

    def line(label, ms, extra=""):
        print(f"[time] {label:44} {ms:9.3f} ms{extra}  ({card})", flush=True)

    if args.quote:
        quote_parity(ct, args.quote, line)
        return
    if args.band:
        band(chip_smoke, ct, cs, dfa_scan, line)
        build_report()
        return
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

    # K3 on the bidi path's reset tiles, at the checkout's split (and, where
    # it splits K3, at 16, 32, 64); an unsplit checkout walks it through
    # flag_lanes with entries [L]
    k3_split = "k" in inspect.signature(flag_scan.flag_full).parameters
    _Lr, Tr, Wr, _ = flag_scan.reset_geometry(int(data.shape[0]))
    k = split(Tr, Wr) if k3_split else 1
    for kk in sorted({k, 16, 32, 64}) if k3_split else [1]:
        fa = chip_smoke.flag_args(be, data, kk)
        if k3_split:
            ms = chip_smoke.cuda_ms(
                lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fa), REPS)
        else:
            packed, _seg, symt, w4, entries, offs, flim = fa
            ms = chip_smoke.cuda_ms(
                lambda: flag_scan.flag_lanes(packed, symt, w4,
                                             entries.reshape(-1), offs,
                                             flim), REPS)
        line(f"K3 ip {mib} MiB" + (f" k={kk}" if k3_split else ""), ms,
             "  (lane_split's k)" if kk == k and k3_split else "")
        del fa
    # K6 on the literal sets the main path counts with it
    k6_split = "k" in inspect.signature(line_scan.hits_lanes_cuda).parameters
    k = split(T, W) if k6_split else 1
    for name in ("multi_literal32", "literal_error", "http_methods"):
        sc = ct.compile(chip_smoke.PATTERNS[name], device="cuda") \
            .batch_engine()._hits_scanner()
        for kk in sorted({k, 16, 32, 64}) if k6_split else [1]:
            ka = (kk,) if k6_split else ()
            ms = chip_smoke.cuda_ms(
                lambda: line_scan.hits_lanes_cuda(sc.tbl, sc.lens, tiles,
                                                  *ka), REPS)
            line(f"K6 {name} {mib} MiB" + (f" k={kk}" if k6_split else ""),
                 ms, "  (lane_split's k)" if kk == k and k6_split else "")
    # K5 on the line shapes, K9 on `\s\d\s`'s fwd_all DFA, at the
    # checkout's split (and 16, 32, 64 where it splits them)
    k5_split = "k" in inspect.signature(
        line_scan.LineScanner.lane_args).parameters
    geom = (L, T, W, 0)
    k = split(T, W) if k5_split else 1
    for name in ("multiline_php", "inner_keyword", "suffix_txt"):
        sc = ct.compile(chip_smoke.PATTERNS[name], device="cuda") \
            .batch_engine()._line_scanner()
        for kk in sorted({k, 16, 32, 64}) if k5_split else [1]:
            la = sc.lane_args(data, geom, tiles, *((kk,) if k5_split else ()))
            ms = chip_smoke.cuda_ms(lambda: line_scan.line_lanes_cuda(*la),
                                    REPS)
            line(f"K5 {name} {mib} MiB" + (f" k={kk}" if k5_split else ""),
                 ms, "  (lane_split's k)" if kk == k and k5_split else "")
            del la
    k9_split = "dead" in inspect.signature(cs.split_fixpoint).parameters
    k = split(T, W) if k9_split else 1
    for kk in sorted({k, 16, 32, 64}) if k9_split else [1]:
        margs = chip_smoke.match_args("ws_digit_ws", "fwd_all", data,
                                      (L, T, W), tiles, kk)
        ms = chip_smoke.cuda_ms(
            lambda: cs.lane_walk_cuda(cs.MODE_MATCH, *margs), REPS)
        line(f"K9 \\s\\d\\s fwd_all {mib} MiB"
             + (f" k={kk}" if k9_split else ""), ms,
             "  (lane_split's k)" if kk == k and k9_split else "")
        del margs
    # K7 on `0\.0` (MODE_MULTI), pass 0 at the checkout's split and, where
    # it splits K7, at 16, 32, 64; an unsplit K7 through its own wrapper
    from coregex_tpu_torch.ops import seq_scan
    k7_split = "k" in inspect.signature(
        seq_scan.SeqScanner.first_pass).parameters
    sq = seq_scan.SeqScanner(seq_scan.MODE_MULTI, [b"0.0"], device="cuda")
    n = int(data.shape[0])
    _L, Ts, Ws, _ = seq_scan.seq_geometry(n, sq.M)
    Ws = min(max(Ws, 4 * sq.M + 4), Ts)
    k = split(Ts, Ws) if k7_split else 1
    for kk in sorted({k, 16, 32, 64}) if k7_split else [1]:
        e0, o0, lim = sq.first_pass(data, n, L, Ts, Ws,
                                    *((kk,) if k7_split else ()))[:3]
        sa = (sq.mode, sq.tbl, sq.lens, sq.jh, sq.anchored, sq.plen, tiles,
              Ws // 4, e0, o0, lim)
        ms = chip_smoke.cuda_ms(lambda: seq_scan.seq_lanes_cuda(*sa), REPS)
        line(f"K7 0\\.0 {mib} MiB" + (f" k={kk}" if k7_split else ""), ms,
             "  (lane_split's k)" if kk == k and k7_split else "")
        del sa, e0
    del data, tiles
    torch.cuda.empty_cache()

    def wall(fn, reps=3):
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    for name in ("ip", "literal_error", "http_methods", "alt_literal",
                 "multi_literal32", "inner_keyword", "multiline_php",
                 "suffix_txt"):
        eng = ct.compile(chip_smoke.PATTERNS[name], device="cuda")
        line(f"{name} count {mib} MiB (wall)",
             wall(lambda: eng.count(corpus)))
    # `0\.0`'s count (K6, then K7 on its overlaps) and K7's parity chain
    # (`aa` over 16 MiB of b + a's), each with K7's launches and repair
    # passes of the last call
    seq = seq_scan.SEQ_KERNEL

    def k7_count(fn):
        chip_smoke.reset_passes(seq)
        seq.launches = 0
        return fn()

    def k7_passes():
        return (f"  K7 launches {seq.launches}, repair passes "
                f"{seq.sub_passes}+{seq.lane_passes}")

    eng = ct.compile(chip_smoke.PATTERNS["overlap_0.0"], device="cuda")
    line(f"0\\.0 count {mib} MiB (wall)",
         wall(lambda: k7_count(lambda: eng.count(corpus))), k7_passes())
    parity = torch.from_numpy(chip_smoke.parity_corpus()).to(dev)
    aa = seq_scan.SeqScanner(seq_scan.MODE_MULTI, [b"aa"], device="cuda")
    want = (int(parity.shape[0]) - 1) // 2
    got = aa.count(parity)
    if got != want:
        sys.exit(f"parity chain: count {got} != {want}")
    line("K7 parity chain aa 16 MiB count (wall)",
         wall(lambda: k7_count(lambda: aa.count(parity)), 2), k7_passes())
    del parity
    for name in ("ip", "version"):
        fbe = ct.compile(chip_smoke.PATTERNS[name], device="cuda") \
            .batch_engine()
        line(f"{name} find_all {mib} MiB (wall)", wall(
            lambda: int(fbe.find_all_spans_device(corpus,
                                                  defer_ok=True)[1])))
    # ip_opt's find_all (its count's route too) at the span limits' corpus
    pattern = chip_smoke.PATTERNS["ip_opt"]
    B = len(base)
    inner, tail = chip_smoke.tiled_spans(
        chip_smoke.oracle_spans(pattern, base), B, 1)
    reps = chip_smoke.limit_reps(inner, tail, B, len(corpus) // B)
    fbe = ct.compile(pattern, device="cuda").batch_engine()
    line(f"ip_opt find_all {reps} tiles (wall)", wall(
        lambda: int(fbe.find_all_spans_device(corpus[:reps * B],
                                              defer_ok=True)[1])))
    # K9 on the single-match paths, early match (a 4 MiB prefix) and none
    for name in ("ws_digits_ws", "a_word_end", "multiline_php"):
        eng = ct.compile(chip_smoke.PATTERNS[name], device="cuda")
        line(f"{name} find_index early {mib} MiB (wall)",
             wall(lambda: eng.find_index(corpus), 10))
    match = dfa_scan.MATCH_KERNEL
    corpora = chip_smoke.single_corpora(base, corpus)

    def k9_passes():
        return (f"  K9 repair passes {match.sub_passes}+"
                f"{match.lane_passes}")

    for name in ("ws_digit_ws", "ab_plus_c"):
        eng = ct.compile(chip_smoke.PATTERNS[name], device="cuda")
        for which, arr in (corpora[0], corpora[2]):
            ms = wall(lambda: chip_smoke.reset_passes(match)
                      or eng.is_match(arr), 10)
            line(f"{name} is_match {which} {mib} MiB (wall)", ms,
                 k9_passes())
    for name in ("inner_keyword", "ip", "email", "url", "multiline_php",
                 "version", "suffix_txt"):
        eng = ct.compile(chip_smoke.PATTERNS[name], device="cuda")
        for which, arr in corpora[1:]:
            for what, fn in (("is_match", eng.is_match),
                             ("find_index", eng.find_index)):
                ms = wall(lambda: chip_smoke.reset_passes(match)
                          or fn(arr))
                line(f"{name} {what} {which} {mib} MiB (wall)", ms,
                     k9_passes())
    del corpora
    quote_parity(ct, 1, line)


def quote_parity(ct, readings: int, line):
    """Quote parity's count wall (chip_smoke.quote_parity), `readings`
    times on one engine, each with its repair passes and K1 launches."""
    import chip_smoke
    eng = ct.compile(chip_smoke.QUOTES, device="cuda")
    for _ in range(readings):
        got, want, ms, subs, lanes, launches = chip_smoke.quote_parity(eng)
        if got != want:
            sys.exit(f"quote parity: count {got} != {want}")
        line("quote parity 16 MiB count (wall)", ms,
             f"  repair passes {subs}+{lanes}, {launches} K1 launches")


def build_report():
    """Registers and spills of every lane-walk and window-scan instance,
    from the ptxas report of the build (where this process built the
    library): one line an instance, its mangled template arguments (lane
    walk: mode, pass, shared memory, value type; window scan: ends form,
    shared memory, value types)."""
    import re
    from coregex_tpu_torch.ops import _build
    name, spill = None, ""
    for ln in (getattr(_build, "build_log", "") or "").splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(lane_walk_kernel|window_kernel)(I.*?E)Ev", ln)
        if "Compiling entry function" in ln:
            name = f"{m.group(1)}{m.group(2)}" if m else None
            spill = ""
        elif name and "spill" in ln:
            spill = "; " + ln.split("]")[-1].strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            print(f"[ptxas] {name}: {regs.group(1) if regs else '?'} "
                  f"registers{spill or '; no spills'}", flush=True)
            name = None


def band(chip_smoke, ct, cs, dfa_scan, line):
    """--band: the band's tables and times in the imported checkout."""
    import torch
    base = chip_smoke.build_base()
    corpus = chip_smoke.bench_corpus(base)
    data = torch.from_numpy(corpus).to("cuda")
    L, T, W, _ = cs.plan_geometry(int(data.shape[0]))
    k = cs.lane_split(T, W)
    tiles = cs.make_word_tiles(data, L, T // 4)
    new = hasattr(cs, "lane_pitch")
    hbm = chip_smoke.HBM_BYTES_PER_MS
    nbytes = chip_smoke.nbytes

    def timed(label, fn, bound, extra=""):
        ms = chip_smoke.cuda_ms(fn, REPS)
        line(label, ms, f"  bound {bound:.3f} ms ({ms / bound:.2f}x){extra}")
        return ms

    def repairs(label, mode, d, args):
        """The sub-lane and lane repair passes from pass 0's exits, a tenth
        of them random (chip_smoke.repair_case)."""
        run = chip_smoke.repair_case(mode, d, args)
        for whole in (False, True):
            line(f"{label} {'lane' if whole else 'sub-lane'} pass",
                 chip_smoke.cuda_ms(
                     lambda: run(cs.lane_repair_cuda, whole), REPS))

    # the headline tables at the checkout's split: K1 and K2 (ip), K3 (ip's
    # bidi reset tiles), K9 (`\s\d\s` fwd_all) and the window ends form
    # over every start of `\b\d+\b`'s general find_all
    ip = ct.compile(chip_smoke.PATTERNS["ip"], device="cuda").batch_engine()
    for kn, mode, d in (("K1", cs.MODE_COUNT, ip._count_scanner_ascii().dcd),
                        ("K2", cs.MODE_SPAN, ip._span_scanner(True).dsd)):
        a = chip_smoke.split_args(d, data, (L, T, W), tiles, k)
        line(f"{kn} ip pass 0 k={k}", chip_smoke.cuda_ms(
            lambda: cs.lane_walk_cuda(mode, *a), REPS))
        repairs(f"{kn} ip", mode, d, a)
        del a
    fa = chip_smoke.flag_args(ip, data)
    line(f"K3 ip pass 0 k={int(fa[4].shape[0])}", chip_smoke.cuda_ms(
        lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fa), REPS))
    del fa
    a = chip_smoke.match_args("ws_digit_ws", "fwd_all", data, (L, T, W),
                              tiles, k)
    line(f"K9 \\s\\d\\s fwd_all pass 0 k={k}", chip_smoke.cuda_ms(
        lambda: cs.lane_walk_cuda(cs.MODE_MATCH, *a), REPS))
    del a
    wd = ct.compile(chip_smoke.PATTERNS["word_digits"], device="cuda") \
        .batch_engine()
    rev, fwd = wd._full_scan_route()
    starts, m, _ok = wd._all_starts(rev, corpus)
    wargs = dfa_scan.window_args(fwd, data, starts[:m].contiguous(), None,
                                 wd.END_WINDOW)
    del starts
    line(f"ends \\b\\d+\\b {m} starts", chip_smoke.cuda_ms(
        lambda: dfa_scan.window_ends_cuda(*wargs, alive_u8=True), REPS))
    del wargs, ip, wd, rev, fwd
    torch.cuda.empty_cache()

    tile = chip_smoke.big_cut(base)
    huge = dict((nm, p) for nm, p, _ in chip_smoke.big_patterns(tile))
    for name, pattern in (chip_smoke.band_patterns(tile)
                          + [("KW_HUGE", huge["KW_HUGE"])]):
        be = ct.compile(pattern, device="cuda").batch_engine()
        kargs, margs, wargs, m = chip_smoke.band_inputs(
            be, data, corpus, (L, T, W), tiles, k)
        starts = (int(data.shape[0]), int(wargs[6].shape[0]), wargs[8])
        for kind, mode, t in chip_smoke.band_tables(be, "cuda"):
            print(f"[band] {name:6} {kind:7} "
                  f"{chip_smoke.residency_text(mode, t.packed, starts)}",
                  flush=True)
        for kn, mode, args in (("K1", cs.MODE_COUNT, kargs),
                               ("K9 fwd_all", cs.MODE_MATCH, margs)):
            out_b = 3 * args[4].numel() * 4 + (
                0 if mode == cs.MODE_COUNT else
                (args[2].numel() // 8 + args[4].numel()) * 4)
            bound = (nbytes(*args) + out_b) / hbm
            timed(f"{name} {kn} pass 0 k={k}",
                  lambda: cs.lane_walk_cuda(mode, *args), bound)
            if not new:
                continue
            # the table in each instance, and widened to int32 (the outputs
            # equal the rule's)
            S, nseg = (int(x) for x in args[0].shape)
            want = cs.lane_walk_cuda(mode, *args)
            wide = (cs.wide(args[0]),) + args[1:]
            for place, a in (("global", args), ("shared", args),
                             ("shared", wide)):
                smem = cs.lane_smem_bytes(
                    mode, S, nseg,
                    a[0].element_size() if place == "shared" else 0)
                if smem > cs.SMEM_LIMIT:
                    continue
                got = cs.lane_walk_cuda(mode, *a, place=place)
                if chip_smoke.max_abs_err(got, want):
                    sys.exit(f"{name} {kn}: {place} differs")
                del got
                timed(f"{name} {kn} {a[0].element_size() * 8}-bit {place}",
                      lambda: cs.lane_walk_cuda(mode, *a, place=place),
                      bound, f"  ({cs.lane_warps(smem)} warps)")
            del want, wide
        for kn, mode, d, args in (
                ("K1", cs.MODE_COUNT, be._count_scanner_ascii().dcd, kargs),
                ("K9 fwd_all", cs.MODE_MATCH,
                 be._chunk_scanner("fwd_all").mt, margs)):
            repairs(f"{name} {kn}", mode, d, args)
        bound = (chip_smoke.window_reads(*wargs)
                 + nbytes(wargs[6], *wargs[:4]) + 5 * wargs[6].numel()) / hbm
        timed(f"{name} ends {int(wargs[6].shape[0])} of {m} starts",
              lambda: dfa_scan.window_ends_cuda(*wargs, alive_u8=True),
              bound)
        if not new:
            del kargs, margs, wargs, be
            torch.cuda.empty_cache()
            continue
        # the window scan in each place the table fits (the ends equal
        # the rule's)
        want = dfa_scan.window_ends_cuda(*wargs, alive_u8=True)
        S, nseg = (int(x) for x in wargs[0].shape)
        for width in (0, 2, 4):
            p, resident = dfa_scan.window_plan_cuda(S, nseg, None, *starts,
                                                    width=width)
            if resident <= 0:
                continue
            got = dfa_scan.window_ends_cuda(*wargs, alive_u8=True,
                                            width=width)
            if chip_smoke.max_abs_err(got, want):
                sys.exit(f"{name} ends: width {width} differs")
            del got
            where = f"shared {p.width * 8}-bit" if p.width else "global"
            timed(f"{name} ends {where} {p.stage}-byte slices",
                  lambda: dfa_scan.window_ends_cuda(*wargs, alive_u8=True,
                                                    width=width),
                  bound, f"  ({resident} warps)")
        del kargs, margs, wargs, be, want
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
