#!/usr/bin/env python3
r"""Smoke run of coregex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. device  - requires torch.cuda; prints the card's name and power limit
  2. build   - builds coregex_tpu_torch/csrc/*.cu with nvcc for sm_90a
  3. kernels - each CUDA kernel against its plain torch version on the card,
               on the same inputs at main-path shapes, bit-equal per lane;
               times both (the kernel's launches queued behind a device
               sleep, so that host overhead is not timed), the bound
               (bytes moved over 3.35 TB/s) and, for
               the compactions, torch.nonzero on the same mask.  The lane
               walks (K1-K3) and the needle kernels (K5-K7) run on a 4 MiB
               sample (several patterns) and on the whole 1536 MiB corpus
               (one pattern each), K1, K2, K3, K5, K6 and K7 at the main
               path's split into sub-lanes (count_scan.lane_split; with
               its size, the table's form and the resident warps an SM
               printed), with K1's, K2's and K3's two repair passes (over
               unsettled sub-lanes, over the lanes holding one) from exits
               of which a tenth are random, at that split and, on the
               sample, also unsplit; K7's two repair passes likewise on
               the sample at k = 2 and 1, and from pass 0's own exits on
               its parity chain (`aa` over 16 MiB of b + a's) at k = 8;
               K5's device combine (LineScanner.verdict) against
               the numpy _combine on the same outputs; the single-pass
               compaction (K4, and
               K8 through compact_positions) on ragged lengths around
               its tile and sub-tile sizes at every byte offset 0-15 of
               a buffer set outside the mask (densities 0-1, 0-4
               payloads, caps under, at and over the count), on a
               2^31 - 1-entry mask at offset 1, on 2^22- and 2^26-entry
               masks and on charclass_w's unpacked run-start mask of
               the 1536 MiB corpus, and the sparse chain with 3 and 5
               word payloads at the 2^26-word shape of its first level;
               K8 on 2^22-entry masks and on the start mask of `\w*`
               over the 1536 MiB corpus (cap 2^30);
               the match scan (K9) at its split on the 4 MiB sample
               (break-at-match DFAs, with its two repair passes, at that
               split and unsplit) and on the whole corpus (`\s\d\s`,
               fwd_all), and the settled scan with its dead cut
               (dfa_scan.match_full: ip's fwd_break, an early match, so
               one pass at k = 64) against the same fixpoint over the
               plain walk; the
               window scan, flags form and ends form, on 2^12 forward
               starts of the sample and 2^16 random reverse starts at
               W = 256, the ends form also on a corpus of n % 16 != 0
               bytes at byte offset 3 with starts at 0, 1, n - 1 and n
               (no edge, and an idx scatter) and on one live lane of 16
               at W = 64 x 4^k; the
               general find_all's shapes (`\b\d+\b` on the whole
               corpus): K9 over the unanchored reverse DFA on the flipped
               corpus, K4's chain over its flag words and the window scan
               forward from every match start (about 55M) at W = 64 in
               both forms (with the sector floor of the bytes the lanes
               read); the ends form over fwd_anch_all, the
               leftmost-longest table, from every POSIX match start of
               `\d+?\.\d+?\.\d+?\.\d+?` on the whole corpus at W = 64,
               and from one lane of 16 that lives through the base's
               first MiB with its newlines made spaces (`a.*?b`) at
               W = 64 x 4^k, the round loop's end there against the host
               walk; the
               single-pass compaction (K10) on the compaction rig's mask
               (256 MiB at density 1/200, seed 11) at R = 128, at R = 256
               with two payloads under cond_dma + skip_empty, and at
               R = 512, and on masks of all-zero, all-one and random tiles,
               more tiles than its persistent grid has blocks; the
               bitset-NFA scan (cgx_bitset_scan) of the BITSET patterns,
               forward and reverse (on the flipped corpus): pass 0 with
               both its repair passes from exits of which a tenth are
               random sets, unsplit on the sample and at the main path's
               shape (the whole corpus's T, W and k = 64) on its first 16
               lanes (the lane pass there for one scan), then pass 0
               and the settled scan of each on the whole corpus, timed,
               the reverse scan of `[a-q][^u-z]{13}x` also held to the
               plain version there; the OnePass capture walk
               (cgx_onepass_extract) on every bidi span of the CAPTURES
               patterns over the whole corpus (2.67M ip spans) and on
               hand-made spans (random ones that die, MAX_WINDOW wide and
               one byte wider, the corpus's last bytes, also of a corpus
               of n % 16 != 0 bytes at byte offset 3), and the row scans
               (cgx_rows_match, cgx_rows_rev_start) on the first 2^20 lines
               of the corpus packed to [2^20, 256]; the OnePass walk and
               both row scans in every table mode their tables allow
               (byte-indexed and class-indexed shared, global), the
               reverse scan also from edge ends (0, L, on and beside
               16-byte boundaries) and from none; the all-entries
               transfer walk (cgx_transfer_walk) in both modes, on the
               4 MiB sample for the 13 bench patterns, on the whole
               corpus in MESH_SHARDS shards for ip, and on 256 MiB in
               MESH_SHARDS shards for quote parity, a random permutation
               table of 64 states and multi_literal32, with its rate of
               table steps; the reset scan (cgx_lane_reset) on the whole
               corpus in one launch a pass at the main path's split (L =
               8192 lanes of 196,608 bytes, k = 64) from the first of two
               subsets of the candidates of POSIX ip (a 16 x 8 table in
               shared memory) and of run_gap_x (1024 x 32, one 1024-thread
               block an SM), pass 0 and a sub-lane and a lane repair pass
               from perturbed exits, and on 4 MiB for a table past shared
               memory (M5_GLOBAL's 2048 x 32, read from global memory),
               and the reset-flag walk (K3) in
               its interference mode over email's suffix DFA with a reset
               at every candidate + k, at the reset geometry's split; then
               the global-memory instances of K1, K2, K3, K9 and both
               window forms (big_table_kernels: pass 0 at the main path's
               split on the whole corpus, the repair passes on 4 MiB), on
               the headline tables padded with unreachable rows past
               shared memory (the same walk in both instances, timed side
               by side) and on tables past shared memory: KW400's and
               KW_HUGE's count, span, fwd_all and anchored forward tables
               (the window forms from their first 2^26 match starts),
               KWL600's reverse flag table, INNER60's suffix table in
               K3's interference mode
  4. e2e     - the public API on a 1536 MiB log corpus (the JAX package's
               bench corpus), in twelve runs, each with the launch counts
               set to 0 before it and read after it.  Earlier slices: count for
               the 13 bench patterns and for `0\.0` (whose hits overlap,
               so K6 hands over to K7, with K7's repair passes printed),
               device find_all for the 4 bidirectional patterns and the 3
               line shapes, checked
               against a Python `re` oracle on the 6 MiB base tile scaled
               by the tile count; find_all_index on a 64 MiB slice compared
               span by span.  The 7 patterns that count through K5 or K6
               are also counted through K1, timed side by side.  Each count
               and find_all prints the repair passes of K1, or of K2 and
               K3 (over sub-lanes + over lanes).  Quote parity (`"[^"]*"` on 16 MiB
               of `"` + 299 x, whose state reaches back to the corpus
               start) is counted against its known count, with its passes
               and time.  Class runs
               and nullable patterns: count and device find_all of
               charclass_w, word_repeat and `\w*` at 1536 MiB, and of
               `(\d+\.\d+\.\d+\.\d+)?` and `(?m)(^/.*\.php)?` at the
               largest whole-tile corpus the span limits admit, against
               the Go-rule oracle (re's matches less each empty match that
               abuts the previous one; the tiling checked across the seam
               of a tile and the next tile's first MiB); find_all_index on
               the corpus's first MiB.  Single match:
               is_match and find_index (first call, then best of 2) of the
               13 bench patterns, `\s\d\s`, `(a|b)+c`, `\s\d+\s` and `a\b`
               (FULL_SCAN; the last two match the bench corpus),
               `\d+$` (END_ANCHORED) and `\w*` (nullable) on three
               corpora: the bench corpus (early match), spaces then a
               newline then one base tile (late match) and spaces only (no
               match), each of its own length, against `re` on windows
               whose bounds no match can cross (the filler checked with re
               to hold no match but the nullable one), with K9's repair
               passes of each call; the module-level match and
               match_string once each against re; and the re-tiling of
               find_first's prefixes, timed.  Literals: device find_all
               (first call, then best of 2) of literal_error,
               http_methods, alt_literal, multi_literal32, `0\.0` (a
               self-overlapping literal) and `0\.0|\.0\.` (hits that
               overlap) on the whole corpus against the tiled oracle,
               `(error)?` at the span limits' corpus as the nullable
               patterns above, then the compaction rig
               (tools/profile_compact_torch.py): its check, its 15
               variants and its production compactions, timed.  General
               find_all: count and device find_all of `\b\d+\b`,
               `\berror\b` and `\w+@\w+\.com\b` (the general fallback:
               match starts and window rounds printed) and of `\d{3}` and
               `[a-z]{2,5}` (the class split) at 1536 MiB, of `(\bfoo)?`
               and `a{0,3}` at the span limits' corpus and of `x*?`
               (ALL_EMPTY) on a SLICE_MIB slice, against the tiled oracle
               (Python's `\b` is Go's on ASCII), with find_all_index on
               the first MiB; the launches of each kernel in one warm
               find_all of each; find_all_index(t, 3) and (t, 2^20) of one
               pattern of each route against the oracle's first spans.
               BITSET_NFA (forward DFAs past the state limit): count and
               device find_all of `[a-q][^u-z]{13}x`,
               `[A-Za-z]\w{0,30}\d{2}\b` and `[A-Za-z]\w{0,30}\d{2}` at
               1536 MiB against the tiled oracle (the tiling checked on two
               tiles), find_all_index on two tiles, is_match and
               find_index on the three single-match corpora, each with the
               bitset scan's repair passes; `(a|b)*a(a|b){15}`, whose
               anchored DFA overflows too (ends from the host search at
               the device's starts), the same on the bench corpus (no
               match) and all four calls on a 1 MiB corpus of 128 matches
               against `re`.  Captures and row batches: the device form
               of FindAllSubmatch (find_all_spans_device, then
               OnePassScanner.extract_device) of the CAPTURES patterns at
               1536 MiB against re's group spans on one tile, tiled, with
               the extraction's kernel ms, its ok=False spans and the peak
               device memory; find_all_submatch_index and replace_all with
               "[$2:$1]" on 64 MiB against re; is_match_batch and
               find_index_batch of `\d+\.\d+` and `\berror\b` on 2^20
               lines against re per row, with the share of pack_rows.
               Multi-device (phase_e2e_multi, a virtual mesh of
               MESH_SHARDS shards on the card): the sharded count of the
               13 bench patterns against K1 on that mesh and on one of
               one shard (also on n % 4 != 0 bytes), the find_all of
               `\b\d+\b` and `\berror\b` with default_mesh replaced
               (the Engine's _sharded_starts hook) against the tiled
               oracle, make_sharded_ends against the single-device
               starts, distributed_count in a world of one process under
               NCCL, the phase probe's three times.
               Leftmost-longest (phase_e2e_posix, compile_posix): count
               and device find_all of the POSIX patterns (`\b\d+\b`,
               the lazy ip, `a.*?b`, email, `[a-q][^u-z]{13}x`,
               `err|error|errors`, `([a-z]{2,3})+`) at 1536 MiB against
               an oracle that is not the port (re on the pattern, on its
               greedy form for the lazy ones, on the set longest first,
               and each `[a-z]+` run cut to its longest prefix that
               `(?:[a-z]{2,3})+` fully matches), tiled, the tiling checked
               on two tiles; each with its route, match starts and
               window rounds, one warm find_all's launches, host_routes
               and find_all_index on two tiles, its count and find_all
               walls beside the leftmost-first engine's.
               Limits (phase_e2e_limits, the corpus cache cleared, the
               base tiled LIMITS_TILES = 341 times: 2,145,381,040 bytes,
               2,102,575 under MAX_CORPUS): device find_all of one
               pattern of each find_all route (LIMITS: class runs and
               their split, a line shape, the bidirectional path, the
               general route, BITSET_NFA, a literal and a set, `\w*`,
               `(error)?`, `x*?`, `.` and `(?s)error.*`) against the tiled
               oracle, each with its route, output and corpus pieces (`.`,
               `x*?` and `(error)?` pass 2^30 spans and must take two or
               more output pieces), host_routes, one warm call's
               launches and its peak device memory (at most
               LIMITS_PEAK_GIB = 60 GiB); one count of each count route
               (K1, K5, K6), the leftmost-longest count of `\b\d+\b` and
               find_all of email, each against its oracle.  M5 and invalid
               UTF-8 (phase_e2e_m5, run before the limits): the candidate
               and INNER pipelines of the M5 patterns (POSIX ip, version,
               email, url, `[A-Z]+ \d+` under both rules, and POSIX
               `[a-z]+ [^ ]{20,60}x` and `[a-z]+ error [^ ]{8,30}[a-z]`,
               which only M5 serves) called directly at 1536 MiB, the
               general fallback beside them where it serves, both
               against the tiled oracle (re, held to the POSIX host walk
               on the base's first 64 KiB) with their walls, then count
               and find_all through the public API, which must take M5
               where the general fallback declines; `[a-z]+ [^
               ]{20,60}x` again on exactly 1536 MiB; the candidate
               pipeline over `[a-q][^u-z]{13}x`'s reverse bitset starts
               beside its own route (a finding, not routed); then `[^
               \n]+` and `.\d` counted and found on the base with an
               invalid byte every 997 bytes, tiled to 1536 MiB, against
               Go's decoding, and `[^ \n]+` on the base with words in
               2-, 3- and 4-byte characters, with the decoder pass that
               finds it valid.  The limits run also finds `[a-z]+ [^
               ]{20,60}x` on as many of its tiles as keep the candidates
               under the pipeline's limit, with its peak device memory.
               Tables past shared memory (phase_e2e_big_tables, run
               before the limits): the BIG keyword lists (400 and 200
               words, `\b`, ` \w+`, `(?i)`, `\s\d+`, POSIX, groups, a
               1000-word list whose count transducer has 3,980 states,
               300 lowercase words on the bidirectional route) and POSIX
               `[a-z]+ error [^ ]{8,60}[a-z]` (INNER) on the base's first
               MiB tiled to the corpus size, ASCII and with multi-byte
               words: each route's tables (past shared memory, their
               instance), count, find_all, find_all_submatch_index on 64
               KiB, is_match and find_index on early, late and no-match
               corpora against re (POSIX: held to the host walk), the
               global instances' launches, host_routes 0
  5. routes  - every kernel K1-K7 was launched in the first run, K1-K4 and
               K8 in the second, K9 and the window scan's ends form in the
               third, K4 and K10 in the fourth, K9, the ends form, K4 and
               K8 in the fifth, the bitset scan, the ends form and K4 in
               the sixth, the OnePass walk, both row scans and K2-K4 in
               the seventh, the transfer walk in both modes, K9 and K8
               in the eighth, K9, the ends form, K4 and the bitset scan in
               the ninth, the reset scan, K3, K4, K8 and the ends form in
               the M5 run, the global-memory instances of K1, K2, K3, K9
               and the ends form in the big-table run, K1-K6, K8, K9, the
               ends form and the bitset scan in the limits run, and no
               call was declined to the
               host loop but
               the nullable find_index (the reference's FALLBACK, by
               design)

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.  Imports no jax.
"""

import functools
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# -- the JAX package's bench corpus and patterns (bench.py:58-120) -----------

def build_base(size=6 * 1024 * 1024, seed=7) -> bytes:
    """Log-like base corpus (paths, IPs, emails, URLs, versions, verbs,
    keywords), trimmed to the last full line so tiling is line-aligned."""
    rng = np.random.default_rng(seed)
    words = [
        b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
        b"dog", b"lorem", b"ipsum", b"dolor", b"sit", b"amet", b"consec",
        b"GET", b"POST", b"HTTP/1.1", b"200", b"404", b"useragent",
        b"alpha", b"beta", b"gamma", b"delta42", b"x86_64", b"warning",
    ]
    specials = [
        b"192.168.1.10", b"10.0.0.255", b"error", b"keyword",
        b"user@example.com", b"admin@test.org", b"v1.2.3",
        b"/index.php", b"/home/user/www.php", b"file.txt", b"notes.log",
        b"https://example.com/index.html?q=1", b"http://test.org/a/b",
        b"DELETE", b"2.14.7",
    ]
    lines = []
    total = 0
    while total < size:
        k = int(rng.integers(4, 12))
        line = []
        for _ in range(k):
            if rng.random() < 0.08:
                line.append(specials[int(rng.integers(len(specials)))])
            else:
                line.append(words[int(rng.integers(len(words)))])
        ln = b" ".join(line) + b"\n"
        lines.append(ln)
        total += len(ln)
    base = b"".join(lines)[:size]
    return base[:base.rfind(b"\n") + 1]


ALT32 = "|".join(
    ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
     "lambda", "sigma", "omega", "error", "warning", "notice", "debug",
     "trace", "fatal", "panic", "abort", "retry", "timeout", "refused",
     "closed", "opened", "created", "deleted", "updated", "inserted",
     "removed", "flushed", "synced", "loaded", "stored"])

CONFIGS = [
    ("inner_keyword", r".*keyword.*"),
    ("ip", r"\d+\.\d+\.\d+\.\d+"),
    ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
    ("url", r"\w+://[^\s]+"),
    ("multiline_php", r"(?m)^/.*\.php"),
    ("version", r"\d+.\d+.\d+"),
    ("suffix_txt", r".*\.txt"),
    ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH"),
    ("alt_literal", r"error|warning|notice|info|debug"),
    ("multi_literal32", ALT32),
    ("charclass_w", r"[\w]+"),
    ("word_repeat", r"(\w{2,8})+"),
    ("literal_error", r"error"),
]
# counted with the bench patterns, outside bench.py's list
EXTRA_COUNTS = [("overlap_0.0", r"0\.0")]
FIND_ALL = ("ip", "version", "email", "url", "inner_keyword", "multiline_php",
            "suffix_txt")
# the patterns the needle kernels count (K5: line shapes, K6: literal sets)
REROUTED = ("inner_keyword", "multiline_php", "suffix_txt", "http_methods",
            "alt_literal", "multi_literal32", "literal_error")
# the class-run and nullable slice: (name, pattern, corpus) where corpus
# "full" is the whole 1536 MiB corpus and "limit" the largest whole-tile
# corpus the span limits admit
CLASS_NULLABLE = [("charclass_w", r"[\w]+", "full"),
                  ("word_repeat", r"(\w{2,8})+", "full"),
                  ("word_star", r"\w*", "full"),
                  ("ip_opt", r"(\d+\.\d+\.\d+\.\d+)?", "limit"),
                  ("php_opt", r"(?m)(^/.*\.php)?", "limit")]
# the literal slice: device find_all of the four literal bench patterns,
# `0\.0` (a self-overlapping literal) and a set whose hits overlap in
# 10.0.0.255 on the whole corpus; a nullable pattern with a literal core on
# the span limits' corpus (as CLASS_NULLABLE)
LITERAL_EXTRA = [("overlap_set", r"0\.0|\.0\.")]
LITERAL_FIND_ALL = ("literal_error", "http_methods", "alt_literal",
                    "multi_literal32", "overlap_0.0", "overlap_set")
LITERAL_NULLABLE = [("error_opt", r"(error)?", "limit")]
# the general find_all slice: patterns with a look (the general fallback),
# {m,k} class runs (the class split) at 1536 MiB, nullable patterns whose
# cores take those routes at the span limits' corpus, and ALL_EMPTY on a
# SLICE_MIB slice (at 1536 MiB it would have n + 1 > 2^30 spans); find_all
# limits for one pattern of each route
GENERAL = [("word_digits", r"\b\d+\b", "full"),
           ("word_error", r"\berror\b", "full"),
           ("word_email", r"\w+@\w+\.com\b", "full"),
           ("digits3", r"\d{3}", "full"),
           ("lower2_5", r"[a-z]{2,5}", "full"),
           ("foo_opt", r"(\bfoo)?", "limit"),
           ("a0_3", r"a{0,3}", "limit"),
           ("empty_lazy", r"x*?", "slice")]
GENERAL_LIMITS = ("word_digits", "lower2_5", "a0_3", "empty_lazy")
# the BITSET_NFA slice (DFAs past the 20,000-state limit): the bitset scan,
# its ends by the window scan over fwd_anch_break; the second pattern has
# looks (two closure groups); the last one's anchored DFA overflows too, so
# the host search finds its ends
BITSET = [("nfa_u_z", r"[a-q][^u-z]{13}x"),
          ("nfa_word_digits_b", r"[A-Za-z]\w{0,30}\d{2}\b"),
          ("nfa_word_digits", r"[A-Za-z]\w{0,30}\d{2}")]
BITSET_HOST_ENDS = ("nfa_ab_host", r"(a|b)*a(a|b){15}")
# the captures and row-batch slice: the OnePass walk over the bidi spans of
# the ip config with groups and of a key=value pattern at CORPUS_MIB, the
# public find_all_submatch_index and replace_all on CAPTURE_API_MIB; the row
# batches on the first ROWS lines of the tiled bench corpus
CAPTURES = [("ip_groups", r"(\d+)\.(\d+)\.(\d+)\.(\d+)"),
            ("kv_groups", r"([a-z]+)=(\d+)")]
CAPTURE_API_MIB = 64
CAPTURE_TEMPLATE = (b"[$2:$1]", rb"[\2:\1]")    # Go's form, re's form
ROWS = 1 << 20
ROW_PATTERNS = [("digits_dot", r"\d+\.\d+"), ("word_error", r"\berror\b")]
# the leftmost-longest slice (compile_posix): (name, pattern, the pattern of
# re's oracle, or None for the ([c]{m,k})+ run oracle, posix_run_spans);
# count and find_all at CORPUS_MIB, the leftmost-first walls beside; the
# window scan's ends form over fwd_anch_all on POSIX_WINDOW's starts
POSIX = [("word_digits", r"\b\d+\b", r"\b\d+\b"),
         ("lazy_ip", r"\d+?\.\d+?\.\d+?\.\d+?", r"\d+\.\d+\.\d+\.\d+"),
         ("lazy_ab", r"a.*?b", r"a.*b"),
         ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+",
          r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
         ("nfa_u_z", r"[a-q][^u-z]{13}x", r"[a-q][^u-z]{13}x"),
         ("err_set", r"err|error|errors", r"errors|error|err"),
         ("lower_plus", r"([a-z]{2,3})+", None)]
# the limits slice: device find_all of one pattern of each find_all route on
# LIMITS_TILES base tiles (2,145,381,040 bytes, 2,102,575 under MAX_CORPUS),
# the routes whose totals pass MAX_DEVICE_SPANS (LIMITS_PIECED) in pieces;
# one count of each count route (K1, K5, K6) and two leftmost-longest calls
# at the same size; no call's peak device memory may pass LIMITS_PEAK_GIB
LIMITS_TILES = 341
LIMITS = [("charclass_w", r"[\w]+"), ("lower2_5", r"[a-z]{2,5}"),
          ("inner_error", r".*error.*"), ("ip", r"\d+\.\d+\.\d+\.\d+"),
          ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
          ("word_digits", r"\b\d+\b"), ("nfa_u_z", r"[a-q][^u-z]{13}x"),
          ("literal_error", r"error"),
          ("http_methods", r"GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH"),
          ("word_star", r"\w*"), ("error_opt", r"(error)?"),
          ("empty_lazy", r"x*?"), ("dot", r"."),
          ("dotall_error", r"(?s)error.*")]
LIMITS_PIECED = ("dot", "empty_lazy", "error_opt")
# each route's densest corpus at the same size, where its result can pass
# MAX_DEVICE_SPANS (or, for class runs and the general route's `\b\w\b`,
# come closest: n / 2 runs): (name, pattern, corpus, route, oracle), the
# corpus "a" (a's), "space" (spaces) or "a_space" ("a " repeated), the
# oracle (s0, e0, step, count) for the arithmetic spans (s0 + step i, e0 +
# step i), i < count, count None for n // step (n + 1 with step 1 and an
# empty span)
LIMITS_DENSE = [
    ("class_split_a", r"[a-z]", "a", "charclass", (0, 1, 1, None)),
    ("literal_a", r"a", "a", "literal", (0, 1, 1, None)),
    ("overlap_aa", r"aa", "a", "literal", (0, 2, 2, None)),
    ("general_dot_nb", r".\B", "a", "full_scan", (0, 1, 1, -1)),
    ("line_first_aa", r"aa.*", "a", "line", "whole"),
    ("line_last_aa", r".*aa", "a", "line", "whole"),
    ("k8_word_star", r"\w*", "space", "nullable_k8", (0, 0, 1, None)),
    ("class_runs_a", r"[a-z]+", "a_space", "charclass", (0, 1, 2, None)),
    ("general_word_b", r"\b\w\b", "a_space", "full_scan", (0, 1, 2, None)),
]
LIMITS_COUNTS = ("ip", "inner_error", "literal_error")    # K1, K5, K6
LIMITS_PEAK_GIB = 60
POSIX_WINDOW = "lazy_ip"
POSIX_LONG_LANE = "lazy_ab"     # the lane that lives for several rounds
# the candidate and INNER pipelines (M5): (name, pattern, posix, the
# pattern of re's oracle); each runs behind the bidirectional path where
# the reference sends it (POSIX ip, version, email and url, [A-Z]+ \d+),
# with the general fallback timed beside it where that serves too, then
# through the public API; M5_SCAN is the reset scan's headline (its
# candidates at the main path's geometry) and M5_INNER K3's interference
# mode's
M5 = [("ip", r"\d+\.\d+\.\d+\.\d+", True, r"\d+\.\d+\.\d+\.\d+"),
      ("version", r"\d+.\d+.\d+", True, r"\d+.\d+.\d+"),
      ("email", r"[\w.+-]+@[\w.-]+\.[\w.-]+", True,
       r"[\w.+-]+@[\w.-]+\.[\w.-]+"),
      ("url", r"\w+://[^\s]+", True, r"\w+://[^\s]+"),
      ("upper_digits", r"[A-Z]+ \d+", True, r"[A-Z]+ \d+"),
      ("upper_digits_lf", r"[A-Z]+ \d+", False, r"[A-Z]+ \d+"),
      ("run_gap_x", r"[a-z]+ [^ ]{20,60}x", True, r"[a-z]+ [^ ]{20,60}x"),
      ("inner_gap", r"[a-z]+ error [^ ]{8,30}[a-z]", True,
       r"[a-z]+ error [^ ]{8,30}[a-z]")]
# also found on exactly CORPUS_MIB MiB (a length plan_geometry's lanes fill
# exactly, so the reset scan's pad byte starts the next size bucket) and on
# the limits corpus, with its peak device memory
M5_WHOLE = "run_gap_x"
M5_SCAN = "ip"
M5_INNER = "email"
# the reset scan's kernel checks also take run_gap_x's 1024 x 32 table
# (one block an SM) and, on 4 MiB, a table past shared memory
M5_WIDE = "run_gap_x"
M5_GLOBAL = ("run_gap_x120", r"[a-z]+ [^ ]{20,120}x")
# BITSET_NFA keeps its route; the candidate pipeline over its reverse
# bitset scan's starts is timed beside it, as a finding
M5_BITSET = ("nfa_u_z", r"[a-q][^u-z]{13}x")
M5_CHECK_BYTES = 1 << 16   # re's oracle held to the POSIX host walk there
# one corpus with invalid UTF-8 at CORPUS_MIB: the base with single bytes
# Go decodes as U+FFFD written in (a lead byte before ASCII, 0xFF, a lone
# continuation byte) every INVALID_STEP bytes, counted and found against
# Go's decoding (Python's decoder gives each such byte one U+FFFD too)
INVALID_STEP = 997
INVALID_BYTES = (0xC3, 0xFF, 0x80, 0xE2, 0xF0)
INVALID_PATTERNS = [("nonspace", r"[^ \n]+"), ("dot_digit", r".\d")]
# one valid multi-byte corpus at CORPUS_MIB: words of the base written in
# 2-, 3- and 4-byte characters; its first call pays the decoder pass
# that finds it valid, and nothing else of the normalization
VALID_WORDS = [(b"lorem", "lørem"), (b"dolor", "dolör"), (b"amet", "amét"),
               (b"gamma", "γάμμα"), (b"delta42", "δέλτα42"),
               (b"fox", "狐"), (b"lazy", "怠惰"), (b"dog", "🐕")]
VALID_PATTERN = ("nonspace", r"[^ \n]+")
# Tables past shared memory (ROADMAP P5): lists of hundreds of keywords,
# whose DFAs of 1,000-4,000 states over 60-90 byte segments pack into
# 0.3-1.2 MB, past the 232,448 bytes a block's shared memory takes, so K1,
# K2, K3, K9 and the window scan read them from global memory.  A list is
# the base tile's distinct words (every whitespace-separated token,
# escaped; with `lower`, its lowercase words only: a list of lowercase
# words packs into 34 segments and fits), then seeded random lowercase
# words of 4-9 letters.  KW_HUGE's count transducer has at least
# BIG_HUGE_STATES states (its DFAs about 1 MB on the card, which L1 cannot
# hold; its minimized count table 0.7 MB); KWL600 takes the
# bidirectional route (K2 and K3; its tables have more than 2047 rows, so
# they stay int32 and take the global-memory instances, where KWL300's
# 16-bit ones took shared memory) and INNER60 the INNER pipeline (K3's
# interference mode over its 1024 x 64 suffix table).  The e2e run tiles
# the base's first BIG_CUT bytes (re with 400 alternatives takes about a
# second a MiB) to the corpus size, ASCII and with VALID_WORDS' 2-4-byte
# characters
BIG = [("KW400", (400, False), r"\b(?:{})\b", False),
       ("KW400_FIELD", (400, False), r"\b(?:{}) \w+", False),
       ("KWI200", (200, False), r"(?i)(?:{})\s\d+", False),
       ("KWI200_POSIX", (200, False), r"(?i)(?:{})\s\d+", True),
       ("KWI200_CAP", (200, False), r"(?i)((?:{}))\s(\d+)", False),
       ("KW_HUGE", (1000, False), r"\b(?:{})\b", False),
       ("KWL600", (600, True), r"(?i)(?:{})\s\d+", False),
       ("INNER60", None, r"[a-z]+ error [^ ]{8,60}[a-z]", True)]
BIG_SEED = 23
BIG_HUGE_STATES = 3000
BIG_CUT = 1 << 20
# find_all_submatch_index through the API on the tile's first
# BIG_API_BYTES (past the Engine's 16 KiB batch threshold, so the spans
# come from the card); re's POSIX spans are held to the port's host walk
# on its first BIG_POSIX_CHECK (the host walk of a 200-word list takes
# about 50 ms a match)
BIG_API_BYTES = 20 << 10
BIG_POSIX_CHECK = 4 << 10
# phase 3: the global instances on these tables, and on the headline
# tables padded with unreachable rows past shared memory (the same walk in
# both instances); the window scan on the first BIG_WINDOW_STARTS starts
BIG_KERNELS = ("KW400", "KW_HUGE")
BIG_WINDOW_STARTS = 1 << 26
# the band: `\b(?:w1|...|wN)\b` over big_words for each of BAND_WORDS
# (tables of 16-230 KB as int32 between the headline tables and the tables
# past shared memory); pass 0 of K1 and K9 over the whole corpus, the
# window ends form from the general find_all's first BAND_STARTS starts,
# BAND_REPS launches each; every lane walk of a list must keep
# BAND_MIN_WARPS warps an SM; the count and find_all walls of BAND_WALLS'
# lists
BAND_WORDS = (10, 25, 50, 100, 150, 200, 400)
BAND_STARTS = 1 << 26
BAND_REPS = 3
BAND_MIN_WARPS = 32
BAND_WALLS = ("KW50", "KW150")
SLICE_MS = {}   # phase 3's kernel ms of the slice's shapes, for phase 4
MESH_SHARDS = 4     # shards of the virtual mesh on the one card
TRANSFER_MAIN = "ip"    # the transfer walk's whole-corpus pattern
MULTI_ODD = ("ip", "multi_literal32")   # also counted on n % 4 != 0 bytes
MULTI_FIND_ALL = [("word_digits", r"\b\d+\b"), ("word_error", r"\berror\b")]
# band lists whose reverse table is outside the transfer walk's gate
# (more than 512 states; past its shared memory): the mesh's find_all
MULTI_GATE = ("KW100", "KW200")
# the single-match slice: the bench patterns and these
SINGLE_EXTRA = [("ws_digit_ws", r"\s\d\s"), ("ab_plus_c", r"(a|b)+c"),
                ("ws_digits_ws", r"\s\d+\s"), ("a_word_end", r"a\b"),
                ("digits_end", r"\d+$"), ("word_star", r"\w*")]
# Go's `$` outside (?m) matches only at the end of the text; Python's also
# before a final newline
ORACLE_RE = {r"\d+$": rb"\d+\Z"}
FILLER = 0x20       # the late and no-match corpora's filler byte
PATTERNS = dict(CONFIGS + EXTRA_COUNTS + SINGLE_EXTRA + LITERAL_EXTRA
                + BITSET + [BITSET_HOST_ENDS]
                + [(nm, p) for nm, p, _ in CLASS_NULLABLE + LITERAL_NULLABLE
                   + GENERAL])
DEVICE = "cuda"
CORPUS_MIB = 1536
SLICE_MIB = 64
BIG_WORDS = 1 << 26     # K4 mask / chain word count of a 1536 MiB find_all
LONGEST = 2 ** 31 - 1   # the longest mask cgx_compact takes
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM: 3.35 TB/s
OPS_PER_MS = 67e9           # H100 SXM: 67 TFLOP/s outside the tensor cores
M32 = 1 << 32
API_BYTES = 1 << 20     # the class-run and nullable find_all_index check


def oracle_spans(pattern: str, base: bytes):
    """Go's FindAll from re.finditer on an ASCII text: Go drops an empty
    match that abuts the previous match, re keeps it; after an empty match
    at p Go searches on from p + 1, where re first tries a non-empty match
    at p (only a lazy pattern such as `x*?` has one), so the scan restarts
    at p + 1 there.  No pattern without empty matches is affected."""
    rx = re.compile(pattern.encode("ascii"))
    out, prev, pos = [], (-1, -1), 0
    while pos is not None:
        start, pos = pos, None
        for m in rx.finditer(base, start):
            s, e = m.span()
            if prev[0] == prev[1] == s < e:
                pos = s + 1
                break
            if not (s == e == prev[1]):
                out.append((s, e))
            prev = (s, e)
    return out


def tiled_spans(spans0, B: int, reps: int):
    """The Go-rule spans of `reps` copies of a line-aligned tile of B bytes,
    from those of one tile (spans0).  Every copy repeats the tile's matches
    that start before B; an empty match at B stays only at the end of the
    last copy.  Returns (inner, tail): the repeated matches and the final
    ones."""
    inner = [sp for sp in spans0 if sp[0] < B]
    tail = [(reps * B, reps * B)] if spans0 and spans0[-1] == (B, B) else []
    return inner, tail


def expand_tiles(inner, tail, B: int, reps: int):
    return [(s + t * B, e + t * B) for t in range(reps)
            for s, e in inner] + tail


def tiled_digest(inner, tail, B: int, reps: int, rng):
    """(count, sum of starts mod 2^32, sum of ends mod 2^32, 64 sampled
    indices, their spans) of the tiled span list."""
    m0 = len(inner)
    cnt = reps * m0 + len(tail)
    tri = B * m0 * (reps * (reps - 1) // 2)
    ss = (reps * sum(s for s, _ in inner) + tri
          + sum(s for s, _ in tail)) % M32
    es = (reps * sum(e for _, e in inner) + tri
          + sum(e for _, e in tail)) % M32
    sidx = np.sort(rng.integers(0, cnt, 64 if cnt else 0))
    samp = np.array([tail[int(g) - reps * m0] if g >= reps * m0 else
                     (inner[int(g) % m0][0] + (int(g) // m0) * B,
                      inner[int(g) % m0][1] + (int(g) // m0) * B)
                     for g in sidx]).reshape(-1, 2)
    return cnt, ss, es, sidx, samp


# -- timing ------------------------------------------------------------------

def reset_passes(counter):
    """Zero a lane walk counter's repair passes."""
    counter.sub_passes = counter.lane_passes = 0


def passes(counter) -> str:
    return f"{counter.sub_passes}+{counter.lane_passes}"


SLEEP_CYCLES_PER_S = 2e9   # about the H100's SM clock under load


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warmup.  The
    launches queue behind a device sleep as long as the host takes to issue
    them (measured on a second warm call, at most 0.2 s), so a launch whose
    host work outlasts its kernel is timed on the device, not the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host, 0.2) * SLEEP_CYCLES_PER_S))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(xs, ys) -> int:
    """Largest |x - y| over paired integer tensors; fails if any pair
    differs in shape or dtype."""
    import torch
    err = 0
    for x, y in zip(xs, ys):
        if (x is None) != (y is None):
            fail("kernel and plain version return different outputs")
        if x is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"shape/dtype mismatch {x.shape}/{x.dtype} vs "
                 f"{y.shape}/{y.dtype}")
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), 1 << 26):     # bounded transients
            d = (x[i:i + (1 << 26)].to(torch.int64)
                 - y[i:i + (1 << 26)].to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def nbytes(*xs) -> int:
    """Bytes of the tensors among xs."""
    import torch
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


# -- phases ----------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from coregex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    wall = time.perf_counter() - t0
    how = (f"nvcc {' '.join(_build.FLAGS)} in {_build.build_seconds:.2f} s"
           if _build.build_seconds is not None else "already built")
    print(f"[build] {_build.library_path()} from {_build.CSRC}/"
          f"{{{','.join(_build.SOURCES)}}}: {how} (load {wall:.2f} s)")
    for line in _build.build_log.splitlines():
        # every entry's registers, and its spills where it has any
        if ("registers" in line or "Compiling entry" in line
                or ("spill" in line and "0 bytes spill stores, 0 bytes "
                    "spill loads" not in line)):
            print(f"[build]   {line.strip()}")
    return _build.build_seconds


def phase_kernels(base: bytes, corpus: np.ndarray):
    """Each kernel against its plain version at main-path shapes: the lane
    walks and needle kernels on a 4 MiB sample for several patterns and on
    the whole corpus for one each, the compaction and the sparse chain on
    masks and words of the sizes the span chains give them."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import (compact, compact2, compact_exp,
                                       dfa_scan, flag_scan, line_scan,
                                       seq_scan)

    dev = torch.device(DEVICE)
    results = {}

    def compare(kind, label, run_kernel, run_plain, reps=5,
                headline=False, in_bytes=0, library=None):
        """Bit-equality of kernel and plain version on one input; the
        plain run is timed once, the kernel over reps launches, `library`
        (one torch call computing the same function) likewise.  The
        headline comparison's times go into the JSON line, with its bound:
        the larger of the bytes it must move (in_bytes read once, its
        outputs written once) over the card's memory rate and one
        operation per input byte over its non-tensor rate."""
        k = run_kernel()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        p = run_plain()
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = max_abs_err(k, p)
        if err:
            fail(f"{kind} kernel differs from its plain version on {label}"
                 f" (max abs err {err})")
        out_bytes = nbytes(*k)
        del k
        ms = cuda_ms(run_kernel, reps)
        lib_ms = cuda_ms(library, reps) if library is not None else None
        by_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_MS
        by_ops = in_bytes / OPS_PER_MS
        bound = max(by_bytes, by_ops)
        print(f"[kernels] {kind:11} {label:20} bit-equal (tolerance 0)  "
              f"kernel {ms:9.3f} ms  plain {plain_ms:10.3f} ms"
              + (f"  bound {bound:.3f} ms" if in_bytes else "")
              + (f"  torch.nonzero {lib_ms:.3f} ms"
                 if lib_ms is not None else ""), flush=True)
        r = results.setdefault(kind, dict(max_abs_err=0, ms=None,
                                          plain_ms=None, bound_ms=None,
                                          bound_by=None, library_ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if headline or r["ms"] is None:
            r["ms"], r["plain_ms"], r["library_ms"] = ms, plain_ms, lib_ms
            if in_bytes:
                r["bound_ms"] = bound
                r["bound_by"] = "bytes" if by_bytes >= by_ops \
                    else "operations"
        return ms

    def repair_kernels(kind, mode, d, args_of, splits, label):
        """K1's, K2's, K3's or K9's two repair passes (sub-lane and lane)
        against their plain versions at each split kk in `splits`, from the
        pass-0 arguments args_of(kk)."""
        for kk in splits:
            run = repair_case(mode, d, args_of(kk))
            for whole in (False, True):
                compare(kind, f"{label} k={kk} "
                        f"{'lane' if whole else 'sub-lane'} pass",
                        lambda: run(cs.lane_repair_cuda, whole),
                        lambda: run(cs.lane_repair_plain, whole))

    def lane_kernels(name, data, label, headline):
        """K1, K2 and K3 at the main path's split with their two repair
        passes (on the sample also unsplit), on one corpus under the main
        path's geometry (K3's: reset_geometry)."""
        n = int(data.shape[0])
        L, T, W, _ = cs.plan_geometry(n)
        k = cs.lane_split(T, W)
        tiles = cs.make_word_tiles(data, L, T // 4)
        print(f"[kernels] {label}: {n} bytes, geometry L={L} T={T} W={W}, "
              f"K1/K2 split k={k}: {k * L} walkers of {T // k} bytes")
        be = ct.compile(dict(CONFIGS)[name], device=DEVICE).batch_engine()
        sc = be._count_scanner_ascii()
        if not sc:
            fail(f"{name}: no ASCII count transducer")
        ssc = be._span_scanner(True)
        for kind, mode, d in (("count_scan", cs.MODE_COUNT, sc.dcd),
                              ("span_scan", cs.MODE_SPAN,
                               ssc.dsd if ssc else None)):
            if d is None:
                continue
            args = split_args(d, data, (L, T, W), tiles, k)
            print(f"[kernels] {kind:11} {label}: table [{d.S}, {d.NSEG}], "
                  f"{cs.resident_warps(mode, d.S, d.NSEG)[0]} resident "
                  f"warps "
                  f"an SM")
            compare(kind, label,
                    lambda: cs.lane_walk_cuda(mode, *args),
                    lambda: cs.lane_walk_plain(mode, *args),
                    headline=headline, in_bytes=nbytes(*args))
            # the repair passes at the main path's split, and on the
            # sample unsplit (a corpus of at most 2 MiB walks k = 1)
            repair_kernels(kind, mode, d,
                           lambda kk: split_args(d, data, (L, T, W), tiles,
                                                 kk),
                           [k] if headline else sorted({1, k}), label)
        fargs = flag_args(be, data)
        if fargs is None:
            return
        packed, symt, fk = fargs[0], fargs[2], int(fargs[4].shape[0])
        S, C = (int(x) for x in packed.shape)
        print(f"[kernels] flag_scan   {label}: reset geometry "
              f"L={symt.shape[1]} T={4 * symt.shape[0]}, split k={fk}, "
              f"table [{S}, {C}], "
              f"{cs.resident_warps(cs.MODE_FLAG, S, C)[0]} resident warps "
              f"an SM")
        compare("flag_scan", label,
                lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fargs),
                lambda: cs.lane_walk_plain(cs.MODE_FLAG, *fargs),
                headline=headline, in_bytes=nbytes(*fargs))
        del symt, fargs
        repair_kernels("flag_scan", cs.MODE_FLAG, flag_scan.FlagWalk(packed),
                       lambda kk: flag_args(be, data, kk),
                       [fk] if headline else sorted({1, fk}), label)

    n = 4 * 1024 * 1024
    sample = base[:base.rfind(b"\n", 0, n) + 1]
    data = torch.from_numpy(np.frombuffer(sample, np.uint8).copy()).to(dev)
    for name in ("ip", "email", "multi_literal32"):
        lane_kernels(name, data, name, headline=False)
    # the main path's lane length: the whole corpus, one pattern
    data = torch.from_numpy(corpus).to(dev)
    lane_kernels("ip", data, f"ip {CORPUS_MIB} MiB", headline=True)
    del data
    # quote parity, whose count walks the most repair passes of the main
    # path (about one a lane), at its split
    data = torch.from_numpy(quote_corpus()).to(dev)
    L, T, W, _ = cs.plan_geometry(int(data.shape[0]))
    sc = ct.compile(QUOTES, device=DEVICE).batch_engine() \
        ._count_scanner_ascii()
    qtiles = cs.make_word_tiles(data, L, T // 4)
    repair_kernels("count_scan", cs.MODE_COUNT, sc.dcd,
                   lambda kk: split_args(sc.dcd, data, (L, T, W), qtiles, kk),
                   [cs.lane_split(T, W)], "quote parity 16 MiB")
    del qtiles
    del data
    for kind in ("count_scan", "span_scan", "flag_scan"):
        if kind not in results:
            fail(f"no {kind} comparison ran")

    def needle_kernels(data, host, label, k5=(), k6=(), k7=(),
                       headline=False, k7_repairs=()):
        """K5, K6 and K7 on one corpus (`host`: its bytes on the host)
        under the main path's geometry, K7 also through `k7_repairs`."""
        n = int(data.shape[0])
        geom = cs.plan_geometry(n)
        L, T, W = geom[:3]
        k = cs.lane_split(T, W)
        tiles = cs.make_word_tiles(data, L, T // 4)
        print(f"[kernels] {label}: {n} bytes, geometry L={L} T={T}, K5/K6 "
              f"split k={k}: {k * L} walkers of {T // k} bytes")
        for name in k5:
            sc = ct.compile(PATTERNS[name], device=DEVICE) \
                .batch_engine()._line_scanner()
            args = sc.lane_args(data, geom, tiles, k)
            compare("line_scan", f"{name} {label}",
                    lambda: line_scan.line_lanes_cuda(*args),
                    lambda: line_scan.line_lanes_plain(*args),
                    headline=headline, in_bytes=nbytes(*args))
            line_combine(sc, data, host, T, args[5],
                         line_scan.line_lanes_cuda(*args), f"{name} {label}")
        for name in k6:
            sc = ct.compile(PATTERNS[name], device=DEVICE) \
                .batch_engine()._hits_scanner()
            args = (sc.tbl, sc.lens, tiles, k)
            compare("hits_scan", f"{name} {label}",
                    lambda: line_scan.hits_lanes_cuda(*args),
                    lambda: line_scan.hits_lanes_plain(*args),
                    headline=headline, in_bytes=nbytes(*args))
        for what, sc in k7:
            seq_kernels(compare, sc, data, tiles, f"{what} {label}",
                        headline, repairs=k7_repairs)

    def seq(mode, needles, prefix=b""):
        return seq_scan.SeqScanner(mode, needles, prefix=prefix,
                                   anchored=bool(prefix), device=dev)

    sample_host = np.frombuffer(sample, np.uint8)
    sample = torch.from_numpy(sample_host.copy()).to(dev)
    alt32 = [w.encode() for w in ALT32.split("|")]
    k7_sample = [("multi 0.0", seq(seq_scan.MODE_MULTI, [b"0.0"])),
                 ("multi alt32", seq(seq_scan.MODE_MULTI, alt32)),
                 ("line keyword", seq(seq_scan.MODE_LINE, [b"keyword"])),
                 ("line ^/ .php", seq(seq_scan.MODE_LINE, [b".php"], b"/"))]
    needle_kernels(
        sample, sample_host, "4 MiB",
        k5=("inner_keyword", "multiline_php", "suffix_txt"),
        k6=("http_methods", "multi_literal32", "literal_error"),
        k7=k7_sample)
    # K7's repair passes on the sample at k = 2 and unsplit (its split
    # there is 1), from exits of which a tenth are random
    L, T, W, _ = seq_scan.seq_geometry(int(sample.shape[0]), 4)
    stiles = cs.make_word_tiles(sample, L, T // 4)
    for what, sc in k7_sample:
        for kk in (2, 1):
            seq_kernels(compare, sc, sample, stiles, f"{what} 4 MiB", False,
                        k=kk, repairs=("sub", "lane"))
    del stiles
    # on the whole corpus K7's sub-lane repair pass runs at the main path's
    # split too (k = 64: the second of a `0\.0` count's two launches); its
    # plain lane pass, which walks whole lanes, runs on the small corpora
    data = torch.from_numpy(corpus).to(dev)
    needle_kernels(data, corpus, f"{CORPUS_MIB} MiB", k5=("multiline_php",),
                   k6=("multi_literal32",),
                   k7=[("multi 0.0", seq(seq_scan.MODE_MULTI, [b"0.0"]))],
                   headline=True, k7_repairs=("sub",))
    del data
    # K7's parity chain (`aa` over b + a's: every sub-lane's match parity
    # lies beyond its warmup), pass 0 and both repair passes from pass 0's
    # own exits, at the main path's split (4) and at k = 8
    data = torch.from_numpy(parity_corpus()).to(dev)
    n = int(data.shape[0])
    sc = seq(seq_scan.MODE_MULTI, [b"aa"])
    L, T, W, _ = seq_scan.seq_geometry(n, sc.M)
    ptiles = cs.make_word_tiles(data, L, T // 4)
    for kk in (None, 8):
        seq_kernels(compare, sc, data, ptiles, "parity chain 16 MiB", False,
                    k=kk, repairs=("sub", "lane"), pick=0.0)
    del ptiles, data
    for kind in ("line_scan", "hits_scan", "seq_scan"):
        if kind not in results:
            fail(f"no {kind} comparison ran")

    # the sparse chain with 3 and 5 word payloads (line shapes, plain and
    # anchored) at the 2^26-word shape of a 1536 MiB corpus's first level
    nw = BIG_WORDS
    g = torch.Generator(device=dev).manual_seed(9)
    evw = torch.where(torch.rand(nw, device=dev, generator=g) < 0.02,
                      torch.randint(-2 ** 31, 2 ** 31 - 1, (nw,),
                                    device=dev, dtype=torch.int32,
                                    generator=g), 0).to(torch.int32)
    wpays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (nw,), device=dev,
                           dtype=torch.int32, generator=g)
             for _ in range(5)]
    u = evw.to(torch.int64) & 0xFFFFFFFF
    nbits = int(sum(((u >> k) & 1).sum() for k in range(32)))
    del u
    for P in (3, 5):
        cap = nbits + 16
        compare("chain", f"n=2^{nw.bit_length() - 1} words P={P}",
                lambda: compact2.sparse_chain_payloads(
                    evw, wpays[:P], 2 ** 31 - 1, cap),
                lambda: chain_plain(evw, wpays[:P], 2 ** 31 - 1, cap),
                reps=2)
    del evw, wpays

    # K4/K8's single pass on ragged lengths at every byte offset 0-15 of a
    # buffer whose other bytes are set (a read outside the mask would count
    # them), densities 0, 1e-3, 0.5, 1, payloads 0-4, caps under, at and
    # over the count; then the longest mask, 2^31 - 1 entries at offset 1
    ncases = compact_sweep(dev)
    print(f"[kernels] compact_pay  {ncases} small cases at byte offsets "
          f"0-15: bit-equal (tolerance 0)", flush=True)
    longest = torch.ones(LONGEST + 1, dtype=torch.uint8, device=dev)
    lmask = longest[1:]
    for lo in range(0, lmask.numel(), 1 << 28):
        hi = min(lmask.numel(), lo + (1 << 28))
        lmask[lo:hi] = torch.rand(hi - lo, device=dev, generator=g) < 1e-3
    lcap = int(lmask.sum()) + 37
    compare("compact_pay", f"n={LONGEST} offset 1 d=1e-3",
            lambda: compact2.compact_pay_cuda(lmask, [], lcap),
            lambda: k4_plain_nopay(lmask, lcap), reps=2,
            in_bytes=lmask.numel(), library=lambda: torch.nonzero(lmask))
    del longest, lmask

    # K4 on masks of several densities with 0-4 payloads (bit-31 words)
    rng = np.random.default_rng(5)
    m = 1 << 22
    pays = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, m,
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]
    for dens in (0.0, 1e-4, 0.05, 1.0):
        mask = torch.from_numpy(rng.random(m) < dens).to(dev)
        nset = int(mask.sum())
        for npay in range(5):
            for cap in {max(16, nset + 5), max(1, nset // 2)}:
                compare("compact_pay", f"d={dens} p={npay} cap={cap}",
                        lambda: compact2.compact_pay_cuda(
                            mask.view(torch.uint8), pays[:npay], cap),
                        lambda: compact2.compact_pay_plain(
                            mask.view(torch.uint8), pays[:npay], cap),
                        reps=2)
    # the level-1 chain shape of a 1536 MiB find_all: 2^26 entries, so the
    # tiles' offset carry runs across many tiles
    big = BIG_WORDS
    for dens in (1.0, 0.01):
        mask, bpays, cap = chain_level(dev, dens)
        nset = cap - 16
        for npay in (4, 3):
            # payloads are read at the set entries only
            compare("compact_pay", f"n=2^26 d={dens} p={npay}",
                    lambda: compact2.compact_pay_cuda(
                        mask.view(torch.uint8), bpays[:npay], cap),
                    lambda: compact2.compact_pay_plain(
                        mask.view(torch.uint8), bpays[:npay], cap),
                    headline=True, in_bytes=big + 4 * nset * npay,
                    library=lambda: torch.nonzero(mask))
    del bpays, mask

    # the class runs' dense branch at 1536 MiB
    runs, rcap = class_run_starts(corpus, dev)
    compare("compact_pay", f"charclass_w run starts {CORPUS_MIB} MiB",
            lambda: compact2.compact_pay_cuda(runs.view(torch.uint8), [],
                                              rcap),
            lambda: k4_plain_nopay(runs.view(torch.uint8), rcap), reps=3,
            in_bytes=runs.numel(), library=lambda: torch.nonzero(runs))
    del runs

    # K8 on 2^22-entry masks, cap overflow included, and on the start mask
    # of `\w*` over the whole corpus (n + 1 entries, cap 2^30), the shape
    # of the nullable find_all's two compactions
    for dens in (0.0, 1e-4, 0.05, 1.0):
        mask = torch.from_numpy(rng.random(m) < dens).to(dev)
        nset = int(mask.sum())
        for cap in {max(16, nset + 5), max(1, nset // 2)}:
            compare("compact_positions", f"d={dens} cap={cap}",
                    lambda: compact.compact_positions(mask, cap),
                    lambda: compact.compact_positions_plain(
                        mask.view(torch.uint8), cap), reps=2)
    # the main path's cap (the match count's bucket), then 2^30, the
    # largest cap the span limits give
    smask, scap = word_starts(corpus, dev)
    for cap in (scap, 1 << 30):
        compare("compact_positions",
                f"\\w* starts {CORPUS_MIB} MiB cap=2^{cap.bit_length() - 1}",
                lambda: compact.compact_positions(smask, cap),
                lambda: compact.compact_positions_plain(
                    smask.view(torch.uint8), cap),
                reps=3, headline=cap < 1 << 30, in_bytes=smask.numel(),
                library=lambda: torch.nonzero(smask))
    del smask

    # K9 at its split over break-at-match DFAs on the 4 MiB sample, with
    # its two repair passes (there also unsplit), then over the fwd_all DFA
    # of `\s\d\s` on the whole corpus, the shape of a FULL_SCAN is_match
    # (the repair passes are compared on the sample), then the settled scan of
    # ip's fwd_break there: an early match, so the dead cut ends it after
    # pass 0
    def match_kernel(name, kind, data, label, headline):
        n = int(data.shape[0])
        L, T, W, _ = cs.plan_geometry(n)
        k = cs.lane_split(T, W)
        tiles = cs.make_word_tiles(data, L, T // 4)
        args = match_args(name, kind, data, (L, T, W), tiles, k)
        mt = match_tables(name, kind)
        print(f"[kernels] match_scan  {label}: split k={k}, {k * L} walkers "
              f"of {T // k} bytes, table [{mt.S}, {mt.NSEG}], "
              f"{cs.resident_warps(cs.MODE_MATCH, mt.S, mt.NSEG)[0]} resident "
              f"warps an SM")
        compare("match_scan", label,
                lambda: cs.lane_walk_cuda(cs.MODE_MATCH, *args),
                lambda: cs.lane_walk_plain(cs.MODE_MATCH, *args),
                headline=headline, in_bytes=nbytes(*args))
        if not headline:
            repair_kernels("match_scan", cs.MODE_MATCH, mt,
                           lambda kk: match_args(name, kind, data, (L, T, W),
                                                 tiles, kk),
                           sorted({1, k}), label)
        return tiles

    for name in ("inner_keyword", "email", "ip"):
        match_kernel(name, "fwd_break", sample, f"{name} fwd_break 4 MiB",
                     False)
    data = torch.from_numpy(corpus).to(dev)
    tiles = match_kernel("ws_digit_ws", "fwd_all", data,
                         f"\\s\\d\\s {CORPUS_MIB} MiB", True)
    cut_case(compare, match_tables("ip", "fwd_break"), data, tiles)
    del tiles

    # the window scan, flags form and ends form: 2^12 starts read forwards
    # on the sample, then 2^16 starts over the whole corpus read backwards
    # (find_first's reverse start search) under the anchored reverse DFA of
    # `.*keyword.*`, half of them with random edge limits
    rev = ct.compile(PATTERNS["inner_keyword"], device=DEVICE) \
        .batch_engine()._chunk_scanner("rev_anch")
    g = torch.Generator(device=dev).manual_seed(11)
    for d, B, Ww, reverse in ((sample, 1 << 12, 64, False),
                              (data, 1 << 16, 256, True)):
        n = int(d.shape[0])
        starts = torch.randint(0, n + 1, (B,), generator=g, device=dev,
                               dtype=torch.int32)
        edge = torch.full((B,), n, dtype=torch.int32, device=dev)
        edge[B // 2:] = (starts[B // 2:].long() + torch.randint(
            0, 2 * Ww, (B - B // 2,), generator=g, device=dev)).clamp(
                max=n).to(torch.int32)
        wargs = dfa_scan.window_args(rev.mt, d, starts, edge, Ww, reverse)
        reads = window_reads(*wargs)
        label = (f"2^{B.bit_length() - 1} starts W={Ww} "
                 f"{'reverse' if reverse else 'forward'} {n / 2 ** 20:.0f} MiB")
        compare("window_scan", label,
                lambda: dfa_scan.window_flags_cuda(*wargs),
                lambda: dfa_scan.window_flags_plain(*wargs),
                in_bytes=reads + nbytes(starts, edge, *wargs[:4]))
        compare("window_ends", label,
                lambda: dfa_scan.window_ends_cuda(*wargs),
                lambda: dfa_scan.window_ends_plain(*wargs),
                in_bytes=reads + nbytes(starts, edge, *wargs[:4]))
    window_edge_cases(compare, rev.mt, data, g)
    # the general find_all's shapes, the window scan's headline among them
    general_kernels(compare, data, corpus)
    # the leftmost-longest general route's ends form over fwd_anch_all
    posix_kernels(compare, base, data, corpus)
    # the bitset-NFA scan on the sample, then timed on the whole corpus
    bitset_kernels(compare, results, sample, data)
    del data
    # the OnePass walk on the capture patterns' spans of the whole corpus,
    # the row scans on the ROWS lines
    capture_row_kernels(compare, base, corpus)
    # the all-entries transfer walk of the sharded scans, both modes
    transfer_kernels(compare, base, corpus)
    # the candidate pipeline's reset scan and K3's interference mode
    m5_kernels(compare, corpus)
    # the global-memory instances of K1, K2, K3, K9 and the window scan on
    # tables past shared memory
    big_table_kernels(compare, base, corpus)
    # every instance, 16-bit and int32, shared and global, on the sample;
    # then the band's residency and times
    residency_kernels(base, corpus)
    band_kernels(compare, base, corpus)

    # K10 on the compaction rig's mask (256 MiB at density 1/200, seed 11)
    # at its three row counts: R = 128 with no payload, R = 256 with two
    # payloads under cond_dma + skip_empty, R = 512; 50 launches each (0.3
    # ms ones), since 5 after the mask's host-side build left the first
    # configuration timed at three times its steady time; then tiles all
    # zero, all one and random in a seeded mix, more tiles than the
    # persistent grid has blocks
    from tools import profile_compact_torch as rig
    mask, nset, cap = rig.rig_mask(256, 1 / 200, DEVICE)
    g = torch.Generator(device=dev).manual_seed(13)
    rpays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (mask.numel(),),
                           dtype=torch.int32, device=dev, generator=g)
             for _ in range(2)]
    m8 = mask.view(torch.uint8)
    for R, npay, kw in ((128, 0, {}),
                        (256, 2, dict(cond_dma=True, skip_empty=True)),
                        (512, 0, {})):
        compare("compact_exp",
                f"256 MiB R={R} p={npay}" + (" cond+skip" if kw else ""),
                lambda: compact_exp.compact_exp_cuda(m8, rpays[:npay], cap,
                                                     R, **kw),
                lambda: compact_exp.compact_exp_plain(m8, rpays[:npay], cap),
                reps=50, headline=R == 128,
                in_bytes=mask.numel() + 4 * nset * npay,
                library=lambda: torch.nonzero(mask))
    for R, nc in ((128, 1200), (512, 300)):
        tiles = mixed_tiles(R, nc, g)
        nh = int(tiles.sum())
        tpay = [rpays[0][:tiles.numel()]]
        for kw in ({}, dict(cond_dma=True, skip_empty=True)):
            compare("compact_exp",
                    f"{nc} mixed tiles R={R} p=1" + (" cond+skip" if kw
                                                      else ""),
                    lambda: compact_exp.compact_exp_cuda(
                        tiles, tpay, nh + 16, R, **kw),
                    lambda: compact_exp.compact_exp_plain(tiles, tpay,
                                                          nh + 16), reps=3)
        del tiles, tpay
    del mask, m8, rpays
    torch.cuda.empty_cache()
    return results


def flag_args(be, data, k=None):
    """K3's pass-0 arguments on `data` as the bidi find_all of `be`'s
    pattern makes them: the reverse reset tiles with a reset at each
    reversed match end, fresh (DEAD) entries at k sub-lanes a lane (None:
    the main path's lane_split of the reset geometry); None without a bidi
    route."""
    import torch
    from coregex_tpu_torch.ops import flag_scan, span_chain
    from coregex_tpu_torch.ops.bytescan import _bucket
    from coregex_tpu_torch.ops.compact2 import _bucket_up
    ssc = be._span_scanner(True)
    rsc = be._rev_flag_scanner(True)
    if not ssc or not rsc:
        return None
    dev = data.device
    n = int(data.shape[0])
    fw, gw, total, kind, _conv = ssc.scan(data)
    total = int(total)
    capM = _bucket(total + 1, 16)
    nwb = _bucket_up(-(-n // 32))
    nwb1 = _bucket_up(-(-(n + 1) // 32))
    _e, _c, rq, _rw, _ok = span_chain.bidi_ends(
        fw, gw, n, total, int(kind), capM, nwb, nwb1)
    del fw, gw
    Lr, Tr, Wr, _ = flag_scan.reset_geometry(n)
    symt = flag_scan.scatter_reset_tiles(
        flag_scan.sym_base_tiles(torch.flip(data, [0]),
                                 rsc.byte_bounds(), Lr, Tr // 4),
        rq, Lr, Tr // 4)
    lanes = torch.arange(Lr, dtype=torch.int64, device=dev)
    if k is None:
        from coregex_tpu_torch.ops.count_scan import lane_split
        k = lane_split(Tr, Wr)
    entries = torch.full((k, Lr), flag_scan.DEAD, dtype=torch.int32,
                         device=dev)
    offs = torch.zeros(Lr, dtype=torch.int32, device=dev)
    offs[0] = Wr
    flim = (n + 1 - lanes * Tr).clamp(0, Tr).to(torch.int32)
    return (rsc.tables.packed_full, None, symt, Wr // 4, entries, offs, flim)


def match_tables(name, kind):
    """Pattern `name`'s K9 tables (dfa_scan.MatchTables) of `kind`
    (fwd_all, fwd_break)."""
    import coregex_tpu_torch as ct
    sc = ct.compile(PATTERNS[name], device=DEVICE).batch_engine() \
        ._chunk_scanner(kind)
    if sc is None:
        fail(f"{name}: no {kind} match tables")
    return sc.mt


def match_args(name, kind, data, geom, tiles, k):
    """K9's pass-0 arguments on `data` under geometry (L, T, W) at k
    sub-lanes a lane: pattern `name`'s match tables of `kind`, first-pass
    entries."""
    from coregex_tpu_torch.ops import count_scan as cs
    mt = match_tables(name, kind)
    L, T, W = geom
    e0, o0, lim = cs.first_pass_inputs(mt.starts, data, int(data.shape[0]),
                                       L, T, W, k)
    return (mt.packed, mt.segmap, tiles, W // 4, e0, o0, lim)


def line_combine(sc, data, host, T: int, pnl, outs, label: str) -> None:
    """K5's device combine (LineScanner.verdict) against the numpy
    _combine over the same sub-lane outputs, read as k*L lanes of T/k
    bytes in corpus order; fails if they differ."""
    k, L = (int(x) for x in pnl.shape)
    got = int(sc.verdict(data, T, pnl, *outs))
    flat = [x.t().reshape(-1).cpu().numpy().astype(np.int64) for x in outs]
    want = sc._combine(int(data.shape[0]), k * L, T // k, *flat, host)
    if got != want:
        fail(f"line_scan combine on {label}: device {got} != numpy {want}")
    ms = cuda_ms(lambda: sc.verdict(data, T, pnl, *outs), 5)
    print(f"[kernels] line_scan   combine {label}: device {got} == numpy "
          f"_combine over {k * L} sub-lanes (tolerance 0), {ms:.3f} ms",
          flush=True)


def cut_case(compare, mt, data, tiles) -> None:
    """The settled K9 scan (dfa_scan.match_full) of `data` at the main
    path's split, kernel against the same fixpoint over the plain walk and
    repair, for a break-at-match DFA whose first match is early: the dead
    cut must end the kernel's scan after pass 0."""
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan
    n = int(data.shape[0])
    L, T, W, _ = cs.plan_geometry(n)
    k = cs.lane_split(T, W)
    args = (mt, data, tiles, n, L, T, W, k)

    def plain():
        walk, repair = cs.lane_walk, cs.lane_repair
        cs.lane_walk = lambda mode, _c, *a: cs.lane_walk_plain(mode, *a)
        cs.lane_repair = lambda mode, _c, whole, *a: cs.lane_repair_plain(
            mode, whole, *a)
        try:
            return dfa_scan.match_full(*args)
        finally:
            cs.lane_walk, cs.lane_repair = walk, repair

    c = dfa_scan.MATCH_KERNEL
    before = c.launches
    reset_passes(c)
    dfa_scan.match_full(*args)
    launches, subs, lanes = c.launches - before, c.sub_passes, c.lane_passes
    print(f"[kernels] match_scan  ip fwd_break cut k={k}: {launches} launch, "
          f"repair passes {subs}+{lanes}", flush=True)
    if (launches, subs, lanes) != (1, 0, 0):
        fail("the dead cut did not end ip's fwd_break scan after pass 0")
    compare("match_scan", f"ip fwd_break cut k={k} {n / 2 ** 20:.0f} MiB",
            lambda: dfa_scan.match_full(*args), plain)


def general_kernels(compare, data, corpus: np.ndarray) -> None:
    r"""The general find_all of `\b\d+\b` on the whole corpus (`data` on
    the card, `corpus` on the host), each kernel at the path's shape
    against its plain version: K9 over the unanchored reverse DFA on the
    flipped corpus (pass 0 at the main path's split), K4's chain over its
    flag words (three compactions), then the window scan forward from
    every match start, W = 64 (the path's first round, one lane a start,
    no cap), with the bytes its lanes must read counted by window_reads."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import compact2, dfa_scan
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops.bytescan import _bucket
    from coregex_tpu_torch.ops.span_scan import to_global
    be = ct.compile(PATTERNS["word_digits"], device=DEVICE).batch_engine()
    route = be._full_scan_route()
    if route is None:
        fail("word_digits: no general find_all route")
    rev, fwd_mt = route
    flipped = torch.flip(data, [0])
    n = int(data.shape[0])
    geom = cs.plan_geometry(n)
    L, T, W, _ = geom
    k = cs.lane_split(T, W)
    tiles = cs.make_word_tiles(flipped, L, T // 4)
    e0, o0, lim = cs.first_pass_inputs(rev.mt.starts, flipped, n, L, T, W,
                                       k)
    args = (rev.mt.packed, rev.mt.segmap, tiles, W // 4, e0, o0, lim)
    label = f"\\b\\d+\\b rev_all {CORPUS_MIB} MiB"
    compare("match_scan", f"{label} flipped k={k}",
            lambda: cs.lane_walk_cuda(cs.MODE_MATCH, *args),
            lambda: cs.lane_walk_plain(cs.MODE_MATCH, *args),
            in_bytes=nbytes(*args))
    del args, e0, o0, lim
    scan = rev.scan_device(flipped, geom, tiles)
    del tiles, flipped
    cnt = int(dfa_scan.flags_count_upto(scan))
    words = to_global(scan.flagw, n)
    del scan
    cap = _bucket(cnt, 16)
    compare("compact_pay", f"{label} flag words ({cnt} set)",
            lambda: compact2.sparse_positions_words(words, n, cap),
            lambda: chain_plain(words, [], n, cap), reps=3,
            in_bytes=nbytes(words))
    del words
    starts, m, ok = be._all_starts(rev, corpus)
    if not bool(ok) or m != cnt + int(starts[0] == 0):
        fail("word_digits: the match starts' compaction failed")
    st = starts[:m].contiguous()
    del starts
    edge = torch.full((m,), n, dtype=torch.int32, device=data.device)
    wargs = dfa_scan.window_args(fwd_mt, data, st, edge, be.END_WINDOW)
    steps = window_steps(*wargs)
    reads = int(steps.sum())
    sectors = window_sectors(data, st, steps)
    floor_ms = (32 * sectors + nbytes(st) + 5 * m) / HBM_BYTES_PER_MS
    print(f"[kernels] window_ends {m} starts of \\b\\d+\\b: {reads} "
          f"corpus bytes read at W={be.END_WINDOW}, in {sectors} 32-byte "
          f"sectors; sector floor (those sectors, the starts, the ends and "
          f"alive bytes at 3.35 TB/s) {floor_ms:.3f} ms", flush=True)
    del steps
    label = f"{m} starts W={be.END_WINDOW} forward {CORPUS_MIB} MiB"
    compare("window_scan", label,
            lambda: dfa_scan.window_flags_cuda(*wargs),
            lambda: dfa_scan.window_flags_plain(*wargs), headline=True,
            in_bytes=reads + nbytes(st, edge, *wargs[:4]))
    eargs = dfa_scan.window_args(fwd_mt, data, st, None, be.END_WINDOW)
    compare("window_ends", label,
            lambda: dfa_scan.window_ends_cuda(*eargs, alive_u8=True),
            lambda: dfa_scan.window_ends_plain(*eargs, alive_u8=True),
            headline=True, in_bytes=reads + nbytes(st, *eargs[:4]))
    del wargs, eargs, st, edge
    torch.cuda.empty_cache()


def posix_kernels(compare, base: bytes, data, corpus: np.ndarray) -> None:
    """The window scan's ends form over fwd_anch_all, the table of the
    leftmost-longest general route, against its plain version: forward
    from every match start of POSIX_WINDOW's POSIX engine on the whole
    corpus at W = 64 (the path's first round, one lane a start), with the
    bytes its lanes must read; then one live lane of 16, the others parked
    at n, from the first `a` of the base's first MiB with its newlines made
    spaces, under POSIX_LONG_LANE's table at W = 64 x 4^k, and the round
    loop (dfa_scan.window_ends) from that lane against the host walk of the
    same table (search.anchored_last_end)."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.dfa.search import anchored_last_end
    from coregex_tpu_torch.ops import dfa_scan
    pattern = {nm: p for nm, p, _ in POSIX}
    be = ct.compile_posix(pattern[POSIX_WINDOW], device=DEVICE) \
        .batch_engine()
    route = be._full_scan_route()
    if route is None or be._verify_kind() != "fwd_anch_all":
        fail(f"posix {POSIX_WINDOW}: no general route over fwd_anch_all")
    rev, fwd_mt = route
    starts, m, ok = be._all_starts(rev, corpus)
    if not bool(ok):
        fail(f"posix {POSIX_WINDOW}: the match starts' compaction failed")
    st = starts[:m].contiguous()
    del starts
    eargs = dfa_scan.window_args(fwd_mt, data, st, None, be.END_WINDOW)
    reads = window_reads(*eargs)
    print(f"[kernels] window_ends {m} POSIX starts of {POSIX_WINDOW}: "
          f"fwd_anch_all [{fwd_mt.S}, {fwd_mt.NSEG}], {reads} corpus bytes "
          f"read at W={be.END_WINDOW}", flush=True)
    compare("window_ends", f"{m} POSIX starts W={be.END_WINDOW} "
            f"fwd_anch_all {CORPUS_MIB} MiB",
            lambda: dfa_scan.window_ends_cuda(*eargs, alive_u8=True),
            lambda: dfa_scan.window_ends_plain(*eargs, alive_u8=True),
            in_bytes=reads + nbytes(st, *eargs[:4]))
    del eargs, st
    lb = ct.compile_posix(pattern[POSIX_LONG_LANE], device=DEVICE) \
        .batch_engine()
    mt = lb._full_scan_route()[1]
    line = np.frombuffer(base[:1 << 20], np.uint8).copy()
    line[line == ord("\n")] = ord(" ")
    d1 = torch.from_numpy(line).to(DEVICE)
    n1 = len(line)
    s0 = int(np.flatnonzero(line == ord("a"))[0])
    one = torch.full((16,), n1, dtype=torch.int32, device=DEVICE)
    one[0] = s0
    for k in range(4):
        W = 64 * 4 ** k
        a = dfa_scan.window_args(mt, d1, one, None, W)
        compare("window_ends", f"one POSIX lane of 16 W={W} fwd_anch_all",
                lambda: dfa_scan.window_ends_cuda(*a),
                lambda: dfa_scan.window_ends_plain(*a),
                in_bytes=nbytes(one, *a[:4]) + min(W, n1 - s0))
    ends, rounds = dfa_scan.window_ends(mt, d1, one[:1].clone(),
                                        lb.END_WINDOW)
    want = anchored_last_end(lb._dense("fwd_anch_all"), line, s0)
    if int(ends[0]) != want or rounds < 5:
        fail(f"posix {POSIX_LONG_LANE}: the round loop's end "
             f"{int(ends[0])} in {rounds} rounds != the host walk's {want}")
    print(f"[kernels] window_ends one POSIX lane over {n1} bytes from {s0}:"
          f" end {want} in {rounds} rounds equals the host walk", flush=True)
    del d1, one
    torch.cuda.empty_cache()


def m5_kernels(compare, corpus: np.ndarray) -> None:
    """The reset scan (cgx_lane_reset, the lane walk's reset mode) against
    its plain version at the main path's geometry: the first reset subset
    of a pattern's candidates (every second run start through the sieve,
    as _interleaved_ends' K = 2 gives it) scattered into the pad-byte word
    tiles, pass 0 over the whole corpus in one launch, then a sub-lane and
    a lane repair pass from exits of which a tenth are random states, for
    M5_SCAN (timed: the kernels line's headline) and M5_WIDE at the same
    size, and on the first 4 MiB for M5_GLOBAL, whose table the kernel
    reads from global memory; bound: the tiles and tables read, the flag
    words and sub-lane outputs written.  Then K3 in its interference mode
    (flag_pre_reset False) over M5_INNER's suffix DFA from a reset at each
    candidate + k, at the reset geometry's lane_split, against its plain
    version."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import flag_scan, span_chain
    from coregex_tpu_torch.ops.bytescan import table_to_ranges
    from coregex_tpu_torch.ops.compact import compact_positions
    pats = {nm: (p, posix) for nm, p, posix, _o in M5}
    pats[M5_GLOBAL[0]] = (M5_GLOBAL[1], True)
    data = torch.from_numpy(corpus).to(DEVICE)
    n = len(corpus)

    def reset_args(name, d):
        """The scan's pass-0 arguments on d's first K = 2 subset, with
        its table."""
        p, posix = pats[name]
        be = (ct.compile_posix if posix else ct.compile)(
            p, device=DEVICE).batch_engine()
        sc = be._reset_scanner()
        if sc is None:
            fail(f"m5 {name}: no reset scanner")
        m = int(d.shape[0])
        smask, cnt = be._prefix_run_candidates_mask(d)
        cand, _c = compact_positions(smask, int(cnt) + 16)
        del smask
        base = sc.tiles(sc.packed(d, pad=1))
        L, T, W = sc.geometry(m + 1)
        k = cs.lane_split(T, W)
        tiles = flag_scan.scatter_reset_tiles(base, cand[:int(cnt)][0::2],
                                              L, T // 4)
        del base, cand
        offs = torch.zeros(L, dtype=torch.int32, device=DEVICE)
        offs[0] = W
        lim = (m + 1 - torch.arange(L, device=DEVICE, dtype=torch.int64)
               * T).clamp(0, T).to(torch.int32)
        S, C = (int(x) for x in sc.walk.packed.shape)
        vb = sc.walk.packed.element_size()
        warps, threads = cs.resident_warps(cs.MODE_RESET, S, C, vb)
        print(f"[kernels] reset_scan  {name} POSIX: {int(cnt)} candidates, "
              f"K = 2 subset 0; table [{S}, {C}] {vb * 8}-bit "
              f"({cs.lane_instance(cs.MODE_RESET, S, C, vb)} memory), "
              f"{warps} resident warps an SM in blocks of {threads}; "
              f"L={L} T={T} W={W} k={k}: one launch a pass", flush=True)
        return sc.walk, (sc.walk.packed, sc.walk.segmap, tiles, W // 4,
                         torch.full((k, L), cs.DEAD, dtype=torch.int32,
                                    device=DEVICE), offs, lim)

    for name, d, headline in ((M5_SCAN, data, True), (M5_WIDE, data, False),
                              (M5_GLOBAL[0], data[:4 << 20], False)):
        walk, args = reset_args(name, d)
        label = f"{name} {int(d.shape[0]) / 2 ** 20:.0f} MiB"
        compare("reset_scan", f"{label} pass 0",
                lambda: cs.lane_walk_cuda(cs.MODE_RESET, *args),
                lambda: cs.lane_walk_plain(cs.MODE_RESET, *args),
                headline=headline, in_bytes=nbytes(*args))
        run = repair_case(cs.MODE_RESET, walk, args)
        for whole in (False, True):
            compare("reset_scan",
                    f"{label} {'lane' if whole else 'sub-lane'} pass",
                    lambda: run(cs.lane_repair_cuda, whole),
                    lambda: run(cs.lane_repair_plain, whole), reps=2)
        del args, run
        torch.cuda.empty_cache()
    # K3's interference mode at the main path's geometry
    p, posix = pats[M5_INNER]
    be = ct.compile_posix(p, device=DEVICE).batch_engine()
    (table, m, _M), fsc = be._inner_route()
    lit = bytes(be.plan.split.lit)
    syms = span_chain.inner_cand_symbols(
        data, table_to_ranges(table), lit, m, fsc.byte_bounds())[3]
    Lr, Tr, Wr, _ = flag_scan.reset_geometry(n)
    k = cs.lane_split(Tr, Wr)
    tiles = cs.make_word_tiles(syms, Lr, Tr // 4)
    del syms
    lanes = torch.arange(Lr, dtype=torch.int64, device=DEVICE)
    offs = torch.zeros(Lr, dtype=torch.int32, device=DEVICE)
    offs[0] = Wr
    fargs = (fsc.tables.packed_full, None, tiles, Wr // 4,
             torch.full((k, Lr), flag_scan.DEAD, dtype=torch.int32,
                        device=DEVICE), offs,
             (n + 1 - lanes * Tr).clamp(0, Tr).to(torch.int32))
    compare("flag_scan", f"interference mode {M5_INNER} suffix k={k}",
            lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fargs),
            lambda: cs.lane_walk_plain(cs.MODE_FLAG, *fargs),
            in_bytes=nbytes(*fargs))
    del fargs, tiles, data
    torch.cuda.empty_cache()


def big_cut(base: bytes) -> bytes:
    """The base's first BIG_CUT bytes, to the last full line."""
    return base[:base.rfind(b"\n", 0, BIG_CUT) + 1]


def big_words(tile: bytes, n: int, lower: bool):
    """n words: the tile's distinct words (lower: its lowercase words,
    else every whitespace-separated token, escaped), then seeded random
    lowercase words of 4-9 letters."""
    if lower:
        out = sorted({w.decode() for w in re.findall(rb"[a-z]+", tile)})
    else:
        out = sorted({re.escape(w.decode()) for w in tile.split()})
    rng = np.random.default_rng(BIG_SEED)
    seen = set(out)
    while len(out) < n:
        w = "".join(chr(97 + int(c)) for c in
                    rng.integers(0, 26, int(rng.integers(4, 10))))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out[:n]


def big_patterns(tile: bytes):
    """(name, pattern, POSIX) of each BIG entry, its words from `tile`."""
    return [(name, tmpl if words is None else
             tmpl.format("|".join(big_words(tile, *words))), posix)
            for name, words, tmpl, posix in BIG]


def padded(t, rows: int):
    """t [S, ...] with zero rows appended to `rows` rows: a table whose
    extra states no walk reaches."""
    import torch
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def big_table_kernels(compare, base: bytes, corpus: np.ndarray) -> None:
    """The global-memory instances of K1, K2, K3 (and its interference
    mode), K9 and both window-scan forms against their plain versions at
    the main path's shape (1536 MiB, k = 64), with the two repair passes
    of K1, K2, K3 and K9 on a 4 MiB sample at its split: first the
    headline tables (ip's count and span tables, ip's reverse flag table,
    `\\s\\d\\s` fwd_all, `\\b\\d+\\b`'s anchored forward table from its match
    starts at W = 64) padded with unreachable zero rows past shared memory,
    the same walk in both instances, each timed beside its shared-memory
    instance; then the BIG_KERNELS tables (count, span from the minimized
    span-event transducer, fwd_all, the general route's anchored forward
    table from its first BIG_WINDOW_STARTS match starts), the big
    lowercase list's reverse flag table (K3 over the reverse reset tiles of
    its bidi find_all) and INNER60's suffix table in K3's interference
    mode, each in the instance its residency picks (16-bit values bring
    KW400's lane-walk tables and INNER60's suffix back to shared memory).
    The global instances' headlines (the kernels line) are KW_HUGE's lane
    walks, the big lowercase list's K3 and KW400's window scan."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan, flag_scan, span_chain
    from coregex_tpu_torch.ops.bytescan import table_to_ranges
    from coregex_tpu_torch.ops.span_scan import DeviceSpanDFA
    tile = big_cut(base)
    pats = {nm: (p, posix) for nm, p, posix in big_patterns(tile)}
    data = torch.from_numpy(corpus).to(DEVICE)
    n = len(corpus)
    geom = cs.plan_geometry(n)[:3]
    L, T, W = geom
    k = cs.lane_split(T, W)
    tiles = cs.make_word_tiles(data, L, T // 4)
    sample = data[:4 << 20]
    sgeom = cs.plan_geometry(int(sample.shape[0]))[:3]
    sk = cs.lane_split(sgeom[1], sgeom[2])
    stiles = cs.make_word_tiles(sample, sgeom[0], sgeom[1] // 4)

    def padded_walk(d, mode):
        """A lane walk's tables (packed, segmap, starts, sot) with the
        packed table widened to int32 and padded past shared memory."""
        rows = (cs.SMEM_LIMIT // 4 - (0 if mode == cs.MODE_FLAG else 256)) \
            // int(d.packed.shape[1]) + 1
        return SimpleNamespace(packed=padded(cs.wide(d.packed),
                                             max(rows, cs.MAX16_ROWS + 1))
                               .contiguous(),
                               segmap=d.segmap, sot=d.sot,
                               starts=getattr(d, "starts", None))

    def walk(kind, mode, d, label, headline=False, args=None, sargs=None):
        """Pass 0 on the whole corpus (args; default: split_args), then
        the repair passes on the sample (sargs); returns pass 0's ms."""
        print(f"[big] {kind:11} {label}: table "
              f"{residency_text(mode, d.packed)}", flush=True)
        if args is None:
            args = split_args(d, data, geom, tiles, k)
        ms = compare(kind, f"{label} k={int(args[4].shape[0])}",
                     lambda: cs.lane_walk_cuda(mode, *args),
                     lambda: cs.lane_walk_plain(mode, *args),
                     headline=headline, in_bytes=nbytes(*args))
        if sargs is None and mode != cs.MODE_FLAG:
            sargs = split_args(d, sample, sgeom, stiles, sk)
        if sargs is not None:
            run = repair_case(mode, d, sargs)
            for whole in (False, True):
                compare(kind, f"{label} 4 MiB k={int(sargs[4].shape[0])} "
                        f"{'lane' if whole else 'sub-lane'} pass",
                        lambda: run(cs.lane_repair_cuda, whole),
                        lambda: run(cs.lane_repair_plain, whole), reps=2)
        return ms

    def ends(kind, mt, st, label, headline=False):
        """Both window forms forward from starts st at W = 64 over mt's
        tables (packed, segmap, eoi, starts)."""
        wargs = (mt.packed, mt.segmap, mt.eoi, mt.starts, data, False, st,
                 None, 64)
        reads = window_reads(*wargs)
        print(f"[big] window{kind} {label}: table "
              f"{residency_text(None, mt.packed)}, {int(st.shape[0])} "
              f"starts, {reads} corpus bytes read at W=64", flush=True)
        inb = reads + nbytes(st, *wargs[:4])
        ms = [compare(f"window_scan{kind}", label,
                      lambda: dfa_scan.window_flags_cuda(*wargs),
                      lambda: dfa_scan.window_flags_plain(*wargs),
                      headline=headline, in_bytes=inb),
              compare(f"window_ends{kind}", label,
                      lambda: dfa_scan.window_ends_cuda(*wargs,
                                                        alive_u8=True),
                      lambda: dfa_scan.window_ends_plain(*wargs,
                                                         alive_u8=True),
                      headline=headline, in_bytes=inb)]
        return ms

    def engine(name):
        p, posix = pats[name] if name in pats else (PATTERNS[name], False)
        return (ct.compile_posix if posix else ct.compile)(
            p, device=DEVICE).batch_engine()

    # the headline tables, padded: the same walk in both instances
    ip = engine("ip")
    sc, ssc = ip._count_scanner_ascii(), ip._span_scanner(True)
    mt = match_tables("ws_digit_ws", "fwd_all")
    for kind, mode, d, label in (
            ("count_scan", cs.MODE_COUNT, sc.dcd, "ip"),
            ("span_scan", cs.MODE_SPAN, ssc.dsd, "ip"),
            ("match_scan", cs.MODE_MATCH, mt, "\\s\\d\\s fwd_all")):
        args = split_args(d, data, geom, tiles, k)
        shared = cuda_ms(lambda: cs.lane_walk_cuda(mode, *args), 5)
        pd = padded_walk(d, mode)
        pargs = (pd.packed,) + args[1:]
        ms = walk(f"{kind}_global", mode, pd, f"{label} padded "
                  f"{CORPUS_MIB} MiB", args=pargs)
        print(f"[big] {kind:11} {label}: shared-memory instance "
              f"{shared:.3f} ms, global {ms:.3f} ms on the same walk",
              flush=True)
        del args, pargs
    fargs = flag_args(ip, data)
    shared = cuda_ms(lambda: cs.lane_walk_cuda(cs.MODE_FLAG, *fargs), 5)
    pd = padded_walk(flag_scan.FlagWalk(fargs[0]), cs.MODE_FLAG)
    pfargs = (pd.packed,) + fargs[1:]
    ms = walk("flag_scan_global", cs.MODE_FLAG, pd,
              f"ip reverse padded {CORPUS_MIB} MiB", args=pfargs)
    print(f"[big] flag_scan   ip reverse: shared-memory instance "
          f"{shared:.3f} ms, global {ms:.3f} ms on the same walk", flush=True)
    del fargs, pfargs
    wd = engine("word_digits")
    rev, fwd_mt = wd._full_scan_route()
    starts, m, _ok = wd._all_starts(rev, corpus)
    st = starts[:m].contiguous()
    del starts
    eargs = dfa_scan.window_args(fwd_mt, data, st, None, 64)
    shared = cuda_ms(lambda: dfa_scan.window_ends_cuda(*eargs), 5)
    rows = max(cs.SMEM_LIMIT // 4 // fwd_mt.NSEG + 1, cs.MAX16_ROWS + 1)
    pmt = SimpleNamespace(packed=padded(cs.wide(fwd_mt.packed),
                                        rows).contiguous(),
                          segmap=fwd_mt.segmap, starts=fwd_mt.starts,
                          eoi=padded(fwd_mt.eoi, rows).contiguous())
    _flags_ms, ends_ms = ends("_global", pmt, st,
                              f"\\b\\d+\\b padded {m} starts")
    print(f"[big] window_ends \\b\\d+\\b: shared-memory instance "
          f"{shared:.3f} ms, global {ends_ms:.3f} ms on the same walk",
          flush=True)
    del st, eargs, ip, sc, ssc, mt
    # tables past shared memory
    for name in BIG_KERNELS:
        t0 = time.perf_counter()
        be = engine(name)
        csc = be._count_scanner_ascii()
        S = int(csc.span_cd_raw.delta.shape[0])
        if name == "KW_HUGE" and S < BIG_HUGE_STATES:
            fail(f"KW_HUGE's count transducer has {S} states")
        span = DeviceSpanDFA.from_host(csc.span_cd_raw.minimized(), DEVICE)
        chunk = be._chunk_scanner("fwd_all")
        route = be._full_scan_route()
        print(f"[big] {name}: count transducer of {S} states, tables built "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        for kind, mode, d in (("count_scan", cs.MODE_COUNT, csc.dcd),
                              ("span_scan", cs.MODE_SPAN, span),
                              ("match_scan", cs.MODE_MATCH, chunk.mt)):
            glob = cs.lane_instance(mode, *d.packed.shape,
                                    d.packed.element_size()) == "global"
            if name == "KW_HUGE" and not glob:
                fail(f"{name}: its {kind} table takes shared memory")
            walk(kind + ("_global" if glob else ""), mode, d,
                 f"{name} {CORPUS_MIB} MiB", headline=glob)
        rev, fwd_mt = route
        starts, m, _ok = be._all_starts(rev, corpus)
        st = starts[:min(m, BIG_WINDOW_STARTS)].contiguous()
        del starts
        if dfa_scan.window_fits(fwd_mt.S, fwd_mt.NSEG,
                                fwd_mt.packed.element_size()):
            fail(f"{name}: its window table takes shared memory")
        ends("_global", fwd_mt, st, f"{name} {int(st.shape[0])} of {m} "
             f"starts", headline=name == BIG_KERNELS[0])
        del st, span, chunk, route, rev, fwd_mt, csc, be
        torch.cuda.empty_cache()
    # K3 past shared memory: KWL600's reverse flag scan, INNER60's suffix
    be = engine("KWL600")
    fargs = flag_args(be, data)
    if cs.lane_instance(cs.MODE_FLAG, *fargs[0].shape,
                        fargs[0].element_size()) != "global":
        fail("KWL600: its reverse flag table takes shared memory")
    fw = flag_scan.FlagWalk(fargs[0])
    sfargs = flag_args(be, sample)
    walk("flag_scan_global", cs.MODE_FLAG, fw,
         f"KWL600 reverse {CORPUS_MIB} MiB", headline=True, args=fargs,
         sargs=sfargs)
    del fargs, sfargs, be
    be = engine("INNER60")
    (table, mm, _M), fsc = be._inner_route()
    syms = span_chain.inner_cand_symbols(
        data, table_to_ranges(table), bytes(be.plan.split.lit), mm,
        fsc.byte_bounds())[3]
    Lr, Tr, Wr, _ = flag_scan.reset_geometry(n)
    kr = cs.lane_split(Tr, Wr)
    rtiles = cs.make_word_tiles(syms, Lr, Tr // 4)
    del syms
    lanes = torch.arange(Lr, dtype=torch.int64, device=DEVICE)
    offs = torch.zeros(Lr, dtype=torch.int32, device=DEVICE)
    offs[0] = Wr
    iargs = (fsc.tables.packed_full, None, rtiles, Wr // 4,
             torch.full((kr, Lr), flag_scan.DEAD, dtype=torch.int32,
                        device=DEVICE), offs,
             (n + 1 - lanes * Tr).clamp(0, Tr).to(torch.int32))
    glob = cs.lane_instance(cs.MODE_FLAG, *iargs[0].shape,
                            iargs[0].element_size()) == "global"
    walk("flag_scan" + ("_global" if glob else ""), cs.MODE_FLAG,
         flag_scan.FlagWalk(fsc.tables.packed_full),
         f"interference mode INNER60 suffix {CORPUS_MIB} MiB", args=iargs)
    del iargs, rtiles, tiles, stiles, data, sample
    torch.cuda.empty_cache()


def band_patterns(tile: bytes):
    """(name, pattern) of `\\b(?:w1|...|wN)\\b` over big_words(tile, N)
    for each N of BAND_WORDS (N = 400 is BIG's KW400)."""
    return [(f"KW{n}", r"\b(?:{})\b".format("|".join(
        big_words(tile, n, False)))) for n in BAND_WORDS]


def band_tables(be, dev):
    """(kind, lane-walk mode or None for the window scan, tables with
    .packed) of each table a keyword list's routes take or could take:
    count (K1), span (K2, the minimized span-event transducer), flag (K3,
    the pre-reset flag table of the minimized anchored reverse DFA), fwd_all
    (K9), rev_all (K9 of the general find_all) and ends (the window scan's
    anchored break table from the general find_all's starts).  Works on a
    checkout whose tables are all int32 too (tools/time_lane_torch.py
    --root)."""
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import flag_scan
    from coregex_tpu_torch.ops.span_scan import DeviceSpanDFA
    csc = be._count_scanner_ascii()
    ft = flag_scan.ResetFlagTables.from_host(
        be._dense("rev_anch_ascii").minimized(), 3, dev, flag_pre_reset=True)
    rev, fwd = be._full_scan_route()
    return [("count", cs.MODE_COUNT, csc.dcd),
            ("span", cs.MODE_SPAN,
             DeviceSpanDFA.from_host(csc.span_cd_raw.minimized(), dev)),
            ("flag", cs.MODE_FLAG, flag_scan.FlagWalk(ft.packed_full)),
            ("fwd_all", cs.MODE_MATCH, be._chunk_scanner("fwd_all").mt),
            ("rev_all", cs.MODE_MATCH, rev.mt), ("ends", None, fwd)]


def table_residency(mode, packed, starts=None):
    """(bytes, place, threads a block, resident warps an SM, the model's
    warps or None, stage slice or None) of a table as this checkout stores
    and launches it; place: "global", or "shared" with the width of its
    values there.  The lane walk's warps by count_scan.resident_warps (the
    occupancy calculator) beside count_scan.lane_warps (the model that
    picks the place); the window scan's (ends form) by the occupancy
    calculator beside its one block's warps, in the plan of the source
    (which must equal dfa_scan.window_plan) for `starts` = (n, B, W)
    (None: starts that want the larger stage slice).  A checkout before 16-bit tables: int32,
    128-thread lane-walk blocks, the window scan's 256-thread blocks by
    its fixed layout (8 warps of 3 x 2048-byte stage slices)."""
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan
    S, nseg = (int(x) for x in packed.shape)
    eb = packed.element_size()
    nb = S * nseg * eb

    def place(width):
        return f"shared {width * 8}-bit" if width else "global"
    if not hasattr(cs, "value_bytes"):      # before 16-bit tables
        if mode is not None:
            warps, threads = cs.resident_warps(mode, S, nseg)
            return (nb, place(4 * cs.table_fits(S, nseg, mode)), threads,
                    warps, None, None)
        shared = dfa_scan.window_fits(S, nseg)
        smem = (((S * nseg if shared else 0) + 256 + 3) & ~3) * 4 \
            + 8 * 3 * 2048
        blocks = min(8, 233472 // (-(-smem // 128) * 128 + 1024))
        return nb, place(4 * shared), 256, blocks * 8, None, 2048
    if mode is None:
        n, B, W = starts or (1 << 30, 1, 64)
        p, resident = dfa_scan.window_plan_cuda(S, nseg, eb, n, B, W)
        host = dfa_scan.window_plan(S, nseg, eb,
                                    dfa_scan.window_stage(n, B, W))
        if host != p:
            fail(f"window plan [{S}, {nseg}] {eb * 8}-bit: the source's "
                 f"{tuple(p)}, the host's {tuple(host)}")
        return (nb, place(p.width), dfa_scan.WINDOW_THREADS, resident,
                dfa_scan.WINDOW_THREADS // 32, p.stage)
    width = eb if cs.table_fits(S, nseg, mode, eb) else 0
    warps, threads = cs.resident_warps(mode, S, nseg, eb)
    model = cs.lane_warps(cs.lane_smem_bytes(mode, S, nseg, width))
    return nb, place(width), threads, warps, model, None


def residency_text(mode, packed, starts=None) -> str:
    nb, where, th, warps, model, stage = table_residency(mode, packed,
                                                         starts)
    return (f"[{', '.join(str(int(x)) for x in packed.shape)}] "
            f"{packed.element_size() * 8}-bit {nb} bytes, {where}, "
            f"{th} threads, {warps} resident warps"
            + (f" (model {model})" if model is not None else "")
            + (f", {stage}-byte stage slices" if stage else ""))


def band_inputs(be, data, corpus, geom, tiles, k):
    """K1's (count) and K9's (fwd_all) pass-0 arguments over the corpus,
    and the window ends form's over the general find_all's first
    BAND_STARTS match starts at W = 64 (with their match count m)."""
    from coregex_tpu_torch.ops import dfa_scan
    rev, fwd = be._full_scan_route()
    starts, m, _ok = be._all_starts(rev, corpus)
    st = starts[:min(m, BAND_STARTS)].contiguous()
    del starts
    return (split_args(be._count_scanner_ascii().dcd, data, geom, tiles, k),
            split_args(be._chunk_scanner("fwd_all").mt, data, geom, tiles,
                       k),
            dfa_scan.window_args(fwd, data, st, None, 64), m)


def band_kernels(compare, base: bytes, corpus: np.ndarray) -> dict:
    """The band: keyword lists `\\b(?:...)\\b` of BAND_WORDS words.  For
    each list every mode's table (count, span, flag, fwd_all, rev_all, the
    window scan's ends table for the starts below): shape, bytes, place,
    block size and resident warps (the occupancy calculator beside the
    model that picks the place, which must agree); then pass 0 of K1
    (count) and K9 (fwd_all) over the whole corpus and the window ends form
    from the general find_all's first BAND_STARTS starts, each bit-equal
    to its plain version, timed beside its bound.  Fails if a table of a
    list keeps fewer than BAND_MIN_WARPS warps an SM.  Returns {name: (K1
    ms, K9 ms, ends ms)}."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan
    t0 = time.perf_counter()
    data = torch.from_numpy(corpus).to(DEVICE)
    L, T, W, _ = cs.plan_geometry(len(corpus))
    k = cs.lane_split(T, W)
    tiles = cs.make_word_tiles(data, L, T // 4)
    out = {}
    for name, pattern in band_patterns(big_cut(base)):
        t1 = time.perf_counter()
        be = ct.compile(pattern, device=DEVICE).batch_engine()
        tabs = band_tables(be, DEVICE)
        build = time.perf_counter() - t1
        kargs, margs, wargs, m = band_inputs(be, data, corpus, (L, T, W),
                                             tiles, k)
        starts = (len(corpus), int(wargs[6].shape[0]), wargs[8])
        for kind, mode, t in tabs:
            _nb, _where, _th, warps, model, _st = table_residency(
                mode, t.packed, starts)
            print(f"[band] {name:6} {kind:7} "
                  f"{residency_text(mode, t.packed, starts)}", flush=True)
            # the lane walk's model is the occupancy calculator's rule; the
            # window scan's block must stay resident whole
            if warps != model if mode is not None else warps < model:
                fail(f"band {name} {kind}: the occupancy calculator keeps "
                     f"{warps} warps, the model {model}")
            if warps < BAND_MIN_WARPS:
                fail(f"band {name} {kind}: {warps} resident warps")
        ms = []
        for kind, mode, args in (("count_scan", cs.MODE_COUNT, kargs),
                                 ("match_scan", cs.MODE_MATCH, margs)):
            glob = cs.lane_instance(mode, *args[0].shape,
                                    args[0].element_size()) == "global"
            ms.append(compare(kind + ("_global" if glob else ""),
                              f"{name} {CORPUS_MIB} MiB k={k}",
                              lambda: cs.lane_walk_cuda(mode, *args),
                              lambda: cs.lane_walk_plain(mode, *args),
                              reps=BAND_REPS, in_bytes=nbytes(*args)))
        glob = not dfa_scan.window_fits(*wargs[0].shape,
                                        wargs[0].element_size())
        ms.append(compare("window_ends" + ("_global" if glob else ""),
                          f"{name} {int(wargs[6].shape[0])} of {m} starts",
                          lambda: dfa_scan.window_ends_cuda(*wargs,
                                                            alive_u8=True),
                          lambda: dfa_scan.window_ends_plain(*wargs,
                                                             alive_u8=True),
                          reps=BAND_REPS,
                          in_bytes=window_reads(*wargs)
                          + nbytes(wargs[6], *wargs[:4])))
        out[name] = tuple(ms)
        print(f"[band] {name:6} K1 {ms[0]:.3f} ms, K9 fwd_all {ms[1]:.3f} "
              f"ms, ends {ms[2]:.3f} ms (tables {build:.1f} s)", flush=True)
        del kargs, margs, wargs, tabs, be
        torch.cuda.empty_cache()
    del tiles, data
    torch.cuda.empty_cache()
    print(f"[band] kernels {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def residency_kernels(base: bytes, corpus: np.ndarray) -> None:
    """Every lane-walk and window-scan instance against its plain version
    (run once a table and pass, bit-equal: tolerance 0) on the 4 MiB sample
    at its split: for the headline tables (ip's count,
    span and reverse flag tables, `\\s\\d\\s` fwd_all, `\\b\\d+\\b`'s
    window table), each band list's count, span, flag (over the flipped
    sample's reset-free symbols) and fwd_all tables and KW_HUGE's count and
    fwd_all tables, the table as packed (16-bit where it has at most
    MAX16_ROWS rows) and widened to int32, each in global memory and in
    shared memory at every value width its room allows (the wrappers'
    `place`): pass 0 and both repair passes; the window ends form likewise
    from the sample's general find_all starts (window_ends_cuda's
    `width`)."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan, flag_scan
    t0 = time.perf_counter()
    sample = torch.from_numpy(corpus[:4 << 20]).to(DEVICE)
    n = int(sample.shape[0])
    L, T, W, _ = cs.plan_geometry(n)
    k = cs.lane_split(T, W)
    tiles = cs.make_word_tiles(sample, L, T // 4)
    Lr, Tr, Wr, _ = flag_scan.reset_geometry(n)
    kr = cs.lane_split(Tr, Wr)

    def variants(mode, packed):
        """(label, table, width) of each place a table can take, for the
        table as packed and widened to int32: global memory (width 0) and
        shared memory where its room allows, the lane walk's at the table's
        own width, the window scan's at each width (4: int32, a 16-bit
        table widened)."""
        S, nseg = (int(x) for x in packed.shape)
        forms = [("int32", cs.wide(packed))]
        if packed.dtype == torch.int16:
            forms.insert(0, ("16-bit", packed))
        for label, t in forms:
            vb = t.element_size()
            for width in (0, vb) if mode is not None else (0, 2, 4):
                smem = (cs.lane_smem_bytes(mode, S, nseg, width)
                        if mode is not None else dfa_scan.window_smem_bytes(
                            width, S, nseg, dfa_scan.WINDOW_STAGES[-1]))
                if width == 0 or (width >= vb and smem <= cs.SMEM_LIMIT):
                    where = ("global" if not width else "shared"
                             if width == vb else "shared as int32")
                    yield f"{label} {where}", t, width

    checked = [0]

    def same(kind, label, got, want):
        err = max_abs_err(got, want)
        if err:
            fail(f"{kind} {label} differs from its plain version (max abs "
                 f"err {err})")
        checked[0] += 1

    def lane(name, kind, mode, d, args):
        run = repair_case(mode, d, args)
        want = [cs.lane_walk_plain(mode, *args)] + [
            run(cs.lane_repair_plain, whole) for whole in (False, True)]
        for label, t, width in variants(mode, d.packed):
            a = (t,) + args[1:]
            place = "shared" if width else "global"
            same(kind, f"{name} {label} 4 MiB k={k}",
                 cs.lane_walk_cuda(mode, *a, place=place), want[0])
            for i, whole in enumerate((False, True)):
                same(kind, f"{name} {label} "
                     f"{'lane' if whole else 'sub-lane'} pass",
                     run(functools.partial(cs.lane_repair_cuda, place=place),
                         whole, t), want[1 + i])
        print(f"[residency] {kind:11} {name}: pass 0 and both repair "
              f"passes bit-equal in "
              f"{', '.join(lb for lb, _t, _w in variants(mode, d.packed))}",
              flush=True)

    def window(name, mt, st):
        wargs = dfa_scan.window_args(mt, sample, st, None, 64)
        want = dfa_scan.window_ends_plain(*wargs)
        for label, t, width in variants(None, mt.packed):
            same("window_ends", f"{name} {label}",
                 dfa_scan.window_ends_cuda(t, *wargs[1:], width=width), want)
        print(f"[residency] window_ends {name} ({int(st.shape[0])} starts): "
              f"bit-equal in "
              f"{', '.join(lb for lb, _t, _w in variants(None, mt.packed))}",
              flush=True)

    def flag_inputs(packed, bounds):
        lanes = torch.arange(Lr, dtype=torch.int64, device=DEVICE)
        offs = torch.zeros(Lr, dtype=torch.int32, device=DEVICE)
        offs[0] = Wr
        return (packed, None, flag_scan.sym_base_tiles(
            torch.flip(sample, [0]), bounds, Lr, Tr // 4), Wr // 4,
            torch.full((kr, Lr), flag_scan.DEAD, dtype=torch.int32,
                       device=DEVICE), offs,
            (n + 1 - lanes * Tr).clamp(0, Tr).to(torch.int32))

    ip = ct.compile(PATTERNS["ip"], device=DEVICE).batch_engine()
    for kind, mode, d in (
            ("count_scan", cs.MODE_COUNT, ip._count_scanner_ascii().dcd),
            ("span_scan", cs.MODE_SPAN, ip._span_scanner(True).dsd),
            ("match_scan", cs.MODE_MATCH, match_tables("ws_digit_ws",
                                                       "fwd_all"))):
        lane("ip" if mode != cs.MODE_MATCH else "\\s\\d\\s", kind, mode, d,
             split_args(d, sample, (L, T, W), tiles, k))
    fargs = flag_args(ip, sample)
    lane("ip reverse", "flag_scan", cs.MODE_FLAG,
         flag_scan.FlagWalk(fargs[0]), fargs)
    wd = ct.compile(PATTERNS["word_digits"], device=DEVICE).batch_engine()
    rev, fwd = wd._full_scan_route()
    starts, m, _ok = wd._all_starts(rev, corpus[:n])
    window("\\b\\d+\\b", fwd, starts[:m].contiguous())
    pats = dict(band_patterns(big_cut(base)))
    pats["KW_HUGE"] = dict((nm, p) for nm, p, _ in
                           big_patterns(big_cut(base)))["KW_HUGE"]
    for name, pattern in pats.items():
        be = ct.compile(pattern, device=DEVICE).batch_engine()
        tabs = band_tables(be, DEVICE)
        for kind, mode, d in tabs:
            if name == "KW_HUGE" and kind not in ("count", "fwd_all"):
                continue
            if kind == "rev_all":
                continue
            if mode is None:
                starts, m, _ok = be._all_starts(be._full_scan_route()[0],
                                                corpus[:n])
                window(name, d, starts[:m].contiguous())
                continue
            kern = {cs.MODE_COUNT: "count_scan", cs.MODE_SPAN: "span_scan",
                    cs.MODE_FLAG: "flag_scan",
                    cs.MODE_MATCH: "match_scan"}[mode]
            if mode == cs.MODE_FLAG:
                bounds = tuple(int(b) for b in
                               dfa_scan.DFATables.from_dense(
                                   be._dense("rev_anch_ascii").minimized())
                               .bounds if 0 < int(b) < 256)
                args = flag_inputs(d.packed, bounds)
            else:
                args = split_args(d, sample, (L, T, W), tiles, k)
            lane(name, kern, mode, d, args)
        del tabs, be
    del tiles, sample
    torch.cuda.empty_cache()
    print(f"[residency] {checked[0]} kernel outputs bit-equal to their "
          f"plain versions in {time.perf_counter() - t0:.1f} s", flush=True)


def bitset_args(d, data, geom, tiles, k):
    """The bitset scan's pass-0 arguments on `data` under geometry (L, T, W)
    at k sub-lanes a lane, as nfa_scan.bitset_full makes them, and the
    exact entry of sub-lane (0, 0)."""
    from coregex_tpu_torch.ops import nfa_scan as ns
    L, T, W = geom
    n = int(data.shape[0])
    e0, o0, lim, first = ns.first_inputs(d, data, n, L, T, W, k)
    return (d, tiles, W // 4, e0, o0, lim, n), first


def bitset_repair_case(d, args, first):
    """A bitset repair pass's inputs: pass 0's plain outputs on `args`, with
    random sets (of the NFA's S states) as the exits of a tenth of the
    sub-lanes.  Returns run(fn, whole): the sub-lane (whole=False) or lane
    pass through fn on fresh copies, giving (exits, counts, sync, flagw,
    last, walked)."""
    import torch
    from coregex_tpu_torch.ops import nfa_scan as ns
    counts, exits, sync, fw, last = ns.bitset_walk_plain(*args)
    dev = exits.device
    k, L, NW = (int(x) for x in exits.shape)
    g = torch.Generator(device=dev).manual_seed(31)
    pick = torch.rand((k, L), device=dev, generator=g) < 0.1
    rnd = torch.randint(-2 ** 62, 2 ** 62, (k * L, NW), device=dev,
                        generator=g)
    rnd = ns.pack_sets(ns.unpack_sets(rnd, d.S)).view(k, L, NW)
    prev = torch.where(pick[..., None], rnd, exits).contiguous()
    _d, tiles, _w4, _e0, _o0, lim, n = args

    def run(fn, whole):
        out = [torch.empty_like(prev), counts.clone(), sync.clone(),
               fw.clone(), last.clone(),
               torch.zeros(1, dtype=torch.int32, device=dev)]
        fn(d, whole, tiles, n, lim, first, prev, *out)
        return out
    return run


# the bitset scan whose lane pass (one thread walking a lane's k
# sub-lanes) is also held at the main path's k: find_all's scan, with the
# widest sets (NW = 7).  Its plain version steps one byte a torch step
# over the whole lane of 196,608 bytes, tens of seconds a scan on an H100,
# so the other scans' lane passes are held unsplit on the sample only
BITSET_MAIN_LANE_PASS = (("nfa_u_z", "rev"),)
BITSET_SLICE_LANES = 16
# the scan also held to its plain version on the whole corpus beside the
# headline's: the look path with two start groups (Gs = 2)
BITSET_WHOLE_LOOK = ("nfa_word_digits_b", "rev")


def idle_corpora(n: int, dev):
    """Two n-byte corpora at the bitset scan's extremes: lowercase letters
    only (seed 17), on which the walkers are busy on most bytes, and spaces
    with one newline, on which every walker's set stays its seed."""
    import torch
    lower = np.random.default_rng(17).integers(ord("a"), ord("z") + 1, n,
                                               dtype=np.uint8)
    blank = np.full(n, ord(" "), dtype=np.uint8)
    blank[n // 2] = ord("\n")
    return [(name, torch.from_numpy(x).to(dev))
            for name, x in (("lowercase", lower), ("blank", blank))]


def bitset_kernels(compare, results, small, data) -> None:
    r"""cgx_bitset_scan against its plain version (nfa_scan's
    bitset_walk_plain, bitset_repair_plain), bit-equal (flag words,
    counts, last flags, exit and warmup sets), for the forward scan and
    the reverse scan over the flipped corpus of each BITSET pattern: pass
    0 and both repair passes from exits of which a tenth are random,
    unsplit on the 4 MiB sample (`small`, on the card) and on the two
    corpora of its size from idle_corpora (every walker busy on most
    bytes; every walker idle), and at the main path's shape (the whole
    corpus's T, W and k = lane_split) on its first BITSET_SLICE_LANES
    lanes (the lane pass there for the scan of BITSET_MAIN_LANE_PASS).
    Then on the whole corpus (`data` on the card) pass 0, timed, with its
    kernel's registers, spills and resident warps, and the settled scan
    with its repair passes and launches.  The reverse scan of the first
    pattern (find_all's and find_index's scan) is also held to the plain
    version on the whole corpus: the line of the kernels takes its ms,
    plain ms and bound from that one input; so is BITSET_WHOLE_LOOK's."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import nfa_scan as ns
    idle = idle_corpora(int(small.shape[0]), small.device)
    for name, pattern in BITSET:
        be = ct.compile(pattern, device=DEVICE).batch_engine()
        for kind in ("fwd", "rev"):
            sc = be._bitset_scanner(kind)
            if not sc:
                fail(f"{name}: no {kind} bitset scanner")
            d = sc.d
            info = ns.kernel_info(d)
            for big in (False, True):
                x = data if big else small
                x = x if kind == "fwd" else torch.flip(x, [0])
                n = int(x.shape[0])
                L, T, W, _ = cs.plan_geometry(n)
                k = cs.lane_split(T, W)
                label = f"{name} {kind} {n / 2 ** 20:.0f} MiB"
                if big:
                    Ls = BITSET_SLICE_LANES
                    y, case = x[:Ls * T], (f"{label} lanes 0-{Ls - 1} "
                                           f"k={k}", Ls, k)
                else:
                    smem = ns.smem_bytes(d.S, d.NW, d.G, d.Gs, d.ascii_word)
                    print(f"[kernels] bitset_scan {label}: S={d.S} "
                          f"NW={d.NW} G={d.G} Gs={d.Gs} mode={d.mode}, "
                          f"shared memory {smem} B, "
                          f"{info.registers} registers, {info.spill_bytes} "
                          f"spill bytes, {info.warps} resident warps an SM",
                          flush=True)
                    y, case = x, (f"{label} k=1", L, 1)
                cases = [case + (y,)]
                if not big:
                    cases += [(f"{name} {kind} {what} {n / 2 ** 20:.0f} "
                               f"MiB k=1", L, 1,
                               z if kind == "fwd" else torch.flip(z, [0]))
                              for what, z in idle]
                for lab, Ly, kk, y in cases:
                    ty = cs.make_word_tiles(y, Ly, T // 4)
                    args, first = bitset_args(d, y, (Ly, T, W), ty, kk)
                    compare("bitset_scan", lab,
                            lambda: ns.bitset_walk_cuda(*args),
                            lambda: ns.bitset_walk_plain(*args), reps=3,
                            in_bytes=nbytes(y))
                    run = bitset_repair_case(d, args, first)
                    for whole in (False, True):
                        if whole and big and (name, kind) \
                                not in BITSET_MAIN_LANE_PASS:
                            continue
                        t0 = time.perf_counter()
                        compare("bitset_scan", f"{lab} "
                                f"{'lane' if whole else 'sub-lane'} pass",
                                lambda: run(ns.bitset_repair_cuda, whole),
                                lambda: run(ns.bitset_repair_plain, whole))
                        if big:
                            print(f"[kernels] bitset_scan {lab} "
                                  f"{'lane' if whole else 'sub-lane'} pass "
                                  f"checked in "
                                  f"{time.perf_counter() - t0:.1f} s",
                                  flush=True)
                    del args, ty, run
                del y, cases
                if not big:
                    continue
                tiles = cs.make_word_tiles(x, L, T // 4)
                args, _first = bitset_args(d, x, (L, T, W), tiles, k)
                head = name == BITSET[0][0] and kind == "rev"
                if head or (name, kind) == BITSET_WHOLE_LOOK:
                    t0 = time.perf_counter()
                    ms = compare("bitset_scan", f"{label} k={k}",
                                 lambda: ns.bitset_walk_cuda(*args),
                                 lambda: ns.bitset_walk_plain(*args),
                                 reps=3, headline=head, in_bytes=n)
                    print(f"[kernels] bitset_scan {label} k={k}: checked "
                          f"in {time.perf_counter() - t0:.1f} s",
                          flush=True)
                else:
                    ms = cuda_ms(lambda: ns.bitset_walk_cuda(*args), 3)
                bound = (n + nbytes(*ns.bitset_walk_cuda(*args))) \
                    / HBM_BYTES_PER_MS
                c = ns.BITSET_KERNEL
                before = c.launches
                reset_passes(c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scan = sc.scan_device(x, (L, T, W), tiles, k)
                flags = int(scan.counts.sum())
                settled_ms = (time.perf_counter() - t0) * 1e3
                print(f"[kernels] bitset_scan {label} k={k} (L={L} T={T} "
                      f"W={W}): pass 0 {ms:.3f} ms (bound {bound:.3f} ms, "
                      f"{ms / bound:.1f}x; {info.registers} registers, "
                      f"{info.spill_bytes} spill bytes, {info.warps} "
                      f"resident warps an SM); settled scan "
                      f"{settled_ms:.1f} ms, {c.launches - before} "
                      f"launches, repair passes {passes(c)}, {flags} flags",
                      flush=True)
                del args, scan, tiles
            del x
            torch.cuda.empty_cache()


def split_args(d, data, geom, tiles, k):
    """K1's or K2's pass-0 arguments on `data` under geometry (L, T, W) at
    k sub-lanes a lane (k = None: the unsplit walk of a checkout that has
    no split), as the count and span scans make them."""
    from coregex_tpu_torch.ops import count_scan as cs
    L, T, W = geom
    n = int(data.shape[0])
    if k is None:
        e0, o0, lim = cs.first_pass_inputs(d.starts, data, n, L, T, W)
    else:
        e0, o0, lim = cs.first_pass_inputs(d.starts, data, n, L, T, W, k)
    return (d.packed, d.segmap, tiles, W // 4, e0, o0, lim)


def repair_case(mode, d, args):
    """A lane walk repair pass's inputs: pass 0's outputs on `args`, whose
    exits are replaced by random states at a tenth of the sub-lanes, so
    their successors walk.  Returns run(fn, whole, packed=None): the
    sub-lane (whole=False) or lane pass through fn (lane_repair_cuda or
    lane_repair_plain) on fresh copies, over d.packed or another form of
    it, giving (exits, counts, sync, flagw, aux, walked)."""
    import torch
    from coregex_tpu_torch.ops import count_scan as cs
    counts, exits, sync, fw, aux = cs.lane_walk_plain(mode, *args)
    dev = exits.device
    g = torch.Generator(device=dev).manual_seed(29)
    pick = torch.rand(exits.shape, device=dev, generator=g) < 0.1
    prev = torch.where(pick, torch.randint(
        0, int(d.packed.shape[0]), exits.shape, device=dev, generator=g,
        dtype=torch.int32), exits).contiguous()
    tiles, lim = args[2], args[6]

    def run(fn, whole, packed=None):
        out = [torch.empty_like(prev), counts.clone(), sync.clone(),
               None if fw is None else fw.clone(),
               None if aux is None else aux.clone(),
               torch.zeros(1, dtype=torch.int32, device=dev)]
        fn(mode, whole, d.packed if packed is None else packed, d.segmap,
           tiles, d.sot, lim, prev, *out)
        return out
    return run


def seq_kernels(compare, sc, data, tiles, label, headline, k=None,
                repairs=(), pick=0.1):
    """K7 (SeqScanner `sc`) on `data` under its geometry with word tiles
    `tiles`: pass 0 at k sub-lanes a lane (lane_split's when None) against
    its plain version, then the repair passes named in `repairs` ("sub",
    "lane") from pass 0's exits, of which a share `pick` are random."""
    import torch
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import seq_scan
    n = int(data.shape[0])
    L, T, W, _ = seq_scan.seq_geometry(n, sc.M)
    W = min(max(W, 4 * sc.M + 4), T)
    k = cs.lane_split(T, W) if k is None else k
    e0, o0, lim, entry0 = sc.first_pass(data, n, L, T, W, k)
    args = (sc.mode, sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen, tiles,
            W // 4, e0, o0, lim)
    img = seq_scan.needle_image(data.device)
    compare("seq_scan", f"{label} k={k}",
            lambda: seq_scan.seq_lanes_cuda(*args, img=img),
            lambda: seq_scan.seq_lanes_plain(*args),
            headline=headline, in_bytes=nbytes(*args))
    if not repairs:
        return
    counts, exits, sync, clean = seq_scan.seq_lanes_plain(*args)
    dev = exits.device
    g = torch.Generator(device=dev).manual_seed(31)
    top = 13 if sc.mode == seq_scan.MODE_MULTI else 256
    prev = torch.where(
        torch.rand(exits.shape, device=dev, generator=g) < pick,
        torch.randint(0, top, exits.shape, device=dev, generator=g,
                      dtype=torch.int32), exits).contiguous()

    def run(fn, whole):
        out = [torch.empty_like(prev), counts.clone(), sync.clone(),
               clean.clone(), torch.zeros(1, dtype=torch.int32, device=dev)]
        fn(sc.mode, whole, sc.tbl, sc.lens, sc.jh, sc.anchored, sc.plen,
           tiles, entry0, lim, prev, *out, img)
        return out

    for kind in repairs:
        whole = kind == "lane"
        compare("seq_scan", f"{label} k={k} "
                f"{'lane' if whole else 'sub-lane'} pass",
                lambda: run(seq_scan.seq_repair_cuda, whole),
                lambda: run(seq_scan.seq_repair_plain, whole), reps=2)


def parity_corpus() -> np.ndarray:
    """16 MiB of b then a's: `aa`'s match parity at each lane start lies
    beyond any warmup."""
    arr = np.full(16 << 20, ord("a"), dtype=np.uint8)
    arr[0] = ord("b")
    return arr


QUOTES = r'"[^"]*"'


def quote_corpus() -> np.ndarray:
    """16 MiB (less a remainder) of `"` + 299 x."""
    return np.frombuffer((b'"' + b"x" * 299) * ((16 << 20) // 300),
                         dtype=np.uint8).copy()


def quote_parity(eng=None):
    r"""Quote parity: `"[^"]*"` counted over quote_corpus(), whose in-quote
    state reaches back to the corpus start, so the lane seams settle one
    lane a pass.  Returns (count, its known value, best of 2 ms, sub-lane
    passes, lane passes, K1 launches) of the last call."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    arr = quote_corpus()
    eng = eng or ct.compile(QUOTES, device=DEVICE)
    c = cs.COUNT_KERNEL
    eng.count(arr)
    best = float("inf")
    for _ in range(2):
        reset_passes(c)
        launches = c.launches
        t0 = time.perf_counter()
        got = eng.count(arr)
        best = min(best, time.perf_counter() - t0)
        launches = c.launches - launches
    return (got, len(arr) // 600, best * 1e3, c.sub_passes, c.lane_passes,
            launches)


def k4_plain_nopay(mask8, cap: int):
    """K4's plain version with no payloads, in K8's bounded chunks (the
    unchunked one holds over 25 bytes of transients per entry): (pos, cnt,
    ok)."""
    from coregex_tpu_torch.ops import compact
    pos, cnt = compact.compact_positions_plain(mask8, cap)
    return pos, cnt, cnt <= cap


def compact_sweep(dev) -> int:
    """cgx_compact (through compact_pay_cuda and compact_positions) against
    its plain versions on masks of ragged lengths around the tile and
    sub-tile sizes, at each byte offset 0-15 of a buffer set outside the
    mask.  Differences are summed on the device and checked once per
    length; fails on any.  Returns the number of cases."""
    import torch
    from coregex_tpu_torch.ops import compact, compact2
    T = compact2.TILE
    ns = (1, 15, 16, 17, 4095, 4096, 4097, T - 1, T, T + 1, 3 * T + 77)
    g = torch.Generator(device=dev).manual_seed(17)
    pays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (max(ns),),
                          dtype=torch.int32, device=dev, generator=g)
            for _ in range(4)]
    cases = 0
    for n in ns:
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for dens in (0.0, 1e-3, 0.5, 1.0):
            m = (torch.rand(n, device=dev, generator=g) < dens).to(
                torch.uint8) * torch.randint(1, 256, (n,), device=dev,
                                             generator=g, dtype=torch.uint8)
            buf = torch.ones(n + 32, dtype=torch.uint8, device=dev)
            cnt = int((m != 0).sum())
            for off in range(16):
                buf.fill_(1)
                buf[off:off + n] = m
                mask8 = buf[off:off + n]
                for cap in sorted({max(1, cnt - 1), max(1, cnt), cnt + 37}):
                    for npay in range(5):
                        pv = [p[:n] for p in pays[:npay]]
                        k = compact2.compact_pay_cuda(mask8, pv, cap)
                        p = compact2.compact_pay_plain(mask8, pv, cap)
                        for x, y in zip(k, p):
                            if x.shape != y.shape or x.dtype != y.dtype:
                                fail(f"compact_pay: shape/dtype differs at "
                                     f"n={n} offset {off}")
                            bad += (x != y).sum()
                        cases += 1
                    k = compact.compact_positions(mask8, cap)
                    p = compact.compact_positions_plain(mask8, cap)
                    bad += sum((x != y).sum() for x, y in zip(k, p))
                    cases += 1
        if int(bad):
            fail(f"compact kernel differs from its plain version at n={n} "
                 f"({int(bad)} entries)")
    return cases


def window_steps(packed, segmap, eoi, starts_tbl, data, reverse, starts,
                 edge, W):
    """[B] int64: the corpus bytes each lane of a window scan must read, one
    for each step it takes while it lives inside its window (the walk of
    dfa_scan.window_flags_plain, counting steps)."""
    import torch
    from coregex_tpu_torch.ops.count_scan import _byte_ctx
    n = int(data.shape[0])
    nseg = int(packed.shape[1])
    tbl, seg = packed.reshape(-1).long(), segmap.long()
    if packed.dtype == torch.int16:     # 16-bit values
        tbl &= 0xFFFF

    def byte_at(j):
        j = j.clamp(0, n - 1)
        return data[n - 1 - j if reverse else j].long()

    st0 = starts.long()
    cut = n if edge is None else edge.long().clamp(max=n)
    s = starts_tbl.long()[torch.where(st0 == 0, 0,
                                      _byte_ctx(byte_at(st0 - 1)))]
    steps = torch.zeros_like(st0)
    for t in range(W):
        pos = st0 + t
        step = (pos < cut) & (s != 0)         # DEAD is state 0
        steps += step
        s = torch.where(step, tbl[s * nseg + seg[byte_at(pos)]] >> 5, 0)
    return steps


def window_reads(*args) -> int:
    """Corpus bytes a window scan must read (window_steps summed)."""
    return int(window_steps(*args).sum())


def window_sectors(data, starts, steps) -> int:
    """Distinct 32-byte device-memory sectors holding the bytes that
    forward lanes from ascending `starts` read: each lane's context byte
    and its `steps` bytes."""
    import torch
    off = data.data_ptr() % 32
    st = starts.long()
    first = st - (st > 0).long() + off
    last = torch.where(steps > 0, st + steps - 1, st - 1).clamp(min=0) + off
    lo, hi = first // 32, torch.maximum(last // 32, first // 32)
    reach = torch.cummax(hi, 0).values
    prev = torch.cat([reach.new_full((1,), -1), reach[:-1]])
    return int((hi - torch.maximum(lo, prev + 1) + 1).clamp(min=0).sum())


def window_edge_cases(compare, mt, data, g) -> None:
    """The ends form on a corpus of n % 16 != 0 bytes at byte offset 3 of
    the corpus (so not 16-byte aligned) with starts at 0, 1, n - 1 and n,
    forward and reverse, with no edge and with an idx scatter into a wider
    out; then one live lane of 16, the others parked at n, reverse from
    corpus byte 12345 at W = 64 * 4^k, as find_first's reverse start
    search launches it."""
    import torch
    from coregex_tpu_torch.ops import dfa_scan
    dev = data.device
    odd = data[3:3 + (1 << 20) + 5]
    n = int(odd.shape[0])
    B = 4096
    st = torch.randint(0, n + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    st[:4] = torch.tensor([0, 1, n - 1, n], dtype=torch.int32)
    idx = torch.randperm(B + 100, generator=g, device=dev)[:B].to(
        torch.int32)
    for reverse in (False, True):
        for W in (16, 64):
            a = dfa_scan.window_args(mt, odd, st, None, W, reverse)
            label = (f"n={n} at offset 3 W={W} "
                     f"{'reverse' if reverse else 'forward'}")
            compare("window_ends", label,
                    lambda: dfa_scan.window_ends_cuda(*a),
                    lambda: dfa_scan.window_ends_plain(*a))

            def scatter(fn):
                out = torch.full((B + 100,), -7, dtype=torch.int32,
                                 device=dev)
                return fn(*a, idx=idx, out=out)
            compare("window_ends", label + " idx",
                    lambda: scatter(dfa_scan.window_ends_cuda),
                    lambda: scatter(dfa_scan.window_ends_plain))
    n = int(data.shape[0])
    one = torch.full((16,), n, dtype=torch.int32, device=dev)
    one[0] = n - 12345
    for k in range(4):
        a = dfa_scan.window_args(mt, data, one, None, 64 * 4 ** k, True)
        compare("window_ends", f"one live lane of 16 W={64 * 4 ** k}",
                lambda: dfa_scan.window_ends_cuda(*a),
                lambda: dfa_scan.window_ends_plain(*a))


def mixed_tiles(R: int, nc: int, g):
    """A uint8 mask of nc tiles of R * 128 entries on the card, each all
    zero, all one or random at density 1/100, drawn from generator g."""
    import torch
    ch = R * 128
    dev = g.device
    kind = torch.randint(0, 3, (nc,), generator=g, device=dev)
    rnd = torch.rand((nc, ch), generator=g, device=dev) < 0.01
    tiles = torch.where((kind == 2)[:, None], rnd, (kind == 1)[:, None])
    return tiles.to(torch.uint8).reshape(-1)


def chain_plain(evw, wpays, n: int, cap: int):
    """Plain sparse chain: the set-bit positions of the event words in
    order, each with its word's payloads; slots past the count hold n and
    0 (the contract of compact2.sparse_chain_payloads)."""
    import torch
    dev = evw.device
    widx = torch.nonzero(evw != 0).reshape(-1)
    w = evw[widx].to(torch.int64) & 0xFFFFFFFF
    r, c = torch.nonzero((w[:, None] >> torch.arange(32, device=dev)) & 1,
                         as_tuple=True)
    cnt = int(r.numel())
    k = min(cnt, cap)
    pos = torch.full((cap,), n, dtype=torch.int32, device=dev)
    pos[:k] = (widx[r[:k]] * 32 + c[:k]).to(torch.int32)
    pays = []
    for q in wpays:
        o = torch.zeros(cap, dtype=torch.int32, device=dev)
        o[:k] = q[widx[r[:k]]]
        pays.append(o)
    return (pos, *pays, torch.tensor(cnt, dtype=torch.int32, device=dev),
            torch.tensor(cnt <= cap, device=dev))


def chain_level(dev, dens: float):
    """K4's input at the sparse chain's first level of a 1536 MiB find_all:
    a BIG_WORDS-entry mask at density dens, four int32 payloads and the cap
    (count + 16).  Its headline case takes d = 0.01 and three payloads."""
    import torch
    mask = torch.rand(BIG_WORDS, device=dev) < dens
    pays = [torch.randint(-2 ** 31, 2 ** 31 - 1, (BIG_WORDS,),
                          dtype=torch.int32, device=dev) for _ in range(4)]
    return mask, pays, int(mask.sum()) + 16


def class_run_starts(corpus: np.ndarray, dev):
    """K4's input on the class runs' dense branch: the unpacked run-start
    mask of charclass_w over `corpus`, and the main path's cap for it (the
    run count's bucket)."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import span_chain
    from coregex_tpu_torch.ops.bytescan import _bucket, table_to_ranges
    data = torch.from_numpy(corpus).to(dev)
    cc = ct.compile(PATTERNS["charclass_w"], device=DEVICE) \
        .batch_engine().plan.charclass
    ws, _we, nruns, _ne = span_chain.class_run_words(
        data, table_to_ranges(np.array(cc.table, dtype=bool)), 1)
    del data, _we
    return (span_chain.unpack_words(ws, int(corpus.shape[0])),
            _bucket(int(nruns), 16))


def word_starts(corpus: np.ndarray, dev):
    r"""K8's input on the nullable find_all of `\w*`: its start mask over
    `corpus` (n + 1 entries), and the main path's cap for it (the match
    count's bucket)."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import span_chain
    from coregex_tpu_torch.ops.bytescan import _bucket
    core = ct.compile(r"\w*", device=DEVICE).batch_engine()._core()
    table = np.array(core.batch_engine().plan.charclass.table, dtype=bool)
    data = torch.from_numpy(corpus).to(dev)
    smask, _emask = span_chain.nullable_class_masks(data, table)
    return smask, _bucket(int(smask.sum()), 16)


def bench_corpus(base: bytes) -> np.ndarray:
    """The base tiled to CORPUS_MIB (whole tiles, so line-aligned)."""
    reps = (CORPUS_MIB * 1024 * 1024) // len(base)
    return np.tile(np.frombuffer(base, dtype=np.uint8), reps)


def phase_e2e(base: bytes, arr: np.ndarray):
    """Counts and find_all at corpus scale through the public API."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan, seq_scan
    from coregex_tpu_torch.ops.count_scan import plan_geometry
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    B = len(base)
    reps = len(arr) // B
    n = len(arr)
    print(f"[e2e] corpus {n} bytes = {reps} line-aligned tiles of {B}")
    engines = []
    routes = {}     # host_routes of each pattern's slice calls
    rng = np.random.default_rng(123)
    for name, pattern in CONFIGS + EXTRA_COUNTS:
        spans0 = oracle_spans(pattern, base)
        m0 = len(spans0)
        eng = ct.compile(pattern, device=DEVICE)
        engines.append((name, eng))
        got, best, first = timed_count(eng, arr)
        if got != reps * m0:
            fail(f"{name}: count {got} != oracle {reps * m0}")
        be = eng.batch_engine()
        route = be._count_route(arr)[0]
        line = (f"[e2e] {name:16} {eng.strategy:13} count {got:>10} ok  "
                f"{n / best / 1e9:7.2f} GB/s ({best * 1e3:.1f} ms via "
                f"{route}, first {first:.2f} s, K1 repair passes "
                f"{passes(count_scan.COUNT_KERNEL)}"
                + (f", K7 repair passes {passes(seq_scan.SEQ_KERNEL)}"
                   if route == "hits" else "") + ")")
        if name in REROUTED:
            # the same count through K1, the count transducer; these
            # launches are a comparison, not the main path's
            k1_launches = count_scan.COUNT_KERNEL.launches
            sc1 = be._count_scanner_for(True)
            geom = plan_geometry(n)
            dev, tiles = device_corpus(arr, DEVICE), be._word_tiles(
                arr, *geom[:2])
            k1_best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got1 = sc1.count(dev, geom, tiles)
                k1_best = min(k1_best, time.perf_counter() - t0)
            count_scan.COUNT_KERNEL.launches = k1_launches
            if got1 != got:
                fail(f"{name}: K1 count {got1} != {got}")
            line += (f" | K1 {n / k1_best / 1e9:7.2f} GB/s "
                     f"({k1_best * 1e3:.1f} ms)")
        if name in FIND_ALL:
            line += " | " + check_find_all(
                name, be, arr, tiled_digest(spans0, [], B, reps, rng))
        print(line, flush=True)
        routes[name] = eng.batch_engine().host_routes
    # exact spans through the public API on a slice
    sreps = (SLICE_MIB * 1024 * 1024) // B
    sl = arr[:sreps * B]
    for name, eng in engines:
        if name not in FIND_ALL:
            continue
        spans0 = oracle_spans(PATTERNS[name], base)
        exp = [(s + t * B, e + t * B) for t in range(sreps)
               for s, e in spans0]
        got = eng.find_all_index(sl)
        routes[name] += eng.batch_engine().host_routes
        if [tuple(x) for x in got] != exp:
            fail(f"{name}: find_all_index on the {len(sl)}-byte slice "
                 f"differs from the oracle")
        print(f"[e2e] {name:16} find_all_index on {len(sl)} bytes: "
              f"{len(got)} spans equal the oracle")
    # the repair's worst case: a state that reaches back to the corpus start
    eng = ct.compile(QUOTES, device=DEVICE)
    got, want, ms, subs, lanes, launches = quote_parity(eng)
    if got != want:
        fail(f"quote parity: count {got} != {want}")
    print(f"[e2e] quote parity {QUOTES} on 16 MiB: count {got} ok  "
          f"{ms:.1f} ms, K1 repair passes {subs} over sub-lanes + {lanes} "
          f"over lanes, {launches} launches", flush=True)
    routes["quote parity"] = eng.batch_engine().host_routes
    return routes


def check_find_all(name, be, arr: np.ndarray, exp, kernels=None,
                   walls=None) -> str:
    """Device find_all of arr (first call, then best of 2) against an
    expected tiled_digest; returns the report, with the repair passes of
    the last call of `kernels` ((label, counter) pairs; K2's and K3's when
    None).  The best wall in seconds goes into `walls` under name."""
    import torch
    n = len(arr)
    cnt_e, ss_e, es_e, sidx, samp_e = exp
    sidx_d = torch.from_numpy(sidx).to(DEVICE)

    def run():
        r = be.find_all_spans_device(arr, defer_ok=True)
        if r is None:
            fail(f"{name}: find_all declined")
        spans, cnt, ok = r
        cnt = int(cnt)
        ok = True if ok is None else bool(ok)
        return (cnt, ok,
                int(spans[:cnt, 0].sum(dtype=torch.int64)) % M32,
                int(spans[:cnt, 1].sum(dtype=torch.int64)) % M32,
                spans[sidx_d].cpu().numpy().astype(np.int64))

    from coregex_tpu_torch.ops.dfa_scan import MATCH_KERNEL
    from coregex_tpu_torch.ops.flag_scan import FLAG_KERNEL
    from coregex_tpu_torch.ops.span_scan import SPAN_KERNEL
    if kernels is None:
        kernels = [("K2", SPAN_KERNEL), ("K3", FLAG_KERNEL)]
    t0 = time.perf_counter()
    res = run()
    fa_first = time.perf_counter() - t0
    fa_best = float("inf")
    for _ in range(2):
        for c in (SPAN_KERNEL, FLAG_KERNEL, MATCH_KERNEL) + tuple(
                c for _, c in kernels):
            reset_passes(c)
        t0 = time.perf_counter()
        res = run()
        fa_best = min(fa_best, time.perf_counter() - t0)
    cnt, ok, ss, es, samp = res
    if not ok or cnt != cnt_e or ss != ss_e or es != es_e:
        fail(f"{name}: find_all digest ({cnt}, {ok}, {ss}, {es}) "
             f"!= oracle ({cnt_e}, True, {ss_e}, {es_e})")
    if not (samp == samp_e).all():
        fail(f"{name}: sampled spans differ from the oracle")
    if walls is not None:
        walls[name] = fa_best
    return (f"find_all {cnt} spans digest+64 samples ok  "
            f"{n / fa_best / 1e9:7.2f} GB/s ({fa_best * 1e3:.1f} ms, "
            f"first {fa_first:.2f} s, repair passes "
            + ", ".join(f"{lb} {passes(c)}" for lb, c in kernels) + ")")


def timed_count(eng, arr: np.ndarray, counters=()):
    """(count, best of 2 seconds, first call seconds); the K1 and K7
    counters' repair passes, and those of `counters`, are those of the
    last call."""
    from coregex_tpu_torch.ops.count_scan import COUNT_KERNEL
    from coregex_tpu_torch.ops.seq_scan import SEQ_KERNEL
    t0 = time.perf_counter()
    got = eng.count(arr)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(2):
        for c in (COUNT_KERNEL, SEQ_KERNEL) + tuple(counters):
            reset_passes(c)
        t0 = time.perf_counter()
        eng.count(arr)
        best = min(best, time.perf_counter() - t0)
    return got, best, first


def limit_reps(inner, tail, B: int, reps: int) -> int:
    """The most whole tiles (at most reps) of the largest corpus the
    general nullable path serves: n <= DEVICE_SPANS_LIMIT and a span total
    (from the tile's tiled_spans) <= MAX_DEVICE_SPANS."""
    from coregex_tpu_torch.meta.batch import BatchEngine
    reps = min(reps, BatchEngine.DEVICE_SPANS_LIMIT // B)
    while reps * len(inner) + len(tail) > BatchEngine.MAX_DEVICE_SPANS:
        reps -= 1
    return reps


def sized_reps(size: str, inner, tail, B: int, arr: np.ndarray) -> int:
    """Whole tiles of a case's corpus: all of arr ("full"), the largest
    corpus the span limits admit ("limit") or SLICE_MIB ("slice")."""
    reps = len(arr) // B
    if size == "limit":
        return limit_reps(inner, tail, B, reps)
    if size == "slice":
        return min(reps, (SLICE_MIB << 20) // B)
    return reps


def route_stats(be, route) -> str:
    """The general find_all's match starts and window rounds of the last
    call (a nullable pattern's: its core's), where that route ran."""
    if route[0] == "nullable":
        be = route[1][0]
    if be.full_scan_stats is None:
        return ""
    m, rounds = be.full_scan_stats
    return f", {m} starts, {rounds} window rounds"


def phase_e2e_class_nullable(base: bytes, arr: np.ndarray,
                             cases=CLASS_NULLABLE, oracles=None):
    """Class-run and nullable count and find_all through the public API,
    against the Go-rule oracle of the base tile scaled by the tile count
    (the scaling checked, for the nullable patterns, across the seam of
    the tile and the next tile's first API_BYTES); find_all_index through
    the API on the corpus's first API_BYTES against the oracle on those
    bytes; each case's oracle of the base tile goes into `oracles` by
    name."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops.count_scan import COUNT_KERNEL
    from coregex_tpu_torch.ops.dfa_scan import MATCH_KERNEL
    from coregex_tpu_torch.utils import corpus_cache

    B = len(base)
    rng = np.random.default_rng(321)
    routes = {}
    for name, pattern, size in cases:
        spans0 = oracle_spans(pattern, base)
        if oracles is not None:
            oracles[name] = spans0
        inner, tail = tiled_spans(spans0, B, 1)
        nullable = bool(tail) or any(s == e for s, e in inner)
        head = base[:base.index(b"\n", API_BYTES) + 1]
        head_spans = oracle_spans(pattern, head)
        if nullable:
            # the next tile's matches restart at the seam as in a tile of
            # their own (away from the head's cut end)
            cut = B + len(head) - 4096
            seam = oracle_spans(pattern, base + head)
            if [sp for sp in seam if sp[1] <= cut] != inner + [
                    (s + B, e + B) for s, e in head_spans if e + B <= cut]:
                fail(f"{name}: the tiled oracle differs from the Go-rule "
                     f"oracle across a seam")
        reps = sized_reps(size, inner, tail, B, arr)
        if size == "limit":
            corpus_cache.clear()
        corpus = arr[:reps * B]
        n = len(corpus)
        inner, tail = tiled_spans(spans0, B, reps)
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(corpus)
        if route is None:
            fail(f"{name}: find_all is not routed to the device")
        exp = tiled_digest(inner, tail, B, reps, rng)
        got, best, first = timed_count(eng, corpus)
        if got != exp[0]:
            fail(f"{name}: count {got} != oracle {exp[0]}")
        line = (f"[e2e] {name:12} {eng.strategy:13} {n} bytes "
                f"({reps} tiles), find_all route {route[0]}: count "
                f"{got:>10} ok {n / best / 1e9:7.2f} GB/s "
                f"({best * 1e3:.1f} ms, first {first:.2f} s, K1 repair "
                f"passes {passes(COUNT_KERNEL)}) | "
                + check_find_all(name, be, corpus, exp)
                + route_stats(be, route)
                + (f", K9 repair passes {passes(MATCH_KERNEL)}"
                   if route_stats(be, route) else ""))
        print(line, flush=True)
        # exact spans through the public API on the corpus's head
        got = eng.find_all_index(arr[:len(head)])
        if got != head_spans:
            fail(f"{name}: find_all_index on {len(head)} bytes differs "
                 f"from the oracle")
        print(f"[e2e] {name:12} find_all_index on {len(head)} bytes: "
              f"{len(got)} spans equal the oracle", flush=True)
        del got
        routes[f"{name} find_all"] = be.host_routes
    return routes


def first_spans(inner, tail, B: int, reps: int, k: int):
    """The first k spans of the tiled span list, built only that far."""
    out, t = [], 0
    while len(out) < k and t < reps:
        out.extend((s + t * B, e + t * B) for s, e in inner)
        t += 1
    if t == reps:
        out.extend(tail)
    return out[:k]


def phase_e2e_general(base: bytes, arr: np.ndarray):
    """The general find_all slice through the public API: count and find_all
    of the GENERAL patterns against the tiled oracle (as the class-run and
    nullable phase), the launches of each kernel in one warm find_all, and
    find_all_index with limits 3 and 2^20 for one pattern of each route
    (general, class split, nullable, ALL_EMPTY) against the oracle's first
    spans."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import compact, compact2, dfa_scan

    oracles = {}
    routes = phase_e2e_class_nullable(base, arr, GENERAL, oracles)
    B = len(base)
    kernels = (dfa_scan.MATCH_KERNEL, dfa_scan.WINDOW_ENDS_KERNEL,
               compact2.COMPACT_KERNEL, compact.COMPACT_POS_KERNEL)
    for name, pattern, size in GENERAL:
        spans0 = oracles.pop(name)
        inner, tail = tiled_spans(spans0, B, 1)
        reps = sized_reps(size, inner, tail, B, arr)
        corpus = arr[:reps * B]
        inner, tail = tiled_spans(spans0, B, reps)
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(corpus)
        be.find_all_spans_device(corpus)
        before = [c.launches for c in kernels]
        cnt = be.find_all_spans_device(corpus)[1]
        launched = ", ".join(f"{c.name} {c.launches - b}"
                             for c, b in zip(kernels, before))
        print(f"[e2e] {name:12} one warm find_all ({cnt} spans, route "
              f"{route[0]}{route_stats(be, route)}): launches {launched}",
              flush=True)
        if name in GENERAL_LIMITS:
            for k in (3, 1 << 20):
                t0 = time.perf_counter()
                got = eng.find_all_index(corpus, k)
                wall = time.perf_counter() - t0
                if got != first_spans(inner, tail, B, reps, k):
                    fail(f"{name}: find_all_index(t, {k}) differs from "
                         f"the oracle's first spans")
                print(f"[e2e] {name:12} find_all_index(t, {k}) on "
                      f"{len(corpus)} bytes: {len(got)} spans equal the "
                      f"oracle ({wall * 1e3:.1f} ms)", flush=True)
        routes[f"{name} launches and limits"] = be.host_routes
    return routes


def phase_e2e_literal(base: bytes, arr: np.ndarray):
    """Literal and literal-set device find_all through the public API on
    the whole corpus against the tiled oracle (no literal holds a newline,
    so no match crosses a tile seam), `(error)?` on the span limits'
    corpus, then the compaction rig (tools/profile_compact_torch.py): its
    check, its 15 variants and its production compactions on its own mask
    (256 MiB at density 1/200, seed 11)."""
    import torch
    import coregex_tpu_torch as ct
    from tools import profile_compact_torch as rig

    B = len(base)
    reps = len(arr) // B
    rng = np.random.default_rng(456)
    routes = {}
    for name in LITERAL_FIND_ALL:
        pattern = PATTERNS[name]
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        if eng.strategy not in ("literal", "multi_literal"):
            fail(f"{name}: plan {eng.strategy}, not a literal plan")
        exp = tiled_digest(oracle_spans(pattern, base), [], B, reps, rng)
        print(f"[e2e] {name:16} {eng.strategy:13} "
              + check_find_all(name, be, arr, exp), flush=True)
        routes[f"{name} find_all"] = be.host_routes
    routes.update(phase_e2e_class_nullable(base, arr, LITERAL_NULLABLE))
    for line in rig.check(DEVICE):
        print(f"[rig] check {line}")
    mask, nhits, cap = rig.rig_mask(256, 1 / 200, DEVICE)
    n = int(mask.shape[0])
    expect = torch.nonzero(mask).flatten().to(torch.int32)
    for variant in rig.VARIANTS:
        ms, ok = rig.run_variant(variant, mask, nhits, cap, expect)
        if ok is False:
            fail(f"rig variant {variant} differs from torch.nonzero")
        print(f"[rig] {variant:14} {ms:8.3f} ms "
              f"({n / 1e9 / (ms / 1e3):7.2f} GB/s)"
              + ("  ablation" if ok is None else "  ok"), flush=True)
    for name, ms, ok in rig.prod(mask, nhits, cap, expect):
        if not ok:
            fail(f"rig prod {name} differs from torch.nonzero")
        print(f"[rig] prod {name:9} {ms:8.3f} ms "
              f"({n / 1e9 / (ms / 1e3):7.2f} GB/s)  ok", flush=True)
    del mask, expect
    torch.cuda.empty_cache()
    return routes


def single_corpora(base: bytes, corpus: np.ndarray):
    """The single-match corpora, each of its own length (the corpus cache
    keys on length, head, tail and 64 sampled bytes, ROADMAP F5): the bench
    corpus (early match); spaces, a newline and one base tile (late
    match); spaces only (no match)."""
    n = CORPUS_MIB * 1024 * 1024
    late = np.full(n - 1, FILLER, dtype=np.uint8)
    late[-len(base) - 1] = 10
    late[-len(base):] = np.frombuffer(base, dtype=np.uint8)
    return [("early", corpus), ("late", late),
            ("none", np.full(n - 2, FILLER, dtype=np.uint8))]


def oracle_first(pattern: str, which: str, arr: np.ndarray, base: bytes):
    """Go's leftmost-first span of `pattern` in a single-match corpus, from
    `re` on windows whose bounds no match can cross: the end for
    end-anchored patterns, the head for the nullable one, one tile (plus
    the next tile's head, and no match may reach past the tile) for the
    bench corpus, the newline and base tile after the spaces for the late
    corpus (a match there must not start at the window's first byte), none
    for the spaces (checked on 4 KiB of them before)."""
    rx = re.compile(ORACLE_RE.get(pattern, pattern.encode()))
    n, B = len(arr), len(base)
    if pattern in ORACLE_RE or pattern == r"\w*":
        off = n - 4096 if pattern in ORACLE_RE else 0
        m = rx.search(arr[off:off + 4096].tobytes())
        if m is not None and off and m.start() == 0:
            fail(f"{pattern}: oracle match reaches its window's start")
        return None if m is None else (off + m.start(), off + m.end())
    if which == "none":
        return None
    if which == "early":
        m = rx.search(base + base[:65536])
        if m is not None and m.end() + 64 >= B:
            fail(f"{pattern}: oracle match reaches the tile's end")
        return None if m is None else m.span()
    off = n - B - 4097
    m = rx.search(arr[off:].tobytes())
    if m is not None and m.start() == 0:
        fail(f"{pattern}: oracle match reaches its window's start")
    return None if m is None else (off + m.start(), off + m.end())


def phase_e2e_single_match(base: bytes, corpus: np.ndarray):
    """is_match and find_index through the public API on the three
    single-match corpora, first call then best of 2, against the oracle;
    then the re-tiling of find_first's prefixes, timed."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops.count_scan import (make_word_tiles,
                                                  plan_geometry)
    from coregex_tpu_torch.ops.dfa_scan import MATCH_KERNEL
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    # 4 KiB: re backtracks quadratically on `.*lit` over a newline-free
    # stretch, so a longer window would not finish; the filler is uniform
    # and no pattern here needs more than a line to match
    fill = bytes([FILLER]) * 4096
    for name, pattern in CONFIGS + SINGLE_EXTRA:
        hit = re.search(ORACLE_RE.get(pattern, pattern.encode()), fill)
        if (hit is not None) != (pattern == r"\w*"):
            fail(f"{name}: the filler byte {FILLER:#x} does not suit it")
    corpora = single_corpora(base, corpus)
    routes = {}
    for name, pattern in CONFIGS + SINGLE_EXTRA:
        eng = ct.compile(pattern, device=DEVICE)
        calls = 0
        for which, arr in corpora:
            exp = oracle_first(pattern, which, arr, base)
            line = f"[single] {name:16} {eng.strategy:13} {which:5}"
            for what, fn, want in (("is_match", eng.is_match,
                                    exp is not None),
                                   ("find_index", eng.find_index, exp)):
                t0 = time.perf_counter()
                got = fn(arr)
                first = time.perf_counter() - t0
                best = float("inf")
                for _ in range(2):
                    reset_passes(MATCH_KERNEL)
                    t0 = time.perf_counter()
                    again = fn(arr)
                    best = min(best, time.perf_counter() - t0)
                    if again != got:
                        fail(f"{name} {which}: {what} changed on a rerun")
                if got != want:
                    fail(f"{name} {which}: {what} {got} != oracle {want}")
                calls += 3 if what == "find_index" else 0
                line += (f" | {what} {str(got):26} {best * 1e3:9.3f} ms "
                         f"(first {first:.2f} s, K9 repair passes "
                         f"{passes(MATCH_KERNEL)})")
            print(line, flush=True)
        # the nullable find_index is the reference's FALLBACK: the host
        # answers it, by design
        expected = calls if pattern == r"\w*" else 0
        if eng.batch_engine().host_routes != expected:
            fail(f"{name}: {eng.batch_engine().host_routes} host routes, "
                 f"expected {expected}")
        routes[f"{name} single"] = 0
    # the module-level Match and MatchString on the card: a late match on
    # the late corpus, none in a 1 MiB str of the base tile
    late = corpora[1][1]
    text = base[:1 << 20].decode()
    for what, got, want in (
            ("match", ct.match(r"(\d+)\.(\d+)", late, device=DEVICE),
             re.search(rb"(\d+)\.(\d+)", base) is not None),
            ("match_string", ct.match_string(r"zq\d{3}", text,
                                             device=DEVICE),
             re.search(r"zq\d{3}", text) is not None)):
        if got != want:
            fail(f"coregex_tpu_torch.{what}: {got} != re's {want}")
        print(f"[single] coregex_tpu_torch.{what}: {got}, equal to re",
              flush=True)
    # find_first tiles each prefix below the corpus afresh
    dev = device_corpus(corpora[1][1], DEVICE)
    for c in (1 << 22, 1 << 25, 1 << 28, int(dev.shape[0])):
        L, T = plan_geometry(c)[:2]
        ms = cuda_ms(lambda: make_word_tiles(dev[:c], L, T // 4), 3)
        print(f"[single] word tiles of a {c} byte prefix: {ms:.3f} ms",
              flush=True)
    del dev
    return routes


def host_ends_corpus(base: bytes) -> bytes:
    """About 1 MiB of the base tile with 128 matches of
    BITSET_HOST_ENDS[1] inserted, one every 8000 bytes."""
    parts = []
    for i in range(128):
        parts.append(base[i * 8000:(i + 1) * 8000])
        parts.append(b" " + b"ab" * (i % 7) + b"a" * 16 + b" ")
    return b"".join(parts)


def phase_e2e_bitset(base: bytes, arr: np.ndarray):
    """The BITSET_NFA slice through the public API: count and device
    find_all (first call, then best of 2) of the BITSET patterns on the
    1536 MiB corpus against the tiled oracle (the tiling checked on two
    tiles), find_all_index on two tiles, is_match and find_index on the
    three single-match corpora against oracle_first, each with the bitset
    scan's repair passes; then the host-ends route (BITSET_HOST_ENDS) on
    the bench corpus, which holds no match, and on host_ends_corpus
    against `re`."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops.nfa_scan import BITSET_KERNEL

    B = len(base)
    reps = len(arr) // B
    n = len(arr)
    rng = np.random.default_rng(77)
    fill = bytes([FILLER]) * 4096
    corpora = single_corpora(base, arr)
    routes = {}
    for name, pattern in BITSET + [BITSET_HOST_ENDS]:
        if re.search(pattern.encode(), fill) is not None:
            fail(f"{name}: the filler byte {FILLER:#x} does not suit it")
        spans0 = oracle_spans(pattern, base)
        if oracle_spans(pattern, base + base) != expand_tiles(spans0, [], B,
                                                              2):
            fail(f"{name}: the tiled oracle differs from re on two tiles")
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(arr)
        host_ends = name == BITSET_HOST_ENDS[0]
        if (eng.strategy != "bitset_nfa" or route is None
                or route[0] != "bitset" or (route[1][1] is None)
                != host_ends):
            fail(f"{name}: plan {eng.strategy}, find_all route {route}")
        exp = tiled_digest(spans0, [], B, reps, rng)
        got, best, first = timed_count(eng, arr, (BITSET_KERNEL,))
        if got != exp[0]:
            fail(f"{name}: count {got} != oracle {exp[0]}")
        line = (f"[bitset] {name:17} count {got:>9} ok {n / best / 1e9:6.2f}"
                f" GB/s ({best * 1e3:.1f} ms, first {first:.2f} s, bitset "
                f"repair passes {passes(BITSET_KERNEL)}) | "
                + check_find_all(name, be, arr, exp,
                                 [("bitset", BITSET_KERNEL)]))
        if be.full_scan_stats is not None and not host_ends:
            line += (f", {be.full_scan_stats[0]} starts, "
                     f"{be.full_scan_stats[1]} window rounds")
        print(line, flush=True)
        got = eng.find_all_index(arr[:2 * B])
        if (got or []) != expand_tiles(spans0, [], B, 2):
            fail(f"{name}: find_all_index on two tiles differs from the "
                 f"oracle")
        for which, carr in corpora:
            want = oracle_first(pattern, which, carr, base)
            line = f"[bitset] {name:17} {which:5}"
            for what, fn, w in (("is_match", eng.is_match,
                                 want is not None),
                                ("find_index", eng.find_index, want)):
                t0 = time.perf_counter()
                got = fn(carr)
                first = time.perf_counter() - t0
                best = float("inf")
                for _ in range(2):
                    reset_passes(BITSET_KERNEL)
                    t0 = time.perf_counter()
                    again = fn(carr)
                    best = min(best, time.perf_counter() - t0)
                    if again != got:
                        fail(f"{name} {which}: {what} changed on a rerun")
                if got != w:
                    fail(f"{name} {which}: {what} {got} != oracle {w}")
                line += (f" | {what} {str(got):20} {best * 1e3:9.3f} ms "
                         f"(first {first:.2f} s, bitset repair passes "
                         f"{passes(BITSET_KERNEL)})")
            print(line, flush=True)
        if host_ends:
            t = host_ends_corpus(base)
            want = [m.span() for m in re.finditer(pattern.encode(), t)]
            if not want:
                fail(f"{name}: the host-ends corpus holds no match")
            t0 = time.perf_counter()
            ok = (eng.find_all_index(t) == want and eng.count(t) == len(want)
                  and eng.is_match(t) is True
                  and eng.find_index(t) == want[0])
            if not ok:
                fail(f"{name}: the host-ends route differs from re on "
                     f"{len(t)} bytes")
            print(f"[bitset] {name:17} host ends on {len(t)} bytes: "
                  f"find_all_index, count, is_match and find_index equal "
                  f"re ({len(want)} matches, "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms)", flush=True)
        routes[f"{name} bitset"] = be.host_routes
    return routes


def posix_run_spans(base: bytes):
    """The leftmost-longest spans of `([a-z]{2,3})+`: each run of
    `[a-z]+` cut to its longest prefix that `(?:[a-z]{2,3})+` fully
    matches (no match fits in what is left of the run)."""
    plus = re.compile(rb"(?:[a-z]{2,3})+")
    out = []
    for r in re.finditer(rb"[a-z]+", base):
        s, e = r.span()
        x = next((x for x in range(e - s, 0, -1)
                  if plus.fullmatch(base, s, s + x)), None)
        if x is not None:
            out.append((s, s + x))
    return out


def posix_oracle(oracle, text: bytes):
    """A POSIX pattern's spans on text: re's on the oracle pattern (its
    leftmost-first spans are the POSIX pattern's leftmost-longest ones on
    this corpus), or posix_run_spans."""
    if oracle is None:
        return posix_run_spans(text)
    return [m.span() for m in re.finditer(oracle.encode(), text)]


def phase_e2e_posix(base: bytes, arr: np.ndarray):
    """The leftmost-longest slice through the public API: count and device
    find_all (first call, then best of 2) of each POSIX pattern through
    compile_posix on the 1536 MiB corpus against its oracle (posix_oracle
    on the base tile, tiled, the tiling checked on two tiles), with its
    route, match starts and window rounds, the launches of each kernel in
    one warm find_all and find_all_index on two tiles; then the
    leftmost-first engine's count and find_all walls of the same pattern
    beside them, a comparison whose launches are not the path's."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import compact2, dfa_scan, nfa_scan

    B = len(base)
    reps = len(arr) // B
    n = len(arr)
    rng = np.random.default_rng(19)
    every = [c for c, _, _ in kernel_counters()]
    kernels = (dfa_scan.MATCH_KERNEL, dfa_scan.WINDOW_ENDS_KERNEL,
               compact2.COMPACT_KERNEL, nfa_scan.BITSET_KERNEL)
    routes, walls = {}, {}
    for name, pattern, oracle in POSIX:
        spans0 = posix_oracle(oracle, base)
        if posix_oracle(oracle, base + base) != expand_tiles(spans0, [], B,
                                                             2):
            fail(f"posix {name}: the tiled oracle differs from the oracle "
                 f"on two tiles")
        eng = ct.compile_posix(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(arr)
        if route is None:
            fail(f"posix {name}: find_all is not routed to the device")
        exp = tiled_digest(spans0, [], B, reps, rng)
        got, best, first = timed_count(
            eng, arr, (dfa_scan.MATCH_KERNEL, nfa_scan.BITSET_KERNEL))
        if got != exp[0]:
            fail(f"posix {name}: count {got} != oracle {exp[0]}")
        line = (f"[posix] {name:11} {eng.strategy:13} route {route[0]:9} "
                f"count {got:>9} ok {n / best / 1e9:6.2f} GB/s "
                f"({best * 1e3:.1f} ms, first {first:.2f} s) | "
                + check_find_all(f"posix {name}", be, arr, exp,
                                 [("K9", dfa_scan.MATCH_KERNEL),
                                  ("bitset", nfa_scan.BITSET_KERNEL)], walls)
                + route_stats(be, route))
        print(line, flush=True)
        before = [c.launches for c in kernels]
        be.find_all_spans_device(arr)
        launched = ", ".join(f"{c.name} {c.launches - b}"
                             for c, b in zip(kernels, before))
        got = eng.find_all_index(arr[:2 * B])
        if (got or []) != expand_tiles(spans0, [], B, 2):
            fail(f"posix {name}: find_all_index on two tiles differs from "
                 f"the oracle")
        routes[f"{name} posix"] = be.host_routes
        # the leftmost-first engine's walls: a comparison, so its
        # launches are taken back out of the counts
        saved = [c.launches for c in every]
        lf = ct.compile(pattern, device=DEVICE)
        lf_route = lf.batch_engine()._spans_route(arr)
        if lf_route is None:
            fail(f"posix {name}: the leftmost-first find_all declines")
        lf_count = timed_count(lf, arr)[1]
        lf_be = lf.batch_engine()
        lf_be.find_all_spans_device(arr)
        lf_fa = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            r = lf_be.find_all_spans_device(arr, defer_ok=True)
            int(r[1])
            lf_fa = min(lf_fa, time.perf_counter() - t0)
        for c, v in zip(every, saved):
            c.launches = v
        fa = walls[f"posix {name}"]
        print(f"[posix] {name:11} host_routes {be.host_routes}; one warm "
              f"find_all launches {launched}; find_all_index on two tiles "
              f"equals the oracle | POSIX count {best * 1e3:.1f} ms, "
              f"find_all {fa * 1e3:.1f} ms; leftmost-first (route "
              f"{lf_route[0]}) count {lf_count * 1e3:.1f} ms, find_all "
              f"{lf_fa * 1e3:.1f} ms", flush=True)
    return routes


def invalid_base(base: bytes) -> bytes:
    """The base tile with a byte Go decodes as U+FFFD every INVALID_STEP
    bytes (cycling INVALID_BYTES; a lead byte stays before an ASCII byte,
    so each decodes alone), none in a tile's last line: tiles join
    without joining a sequence."""
    b = bytearray(base)
    last = base.rfind(b"\n", 0, len(base) - 1)
    for i, p in enumerate(range(INVALID_STEP, last, INVALID_STEP)):
        b[p] = INVALID_BYTES[i % len(INVALID_BYTES)]
    return bytes(b)


def go_oracle(pattern: str, text: bytes):
    """Go's spans of a non-nullable pattern on text whose only non-ASCII
    bytes decode alone as U+FFFD: Python's decoder gives each one U+FFFD,
    so character offsets are byte offsets, and re's ASCII classes are
    Go's."""
    s = text.decode("utf-8", errors="replace")
    if len(s) != len(text):
        fail("the invalid UTF-8 oracle's text has a multi-byte character")
    return [m.span() for m in re.finditer(pattern, s, re.ASCII)]


def utf8_oracle(pattern: str, text: bytes):
    """re's spans (ASCII classes, as Go's) of a non-nullable pattern on
    valid UTF-8 text, in bytes."""
    s = text.decode("utf-8")
    b = np.frombuffer(text, np.uint8)
    offs = np.append(np.flatnonzero((b & 0xC0) != 0x80), len(b))
    return [(int(offs[m.start()]), int(offs[m.end()]))
            for m in re.finditer(pattern, s, re.ASCII)]


def phase_e2e_m5(base: bytes, arr: np.ndarray):
    """The candidate and INNER pipelines (M5) and invalid UTF-8 on the
    1536 MiB corpus.  For each M5 pattern: its oracle (re, held to the
    port's POSIX host walk on the base's first M5_CHECK_BYTES, then tiled,
    the tiling checked on two tiles), the M5 pipeline called directly
    (_candidate_spans_dev or _inner_spans_dev, first call, then best of
    2) and the general fallback beside it where that serves the plan,
    both against the oracle's digest, then count and find_all through the
    public API with the route taken and host_routes (a pattern the
    general fallback declines must take its M5 route); M5_WHOLE again on
    exactly CORPUS_MIB MiB.  M5_BITSET's
    candidates from its reverse bitset scan through
    _spans_from_candidate_mask, timed beside its own route (not routed).
    Then INVALID_PATTERNS
    on the invalid corpus (invalid_base tiled) through the public count and
    find_all against go_oracle, with the normalization's first-call cost,
    and VALID_PATTERN on the valid multi-byte corpus against utf8_oracle,
    with the decoder pass's cost (which must return the corpus itself).
    It must launch the reset scan, K3, K4, K8 and the window scan's ends
    form."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import dfa_scan
    from coregex_tpu_torch.utils import corpus_cache

    B = len(base)
    reps = len(arr) // B
    n = len(arr)
    rng = np.random.default_rng(23)
    routes = {}

    def best_wall(fn):
        t0 = time.perf_counter()
        r = fn()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            if r is not None and r[1] is not None:
                int(r[1])
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return r, best, first

    def digest_ok(label, r, exp):
        if r is None:
            return "declined"
        spans, cnt = r[0], int(r[1])
        cnt_e, ss_e, es_e, sidx, samp_e = exp
        ss = int(spans[:cnt, 0].sum(dtype=torch.int64)) % M32
        es = int(spans[:cnt, 1].sum(dtype=torch.int64)) % M32
        samp = spans[torch.from_numpy(sidx).to(DEVICE)].cpu().numpy()
        if (cnt, ss, es) != (cnt_e, ss_e, es_e) or not (samp == samp_e).all():
            fail(f"m5 {label}: digest ({cnt}, {ss}, {es}) != oracle "
                 f"({cnt_e}, {ss_e}, {es_e})")
        return f"{cnt} spans ok"

    for name, pattern, posix, oracle in M5:
        comp = ct.compile_posix if posix else ct.compile
        spans0 = [m.span() for m in re.finditer(oracle.encode(), base)]
        if [m.span() for m in re.finditer(oracle.encode(), base + base)] \
                != expand_tiles(spans0, [], B, 2):
            fail(f"m5 {name}: the tiled oracle differs on two tiles")
        head = base[:base.rfind(b"\n", 0, M5_CHECK_BYTES) + 1]
        host = comp(pattern, device="cpu")
        host.batch_threshold = 1 << 40
        if (host.find_all_index(head) or []) != [
                sp for sp in spans0 if sp[1] <= len(head)]:
            fail(f"m5 {name}: re's oracle differs from the host walk on "
                 f"{len(head)} bytes")
        exp = tiled_digest(spans0, [], B, reps, rng)
        eng = comp(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(arr)
        if route is None:
            fail(f"m5 {name}: find_all is not routed to the device")
        line = f"[m5] {name:15} {eng.strategy:10} route {route[0]}"
        m5 = be._m5_route()
        if m5 is None:
            fail(f"m5 {name}: the M5 pipeline declines")
        kind, args = m5
        run = (lambda: be._inner_spans_dev(args, arr)) if kind == "inner" \
            else (lambda: be._candidate_spans_dev(args, arr))
        rk = dfa_scan.RESET_KERNEL
        l0 = rk.launches
        reset_passes(rk)
        r, best, first = best_wall(run)
        line += (f" | {kind} {digest_ok(name, r, exp)} "
                 f"{best * 1e3:.2f} ms (first {first:.2f} s)")
        if kind == "candidate":
            # best_wall makes three calls
            line += (f", reset scan {(rk.launches - l0) / 3:.1f} launches "
                     f"and {rk.sub_passes / 3:.1f}+{rk.lane_passes / 3:.1f}"
                     f" repair passes a call")
        general = be._full_scan_route()
        if general is not None:
            r, gbest, gfirst = best_wall(
                lambda: be._full_scan_spans_dev(*general, arr))
            line += (f" | full_scan {digest_ok(name, r, exp)} "
                     f"{gbest * 1e3:.2f} ms (first {gfirst:.2f} s, "
                     f"{gbest / best:.3f}x M5)")
        else:
            line += " | full_scan declines"
        print(line, flush=True)
        got, cbest, _f = timed_count(eng, arr)
        if got != exp[0]:
            fail(f"m5 {name}: count {got} != oracle {exp[0]}")
        bulk = ""
        if kind == "candidate" and be.plan.strategy.name == "PREFIX_RUN" \
                and be._chunk_scanner(be._verify_kind()) is not None:
            # the reference's bulk count, beside the count the port takes
            r, bbest, _bf = best_wall(
                lambda: (None, be._prefix_run_count_device(arr)))
            if r[1] is not None and r[1] != exp[0]:
                fail(f"m5 {name}: bulk count {r[1]} != oracle {exp[0]}")
            bulk = f", bulk count {r[1]} {bbest * 1e3:.1f} ms"
        line = (f"[m5] {name:15} count {got} ({cbest * 1e3:.1f} ms{bulk}) | "
                + check_find_all(f"m5 {name}", be, arr, exp, []))
        print(line + f" | route {be.route}, host_routes {be.host_routes}",
              flush=True)
        if general is None and be.route != kind:
            fail(f"m5 {name}: the general fallback declines, but find_all "
                 f"took {be.route}, not {kind}")
        routes[f"{name} m5"] = be.host_routes
    # M5_WHOLE on exactly CORPUS_MIB MiB: newlines (no space, no x) fill
    # the corpus up, so the spans stay the tiled oracle's
    name, pattern, posix, oracle = [m for m in M5 if m[0] == M5_WHOLE][0]
    whole = CORPUS_MIB * 2 ** 20
    if not 0 < whole - n < B:
        fail(f"m5 {name}: {n} bytes is not a part tile under {whole}")
    corpus_cache.clear()
    xarr = np.concatenate([arr, np.full(whole - n, 10, np.uint8)])
    spans0 = [m.span() for m in re.finditer(oracle.encode(), base)]
    exp = tiled_digest(spans0, [], B, reps, rng)
    eng = (ct.compile_posix if posix else ct.compile)(pattern, device=DEVICE)
    be = eng.batch_engine()
    got, cbest, _f = timed_count(eng, xarr)
    if got != exp[0]:
        fail(f"m5 {name} whole: count {got} != oracle {exp[0]}")
    line = (f"[m5] {name:15} {whole} bytes: count {got} ({cbest * 1e3:.1f} "
            f"ms) | " + check_find_all(f"m5 {name} whole", be, xarr, exp,
                                       []))
    print(line + f" | route {be.route}, host_routes {be.host_routes}",
          flush=True)
    if be.route != "candidate":
        fail(f"m5 {name} whole: find_all took {be.route}")
    routes[f"{name} m5 whole"] = be.host_routes
    del xarr
    corpus_cache.clear()
    # the leftmost-longest slice's other patterns: no M5 route to time
    plans = []
    for name, pattern, _o in POSIX:
        be = ct.compile_posix(pattern, device=DEVICE).batch_engine()
        if be._m5_route() is None:
            plans.append(f"{name} ({be.plan.strategy.name})")
    print(f"[m5] no M5 route, so the general or own route alone: "
          f"{', '.join(plans)}", flush=True)
    # BITSET_NFA: its route, and the candidate pipeline over the same
    # reverse bitset scan's starts (not routed)
    name, pattern = M5_BITSET
    spans0 = [m.span() for m in re.finditer(pattern.encode(), base)]
    exp = tiled_digest(spans0, [], B, reps, rng)
    be = ct.compile(pattern, device=DEVICE).batch_engine()
    rev, fwd_mt = be._bitset_route()
    sc = be._reset_scanner()
    if sc is None:
        fail(f"m5 {name}: no reset scanner over its anchored DFA")

    def candidates():
        from coregex_tpu_torch.ops.span_chain import unpack_words
        from coregex_tpu_torch.ops.span_scan import to_global
        scan = be._bitset_rev_scan(rev, arr)
        fr = unpack_words(to_global(scan.flagw, n), n)
        smask = torch.flip(fr, [0])   # a flag at flipped j: start n-1-j
        cnt = int(smask.sum())
        return be._spans_from_candidate_mask(
            sc, corpus_cache.device_corpus(arr, DEVICE), n, smask, cnt)

    r, best, first = best_wall(candidates)
    line = (f"[m5] {name:15} bitset_nfa candidates over the reverse bitset "
            f"starts {digest_ok(name, r, exp)} {best * 1e3:.2f} ms (first "
            f"{first:.2f} s)")
    r, bbest, bfirst = best_wall(
        lambda: be._bitset_spans_dev(rev, fwd_mt, arr))
    print(line + f" | bitset route {digest_ok(name, r, exp)} "
          f"{bbest * 1e3:.2f} ms (first {bfirst:.2f} s, {bbest / best:.3f}x"
          f" the candidates)", flush=True)
    # invalid UTF-8 at full size
    ibase = invalid_base(base)
    iarr = np.tile(np.frombuffer(ibase, np.uint8), reps)
    n_bad = reps * sum(a != b for a, b in zip(ibase, base))
    corpus_cache.clear()
    for name, pattern in INVALID_PATTERNS:
        spans0 = go_oracle(pattern, ibase)
        if go_oracle(pattern, ibase + ibase) != expand_tiles(spans0, [], B,
                                                              2):
            fail(f"invalid {name}: the tiled oracle differs on two tiles")
        exp = tiled_digest(spans0, [], B, reps, rng)
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        got, cbest, cfirst = timed_count(eng, iarr)
        if got != exp[0]:
            fail(f"invalid {name}: count {got} != Go's {exp[0]}")
        line = (f"[invalid] {name:9} {n} bytes, {n_bad} invalid: count "
                f"{got} ({cbest * 1e3:.1f} ms, first "
                f"{cfirst:.2f} s with the normalization) | "
                + check_find_all(f"invalid {name}", be, iarr, exp))
        got = eng.find_all_index(iarr[:2 * B].tobytes())
        if (got or []) != expand_tiles(spans0, [], B, 2):
            fail(f"invalid {name}: find_all_index on two tiles differs")
        print(line + f" | route {be.route}, host_routes {be.host_routes}",
              flush=True)
        routes[f"{name} invalid"] = be.host_routes
    del iarr
    # valid multi-byte text at full size: the decoder pass alone
    vbase = base
    for w, u in VALID_WORDS:
        vbase = vbase.replace(w, u.encode())
    vreps = len(arr) // len(vbase)
    varr = np.tile(np.frombuffer(vbase, np.uint8), vreps)
    n_multi = vreps * sum(ord(u) > 127 for u in vbase.decode())
    corpus_cache.clear()
    t0 = time.perf_counter()
    same = corpus_cache.go_bytes(varr, DEVICE) is varr
    gate_s = time.perf_counter() - t0
    if not same:
        fail("valid UTF-8: the normalization copied a valid corpus")
    corpus_cache.clear()
    name, pattern = VALID_PATTERN
    spans0 = utf8_oracle(pattern, vbase)
    if utf8_oracle(pattern, vbase + vbase) != expand_tiles(
            spans0, [], len(vbase), 2):
        fail(f"valid {name}: the tiled oracle differs on two tiles")
    exp = tiled_digest(spans0, [], len(vbase), vreps, rng)
    eng = ct.compile(pattern, device=DEVICE)
    be = eng.batch_engine()
    got, cbest, cfirst = timed_count(eng, varr)
    if got != exp[0]:
        fail(f"valid {name}: count {got} != oracle {exp[0]}")
    line = (f"[valid] {name:9} {len(varr)} bytes, {n_multi} multi-byte "
            f"characters: decoder pass {gate_s:.2f} s (the corpus itself); "
            f"count {got} ({cbest * 1e3:.1f} ms, first {cfirst:.2f} s with "
            f"the decoder pass) | "
            + check_find_all(f"valid {name}", be, varr, exp))
    print(line + f" | route {be.route}, host_routes {be.host_routes}",
          flush=True)
    routes[f"{name} valid"] = be.host_routes
    del varr
    corpus_cache.clear()
    torch.cuda.empty_cache()
    return routes


def char_offsets(text: bytes) -> np.ndarray:
    """Byte offset of each character of valid UTF-8 text, and its length."""
    b = np.frombuffer(text, np.uint8)
    return np.append(np.flatnonzero((b & 0xC0) != 0x80), len(b))


def utf8_groups(pattern: str, text: bytes):
    """re's capture groups (ASCII classes, as Go's) of every match on
    valid UTF-8 text, in bytes, as find_all_submatch_index gives them."""
    offs = char_offsets(text)
    return [[None if m.start(g) < 0 else
             (int(offs[m.start(g)]), int(offs[m.end(g)]))
             for g in range(m.re.groups + 1)]
            for m in re.finditer(pattern, text.decode("utf-8"), re.ASCII)]


def route_tables(be, arr: np.ndarray):
    """(kernel, lane-walk mode or None for the window scan, S, nseg) of the
    tables the count and find_all routes of `arr` take."""
    from coregex_tpu_torch.ops import count_scan as cs
    out = []
    cr = None if be.longest else be._count_route(arr)
    if cr is not None and cr[0] == "dfa":
        out.append(("K1", cs.MODE_COUNT, cr[1].dcd.S, cr[1].dcd.NSEG))
    kind, args = be._spans_route(arr)
    if kind == "full_scan":
        rev, fwd = args
        out += [("K9", cs.MODE_MATCH, rev.mt.S, rev.mt.NSEG),
                ("window", None, fwd.S, fwd.NSEG)]
    elif kind == "bidi":
        ssc, rsc = args
        out += [("K2", cs.MODE_SPAN, ssc.dsd.S, ssc.dsd.NSEG),
                ("K3", cs.MODE_FLAG, rsc.tables.S, rsc.tables.NSEG)]
    elif kind == "m5":
        kind, m5 = args
        if kind == "inner":
            fsc = m5[1]
            out.append(("K3 suffix", cs.MODE_FLAG, fsc.tables.S,
                        fsc.tables.NSEG))
    return kind, out


def phase_e2e_band(base: bytes, arr: np.ndarray):
    """The band's walls through the public API: count and device find_all
    (first call, then best of 2) of BAND_WALLS' keyword lists over the
    corpus, against re's spans on the base tile, tiled; host_routes 0.  It
    must launch K1, K9 and the window scan's ends form."""
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan
    t0 = time.perf_counter()
    B = len(base)
    reps = len(arr) // B
    pats = dict(band_patterns(big_cut(base)))
    rng = np.random.default_rng(37)
    routes = {}
    for name in BAND_WALLS:
        pattern = pats[name]
        inner, tail = tiled_spans(oracle_spans(pattern, base), B, reps)
        exp = tiled_digest(inner, tail, B, reps, rng)
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        got, cbest, cfirst = timed_count(eng, arr)
        if got != exp[0]:
            fail(f"band {name}: count {got} != oracle {exp[0]}")
        line = check_find_all(f"band {name}", be, arr, exp,
                              kernels=[("K9", dfa_scan.MATCH_KERNEL)])
        print(f"[band] {name:6} count {got} {cbest * 1e3:.1f} ms (first "
              f"{cfirst:.2f} s, {passes(cs.COUNT_KERNEL)}) | route "
              f"{be.route} | {line}", flush=True)
        routes[f"{name} band"] = be.host_routes
    print(f"[band] walls {time.perf_counter() - t0:.1f} s", flush=True)
    return routes


def phase_e2e_big_tables(base: bytes, arr: np.ndarray):
    """Tables past shared memory (ROADMAP P5) through the public API.  For
    each BIG pattern, on the base's first BIG_CUT bytes tiled to the
    corpus size, ASCII and with VALID_WORDS' 2-4-byte characters: the
    tables its count and find_all routes take (shape, bytes, instance;
    each past SMEM_LIMIT), count and device find_all (first call, then
    best of 2) against re's oracle on the tile, tiled (POSIX: re held to
    the port's host walk on the tile's first BIG_POSIX_CHECK; the tiling
    checked across the seam of the tile and the next tile's head),
    find_all_submatch_index through the API on the tile's first
    BIG_API_BYTES against re's groups, is_match and find_index on the
    corpus (early
    match), on spaces, a newline and one tile (late) and on spaces (none);
    POSIX find_index on the early corpus only (a host route the reference
    keeps).  One engine a pattern serves both corpora.  Each pattern's
    calls print the launches of the global instances; host_routes must
    stay 0.  It must launch the global instances of K1, K2, K3, K9 and
    the window scan's ends form."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import count_scan as cs
    from coregex_tpu_torch.ops import dfa_scan
    from coregex_tpu_torch.utils import corpus_cache

    tile = big_cut(base)
    pats = big_patterns(tile)
    vtile = tile
    for w, u in VALID_WORDS:
        vtile = vtile.replace(w, u.encode())
    glob = list(cs.GLOBAL_KERNELS.values()) + [
        dfa_scan.WINDOW_GLOBAL[dfa_scan.WINDOW_ENDS_KERNEL]]
    spaces = b" " * 4096 + b"\n"
    rng = np.random.default_rng(31)
    routes = {}
    engines = {}
    for label, t in (("ascii", tile), ("utf8", vtile)):
        B = len(t)
        reps = len(arr) // B
        big = np.tile(np.frombuffer(t, np.uint8), reps)
        n = len(big)
        late = np.full(n - 1, FILLER, dtype=np.uint8)
        late[-B - 1] = 10
        late[-B:] = np.frombuffer(t, np.uint8)
        none = np.full(n - 2, FILLER, dtype=np.uint8)
        api = t[:t.find(b"\n", BIG_API_BYTES) + 1]
        check = t[:t.rfind(b"\n", 0, BIG_POSIX_CHECK) + 1]
        corpus_cache.clear()
        oracles = {}
        print(f"[big] {label}: tile of {B} bytes x {reps} = {n} bytes",
              flush=True)
        for name, pattern, posix in pats:
            comp = ct.compile_posix if posix else ct.compile
            if pattern not in oracles:
                # the tile's spans, from re on the tile and the next tile's
                # head: no match may cross the seam or change across it
                two = utf8_oracle(pattern, t + api)
                spans0 = [sp for sp in two if sp[1] <= B]
                if two != spans0 + [(s + B, e + B) for s, e in spans0
                                    if e <= len(api)]:
                    fail(f"big {name}: the tiled oracle differs at a seam")
                if utf8_oracle(pattern, spaces):
                    fail(f"big {name}: the oracle matches in spaces")
                oracles[pattern] = spans0
            spans0 = oracles[pattern]
            groups = utf8_groups(pattern, api)
            if posix:
                # re's leftmost-first spans are the POSIX ones here
                host = comp(pattern, device="cpu")
                host.batch_threshold = 1 << 40
                if (host.find_all_index(check) or []) != [
                        sp for sp in spans0 if sp[1] <= len(check)]:
                    fail(f"big {name}: re's oracle differs from the POSIX "
                         f"host walk on {len(check)} bytes")
                if re.compile(pattern).groups:
                    fail(f"big {name}: no POSIX oracle for its groups")
            if name not in engines:
                engines[name] = comp(pattern, device=DEVICE)
            eng = engines[name]
            be = eng.batch_engine()
            declined = be.host_routes
            exp = tiled_digest(spans0, [], B, reps, rng)
            before = [c.launches for c in glob]
            t0 = time.perf_counter()
            kind, tables = route_tables(be, big)
            build = time.perf_counter() - t0
            shown = []
            for kern, mode, S, nseg in tables:
                if (S * nseg + 256) * 4 <= cs.SMEM_LIMIT:
                    fail(f"big {name}: its {kern} table [{S}, {nseg}] fits "
                         f"shared memory")
                inst = (cs.lane_instance(mode, S, nseg) if mode is not None
                        else "shared" if dfa_scan.window_fits(S, nseg)
                        else "global")
                shown.append(f"{kern} [{S}, {nseg}] {S * nseg * 4} B "
                             f"{inst}")
            if name == "KW_HUGE":
                raw = int(be._count_scanner_ascii().span_cd_raw.delta.shape[0]
                          if label == "ascii" else
                          be._count_scanner().span_cd_raw.delta.shape[0])
                if raw < BIG_HUGE_STATES:
                    fail(f"big KW_HUGE: count transducer of {raw} states")
                shown.append(f"count transducer {raw} states")
            got, cbest, cfirst = timed_count(eng, big)
            if got != exp[0]:
                fail(f"big {name} {label}: count {got} != oracle {exp[0]}")
            line = (f"[big] {name:12} {label:5} route {kind} (tables "
                    f"{build:.1f} s: {'; '.join(shown)}) | count {got} "
                    f"{cbest * 1e3:.1f} ms (first {cfirst:.2f} s) | "
                    + check_find_all(f"big {name} {label}", be, big, exp))
            if be.route != kind:
                fail(f"big {name}: find_all took {be.route}, not {kind}")
            t0 = time.perf_counter()
            sub = eng.find_all_submatch_index(api) or []
            if sub != groups:
                fail(f"big {name} {label}: find_all_submatch_index on "
                     f"{len(api)} bytes differs from the oracle")
            line += (f" | find_all_submatch_index {len(sub)} matches on "
                     f"{len(api)} bytes {time.perf_counter() - t0:.2f} s")
            first = spans0[0] if spans0 else None
            for which, a, want in (
                    ("early", big, first),
                    ("late", late, None if first is None else
                     (first[0] + n - 1 - B, first[1] + n - 1 - B)),
                    ("none", none, None)):
                t0 = time.perf_counter()
                hit = eng.is_match(a)
                w_is = time.perf_counter() - t0
                if hit != (want is not None):
                    fail(f"big {name} {label}: is_match {which} {hit}")
                line += f" | {which} is_match {w_is * 1e3:.1f} ms"
                if posix and which != "early":
                    continue
                t0 = time.perf_counter()
                got = eng.find_index(a)
                w_fi = time.perf_counter() - t0
                if got != want:
                    fail(f"big {name} {label}: find_index {which} {got} != "
                         f"{want}")
                line += f", find_index {w_fi * 1e3:.1f} ms"
            line += (f" | global launches "
                     + ", ".join(f"{c.name} {c.launches - b}"
                                 for c, b in zip(glob, before))
                     + f" | host_routes {be.host_routes - declined}")
            print(line, flush=True)
            routes[f"{name} big {label}"] = be.host_routes - declined
        del big, late, none
        corpus_cache.clear()
        torch.cuda.empty_cache()
    return routes


def limits_oracle(name: str, pattern: str, base: bytes, n: int, rng):
    """The tiled digest of a LIMITS pattern on LIMITS_TILES tiles: the
    Go-rule oracle of one tile, tiled; `(?s)error.*` matches once, from
    the first `error` to the end."""
    B = len(base)
    if name == "dotall_error":
        s = base.find(b"error")
        return tiled_digest([], [(s, n)], B, LIMITS_TILES, rng)
    inner, tail = tiled_spans(oracle_spans(pattern, base), B, LIMITS_TILES)
    return tiled_digest(inner, tail, B, LIMITS_TILES, rng)


def span_digest(spans, cnt: int, sidx):
    """(start sum mod 2^32, end sum mod 2^32, the rows at sidx) of the
    first cnt rows of a device span array, summed 2^26 rows at a time."""
    import torch
    ss = es = 0
    for i in range(0, cnt, 1 << 26):
        j = min(cnt, i + (1 << 26))
        ss += int(spans[i:j, 0].sum(dtype=torch.int64))
        es += int(spans[i:j, 1].sum(dtype=torch.int64))
    return (ss % M32, es % M32,
            spans[torch.from_numpy(sidx).to(spans.device)].cpu().numpy())


def dense_corpus(kind: str, n: int) -> np.ndarray:
    """A LIMITS_DENSE corpus of n bytes (n even)."""
    if kind == "a_space":
        return np.tile(np.frombuffer(b"a ", dtype=np.uint8), n // 2)
    return np.full(n, ord("a") if kind == "a" else 0x20, dtype=np.uint8)


def dense_oracle(oracle, n: int, rng):
    """The digest of a LIMITS_DENSE oracle on n bytes: "whole" is the one
    span (0, n); (s0, e0, step, count) the arithmetic spans, count None
    for n // step spans (n + 1 when the span is empty), -1 for n - 1."""
    if oracle == "whole":
        return tiled_digest([], [(0, n)], 1, 1, rng)
    s0, e0, step, cnt = oracle
    if cnt is None:
        cnt = n + 1 if s0 == e0 else n // step
    elif cnt < 0:
        cnt = n + cnt
    return tiled_digest([(s0, e0)], [], step, cnt, rng)


def limits_find_all(name, be, arr: np.ndarray, exp, kernels):
    """Device find_all of arr (first call, then best of 2), each call's
    peak device memory since a reset before it; the last call's spans
    against the expected digest.  Returns (best wall s, first wall s,
    peak bytes, count, launches of `kernels` in the last call)."""
    import torch
    walls, peak = [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = [c.launches for c in kernels]
        t0 = time.perf_counter()
        r = be.find_all_spans_device(arr, defer_ok=True)
        if r is None:
            fail(f"limits {name}: find_all declined")
        spans, cnt, ok = r
        cnt = int(cnt)
        ok = True if ok is None else bool(ok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        launched = [c.launches - b for c, b in zip(kernels, before)]
        if len(walls) < 3:
            del spans, r
    cnt_e, ss_e, es_e, sidx, samp_e = exp
    ss, es, samp = span_digest(spans, cnt, sidx)
    del spans, r
    if not ok or (cnt, ss, es) != (cnt_e, ss_e, es_e):
        fail(f"limits {name}: find_all digest ({cnt}, {ok}, {ss}, {es}) "
             f"!= oracle ({cnt_e}, True, {ss_e}, {es_e})")
    if not (samp.astype(np.int64) == samp_e).all():
        fail(f"limits {name}: sampled spans differ from the oracle")
    return min(walls[1:]), walls[0], peak, cnt, launched


def phase_e2e_limits(base: bytes, arr: np.ndarray):
    """find_all up to MAX_CORPUS through the public API: the corpus cache
    cleared, the base tiled LIMITS_TILES times (2,145,381,040 bytes), then
    for each LIMITS pattern (the cache cleared before it, so each call's
    peak holds only what its route keeps) its route, device find_all
    (first call, then best of 2) against the tiled oracle with its peak
    device memory, its output and corpus pieces, host_routes and one warm
    call's launches; the LIMITS_PIECED patterns must take two or more
    output pieces, and no call may pass LIMITS_PEAK_GIB.  Then the same
    for each LIMITS_DENSE pattern on its dense corpus of as many bytes
    (rounded down to even), against its arithmetic oracle.  Then one count
    of each count route (LIMITS_COUNTS: K1, K5, K6), the leftmost-longest
    count of `\\b\\d+\\b` and find_all of email, each against its oracle;
    then M5_WHOLE's find_all (the candidate pipeline) on as many tiles as
    keep its candidates under _DEV_FILTER_LIMIT, with its candidate count
    and peak device memory; the corpus is freed at the end."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.utils import corpus_cache

    corpus_cache.clear()
    torch.cuda.empty_cache()
    B = len(base)
    big = np.tile(np.frombuffer(base, dtype=np.uint8), LIMITS_TILES)
    n = len(big)
    from coregex_tpu_torch.meta.batch import MAX_CORPUS
    print(f"[limits] corpus {n} bytes = {LIMITS_TILES} tiles of {B}, "
          f"{MAX_CORPUS - n} under MAX_CORPUS", flush=True)
    rng = np.random.default_rng(341)
    every = [c for c, _, _ in kernel_counters()]
    routes = {}
    gib = 2 ** 30
    for name, pattern in LIMITS:
        corpus_cache.clear()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        exp = limits_oracle(name, pattern, base, n, rng)
        oracle_s = time.perf_counter() - t0
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(big)
        if route is None:
            fail(f"limits {name}: find_all is not routed to the device")
        best, first, peak, cnt, launched = limits_find_all(
            name, be, big, exp, every)
        pieces = list(be.pieces)
        if peak > LIMITS_PEAK_GIB * gib:
            fail(f"limits {name}: peak device memory {peak / gib:.2f} GiB "
                 f"passes {LIMITS_PEAK_GIB} GiB")
        if name in LIMITS_PIECED and pieces[0] < 2:
            fail(f"limits {name}: {cnt} spans in {pieces[0]} output piece")
        routes[f"{name} limits"] = be.host_routes
        used = ", ".join(f"{c.name} {k}" for c, k in zip(every, launched)
                         if k)
        print(f"[limits] {name:13} {eng.strategy:13} route {route[0]:9} "
              f"find_all {cnt:>10} spans digest+64 samples ok  "
              f"{n / best / 1e9:7.2f} GB/s ({best * 1e3:.1f} ms, first "
              f"{first:.2f} s), pieces {pieces[0]} output / {pieces[1]} "
              f"corpus, peak {peak / gib:.2f} GiB, host_routes "
              f"{be.host_routes}, oracle {oracle_s:.1f} s; one warm "
              f"call's launches: {used or 'none'}", flush=True)
        del eng, be
    corpus_cache.clear()
    nd = n - n % 2
    for cname, cpat, kind, want, oracle in LIMITS_DENSE:
        corpus_cache.clear()
        torch.cuda.empty_cache()
        dense = dense_corpus(kind, nd)
        exp = dense_oracle(oracle, nd, rng)
        eng = ct.compile(cpat, device=DEVICE)
        be = eng.batch_engine()
        route = be._spans_route(dense)
        if route is None or route[0] != want:
            fail(f"limits dense {cname}: route {route and route[0]}, not "
                 f"{want}")
        best, first, peak, cnt, launched = limits_find_all(
            f"dense {cname}", be, dense, exp, every)
        pieces = list(be.pieces)
        if peak > LIMITS_PEAK_GIB * gib:
            fail(f"limits dense {cname}: peak device memory "
                 f"{peak / gib:.2f} GiB passes {LIMITS_PEAK_GIB} GiB")
        routes[f"{cname} limits dense"] = be.host_routes
        used = ", ".join(f"{c.name} {k}" for c, k in zip(every, launched)
                         if k)
        print(f"[limits] dense {cname:15} {kind:7} route {route[0]:11} "
              f"find_all {cnt:>10} spans digest+64 samples ok  "
              f"{nd / best / 1e9:7.2f} GB/s ({best * 1e3:.1f} ms, first "
              f"{first:.2f} s), pieces {pieces[0]} output / {pieces[1]} "
              f"corpus, peak {peak / gib:.2f} GiB, host_routes "
              f"{be.host_routes}; one warm call's launches: "
              f"{used or 'none'}", flush=True)
        del eng, be, dense
    corpus_cache.clear()
    torch.cuda.empty_cache()
    for name in LIMITS_COUNTS:
        pattern = dict(LIMITS)[name]
        exp = limits_oracle(name, pattern, base, n, rng)[0]
        eng = ct.compile(pattern, device=DEVICE)
        got, best, first = timed_count(eng, big)
        kind = eng.batch_engine()._count_route(big)[0]
        if got != exp:
            fail(f"limits {name}: count {got} != oracle {exp}")
        routes[f"{name} limits count"] = eng.batch_engine().host_routes
        print(f"[limits] {name:13} count {got:>10} ok via {kind} "
              f"{n / best / 1e9:7.2f} GB/s ({best * 1e3:.1f} ms, first "
              f"{first:.2f} s)", flush=True)
    for name, pattern, oracle in POSIX:
        if name not in ("word_digits", "email"):
            continue
        inner, tail = tiled_spans(posix_oracle(oracle, base), B,
                                  LIMITS_TILES)
        exp = tiled_digest(inner, tail, B, LIMITS_TILES, rng)
        eng = ct.compile_posix(pattern, device=DEVICE)
        be = eng.batch_engine()
        if name == "word_digits":
            got, best, first = timed_count(eng, big)
            if got != exp[0]:
                fail(f"limits posix {name}: count {got} != oracle {exp[0]}")
            what = f"count {got:>10} ok"
        else:
            best, first, peak, got, _l = limits_find_all(
                f"posix {name}", be, big, exp, every)
            what = (f"find_all {got:>10} spans digest+64 samples ok, peak "
                    f"{peak / gib:.2f} GiB")
        routes[f"{name} limits posix"] = be.host_routes
        print(f"[limits] posix {name:7} {what} {n / best / 1e9:7.2f} GB/s "
              f"({best * 1e3:.1f} ms, first {first:.2f} s)", flush=True)
    # the candidate pipeline at its _DEV_FILTER_LIMIT: as many tiles as
    # keep the candidates under it (past it the pipeline declines)
    name, pattern, posix, oracle = [m for m in M5 if m[0] == M5_WHOLE][0]
    corpus_cache.clear()
    torch.cuda.empty_cache()
    eng = (ct.compile_posix if posix else ct.compile)(pattern, device=DEVICE)
    be = eng.batch_engine()
    one = torch.from_numpy(np.frombuffer(base, np.uint8).copy()).to(DEVICE)
    per_tile = int(be._prefix_run_candidates_mask(one)[1])
    del one
    tiles = min(LIMITS_TILES, be._DEV_FILTER_LIMIT // per_tile)
    sub = big[:tiles * B]
    inner, tail = tiled_spans(
        [m.span() for m in re.finditer(oracle.encode(), base)], B, tiles)
    exp = tiled_digest(inner, tail, B, tiles, rng)
    best, first, peak, got, _l = limits_find_all(f"m5 {name}", be, sub, exp,
                                                 every)
    if be.route != "candidate":
        fail(f"limits m5 {name}: find_all took {be.route}")
    if peak > LIMITS_PEAK_GIB * gib:
        fail(f"limits m5 {name}: peak device memory {peak / gib:.2f} GiB "
             f"passes {LIMITS_PEAK_GIB} GiB")
    cand = int(be._prefix_run_candidates_mask(
        corpus_cache.device_corpus(sub, DEVICE))[1])
    routes[f"{name} limits m5"] = be.host_routes
    print(f"[limits] m5 {name} {tiles} tiles ({len(sub)} bytes; "
          f"{LIMITS_TILES} hold {LIMITS_TILES * per_tile} candidates and "
          f"decline) find_all {got:>10} spans digest+64 samples ok, {cand} "
          f"candidates ({cand / be._DEV_FILTER_LIMIT:.4f} of the limit), "
          f"peak {peak / gib:.2f} GiB {len(sub) / best / 1e9:7.2f} GB/s "
          f"({best * 1e3:.1f} ms, first {first:.2f} s)", flush=True)
    del sub
    del big
    corpus_cache.clear()
    torch.cuda.empty_cache()
    return routes


def capture_oracle(pattern: str, base: bytes) -> np.ndarray:
    """The capture slots [m, NS] int64 (-1: unset) of re's matches in one
    tile."""
    rx = re.compile(pattern.encode())
    ns = 2 * (rx.groups + 1)
    return np.array([[p for g in range(rx.groups + 1) for p in m.span(g)]
                     for m in rx.finditer(base)],
                    dtype=np.int64).reshape(-1, ns)


def slot_digest(o: np.ndarray, B: int, reps: int, rng):
    """(count, column sums, sampled indices, their rows) of the slots of
    `reps` tiles of B bytes, from those of one tile (o); an unset slot
    stays -1 in every tile."""
    m0 = len(o)
    sums = reps * o.sum(0) + B * (o >= 0).sum(0) * (reps * (reps - 1) // 2)
    sidx = np.sort(rng.integers(0, reps * m0, 64))
    rows = o[sidx % m0] + np.where(o[sidx % m0] >= 0,
                                   (sidx // m0)[:, None] * B, 0)
    return reps * m0, sums, sidx, rows


def row_walk_need(tb, rows, s0, steps, ends=None):
    """The bytes [B] int64 a row scan must read of each row: its first
    steps[b] bytes (from ends[b] - 1 down to 0 when ends is given), cut
    after the byte that takes its walk from s0[b] to the dead state where
    tb.stop_dead: the rest of the row cannot change its result."""
    import torch
    B, L = (int(x) for x in rows.shape)
    tbl, cls = tb.tbl.long().reshape(-1), tb.classes.long()
    ar = torch.arange(B, device=rows.device)
    s = s0.long()
    n = steps.long().clamp(0, L)
    need = n.clone()
    alive = torch.ones(B, dtype=torch.bool, device=rows.device)
    for t in range(int(n.max()) if B else 0):
        live = alive & (t < n)
        col = rows[:, t] if ends is None else \
            rows[ar, (ends.long() - 1 - t).clamp(0, L - 1)]
        s = torch.where(live, tbl[s * tb.C + cls[col.long()]] >> 1, s)
        if tb.stop_dead:
            died = live & (s == 0)
            need = torch.where(died, t + 1, need)
            alive &= ~died
    return need


def row_walk_bytes(tb, rows, s0, steps, ends=None) -> int:
    """The bytes a row scan must read in all (row_walk_need's sum)."""
    return int(row_walk_need(tb, rows, s0, steps, ends).sum())


def bench_lines(base: bytes):
    """The first ROWS lines of the tiled bench corpus."""
    per_tile = base.count(b"\n")
    return (base * -(-ROWS // per_tile)).split(b"\n")[:ROWS]


def capture_row_kernels(compare, base: bytes, corpus: np.ndarray) -> None:
    """cgx_onepass_extract against onepass_plain on every bidi span of the
    CAPTURES patterns over the whole corpus (the device form's input) and
    on hand-made spans (random spans, most of which die; spans of
    MAX_WINDOW and one byte more; the corpus's last bytes, also of a
    corpus of n % 16 != 0 bytes at byte offset 3), then cgx_rows_match and
    cgx_rows_rev_start against theirs on the packed ROWS lines for each
    ROW_PATTERNS pattern.  The OnePass walk and the forward row scan run
    in every table mode their tables allow (byte-indexed and
    class-indexed shared, global), the chosen one first."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import onepass_scan as ops
    from coregex_tpu_torch.ops import rowscan as rs
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    def each_mode(tables, run):
        """run(mode, chosen) in every table mode, the chosen one first."""
        chosen = tables.mode
        for mode in tables.modes:
            tables.mode = mode
            run(mode, mode == chosen)
        tables.mode = chosen

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    data = device_corpus(corpus, DEVICE)
    n = len(corpus)
    for i, (name, pattern) in enumerate(CAPTURES):
        eng = ct.compile(pattern, device=DEVICE)
        op = eng._onepass_dfa()
        if not op:
            fail(f"{name}: not one-pass")
        d = ops.DeviceOnePass(op, DEVICE)
        r = eng.batch_engine().find_all_spans_device(corpus)
        if r is None:
            fail(f"{name}: find_all declined")
        sp = r[0][:int(r[1])]
        walked = int((sp[:, 1] - sp[:, 0]).sum(dtype=torch.int64))
        print(f"[kernels] onepass     {name}: {sp.shape[0]} spans, "
              f"{walked} bytes, tables [{d.S}, {d.C}] x {d.NS} slots, "
              f"modes {'/'.join(d.modes)} (at "
              f"{time.perf_counter() - t_start:.1f} s)")

        def whole(mode, chosen):
            ms = compare(
                "onepass_extract", f"{name} {CORPUS_MIB} MiB {mode}",
                lambda: ops.onepass_cuda(d, data, sp),
                lambda: ops.onepass_plain(d, data, sp),
                headline=i == 0 and chosen,
                in_bytes=walked + nbytes(sp, d.trans, d.fin, d.classes))
            if chosen:
                SLICE_MS[("onepass_extract", name)] = ms
        each_mode(d, whole)
        if i:
            continue
        g = torch.Generator(device=dev).manual_seed(14)
        a = torch.randint(0, n - 64, (4096,), generator=g, device=dev)
        rand = torch.stack([a, a + torch.randint(0, 65, (4096,), generator=g,
                                                 device=dev)], 1)
        W = ops.MAX_WINDOW
        edge = torch.tensor([[0, W], [1, W + 2], [n - W, n], [n - W - 1, n],
                             [n - 1, n], [n, n], [n - 15, n]], device=dev)
        hand = torch.cat([rand, sp[:64].long(), edge]).to(torch.int32)
        # a corpus of n % 16 != 0 bytes starting at byte offset 3: its last
        # bytes, the first ones, spans reaching past it
        odd = data[3:n - 2]
        m = int(odd.shape[0])
        ends = torch.tensor([[m - 1, m], [m - 5, m], [m - 13, m],
                             [m - 17, m], [m - 40, m], [0, 1], [0, 13],
                             [m - 3, m + 4], [-2, 5]], device=dev)
        hand_odd = torch.cat([rand[:512], sp[-512:].long() - 3,
                              ends]).to(torch.int32)

        def hand_made(mode, chosen):
            _, ok = ops.onepass_cuda(d, data, hand)
            _, ok_odd = ops.onepass_cuda(d, odd, hand_odd)
            print(f"[kernels] onepass     hand-made ({mode}): "
                  f"{hand.shape[0]} spans, {int(ok.sum())} end in a match; "
                  f"{hand_odd.shape[0]} on {m} bytes at offset 3, "
                  f"{int(ok_odd.sum())} (at "
                  f"{time.perf_counter() - t_start:.1f} s)")
            compare("onepass_extract", f"hand-made spans {mode}",
                    lambda: ops.onepass_cuda(d, data, hand),
                    lambda: ops.onepass_plain(d, data, hand), reps=3)
            compare("onepass_extract", f"corpus end, n%16={m % 16} {mode}",
                    lambda: ops.onepass_cuda(d, odd, hand_odd),
                    lambda: ops.onepass_plain(d, odd, hand_odd), reps=3)
        each_mode(d, hand_made)
    del data
    lines = bench_lines(base)
    t0 = time.perf_counter()
    rows, lens = rs.pack_rows(lines)
    print(f"[kernels] rows        {len(lines)} lines packed to "
          f"{list(rows.shape)} in {time.perf_counter() - t0:.2f} s (at "
          f"{time.perf_counter() - t_start:.1f} s)")
    for i, (name, pattern) in enumerate(ROW_PATTERNS):
        eng = ct.compile(pattern, device=DEVICE)
        rb = rs.RowBatch(eng.fwd, eng.rev, DEVICE)
        rt, lt = rb.upload(rows, lens)
        tables = nbytes(rb.fwd.tbl, rb.fwd.eoi, rb.fwd.classes)
        # the bytes each scan needs: a row up to its length or the byte
        # that kills its walk
        ahead = row_walk_bytes(rb.fwd, rt, torch.full_like(lt, rb.fwd.start),
                               lt)

        def forward(mode, chosen):
            ms = compare(
                "rows_match", f"{name} {len(lines)} rows {mode}",
                lambda: rs.rows_match_cuda(rb.fwd, rt, lt),
                lambda: rs.rows_match_plain(rb.fwd, rt, lt),
                headline=i == 0 and chosen,
                in_bytes=ahead + nbytes(lt) + tables)
            if chosen:
                SLICE_MS[("rows_match", name)] = ms
        print(f"[kernels] rows        {name}: S={rb.fwd.S} C={rb.fwd.C}, "
              f"modes {'/'.join(rb.fwd.modes)}")
        each_mode(rb.fwd, forward)
        found, last = rs.rows_match_cuda(rb.fwd, rt, lt)
        ends = torch.where(found, last, -1)
        s0 = rs.rev_start_states(rb.rev, rt, lt, ends)
        back = row_walk_bytes(rb.rev, rt, s0, ends.clamp(min=0), ends)
        print(f"[kernels] rows        {name}: the walks need {ahead} bytes "
              f"forward, {back} back (rows hold {int(lens.sum())})")
        print(f"[kernels] rows        {name}: reverse S={rb.rev.S} "
              f"C={rb.rev.C}, modes {'/'.join(rb.rev.modes)}")

        def backward(mode, chosen):
            ms = compare(
                "rows_rev_start", f"{name} {int(found.sum())} ends {mode}",
                lambda: (rs.rows_rev_cuda(rb.rev, rt, ends, s0),),
                lambda: (rs.rows_rev_plain(rb.rev, rt, ends, s0),),
                headline=i == 0 and chosen,
                in_bytes=back + nbytes(ends, s0) + nbytes(
                    rb.rev.tbl, rb.rev.eoi, rb.rev.classes))
            if chosen:
                SLICE_MS[("rows_rev_start", name)] = ms
        each_mode(rb.rev, backward)
        if i == 0:
            # edge rows at the same shape: ends 0 and L, on 16-byte
            # boundaries and beside them, none; then no row with an end
            L = int(rt.shape[1])
            B = int(rt.shape[0])
            edge = torch.tensor([0, L, 16, 32, L - 16, 1, 15, 17, 48, -1],
                                dtype=torch.int32, device=dev).repeat(
                                    B // 10 + 1)[:B].contiguous()
            for what, e in (("edge ends", edge),
                            ("no ends", torch.full_like(ends, -1))):
                se = rs.rev_start_states(rb.rev, rt, lt, e)
                each_mode(rb.rev, lambda mode, chosen: compare(
                    "rows_rev_start", f"{name} {what} {mode}",
                    lambda: (rs.rows_rev_cuda(rb.rev, rt, e, se),),
                    lambda: (rs.rows_rev_plain(rb.rev, rt, e, se),),
                    reps=3))
            del edge, se
        del rt, lt, found, last, ends, s0
    torch.cuda.empty_cache()
    print(f"[kernels] captures and rows: "
          f"{time.perf_counter() - t_start:.1f} s")


def phase_e2e_captures_rows(base: bytes, arr: np.ndarray):
    """The captures and row-batch slice through the public API.  Captures,
    for each CAPTURES pattern: the device form (find_all_spans_device, then
    OnePassScanner.extract_device over every span) on the whole corpus
    (first call, then best of 2), its slots against the tiled re oracle
    (count, column sums, 64 sampled rows), with the extraction's kernel
    time, the spans that came back ok=False (re-extracted on the host) and
    the peak device memory; then find_all_submatch_index and
    replace_all(text, "[$2:$1]") on CAPTURE_API_MIB against the oracle.
    Row batches: is_match_batch and find_index_batch of the ROW_PATTERNS
    on the first ROWS lines against re per row, with the share of the wall
    that pack_rows takes."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import rowscan
    from coregex_tpu_torch.ops.onepass_scan import OnePassScanner
    from coregex_tpu_torch.utils.corpus_cache import device_corpus

    B = len(base)
    reps = len(arr) // B
    rng = np.random.default_rng(14)
    routes = {}
    for name, pattern in CAPTURES:
        o = capture_oracle(pattern, base)
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        op = eng._onepass_dfa()
        route = be._spans_route(arr)
        if not op or route is None or route[0] != "bidi":
            fail(f"{name}: one-pass {bool(op)}, find_all route {route}")
        sc = OnePassScanner(op, DEVICE)
        cnt_e, sums_e, sidx, rows_e = slot_digest(o, B, reps, rng)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def run():
            data = device_corpus(arr, DEVICE)
            spans, cnt = be.find_all_spans_device(arr)
            sp = spans[:int(cnt)]
            ev[0].record()
            slots, ok = sc.extract_device(data, sp)
            ev[1].record()
            torch.cuda.synchronize()
            return sp, slots, ok

        t0 = time.perf_counter()
        run()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(2):
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sp, slots, ok = run()
            wall = time.perf_counter() - t0
            if wall < best:
                best, kms = wall, ev[0].elapsed_time(ev[1])
        peak = torch.cuda.max_memory_allocated()
        bad = torch.nonzero(~ok).reshape(-1).cpu().numpy()
        if len(bad):
            # the reference's contract: the host walks what the lanes could
            # not (dead lanes, spans past MAX_WINDOW)
            text = arr.tobytes()
            fix = [eng._captures_in_span(arr, text, tuple(
                int(x) for x in sp[i].tolist())) for i in bad]
            slots[torch.from_numpy(bad).to(slots.device)] = torch.tensor(
                fix, dtype=torch.int32, device=slots.device)
        cnt = int(slots.shape[0])
        sums = slots.long().sum(0).cpu().numpy()
        samp = slots[torch.from_numpy(sidx).to(slots.device)].cpu().numpy()
        if cnt != cnt_e or not (sums == sums_e).all() \
                or not (samp == rows_e).all():
            fail(f"{name}: slots digest ({cnt}, {sums}) != oracle "
                 f"({cnt_e}, {sums_e}) or sampled rows differ")
        print(f"[captures] {name:9} {cnt} spans x {slots.shape[1]} slots on "
              f"{len(arr)} bytes: digest+64 samples ok, wall "
              f"{best * 1e3:.1f} ms (first {first:.2f} s), extraction "
              f"kernel {kms:.3f} ms, ok=False {len(bad)}, peak device "
              f"memory {peak / 2 ** 30:.2f} GiB ({resident / 2 ** 30:.2f} "
              f"GiB resident before the call)", flush=True)
        del sp, slots, ok
        # the public API on whole tiles of at least CAPTURE_API_MIB
        k = -(-(CAPTURE_API_MIB << 20) // B)
        sub = arr[:k * B]
        tile = [[None if s < 0 else (s, e) for s, e in zip(r[::2], r[1::2])]
                for r in o.tolist()]
        t0 = time.perf_counter()
        got = eng.find_all_submatch_index(sub)
        w_idx = time.perf_counter() - t0
        want = [[None if g is None else (g[0] + t * B, g[1] + t * B)
                 for g in groups] for t in range(k) for groups in tile]
        if got != want:
            fail(f"{name}: find_all_submatch_index on {len(sub)} bytes "
                 f"differs from the oracle")
        del got, want
        go, py = CAPTURE_TEMPLATE
        t0 = time.perf_counter()
        got = eng.replace_all(sub, go)
        w_rep = time.perf_counter() - t0
        if got != re.sub(pattern.encode(), py, base) * k:
            fail(f"{name}: replace_all on {len(sub)} bytes differs from "
                 f"re.sub")
        print(f"[captures] {name:9} on {len(sub)} bytes: "
              f"find_all_submatch_index {k * len(o)} matches "
              f"{w_idx:.2f} s, replace_all {go.decode()} {w_rep:.2f} s, "
              f"both equal the oracle", flush=True)
        routes[f"{name} captures"] = be.host_routes
    del sub, got
    lines = bench_lines(base)
    for name, pattern in ROW_PATTERNS:
        eng = ct.compile(pattern, device=DEVICE)
        if not eng._batch_rows_ok():
            fail(f"{name}: the row batches decline")
        rx = re.compile(pattern.encode())
        want = [m.span() if m else None for m in map(rx.search, lines)]
        t0 = time.perf_counter()
        rowscan.pack_rows(lines)
        pack = time.perf_counter() - t0
        line = f"[rows] {name:10} {len(lines)} rows"
        for what, fn, w in (("is_match_batch", eng.is_match_batch,
                             [x is not None for x in want]),
                            ("find_index_batch", eng.find_index_batch,
                             want)):
            t0 = time.perf_counter()
            got = fn(lines)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = fn(lines)
            wall = time.perf_counter() - t0
            if got != w or again != w:
                fail(f"{name}: {what} differs from re per row")
            line += (f" | {what} {sum(x is not None and x is not False
                                      for x in got)} found, wall "
                     f"{wall * 1e3:.1f} ms (first {first:.2f} s), pack_rows "
                     f"{100 * pack / wall:.0f}% of it")
        line += (f" | kernels (phase 3): rows_match "
                 f"{SLICE_MS[('rows_match', name)]:.3f} ms, rows_rev_start "
                 f"{SLICE_MS[('rows_rev_start', name)]:.3f} ms")
        print(line, flush=True)
    return routes


def virtual_mesh(D: int):
    """A mesh of D shards, all on the one card."""
    from coregex_tpu_torch.parallel.shard import Mesh
    return Mesh([DEVICE] * D)


TRANSFER_EXTRA_MIB = 256   # the walk's other tables: on 256 MiB in 4 shards
TRANSFER_EXTRA = ("quote_parity", "perm64", "multi_literal32")


def transfer_tables(name: str, mode: int):
    """(packed, segmap) of the transfer walk for a pattern of PATTERNS (or
    "quote_parity") on DEVICE: the unanchored forward DFA's match table in
    the DFA mode, the count transducer's table in the count mode; "perm64"
    is a random permutation table of 64 states (one permutation and an
    emission of 0 or 1 a byte, seed 18), whose walkers never merge; int32
    values."""
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.ops import transfer_scan as ts
    from coregex_tpu_torch.ops.dfa_scan import DFATables, MatchTables
    if name == "perm64":
        rng = np.random.default_rng(18)
        delta = np.argsort(rng.random((256, 64)), axis=1).T
        packed = delta * 32 + rng.integers(0, 2, (64, 256))
        return (torch.from_numpy(packed.astype(np.int32)).to(DEVICE),
                torch.arange(256, dtype=torch.int32, device=DEVICE))
    pattern = QUOTES if name == "quote_parity" else PATTERNS[name]
    be = ct.compile(pattern, device=DEVICE).batch_engine()
    if mode == ts.MODE_DFA:
        t = MatchTables(DFATables.from_dense(be._dense("fwd_all")), DEVICE)
    else:
        t = be._count_scanner().dcd
    if t.packed.dtype == torch.int16:
        # a lane walk's 16-bit table; the transfer walk reads int32 values
        # (transfer_maps widens it the same way)
        from coregex_tpu_torch.ops.count_scan import wide
        return wide(t.packed), t.segmap
    return t.packed, t.segmap


def transfer_data(name: str, corpus: np.ndarray, mib: int):
    """The walk's input for `name` on DEVICE: the first `mib` MiB of the
    corpus, or for quote parity quote_corpus()'s period (a quote every 300
    bytes) repeated to that length; a multiple of MESH_SHARDS bytes."""
    import torch
    n = (min(mib << 20, len(corpus)) // MESH_SHARDS) * MESH_SHARDS
    if name == "quote_parity":
        period = quote_corpus()[:300]
        return torch.from_numpy(np.resize(period, n)).to(DEVICE)
    return torch.from_numpy(corpus[:n]).to(DEVICE)


def transfer_kernels(compare, base: bytes, corpus: np.ndarray) -> None:
    """cgx_transfer_walk against transfer_walk_plain in both modes (the
    DFA mode over the unanchored forward DFA's match table, the count mode
    over the count transducer's table): on the 4 MiB sample for the 13
    bench patterns as one shard, on the whole corpus cut into MESH_SHARDS
    shards of a virtual mesh on the card for TRANSFER_MAIN, and on
    TRANSFER_EXTRA_MIB MiB in MESH_SHARDS shards for TRANSFER_EXTRA (quote
    parity, whose two live walkers never merge; a random permutation table
    of 64 states, whose walkers stay 64; multi_literal32, 112 and 149
    states), the split sub_lanes picks each time; with the rate of table
    steps (S x n over the kernel's time)."""
    import torch
    from coregex_tpu_torch.ops import transfer_scan as ts

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    n = 4 * 1024 * 1024
    sample = base[:base.rfind(b"\n", 0, n) + 1]
    small = torch.from_numpy(np.frombuffer(sample, np.uint8).copy()).to(dev)

    def case(name, mode, data, D, headline):
        packed, segmap = transfer_tables(name, mode)
        S = int(packed.shape[0])
        m = int(data.shape[0]) // D
        G = ts.sub_lanes(m, D)
        kind = ts.COUNTERS[mode].name
        ms = compare(kind, f"{name} {int(data.shape[0]) / 2 ** 20:.0f} MiB "
                           f"D={D}",
                     lambda: ts.transfer_walk_cuda(packed, segmap, data, m,
                                                   D, G),
                     lambda: ts.transfer_walk_plain(packed, segmap, data, m,
                                                    D, G),
                     headline=headline,
                     in_bytes=int(data.shape[0]) + nbytes(packed, segmap))
        steps = S * int(data.shape[0])
        print(f"[kernels] {kind:14} {name}: S={S} NSEG="
              f"{int(packed.shape[1])}, {D} shard(s) x G={G} pieces of "
              f"{ts.piece_len(m, G)} bytes in {ts.SUB} sub-pieces of "
              f"{ts.sub_len(ts.piece_len(m, G))}, "
              f"{int(ts.silent_states(packed).sum())} silent state(s), "
              f"{steps} table steps: {steps / ms / 1e9:.2f} G steps/ms (at "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        if headline:
            SLICE_MS[(kind, name)] = ms

    for mode in (ts.MODE_DFA, ts.MODE_COUNT):
        for name, _ in CONFIGS:
            case(name, mode, small, 1, False)
    del small
    big = transfer_data(TRANSFER_MAIN, corpus, len(corpus) >> 20)
    for mode in (ts.MODE_DFA, ts.MODE_COUNT):
        case(TRANSFER_MAIN, mode, big, MESH_SHARDS, True)
    del big
    for name in TRANSFER_EXTRA:
        data = transfer_data(name, corpus, TRANSFER_EXTRA_MIB)
        for mode in (ts.MODE_DFA, ts.MODE_COUNT):
            case(name, mode, data, MESH_SHARDS, False)
        del data
    torch.cuda.empty_cache()
    print(f"[kernels] transfer walk: {time.perf_counter() - t_start:.1f} s")


def phase_e2e_multi(base: bytes, arr: np.ndarray):
    """The multi-device layer at the main path's width, on a virtual mesh
    of MESH_SHARDS shards on the card (the one card's own mesh holds one
    device, so the Engine's hooks are off unless a mesh is substituted):
    ShardedGoCount.count of the 13 bench patterns on that mesh and on a
    mesh of 1 against the single-device count (K1), also on n % 4 != 0
    bytes for MULTI_ODD; the Engine's find_all of MULTI_FIND_ALL with
    ``default_mesh`` replaced by the virtual mesh (the _sharded_starts hook
    over make_sharded_ends, or its decline when a shard's starts overflow
    the reference's buffer) against the tiled oracle; make_sharded_ends of
    the first at a buffer that holds its starts against the single-device
    starts; distributed_count in a world of one process under NCCL (a
    file:// rendezvous) against K9's flag count; ShardedPhaseProbe's three
    phases.  The comparisons' own K1 and K9 launches are not counted."""
    import os
    import shutil
    import tempfile
    import torch
    import coregex_tpu_torch as ct
    from coregex_tpu_torch.dfa.dense import CTX_SOT
    from coregex_tpu_torch.ops.count_scan import COUNT_KERNEL
    from coregex_tpu_torch.ops.dfa_scan import (MATCH_KERNEL, DFATables,
                                                exit_at_end,
                                                flags_count_upto)
    from coregex_tpu_torch.parallel import distributed, shard
    from coregex_tpu_torch.parallel.sharded_count import (
        ShardedGoCount, ShardedPhaseProbe)
    from coregex_tpu_torch.utils.corpus_cache import (device_corpus,
                                                      device_corpus_flipped)

    def oracle(fn):
        """fn() with the K1 and K9 launches it makes left uncounted."""
        saved = COUNT_KERNEL.launches, MATCH_KERNEL.launches
        out = fn()
        COUNT_KERNEL.launches, MATCH_KERNEL.launches = saved
        return out

    def best_of(fn, k=2):
        out = fn()
        best = float("inf")
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, best

    B = len(base)
    n = len(arr)
    reps = n // B
    D = MESH_SHARDS
    dev = device_corpus(arr, DEVICE)
    odd_n = n - 1 if (n - 1) % D else n - 2
    meshes = {D: virtual_mesh(D), 1: virtual_mesh(1)}
    routes = {}
    print(f"[multi] corpus {n} bytes (n % {D} = {n % D}); virtual mesh of "
          f"{D} shards on {DEVICE}, and of 1", flush=True)
    for name, pattern in CONFIGS:
        eng = ct.compile(pattern, device=DEVICE)
        be = eng.batch_engine()
        sc = be._count_scanner()
        if not sc:
            fail(f"{name}: no count transducer")
        want, k1 = oracle(lambda: best_of(lambda: sc.count(dev)))
        line = (f"[multi] {name:16} S={sc.cd.num_states:3} K1 {want:>10} "
                f"({k1 * 1e3:.1f} ms)")
        for k, mesh in meshes.items():
            shc = ShardedGoCount(sc.cd, mesh)
            got, wall = best_of(lambda: shc.count(dev))
            if got != want:
                fail(f"{name}: sharded count on {k} shard(s) {got} != K1 "
                     f"{want}")
            line += f" | {k} shard(s) equal ({wall * 1e3:.1f} ms)"
        if name in MULTI_ODD:
            part = dev[:odd_n]
            want = oracle(lambda: sc.count(part))
            got = ShardedGoCount(sc.cd, meshes[D]).count(part)
            if got != want:
                fail(f"{name}: sharded count of {odd_n} bytes {got} != K1 "
                     f"{want}")
            line += f" | {odd_n} bytes (n % {D} = {odd_n % D}) equal"
        print(line, flush=True)
        routes[f"{name} multi-device"] = be.host_routes
    rng = np.random.default_rng(17)
    # keyword lists whose reverse table is outside the transfer walk's gate:
    # their one-card spans, for the mesh's find_all below
    kws = dict(band_patterns(big_cut(base)))
    one_card = {}
    for name in MULTI_GATE:
        r = oracle(lambda: ct.compile(kws[name], device=DEVICE)
                   .batch_engine().find_all_spans_device(arr))
        if r is None:
            fail(f"{name}: the one-card find_all declined")
        one_card[name] = r[0][:r[1]].clone()
        del r
    saved = shard.default_mesh
    shard.default_mesh = (lambda n_devices=None, device=None, axis="data":
                          shard.Mesh([device] * D, axis))
    try:
        for name, pattern in MULTI_FIND_ALL:
            inner, tail = tiled_spans(oracle_spans(pattern, base), B, reps)
            be = ct.compile(pattern, device=DEVICE).batch_engine()
            served = []
            hook = be._sharded_starts

            def spy(rev, data, hook=hook, served=served):
                served.append(hook(rev, data))
                return served[-1]
            be._sharded_starts = spy
            line = check_find_all(
                name, be, arr, tiled_digest(inner, tail, B, reps, rng),
                kernels=[("K9", MATCH_KERNEL)])
            if not served:
                fail(f"{name}: find_all did not reach the _sharded_starts "
                     f"hook")
            how = ("served by _sharded_starts" if served[-1] is not None
                   else f"_sharded_starts declined: a shard's starts "
                   f"overflow max(4096, n // 256) = {max(4096, n // 256)}")
            print(f"[multi] {name:12} {line} | {how}", flush=True)
            if name == "word_error" and served[-1] is None:
                fail(f"{name}: the _sharded_starts hook declined")
            routes[f"{name} multi-device"] = be.host_routes
        # the hook declines a reverse table past the walk's gate before the
        # upload (P6), and the one-device path gives the one card's spans
        for name in MULTI_GATE:
            be = ct.compile(kws[name], device=DEVICE).batch_engine()
            S, nseg = be._full_scan_route()[0].tables.packed.shape
            served = []
            hook = be._sharded_starts

            def spy(rev, data, hook=hook, served=served):
                served.append(hook(rev, data))
                return served[-1]
            be._sharded_starts = spy
            t0 = time.perf_counter()
            r = be.find_all_spans_device(arr)
            wall = time.perf_counter() - t0
            if r is None or not served or served[-1] is not None:
                fail(f"{name}: the mesh's find_all did not decline the "
                     f"sharded starts of its [{S}, {nseg}] reverse table")
            if not torch.equal(r[0][:r[1]], one_card[name]):
                fail(f"{name}: the mesh's find_all differs from the one "
                     f"card's")
            print(f"[multi] {name:12} reverse table [{S}, {nseg}]: "
                  f"_sharded_starts declined before the upload; find_all "
                  f"{r[1]} spans equal the one card's ({wall * 1e3:.1f} ms, "
                  f"first call)", flush=True)
            routes[f"{name} multi-device"] = be.host_routes
            del r, be
        one_card.clear()
    finally:
        shard.default_mesh = saved
    # make_sharded_ends at a buffer that holds every start, against the
    # single-device starts of the same reverse scan
    name, pattern = MULTI_FIND_ALL[0]
    be = ct.compile(pattern, device=DEVICE).batch_engine()
    rev = be._chunk_scanner("rev_all")
    starts, m, ok = oracle(lambda: be._all_starts(rev, arr))
    flipped = device_corpus_flipped(arr, DEVICE)
    if n % D:
        flipped = torch.cat([flipped, flipped.new_zeros(-n % D)])
    fn = shard.make_sharded_ends(meshes[D], rev.tables, m + 16)
    (pos, cnt), wall = best_of(lambda: fn(flipped), 1)
    got = n - pos[pos < n].flip(0)
    at0 = m - int(got.numel())
    if not bool(ok) or at0 not in (0, 1) or not torch.equal(
            got.to(torch.int32), starts[at0:m]):
        fail(f"{name}: make_sharded_ends' starts differ from the single "
             f"device's ({int(got.numel())} vs {m})")
    print(f"[multi] {name:12} make_sharded_ends on {D} shards, cap "
          f"{m + 16}: {int(got.numel())} starts (shards {cnt.tolist()}) "
          f"equal the single device's ({wall * 1e3:.1f} ms)", flush=True)
    del starts, flipped, pos, got
    # distributed_count in a world of one process under NCCL
    tmp = tempfile.mkdtemp(prefix="coregex_nccl_")
    try:
        t0 = time.perf_counter()
        distributed.initialize("file://" + os.path.join(tmp, "rendezvous"),
                               1, 0, backend="nccl")
        be = ct.compile(r"\d+\.\d+", device=DEVICE).batch_engine()
        tables = DFATables.from_dense(be._dense("fwd_all"))
        cut = n - n % D
        got = distributed.distributed_count(
            tables, dev[:cut], shard.Mesh([DEVICE] * D, "data", 1, 0))
        wall = time.perf_counter() - t0
        sc = be._chunk_scanner("fwd_all")

        def k9():
            scan = sc.scan_device(dev[:cut])
            return int(flags_count_upto(scan)) + int(
                tables.match_eoi[int(exit_at_end(scan)), CTX_SOT])
        want = oracle(k9)
        if got != want:
            fail(f"distributed_count {got} != K9's flag count {want}")
        print(f"[multi] distributed_count of \\d+\\.\\d+ under "
              f"{torch.distributed.get_backend()} (world "
              f"{torch.distributed.get_world_size()}, {D} shards): {got} "
              f"ends equal K9's ({wall:.2f} s with the rendezvous)",
              flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    # the probe's three phases
    for name in (TRANSFER_MAIN, "multi_literal32"):
        be = ct.compile(PATTERNS[name], device=DEVICE).batch_engine()
        cd = be._count_scanner().cd
        r = ShardedPhaseProbe(cd, meshes[D]).measure(dev, reps=3)
        if n % D == 0 and r["count"] != ShardedGoCount(
                cd, meshes[D]).count(dev):
            fail(f"{name}: probe count {r['count']} differs from the "
                 f"sharded count")
        print(f"[multi] ShardedPhaseProbe {name} on {D} shards: phase 1 "
              f"{r['phase1_scan'] * 1e3:.3f} ms, collective "
              f"{r['collective'] * 1e3:.3f} ms, phase 2 "
              f"{r['phase2_fold'] * 1e3:.3f} ms (count {r['count']})",
              flush=True)
    print(f"[multi] kernels (phase 3) on {TRANSFER_MAIN}: transfer_walk "
          f"{SLICE_MS[('transfer_walk', TRANSFER_MAIN)]:.3f} ms, "
          f"transfer_count "
          f"{SLICE_MS[('transfer_count', TRANSFER_MAIN)]:.3f} ms",
          flush=True)
    return routes


def kernel_counters():
    """(launch counter, CUDA source, the TPU kernel it replaces) of every
    kernel, in the order of the JSON line."""
    from coregex_tpu_torch.ops import (compact, compact2, compact_exp,
                                       count_scan, dfa_scan, flag_scan,
                                       line_scan, nfa_scan, onepass_scan,
                                       rowscan, seq_scan, span_scan,
                                       transfer_scan)
    ops = "coregex_tpu/ops/"
    return [
        (count_scan.COUNT_KERNEL, "lane_scan.cu", ops + "count_scan.py:211"),
        (span_scan.SPAN_KERNEL, "lane_scan.cu", ops + "span_scan.py:108"),
        (flag_scan.FLAG_KERNEL, "lane_scan.cu", ops + "flag_scan.py:164"),
        (compact2.COMPACT_KERNEL, "compact.cu", ops + "compact2.py:91"),
        (line_scan.LINE_KERNEL, "needle_scan.cu", ops + "line_scan.py:78"),
        (line_scan.HITS_KERNEL, "needle_scan.cu", ops + "line_scan.py:407"),
        (seq_scan.SEQ_KERNEL, "needle_scan.cu", ops + "seq_scan.py:103"),
        (compact.COMPACT_POS_KERNEL, "compact.cu", ops + "compact.py:97"),
        (dfa_scan.MATCH_KERNEL, "lane_scan.cu", ops + "pallas_scan.py:35"),
        # a lax.scan loop of the reference, with no Pallas kernel
        (dfa_scan.WINDOW_KERNEL, "window_scan.cu", ops + "dfa_scan.py:626"),
        (compact_exp.COMPACT_EXP_KERNEL, "compact_exp.cu",
         "tools/_compact_exp.py:67"),
        # the window scan's ends form: the reference's _window_scan, the
        # lax.scan its WindowScanner rounds run
        (dfa_scan.WINDOW_ENDS_KERNEL, "window_scan.cu",
         ops + "dfa_scan.py:495"),
        # the BITSET_NFA scan: a lax.scan with an MXU step and a while_loop
        # repair, no Pallas kernel
        (nfa_scan.BITSET_KERNEL, "nfa_scan.cu", ops + "nfa_scan.py:237"),
        # the captures and row batches: three lax.scan loops, no Pallas
        # kernel
        (onepass_scan.ONEPASS_KERNEL, "onepass_scan.cu",
         ops + "onepass_scan.py:84"),
        (rowscan.ROWS_KERNEL, "row_scan.cu", ops + "rowscan.py:57"),
        (rowscan.ROWS_REV_KERNEL, "row_scan.cu", ops + "rowscan.py:90"),
        # the multi-device layer's phase 1: the lax.scans of the sharded
        # scan and of the sharded count, no Pallas kernel
        (transfer_scan.TRANSFER_KERNEL, "transfer_scan.cu",
         "coregex_tpu/parallel/shard.py:37"),
        (transfer_scan.TRANSFER_COUNT_KERNEL, "transfer_scan.cu",
         "coregex_tpu/parallel/sharded_count.py:83"),
        # the candidate pipeline's reset scan: a lax.scan in a while_loop,
        # no Pallas kernel
        (dfa_scan.RESET_KERNEL, "lane_scan.cu", ops + "dfa_scan.py:685"),
        # the global-memory instances of K1, K2, K3, K9 and both window
        # forms, for tables past shared memory (the flags form has no user
        # path)
        (count_scan.GLOBAL_KERNELS[count_scan.MODE_COUNT], "lane_scan.cu",
         ops + "count_scan.py:211"),
        (count_scan.GLOBAL_KERNELS[count_scan.MODE_SPAN], "lane_scan.cu",
         ops + "span_scan.py:108"),
        (count_scan.GLOBAL_KERNELS[count_scan.MODE_FLAG], "lane_scan.cu",
         ops + "flag_scan.py:164"),
        (count_scan.GLOBAL_KERNELS[count_scan.MODE_MATCH], "lane_scan.cu",
         ops + "pallas_scan.py:35"),
        (dfa_scan.WINDOW_GLOBAL[dfa_scan.WINDOW_KERNEL], "window_scan.cu",
         ops + "dfa_scan.py:626"),
        (dfa_scan.WINDOW_GLOBAL[dfa_scan.WINDOW_ENDS_KERNEL],
         "window_scan.cu", ops + "dfa_scan.py:495"),
    ]


def main():
    card = phase_device()
    import torch
    try:
        import coregex_tpu_torch  # noqa: F401
    except ImportError as ex:
        fail(f"cannot import coregex_tpu_torch: {ex}")
    counters = kernel_counters()
    # kernels each run of phase 4 must launch: the earlier slices' path,
    # then the class-run and nullable path (K1 for the `\w*` count, K2/K3
    # for the ip core, K4 for class runs and chains, K8 for `\w*`), then
    # the single-match path (K9 and the window scan's ends form), then the
    # literal path and the compaction rig (K4 for the literal chains, K10),
    # then the general find_all (K9 over the reverse DFA, the ends form for
    # the ends, K4 for the starts, the alive lanes and the chain, K8 for
    # ALL_EMPTY), then BITSET_NFA (the bitset scan for the starts and
    # is_match, the ends form, K4 for the starts and the chain), then the
    # captures and row batches (the OnePass walk, both row scans, K2-K4 for
    # the capture patterns' bidi spans), then the multi-device layer (the
    # transfer walk in both modes, K9 and K8 for the sharded ends), then
    # leftmost-longest (K9 over the reverse DFA, the ends form over
    # fwd_anch_all, K4 for the starts and the chain, the bitset scan for
    # BITSET_NFA's starts), then M5 and invalid UTF-8 (the reset scan for
    # the candidates, K3 in its interference mode for INNER suffixes, K4
    # and K8 for their compactions, the ends form for the PREFIX_RUN bulk
    # count), then tables past shared memory (the global-memory instances
    # of K1, K2 and K3 for KWL600, K3 for INNER60, K9 and the ends form);
    # the flags form has no caller on a user path (its checks are phase
    # 3's)
    paths = [("earlier slices", phase_e2e,
              [c for c, _, _ in counters[:7]]),
             ("class runs and nullable", phase_e2e_class_nullable,
              [counters[i][0] for i in (0, 1, 2, 3, 7)]),
             ("single match", phase_e2e_single_match,
              [counters[i][0] for i in (8, 11)]),
             ("literal find_all and compaction rig", phase_e2e_literal,
              [counters[i][0] for i in (3, 10)]),
             ("general find_all", phase_e2e_general,
              [counters[i][0] for i in (8, 11, 3, 7)]),
             ("BITSET_NFA", phase_e2e_bitset,
              [counters[i][0] for i in (12, 11, 3)]),
             ("captures and row batches", phase_e2e_captures_rows,
              [counters[i][0] for i in (13, 14, 15, 1, 2, 3)]),
             ("multi-device", phase_e2e_multi,
              [counters[i][0] for i in (16, 17, 8, 7)]),
             ("leftmost-longest", phase_e2e_posix,
              [counters[i][0] for i in (8, 11, 3, 12)]),
             ("M5 pipelines and invalid UTF-8", phase_e2e_m5,
              [counters[i][0] for i in (18, 2, 3, 7, 11)]),
             ("tables past shared memory", phase_e2e_big_tables,
              [counters[i][0] for i in (19, 20, 21, 22, 24)]),
             ("keyword lists of 16-230 KB tables", phase_e2e_band,
              [counters[i][0] for i in (0, 8, 11)]),
             ("limits at MAX_CORPUS", phase_e2e_limits,
              [counters[i][0] for i in (0, 1, 2, 3, 4, 5, 7, 8, 11, 12)])]
    build_s = phase_build()
    base = build_base()
    corpus = bench_corpus(base)
    kres = phase_kernels(base, corpus)

    launches = {c.name: 0 for c, _, _ in counters}
    routes = {}
    for what, phase, needed in paths:
        for c, _, _ in counters:
            c.launches = 0
        t0 = time.perf_counter()
        routes.update(phase(base, corpus))
        e2e_s = time.perf_counter() - t0
        run = {c.name: c.launches for c, _, _ in counters}
        print(f"[routes] launches during the {what} run ({e2e_s:.1f} s): "
              f"{run}")
        for c in needed:
            if run[c.name] <= 0:
                fail(f"kernel {c.name} was not launched on the {what} "
                     f"path")
        for k, v in run.items():
            launches[k] += v
    if any(routes.values()):
        fail(f"slice calls declined to the host loop: {routes}")
    print(f"[routes] no unexpected host routes in {len(routes)} pattern "
          f"runs; "
          f"build {build_s} s on {card}")
    print(json.dumps({"kernels": [
        {"name": c.name, "route": "cuda",
         "source": f"coregex_tpu_torch/csrc/{src}",
         "replaces": ref, "launches": launches[c.name],
         **{k: kres[c.name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for c, src, ref in counters]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
