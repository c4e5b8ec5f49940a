"""Corpus-scale execution on a torch device: count, find_all, is_match and
find_first.

Ports the main path of ``coregex_tpu/meta/batch.py:BatchEngine``: plan
selection (:296-344), ``_dense`` (:351-419) for the kinds the paths use,
the count scanners (:1456-1629), ``count`` (:1698-1790) with
``nullable_count``'s route and UTF-8 gate (:1668-1696) folded in,
``_line_shape_parts`` (:2091-2097), the bidirectional span path
(:999-1184), the line-shape span path (:798-848), the class-run path
(``_chop_runs`` :54, ``_charclass_spans_dev`` :710-742 with
``_charclass_dense_pair`` :744-758 folded in), the literal paths
(``_literal_spans_dev`` :678-708, ``_multi_literal_spans_dev`` :760-796,
one method here), the nullable paths (``_core``
:2467-2476, ``_nullable_spans_dev`` :589-633,
``_nullable_general_spans_dev`` :635-676), ``find_all_spans_device``
(:523-587), ``find_all_spans``, ``_end_anchored_spans`` (:1402-1413),
``is_match`` (:1415-1450), ``find_first`` (:1803-1863),
``_charclass_first`` (:1865-1881), ``_find_first_dfa`` (:1883-1917),
``_rev_start_flags`` (:2252-2307, kind="rev_anch") as ``_rev_start``, the
general find_all (``_all_starts`` :2584-2600, ``_full_scan_spans``
:2602-2610, its ``go_select`` :122-144 on the device), the ``{m,k}`` class
split of ``_charclass_spans`` (:2028-2075), ALL_EMPTY's spans
(``meta/nullable.py:all_empty_spans``) and the BITSET_NFA tier
(``_bitset_scanner``, ``_bitset_starts`` as ``_bitset_rev_scan`` with
``_compact_starts``, ``_bitset_is_match``, ``_bitset_spans``,
``_bitset_nfa_spans_dev`` and ``_spans_from_starts_host``, :2385-2522 and
:1308-1335), the multi-device hooks (``_sharded_counter`` :1644-1666,
``_sharded_starts`` :2526-2571, over ``..parallel``) and the candidate and
INNER pipelines (M5: ``_sieve_ranges`` :421, ``_class_run_prefix`` :851,
``_inner_spans_dev`` :878, ``_interleaved_ends`` :1191, ``_flags_with_eoi``
:1273 folded into it, ``_candidate_spans_dev`` :1285,
``_spans_from_candidate_mask`` :1337, ``_note_prefilter_counts`` :1387,
``_prefix_run_table`` and ``_prefix_run_candidates_mask`` :1949-1963,
``_prefix_run_count_device`` :2001).  The
port builds on its own copy of the host pipeline (``..dfa``, ``..nfa``,
``.strategy``, ``.literal``) and imports nothing of ``coregex_tpu``.

Routes:
  * every entry point reads the corpus as Go decodes it: each byte that
    starts no valid UTF-8 sequence is one U+FFFD, held as 0xFF
    (``corpus_cache.go_bytes``, once per corpus; ``_go``), so the routes'
    tables, host replays and device buffers see the same bytes (ROADMAP
    P4; the reference stops at a valid lead byte that lacks its
    continuation bytes, F14).
  * count, in the reference's order (:1740-1790): END_ANCHORED plans scan
    back from the end on the host; K5 (LineScanner) for a LINE_SHAPE or
    line-set FULL_SCAN plan that ``_line_shape_args`` accepts; K6
    (HitsScanner) for LITERAL and MULTI_LITERAL plans, and K7 (SeqScanner,
    MODE_MULTI) when K6 finds two hits overlapping; otherwise the count
    transducer (the nullable transducer, behind its UTF-8 gate, for
    nullable plans).  A nullable plan outside that gate, a BITSET_NFA plan
    (whose transducer overflows) and a PREFIX_RUN plan with no transducer
    count their device find_all, as the reference counts its span list;
    such a PREFIX_RUN plan that no find_all route serves takes the bulk
    count (window ends from every candidate run start,
    ``_prefix_run_count_device``, ref. :1791-1794), which the reference
    tries first.  The reference's class-run, memmem
    and multi-literal XLA counts are not ported; the transducer gives the
    same counts.  Unlike the reference, these routes
    run on every device (its scanners run only on a TPU backend) and a
    failing scanner raises instead of being retired.  The reference
    reaches K7 in MODE_LINE only after retiring a LineScanner, since both
    take the same needle sets, so the port does not route it.  With a
    mesh of several devices (``parallel.shard.default_mesh`` of the
    engine's device; one H100 gives a mesh of one) the sharded count
    transducer counts before these routes, and for a nullable plan once
    its transducer's gate passes, as the reference's does; it declines
    only for a transducer wider than the phase-1 gate (512 states) and
    raises where the reference retires it.
  * find_all: the bidirectional span path for PREFIX_RUN, PREFIX_SET,
    FULL_SCAN and INNER plans whose count transducer is spans_simple with
    no EOI_COMPLEX state and that have no look; behind it, the general
    fallback for the other plans of those four families
    (``_full_scan_spans_dev``: K9 over the unanchored reverse DFA for every
    match start, sharded over the mesh with each shard's starts compacted
    where a mesh of several devices serves the corpus, the forward window
    scan for their ends, Go's chain on the device), unless its DFAs
    overflow or do not fit the kernels; where it declines a PREFIX_RUN,
    PREFIX_SET or INNER plan, under either rule, the M5 pipeline (the
    candidate pipeline: run starts through the offset sieve, or prefix
    literal hits, verified by interleaved reset scans (the lane walk's
    reset mode, ``csrc/lane_scan.cu``);
    the INNER pipeline: a class-run prefix, the literal and K3's
    interference-mode scan of the suffix), which is 7-14x slower on the
    card where both serve; the candidate chain for
    LINE_SHAPE plans with newline-free, non-empty literals and no ``(?s)``
    part, the at-most-one-match construction of the reference's
    ``_line_shape_any`` (:2223-2250) for those with a ``(?s)`` part, and
    the general fallback for the others (a newline in the literal, a
    line-anchored ``(?s)`` shape), as the reference's
    ``_line_shape_spans`` falls to ``_full_scan_spans`` (:2201); class
    runs for CHARCLASS plans (two sparse chains, or K4 over the unpacked
    masks when runs are dense; ``([class]{m,k})+`` chops a
    run to its match, ``[class]{m,k}`` splits it into its matches); for
    LITERAL and MULTI_LITERAL plans the hit words and their chains (K4 over
    the unpacked masks when hits are dense), with Go's leftmost-first
    selection on the device when hits overlap; for NULLABLE_CORE plans
    two K8 compactions when the core is ``[class]+`` and the corpus ASCII,
    else the core's own route plus the empty fill when that route serves
    the corpus (past DEVICE_SPANS_LIMIT positions, a corpus piece at a
    time); for ALL_EMPTY plans one K8 compaction of the rune boundaries
    (past that limit, a corpus piece at a time); the host reverse scan
    for END_ANCHORED plans; for BITSET_NFA plans every match start from
    the bitset-NFA scan of the reverse NFA over the flipped corpus
    (``ops/nfa_scan.py``), then the general fallback's ends
    and chain, or, when the anchored DFA overflows or does not fit the
    kernels, Go's restart walk over the starts with the Engine's host
    search for the ends (the reference's route for that case); a reverse
    NFA out of the scan's scope (more than 512 range states, more than 4
    closure groups) declines.  A limit (find_all_index(t, k)) takes the
    same routes and keeps the first k spans (the host walk stops after
    k).
  * leftmost-longest (POSIX, ``compile_posix``): find_all, find_all with a
    limit and count take the find_all routes above, as the reference's
    do, with the rule in their tables and arithmetic (``_verify_kind``,
    ref. :345-348): the general fallback serves FULL_SCAN, PREFIX_RUN,
    PREFIX_SET and INNER plans and BITSET_NFA takes its ends from the
    anchored all-matches DFA ``fwd_anch_all``, whose last flag from a
    start is the longest end (the host search's ends, where it overflows,
    are the longest too); MULTI_LITERAL plans list their literals longest
    first, so the longest literal wins at a start; ``([c]{m,k})+`` takes
    each run's longest prefix that splits into m- to k-byte pieces
    (``_chop_runs_longest``; the reference chops leftmost-first here,
    ROADMAP F12); the other class runs, literals, line shapes and
    END_ANCHORED give the same spans under both rules.  Count is the
    length of the device find_all (ref. :1798-1800).  Still declining:
    the bidirectional path (its transducer is leftmost-first, so those
    plans take the general fallback), nullable plans (the plan is HOST,
    as in the reference), and whatever declines leftmost-first (a DFA
    that overflows or does not fit, a reverse NFA out of the bitset
    scan's scope).  find_first and find_index of a
    leftmost-longest engine stay on the host, as in the reference
    (engine.py:238); its captures take their spans from the card and
    their groups from the PikeVM (the reference's gate, engine.py:423).
  * is_match: True for nullable plans; the host reverse scan for
    END_ANCHORED; one K9 scan over ``fwd_all`` for FULL_SCAN; one forward
    bitset scan for BITSET_NFA when the forward NFA is in the scan's
    scope; for the other strategies ``find_first(...) is not None`` (the
    reference asks its find_all pipelines with limit 1, not ported).  Any
    match rule.
  * find_first: chunked literal scans for LITERAL and MULTI_LITERAL; the
    first qualifying class run for CHARCLASS; the host reverse scan for
    END_ANCHORED; for BITSET_NFA the first start of find_all's reverse
    bitset scan and its end (window scan or host search); K9 over
    ``fwd_break`` on growing prefixes, then the window kernel from the end
    backwards, for the others.  Nullable plans decline, as in the
    reference.
Limits: every find_all route serves corpora up to MAX_CORPUS
(SPARSE_SPANS_LIMIT); a result past MAX_DEVICE_SPANS spans (2^30, the cap
of one compaction) is one [T, 2] array filled a piece at a time, each
piece cut from the running counts of the words or mask it compacts and
compacted with a cap within the limit, positions absolute; a selection
that walks from one candidate to the next (Go's chain over overlapping
hits or matches, a line's first or last candidate) carries its state
across the seams.  ``pieces`` keeps the last call's output and corpus
pieces.  The reference's device routes stop at its limit and its host
pipelines take over.  Past MAX_CORPUS a call raises (positions are
int32, F6).
A call outside these routes returns None (find_first returns FALLBACK) and
the Engine's host loop serves it; each such decline adds one to
``host_routes``.  The route is decided on the host, from the plan, its
tables (a DFA that overflows, a count transducer past its state limit, or
K3's alphabet past 64 classes declines, as in the reference), the core's
plan and the corpus's ASCII verdict, before the corpus is uploaded.  A
table of any size takes the kernels: in shared memory where it fits, in
global memory past it (a list of hundreds of keywords).  Once a call is
on the device it finishes there or raises: the repair fixpoints run until
they settle (at most L rescans).

Corpus state (the host array, its ASCII verdict) travels as arguments, not
engine attributes, so concurrent calls on one engine cannot mix corpora
(ROADMAP F1).  Device calls serialize on a per-device lock.
"""

from __future__ import annotations

import dataclasses
from contextlib import ExitStack
from typing import Dict, Optional

import numpy as np
import torch

from ..dfa.countdfa import (EOI_COMPLEX, build_count_dfa,
                            build_count_dfa_nullable)
from ..dfa.dense import CTX_SOT, DEAD
from ..dfa.determinize import DFAOverflow, determinize, determinize_py
from ..dfa.search import anchored_last_end, find_rev_start
from ..nfa.thompson import compile_nfa
from ..ops.bytescan import (_bucket, _memmem_mask, _multi_literal_scan,
                            _range_mask, bulk_count, first_run_geq,
                            first_set_index, last_set_index,
                            literal_self_overlaps, mask_count,
                            prefix_run_candidates, table_to_ranges)
from ..ops.compact import compact_positions, compact_positions_into
from ..ops.compact2 import (_bucket_up, compact_pay, sparse_chain_payloads,
                            word_pieces)
from ..ops.count_scan import CountScanner, make_word_tiles, plan_geometry
from ..ops.dfa_scan import (ChunkScanner, DFATables, ResetScanner,
                            exit_at_end, flags_count_upto, flags_last,
                            window_ends, window_ends_round)
from ..ops.flag_scan import (FlagResetScanner, ResetFlagTables,
                             reset_geometry, scatter_reset_tiles,
                             sym_base_tiles)
from ..ops.line_scan import HitsScanner, LineScanner
from ..ops.nfa_scan import BitsetNFAScanner, LookUnsupported
from ..ops.seq_scan import MODE_MULTI, SeqScanner, seq_geometry
from ..ops.sieve import offset_byte_ranges
from ..ops.span_chain import (MULTI_FUSED_LIMIT, SPARSE_OK, _shift_words,
                              bidi_assemble, bidi_assemble_pieces, bidi_ends,
                              bidi_ends_pieces, chain_select_pieces,
                              class_run_words, expand_class_runs,
                              inner_assemble, inner_cand_arrays,
                              inner_cand_symbols, inner_flag_arrays_words,
                              reset_interval_ends,
                              leftmost_first_spans,
                              line_event_words, line_spans_pieces, literal_lengths,
                              literal_spans_sparse, literal_words,
                              multi_literal_words, multi_literal_words_big,
                              nullable_class_masks, nullable_fill_range,
                              nullable_merge_into, pair_spans_pieces,
                              pair_spans_sparse, reset_words,
                              rune_boundaries_range, word_positions,
                              word_positions_into)
from ..ops import transfer_scan
from ..ops.span_scan import SpanScanner, to_global
from ..parallel import shard
from ..parallel.sharded_count import Phase1TooWide, ShardedGoCount
from ..syntax.ast import Node, Op
from ..syntax.parser import Parsed
from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_WORD
from ..utils.artifact_cache import load_dense, save_dense
from ..utils.corpus_cache import (_fingerprint, corpus_is_ascii,
                                  corpus_tiles, device_corpus,
                                  device_corpus_flipped, go_bytes)
from ..utils.device_lock import device_lock
from . import literal as litmod
from .literal import UNIV_ANY, UNIV_LINE
from .strategy import Plan, Strategy, select

# Sentinel distinct from None ("no match"): the device path is out of scope
# and the caller falls back to the host engine (ref. batch.py:40-43).
# Never test find_first results by truthiness.
FALLBACK = object()

# positions are int32 on the device path (ROADMAP F6): the reverse scan
# walks n + 32 symbols, and every position must stay below 2^31
MAX_CORPUS = 2 ** 31 - 33


def _empty_spans(device):
    return torch.zeros((16, 2), dtype=torch.int32, device=device)


def _chop_runs(spans, mn: int, mx: int):
    """([c]{m,k})+ whole-run form applied to maximal-run spans (ref.
    batch.py:54-80): greedy k-chunks plus the remainder iff >= m, the
    host path's arithmetic on hit-sized arrays.  Dead rows (end == start)
    map to themselves."""
    s, e = spans[:, 0], spans[:, 1]
    r = (e - s) % mx
    return torch.stack([s, e - torch.where(r < mn, r, 0)], dim=1)


def _chop_runs_longest(spans, mn: int, mx: int):
    """The leftmost-longest ([c]{m,k})+ match of each maximal run of
    length L >= m: its longest prefix of x <= L bytes that splits into j
    pieces of m to k bytes (j*m <= x <= j*k), x = min(L, (L // m) * k),
    since the ranges for j pieces grow with j; L - x < m, so no further
    match fits in the run.  The reference applies ``_chop_runs`` here
    (ROADMAP F12).  Dead rows map to themselves."""
    s, e = spans[:, 0], spans[:, 1]
    L = e - s
    return torch.stack([s, s + torch.minimum(L, L // mn * mx)], dim=1)


class BatchEngine:
    """Per-pattern batch plan + device artifacts on one torch device."""

    # Span limits for one 80 GB H100 (the reference sized its own,
    # batch.py:484-492, for a 16 GB chip).
    #  * MAX_DEVICE_SPANS: the largest cap one compaction is given (a cap
    #    is an int in cgx_compact, and _bucket rounds a total up to a power
    #    of two, so totals <= 2^30 keep every cap <= 2^30).  It bounds a
    #    piece, not a result: a result past it is one [T, 2] int32 array
    #    (8 bytes a span) filled a piece at a time, each piece cut from the
    #    running counts of the words or mask it compacts.
    #  * DEVICE_SPANS_LIMIT: the corpus positions of one piece of the
    #    general nullable path's empty fill and merge (and of ALL_EMPTY's
    #    boundary mask): per position the int32 cover difference and its
    #    running sum, three bool masks (about 11 bytes: 11 GiB a piece).
    #  * CHAIN_PIECE: the candidates of one piece of a chain whose levels
    #    and selection hold about 30 bytes a candidate (the bidirectional
    #    chains, Go's selection over overlapping literal hits or general
    #    matches): 7.5 GiB at 2^28, beside the [T, 2] output (16 GiB at
    #    2^31 spans).  At 2^30 a piece, `aa` on MAX_CORPUS bytes of `a`
    #    (2^31 - 34 overlapping hits) peaked at 68.25 GiB.
    #  * SPARSE_SPANS_LIMIT is MAX_CORPUS: every find_all route measured
    #    stays under 60 GiB of device memory at 2,145,381,040 bytes (341
    #    tiles of chip_smoke.build_base), 60 GiB leaving room for a second
    #    corpus and the CUDA context.  Peaks (torch.cuda.max_memory_allocated,
    #    the 2 GiB corpus and its cached tiles included; chip_smoke.py's
    #    limits run on NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 5),
    #    on the bench tiles: the literal and line routes 6.0-14.5 GiB, the
    #    bidirectional path 14.8 (ip, email) and 41.2 (`.`, 2.10G spans in
    #    8 pieces), the general route 19.8, BITSET_NFA 8.1, the class runs
    #    and their split 14.5, `\w*` 14.0, ALL_EMPTY 28.0 and `(error)?`
    #    30.2 (2.14G spans); on each route's densest corpus of that size
    #    (chip_smoke.LIMITS_DENSE: a's, spaces, "a " repeated): the class
    #    split 20.8 (2.15G spans), literal words 27.3 (2.15G), overlapping
    #    hits 30.8, the general route 34.3 (2.15G) and 22.5, line
    #    candidates 23.5 (2.1G in 2^28 runs), the K8 pair 38.0 (2.15G
    #    empties), class runs 18.5 (1.07G runs, the most n bytes hold).
    #    Not measured: the multi-device hook _sharded_starts (a mesh of
    #    cards).
    SPARSE_SPANS_LIMIT = MAX_CORPUS
    MAX_DEVICE_SPANS = 2 ** 30
    DEVICE_SPANS_LIMIT = 2 ** 30 - 1
    CHAIN_PIECE = 2 ** 28
    # plans whose find_all takes the bidirectional path: the bidi branches
    # of the reference's _prefix_family_spans_dev / _inner_family_spans_dev
    # and its FULL_SCAN builder (their candidate and INNER pipelines
    # behind the bidi path are not ported)
    _BIDI_FAMILIES = (Strategy.PREFIX_RUN, Strategy.PREFIX_SET,
                      Strategy.FULL_SCAN, Strategy.INNER)

    def __init__(self, parsed: Parsed, ast: Node, dfas_ok: bool, device,
                 longest: bool = False, host_find=None, stats=None):
        self.parsed = parsed
        self.ast = ast
        self.longest = longest
        # (corpus, pos) -> the leftmost span at or after pos under the
        # engine's rule, or None: the Engine's host search, for BITSET_NFA
        # ends when the anchored DFA overflows (ref. :302)
        self.host_find = host_find
        self.device = torch.device(device)
        self.plan: Plan = select(ast, dfas_ok)
        if longest and self.plan.strategy in (Strategy.NULLABLE_CORE,
                                              Strategy.ALL_EMPTY):
            self.plan = Plan(Strategy.HOST, "nullable (longest): host",
                             nullable=True)
        if longest and self.plan.strategy == Strategy.MULTI_LITERAL:
            # POSIX takes the longest literal at a start, not the first
            # listed: priority by length, stable (ref. :312-316)
            self.plan = dataclasses.replace(
                self.plan, literals=sorted(self.plan.literals, key=len,
                                           reverse=True))
        self._lock = device_lock(f"torch:{self.device}")
        self.host_routes = 0     # calls declined to the Engine's host loop
        self._host_dense: Dict[str, object] = {}
        self._count_sc = None        # lazy CountScanner; False == none
        self._count_sc_ascii = None  # lazy ASCII-projected CountScanner
        self._span_sc = None
        self._span_sc_ascii = None
        self._line_sc = None         # lazy needle scanners; False == none
        self._hits_sc = None
        self._seq_sc = None
        self._flag_scanner_cache = {}
        # per-corpus-fingerprint (total, kind) of the bidi path, or (hit
        # count, selection) of the literal path: sizes warm find_all caps
        # without a count sync
        self._spans_cnt_cache = {}
        self._rev_hint_cache = {}   # corpus fp -> K3 sub-lane entries [k, L]
        self._core_engine = None    # lazy Engine over a nullable core
        self._chunk_sc = {}         # dense kind -> ChunkScanner; False == none
        self._bitset_sc = {}        # "fwd"/"rev" -> BitsetNFAScanner or False
        # (match starts, window rounds) of the last general find_all, None
        # before the first
        self.full_scan_stats = None
        # [output pieces, corpus pieces] of the last device find_all: the
        # most pieces any of its compactions took, and the corpus pieces of
        # its fill (1 and 1 within the limits)
        self.pieces = [1, 1]
        # the multi-device hooks' objects, by mesh devices: ShardedGoCount
        # or False; (make_sharded_ends' fn, its cap)
        self._sharded_sc = {}
        self._sharded_ends = {}
        # the candidate and INNER pipelines (M5): the engine's Stats (the
        # prefilter counters), the offset sieve and ResetScanners by kind
        # (ref. :327-329)
        self.stats = stats
        self._sieve = None
        self._reset_sc = {}
        # the route that served the last device find_all
        self.route = None

    def _verify_kind(self) -> str:
        """The anchored forward DFA whose last flag from a match start is
        that match's end under the engine's rule (ref. :345-348):
        break-at-match for leftmost-first, every match kept for
        leftmost-longest, whose last flag is the longest end."""
        return "fwd_anch_all" if self.longest else "fwd_anch_break"

    def _note_pieces(self, out: int = 1, corpus: int = 1) -> None:
        self.pieces = [max(self.pieces[0], out), max(self.pieces[1], corpus)]

    def _chain_piece(self) -> int:
        """Candidates of one piece of a chain that holds about 30 bytes a
        candidate (CHAIN_PIECE within the span limit)."""
        return min(self.MAX_DEVICE_SPANS, self.CHAIN_PIECE)

    def _slots(self, total: int) -> int:
        """Rows of an array of `total` entries: the power-of-two bucket
        within the span limit (warm calls reuse its shapes), `total`
        itself past it."""
        return _bucket(total, 16) if total <= self.MAX_DEVICE_SPANS \
            else total

    def _go(self, data: np.ndarray) -> np.ndarray:
        """The corpus as every matcher reads it, each byte that Go decodes
        as a width-1 RuneError set to 0xFF (``corpus_cache.go_bytes``,
        once per corpus): the entry points take it first, so the routes'
        host replays and device buffers see the same bytes.  A corpus
        past MAX_CORPUS is left for ``_check_size`` to refuse."""
        return go_bytes(data, self.device) if 0 < len(data) <= MAX_CORPUS \
            else data

    def _decline(self, result=None):
        self.host_routes += 1
        return result

    @staticmethod
    def _check_size(n: int) -> None:
        if n > MAX_CORPUS:
            raise ValueError(f"corpus of {n} bytes exceeds the int32 "
                             f"position range ({MAX_CORPUS})")

    # -- artifact builders (lazy) ---------------------------------------
    def _dense(self, kind: str):
        """Host DenseDFA of the given kind (ref. :351-419): the anchored
        reverse DFAs, the unanchored reverse DFA (``rev_all``: every match
        start, read on the flipped corpus), the unanchored forward DFA
        (``fwd_all``) and its break-at-match form (``fwd_break``: it dies
        right after the leftmost match is complete, so its last flag is the
        leftmost-first end), and the anchored forms of both
        (``fwd_anch_break`` and ``fwd_anch_all``, the two results of
        ``_verify_kind``), and the anchored DFAs of an INNER split's suffix
        (``fwd_suffix``, ``fwd_suffix_all``).  Raises DFAOverflow past the
        state limit."""
        if kind in self._host_dense:
            return self._host_dense[kind]
        d = load_dense(self.parsed.pattern, kind)
        if d is None:
            if kind in ("rev_anch", "rev_anch_ascii"):
                nfa = compile_nfa(self.parsed, reverse=True,
                                  ascii_only=(kind == "rev_anch_ascii"))
                d = determinize(nfa, anchored=True, break_at_match=False,
                                reverse=True)
            elif kind == "rev_all":
                nfa = compile_nfa(self.parsed, reverse=True)
                d = determinize(nfa, anchored=False, break_at_match=False,
                                reverse=True)
            elif kind in ("fwd_all", "fwd_break", "fwd_anch_break",
                          "fwd_anch_all"):
                nfa = compile_nfa(self.parsed, with_captures=False)
                d = determinize(nfa, anchored=kind.startswith("fwd_anch"),
                                break_at_match=kind.endswith("break"))
            elif kind in ("fwd_suffix", "fwd_suffix_all"):
                # the anchored DFA of an INNER split's suffix: its run from
                # each reset gives a candidate's end (leftmost-first: the
                # last flag before it dies; leftmost-longest: every flag)
                sub = Parsed(self.plan.split.suffix_ast, 0, [],
                             self.parsed.pattern + "<suffix>")
                nfa = compile_nfa(sub, with_captures=False)
                d = determinize(nfa, anchored=True,
                                break_at_match=(kind == "fwd_suffix"))
            else:
                raise KeyError(kind)
            save_dense(self.parsed.pattern, kind, d)
        self._host_dense[kind] = d
        return d

    def _make_count_scanner(self, ascii_only: bool):
        """CountScanner over the FindAll-count transducer, or False when
        out of scope (the DFA overflows, or the transducer passes its
        state limit); ascii_only builds the ASCII-projected tables (exact
        when every corpus byte < 0x80)."""
        if self.longest:
            return False
        try:
            nfa = compile_nfa(self.parsed, with_captures=False,
                              ascii_only=ascii_only)
            if self.plan.nullable:
                u = determinize_py(nfa, anchored=False,
                                   break_at_match=True, track_empty=True)
                cd = build_count_dfa_nullable(u)
            else:
                u = determinize(nfa, anchored=False, break_at_match=True)
                cd = build_count_dfa(u)
        except DFAOverflow:
            return False
        if cd is None:
            return False
        sc = CountScanner(cd.without_spans().minimized(), self.device)
        # unminimized span-event transducer for the bidirectional path
        sc.span_cd_raw = cd
        return sc

    def _count_scanner_ascii(self):
        if self._count_sc_ascii is None:
            self._count_sc_ascii = self._make_count_scanner(True)
        return self._count_sc_ascii

    def _count_scanner(self):
        if self._count_sc is None:
            self._count_sc = self._make_count_scanner(False)
        return self._count_sc

    def _count_scanner_for(self, ascii_ok: bool):
        """The ASCII-projected scanner when the corpus is ASCII, else the
        full rune tables."""
        if ascii_ok:
            sc = self._count_scanner_ascii()
            if sc:
                return sc
        return self._count_scanner()

    def _word_tiles(self, data: np.ndarray, L: int, T: int):
        """The corpus's word tiles under (L, T), cached with its buffer."""
        return corpus_tiles(
            data, self.device, ("words", L, T),
            lambda: make_word_tiles(device_corpus(data, self.device), L,
                                    T // 4))

    # -- needle scanners (K5-K7) ----------------------------------------
    def _line_shape_parts(self, sp):
        a_univ = sp.prefix_universal
        b_empty = sp.suffix_ast.op == Op.EMPTY
        b_univ = sp.suffix_universal
        a_is_empty = litmod.exact_literals(sp.prefix_ast) == [sp.lit] \
            and not sp.line_anchored
        return a_univ, b_empty, b_univ, a_is_empty

    def _line_shape_args(self):
        """(needles, prefix, anchored) when the pattern is a line shape the
        line kernels can count, else None."""
        strat = self.plan.strategy
        if self.longest:
            return None
        if strat == Strategy.LINE_SHAPE:
            sp = self.plan.split
            a_univ, _b_empty, b_univ, a_is_empty = \
                self._line_shape_parts(sp)
            if (a_univ != UNIV_ANY and b_univ != UNIV_ANY
                    and (sp.line_anchored or a_univ == UNIV_LINE
                         or a_is_empty)):
                anchored = sp.line_anchored and len(sp.prefix_literal) > 0
                prefix = sp.prefix_literal if anchored else b""
                return [sp.lit], prefix, anchored
        elif strat == Strategy.FULL_SCAN:
            ls = litmod.line_set_split(self.ast)
            if ls is not None:
                anchored = ls.line_anchored and len(ls.prefix_literal) > 0
                prefix = ls.prefix_literal if anchored else b""
                return ls.lits, prefix, anchored
        return None

    def _literal_set(self):
        """The plan's literals when it is a LITERAL / MULTI_LITERAL plan
        counted leftmost-first, else None."""
        if self.longest or self.plan.strategy not in (
                Strategy.LITERAL, Strategy.MULTI_LITERAL):
            return None
        return [bytes(x) for x in self.plan.literals]

    def _line_scanner(self):
        """Lazy LineScanner (K5); False when out of scope."""
        if self._line_sc is None:
            self._line_sc = False
            args = self._line_shape_args()
            if args is not None and LineScanner.supported(args[0], args[1]):
                self._line_sc = LineScanner(args[0], prefix=args[1],
                                            anchored=args[2],
                                            device=self.device)
        return self._line_sc

    def _hits_scanner(self):
        """Lazy HitsScanner (K6) for literal sets; False when out of
        scope."""
        if self._hits_sc is None:
            self._hits_sc = False
            nds = self._literal_set()
            if nds is not None and HitsScanner.supported(nds):
                self._hits_sc = HitsScanner(nds, device=self.device)
        return self._hits_sc

    def _seq_scanner(self):
        """Lazy SeqScanner (K7, MODE_MULTI) for literal sets: the count
        when K6 finds two hits overlapping; False when out of scope."""
        if self._seq_sc is None:
            self._seq_sc = False
            nds = self._literal_set()
            if nds is not None and SeqScanner.supported(nds):
                self._seq_sc = SeqScanner(MODE_MULTI, nds,
                                          device=self.device)
        return self._seq_sc

    # -- count ------------------------------------------------------------
    def _count_route(self, data: np.ndarray):
        """(kind, scanner) that counts this corpus, or None (declined); host
        work only, the corpus is not uploaded.  kind is "line" (K5),
        "hits" (K6, then K7 on an overlap) or "dfa" (the count
        transducer)."""
        if not self.plan.nullable:
            if self._line_scanner():
                return "line", self._line_sc
            if self._hits_scanner() and self._seq_scanner():
                return "hits", self._hits_sc
        ascii_ok = corpus_is_ascii(data, self.device)
        sc = self._count_scanner_for(ascii_ok)
        if not sc:
            return None
        if self.plan.nullable:
            # ref. nullable_count: the empty-match-aware transducer
            if len(data) == 0 or not getattr(sc.cd, "requires_width1",
                                             False):
                return None
            # the transducer advances one byte after an empty match, Go
            # one rune: exact unless a multi-byte UTF-8 lead occurs
            if not ascii_ok and bool(((data >= 0xC2)
                                      & (data <= 0xF4)).any()):
                return None
        return "dfa", sc

    def count(self, data: np.ndarray) -> Optional[int]:
        """Match count through the route `_count_route` picks, or None
        (declined: the Engine's host loop counts).  With a mesh of several
        devices (``_mesh``) the multi-device hook ``_sharded_counter``
        counts first, as the reference's count does (:1721-1729): before
        the line, hits and transducer routes, and for nullable plans once
        their transducer's gate passes (its nullable_count, :1678-1685).
        A leftmost-longest engine counts its device find_all
        (``_count_by_spans``): the count transducer and the needle counts
        are leftmost-first."""
        self._check_size(len(data))
        data = self._go(data)
        if self.plan.strategy == Strategy.END_ANCHORED:
            sp = self._end_anchored_spans(data)
            return None if sp is None else len(sp)
        if self.longest:
            return self._count_by_spans(data)
        mesh = self._mesh()
        with self._locks(mesh):
            route = self._count_route(data)
            if mesh is not None and (not self.plan.nullable or (
                    route is not None and route[0] == "dfa")):
                shc = self._sharded_counter(mesh)
                if shc:
                    return shc.count(device_corpus(data, self.device))
            if route is None:
                return self._count_by_spans(data)
            kind, sc = route
            geom = plan_geometry(len(data))
            dev = device_corpus(data, self.device)
            tiles = self._word_tiles(data, *geom[:2])
            if kind == "hits":
                c = sc.count(dev, geom, tiles)
                if c is None:
                    # two hits overlap: the sequential leftmost-first count
                    sq = self._seq_sc
                    c = sq.count(dev, seq_geometry(len(data), sq.M), tiles)
                return c
            return sc.count(dev, geom, tiles)

    # -- the multi-device hooks ------------------------------------------------
    def _mesh(self):
        """The mesh of ``parallel.shard.default_mesh`` for this engine's
        device when it holds more than one device, else None: the hooks
        stay off.  One card gives a mesh of one; tests substitute a
        virtual mesh by replacing ``default_mesh``."""
        mesh = shard.default_mesh(device=self.device)
        return mesh if mesh.size > 1 else None

    def _locks(self, mesh):
        """This engine's device lock and, with a mesh, the lock of every
        device in it, taken in one order (their keys sorted), so that two
        engines on different cards of a mesh cannot hold one each."""
        locks = {f"torch:{self.device}": self._lock}
        for d in () if mesh is None else mesh.devices:
            locks.setdefault(f"torch:{d}", device_lock(f"torch:{d}"))
        stack = ExitStack()
        for key in sorted(locks):
            stack.enter_context(locks[key])
        return stack

    def _sharded_counter(self, mesh=None):
        """The sharded count transducer over the mesh (ref. :1644-1666,
        ``parallel/sharded_count.py``), or False: a mesh of one device, a
        plan with no count transducer, or one wider than the phase-1 gate
        (``Phase1TooWide``).  Built once a mesh."""
        mesh = mesh or self._mesh()
        if mesh is None:
            return False
        shc = self._sharded_sc.get(mesh.devices)
        if shc is None:
            shc = False
            sc = self._count_scanner()
            if sc:
                try:
                    shc = ShardedGoCount(sc.cd, mesh)
                except Phase1TooWide:
                    shc = False
            self._sharded_sc[mesh.devices] = shc
        return shc

    def _sharded_starts(self, rev, data: np.ndarray):
        """Every match start as ``_all_starts`` gives them, from the mesh
        (ref. :2526-2571): the unanchored reverse DFA's flags over the
        flipped corpus, zero-padded to a multiple of the mesh size,
        sharded with each shard's ends compacted into a buffer of
        max(4096, n // 256) slots (``shard.make_sharded_ends``); the start
        at 0 from one anchored forward walk on the host.  None when out of
        scope, before anything is uploaded: a mesh of one device, n <
        2^16, or a reverse table outside the transfer walk's gate
        (``transfer_scan.walk_gate``: more than MAX_STATES states or a
        block past shared memory; a keyword list of 100 words or more),
        as ``_sharded_counter`` declines past ``Phase1TooWide``; after
        the walk, a shard whose ends overflow its buffer."""
        n = len(data)
        mesh = self._mesh()
        if (mesh is None or n < 1 << 16
                or not transfer_scan.walk_gate(*rev.tables.packed.shape)):
            return None
        cap = max(4096, n // 256)
        fn, built = self._sharded_ends.get(mesh.devices, (None, 0))
        if fn is None or cap > built:
            # a larger corpus needs a larger buffer than the cached fn's
            fn = shard.make_sharded_ends(mesh, rev.tables, cap)
            self._sharded_ends[mesh.devices] = (fn, cap)
        else:
            cap = built
        flipped = device_corpus_flipped(data, self.device)
        pad = -n % mesh.size
        if pad:
            flipped = torch.cat([flipped, flipped.new_zeros(pad)])
        pos, cnts = fn(flipped)
        over, m = torch.stack([(cnts > cap).any().long(),
                               (pos < n).sum()]).tolist()
        if over:
            return None
        at0 = int(anchored_last_end(self._dense(self._verify_kind()), data,
                                    0) >= 0)
        starts = torch.full((self._slots(m + at0),), n, dtype=torch.int32,
                            device=self.device)
        # flag at flipped offset j: a match start at n - j; ascending
        starts[at0:at0 + m] = n - pos[pos < n].flip(0).to(self.device)
        if at0:
            starts[0] = 0
        return starts, m + at0, torch.ones((), dtype=torch.bool,
                                           device=self.device)

    def _count_by_spans(self, data: np.ndarray) -> Optional[int]:
        """A nullable plan outside the transducer's gate (ALL_EMPTY among
        them), a BITSET_NFA plan (whose transducer overflows), a PREFIX_RUN
        plan with no transducer or any plan of a leftmost-longest engine
        counts its device find_all when a find_all route serves the corpus
        (the reference counts the span list of its device find_all, ref.
        engine.py:337 and batch.py :1798-1800); where none does, a
        PREFIX_RUN plan takes the bulk count (``_prefix_run_count``); else
        None (declined)."""
        if ((self.plan.strategy not in (Strategy.NULLABLE_CORE,
                                        Strategy.ALL_EMPTY,
                                        Strategy.BITSET_NFA,
                                        Strategy.PREFIX_RUN)
             and not self.longest)
                or not 0 < len(data) <= self.SPARSE_SPANS_LIMIT):
            return self._decline()
        if self._spans_route(data) is None:
            c = self._prefix_run_count(data)
            return self._decline() if c is None else c
        r = self.find_all_spans_device(data)
        return None if r is None else r[1]

    # -- single match (is_match, find_first) ------------------------------
    # find_first's first forward prefix (ref. :1893); each miss scans a
    # prefix 8x longer
    FIRST_PREFIX = 1 << 22
    # chunk of the literal find_first scans (ref. :1827)
    FIRST_CHUNK = 1 << 24
    # the reverse start search's first window (ref. _rev_start_flags
    # :2266-2274)
    REV_WINDOW = 64

    def _chunk_scanner(self, kind: str):
        """Lazy ChunkScanner over a dense DFA kind, or None (out of scope:
        the DFA overflows; a table past shared memory takes the kernels'
        global-memory instance).  Host work only: decides a route before
        the corpus is uploaded."""
        sc = self._chunk_sc.get(kind)
        if sc is None:
            try:
                sc = ChunkScanner(DFATables.from_dense(self._dense(kind)),
                                  self.device)
            except DFAOverflow:
                sc = False
            self._chunk_sc[kind] = sc
        return sc or None

    def _end_anchored_spans(self, data: np.ndarray):
        """The match of an END_ANCHORED plan as an [k, 2] int64 host array
        (k <= 1), or None (declined: the reverse DFA overflows).  Every
        match ends at n, so one host scan of the anchored reverse DFA from
        the end finds the earliest start in O(match length), with no
        upload (ref. :1402-1413).  Whether a match exists and where does
        not depend on the match rule."""
        try:
            rev = self._dense("rev_anch")
        except DFAOverflow:
            return self._decline(None)
        n = len(data)
        s = find_rev_start(rev, data, 0, n)
        if s < 0:
            return np.empty((0, 2), dtype=np.int64)
        return np.array([[s, n]], dtype=np.int64)

    def is_match(self, data: np.ndarray):
        """True/False, or None (declined: the Engine's host loop answers),
        by strategy (ref. :1415-1450): nullable plans match; END_ANCHORED
        scans back from the end on the host; FULL_SCAN runs one K9 scan of
        the whole corpus over ``fwd_all`` (a flag below n, else the EOI
        flag at the exact state at n); the other strategies answer
        ``find_first(...) is not None`` where the reference asks its
        ``find_all_spans(limit=1)``, whose limit pipelines are not ported
        (ROADMAP M7): the same answer.  BITSET_NFA runs one forward bitset
        scan (``_bitset_is_match``) when the forward NFA is in the scan's
        scope, else asks find_first.  Whether a match exists does not
        depend on the match rule, so a leftmost-longest engine takes the
        same routes."""
        n = len(data)
        data = self._go(data)
        strat = self.plan.strategy
        if strat in (Strategy.NULLABLE_CORE, Strategy.ALL_EMPTY):
            return True
        if strat == Strategy.END_ANCHORED:
            sp = self._end_anchored_spans(data)
            return None if sp is None else len(sp) > 0
        if strat == Strategy.BITSET_NFA and self._bitset_scanner("fwd"):
            return self._bitset_is_match(data)
        if strat != Strategy.FULL_SCAN:
            m = self.find_first(data)
            return None if m is FALLBACK else m is not None
        sc = self._chunk_scanner("fwd_all")
        if n == 0 or sc is None:
            return self._decline(None)
        self._check_size(n)
        geom = plan_geometry(n)
        with self._lock:
            scan = sc.scan_device(device_corpus(data, self.device), geom,
                                  self._word_tiles(data, *geom[:2]))
            cnt, exit_n = torch.stack([flags_count_upto(scan),
                                       exit_at_end(scan)]).tolist()
        return cnt > 0 or bool(sc.tables.match_eoi[exit_n, CTX_SOT])

    def find_first(self, data: np.ndarray):
        """Leftmost-first span (start, end), None (no match), or FALLBACK
        (declined: the Engine's host loop answers), by strategy (ref.
        :1803-1863): LITERAL and MULTI_LITERAL scan 16 MiB chunks for the
        first hit; CHARCLASS finds the first qualifying class run;
        END_ANCHORED scans back from the end on the host; BITSET_NFA takes
        ``_bitset_first`` on find_all's route (declining where find_all
        does); nullable plans decline (the reference's FALLBACK; a
        nullable plan's leftmost match is O(match length) on the host); the
        others take ``_find_first_dfa``.  The route is decided before the
        corpus is uploaded.  The Engine asks only leftmost-first engines (ref.
        engine.py:238); ``is_match`` asks for any, and reads only whether
        a span came back."""
        n = len(data)
        data = self._go(data)
        strat = self.plan.strategy
        if n == 0 or strat in (Strategy.NULLABLE_CORE, Strategy.ALL_EMPTY,
                               Strategy.HOST):
            return self._decline(FALLBACK)
        if strat == Strategy.BITSET_NFA:
            route = self._bitset_route()
            if route is None:
                return self._decline(FALLBACK)
            self._check_size(n)
            with self._lock:
                return self._bitset_first(*route, data)
        if strat == Strategy.END_ANCHORED:
            sp = self._end_anchored_spans(data)
            if sp is None:
                return FALLBACK
            return None if len(sp) == 0 else (int(sp[0, 0]), int(sp[0, 1]))
        if strat in (Strategy.LITERAL, Strategy.MULTI_LITERAL,
                     Strategy.CHARCLASS):
            self._check_size(n)
            with self._lock:
                dev = device_corpus(data, self.device)
                if strat == Strategy.CHARCLASS:
                    return self._charclass_first(dev)
                return self._literal_first(dev)
        fwd = self._chunk_scanner("fwd_break")
        rev = self._chunk_scanner("rev_anch") if fwd else None
        if rev is None:
            return self._decline(FALLBACK)
        self._check_size(n)
        with self._lock:
            return self._find_first_dfa(fwd, rev, data)

    def _literal_first(self, dev):
        """First hit of a LITERAL or MULTI_LITERAL plan (ref. :1822-1849):
        chunks of FIRST_CHUNK bytes, each read with the longest literal's
        length - 1 bytes of overlap, so a hit that starts in a chunk is
        seen there; at a position the first literal in priority order
        wins.  One sync per chunk."""
        n = int(dev.shape[0])
        lits = [bytes(x) for x in self.plan.literals]
        ext = max(len(x) for x in lits) - 1
        for off in range(0, n, self.FIRST_CHUNK):
            end = min(n, off + self.FIRST_CHUNK)
            sl = dev[off:min(n, end + ext)]
            if len(lits) == 1:
                p = first_set_index(_memmem_mask(sl, lits[0]))
                if p < end - off:
                    return off + p, off + p + len(lits[0])
            else:
                best, blen = _multi_literal_scan(sl, lits)
                p = first_set_index(best >= 0)
                if p < end - off:
                    return off + p, off + p + int(blen[p])
        return None

    def _charclass_first(self, dev):
        """The first match of a CHARCLASS plan (ref. :1865-1881) from the
        first maximal class run of length >= min, on prefixes of
        FIRST_PREFIX bytes, x8 per miss: a run that ends inside a prefix is
        final, a run that touches its edge may go on, so the prefix grows
        until the run ends or the prefix is the corpus."""
        n = int(dev.shape[0])
        cc = self.plan.charclass
        ranges = table_to_ranges(np.array(cc.table, dtype=bool))
        c = min(n, self.FIRST_PREFIX)
        while True:
            s, run = first_run_geq(_range_mask(dev[:c], ranges), cc.min)
            if c == n or s + run < c:
                break
            c = min(n, c * 8)
        if s >= n:
            return None
        m, k = cc.min, cc.max
        if cc.plus:
            r = run % k
            return s, s + run - (r if r < m else 0)
        if k == -1:
            return s, s + run
        return s, s + min(k, run)

    def _find_first_dfa(self, fwd, rev, data: np.ndarray):
        """Two-pass bidirectional find (ref. :1883-1917): K9 over the
        break-at-match ``fwd_break`` DFA on prefixes of FIRST_PREFIX bytes,
        x8 while the automaton lives at the prefix's end; the last flag
        before it dies is the leftmost-first end (at n, the EOI flag at
        the exact exit state).  The whole corpus reuses its cached word
        tiles; a shorter prefix is tiled afresh.  Then the window kernel
        finds the start (``_rev_start``)."""
        n = len(data)
        dev = device_corpus(data, self.device)
        c = min(n, self.FIRST_PREFIX)
        while True:
            geom = plan_geometry(c)
            if c == n:
                tiles = self._word_tiles(data, *geom[:2])
            else:
                tiles = make_word_tiles(dev[:c], geom[0], geom[1] // 4)
            scan = fwd.scan_device(dev[:c], geom, tiles)
            del tiles
            e, exit_c = torch.stack([flags_last(scan),
                                     exit_at_end(scan)]).tolist()
            if exit_c == DEAD:
                break
            if c == n:
                if fwd.tables.match_eoi[exit_c, CTX_SOT]:
                    e = n
                break
            c = min(n, c * 8)
        if e < 0:
            return None
        return self._rev_start(rev, dev, e), e

    def _rev_start(self, rev, dev, e: int) -> int:
        """The earliest start of a match ending at e (ref.
        ``_rev_start_flags`` :2252-2307 with kind="rev_anch", for one end):
        the window scan's ends form runs the anchored reverse DFA from e
        backwards in one lane, W = REV_WINDOW bytes, x4 while the run
        lives; the last flag of the finished run is the longest reverse
        match.  In reverse coordinates the run starts at j0 = n - e and its
        context byte is forward byte e; the kernel reads the forward corpus
        backwards, so no flipped copy is made.  The lane's end j0 + t_max
        in reverse coordinates is forward position n - (j0 + t_max) = e -
        t_max, the start."""
        n = int(dev.shape[0])
        starts = torch.full((1,), n - e, dtype=torch.int32,
                            device=dev.device)
        W = self.REV_WINDOW
        while True:
            Wc = min(W, n + 1)
            end, alive = window_ends_round(rev.mt, dev, starts, Wc,
                                           reverse=True)
            end, live = torch.cat([end, alive]).tolist()
            if not live:
                break
            W *= 4
            if W > 4 * (n + 1):
                raise RuntimeError("reverse window scan: the run outlived "
                                   "the corpus")
        if end < 0:
            raise RuntimeError("reverse window scan found no start for a "
                               "forward match end")
        return n - end

    # -- find_all -----------------------------------------------------------
    def find_all_spans(self, data: np.ndarray, limit: int = -1
                       ) -> Optional[np.ndarray]:
        """All non-overlapping spans with Go semantics as an [m, 2] int64
        host array, at most `limit` of them when limit >= 0, or None
        (declined).  A limit takes the corpus's device route and keeps the
        first `limit` spans (class runs extract only the runs those need);
        limit 0 returns none and uploads nothing."""
        if limit == 0:
            return np.empty((0, 2), dtype=np.int64)
        if self.plan.strategy == Strategy.END_ANCHORED:
            self.route = "end_anchored"
            sp = self._end_anchored_spans(self._go(data))
            return sp if sp is None or limit < 0 else sp[:limit]
        r = self.find_all_spans_device(data, limit=limit)
        if r is None:
            return None
        spans, cnt = r
        if limit >= 0:
            cnt = min(cnt, limit)
        return spans[:cnt].cpu().numpy().astype(np.int64)

    def find_all_spans_device(self, data: np.ndarray,
                              defer_ok: bool = False, limit: int = -1):
        """(spans [cap, 2] int32 on the device, count) or None (declined).
        With defer_ok=True returns (spans, count, ok): ok a device bool or
        None (validated here), and on a warm call of a family with a
        count cache (a corpus with a cached fingerprint) the count is a
        device scalar and no sync is paid for the caps.  A limit >= 0 lets
        the class-run route stop after the runs that hold the first
        `limit` matches; the other routes return every span."""
        n = len(data)
        if n == 0 or n > self.SPARSE_SPANS_LIMIT:
            return self._decline(None)
        self._check_size(n)
        data = self._go(data)
        route = self._spans_route(data)
        if route is None:
            return self._decline(None)
        kind, args = route
        fp = _fingerprint(data)
        known = self._spans_cnt_cache.get(fp) if defer_ok else None
        self.pieces = [1, 1]
        with self._locks(self._mesh() if kind in ("full_scan", "m5")
                         else None):
            if kind == "line_any":
                spans, cnt, ok = self._line_any_spans_dev(args, data)
            elif kind == "line":
                spans, cnt, ok = self._line_shape_spans_dev(args, data)
            elif kind == "bidi":
                spans, cnt, ok = self._bidi_spans_dev(*args, data, known,
                                                      fp)
            elif kind == "full_scan":
                spans, cnt, ok = self._full_scan_spans_dev(*args, data)
            elif kind == "m5":
                kind, m5 = args
                r = (self._inner_spans_dev if kind == "inner"
                     else self._candidate_spans_dev)(m5, data)
                if r is None:
                    return self._decline(None)
                spans, cnt, ok = r
            elif kind == "bitset":
                spans, cnt, ok = self._bitset_spans_dev(*args, data, limit)
            elif kind == "charclass":
                spans, cnt, ok = self._charclass_spans_dev(args, data,
                                                           limit)
            elif kind == "all_empty":
                spans, cnt, ok = self._all_empty_spans_dev(data)
            elif kind == "literal":
                spans, cnt, ok = self._literal_spans_dev(args, data, known,
                                                         fp)
            elif kind == "nullable_k8":
                spans, cnt, ok = self._nullable_spans_dev(args, data)
            elif kind == "end_anchored":
                sp = self._end_anchored_spans(data)
                spans = _empty_spans(self.device)
                spans[:len(sp)] = torch.from_numpy(sp.astype(np.int32))
                cnt, ok = len(sp), None
            else:
                spans, cnt, ok = self._nullable_general_spans_dev(
                    args, data)
        self.route = kind
        return (spans, cnt, ok) if defer_ok else (spans, cnt)

    def _spans_route(self, data: np.ndarray):
        """(kind, args) of the find_all route serving this corpus, or None
        (declined); host work only, the corpus is not uploaded.  Callers
        check the size limits.  A leftmost-longest engine takes the same
        routes but the bidirectional one (its transducer is
        leftmost-first): its general and BITSET_NFA routes read ends from
        ``fwd_anch_all``, its literal sets are sorted longest first, its
        ``([c]{m,k})+`` runs take the longest chop; line shapes and the
        other class runs give the same spans under both rules."""
        strat = self.plan.strategy
        if strat == Strategy.END_ANCHORED:
            # rule-independent, so leftmost-longest takes it too
            try:
                self._dense("rev_anch")
            except DFAOverflow:
                return None
            return "end_anchored", None
        if strat == Strategy.BITSET_NFA:
            route = self._bitset_route()
            return None if route is None else ("bitset", route)
        if strat == Strategy.LINE_SHAPE:
            route = self._line_spans_route()
            if route is not None:
                return "line", route
            route = self._line_any_route()
            if route is not None:
                return "line_any", route
            # a newline in the literal or the prefix, an empty literal, a
            # line-anchored (?s) shape: the general fallback, as the
            # reference's _line_shape_spans falls to _full_scan_spans
            # (ref. :2201)
            route = self._full_scan_route()
            return None if route is None else ("full_scan", route)
        if strat in self._BIDI_FAMILIES:
            route = self._bidi_route(corpus_is_ascii(data, self.device))
            if route is not None:
                return "bidi", route
            general = self._full_scan_route()
            if general is not None:
                return "full_scan", general
            m5 = self._m5_route()
            return None if m5 is None else ("m5", m5)
        if strat == Strategy.CHARCLASS:
            return "charclass", self.plan.charclass
        if strat in (Strategy.LITERAL, Strategy.MULTI_LITERAL):
            lits = [bytes(x) for x in self.plan.literals]
            return ("literal", lits) if all(lits) else None
        if strat == Strategy.NULLABLE_CORE:
            return self._nullable_route(data)
        if strat == Strategy.ALL_EMPTY:
            return ("all_empty", None) if len(data) >= 4 else None
        return None

    # -- line-shape span path -------------------------------------------------
    def _line_spans_route(self):
        """(mode, lit, prefix, anchored) of the candidate chain, or None
        (declined): a (?s) part, a newline in the literal or prefix, or
        an empty literal.  Host work only.  Either rule gives the same
        spans: a match starts at the leftmost position that holds one,
        and its end is the line's end (a universal suffix) or the end of
        the line's last literal after that start (none), the longest end
        under both rules, since the literal holds no newline."""
        sp = self.plan.split
        a_univ, b_empty, b_univ, a_is_empty = self._line_shape_parts(sp)
        if a_univ == UNIV_ANY or b_univ == UNIV_ANY:
            return None
        mode = ("first_to_eol" if a_is_empty
                else "bol_to_last" if b_empty else "bol_to_eol")
        lit = bytes(sp.lit)
        prefix = bytes(sp.prefix_literal) if sp.line_anchored else b""
        if b"\n" in lit or b"\n" in prefix or not lit:
            return None
        return mode, lit, prefix, bool(sp.line_anchored)

    def _line_any_route(self):
        """(start rule, end rule, literal) of a line shape with a (?s)
        universal part, which matches at most once (the reference's
        ``_line_shape_any``, :2223-2250), or None: a line-anchored shape,
        an empty literal, or a start side that is neither universal nor
        the literal itself (the general fallback serves those).  The match
        begins at 0 after a leading (?s).*, else at the first hit ("lit")
        or its line's start ("bol"); it ends at n before a trailing
        (?s).*, else at the last hit's end ("lit") or the first newline
        after it ("eol").  A newline in the literal changes none of these,
        since each reads the corpus around the hit itself (the reference's
        candidate lines assume none: F13).  Host work only."""
        sp = self.plan.split
        a_univ, b_empty, b_univ, a_is_empty = self._line_shape_parts(sp)
        lit = bytes(sp.lit)
        if (not lit or sp.line_anchored or self.plan.nullable
                or UNIV_ANY not in (a_univ, b_univ)):
            return None
        if a_univ == UNIV_ANY:
            end = ("eoi" if b_univ == UNIV_ANY else "eol"
                   if b_univ == UNIV_LINE else "lit" if b_empty else None)
            return None if end is None else ("zero", end, lit)
        start = ("lit" if a_is_empty else "bol" if a_univ == UNIV_LINE
                 else None)
        return None if start is None else (start, "eoi", lit)

    def _line_any_spans_dev(self, route, data):
        """(spans, count, None) of a _line_any_route shape: the literal's
        hit mask, its first or last hit, and a newline search beside it;
        one sync each.  Either rule gives this span: the start is the
        leftmost one, and the end the farthest the shape reaches from
        it."""
        start_rule, end_rule, lit = route
        n = len(data)
        dev = device_corpus(data, self.device)
        hits = _memmem_mask(dev, lit)
        first = first_set_index(hits)
        spans = _empty_spans(self.device)
        if first >= n:
            return spans, 0, None
        last = last_set_index(hits) if start_rule == "zero" else first
        del hits
        if start_rule == "zero":
            start = 0
        elif start_rule == "lit":
            start = first
        else:
            start = last_set_index(dev[:first] == 10) + 1
        end = last + len(lit)
        if end_rule == "eoi":
            end = n
        elif end_rule == "eol":
            end += first_set_index(dev[end:] == 10)
        spans[0, 0], spans[0, 1] = start, end
        return spans, 1, None

    def _line_shape_spans_dev(self, route, data):
        """(spans, count, None) via the candidate chain (ref. batch.py:
        798-848), in runs of at most CHAIN_PIECE candidates
        (span_chain.line_spans_pieces; one run within it).  Syncs: the
        candidate total, one a run, the check."""
        mode, lit, prefix, anchored = route
        n = len(data)
        words, cnts = line_event_words(device_corpus(data, self.device),
                                       lit, prefix, anchored)
        cand_total = int(cnts[1])
        if cand_total == 0:
            return _empty_spans(self.device), 0, None
        spans, cnt, ok, pieces = line_spans_pieces(
            list(words), n, cand_total, self._chain_piece(), mode, anchored,
            len(lit), len(prefix))
        if not bool(ok):
            raise RuntimeError("line-shape span assembly failed its "
                               "consistency check")
        self._note_pieces(pieces)
        if cnt == 0:
            return _empty_spans(self.device), 0, None
        return spans, cnt, None

    # -- bidirectional span path --------------------------------------------
    def _span_scanner(self, ascii_ok: bool):
        """Lazy SpanScanner over the span-event transducer; False when out
        of scope (no transducer, not spans_simple, an EOI_COMPLEX state)."""
        slot = "_span_sc_ascii" if ascii_ok else "_span_sc"
        cur = getattr(self, slot)
        if cur is None:
            cur = False
            csc = (self._count_scanner_ascii() if ascii_ok
                   else self._count_scanner())
            cd_raw = getattr(csc, "span_cd_raw", None) if csc else None
            if cd_raw is not None and cd_raw.spans_simple:
                cd = cd_raw.minimized()
                if (cd.spans_simple and not
                        (cd.eoi_kind[:, CTX_SOT] == EOI_COMPLEX).any()):
                    cur = SpanScanner(cd, self.device)
            setattr(self, slot, cur)
        return cur

    def _rev_flag_scanner(self, ascii_ok: bool = False):
        """Lazy pre-reset FlagResetScanner over the minimized anchored
        reverse DFA (every viable match start flagged); None when out of
        scope."""
        kind = "rev_anch_ascii" if ascii_ok else "rev_anch"
        sc = self._flag_scanner_cache.get(kind)
        if sc is None:
            sc = False
            try:
                dfa = self._dense(kind).minimized()
            except DFAOverflow:
                dfa = None
            # look-free patterns have context-independent start closures;
            # the SOT id may differ, so require only the other contexts to
            # agree and reset in CTX_OTHER
            if (dfa is not None
                    and len({int(dfa.starts[c]) for c in (1, 2, 3)}) == 1
                    and ResetFlagTables.alphabet_fits(
                        DFATables.from_dense(dfa))):
                sc = FlagResetScanner(dfa, 3, self.device,
                                      flag_pre_reset=True)
            self._flag_scanner_cache[kind] = sc
        return sc or None

    def _bidi_route(self, ascii_ok: bool):
        """(SpanScanner, FlagResetScanner) serving the corpus, or None
        (declined); host work only."""
        if self.longest or self.plan.nullable or litmod.has_looks(self.ast):
            return None
        ssc = (self._span_scanner(True) if ascii_ok else None) \
            or self._span_scanner(False)
        if not ssc:
            return None
        rsc = (self._rev_flag_scanner(True) if ascii_ok else None) \
            or self._rev_flag_scanner()
        if rsc is None:
            return None
        return ssc, rsc

    def _sym_tiles(self, rsc, data: np.ndarray, L: int, T: int):
        """Reset-free reverse symbol tiles of the corpus, cached with its
        buffer per symbol table."""
        bounds = rsc.byte_bounds()
        return corpus_tiles(
            data, self.device, ("sym", bounds, L, T),
            lambda: sym_base_tiles(device_corpus_flipped(data, self.device),
                                   bounds, L, T // 4))

    def _bidi_spans_dev(self, ssc, rsc, data, known_cnt, fp):
        """(spans, count, ok) via the bidirectional event-stream path.
        Cold: one sync for the forward total, ok validated here (None);
        warm: the cached total, count and ok left on the device."""
        n = len(data)
        geom = plan_geometry(n)
        fw, gw, total_d, kind_d, _conv = ssc.scan(
            device_corpus(data, self.device), geom,
            self._word_tiles(data, *geom[:2]))
        if known_cnt is None:
            total, kind = int(total_d), int(kind_d)
            self._spans_cnt_cache[fp] = (total, kind)
        else:
            total, kind = known_cnt
        if total == 0:
            return _empty_spans(self.device), 0, None
        nwb = _bucket_up(max(-(-n // 32), 1))
        nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
        Lr, Tr, _W, _Lc = reset_geometry(n)
        piece = self._chain_piece()
        if total + 1 > piece:
            return self._bidi_pieces(rsc, data, fp, fw, gw, total, kind,
                                     piece, nwb, nwb1, Lr, Tr)
        capM = _bucket(total + 1, 16)
        ends_c, cntF, rq, rw, okA = bidi_ends(fw, gw, n, total_d, kind_d,
                                              capM, nwb, nwb1)
        tiles_r = scatter_reset_tiles(self._sym_tiles(rsc, data, Lr, Tr),
                                      rq, Lr, Tr // 4)
        fw_rev, _interf, _conv, rhint = rsc.scan_tiles(
            tiles_r, n, entries_hint=self._rev_hint_cache.get(fp))
        self._rev_hint_cache[fp] = rhint
        spans, cnt_d, ok = bidi_assemble(ends_c, cntF, rw, fw_rev, n, capM,
                                         nwb1)
        ok = ok & okA
        if known_cnt is None:
            if not bool(ok):
                raise RuntimeError("bidirectional span assembly failed "
                                   "its consistency check")
            return spans, total, None
        return spans, cnt_d, ok

    def _bidi_pieces(self, rsc, data, fp, fw, gw, total: int, kind: int,
                     piece: int, nwb: int, nwb1: int, Lr: int, Tr: int):
        """The bidirectional path past `piece` spans: one [total, 2]
        output, its ends from the forward chain in pieces
        (span_chain.bidi_ends_pieces), the reset words and tiles from
        those ends, the reverse scan, then its starts from the reverse
        chain in pieces (bidi_assemble_pieces), checked against the ends.
        Returns (spans, total, None)."""
        n = len(data)
        out = torch.empty((total, 2), dtype=torch.int32, device=self.device)
        pf, okA = bidi_ends_pieces(fw, gw, n, total, kind, nwb, piece,
                                   out[:, 1])
        del fw, gw
        rw = reset_words(out[:, 1], n, nwb1)
        tiles_r = scatter_reset_tiles(self._sym_tiles(rsc, data, Lr, Tr),
                                      out[:, 1], Lr, Tr // 4, flip_n=n)
        fw_rev, _interf, _conv, rhint = rsc.scan_tiles(
            tiles_r, n, entries_hint=self._rev_hint_cache.get(fp))
        del tiles_r
        self._rev_hint_cache[fp] = rhint
        pr, ok = bidi_assemble_pieces(rw, fw_rev, n, nwb1, piece, out)
        if not bool(ok & okA):
            raise RuntimeError("bidirectional span assembly failed its "
                               "consistency check")
        self._note_pieces(max(pf, pr))
        return out, total, None

    # -- the general fallback: all starts, their ends, Go's chain -----------
    # first window of the end search (ref. WindowScanner init_window)
    END_WINDOW = 64

    def _full_scan_route(self):
        """(rev_all ChunkScanner, MatchTables of ``_verify_kind``) of the
        general find_all, or None (declined: a nullable plan, a DFA that
        overflows or a table too large for the kernels); host work
        only."""
        if self.plan.nullable:
            return None
        rev = self._chunk_scanner("rev_all")
        fwd = self._chunk_scanner(self._verify_kind()) if rev else None
        return None if fwd is None else (rev, fwd.mt)

    def _flipped_tiles(self, data: np.ndarray, geom):
        """The flipped corpus's word tiles under geom, cached with it."""
        L, T = geom[:2]
        return corpus_tiles(
            data, self.device, ("flipped words", L, T),
            lambda: make_word_tiles(device_corpus_flipped(data, self.device),
                                    L, T // 4))

    def _all_starts(self, rev, data: np.ndarray):
        """(starts [cap] int32 ascending with n past the count, count, ok)
        of every match start (ref. ``_all_starts``, batch.py:2584-2600):
        the multi-device hook ``_sharded_starts`` when a mesh serves the
        corpus, else K9 over the unanchored reverse DFA on the flipped
        corpus, whose flag at flipped offset j is a match start at n - j,
        compacted by ``_compact_starts``; the EOI flag at the flipped
        corpus's end is a start at 0.  One sync for the flag count and the
        exit state."""
        st = self._sharded_starts(rev, data)
        if st is not None:
            return st
        n = len(data)
        geom = plan_geometry(n)
        scan = rev.scan_device(device_corpus_flipped(data, self.device),
                               geom, self._flipped_tiles(data, geom))
        cnt, exit_n = torch.stack([flags_count_upto(scan),
                                   exit_at_end(scan)]).tolist()
        at0 = int(bool(rev.tables.match_eoi[exit_n, CTX_SOT]))
        return self._compact_starts(scan, cnt, at0, 0)

    def _compact_starts(self, scan, cnt: int, at0: int, delay: int):
        """(starts, count, ok) as _all_starts gives them, from a settled
        scan of the flipped corpus with cnt flags, each at a flipped offset
        j that is a match start at n - delay - j (K9's flags: delay 0; the
        bitset scan's, whose flag at j is an end at boundary j + 1: delay
        1), plus a start at 0 when at0: the flag words compacted by K4 in
        pieces of the span limit (``word_positions_into``) and read
        backwards a piece at a time, so the starts come out ascending."""
        n = scan.n
        m = cnt + at0
        starts = torch.full((self._slots(m),), n, dtype=torch.int32,
                            device=self.device)
        jpos = torch.empty(cnt, dtype=torch.int32, device=self.device)
        c, pieces, ok = word_positions_into(
            to_global(scan.flagw, n), n, jpos, self.MAX_DEVICE_SPANS,
            dense=cnt / max(n, 1) >= SPARSE_OK, total=cnt)
        ok = ok & (c == cnt)
        self._note_pieces(pieces)
        for i in range(0, cnt, self.MAX_DEVICE_SPANS):
            j = min(cnt, i + self.MAX_DEVICE_SPANS)
            starts[at0 + i:at0 + j] = n - delay - jpos[cnt - j:cnt - i].flip(0)
        if at0:
            starts[0] = 0
        return starts, m, ok

    def _full_scan_spans_dev(self, rev, fwd_mt, data):
        """(spans, count, None) of the general find_all (ref.
        ``_full_scan_spans``, batch.py:2602-2610): every match start
        (``_all_starts``), then ``_starts_spans_dev``."""
        starts, m, ok = self._all_starts(rev, data)
        return self._starts_spans_dev(starts, m, ok, fwd_mt, data)

    def _starts_spans_dev(self, starts, m: int, ok, fwd_mt, data):
        """(spans, count, None) from every match start (ascending, n past
        the count m, ok their device check): the starts in pieces of
        min(MAX_DEVICE_SPANS, CHAIN_PIECE) (one within the limit), each
        piece's ends by the forward window scan over the ``_verify_kind``
        table (dfa_scan.window_ends; the leftmost-first end over
        ``fwd_anch_break``, the longest over ``fwd_anch_all``), then Go's
        selection across the pieces with the last accepted end carried
        (span_chain.chain_select_pieces): a piece whose matches do not
        overlap the next start keeps them all, else the chain walk on the
        device, since a non-nullable plan never matches empty.  The next
        match begins at the first start at or after the previous end under
        either rule.  Syncs: one alive count a window round, a few a piece,
        the checks.  ``full_scan_stats`` keeps the last call's start count
        and window rounds."""
        n = len(data)
        self.full_scan_stats = (m, 0)
        if m == 0:
            return _empty_spans(self.device), 0, None
        dev = device_corpus(data, self.device)
        lim = self._chain_piece()
        checks = [ok]
        rounds = [0]

        def pieces():
            for i in range(0, m, lim):
                st = starts[i:min(m, i + lim)]
                en = torch.empty_like(st)
                _e, r = window_ends(fwd_mt, dev, st, self.END_WINDOW, out=en)
                rounds[0] = max(rounds[0], r)
                checks.append((en > st).all())
                yield st, en

        out = torch.empty((m, 2), dtype=torch.int32, device=self.device)
        total, ok_c = chain_select_pieces(pieces(), n, out)
        self.full_scan_stats = (m, rounds[0])
        if not bool(torch.stack(checks + [ok_c]).all()):
            raise RuntimeError("find_all: a match start without a match "
                               "end, or a compaction fault")
        self._note_pieces(-(-m // lim))
        return out[:total], total, None

    # -- the candidate and INNER pipelines (M5) -------------------------------
    # Behind the bidirectional path, for PREFIX_RUN, PREFIX_SET and INNER
    # plans under either rule (ref. _prefix_family_spans_dev and
    # _inner_family_spans_dev, :1089-1114), after the general fallback: the
    # reference tries M5 first, but on the card at 1536 MiB the general
    # fallback was 7-14x faster on every family (PERF.md section 5,
    # chip_smoke.py's M5 run, NVIDIA H100 80GB HBM3, 700.00 W: POSIX ip 14.3
    # ms against the candidate pipeline's 191.3, version 41.0 against 324.1,
    # `[A-Z]+ \d+` 14.5 against 171.6; POSIX email 23.1 against the INNER
    # pipeline's 166.3, url 23.9 against 206.9), so M5 serves the plans
    # whose general tables the kernels cannot take (a reverse DFA that
    # overflows: POSIX `[a-z]+ [^ ]{20,60}x`, 578.5 ms).  The general
    # fallback never declines a call it takes, so nothing falls from it to
    # M5 at run time.  The reference's prefilter tracker retires its
    # pipelines into its full scan, which the general fallback is here;
    # with that first, there is nothing to retire, and the counts go to
    # the engine's Stats only.
    # candidates past it decline (ref. :1189, 2^24 for a 16 GB chip),
    # re-derived for 80 GB: `[a-z]+ [^ ]{20,60}x` has about one run start
    # in 7.5 bytes, so it reaches the limit at about 2 GB of corpus, where
    # its find_all peaks well under the card's memory (chip_smoke.py's
    # limits run, PERF.md section 5)
    _DEV_FILTER_LIMIT = 1 << 28

    def _m5_route(self):
        """("candidate", ResetScanner) for PREFIX_RUN and PREFIX_SET plans,
        ("inner", (class-run shape, suffix FlagResetScanner or None)) for
        INNER ones, or None (declined: a nullable plan, and each pipeline's
        own gates).  Host work only."""
        if self.plan.nullable:
            return None
        strat = self.plan.strategy
        if strat == Strategy.INNER:
            r = self._inner_route()
            return None if r is None else ("inner", r)
        if strat in (Strategy.PREFIX_RUN, Strategy.PREFIX_SET):
            sc = self._reset_scanner()
            return None if sc is None else ("candidate", sc)
        return None

    def _reset_scanner(self):
        """Lazy ResetScanner over the ``_verify_kind`` DFA, or None (out of
        scope: a look in the pattern, whose flag at n the scan cannot decide
        (ref. _flags_with_eoi, :1273-1283); more than 32 table columns; a
        DFA that overflows).  Host work only."""
        kind = self._verify_kind()
        sc = self._reset_sc.get(kind)
        if sc is None:
            sc = False
            if not litmod.has_looks(self.ast):
                try:
                    sc = ResetScanner(self._dense(kind), self.device)
                except (DFAOverflow, ValueError):
                    sc = False
            self._reset_sc[kind] = sc
        return sc or None

    def _sieve_ranges(self):
        """The offset byte-range sieve from the anchored DFA, cached (ref.
        :421-429)."""
        if self._sieve is None:
            self._sieve = offset_byte_ranges(self._dense(self._verify_kind()))
        return self._sieve

    def _prefix_run_table(self) -> np.ndarray:
        return np.array(self.plan.prefix_run.table, dtype=bool)

    def _prefix_run_candidates_mask(self, dev):
        """(mask, count) of the run-start candidates, sharpened by the sieve
        (ref. :1952-1963)."""
        return prefix_run_candidates(
            dev, table_to_ranges(self._prefix_run_table()),
            tuple(tuple(r) for r in self._sieve_ranges()))

    def _candidate_spans_dev(self, sc, data):
        """(spans, count, None) of a PREFIX_RUN or PREFIX_SET plan, or None
        (declined; ref. :1285-1306): candidate starts on the device (the
        run starts through the sieve, or every hit of a prefix literal),
        then ``_spans_from_candidate_mask``."""
        n = len(data)
        dev = device_corpus(data, self.device)
        if self.plan.strategy == Strategy.PREFIX_RUN:
            smask, cnt = self._prefix_run_candidates_mask(dev)
        else:
            smask = None
            for lit in self.plan.prefix_lits:
                m = _memmem_mask(dev, bytes(lit))
                smask = m if smask is None else smask | m
            cnt = mask_count(smask)
        return self._spans_from_candidate_mask(sc, dev, n, smask, int(cnt))

    def _spans_from_candidate_mask(self, sc, dev, n: int, smask, cnt: int):
        """The candidate mask's tail (ref. :1337-1385): the verified
        (start, end) pairs (``_interleaved_ends``), then Go's selection,
        ``span_chain.chain_select`` where they overlap (the exact chain the
        reference's ``go_select_device`` iterates to, with no round limit).
        Declines past _DEV_FILTER_LIMIT candidates and where the
        verification declines.  For PREFIX_RUN, Go restarts after a match
        that ends inside a class run at a position that is no candidate; a
        match there would start at that very position (a leading [c]+
        takes the run's bytes before any later start), so the window scan
        looks from each such end and the pipeline declines if one matches
        (the reference's span path does not look, :1337-1385; its count
        path declines at every such end, :2024-2026).  Returns (spans,
        count, None) or None."""
        if cnt == 0:
            return _empty_spans(self.device), 0, None
        if cnt > self._DEV_FILTER_LIMIT:
            return None
        r = self._interleaved_ends(sc, dev, n, smask, cnt)
        if r is None:
            return None
        fs, fe, kept = r
        self._note_prefilter_counts(kept, cnt)
        if kept == 0:
            return _empty_spans(self.device), 0, None
        out = torch.empty((kept, 2), dtype=torch.int32, device=self.device)
        total, ok = chain_select_pieces([(fs, fe)], n, out)
        if not bool(ok):
            raise RuntimeError("candidate pipeline: a compaction fault")
        out = out[:total]
        if self.plan.strategy == Strategy.PREFIX_RUN and total:
            e = out[:, 1]
            tbl = torch.as_tensor(self._prefix_run_table(), device=dev.device)
            ei = e.clamp(1, max(n - 1, 1)).long()
            mid = (e > 0) & (e < n) & tbl[dev[ei].long()] \
                & tbl[dev[ei - 1].long()]
            nmid = int(mid.sum())
            if nmid:
                fwd = self._chunk_scanner(self._verify_kind())
                if fwd is None:
                    return None
                _p, restart, _c, _ok = compact_pay(mid, [e],
                                                   _bucket(nmid, 16))
                ends, _r = window_ends(fwd.mt, dev, restart[:nmid].clone(),
                                       self.END_WINDOW)
                if bool((ends >= 0).any()):
                    return None
        return out, total, None

    def _interleaved_ends(self, sc, dev, n: int, smask, cnt: int):
        """Verified (starts, ends, kept) of the candidates (ref. :1191-1271):
        K interleaved reset scans, subset j resetting at every K-th
        candidate from the j-th, so each candidate's anchored run gets about
        K candidate spacings of room in one contiguous pass.  A run still
        alive at its subset's next reset trips the interference flag and K
        escalates (2, 4, 16; 4, 16 where candidates are denser than one in
        48 bytes); interference at 16, or a scan that does not converge,
        declines (None).  A candidate whose run never flags is dropped (Go
        skips it).  The candidates come out of one K8 compaction, a subset
        is every K-th of them, each run's end is the last flag inside its
        interval (``span_chain.reset_interval_ends``) and the verified pairs
        one K4 compaction: no corpus-sized int32 array.  Each scan reads
        n + 1 positions, the last a pad byte whose flag is the match at n
        (the reference's ``_flags_with_eoi``, :1273-1283; the DFA has no
        look).  The reset-free word tiles are built once a call, and each
        subset scatters its reset bits into a copy.  Syncs: one a repair
        pass, one a scan."""
        cap = _bucket(cnt, 16)
        cand, _c = compact_positions(smask, cap)
        cand = cand[:cnt]
        n1 = n + 1                     # the flag at n from the pad byte
        base = sc.tiles(sc.packed(dev, pad=1))
        L, T4 = int(base.shape[1]), int(base.shape[0])
        spacing = n // max(cnt, 1)
        for K in ((2, 4, 16) if spacing >= 48 else (4, 16)):
            ends = torch.full((cnt,), -1, dtype=torch.int32,
                              device=dev.device)
            for j in range(min(K, cnt)):
                r = cand[j::K]
                fw, conv, interf, _st = sc.scan_tiles(
                    scatter_reset_tiles(base, r, L, T4), n1)
                if not conv:
                    return None
                if interf:
                    break
                ends[j::K] = reset_interval_ends(fw, r, n)
            else:
                keep = ends >= 0
                _p, fs, fe, kept, _ok = compact_pay(keep, [cand, ends], cap)
                kept = int(kept)
                return fs[:kept], fe[:kept], kept
        return None

    def _note_prefilter_counts(self, hits: int, seen: int) -> None:
        """The prefilter tracker's counts (ref. :1387-1400): verified and
        seen candidates, into the engine's Stats."""
        if self.stats is not None:
            self.stats.prefilter_hits += hits
            self.stats.prefilter_misses += seen - hits

    @staticmethod
    def _class_run_prefix(prefix_ast, lit: bytes):
        """(table [256], m, M) when prefix_ast is [class]{m,M} followed by
        the literal, with m >= 1 and lit[0] outside the class: the viable
        starts of a match are the members of the run right before each
        literal hit, every suffix of it of m to M bytes (ref. :851-876).
        None otherwise."""
        node = litmod._uncap(prefix_ast)
        if node.op != Op.CONCAT or len(node.subs) != 2:
            return None
        rep, tail = litmod._uncap(node.subs[0]), node.subs[1]
        if tail.op != Op.LITERAL or bytes(bytearray(tail.runes)) != lit:
            return None
        if rep.op == Op.PLUS and rep.greedy:
            m, M = 1, -1
        elif rep.op == Op.REPEAT and rep.greedy and rep.min >= 1:
            m, M = rep.min, rep.max
        else:
            return None
        if m > 16:
            return None
        t = litmod.ascii_class_table(litmod._uncap(rep.subs[0]))
        if t is None or t[lit[0]]:
            return None
        return np.array(t, dtype=bool), m, M

    def _inner_route(self):
        """(class-run shape, suffix FlagResetScanner or None) of an INNER
        plan's pipeline, or None (declined as the reference's
        ``_inner_spans_dev`` declines, :908-939: more than one literal, a
        prefix that is no class run, a nullable suffix, a look in the
        suffix, more than 64 table columns or a suffix DFA that overflows).
        The suffix scan resets in the context of the literal's last byte.
        Host work only."""
        sp = self.plan.split
        if len(sp.lits) != 1:
            return None
        shape = self._class_run_prefix(sp.prefix_ast, bytes(sp.lit))
        if shape is None:
            return None
        if sp.suffix_ast.op == Op.EMPTY:
            return shape, None
        if litmod.is_nullable(sp.suffix_ast) or \
                litmod.has_looks(sp.suffix_ast):
            return None
        kind = "fwd_suffix_all" if self.longest else "fwd_suffix"
        b = sp.lit[-1]
        rctx = (CTX_WORD if (48 <= b <= 57 or 65 <= b <= 90 or b == 95
                             or 97 <= b <= 122)
                else CTX_NL if b == 10 else CTX_OTHER)
        fsc = self._flag_scanner_cache.get((kind, rctx))
        if fsc is None:
            try:
                d = self._dense(kind)
            except DFAOverflow:
                d = None
            fsc = (d is not None
                   and ResetFlagTables.alphabet_fits(DFATables.from_dense(d))
                   and FlagResetScanner(d, rctx, self.device))
            self._flag_scanner_cache[(kind, rctx)] = fsc
        return (shape, fsc) if fsc else None

    def _inner_spans_dev(self, route, data):
        """(spans, count, None) of an INNER plan with a class-run prefix, or
        None (declined; ref. :878-996): one pass builds the candidate words
        (literal hits with m members before them), the member words with
        each word's last nonmember, and the suffix scan's symbols with a
        reset at each candidate + k; K3 in its interference mode scans the
        suffix from every reset; two payload chains (K4) carry the words to
        the candidates and the resets; ``inner_assemble`` gives each
        candidate its [smin, smax] start range and end and runs the
        flexible Go selection.  Declines on more than MAX_DEVICE_SPANS
        candidates and where the check fails: a reset met a live suffix
        run (interference), or the selection did not settle.  Syncs: the
        candidate count, the check."""
        (table, m, M), fsc = route
        lit = bytes(self.plan.split.lit)
        k = len(lit)
        n = len(data)
        dev = device_corpus(data, self.device)
        ranges = table_to_ranges(table)
        if fsc is not None:
            candw, mw, lastnm_w, syms, cnt_d = inner_cand_symbols(
                dev, ranges, lit, m, fsc.byte_bounds())
        else:
            candw, mw, lastnm_w, _rm, cnt_d = inner_cand_arrays(
                dev, ranges, lit, m)
        cnt = int(cnt_d)
        if cnt == 0:
            return _empty_spans(self.device), 0, None
        if cnt > self.MAX_DEVICE_SPANS:
            return None
        cap = _bucket(cnt, 16)
        c_pos, mw_i, lastnm_i, cntA, okA = sparse_chain_payloads(
            candw, [mw, lastnm_w], n, cap)
        no = torch.zeros((), dtype=torch.bool, device=self.device)
        if fsc is None:
            live = torch.arange(cap, dtype=torch.int32,
                                device=self.device) < cntA
            spans, nsel, ok = inner_assemble(
                c_pos, mw_i, lastnm_i, c_pos, mw_i, lastnm_i, cntA, cntA,
                okA, 0, ~no, no, n, cap, k, m, M, b_empty=True,
                fixed_ends=torch.where(live, c_pos + k, 0))
        else:
            fw_raw, interf, conv, _h = fsc.scan_words_syms(syms, n)
            del syms
            nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
            flagw, lastflag_w, glob_lf = inner_flag_arrays_words(fw_raw,
                                                                 nwb1)
            rw = _shift_words(candw, k, nwb1)
            r_pos, flagw_i, lastflag_i, cntB, okB = sparse_chain_payloads(
                rw, [flagw, lastflag_w], n + 1, cap)
            spans, nsel, ok = inner_assemble(
                c_pos, mw_i, lastnm_i, r_pos, flagw_i, lastflag_i, cntA,
                cntB, okA & okB, glob_lf,
                torch.as_tensor(bool(conv), device=self.device)
                & (interf == 0), no, n, cap, k, m, M)
        nsel, okh = torch.stack([nsel.to(torch.int64),
                                 ok.to(torch.int64)]).tolist()
        if not okh:
            return None
        if nsel == 0:
            return _empty_spans(self.device), 0, None
        return spans, nsel, None

    def _prefix_run_count(self, data: np.ndarray) -> Optional[int]:
        """The count of a PREFIX_RUN plan that has no count transducer (or
        under leftmost-longest) where no find_all route serves the corpus
        (a look or more than 32 columns keep the candidate pipeline off a
        plan whose reverse DFA overflows, as POSIX `[a-z]+ [^ ]{20,60}x\\b`):
        ``_prefix_run_count_device`` when the anchored tables fit the
        window scan, else None (decided before the upload).  The reference
        tries it before its find_all (:1791-1794); on the card the find_all
        counts faster (POSIX ip at 1536 MiB: 14 ms against 92, PERF.md
        section 5), so the port counts the find_all wherever one serves."""
        if (self.plan.strategy != Strategy.PREFIX_RUN
                or self._chunk_scanner(self._verify_kind()) is None):
            return None
        with self._lock:
            return self._prefix_run_count_device(data)

    def _prefix_run_count_device(self, data: np.ndarray) -> Optional[int]:
        """The bulk count of a PREFIX_RUN plan (ref. :2001-2026): every
        candidate start's anchored end by the window scan's ends form, then
        ``bytescan.bulk_count``; None where the candidates are denser than
        one in six bytes, or where Go's selection would drop a candidate or
        restart inside a run (the caller counts the find_all)."""
        n = len(data)
        dev = device_corpus(data, self.device)
        smask, cnt = self._prefix_run_candidates_mask(dev)
        cnt = int(cnt)
        if cnt == 0:
            return 0
        if cnt > max(n // 6, 1024):
            return None
        starts, _c = compact_positions(smask, _bucket(cnt, 16))
        starts = starts[:cnt]
        ends, _r = window_ends(self._chunk_scanner(self._verify_kind()).mt,
                               dev, starts, self.END_WINDOW)
        tbl = torch.as_tensor(self._prefix_run_table(), device=dev.device)
        count, overlap, pending = torch.stack(
            [x.to(torch.int64) for x in bulk_count(starts, ends, dev, tbl,
                                                    n)]).tolist()
        return None if overlap or pending else count

    # -- the bitset-NFA tier (BITSET_NFA) -------------------------------------
    def _bitset_scanner(self, kind: str):
        """Lazy BitsetNFAScanner over the forward NFA ("fwd": match ends) or
        the reverse one ("rev": match starts, read on the flipped corpus),
        or False when out of the scan's scope: more than 512 range states,
        more than 4 closure groups, an empty match in some context (ref.
        :2385-2400).  Host work only: decides a route before the corpus is
        uploaded."""
        sc = self._bitset_sc.get(kind)
        if sc is None:
            try:
                sc = BitsetNFAScanner(
                    compile_nfa(self.parsed, reverse=(kind == "rev"),
                                with_captures=False), self.device)
            except LookUnsupported:
                sc = False
            self._bitset_sc[kind] = sc
        return sc

    def _bitset_route(self):
        """(reverse BitsetNFAScanner, MatchTables of ``_verify_kind`` or
        None) serving a BITSET_NFA plan's find_all and find_first, or None
        (declined: the reverse NFA is out of the scan's scope).  Tables
        None: the anchored DFA overflows or does not fit the kernels, and
        the Engine's host search gives the ends (ref. _bitset_spans,
        :2484-2500), the longest on a leftmost-longest engine.  Host work
        only."""
        rev = self._bitset_scanner("rev")
        if not rev:
            return None
        fwd = self._chunk_scanner(self._verify_kind())
        if fwd is None and self.host_find is None:
            return None
        return rev, (None if fwd is None else fwd.mt)

    def _bitset_rev_scan(self, rev, data: np.ndarray):
        """The settled reverse bitset scan of the flipped corpus: its flag
        at flipped offset j is a match start at n - 1 - j."""
        geom = plan_geometry(len(data))
        return rev.scan_device(device_corpus_flipped(data, self.device),
                               geom, self._flipped_tiles(data, geom))

    def _bitset_spans_dev(self, rev, fwd_mt, data, limit: int = -1):
        """(spans, count, None) of a BITSET_NFA plan (ref. _bitset_spans,
        :2484-2500, and _bitset_nfa_spans_dev, :1308-1335): every match
        start from the reverse bitset scan (``_compact_starts``), then the
        general find_all's tail (``_starts_spans_dev``); with no anchored
        tables, Go's restart walk over the starts with the host search's
        ends (``_spans_from_starts_host``), which stops after `limit`
        spans.  Syncs: the start count, then the tail's."""
        scan = self._bitset_rev_scan(rev, data)
        starts, m, ok = self._compact_starts(
            scan, int(flags_count_upto(scan)), 0, 1)
        del scan
        if fwd_mt is not None:
            return self._starts_spans_dev(starts, m, ok, fwd_mt, data)
        if not bool(ok):
            raise RuntimeError("bitset find_all: the start compaction "
                               "failed its check")
        sp = self._spans_from_starts_host(data, starts[:m].cpu().numpy(),
                                          limit)
        spans = torch.zeros((self._slots(len(sp)), 2), dtype=torch.int32,
                            device=self.device)
        spans[:len(sp)] = torch.from_numpy(sp.astype(np.int32))
        return spans, len(sp), None

    def _host_span_at(self, data: np.ndarray, s: int):
        """The host search's match at a device-found start s."""
        sp = self.host_find(data, s)
        if sp is None or sp[0] != s:
            raise RuntimeError(f"the host search finds {sp} at the match "
                               f"start {s} of the bitset scan")
        return int(sp[0]), int(sp[1])

    def _spans_from_starts_host(self, data: np.ndarray, starts: np.ndarray,
                                limit: int) -> np.ndarray:
        """Go's FindAll restart walk over the ascending match starts with
        the host search's ends (ref. :2502-2522): the next match begins at
        the first start at or after the previous match's end (every match
        is non-empty).  Host work is O(matched bytes); at most `limit`
        spans when limit >= 0."""
        out = []
        pos = 0
        while limit < 0 or len(out) < limit:
            i = int(np.searchsorted(starts, pos, side="left"))
            if i >= len(starts):
                break
            out.append(self._host_span_at(data, int(starts[i])))
            pos = out[-1][1]
        return np.array(out, dtype=np.int64).reshape(-1, 2)

    def _bitset_first(self, rev, fwd_mt, data: np.ndarray):
        """The leftmost match of a BITSET_NFA plan: Go's match begins at
        the leftmost start, the last flag of the reverse scan, and ends at
        that start's window end over the ``_verify_kind`` table (the host
        search's with no tables): the span the reference's
        _bitset_spans(limit=1) gives."""
        n = len(data)
        j = int(flags_last(self._bitset_rev_scan(rev, data)))
        if j < 0:
            return None
        s = n - 1 - j
        if fwd_mt is None:
            return self._host_span_at(data, s)
        st = torch.full((1,), s, dtype=torch.int32, device=self.device)
        e = int(window_ends(fwd_mt, device_corpus(data, self.device), st,
                            self.END_WINDOW)[0][0])
        if e <= s:
            raise RuntimeError("bitset find_first: a match start without a "
                               "match end")
        return s, e

    def _bitset_is_match(self, data: np.ndarray) -> bool:
        """Whether a BITSET_NFA plan matches: one forward bitset scan, a
        flag below n (ref. _bitset_is_match, :2428-2443).  A non-nullable
        plan has no match in an empty corpus."""
        n = len(data)
        if n == 0:
            return False
        self._check_size(n)
        geom = plan_geometry(n)
        with self._lock:
            scan = self._bitset_scanner("fwd").scan_device(
                device_corpus(data, self.device), geom,
                self._word_tiles(data, *geom[:2]))
            return int(flags_count_upto(scan)) > 0

    # -- every match empty (ALL_EMPTY) ----------------------------------------
    def _all_empty_spans_dev(self, data):
        """(spans, count, None) of a pattern whose every match is empty
        (ref. meta/nullable.py:all_empty_spans): an empty match at each
        rune boundary.  The [n + 1] boundary mask in corpus pieces of
        DEVICE_SPANS_LIMIT positions (one within the limit), each
        compacted by K8 in pieces of the span limit into one output."""
        n = len(data)
        dev = device_corpus(data, self.device)
        cuts = list(range(0, n + 1, self.DEVICE_SPANS_LIMIT)) + [n + 1]
        masks = [rune_boundaries_range(dev, a, b)
                 for a, b in zip(cuts[:-1], cuts[1:])]
        counts = torch.stack([mask_count(b) for b in masks]).tolist()
        total = sum(counts)
        out = torch.empty((total, 2), dtype=torch.int32, device=self.device)
        off, pieces = 0, 0
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for a, b, c in zip(cuts, masks, counts):
            col = out[off:off + c, 0]
            w, k, okp = compact_positions_into(b, col, self.MAX_DEVICE_SPANS,
                                               total=c)
            col += a
            ok = ok & okp & (w == c)
            off += c
            pieces += k
        del masks
        # the output's pieces: every compaction of every corpus piece
        out[:, 1] = out[:, 0]
        if not bool(ok):
            raise RuntimeError("rune-boundary compaction failed its check")
        self._note_pieces(pieces, len(counts))
        return out, total, None

    # -- class runs (CHARCLASS) ----------------------------------------------
    def _charclass_spans_dev(self, cc, data, limit=-1):
        """(spans, count, None) of a CHARCLASS plan (ref. batch.py:710-742
        and :2028-2075): the maximal class runs of length >= min packed to
        words, one sync for the run count, then each column compacted
        (span_chain.pair_spans_pieces: the sparse chain when runs are
        sparse, else K4 over the unpacked mask; the reference's
        _charclass_dense_pair, :744-758, rebuilds the masks from the corpus
        instead), in pieces of the span limit past it.  [class]+ takes the
        runs; ([class]{m,k})+ chops each run to its one match
        (``_chop_runs``, or ``_chop_runs_longest`` on a leftmost-longest
        engine); [class]{m,k} splits each run into its matches on the
        device (span_chain.expand_class_runs).  Every run counted holds a
        match, so a limit >= 0 extracts only the first `limit` runs (the
        reference's bounded take, :2039-2043, which it keeps to min <= 1
        because it counts shorter runs too)."""
        n = len(data)
        dev = device_corpus(data, self.device)
        plain = cc.min == 1 and cc.max == -1 and not cc.plus
        ranges = table_to_ranges(np.array(cc.table, dtype=bool))
        ws, we, cs_d, _ce = class_run_words(dev, ranges, cc.min)
        cnt = int(cs_d)
        if cnt == 0:
            return _empty_spans(self.device), 0, None
        take = cnt if limit < 0 else min(cnt, limit)
        spans, ok, pieces = pair_spans_pieces(
            ws, we, n, n, cnt, self.MAX_DEVICE_SPANS, end_adjust=1,
            dense=cnt / n >= SPARSE_OK, take=-1 if take == cnt else take)
        del ws, we
        self._note_pieces(pieces)
        if not bool(ok):
            raise RuntimeError("class-run span assembly failed its "
                               "consistency check")
        if not (plain or cc.plus):
            spans, total = expand_class_runs(spans, cc.min, cc.max, n, limit)
            return spans, total, None
        if not plain:
            chop = _chop_runs_longest if self.longest else _chop_runs
            spans = chop(spans, cc.min, cc.max)
        return spans, take, None

    # -- literals and literal sets (LITERAL, MULTI_LITERAL) -------------------
    def _literal_spans_dev(self, lits, data, known_cnt, fp):
        """(spans, count, ok) of a literal or a literal set (ref. batch.py
        :678-708 and :760-796): the hits packed to words (a set's in slices
        past MULTI_FUSED_LIMIT), one sync for the hit count, then positions
        from the sparse chain, or from K4 over the unpacked mask when hits
        are dense.  Hits that cannot overlap give the spans directly: a
        literal's fixed length, or a set's start and end words zipped (a
        set's end is its winning literal's).  Hits that overlap -- a
        self-overlapping literal such as `0\\.0`, a set whose start and end
        counts differ, or whose zipped spans fail their check -- go
        through leftmost_first_spans.  The reference hands those three
        cases and dense sets to its host loop, after the upload (ROADMAP
        F9).  Warm: the cached (hit count, selection) verdict sizes the
        caps and picks the branch; count and ok stay on the device."""
        n = len(data)
        dev = device_corpus(data, self.device)
        single = len(lits) == 1
        if single:
            ws, cnt_d = literal_words(dev, lits[0])
        else:
            producer = (multi_literal_words if n <= MULTI_FUSED_LIMIT
                        else multi_literal_words_big)
            ws, we, cnt_d, ce_d = producer(dev, lits)
        if known_cnt is not None:
            cnt, select = known_cnt
        elif single:
            cnt, select = int(cnt_d), literal_self_overlaps(lits[0])
        else:
            cnt, ce = torch.stack([cnt_d, ce_d]).tolist()
            select = cnt != ce
        self._spans_cnt_cache[fp] = (cnt, select)
        if cnt == 0:
            return _empty_spans(self.device), 0, None
        if cnt > (self._chain_piece() if select else self.MAX_DEVICE_SPANS):
            return self._literal_pieces(lits, dev, ws, None if single
                                        else we, cnt, select)
        cap = _bucket(cnt, 16)
        dense = cnt / n >= SPARSE_OK
        if not select:
            if single:
                spans, _c, ok = literal_spans_sparse(ws, n, cap,
                                                     len(lits[0]), dense)
            else:
                spans, _c, ok = pair_spans_sparse(ws, we, n, n + 1, cap,
                                                  dense=dense)
            if known_cnt is not None:
                return spans, cnt_d, ok
            if bool(ok):
                return spans, cnt, None
            if single:
                raise RuntimeError("literal span chain failed its "
                                   "consistency check")
            # two hits overlap, yet the set has as many ends as starts
            self._spans_cnt_cache[fp] = (cnt, True)
            if cnt > self._chain_piece():
                return self._literal_pieces(lits, dev, ws, we, cnt, True)
        if not single:
            del we
        starts, _c, ok1 = word_positions(ws, n, cap, dense)
        del ws
        spans, total, ok = leftmost_first_spans(dev, starts, cnt_d, lits,
                                                cap)
        ok = ok & ok1
        if known_cnt is not None:
            return spans, total, ok
        if not bool(ok):
            raise RuntimeError("leftmost-first literal selection failed its "
                               "consistency check")
        return spans, int(total), None

    def _literal_pieces(self, lits, dev, ws, we, cnt: int, select: bool):
        """_literal_spans_dev past the span limit (cnt hits): hits that
        cannot overlap give their spans column by column in pieces
        (word_positions_into, pair_spans_pieces); hits that overlap go
        through Go's selection a piece of CHAIN_PIECE hits at a time, the
        last accepted end carried (chain_select_pieces), into an output of
        cnt rows whose first `count` are the spans."""
        n = int(dev.shape[0])
        lim = self.MAX_DEVICE_SPANS
        dense = cnt / n >= SPARSE_OK
        if not select:
            if we is None:
                out = torch.empty((cnt, 2), dtype=torch.int32,
                                  device=self.device)
                c, pieces, ok = word_positions_into(ws, n, out[:, 0], lim,
                                                    dense, total=cnt)
                out[:, 1] = out[:, 0] + len(lits[0])
                ok = ok & (c == cnt)
            else:
                out, ok, pieces = pair_spans_pieces(ws, we, n, n + 1, cnt,
                                                    lim, dense=dense)
            if bool(ok):
                self._note_pieces(pieces)
                return out, cnt, None
            if we is None:
                raise RuntimeError("literal span chain failed its "
                                   "consistency check")
            # two hits overlap, yet the set has as many ends as starts
            del out
        checks = []
        runs = word_pieces(ws, self._chain_piece(), total=cnt)

        def pieces():
            for w0, w1, c in runs:
                if c == 0:
                    continue
                base = 32 * w0
                pos, cp, okp = word_positions(ws[w0:w1],
                                              min(n, 32 * w1) - base,
                                              _bucket(c, 16), dense)
                st = pos[:c] + base
                del pos
                length, okl = literal_lengths(dev, st, c, lits, c)
                checks.append(okp & okl & (cp == c))
                yield st, st + length

        out = torch.empty((cnt, 2), dtype=torch.int32, device=self.device)
        total, ok_c = chain_select_pieces(pieces(), n, out)
        if not bool(torch.stack(checks + [ok_c]).all()):
            raise RuntimeError("leftmost-first literal selection failed its "
                               "consistency check")
        self._note_pieces(len(checks))
        return out[:total], total, None

    # -- nullable patterns (NULLABLE_CORE) ------------------------------------
    def _core(self):
        """Lazy Engine over the non-empty core projection on this engine's
        device (ref. batch.py:2467-2476); its own plan and routes serve
        the core's find_all."""
        if self._core_engine is None:
            from .engine import Engine
            sub = Parsed(self.plan.core_ast, 0, [],
                         self.parsed.pattern + "<core>")
            self._core_engine = Engine(sub, longest=False,
                                       device=self.device)
        return self._core_engine

    def _nullable_route(self, data: np.ndarray):
        """("nullable_k8", class shape) for a [class]+ core on an ASCII
        corpus; ("nullable", (core BatchEngine, ASCII verdict)) when the
        core's own find_all route serves the corpus (a literal core such as
        `(error)?`, a {m,k} class core such as `a{0,3}`'s, a core with a
        look such as `(\bfoo)?`'s on the general route among them); else
        None: a core whose plan declines find_all declines."""
        core_be = self._core().batch_engine()
        cc = core_be.plan.charclass
        ascii_ok = corpus_is_ascii(data, self.device)
        if (core_be.plan.strategy == Strategy.CHARCLASS and cc.min == 1
                and cc.max == -1 and not cc.plus and ascii_ok):
            return "nullable_k8", cc
        if len(data) < 4 or core_be._spans_route(data) is None:
            return None
        return "nullable", (core_be, ascii_ok)

    def _nullable_spans_dev(self, cc, data):
        """(spans, count, None) for a [class]+ core on an ASCII corpus
        (ref. batch.py:589-633): the matches form an aligned mask pair,
        starts = run starts and accepted empties, ends = run ends + 1 and
        the same empties, disjoint and strictly interleaved, so two K8
        compactions, each column in pieces of the span limit, assemble the
        span list with no sort.  Empties sit at the positions that are
        neither members nor a run's exclusive end; ASCII makes every
        position a rune boundary."""
        smask, emask = nullable_class_masks(
            device_corpus(data, self.device), np.array(cc.table, dtype=bool))
        total = int(mask_count(smask))
        if total == 0:
            return _empty_spans(self.device), 0, None
        out = torch.empty((total, 2), dtype=torch.int32, device=self.device)
        cs, ps, ok1 = compact_positions_into(smask, out[:, 0],
                                             self.MAX_DEVICE_SPANS,
                                             total=total)
        del smask
        ce, pe, ok2 = compact_positions_into(
            emask, out[:, 1], self.MAX_DEVICE_SPANS, take=total, total=total)
        del emask
        if not bool(ok1 & ok2) or cs != total or ce != total:
            raise RuntimeError("nullable mask pair is not aligned")
        self._note_pieces(max(ps, pe))
        return out, total, None

    def _nullable_general_spans_dev(self, args, data):
        """(spans, count, None) for general cores and UTF-8 corpora (ref.
        batch.py:635-676): the core's spans from the core engine's own
        device route, then the empty fill as device algebra and a merge by
        rank, a corpus piece of DEVICE_SPANS_LIMIT positions at a time
        (``_nullable_fill_pieces``; one within the limit), each piece's
        empty positions compacted in pieces of the span limit, into one
        output."""
        core_be, ascii_ok = args
        spans_c, cnt_c = core_be.find_all_spans_device(data)
        self._note_pieces(*core_be.pieces)
        dev = device_corpus(data, self.device)
        pieces = self._nullable_fill_pieces(spans_c, cnt_c, dev, ascii_ok)
        ne_all = sum(p[3] for p in pieces)
        if ne_all == 0:
            return spans_c, cnt_c, None
        total = cnt_c + ne_all
        self._note_pieces(1, len(pieces))
        out = torch.empty((total, 2), dtype=torch.int32, device=self.device)
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        off = used = 0
        for a, b, Bw, ne, ci0, ci1 in pieces:
            dst = out[off:off + (ci1 - ci0) + ne]
            if ne:
                emp = torch.empty(ne, dtype=torch.int32, device=self.device)
                k, p, okp = word_positions_into(Bw, b - a, emp,
                                                self.MAX_DEVICE_SPANS,
                                                total=ne)
                ok = ok & okp & (k == ne)
                emp += a
                nullable_merge_into(dst, spans_c[ci0:ci1], emp)
                del emp
                used += p
            else:
                dst.copy_(spans_c[ci0:ci1])
            off += int(dst.shape[0])
        del pieces
        if not bool(ok):
            raise RuntimeError("empty-position chain failed its consistency "
                               "check")
        # the output's pieces: every empty compaction of every corpus piece
        self._note_pieces(used)
        return out, total, None

    def _nullable_fill_pieces(self, spans_c, cnt_c: int, dev,
                              ascii_ok: bool):
        """The empty fill of the [n + 1] positions in corpus pieces of
        about DEVICE_SPANS_LIMIT positions, each cut moved off any core
        span that crosses it (to its start, or past its end when it
        starts the piece): [(a, b, empty words of [a, b), empty count,
        first core span, end core span)], the core spans of a piece those
        that start in it.  A core span that ends at a piece's start bars
        an empty match there (nullable_fill_range's `ends`)."""
        n = int(dev.shape[0])
        S = spans_c[:cnt_c, 0].contiguous()
        E = spans_c[:cnt_c, 1].contiguous()

        def rank(x, a: int, b: int):
            return torch.searchsorted(x, torch.tensor(
                [a, b], dtype=torch.int32, device=x.device)).tolist()

        out = []
        a = 0
        while a < n + 1:
            b = min(n + 1, a + self.DEVICE_SPANS_LIMIT)
            if b < n + 1 and cnt_c:
                i = int(torch.searchsorted(E, torch.tensor(
                    [b], dtype=torch.int32, device=E.device), right=True)[0])
                if i < cnt_c:
                    s_i, e_i = spans_c[i].tolist()
                    if s_i < b:
                        b = s_i if s_i > a else e_i
            ci0, ci1 = rank(S, a, b) if cnt_c else (0, 0)
            ei0, ei1 = rank(E, a, b) if cnt_c else (0, 0)
            Bw, ne = nullable_fill_range(dev, a, b, S[ci0:ci1], E[ci0:ci1],
                                         E[ei0:ei1], ascii_ok)
            out.append((a, b, Bw, int(ne), ci0, ci1))
            a = b
        return out
