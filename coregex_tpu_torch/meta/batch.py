"""Corpus-scale execution on a torch device: count and find_all.

Ports the main path of ``coregex_tpu/meta/batch.py:BatchEngine``: plan
selection (:296-344), ``_dense`` (:351-419) for the kinds the path uses, the
count scanners (:1456-1629), ``count`` (:1698-1790) with ``nullable_count``'s
route and UTF-8 gate (:1668-1696) folded in, ``_line_shape_parts``
(:2091-2097), the bidirectional span path (:999-1184), the line-shape span
path (:798-848), ``find_all_spans_device`` (:523-587) and
``find_all_spans``.

Routes:
  * count, in the reference's order (:1740-1790): K5 (LineScanner) for a
    LINE_SHAPE or line-set FULL_SCAN plan that ``_line_shape_args``
    accepts; K6 (HitsScanner) for LITERAL and MULTI_LITERAL plans, and K7
    (SeqScanner, MODE_MULTI) when K6 finds two hits overlapping; otherwise
    the count transducer (the nullable transducer, behind its UTF-8 gate,
    for nullable plans).  The reference's class-run, memmem and
    multi-literal XLA counts are not ported; the transducer gives the same
    counts.  Unlike the reference, these routes run on every device (its
    scanners run only on a TPU backend) and a failing scanner raises
    instead of being retired.  The reference reaches K7 in MODE_LINE only
    after retiring a LineScanner, since both take the same needle sets, so
    the port does not route it.
  * find_all: the bidirectional span path for PREFIX_RUN, PREFIX_SET,
    FULL_SCAN and INNER plans whose count transducer is spans_simple with
    no EOI_COMPLEX state; the candidate chain for LINE_SHAPE plans with
    newline-free, non-empty literals and no ``(?s)`` part.
A call outside these routes returns None (find_first returns FALLBACK) and
the Engine's host loop serves it; each such decline adds one to
``host_routes``.  The route is decided on the host, from the plan, its
tables and the corpus's ASCII verdict, before the corpus is uploaded.  Once
a call is on the device it finishes there or raises: the repair fixpoints
run until they settle (at most L rescans), a table too large for the
kernels raises ValueError when it is built, and a result over
MAX_DEVICE_SPANS spans raises ValueError.

Corpus state (the host array, its ASCII verdict) travels as arguments, not
engine attributes, so concurrent calls on one engine cannot mix corpora
(ROADMAP F1).  Device calls serialize on a per-device lock.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from coregex_tpu.dfa.countdfa import (EOI_COMPLEX, build_count_dfa,
                                      build_count_dfa_nullable)
from coregex_tpu.dfa.dense import CTX_SOT
from coregex_tpu.dfa.determinize import (DFAOverflow, determinize,
                                         determinize_py)
from coregex_tpu.meta import literal as litmod
from coregex_tpu.meta.batch import FALLBACK
from coregex_tpu.meta.literal import UNIV_ANY, UNIV_LINE
from coregex_tpu.meta.strategy import Plan, Strategy, select
from coregex_tpu.nfa.thompson import compile_nfa
from coregex_tpu.syntax.ast import Node, Op
from coregex_tpu.syntax.parser import Parsed
from coregex_tpu.utils.artifact_cache import load_dense, save_dense
from coregex_tpu.utils.corpus_cache import _fingerprint
from coregex_tpu.utils.device_lock import device_lock

from ..ops.bytescan import _bucket
from ..ops.compact2 import _bucket_up
from ..ops.count_scan import CountScanner, make_word_tiles, plan_geometry
from ..ops.dfa_scan import DFATables
from ..ops.flag_scan import (FlagResetScanner, ResetFlagTables,
                             reset_geometry, scatter_reset_tiles,
                             sym_base_tiles)
from ..ops.line_scan import HitsScanner, LineScanner
from ..ops.seq_scan import MODE_MULTI, SeqScanner, seq_geometry
from ..ops.span_chain import (bidi_assemble, bidi_ends, line_event_words,
                              line_spans_candidates)
from ..ops.span_scan import SpanScanner
from ..utils.corpus_cache import (corpus_is_ascii, corpus_tiles,
                                  device_corpus, device_corpus_flipped)

# positions are int32 on the device path (ROADMAP F6): the reverse scan
# walks n + 32 symbols, and every position must stay below 2^31
MAX_CORPUS = 2 ** 31 - 33


def _empty_spans(device):
    return torch.zeros((16, 2), dtype=torch.int32, device=device)


class BatchEngine:
    """Per-pattern batch plan + device artifacts on one torch device."""

    # span limits of the reference (batch.py:484-492), kept at its values:
    # the bidi families are all "sparse" families there (its 448 MiB
    # DEVICE_SPANS_LIMIT governs pipelines not ported here)
    SPARSE_SPANS_LIMIT = 1600 * 1024 * 1024
    MAX_DEVICE_SPANS = 128 * 1024 * 1024
    # plans whose find_all takes the bidirectional path: the bidi branches
    # of the reference's _prefix_family_spans_dev / _inner_family_spans_dev
    # and its FULL_SCAN builder (their candidate and INNER pipelines
    # behind the bidi path are not ported)
    _BIDI_FAMILIES = (Strategy.PREFIX_RUN, Strategy.PREFIX_SET,
                      Strategy.FULL_SCAN, Strategy.INNER)
    # plans whose find_all runs on the device: the bidi families and the
    # line shapes (all "sparse" families of the reference, :494-496)
    _SPAN_FAMILIES = _BIDI_FAMILIES + (Strategy.LINE_SHAPE,)

    def __init__(self, parsed: Parsed, ast: Node, dfas_ok: bool, device,
                 longest: bool = False):
        self.parsed = parsed
        self.ast = ast
        self.longest = longest
        self.device = torch.device(device)
        self.plan: Plan = select(ast, dfas_ok)
        if longest and self.plan.strategy in (Strategy.NULLABLE_CORE,
                                              Strategy.ALL_EMPTY):
            self.plan = Plan(Strategy.HOST, "nullable (longest): host",
                             nullable=True)
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
        # per-corpus-fingerprint (total, kind) of the bidi path, or the
        # candidate total of the line path: sizes warm find_all caps
        # without a count sync
        self._spans_cnt_cache = {}
        self._rev_hint_cache = {}   # corpus fp -> reverse-scan lane entries

    def _decline(self, result=None):
        self.host_routes += 1
        return result

    # -- artifact builders (lazy) ---------------------------------------
    def _dense(self, kind: str):
        """Host DenseDFA of the given kind.  The main path needs only the
        anchored reverse DFAs; later slices add the reference's others."""
        if kind in self._host_dense:
            return self._host_dense[kind]
        d = load_dense(self.parsed.pattern, kind)
        if d is None:
            if kind not in ("rev_anch", "rev_anch_ascii"):
                raise KeyError(kind)
            nfa = compile_nfa(self.parsed, reverse=True,
                              ascii_only=(kind == "rev_anch_ascii"))
            d = determinize(nfa, anchored=True, break_at_match=False,
                            reverse=True)
            save_dense(self.parsed.pattern, kind, d)
        self._host_dense[kind] = d
        return d

    def _make_count_scanner(self, ascii_only: bool):
        """CountScanner over the FindAll-count transducer, or False when
        out of scope; ascii_only builds the ASCII-projected tables (exact
        when every corpus byte < 0x80).  Raises ValueError when the tables
        are too large for the device's kernels."""
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
        (declined: the Engine's host loop counts)."""
        if len(data) > MAX_CORPUS:
            raise ValueError(f"corpus of {len(data)} bytes exceeds the "
                             f"int32 position range ({MAX_CORPUS})")
        with self._lock:
            route = self._count_route(data)
            if route is None:
                return self._decline()
            kind, sc = route
            geom = plan_geometry(len(data))
            dev = device_corpus(data, self.device)
            tiles = self._word_tiles(data, *geom[:2])
            if kind == "line":
                return sc.count(dev, data, geom, tiles)
            if kind == "hits":
                c = sc.count(dev, geom, tiles)
                if c is None:
                    # two hits overlap: the sequential leftmost-first count
                    sq = self._seq_sc
                    c = sq.count(dev, seq_geometry(len(data), sq.M), tiles)
                return c
            return sc.count(dev, geom, tiles)

    # -- single match: not on this slice ----------------------------------
    def is_match(self, data: np.ndarray):
        return self._decline(None)

    def find_first(self, data: np.ndarray):
        return self._decline(FALLBACK)

    # -- find_all -----------------------------------------------------------
    def find_all_spans(self, data: np.ndarray, limit: int = -1
                       ) -> Optional[np.ndarray]:
        """All non-overlapping spans with Go semantics as an [m, 2] int64
        host array, or None (declined)."""
        if limit >= 0:
            return self._decline(None)
        r = self.find_all_spans_device(data)
        if r is None:
            return None
        spans, cnt = r
        return spans[:cnt].cpu().numpy().astype(np.int64)

    def find_all_spans_device(self, data: np.ndarray,
                              defer_ok: bool = False):
        """(spans [cap, 2] int32 on the device, count) or None (declined).
        With defer_ok=True returns (spans, count, ok): ok a device bool or
        None (validated here), and on a warm call (a corpus with a cached
        fingerprint) the count is a device scalar and no sync is paid for
        the caps."""
        n = len(data)
        strat = self.plan.strategy
        if (strat not in self._SPAN_FAMILIES or n == 0
                or n > self.SPARSE_SPANS_LIMIT):
            return self._decline(None)
        if n > MAX_CORPUS:
            raise ValueError(f"corpus of {n} bytes exceeds the int32 "
                             f"position range ({MAX_CORPUS})")
        fp = _fingerprint(data)
        known = self._spans_cnt_cache.get(fp) if defer_ok else None
        with self._lock:
            if strat == Strategy.LINE_SHAPE:
                route = self._line_spans_route()
                if route is None:
                    return self._decline(None)
                spans, cnt, ok = self._line_shape_spans_dev(route, data,
                                                            known, fp)
            else:
                route = self._bidi_route(corpus_is_ascii(data, self.device))
                if route is None:
                    return self._decline(None)
                spans, cnt, ok = self._bidi_spans_dev(*route, data, known,
                                                      fp)
        return (spans, cnt, ok) if defer_ok else (spans, cnt)

    # -- line-shape span path -------------------------------------------------
    def _line_spans_route(self):
        """(mode, lit, prefix, anchored) of the candidate chain, or None
        (declined): a (?s) part, a newline in the literal or prefix, an
        empty literal, or leftmost-longest.  Host work only."""
        if self.longest:
            return None
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

    def _line_shape_spans_dev(self, route, data, known_cnt, fp):
        """(spans, count, ok) via the candidate chain (ref. batch.py:
        798-848).  Cold: one sync for the candidate total, one for count
        and ok (validated here, ok None); warm: the cached candidate total
        sizes the caps, count and ok stay on the device."""
        mode, lit, prefix, anchored = route
        n = len(data)
        words, cnts = line_event_words(device_corpus(data, self.device),
                                       lit, prefix, anchored)
        if known_cnt is None:
            cand_total = int(cnts[1])
            self._spans_cnt_cache[fp] = cand_total
        else:
            cand_total = known_cnt
        if cand_total == 0:
            return _empty_spans(self.device), 0, None
        if cand_total > self.MAX_DEVICE_SPANS:
            raise ValueError(f"{cand_total} candidates exceed the device "
                             f"span limit ({self.MAX_DEVICE_SPANS})")
        cap = _bucket(cand_total, 16)
        spans, cnt_d, ok = line_spans_candidates(
            list(words), n, cap, mode, anchored, len(lit), len(prefix))
        if known_cnt is None:
            if not bool(ok):
                raise RuntimeError("line-shape span assembly failed its "
                                   "consistency check")
            cnt = int(cnt_d)
            if cnt == 0:
                return _empty_spans(self.device), 0, None
            return spans, cnt, None
        return spans, cnt_d, ok

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
        if total > self.MAX_DEVICE_SPANS:
            raise ValueError(f"{total} matches exceed the device span "
                             f"limit ({self.MAX_DEVICE_SPANS})")
        capM = _bucket(total + 1, 16)
        nwb = _bucket_up(max(-(-n // 32), 1))
        nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
        ends_c, cntF, rq, rw, okA = bidi_ends(fw, gw, n, total_d, kind_d,
                                              capM, nwb, nwb1)
        Lr, Tr, _W, _Lc = reset_geometry(n)
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
