# Copy of coregex_tpu/dfa/determinize.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Eager subset-construction determinizer.

Host-side analogue of the reference's lazy determinization
(dfa/lazy/builder.go:134-239: epsilonClosure / moveWithWordContextBreak /
resolveWordBoundaries / CheckEOIMatch), run to completion at compile time.

Key semantics preserved exactly:
  * priority order = DFS order over SPLIT targets (leftmost-first);
  * break-at-match (builder.go:172-239 analogue): when a MATCH state is seen
    while resolving a transition, lower-priority NFA states are pruned, so
    the last recorded match of a scan is the leftmost-first match end;
  * look-around: BEGIN_TEXT/BEGIN_LINE resolve against the *previous* byte
    (baked into state identity via context flags), END_TEXT/END_LINE and
    word boundaries resolve against the *next* byte (kept as unresolved LOOK
    members of the state set, resolved per transition column — the
    word-boundary flag machinery of dfa/lazy/state.go:130-176);
  * EOI is an extra virtual transition column (CheckEOIMatch analogue).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..nfa.nfa import NFA, ByteClasses, Kind, Look, WORD_BYTES
from .dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD, DEAD, DenseDFA

DEFAULT_STATE_LIMIT = 20_000


class DFAOverflow(Exception):
    """Raised when determinization exceeds the state budget; the meta engine
    falls back to the NFA engines (the reference's ErrCacheFull → PikeVM
    fallback analogue, dfa/lazy/lazy.go:1472-1502)."""


# A DFA state: ordered NFA ids (RANGE / MATCH / unresolved LOOK) + context.
# Context flags describe the byte *entering* this state.
StateKey = Tuple[Tuple[int, ...], bool, bool, bool]  # ids, prev_word, prev_nl, at_start


class _Determinizer:
    def __init__(self, nfa: NFA, anchored: bool, break_at_match: bool,
                 state_limit: int, byte_classes: Optional[ByteClasses]):
        self.nfa = nfa
        self.anchored = anchored
        self.break_at_match = break_at_match
        self.state_limit = state_limit
        self.bc = byte_classes or nfa.byte_classes()
        self.states = nfa.states
        self.needs_word = nfa.has_look(Look.WORD_BOUNDARY,
                                       Look.NO_WORD_BOUNDARY)
        self.needs_prev = nfa.has_look(Look.BEGIN_TEXT, Look.BEGIN_LINE,
                                       Look.WORD_BOUNDARY,
                                       Look.NO_WORD_BOUNDARY)

        C = self.bc.num_classes
        # per-class representative byte + flags
        rep = np.zeros(C, dtype=np.int64)
        seen = set()
        for b in range(256):
            c = int(self.bc.classes[b])
            if c not in seen:
                rep[c] = b
                seen.add(c)
        self.cls_word = np.array([bool(WORD_BYTES[rep[c]]) for c in range(C)])
        self.cls_nl = np.array([rep[c] == 10 for c in range(C)])

        self.key_to_id: Dict[StateKey, int] = {}
        self.sets: List[StateKey] = []
        # state 0 = DEAD
        dead_key: StateKey = ((), False, False, False)
        self.key_to_id[dead_key] = DEAD
        self.sets.append(dead_key)

    # -- epsilon closure with prev-context known, next unknown -----------
    def closure(self, roots: List[int], prev_word: bool, prev_nl: bool,
                at_start: bool) -> Tuple[int, ...]:
        out: List[int] = []
        emitted = set()
        visited = set()
        stack: List[int] = list(reversed(roots))
        while stack:
            sid = stack.pop()
            if sid in visited:
                continue
            visited.add(sid)
            st = self.states[sid]
            k = st[0]
            if k == Kind.RANGE or k == Kind.MATCH:
                if sid not in emitted:
                    emitted.add(sid)
                    out.append(sid)
            elif k == Kind.SPLIT:
                # push in reverse so first target pops first (priority)
                for t in reversed(st[1:]):
                    stack.append(t)
            elif k == Kind.CAPTURE:
                stack.append(st[2])
            elif k == Kind.LOOK:
                look = st[1]
                if look == Look.BEGIN_TEXT:
                    if at_start:
                        stack.append(st[2])
                elif look == Look.BEGIN_LINE:
                    if at_start or prev_nl:
                        stack.append(st[2])
                else:
                    # next-dependent: keep unresolved
                    if sid not in emitted:
                        emitted.add(sid)
                        out.append(sid)
            # FAIL: drop
        return tuple(out)

    # -- full closure when both prev and next are known ------------------
    def closure_full(self, roots: List[int], prev_word: bool, prev_nl: bool,
                     at_start: bool, next_word: bool, next_nl: bool,
                     at_eoi: bool, out: List[int], emitted: set,
                     visited: set) -> None:
        stack: List[int] = list(reversed(roots))
        while stack:
            sid = stack.pop()
            if sid in visited:
                continue
            visited.add(sid)
            st = self.states[sid]
            k = st[0]
            if k == Kind.RANGE or k == Kind.MATCH:
                if sid not in emitted:
                    emitted.add(sid)
                    out.append(sid)
            elif k == Kind.SPLIT:
                for t in reversed(st[1:]):
                    stack.append(t)
            elif k == Kind.CAPTURE:
                stack.append(st[2])
            elif k == Kind.LOOK:
                look = st[1]
                ok = False
                if look == Look.BEGIN_TEXT:
                    ok = at_start
                elif look == Look.BEGIN_LINE:
                    ok = at_start or prev_nl
                elif look == Look.END_TEXT:
                    ok = at_eoi
                elif look == Look.END_LINE:
                    ok = at_eoi or next_nl
                elif look == Look.WORD_BOUNDARY:
                    ok = prev_word != next_word
                elif look == Look.NO_WORD_BOUNDARY:
                    ok = prev_word == next_word
                if ok:
                    stack.append(st[2])

    # -- transition ------------------------------------------------------
    def transition(self, key: StateKey, c: Optional[int],
                   eoi_ctx: int = CTX_SOT) -> Tuple[int, bool]:
        """Transition from state `key` on class `c` (None == window edge).

        For c is None, `eoi_ctx` describes what lies beyond the edge:
        CTX_SOT == true end of text; CTX_WORD/CTX_NL/CTX_OTHER == a byte of
        that kind follows the window (bounded scans).
        Returns (next_state_id, is_match_at_current_position)."""
        ids, prev_word, prev_nl, at_start = key
        if c is None:
            at_eoi = eoi_ctx == CTX_SOT
            next_word = eoi_ctx == CTX_WORD
            next_nl = eoi_ctx == CTX_NL
        else:
            at_eoi = False
            next_word = bool(self.cls_word[c])
            next_nl = bool(self.cls_nl[c])
        at_edge = c is None

        # resolve: expand unresolved looks, detect match, apply priority cut
        resolved: List[int] = []
        emitted: set = set()
        visited: set = set()
        is_match = False
        for sid in ids:
            if is_match and self.break_at_match:
                break
            st = self.states[sid]
            k = st[0]
            if k == Kind.MATCH:
                is_match = True
            elif k == Kind.RANGE:
                if sid not in emitted:
                    emitted.add(sid)
                    resolved.append(sid)
            elif k == Kind.LOOK:
                look = st[1]
                ok = False
                if look == Look.END_TEXT:
                    ok = at_eoi
                elif look == Look.END_LINE:
                    ok = at_eoi or next_nl
                elif look == Look.WORD_BOUNDARY:
                    ok = prev_word != next_word
                elif look == Look.NO_WORD_BOUNDARY:
                    ok = prev_word == next_word
                if ok:
                    before = len(resolved)
                    self.closure_full([st[2]], prev_word, prev_nl, at_start,
                                      next_word, next_nl, at_eoi,
                                      resolved, emitted, visited)
                    # closure_full may emit MATCH ids; handle them in order
                    kept: List[int] = []
                    for rid in resolved[before:]:
                        if is_match and self.break_at_match:
                            break
                        if self.states[rid][0] == Kind.MATCH:
                            is_match = True
                        else:
                            kept.append(rid)
                    del resolved[before:]
                    resolved.extend(kept)
        if at_edge:
            return DEAD, is_match

        # step on the byte class
        rep_is_word = next_word
        rep_is_nl = next_nl
        targets: List[int] = []
        for sid in resolved:
            st = self.states[sid]
            # st is RANGE here
            lo, hi = st[1], st[2]
            # class membership is all-or-nothing by construction; test rep
            b = self._rep(c)
            if lo <= b <= hi:
                targets.append(st[3])
        new_ids = self.closure(targets, rep_is_word, rep_is_nl, False)
        if not new_ids:
            return DEAD, is_match
        new_key: StateKey = (new_ids,
                             rep_is_word if self.needs_prev else False,
                             rep_is_nl if self.needs_prev else False,
                             False)
        return self._intern(new_key), is_match

    def _rep(self, c: int) -> int:
        # smallest byte of class c (cached)
        if not hasattr(self, "_rep_cache"):
            C = self.bc.num_classes
            rep = [256] * C
            for b in range(255, -1, -1):
                rep[int(self.bc.classes[b])] = b
            self._rep_cache = rep
        return self._rep_cache[c]

    def _intern(self, key: StateKey) -> int:
        sid = self.key_to_id.get(key)
        if sid is None:
            sid = len(self.sets)
            if sid > self.state_limit:
                raise DFAOverflow(
                    f"DFA exceeds {self.state_limit} states for pattern")
            self.key_to_id[key] = sid
            self.sets.append(key)
        return sid

    # -- main loop -------------------------------------------------------
    def run(self) -> DenseDFA:
        start_nfa = (self.nfa.start_anchored if self.anchored
                     else self.nfa.start_unanchored)
        ctxs = [
            (False, False, True),    # CTX_SOT: at_start
            (True, False, False),    # CTX_WORD
            (False, True, False),    # CTX_NL
            (False, False, False),   # CTX_OTHER
        ]
        starts = np.zeros(4, dtype=np.int32)
        for i, (pw, pn, at_start) in enumerate(ctxs):
            ids = self.closure([start_nfa], pw, pn, at_start)
            if not ids:
                starts[i] = DEAD
                continue
            key: StateKey = (ids, pw if self.needs_prev else False,
                             pn if self.needs_prev else False, at_start)
            starts[i] = self._intern(key)

        C = self.bc.num_classes
        delta_rows: List[np.ndarray] = []
        match_rows: List[np.ndarray] = []
        eoi_rows: List[np.ndarray] = []
        i = 0
        while i < len(self.sets):
            key = self.sets[i]
            drow = np.zeros(C, dtype=np.int32)
            mrow = np.zeros(C, dtype=bool)
            erow = np.zeros(4, dtype=bool)
            if key[0]:  # non-dead
                for c in range(C):
                    nxt, m = self.transition(key, c)
                    drow[c] = nxt
                    mrow[c] = m
                for ctx in range(4):
                    _, erow[ctx] = self.transition(key, None, eoi_ctx=ctx)
            delta_rows.append(drow)
            match_rows.append(mrow)
            eoi_rows.append(erow)
            i += 1

        return DenseDFA(
            delta=np.stack(delta_rows),
            match_on=np.stack(match_rows),
            match_eoi=np.stack(eoi_rows),
            starts=starts,
            classes=self.bc.classes.astype(np.int32),
            anchored=self.anchored,
            break_at_match=self.break_at_match,
            pattern=self.nfa.pattern,
            num_nfa_states=len(self.nfa),
        )


class _EmptyTrackingDeterminizer(_Determinizer):
    """Subset construction that additionally classifies every match flag as
    EMPTY (the accepting thread is the fresh pattern start spawned at the
    current position via the unanchored `(?s:.)*?` loop) or non-empty.

    The extension that makes the nullable count transducer possible
    (dfa/countdfa.py:build_count_dfa_nullable): Go's FindAll empty-match
    rules key on whether the committed match was empty (regex.go
    allMatches: `matches[1] == matches[0]` advance/skip), which in DFA
    terms is a property of which *thread* accepted, not of the state —
    so thread provenance ("fresh at this position") is tracked in the
    state identity.  State keys grow a parallel freshness tuple; first
    -reached-wins dedup keeps the classification aligned with thread
    priority (an accept reachable both ways counts as the older, non-empty
    thread — leftmost-first prefers the earlier start)."""

    # state key: (ids, fresh, prev_word, prev_nl, at_start)

    def closure(self, roots, prev_word, prev_nl, at_start,
                roots_fresh=None):
        out: List[int] = []
        out_fresh: List[bool] = []
        emitted = set()
        visited = set()
        L = self.nfa.start_unanchored
        if roots_fresh is None:
            roots_fresh = [False] * len(roots)
        stack = list(reversed([(r, f) for r, f in zip(roots, roots_fresh)]))
        while stack:
            sid, fresh = stack.pop()
            if sid in visited:
                continue
            visited.add(sid)
            st = self.states[sid]
            k = st[0]
            if k == Kind.RANGE or k == Kind.MATCH:
                if sid not in emitted:
                    emitted.add(sid)
                    out.append(sid)
                    out_fresh.append(fresh)
            elif k == Kind.SPLIT:
                if sid == L:
                    # unanchored loop: first branch = pattern start at the
                    # CURRENT position (fresh), the rest = keep scanning
                    tgts = st[1:]
                    frames = [(tgts[0], True)] + [(t, fresh)
                                                  for t in tgts[1:]]
                    for t, f in reversed(frames):
                        stack.append((t, f))
                else:
                    for t in reversed(st[1:]):
                        stack.append((t, fresh))
            elif k == Kind.CAPTURE:
                stack.append((st[2], fresh))
            elif k == Kind.LOOK:
                look = st[1]
                if look == Look.BEGIN_TEXT:
                    if at_start:
                        stack.append((st[2], fresh))
                elif look == Look.BEGIN_LINE:
                    if at_start or prev_nl:
                        stack.append((st[2], fresh))
                else:
                    if sid not in emitted:
                        emitted.add(sid)
                        out.append(sid)
                        out_fresh.append(fresh)
        return tuple(out), tuple(out_fresh)

    def transition(self, key, c, eoi_ctx=CTX_SOT):
        """Returns (next_state_id, is_match, match_is_empty)."""
        ids, fresh, prev_word, prev_nl, at_start = key
        if c is None:
            at_eoi = eoi_ctx == CTX_SOT
            next_word = eoi_ctx == CTX_WORD
            next_nl = eoi_ctx == CTX_NL
        else:
            at_eoi = False
            next_word = bool(self.cls_word[c])
            next_nl = bool(self.cls_nl[c])
        at_edge = c is None

        resolved: List[int] = []
        resolved_fresh: List[bool] = []
        emitted: set = set()
        visited: set = set()
        is_match = False
        is_empty = False
        for sid, fr in zip(ids, fresh):
            if is_match and self.break_at_match:
                break
            st = self.states[sid]
            k = st[0]
            if k == Kind.MATCH:
                if not is_match:
                    is_match = True
                    is_empty = fr
            elif k == Kind.RANGE:
                if sid not in emitted:
                    emitted.add(sid)
                    resolved.append(sid)
                    resolved_fresh.append(fr)
            elif k == Kind.LOOK:
                look = st[1]
                ok = False
                if look == Look.END_TEXT:
                    ok = at_eoi
                elif look == Look.END_LINE:
                    ok = at_eoi or next_nl
                elif look == Look.WORD_BOUNDARY:
                    ok = prev_word != next_word
                elif look == Look.NO_WORD_BOUNDARY:
                    ok = prev_word == next_word
                if ok:
                    before = len(resolved)
                    self.closure_full([st[2]], prev_word, prev_nl, at_start,
                                      next_word, next_nl, at_eoi,
                                      resolved, emitted, visited)
                    kept: List[int] = []
                    for rid in resolved[before:]:
                        if is_match and self.break_at_match:
                            break
                        if self.states[rid][0] == Kind.MATCH:
                            if not is_match:
                                is_match = True
                                is_empty = fr
                        else:
                            kept.append(rid)
                    del resolved[before:]
                    resolved.extend(kept)
                    resolved_fresh.extend([fr] * (len(resolved) - before))
        if at_edge:
            return DEAD, is_match, is_empty

        targets: List[int] = []
        targets_fresh: List[bool] = []
        b = self._rep(c)
        for sid, fr in zip(resolved, resolved_fresh):
            st = self.states[sid]
            lo, hi = st[1], st[2]
            if lo <= b <= hi:
                targets.append(st[3])
                targets_fresh.append(False)  # consumed a byte: not fresh
        new_ids, new_fresh = self.closure(targets, next_word, next_nl,
                                          False, targets_fresh)
        if not new_ids:
            return DEAD, is_match, is_empty
        new_key = (new_ids, new_fresh,
                   next_word if self.needs_prev else False,
                   next_nl if self.needs_prev else False,
                   False)
        return self._intern(new_key), is_match, is_empty

    def run(self) -> DenseDFA:
        start_nfa = (self.nfa.start_anchored if self.anchored
                     else self.nfa.start_unanchored)
        # re-seed interning with the 5-tuple dead key
        self.key_to_id = {}
        self.sets = []
        dead_key = ((), (), False, False, False)
        self.key_to_id[dead_key] = DEAD
        self.sets.append(dead_key)

        ctxs = [
            (False, False, True),
            (True, False, False),
            (False, True, False),
            (False, False, False),
        ]
        starts = np.zeros(4, dtype=np.int32)
        for i, (pw, pn, at_start) in enumerate(ctxs):
            # the whole start closure is a fresh search at this position
            ids, fr = self.closure([start_nfa], pw, pn, at_start,
                                   roots_fresh=[True])
            if not ids:
                starts[i] = DEAD
                continue
            key = (ids, fr, pw if self.needs_prev else False,
                   pn if self.needs_prev else False, at_start)
            starts[i] = self._intern(key)

        C = self.bc.num_classes
        delta_rows, match_rows, eoi_rows = [], [], []
        empty_rows, eoi_empty_rows = [], []
        i = 0
        while i < len(self.sets):
            key = self.sets[i]
            drow = np.zeros(C, dtype=np.int32)
            mrow = np.zeros(C, dtype=bool)
            xrow = np.zeros(C, dtype=bool)
            erow = np.zeros(4, dtype=bool)
            exrow = np.zeros(4, dtype=bool)
            if key[0]:
                for c in range(C):
                    nxt, m, x = self.transition(key, c)
                    drow[c] = nxt
                    mrow[c] = m
                    xrow[c] = x
                for ctx in range(4):
                    _, erow[ctx], exrow[ctx] = self.transition(
                        key, None, eoi_ctx=ctx)
            delta_rows.append(drow)
            match_rows.append(mrow)
            eoi_rows.append(erow)
            empty_rows.append(xrow)
            eoi_empty_rows.append(exrow)
            i += 1

        return DenseDFA(
            delta=np.stack(delta_rows),
            match_on=np.stack(match_rows),
            match_eoi=np.stack(eoi_rows),
            starts=starts,
            classes=self.bc.classes.astype(np.int32),
            anchored=self.anchored,
            break_at_match=self.break_at_match,
            pattern=self.nfa.pattern,
            num_nfa_states=len(self.nfa),
            match_empty=np.stack(empty_rows),
            match_eoi_empty=np.stack(eoi_empty_rows),
        )


def determinize(nfa: NFA, anchored: bool = False,
                break_at_match: bool = True,
                state_limit: int = DEFAULT_STATE_LIMIT,
                byte_classes: Optional[ByteClasses] = None,
                reverse: bool = False) -> DenseDFA:
    from ..native import determinize_native
    dfa = determinize_native(nfa, anchored, break_at_match, state_limit,
                             byte_classes)
    if dfa is None:
        d = _Determinizer(nfa, anchored, break_at_match, state_limit,
                          byte_classes)
        dfa = d.run()
    dfa.reverse = reverse
    return dfa


def determinize_py(nfa: NFA, anchored: bool = False,
                   break_at_match: bool = True,
                   state_limit: int = DEFAULT_STATE_LIMIT,
                   byte_classes: Optional[ByteClasses] = None,
                   reverse: bool = False,
                   track_empty: bool = False) -> DenseDFA:
    """Pure-Python determinizer (the native module's oracle).  With
    track_empty=True the result also carries match_empty /
    match_eoi_empty flag classification (nullable count transducer)."""
    cls = _EmptyTrackingDeterminizer if track_empty else _Determinizer
    d = cls(nfa, anchored, break_at_match, state_limit, byte_classes)
    dfa = d.run()
    dfa.reverse = reverse
    return dfa
