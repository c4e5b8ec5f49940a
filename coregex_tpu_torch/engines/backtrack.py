# Copy of coregex_tpu/engines/backtrack.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Bounded backtracker.

Capability analogue of the reference's BoundedBacktracker
(nfa/backtrack.go:19): explicit-stack DFS over the NFA with a visited
bitmap of (state, position) pairs, capacity-gated so memory stays bounded
(CanHandle, backtrack.go:78-143 analogue).  Leftmost-first only (DFS order
IS the priority order); the meta engine uses it for small haystacks where
its constant factors beat the PikeVM, falling back to the PikeVM when the
visited table would exceed the budget.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..nfa.nfa import NFA, Kind, Look, is_word_byte

MAX_VISITED_ENTRIES = 1 << 22

Slots = Tuple[int, ...]


class BoundedBacktracker:
    def __init__(self, nfa: NFA):
        self.nfa = nfa
        self.states = nfa.states
        self.num_slots = nfa.num_slots

    def can_handle(self, text_len: int) -> bool:
        return len(self.states) * (text_len + 1) <= MAX_VISITED_ENTRIES

    def _look_ok(self, look: int, text: bytes, pos: int) -> bool:
        n = len(text)
        if look == Look.BEGIN_TEXT:
            return pos == 0
        if look == Look.END_TEXT:
            return pos == n
        if look == Look.BEGIN_LINE:
            return pos == 0 or text[pos - 1] == 10
        if look == Look.END_LINE:
            return pos == n or text[pos] == 10
        prev_w = pos > 0 and is_word_byte(text[pos - 1])
        next_w = pos < n and is_word_byte(text[pos])
        if look == Look.WORD_BOUNDARY:
            return prev_w != next_w
        return prev_w == next_w

    def search(self, text: bytes, start: int = 0, anchored: bool = False,
               end: Optional[int] = None) -> Optional[Slots]:
        """Leftmost-first search; returns capture slots or None.

        `end` bounds byte consumption (span-relative visited table,
        backtrack.go:55-61 SpanStart analogue); look assertions still see
        the full text."""
        n = len(text)
        lim = n if end is None else end
        S = len(self.states)
        visited = np.zeros((S, lim - start + 2), dtype=bool)
        states = self.states
        nfa = self.nfa

        slots = [-1] * self.num_slots
        trail: List[Tuple[int, int]] = []  # (slot, old_value) undo log

        # frames: (state, pos, trail_len)
        def try_at(at: int) -> Optional[Slots]:
            stack: List[Tuple[int, int, int]] = [
                (nfa.start_anchored, at, len(trail))]
            while stack:
                sid, pos, tl = stack.pop()
                while len(trail) > tl:
                    slot, old = trail.pop()
                    slots[slot] = old
                if visited[sid, pos - start]:
                    continue
                visited[sid, pos - start] = True
                st = states[sid]
                k = st[0]
                if k == Kind.MATCH:
                    return tuple(slots)
                if k == Kind.RANGE:
                    if pos < lim and st[1] <= text[pos] <= st[2]:
                        stack.append((st[3], pos + 1, len(trail)))
                elif k == Kind.SPLIT:
                    for t in reversed(st[1:]):
                        stack.append((t, pos, len(trail)))
                elif k == Kind.CAPTURE:
                    slot = st[1]
                    if slot < self.num_slots:
                        trail.append((slot, slots[slot]))
                        slots[slot] = pos
                    stack.append((st[2], pos, len(trail)))
                elif k == Kind.LOOK:
                    if self._look_ok(st[1], text, pos):
                        stack.append((st[2], pos, len(trail)))
            return None

        if anchored:
            return try_at(start)
        for at in range(start, lim + 1):
            m = try_at(at)
            if m is not None:
                return m
        return None

    def find(self, text: bytes, start: int = 0,
             anchored: bool = False) -> Optional[Tuple[int, int]]:
        m = self.search(text, start, anchored)
        return None if m is None else (m[0], m[1])

    def is_match(self, text: bytes, start: int = 0) -> bool:
        return self.search(text, start) is not None
