# Copy of coregex_tpu/engines/pikevm.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""PikeVM: Thompson NFA simulation with capture slots.

The universal correctness backstop (reference analogue: nfa/pikevm.go —
thread queues, DFS-priority leftmost-first, Longest/POSIX mode, capture
slots).  This host implementation is the semantics oracle for every TPU
kernel and the fallback when determinization overflows; it is also used for
phase-2 capture extraction inside spans found by the DFA phases (the
two-phase submatch design of meta/findall.go:49-128).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..nfa.nfa import NFA, Kind, Look, is_word_byte

Slots = Tuple[int, ...]


class PikeVM:
    def __init__(self, nfa: NFA):
        self.nfa = nfa
        self.states = nfa.states
        self.num_slots = nfa.num_slots
        self._fb_table: Optional[bytes] = None

    def set_first_bytes(self, first: "set[int]") -> None:
        """Enable skip-ahead over bytes that cannot start a match (the
        prefilter SkipAhead wiring of the reference's PikeVM,
        nfa/pikevm.go:85-96, backed by the FirstByteSet analogue in
        meta/literal.py:first_bytes).  `first` must be a complete
        (over-approximate) set of possible match-start bytes."""
        self._fb_table = bytes(1 if b in first else 0 for b in range(256))

    # -- look evaluation -------------------------------------------------
    @staticmethod
    def _look_ok(look: int, text: bytes, pos: int) -> bool:
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
        return prev_w == next_w  # NO_WORD_BOUNDARY

    # -- thread add (epsilon closure at a position) -----------------------
    def _add(self, queue: List[Tuple[int, Slots]], on_queue: set,
             sid: int, slots: Slots, text: bytes, pos: int) -> None:
        stack: List[Tuple[int, Slots]] = [(sid, slots)]
        states = self.states
        while stack:
            sid, slots = stack.pop()
            if sid in on_queue:
                continue
            on_queue.add(sid)
            st = states[sid]
            k = st[0]
            if k == Kind.SPLIT:
                # push reversed so first target is processed first; use a
                # sentinel frame per target to preserve slot values
                for t in reversed(st[1:]):
                    if t not in on_queue:
                        stack.append((t, slots))
            elif k == Kind.CAPTURE:
                slot = st[1]
                if slot < self.num_slots:
                    new = list(slots)
                    new[slot] = pos
                    slots = tuple(new)
                if st[2] not in on_queue:
                    stack.append((st[2], slots))
            elif k == Kind.LOOK:
                if self._look_ok(st[1], text, pos) and st[2] not in on_queue:
                    stack.append((st[2], slots))
            elif k == Kind.RANGE or k == Kind.MATCH:
                queue.append((sid, slots))
            # FAIL: drop

    # NOTE on priority: the explicit stack above visits SPLIT targets in
    # DFS order but *interleaves* siblings' subtrees LIFO; to keep strict
    # DFS priority we must push each target as its own frame and process
    # to completion before the next.  A LIFO stack where we push targets in
    # reverse achieves exactly DFS pre-order, because each popped frame
    # expands before its right siblings are popped.

    # -- main search -------------------------------------------------------
    def search(self, text: bytes, start: int = 0,
               anchored: bool = False, longest: bool = False,
               end: Optional[int] = None) -> Optional[Slots]:
        """Leftmost search from `start`; returns capture slots (slot 0/1 =
        overall span) or None.  `longest` selects POSIX leftmost-longest."""
        n = len(text) if end is None else end
        nfa = self.nfa
        start_sid = nfa.start_anchored
        init_slots = tuple([-1] * self.num_slots)

        curr: List[Tuple[int, Slots]] = []
        nxt: List[Tuple[int, Slots]] = []
        matched: Optional[Slots] = None
        states = self.states

        pos = start
        fb_mask: Optional[bytes] = None
        while True:
            on_q: set = set()
            if curr:
                pass
            # seed a new thread for unanchored search (lowest priority)
            if matched is None and (pos == start or not anchored):
                # build into a fresh queue preserving existing priority
                seed_q: List[Tuple[int, Slots]] = []
                seed_on: set = set(t[0] for t in curr)
                self._add(seed_q, seed_on, start_sid, init_slots, text, pos)
                curr.extend(seed_q)

            next_on: set = set()
            nxt = []
            for idx, (sid, slots) in enumerate(curr):
                st = states[sid]
                if st[0] == Kind.MATCH:
                    if longest:
                        if (matched is None or slots[0] < matched[0] or
                                (slots[0] == matched[0]
                                 and slots[1] > matched[1])):
                            matched = slots
                        continue  # keep lower-priority threads in longest
                    matched = slots
                    break  # leftmost-first: prune lower priority
                else:  # RANGE
                    if pos < n and st[1] <= text[pos] <= st[2]:
                        self._add(nxt, next_on, st[3], slots, text, pos + 1)
            if pos >= n:
                break
            curr = nxt
            pos += 1
            if not curr and (matched is not None or anchored):
                break
            if not curr and matched is None and not anchored \
                    and self._fb_table is not None:
                # no live threads: memchr-style skip to the next byte that
                # can start a match (C-speed translate + find)
                if fb_mask is None:
                    fb_mask = text.translate(self._fb_table)
                hit = fb_mask.find(1, pos, n)
                pos = n if hit < 0 else hit
        return matched

    # convenience: span only
    def find(self, text: bytes, start: int = 0, anchored: bool = False,
             longest: bool = False) -> Optional[Tuple[int, int]]:
        m = self.search(text, start, anchored, longest)
        if m is None:
            return None
        return (m[0], m[1])

    def is_match(self, text: bytes, start: int = 0,
                 anchored: bool = False, longest: bool = False) -> bool:
        return self.search(text, start, anchored, longest) is not None


class StreamPikeVM:
    """Incremental PikeVM over a byte stream: constant memory in stream
    length (state = thread queues bounded by NFA size + one carried byte),
    the true-streaming engine behind Go's MatchReader family
    (regex.go:1619-1667, which likewise feeds its NFA machine one rune at
    a time without buffering).  Look-around is evaluated from the carried
    previous byte and the current byte, so chunk boundaries are
    invisible.

    Protocol: feed(chunk) per chunk, then finish(); each returns the
    match slots once the leftmost match is decided (early — reading can
    stop), or None while undecided.  `done` is True once further input
    cannot change the answer."""

    def __init__(self, vm: PikeVM, longest: bool = False):
        self.vm = vm
        self.longest = longest
        self.states = vm.states
        self.num_slots = vm.num_slots
        self._init_slots = tuple([-1] * self.num_slots)
        # threads awaiting epsilon closure at stream position self.pos
        self._pending: List[Tuple[int, Slots]] = \
            [(vm.nfa.start_anchored, self._init_slots)]
        self.pos = 0
        self.prev_byte: Optional[int] = None  # None == start of text
        self.matched: Optional[Slots] = None
        self.done = False

    # look evaluation from carried context (no text slice)
    def _look_ok(self, look: int, cur: Optional[int]) -> bool:
        prev = self.prev_byte
        if look == Look.BEGIN_TEXT:
            return prev is None
        if look == Look.END_TEXT:
            return cur is None
        if look == Look.BEGIN_LINE:
            return prev is None or prev == 10
        if look == Look.END_LINE:
            return cur is None or cur == 10
        prev_w = prev is not None and is_word_byte(prev)
        next_w = cur is not None and is_word_byte(cur)
        if look == Look.WORD_BOUNDARY:
            return prev_w != next_w
        return prev_w == next_w  # NO_WORD_BOUNDARY

    def _add(self, queue: List[Tuple[int, Slots]], on_queue: set,
             sid: int, slots: Slots, cur: Optional[int]) -> None:
        stack: List[Tuple[int, Slots]] = [(sid, slots)]
        states = self.states
        while stack:
            sid, slots = stack.pop()
            if sid in on_queue:
                continue
            on_queue.add(sid)
            st = states[sid]
            k = st[0]
            if k == Kind.SPLIT:
                for t in reversed(st[1:]):
                    if t not in on_queue:
                        stack.append((t, slots))
            elif k == Kind.CAPTURE:
                slot = st[1]
                if slot < self.num_slots:
                    new = list(slots)
                    new[slot] = self.pos
                    slots = tuple(new)
                if st[2] not in on_queue:
                    stack.append((st[2], slots))
            elif k == Kind.LOOK:
                if self._look_ok(st[1], cur) and st[2] not in on_queue:
                    stack.append((st[2], slots))
            elif k == Kind.RANGE or k == Kind.MATCH:
                queue.append((sid, slots))

    def _step(self, cur: Optional[int]) -> None:
        """Close pending threads at self.pos (seeing byte `cur`, None at
        EOT), process matches, and consume `cur`."""
        curr: List[Tuple[int, Slots]] = []
        on_q: set = set()
        for sid, slots in self._pending:
            self._add(curr, on_q, sid, slots, cur)
        if self.matched is None:
            # unanchored restart seed at lowest priority
            self._add(curr, on_q, self.vm.nfa.start_anchored,
                      self._init_slots, cur)
        nxt: List[Tuple[int, Slots]] = []
        states = self.states
        for sid, slots in curr:
            st = states[sid]
            if st[0] == Kind.MATCH:
                if self.longest:
                    m = self.matched
                    if (m is None or slots[0] < m[0]
                            or (slots[0] == m[0] and slots[1] > m[1])):
                        self.matched = slots
                    continue
                self.matched = slots
                break  # leftmost-first: prune lower priority
            if cur is not None and st[1] <= cur <= st[2]:
                nxt.append((st[3], slots))
        self._pending = nxt
        if cur is None:
            self.done = True
        else:
            self.prev_byte = cur
            self.pos += 1
            if self.matched is not None and not nxt and not self.longest:
                self.done = True

    def feed(self, chunk: bytes) -> Optional[Slots]:
        """Consume a chunk; returns the decided match early when further
        input cannot change it (caller may stop reading)."""
        if self.done:
            return self.matched
        fb = self.vm._fb_table
        i, n = 0, len(chunk)
        fb_mask = None
        while i < n:
            if (fb is not None and not self._pending
                    and self.matched is None and i < n):
                # no live threads: skip to the next possible start byte
                # (same prefilter skip-ahead as PikeVM.search)
                if fb_mask is None:
                    fb_mask = chunk.translate(fb)
                hit = fb_mask.find(1, i, n)
                if hit < 0:
                    self.pos += n - i
                    self.prev_byte = chunk[-1]
                    return None
                if hit > i:
                    self.pos += hit - i
                    self.prev_byte = chunk[hit - 1]
                    i = hit
            self._step(chunk[i])
            i += 1
            if self.done:
                break
        return self.matched if self.done else None

    def finish(self) -> Optional[Slots]:
        """Signal end of stream; returns the final match slots or None."""
        if not self.done:
            self._step(None)
            self.done = True
        return self.matched
