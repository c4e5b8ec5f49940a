# Copy of coregex_tpu/dfa/onepass.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""OnePass capture DFA.

Capability analogue of the reference's dfa/onepass (onepass.go:33-93,
builder.go:161-360): for patterns whose anchored NFA admits at most one
successful path per input, capture extraction becomes a single
deterministic table walk — each transition carries a slot mask ("set these
capture slots to the current position").  Construction rejects ambiguity
(overlapping byte ranges in one closure) with NotOnePass, and the engine
falls back to the PikeVM (meta/findall.go:63-74 dispatch analogue).

Tables are dense [S, C] like the match DFA, so capture extraction can be
batched across spans on device (round-2 kernel); the host `apply` below is
the reference implementation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..nfa.nfa import NFA, ByteClasses, Kind, Look

MAX_SLOTS = 32


class NotOnePass(Exception):
    pass


@dataclass
class OnePassDFA:
    delta: np.ndarray        # [S, C] int32, -1 == no transition
    slotmask: np.ndarray     # [S, C] uint32: slots set to pos on transition
    match_cond: np.ndarray   # [S] bool: match available in this state
    match_slots: np.ndarray  # [S] uint32: slots set to pos at match
    classes: np.ndarray      # [256] int32
    start: int
    num_slots: int

    def apply(self, data: np.ndarray, start: int, end: int
              ) -> Optional[List[int]]:
        """Extract capture slots for the match spanning [start, end)."""
        slots = [-1] * self.num_slots
        pending: Optional[List[int]] = None
        s = self.start
        pos = start

        def set_slots(mask: int, p: int, base: List[int]) -> List[int]:
            out = list(base)
            m = mask
            i = 0
            while m:
                if m & 1:
                    out[i] = p
                m >>= 1
                i += 1
            return out

        while True:
            if self.match_cond[s] and pos == end:
                pending = set_slots(int(self.match_slots[s]), pos, slots)
                break
            if pos >= end:
                break
            c = self.classes[data[pos]]
            nxt = int(self.delta[s, c])
            if nxt < 0:
                break
            slots = set_slots(int(self.slotmask[s, c]), pos, slots)
            s = nxt
            pos += 1
        return pending


def build_onepass(nfa: NFA, byte_classes: Optional[ByteClasses] = None
                  ) -> OnePassDFA:
    """Build or raise NotOnePass.  Requires a captures NFA; look assertions
    other than a leading BEGIN_TEXT are rejected (PikeVM handles those)."""
    if nfa.num_slots > MAX_SLOTS:
        raise NotOnePass("too many capture slots")
    bc = byte_classes or nfa.byte_classes()
    C = bc.num_classes
    states = nfa.states

    # map: NFA range-state id (a "node") -> dense id
    node_ids: Dict[int, int] = {}
    order: List[int] = []

    def intern(nid: int) -> int:
        if nid not in node_ids:
            node_ids[nid] = len(order)
            order.append(nid)
        return node_ids[nid]

    # virtual start node id -1 maps to dense 0 via special handling
    START = -1
    intern(START)

    rows_delta: Dict[int, np.ndarray] = {}
    rows_mask: Dict[int, np.ndarray] = {}
    match_cond: Dict[int, bool] = {}
    match_slots: Dict[int, int] = {}

    def explore(dense_id: int, nid: int) -> None:
        """Walk the epsilon closure from node's successor; collect per-class
        transitions + match condition.  Priority cut at MATCH."""
        drow = np.full(C, -1, dtype=np.int64)
        mrow = np.zeros(C, dtype=np.uint32)
        mcond = False
        mslots = 0
        claimed = np.zeros(C, dtype=bool)

        roots: List[Tuple[int, int]]
        if nid == START:
            roots = [(nfa.start_anchored, 0)]
        else:
            roots = [(states[nid][3], 0)]

        stack = list(reversed(roots))
        # visited maps state -> slot mask it was first reached with: a
        # second epsilon path reaching the same state with a DIFFERENT
        # mask makes capture assignment ambiguous and the pattern not
        # one-pass (reference builder.go:161-360 rejects this; keying on
        # the state alone would silently keep the first path's slots)
        visited: Dict[int, int] = {}
        stop = False
        while stack and not stop:
            v, mask = stack.pop()
            if v in visited:
                if visited[v] != mask:
                    raise NotOnePass("ambiguous epsilon paths")
                continue
            visited[v] = mask
            st = states[v]
            k = st[0]
            if k == Kind.MATCH:
                mcond = True
                mslots = mask
                stop = True  # leftmost-first: prune lower priority
            elif k == Kind.RANGE:
                lo, hi = st[1], st[2]
                tgt = intern(v)
                for c in range(C):
                    b = _rep(bc, c)
                    if lo <= b <= hi:
                        if claimed[c]:
                            raise NotOnePass("ambiguous byte transition")
                        claimed[c] = True
                        drow[c] = tgt
                        mrow[c] = mask
            elif k == Kind.SPLIT:
                for t in reversed(st[1:]):
                    stack.append((t, mask))
            elif k == Kind.CAPTURE:
                slot = st[1]
                if slot < MAX_SLOTS:
                    mask = mask | (1 << slot)
                stack.append((st[2], mask))
            elif k == Kind.LOOK:
                if st[1] == Look.BEGIN_TEXT and nid == START:
                    stack.append((st[2], mask))
                else:
                    raise NotOnePass("look assertion")
            # FAIL: drop

        rows_delta[dense_id] = drow
        rows_mask[dense_id] = mrow
        match_cond[dense_id] = mcond
        match_slots[dense_id] = mslots

    i = 0
    while i < len(order):
        explore(i, order[i])
        i += 1
        if len(order) > 4096:
            raise NotOnePass("too many onepass states")

    S = len(order)
    delta = np.stack([rows_delta[i] for i in range(S)]).astype(np.int32)
    slotmask = np.stack([rows_mask[i] for i in range(S)])
    return OnePassDFA(
        delta=delta,
        slotmask=slotmask,
        match_cond=np.array([match_cond[i] for i in range(S)]),
        match_slots=np.array([match_slots[i] for i in range(S)],
                             dtype=np.uint32),
        classes=bc.classes.astype(np.int32),
        start=0,
        num_slots=nfa.num_slots,
    )


def _rep(bc: ByteClasses, c: int) -> int:
    rep = getattr(bc, "_rep_table", None)
    if rep is None:
        rep = [256] * bc.num_classes
        for b in range(255, -1, -1):
            rep[int(bc.classes[b])] = b
        bc._rep_table = rep
    return rep[c]
