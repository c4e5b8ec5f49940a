# Copy of coregex_tpu/nfa/nfa.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Byte-level Thompson NFA model.

Capability analogue of the reference's nfa/nfa.go (StateKind set at
nfa/nfa.go:21-60) re-expressed for array-oriented host compilation: states
are flat Python lists, transitions are byte ranges, priority is structural
(SPLIT target order / DFS order), and byte-class alphabet reduction
(nfa/alphabet.go:111-166 analogue) is computed from the range boundaries.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np


class Kind(enum.IntEnum):
    FAIL = 0
    MATCH = 1
    RANGE = 2     # [RANGE, lo, hi, next]
    SPLIT = 3     # [SPLIT, t0, t1, ...]  (priority = order)
    LOOK = 4      # [LOOK, lookkind, next]
    CAPTURE = 5   # [CAPTURE, slot, next]


class Look(enum.IntEnum):
    BEGIN_TEXT = 0   # \A
    END_TEXT = 1     # \z
    BEGIN_LINE = 2   # (?m:^): at 0 or after \n
    END_LINE = 3     # (?m:$): at EOI or before \n
    WORD_BOUNDARY = 4
    NO_WORD_BOUNDARY = 5


def is_word_byte(b: int) -> bool:
    return (48 <= b <= 57) or (65 <= b <= 90) or b == 95 or (97 <= b <= 122)


WORD_BYTES = np.zeros(256, dtype=bool)
for _b in range(256):
    WORD_BYTES[_b] = is_word_byte(_b)


class NFA:
    """A compiled byte-NFA with anchored and unanchored start states."""

    def __init__(self):
        self.states: List[list] = []
        self.start_anchored: int = -1
        self.start_unanchored: int = -1
        self.num_slots: int = 0          # capture slots (2 per group incl. 0)
        self.group_names: List[Optional[str]] = []
        self.pattern: str = ""

    # -- construction ---------------------------------------------------
    def add(self, state: list) -> int:
        self.states.append(state)
        return len(self.states) - 1

    def add_fail(self) -> int:
        return self.add([Kind.FAIL])

    def add_match(self) -> int:
        return self.add([Kind.MATCH])

    def add_range(self, lo: int, hi: int, nxt: int = -1) -> int:
        return self.add([Kind.RANGE, lo, hi, nxt])

    def add_split(self, targets: Optional[List[int]] = None) -> int:
        return self.add([Kind.SPLIT] + list(targets or []))

    def add_look(self, look: Look, nxt: int = -1) -> int:
        return self.add([Kind.LOOK, int(look), nxt])

    def add_capture(self, slot: int, nxt: int = -1) -> int:
        return self.add([Kind.CAPTURE, slot, nxt])

    def patch(self, sid: int, idx: int, target: int) -> None:
        self.states[sid][idx] = target

    # -- introspection --------------------------------------------------
    def __len__(self) -> int:
        return len(self.states)

    def kind(self, sid: int) -> Kind:
        return Kind(self.states[sid][0])

    def byte_ranges(self) -> List[Tuple[int, int]]:
        out = []
        for st in self.states:
            if st[0] == Kind.RANGE:
                out.append((st[1], st[2]))
        return out

    def has_look(self, *looks: Look) -> bool:
        want = {int(l) for l in looks}
        return any(st[0] == Kind.LOOK and st[1] in want for st in self.states)

    def any_look(self) -> bool:
        return any(st[0] == Kind.LOOK for st in self.states)

    def byte_classes(self) -> "ByteClasses":
        return ByteClasses.from_ranges(self.byte_ranges(),
                                       needs_word=self.has_look(
                                           Look.WORD_BOUNDARY,
                                           Look.NO_WORD_BOUNDARY),
                                       needs_nl=self.has_look(
                                           Look.BEGIN_LINE, Look.END_LINE))


class ByteClasses:
    """Alphabet reduction: byte -> equivalence class id.

    Two bytes are equivalent iff no NFA byte range (nor a look assertion's
    word/newline distinction) separates them.  Mirrors the purpose of the
    reference's ByteClasses (nfa/alphabet.go) — the dense DFA's columns.
    """

    def __init__(self, classes: np.ndarray):
        assert classes.shape == (256,)
        self.classes = classes.astype(np.int32)
        self.num_classes = int(classes.max()) + 1 if len(classes) else 1

    @classmethod
    def from_ranges(cls, ranges, needs_word=False, needs_nl=False
                    ) -> "ByteClasses":
        # boundary bitset: a boundary at b means b starts a new segment
        boundary = np.zeros(257, dtype=bool)
        boundary[0] = True
        for lo, hi in ranges:
            boundary[lo] = True
            boundary[hi + 1] = True
        if needs_nl:
            boundary[10] = True
            boundary[11] = True
        if needs_word:
            for b in range(257):
                if b < 256 and (b == 0 or WORD_BYTES[b] != WORD_BYTES[b - 1]):
                    boundary[b] = True
        seg = np.cumsum(boundary[:256]) - 1
        # merge equivalent segments: two segments are equivalent iff every
        # range covers both or neither, and word/nl flags agree.
        sig = {}
        classes = np.zeros(256, dtype=np.int32)
        seg_ids = {}
        for b in range(256):
            s = int(seg[b])
            if s not in seg_ids:
                key = tuple(lo <= b <= hi for lo, hi in ranges)
                if needs_word:
                    key = key + (bool(WORD_BYTES[b]),)
                if needs_nl:
                    key = key + (b == 10,)
                if key not in sig:
                    sig[key] = len(sig)
                seg_ids[s] = sig[key]
            classes[b] = seg_ids[s]
        return cls(classes)

    @classmethod
    def singletons(cls) -> "ByteClasses":
        return cls(np.arange(256, dtype=np.int32))

    def __getitem__(self, b: int) -> int:
        return int(self.classes[b])

    def map_bytes(self, data: np.ndarray) -> np.ndarray:
        return self.classes[data]
