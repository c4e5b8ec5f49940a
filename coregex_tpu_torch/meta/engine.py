# Copy of coregex_tpu/meta/engine.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Meta engine: compile pipeline + dispatch + the stdlib-compatible API.

Capability analogue of the reference's meta/ package (compile pipeline
meta/compile.go:440, dispatch meta/find.go, findall loop meta/findall.go)
and of the public Regexp surface (regex.go).  Numeric results are byte
offsets, like Go's regexp.

The port's copy of ``coregex_tpu/meta/engine.py``: parsing, the host
engines (DFA search, PikeVM, backtracker) and the stdlib-compatible surface
are the reference's, run from the port's own copies of the host pipeline.
What differs from the reference:

  * the engine has a torch device; ``batch_engine()`` (ref. :142-150)
    returns the torch BatchEngine on it, so corpus-scale ``count`` and
    ``find_all*`` run there;
  * ``count`` (ref. :312-337) asks the BatchEngine once: its count already
    covers nullable plans;
  * the reference's two other device call sites run on the engine's device
    too: ``_batch_captures`` (ref. :418-443) through the port's
    OnePassScanner (ops/onepass_scan.py) and the row batches (ref.
    :687-732) through its RowBatch (ops/rowscan.py); neither probes for
    jax, since the device is explicit;
  * invalid UTF-8 (ROADMAP P4; the reference's matchers stop at a valid
    lead byte that lacks its continuation bytes, F14): every matcher, on
    the host and on the device, reads the text as Go decodes it, each byte
    that starts no valid sequence one U+FFFD of width 1, which the bytes
    the matchers read hold as 0xFF (``_go``: ``utils.utf8.go_normalize``,
    through the corpus cache at batch sizes; a row of a batch on its own;
    a stream with three bytes of lookahead across each chunk seam).  Only
    positions come from that copy: every byte a call returns or copies
    into its output (matches, groups, replace_all's and split's text) is
    the caller's.  A str is valid UTF-8 and skips the pass.

The device is explicit: "cpu" runs the kernels' plain torch versions,
"cuda" runs the CUDA kernels.  Nothing picks it by probing for a GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dfa import search as dfasearch
from ..dfa.dense import DenseDFA
from ..dfa.determinize import DFAOverflow, determinize
from ..engines.pikevm import PikeVM
from ..nfa.thompson import compile_nfa
from ..syntax.parser import Parsed, parse
from ..utils.utf8 import StreamNormalizer, go_normalize, go_rune_width
from .strategy import Strategy

Bytes = Union[bytes, bytearray, memoryview, np.ndarray, str]


def _as_array(data: Bytes) -> np.ndarray:
    if isinstance(data, str):
        data = data.encode("utf-8")
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _is_pair_seq(match) -> bool:
    """True when the submatch vector uses (start, end) pair entries."""
    return any(isinstance(v, (tuple, list)) for v in match)


def _rune_width(data: np.ndarray, pos: int) -> int:
    """Width of the UTF-8 rune starting at pos (Go's empty-match advance:
    utf8.DecodeRune width, 1 for any invalid sequence)."""
    return go_rune_width(data, pos)


@dataclass
class Stats:
    """Search counters (meta/engine.go:158-183 Stats analogue), plus
    device-path timing the reference never needed (its engines are
    synchronous CPU; here a scan is a kernel launch whose wall time is
    the observable)."""
    dfa_searches: int = 0
    nfa_searches: int = 0
    prefilter_hits: int = 0
    prefilter_misses: int = 0
    kernel_scans: int = 0
    kernel_seconds: float = 0.0   # cumulative wall time inside device paths
    kernel_bytes: int = 0         # corpus bytes pushed through kernels

    @property
    def kernel_gbps(self) -> float:
        """Observed aggregate device-scan throughput."""
        return (self.kernel_bytes / self.kernel_seconds / 1e9
                if self.kernel_seconds > 0 else 0.0)

    def reset(self) -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, 0 if f != "kernel_seconds" else 0.0)


class Engine:
    """A compiled pattern (the reference's meta.Engine + Regexp facade)."""

    def __init__(self, parsed: Parsed, longest: bool = False,
                 config=None, device="cuda"):
        from . import anchored_literal
        self.device = torch.device(device)
        from .config import DEFAULT, debug
        self.config = (config or DEFAULT).validate()
        self.parsed = parsed
        self.pattern = parsed.pattern
        self.longest = longest
        self.stats = Stats()

        # NFAs: one with captures for the PikeVM, capture-free for DFAs.
        self.nfa = compile_nfa(parsed, with_captures=True)
        self.nfa_nocap = compile_nfa(parsed, with_captures=False)
        self.nfa_rev = compile_nfa(parsed, reverse=True)
        self.pikevm = PikeVM(self.nfa)
        from . import literal as _litmod
        fb = _litmod.first_bytes(parsed.ast)
        if fb is not None:
            self.pikevm.set_first_bytes(fb)

        # Dense DFAs (eager). On overflow fall back to PikeVM-only.
        self.fwd: Optional[DenseDFA] = None
        self.rev: Optional[DenseDFA] = None
        if self.config.enable_dfa:
            from ..utils.artifact_cache import load_dense, save_dense
            try:
                self.fwd = load_dense(self.pattern, f"fwd:{longest}")
                if self.fwd is None:
                    self.fwd = determinize(
                        self.nfa_nocap, anchored=False,
                        break_at_match=not longest,
                        state_limit=self.config.state_limit)
                    save_dense(self.pattern, f"fwd:{longest}", self.fwd)
                self.rev = load_dense(self.pattern, "rev")
                if self.rev is None:
                    self.rev = determinize(
                        self.nfa_rev, anchored=True,
                        break_at_match=False, reverse=True,
                        state_limit=self.config.state_limit)
                    save_dense(self.pattern, "rev", self.rev)
            except DFAOverflow:
                self.fwd = None
                self.rev = None

        # O(1) fully-anchored literal shapes (meta/anchored_literal.go)
        self._anchored_lit = (anchored_literal.detect(parsed.ast)
                              if not longest else None)

        self._batch = None  # lazy device execution plan
        self._onepass = None  # lazy OnePass capture DFA (False == rejected)
        self._bt = None  # lazy BoundedBacktracker
        self.batch_threshold = self.config.batch_threshold

        debug(1, f"compile {self.pattern!r}: nfa={len(self.nfa)} states, "
                 f"dfa={'%d states' % self.fwd.num_states if self.fwd else 'off'}, "
                 f"anchored_lit={'yes' if self._anchored_lit else 'no'}")

    # -- construction ---------------------------------------------------
    @classmethod
    def compile(cls, pattern: str, longest: bool = False,
                config=None, device="cuda", **kw) -> "Engine":
        return cls(parse(pattern), longest=longest, config=config,
                   device=device)

    # -- batch (device) plan --------------------------------------------
    def batch_engine(self):
        if self._batch is None:
            from .batch import BatchEngine
            self._batch = BatchEngine(self.parsed, self.parsed.ast,
                                      dfas_ok=self.fwd is not None,
                                      device=self.device,
                                      longest=self.longest,
                                      host_find=self._find_span_host,
                                      stats=self.stats)
        return self._batch

    @property
    def strategy(self) -> str:
        """Selected batch strategy name (Engine.Strategy() analogue)."""
        return self.batch_engine().plan.strategy.value

    @property
    def strategy_reason(self) -> str:
        return self.batch_engine().plan.reason

    def _go(self, data: Bytes, arr: np.ndarray) -> np.ndarray:
        """The bytes every matcher reads: `arr` with each byte that Go
        decodes as a width-1 RuneError set to 0xFF (`arr` itself when it
        is valid UTF-8; a str always is).  At batch sizes through the
        corpus cache, so a corpus pays the pass once."""
        if isinstance(data, str):
            return arr
        if len(arr) >= self.batch_threshold:
            from ..utils.corpus_cache import go_bytes
            return go_bytes(arr, self.device)
        return go_normalize(arr)

    def _use_batch(self, arr: np.ndarray) -> bool:
        if len(arr) < self.batch_threshold:
            return False
        return self.batch_engine().plan.strategy != Strategy.HOST

    def _timed_scan(self, arr: np.ndarray):
        """Context manager accounting a device scan in Stats (count,
        wall seconds, corpus bytes — Engine.Stats() observability)."""
        import contextlib
        import time

        @contextlib.contextmanager
        def cm():
            self.stats.kernel_scans += 1
            self.stats.kernel_bytes += len(arr)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.stats.kernel_seconds += time.perf_counter() - t0
        return cm()

    # -- core single-search primitives ----------------------------------
    def _backtracker(self):
        if self._bt is None:
            from ..engines.backtrack import BoundedBacktracker
            self._bt = BoundedBacktracker(self.nfa)
        return self._bt

    def _find_span_host(self, data: np.ndarray, pos: int
                        ) -> Optional[Tuple[int, int]]:
        if self._anchored_lit is not None:
            from . import anchored_literal
            if pos > 0:
                return None  # \A-anchored: no match past position 0
            return anchored_literal.match_span(self._anchored_lit, data)
        if self.fwd is not None and self.rev is not None and not self.longest:
            self.stats.dfa_searches += 1
            return dfasearch.find_span(self.fwd, self.rev, data, pos)
        text = bytes(data.tobytes())
        if not self.longest:
            bt = self._backtracker()
            if bt.can_handle(len(text) - pos):
                self.stats.nfa_searches += 1
                return bt.find(text, pos)
        self.stats.nfa_searches += 1
        m = self.pikevm.search(text, pos, longest=self.longest)
        return (m[0], m[1]) if m is not None else None

    def _is_match_host(self, data: np.ndarray) -> bool:
        if self.fwd is not None and not self.longest:
            self.stats.dfa_searches += 1
            return dfasearch.earliest_end(self.fwd, data, 0) >= 0
        self.stats.nfa_searches += 1
        return self.pikevm.is_match(bytes(data.tobytes()),
                                    longest=self.longest)

    # -- stdlib-compatible API ------------------------------------------
    def is_match(self, data: Bytes) -> bool:
        """Regexp.Match / MatchString (regex.go:282,295 analogue)."""
        arr = _as_array(data)
        arr = self._go(data, arr)
        if self._use_batch(arr):
            with self._timed_scan(arr):
                r = self.batch_engine().is_match(arr)
            if r is not None:
                return r
        return self._is_match_host(arr)

    # Go-style aliases
    match = is_match
    match_string = is_match

    def _find_span(self, arr: np.ndarray) -> Optional[Tuple[int, int]]:
        """Leftmost-first span: device two-pass bidirectional scan on
        corpus-scale inputs (meta/find.go:29 dispatch breadth), host
        otherwise."""
        if not self.longest and self._use_batch(arr):
            from .batch import FALLBACK
            with self._timed_scan(arr):
                m = self.batch_engine().find_first(arr)
            if m is not FALLBACK:
                return m
        return self._find_span_host(arr, 0)

    def find_index(self, data: Bytes) -> Optional[Tuple[int, int]]:
        """Regexp.FindIndex: [start, end) byte offsets or None."""
        arr = _as_array(data)
        return self._find_span(self._go(data, arr))

    def find(self, data: Bytes) -> Optional[bytes]:
        """Regexp.Find: matched bytes or None."""
        arr = _as_array(data)
        m = self._find_span(self._go(data, arr))
        if m is None:
            return None
        return arr[m[0]:m[1]].tobytes()

    def find_string(self, s: str) -> Optional[str]:
        b = self.find(s)
        return None if b is None else b.decode("utf-8", errors="surrogateescape")

    # -- find-all (Go allMatches semantics, regexp.go) -------------------
    def _all_spans(self, arr: np.ndarray, limit: int = -1
                   ) -> List[Tuple[int, int]]:
        if self._use_batch(arr):
            with self._timed_scan(arr):
                spans = self.batch_engine().find_all_spans(arr, limit)
            if spans is not None:
                return [(int(s), int(e)) for s, e in spans]
        n = len(arr)
        out: List[Tuple[int, int]] = []
        pos = 0
        prev_end = -1
        while pos <= n and (limit < 0 or len(out) < limit):
            m = self._find_span_host(arr, pos)
            if m is None:
                break
            s, e = m
            accept = True
            if e == pos:
                # empty match at the current search position
                if s == prev_end:
                    accept = False
                pos += _rune_width(arr, pos)
            else:
                pos = e
            prev_end = e
            if accept:
                out.append((s, e))
        return out

    def find_all_index(self, data: Bytes, n: int = -1
                       ) -> Optional[List[Tuple[int, int]]]:
        arr = _as_array(data)
        out = self._all_spans(self._go(data, arr), n)
        return out or None

    def find_all(self, data: Bytes, n: int = -1) -> Optional[List[bytes]]:
        arr = _as_array(data)
        spans = self._all_spans(self._go(data, arr), n)
        if not spans:
            return None
        return [arr[s:e].tobytes() for s, e in spans]

    def find_all_string(self, s: str, n: int = -1) -> Optional[List[str]]:
        res = self.find_all(s, n)
        if res is None:
            return None
        return [b.decode("utf-8", errors="surrogateescape") for b in res]

    def count(self, data: Bytes) -> int:
        """Number of non-overlapping matches (meta/findall.go:297 Count).
        The BatchEngine's count serves nullable plans itself (through the
        nullable transducer), so the reference's second nullable_count
        attempt after a decline would only repeat it."""
        arr = _as_array(data)
        arr = self._go(data, arr)
        if len(arr) >= self.batch_threshold:
            be = self.batch_engine()
            if be.plan.strategy != Strategy.HOST or (
                    be.plan.nullable and not self.longest):
                with self._timed_scan(arr):
                    c = be.count(arr)
                if c is not None:
                    return c
        return len(self._all_spans(arr))

    def finditer(self, data: Bytes) -> Iterator[Tuple[int, int]]:
        """Iterator over spans (regex.go:1485 AllIndex analogue)."""
        arr = _as_array(data)
        yield from self._all_spans(self._go(data, arr))

    # -- captures --------------------------------------------------------
    @property
    def num_subexp(self) -> int:
        return self.parsed.num_captures

    def subexp_names(self) -> List[str]:
        return self.parsed.subexp_names()

    def _onepass_dfa(self):
        """Lazy OnePass capture DFA (dfa/onepass analogue); False if the
        pattern is not one-pass."""
        if self._onepass is None:
            from ..dfa.onepass import NotOnePass, build_onepass
            try:
                self._onepass = build_onepass(self.nfa)
            except NotOnePass:
                self._onepass = False
        return self._onepass

    def _captures_in_span(self, arr: np.ndarray, text: bytes,
                          span: Tuple[int, int]):
        """Phase-2 capture extraction: OnePass table walk when the pattern
        is one-pass, PikeVM otherwise (meta/findall.go:63-74 dispatch)."""
        if not self.longest:
            op = self._onepass_dfa()
            if op:
                slots = op.apply(arr, span[0], span[1])
                if slots is not None:
                    return tuple(slots)
            bt = self._backtracker()
            if bt.can_handle(span[1] - span[0] + 1):
                m = bt.search(text, span[0], anchored=True, end=span[1])
                if m is not None:
                    return m
        return self.pikevm.search(text, span[0], anchored=True,
                                  longest=self.longest)

    def _submatch_at(self, arr: np.ndarray, pos: int
                     ) -> Optional[List[Optional[Tuple[int, int]]]]:
        """Two-phase submatch (meta/findall.go:49-128 analogue): phase 1
        span via DFA, phase 2 capture extraction in the span."""
        span = self._find_span_host(arr, pos)
        if span is None:
            return None
        text = bytes(arr.tobytes())
        m = self._captures_in_span(arr, text, span)
        if m is None:  # should not happen; trust the PikeVM
            m = self.pikevm.search(text, pos, longest=self.longest)
            if m is None:
                return None
        groups: List[Optional[Tuple[int, int]]] = []
        for i in range(0, len(m), 2):
            s, e = m[i], m[i + 1]
            groups.append(None if s < 0 or e < 0 else (s, e))
        return groups

    def find_submatch_index(self, data: Bytes
                            ) -> Optional[List[Optional[Tuple[int, int]]]]:
        arr = _as_array(data)
        return self._submatch_at(self._go(data, arr), 0)

    def find_submatch(self, data: Bytes) -> Optional[List[Optional[bytes]]]:
        arr = _as_array(data)
        g = self._submatch_at(self._go(data, arr), 0)
        if g is None:
            return None
        return [None if sp is None else arr[sp[0]:sp[1]].tobytes()
                for sp in g]

    def find_string_submatch(self, s: str) -> Optional[List[Optional[str]]]:
        res = self.find_submatch(s)
        if res is None:
            return None
        return [None if b is None else
                b.decode("utf-8", errors="surrogateescape") for b in res]

    def _batch_captures(self, arr: np.ndarray, spans):
        """Device OnePass capture extraction over many spans at once
        (dfa/onepass/onepass.go:33-93 batched); returns a list aligned
        with spans of flat slot tuples or None (host re-extracts)."""
        out = [None] * len(spans)
        if self.longest or len(spans) < 64:
            return out
        op = self._onepass_dfa()
        if not op:
            return out
        from ..ops.onepass_scan import OnePassScanner
        from ..utils.corpus_cache import device_corpus
        if getattr(self, "_onepass_sc", None) is None:
            self._onepass_sc = OnePassScanner(op, self.device)
        dev = device_corpus(arr, self.device)
        sp = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
        slots, ok = self._onepass_sc.extract(dev, sp)
        self.stats.kernel_scans += 1
        for i, row in enumerate(slots.tolist()):
            if ok[i]:
                out[i] = tuple(row)
        return out

    def find_all_submatch_index(self, data: Bytes, n: int = -1):
        arr = _as_array(data)
        arr = self._go(data, arr)
        spans = self._all_spans(arr, n)
        if not spans:
            return None
        text = bytes(arr.tobytes())
        batched = self._batch_captures(arr, spans)
        out = []
        for (s, e), m in zip(spans, batched):
            if m is None:
                m = self._captures_in_span(arr, text, (s, e))
            groups = []
            if m is not None:
                for i in range(0, len(m), 2):
                    a, b = m[i], m[i + 1]
                    groups.append(None if a < 0 or b < 0 else (a, b))
            out.append(groups)
        return out

    def find_all_submatch(self, data: Bytes, n: int = -1):
        arr = _as_array(data)
        idx = self.find_all_submatch_index(data, n)
        if idx is None:
            return None
        return [[None if sp is None else arr[sp[0]:sp[1]].tobytes()
                 for sp in groups] for groups in idx]

    # -- replace / split / expand ---------------------------------------
    def replace_all(self, data: Bytes, repl: Bytes) -> bytes:
        """ReplaceAll with $1 / ${name} expansion (regex.go:951 Expand)."""
        arr = _as_array(data)
        if isinstance(repl, str):
            repl_b = repl.encode("utf-8")
        else:
            repl_b = bytes(repl)
        out = bytearray()
        last = 0
        g = self._go(data, arr)
        spans = self._all_spans(g, -1)
        text = bytes(arr.tobytes())
        # $-free templates never read groups: skip capture extraction
        need_caps = b"$" in repl_b
        batched = self._batch_captures(g, spans) if need_caps \
            else [()] * len(spans)
        gtext = text if g is arr else bytes(g.tobytes())
        for (s, e), m in zip(spans, batched):
            out += text[last:s]
            if need_caps and m is None:
                m = self._captures_in_span(g, gtext, (s, e))
            out += self._expand(repl_b, text, m)
            last = e
        out += text[last:]
        return bytes(out)

    def replace_all_string(self, s: str, repl: str) -> str:
        return self.replace_all(s, repl).decode("utf-8",
                                                errors="surrogateescape")

    def replace_all_literal(self, data: Bytes, repl: Bytes) -> bytes:
        arr = _as_array(data)
        repl_b = repl.encode("utf-8") if isinstance(repl, str) else bytes(repl)
        out = bytearray()
        last = 0
        text = bytes(arr.tobytes())
        for s, e in self._all_spans(self._go(data, arr), -1):
            out += text[last:s]
            out += repl_b
            last = e
        out += text[last:]
        return bytes(out)

    def replace_all_func(self, data: Bytes, fn) -> bytes:
        arr = _as_array(data)
        out = bytearray()
        last = 0
        text = bytes(arr.tobytes())
        for s, e in self._all_spans(self._go(data, arr), -1):
            out += text[last:s]
            r = fn(text[s:e])
            out += r.encode("utf-8") if isinstance(r, str) else bytes(r)
            last = e
        out += text[last:]
        return bytes(out)

    def _expand(self, template: bytes, text: bytes, m) -> bytes:
        """Go's $-template expansion: $1, ${name}, $$ handling."""
        names = self.subexp_names()

        def group_span(i: int):
            if m is None or 2 * i + 1 >= len(m):
                return None
            s, e = m[2 * i], m[2 * i + 1]
            return None if s < 0 or e < 0 else (s, e)

        out = bytearray()
        i = 0
        n = len(template)
        while i < n:
            b = template[i]
            if b != ord("$"):
                out.append(b)
                i += 1
                continue
            i += 1
            if i >= n:
                out.append(ord("$"))
                break
            if template[i] == ord("$"):
                out.append(ord("$"))
                i += 1
                continue
            braced = template[i] == ord("{")
            if braced:
                i += 1
            j = i
            while j < n and (chr(template[j]).isalnum()
                             or template[j] == ord("_")):
                j += 1
            name = template[i:j].decode("ascii", errors="replace")
            if braced:
                if j < n and template[j] == ord("}"):
                    jj = j + 1
                else:  # malformed ${: literal
                    out += b"${"
                    continue
            else:
                jj = j
            if not name:
                out.append(ord("$"))
                if braced:
                    out.append(ord("{"))
                continue
            idx: Optional[int] = None
            if name.isdigit():
                idx = int(name)
            else:
                for gi, gname in enumerate(names):
                    if gname == name:
                        idx = gi
                        break
            if idx is not None:
                sp = group_span(idx)
                if sp is not None:
                    out += text[sp[0]:sp[1]]
            i = jj
        return bytes(out)

    def split(self, data: Bytes, n: int = -1) -> List[bytes]:
        """Regexp.Split semantics (regex.go Split)."""
        if n == 0:
            return []
        arr = _as_array(data)
        if len(self.parsed.pattern) > 0 and len(arr) == 0:
            # Go: non-empty expression on empty input -> [""]
            return [b""]
        text = bytes(arr.tobytes())
        spans = self._all_spans(self._go(data, arr), -1)
        out: List[bytes] = []
        beg = 0
        end = 0
        for s, e in spans:
            if n > 0 and len(out) >= n - 1:
                break
            end = s
            if e != 0:
                out.append(text[beg:end])
                beg = e
        if end != len(text):
            out.append(text[beg:])
        return out

    def split_string(self, s: str, n: int = -1) -> List[str]:
        return [b.decode("utf-8", errors="surrogateescape")
                for b in self.split(s, n)]

    # -- Go API parity extras -------------------------------------------
    def literal_prefix(self) -> Tuple[bytes, bool]:
        """Regexp.LiteralPrefix: a literal that must begin any match, and
        whether it is the whole pattern."""
        from . import literal as litmod
        lits = litmod.exact_literals(self.parsed.ast)
        if lits is not None and len(lits) == 1:
            return lits[0], True
        node = self.parsed.ast
        from ..syntax.ast import Op
        while node.op == Op.CAPTURE:
            node = node.subs[0]
        prefix = b""
        if node.op == Op.CONCAT:
            for sub in node.subs:
                l = litmod.exact_literals(sub)
                if l is not None and len(l) == 1:
                    prefix += l[0]
                else:
                    break
        elif node.op == Op.LITERAL:
            l = litmod.exact_literals(node)
            if l:
                prefix = l[0]
        return prefix, False

    def subexp_index(self, name: str) -> int:
        """Regexp.SubexpIndex: group index for a name, or -1."""
        for i, nm in enumerate(self.subexp_names()):
            if i > 0 and nm == name:
                return i
        return -1

    def set_longest(self, longest: bool = True) -> None:
        """Regexp.Longest(): switch to POSIX leftmost-longest matching.

        Like Go's Regexp.Longest, not safe to call concurrently with
        searches — but the swap is prepared on a fresh engine and
        installed in one attribute update, so self is never observable
        in a half-initialized state (and dense-DFA artifacts rebuild
        through the on-disk cache, not from scratch)."""
        if longest != self.longest:
            fresh = type(self)(self.parsed, longest=longest,
                               config=self.config, device=self.device)
            self.__dict__.update(fresh.__dict__)

    def expand(self, template: Bytes, src: Bytes,
               match: Sequence[int]) -> bytes:
        """Regexp.Expand: apply a $-template given a submatch index
        vector — Go's flat [s0,e0,s1,e1,...] form or this package's
        find_submatch_index pair form [(s0,e0),(s1,e1)|None,...]."""
        tmpl = template.encode("utf-8") if isinstance(template, str) \
            else bytes(template)
        text = bytes(_as_array(src).tobytes())
        flat = []
        for v in match:
            if v is None:
                flat.extend((-1, -1)) if _is_pair_seq(match) \
                    else flat.append(-1)
            elif isinstance(v, (tuple, list)):
                flat.extend(int(x) for x in v)
            else:
                flat.append(int(v))
        return self._expand(tmpl, text, tuple(flat))

    # -- batched many-strings APIs (BranchDispatch/FirstByteSet subsumed,
    #    nfa/branch_dispatch.go:18-40 + nfa/firstbytes.go:8-41: the dense
    #    row scan dispatches and rejects every row's first byte with the
    #    same table gather; ops/rowscan.py) ------------------------------
    def _row_batch(self):
        if getattr(self, "_rows", None) is None:
            from ..ops.rowscan import RowBatch
            self._rows = RowBatch(self.fwd, self.rev, self.device)
        return self._rows

    def _batch_rows_ok(self) -> bool:
        return self.fwd is not None and self.rev is not None \
            and not self.longest

    @staticmethod
    def _row_bytes(texts: Sequence[Bytes]) -> List[bytes]:
        """Each row as the matchers read it, normalized on its own
        (go_normalize; a row's end is its text's end); an ASCII row or a
        str as it is."""
        out = []
        for t in texts:
            if isinstance(t, str):
                t = t.encode("utf-8")
            elif not (isinstance(t, bytes) and t.isascii()):
                t = go_normalize(_as_array(t)).tobytes()
            out.append(t)
        return out

    def is_match_batch(self, texts: Sequence[Bytes]) -> List[bool]:
        """Match one pattern against many independent strings in a single
        device launch (the reference's per-call anchored dispatch loop,
        re-expressed as a [B, L] row scan)."""
        if not self._batch_rows_ok():
            return [self.is_match(t) for t in texts]
        from ..ops.rowscan import pack_rows
        rb = self._row_batch()
        rows, lens = rb.upload(*pack_rows(self._row_bytes(texts)))
        self.stats.kernel_scans += 1
        found, _ = rb.match_ends_device(rows, lens)
        return found[:len(texts)].tolist()

    def find_index_batch(self, texts: Sequence[Bytes]
                         ) -> List[Optional[Tuple[int, int]]]:
        """Leftmost-first span per string, two launches total: forward
        ends (break-at-match rows scan) + reverse anchored starts."""
        if not self._batch_rows_ok():
            return [self.find_index(t) for t in texts]
        from ..ops.rowscan import pack_rows
        rb = self._row_batch()
        rows, lens = rb.upload(*pack_rows(self._row_bytes(texts)))
        self.stats.kernel_scans += 1
        found, ends = rb.match_ends_device(rows, lens)
        ends = torch.where(found, ends, -1)
        starts = rb.rev_starts_device(rows, lens, ends)
        m = len(texts)
        return [(s, e) if f else None for f, s, e in zip(
            found[:m].tolist(), starts[:m].tolist(), ends[:m].tolist())]

    # -- streaming (MatchReader family, regex.go:1619-1667 analogue) -----
    def is_match_reader(self, reader, chunk_size: int = 1 << 20) -> bool:
        """Stream a file-like object through the DFA with carried state;
        stops at the first match."""
        if self.fwd is None or self.longest:
            return self._stream_search(reader, chunk_size) is not None
        from ..dfa.dense import CTX_SOT, DEAD
        fwd = self.fwd
        s = int(fwd.starts[CTX_SOT])
        delta, match_on, classes = fwd.delta, fwd.match_on, fwd.classes
        norm = StreamNormalizer()
        while True:
            buf = reader.read(chunk_size)
            arr = norm.feed(buf) if buf else norm.finish()
            for c in classes[arr]:
                if match_on[s, c]:
                    return True
                s = delta[s, c]
                if s == DEAD:
                    return False
            if not buf:
                break
        return bool(fwd.match_eoi[s, CTX_SOT])

    def _stream_search(self, reader, chunk_size: int):
        """Run the incremental PikeVM over the reader: constant memory
        (thread queues + one carried byte), stops reading as soon as the
        leftmost match is decided — the true-streaming engine behind
        Go's MatchReader family (regex.go:1619-1667, which feeds its NFA
        machine one rune at a time without buffering)."""
        from ..engines.pikevm import StreamPikeVM
        sm = StreamPikeVM(self.pikevm, longest=self.longest)
        norm = StreamNormalizer()
        while True:
            buf = reader.read(chunk_size)
            if not buf:
                break
            m = sm.feed(norm.feed(buf).tobytes())
            if m is not None or sm.done:
                return sm.matched
        rest = norm.finish()
        if len(rest):
            m = sm.feed(rest.tobytes())
            if m is not None or sm.done:
                return sm.matched
        return sm.finish()

    def find_reader_index(self, reader, chunk_size: int = 1 << 20
                          ) -> Optional[Tuple[int, int]]:
        """FindReaderIndex (regex.go:1630): leftmost match span in stream
        offsets, reading only as much input as needed."""
        m = self._stream_search(reader, chunk_size)
        return None if m is None else (m[0], m[1])

    def find_reader_submatch_index(self, reader, chunk_size: int = 1 << 20
                                   ) -> Optional[List[Optional[int]]]:
        """FindReaderSubmatchIndex (regex.go:1650 analogue): submatch
        group spans in stream offsets, streaming with constant memory."""
        m = self._stream_search(reader, chunk_size)
        if m is None:
            return None
        groups = []
        for i in range(0, len(m), 2):
            a, b = m[i], m[i + 1]
            groups.append(None if a < 0 or b < 0 else (a, b))
        return groups

    # -- string-offset variants (Go Find*String*Index, regex.go) ---------
    # Offsets are byte offsets into the UTF-8 encoding, exactly as in Go
    # (strings are byte slices there).
    def find_string_index(self, s: str) -> Optional[Tuple[int, int]]:
        return self.find_index(s)

    def find_all_string_index(self, s: str, n: int = -1
                              ) -> Optional[List[Tuple[int, int]]]:
        return self.find_all_index(s, n)

    def find_string_submatch_index(self, s: str
                                   ) -> Optional[List[Optional[int]]]:
        return self.find_submatch_index(s)

    def find_all_string_submatch(self, s: str, n: int = -1
                                 ) -> Optional[List[List[Optional[str]]]]:
        res = self.find_all_submatch(s, n)
        if res is None:
            return None
        return [[None if b is None else
                 b.decode("utf-8", errors="surrogateescape") for b in grp]
                for grp in res]

    def find_all_string_submatch_index(self, s: str, n: int = -1):
        return self.find_all_submatch_index(s, n)

    def expand_string(self, template: str, src: str,
                      match: Sequence[int]) -> str:
        """Regexp.ExpandString (regex.go:951 analogue)."""
        return self.expand(template, src, match).decode(
            "utf-8", errors="surrogateescape")

    def replace_all_literal_string(self, s: str, repl: str) -> str:
        return self.replace_all_literal(s, repl).decode(
            "utf-8", errors="surrogateescape")

    def replace_all_string_func(self, s: str, fn) -> str:
        """ReplaceAllStringFunc: fn receives and returns str."""
        def wrap(b: bytes) -> bytes:
            out = fn(b.decode("utf-8", errors="surrogateescape"))
            return out.encode("utf-8") if isinstance(out, str) else out
        return self.replace_all_func(s, wrap).decode(
            "utf-8", errors="surrogateescape")

    # -- text marshalling (regex.go:1602-1615 analogue) -------------------
    def marshal_text(self) -> bytes:
        """MarshalText: the pattern string (engines recompile on load)."""
        return self.pattern.encode("utf-8")

    @classmethod
    def unmarshal_text(cls, text: Bytes) -> "Engine":
        pat = text.decode("utf-8") if isinstance(text, (bytes, bytearray)) \
            else str(text)
        return cls.compile(pat)

    # -- misc ------------------------------------------------------------
    def copy(self) -> "Engine":
        """Regexp.Copy (deprecated in Go; engines here are stateless)."""
        return self

    def __repr__(self) -> str:
        return f"coregex_tpu_torch.Regex({self.pattern!r}, {self.device})"

    def string(self) -> str:
        return self.pattern

    def __getstate__(self):
        # MarshalText analogue (regex.go:1602): persist pattern, recompile
        return {"pattern": self.pattern, "longest": self.longest,
                "device": str(self.device)}

    def __setstate__(self, state):
        self.__init__(parse(state["pattern"]), longest=state["longest"],
                      device=state["device"])
