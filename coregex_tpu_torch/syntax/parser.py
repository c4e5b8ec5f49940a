# Copy of coregex_tpu/syntax/parser.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Parser for the Go `regexp/syntax` Perl dialect (the reference's input
language — its meta/compile.go:58 parses with regexp/syntax).

Produces the flag-free AST in `ast.py`: inline flags `(?imsU)` are resolved
during parsing, case-insensitivity is lowered to fold-closed classes, and
POSIX leftmost-longest vs Perl leftmost-first is NOT a parse-time property
(it is an engine mode, as in Go).

Unsupported (exactly like the reference, README.md:204): backreferences and
lookaround assertions raise ParseError.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ast import (MAX_RUNE, POSIX_CLASSES, PERL_D, PERL_S, PERL_W, Node, Op,
                  alternate, cls, concat, lit, negate_ranges, normalize_ranges)
from . import fold as foldmod
from . import unicode_tables

MAX_REPEAT = 1000

# flag bits
FOLD = 1
MULTILINE = 2
DOT_NL = 4
UNGREEDY = 8


class ParseError(ValueError):
    def __init__(self, msg: str, pattern: str = "", pos: int = -1):
        self.msg = msg
        self.pattern = pattern
        self.pos = pos
        loc = f" at {pos}" if pos >= 0 else ""
        super().__init__(f"error parsing regexp: {msg}{loc}: `{pattern}`")


class _Parser:
    def __init__(self, pattern: str, flags: int = 0):
        self.pat = pattern
        self.pos = 0
        self.flags = flags
        self.ngroup = 0
        self.group_names: List[Optional[str]] = []

    # -- low-level ------------------------------------------------------
    def error(self, msg: str) -> "ParseError":
        return ParseError(msg, self.pat, self.pos)

    def more(self) -> bool:
        return self.pos < len(self.pat)

    def peek(self) -> str:
        return self.pat[self.pos] if self.pos < len(self.pat) else ""

    def next(self) -> str:
        c = self.pat[self.pos]
        self.pos += 1
        return c

    def eat(self, c: str) -> bool:
        if self.pat.startswith(c, self.pos):
            self.pos += len(c)
            return True
        return False

    # -- entry ----------------------------------------------------------
    def parse(self) -> Node:
        node = self.parse_alternate()
        if self.more():
            if self.peek() == ")":
                raise self.error("unexpected )")
            raise self.error(f"unexpected {self.peek()!r}")
        return node

    def parse_alternate(self) -> Node:
        subs = [self.parse_concat()]
        while self.eat("|"):
            subs.append(self.parse_concat())
        return alternate(subs)

    def parse_concat(self) -> Node:
        terms: List[Node] = []
        while self.more() and self.peek() not in "|)":
            t = self.parse_term(terms)
            if t is not None:
                terms.append(t)
        return concat(self._coalesce_literals(terms))

    @staticmethod
    def _coalesce_literals(terms: List[Node]) -> List[Node]:
        out: List[Node] = []
        for t in terms:
            if (t.op == Op.LITERAL and out and out[-1].op == Op.LITERAL):
                out[-1] = lit(out[-1].runes + t.runes)
            else:
                out.append(t)
        return out

    # -- terms ----------------------------------------------------------
    def parse_term(self, terms: List[Node]) -> Optional[Node]:
        c = self.peek()
        if c in "*+?":
            self.pos += 1
            return self._apply_repeat(terms, c)
        if c == "{":
            rep = self._try_parse_counted_repeat()
            if rep is None:
                self.pos += 1
                return self._literal_char(ord("{"))
            return self._apply_repeat(terms, rep)
        a = self.parse_atom()
        if isinstance(a, list):  # \Q..\E rune sequence: splice so a
            terms.extend(a[:-1])  # quantifier binds only the last rune
            return a[-1]
        return a

    def _apply_repeat(self, terms: List[Node], op) -> None:
        if not terms:
            raise self.error("missing argument to repetition operator")
        sub = terms[-1]
        if sub.op in (Op.STAR, Op.PLUS, Op.QUEST, Op.REPEAT):
            raise self.error("invalid nested repetition operator")
        if sub.op in (Op.BEGIN_LINE, Op.END_LINE, Op.BEGIN_TEXT, Op.END_TEXT,
                      Op.WORD_BOUNDARY, Op.NO_WORD_BOUNDARY):
            # Go allows e.g. ^* (treats as repeat of empty-width op)
            pass
        greedy = not (self.flags & UNGREEDY)
        if self.eat("?"):
            greedy = not greedy
        if self.more() and self.peek() in "*+?":
            raise self.error("invalid nested repetition operator")
        # NOTE: no "last rune only" split here.  Bare `ab*` binds to 'b'
        # naturally because literal chars stay separate terms until the
        # end-of-concat coalesce; a multi-rune literal term can only come
        # from a finished group (`(?:ab)*`), where the repeat applies to
        # the whole group (Go regexp/syntax stack semantics).
        if isinstance(op, str):
            kind = {"*": Op.STAR, "+": Op.PLUS, "?": Op.QUEST}[op]
            terms[-1] = Node(kind, greedy=greedy, subs=(sub,))
        else:
            lo, hi = op
            if lo > MAX_REPEAT or (hi != -1 and (hi > MAX_REPEAT or hi < lo)):
                raise self.error("invalid repeat count")
            terms[-1] = Node(Op.REPEAT, min=lo, max=hi, greedy=greedy,
                             subs=(sub,))
        return None

    def _try_parse_counted_repeat(self) -> Optional[Tuple[int, int]]:
        start = self.pos
        assert self.peek() == "{"
        self.pos += 1
        lo = self._parse_int()
        if lo is None:
            self.pos = start
            return None
        hi: Optional[int] = lo
        if self.eat(","):
            if self.peek() == "}":
                hi = -1
            else:
                hi = self._parse_int()
                if hi is None:
                    self.pos = start
                    return None
        if not self.eat("}"):
            self.pos = start
            return None
        return (lo, hi if hi is not None else -1)

    def _parse_int(self) -> Optional[int]:
        start = self.pos
        while self.more() and self.peek().isdigit():
            self.pos += 1
        if self.pos == start or self.pos - start > 8:
            return None
        return int(self.pat[start:self.pos])

    # -- atoms ----------------------------------------------------------
    def parse_atom(self) -> Optional[Node]:
        c = self.next()
        if c == "(":
            return self.parse_group()
        if c == "[":
            return self.parse_class()
        if c == ".":
            if self.flags & DOT_NL:
                return Node(Op.ANY_CHAR)
            return Node(Op.ANY_NOT_NL)
        if c == "^":
            return Node(Op.BEGIN_LINE if self.flags & MULTILINE
                        else Op.BEGIN_TEXT)
        if c == "$":
            return Node(Op.END_LINE if self.flags & MULTILINE
                        else Op.END_TEXT)
        if c == "\\":
            return self.parse_escape()
        if c == ")":
            raise self.error("unexpected )")
        return self._literal_char(ord(c))

    def _literal_char(self, cp: int) -> Node:
        if self.flags & FOLD:
            orbit = foldmod.fold_orbit(cp)
            if len(orbit) > 1:
                return cls([(o, o) for o in orbit])
        return lit((cp,))

    # -- groups ---------------------------------------------------------
    def parse_group(self) -> Optional[Node]:
        if self.eat("?"):
            if self.eat(":"):
                node = self.parse_alternate()
                if not self.eat(")"):
                    raise self.error("missing closing )")
                return node
            if self.peek() in "=!<" or self.pat.startswith("P=", self.pos):
                if self.eat("P="):
                    raise self.error("backreferences not supported")
                if self.eat("<="):
                    raise self.error("lookbehind not supported")
                if self.eat("<!"):
                    raise self.error("lookbehind not supported")
                if self.peek() in "=!":
                    raise self.error("lookahead not supported")
                # (?<name> — named group
                return self._parse_named_group("<", ">")
            if self.eat("P<"):
                return self._parse_named_group("", ">")
            if self.eat("'"):
                raise self.error("invalid group syntax")
            # flag setting: (?ims-U) or (?flags:...)
            return self._parse_flags_group()
        # plain capture
        self.ngroup += 1
        idx = self.ngroup
        self.group_names.append(None)
        saved = self.flags
        node = self.parse_alternate()
        self.flags = saved
        if not self.eat(")"):
            raise self.error("missing closing )")
        return Node(Op.CAPTURE, group=idx, subs=(node,))

    def _parse_named_group(self, opener: str, closer: str) -> Node:
        if opener and not self.eat(opener):
            raise self.error("invalid named capture")
        end = self.pat.find(closer, self.pos)
        if end < 0:
            raise self.error("invalid named capture: missing closing >")
        name = self.pat[self.pos:end]
        if not name or not all(ch.isalnum() or ch == "_" for ch in name):
            raise self.error(f"invalid named capture: bad name {name!r}")
        self.pos = end + 1
        self.ngroup += 1
        idx = self.ngroup
        self.group_names.append(name)
        saved = self.flags
        node = self.parse_alternate()
        self.flags = saved
        if not self.eat(")"):
            raise self.error("missing closing )")
        return Node(Op.CAPTURE, group=idx, name=name, subs=(node,))

    def _parse_flags_group(self) -> Optional[Node]:
        add = 0
        remove = 0
        neg = False
        while self.more():
            c = self.peek()
            if c == "-":
                if neg:
                    raise self.error("bad inline flags")
                neg = True
                self.pos += 1
                continue
            bit = {"i": FOLD, "m": MULTILINE, "s": DOT_NL, "U": UNGREEDY}.get(c)
            if bit is None:
                break
            if neg:
                remove |= bit
            else:
                add |= bit
            self.pos += 1
        if self.eat(")"):
            # (?flags) — applies to rest of enclosing group
            if add == 0 and remove == 0:
                raise self.error("missing flags in (?)")
            self.flags = (self.flags | add) & ~remove
            return None
        if self.eat(":"):
            saved = self.flags
            self.flags = (self.flags | add) & ~remove
            node = self.parse_alternate()
            self.flags = saved
            if not self.eat(")"):
                raise self.error("missing closing )")
            return node
        raise self.error("bad inline flags")

    # -- escapes --------------------------------------------------------
    SIMPLE_ESCAPES = {"a": 7, "f": 12, "n": 10, "r": 13, "t": 9, "v": 11}

    def parse_escape(self) -> Node:
        if not self.more():
            raise self.error("trailing backslash at end of expression")
        c = self.next()
        if c in self.SIMPLE_ESCAPES:
            return self._literal_char(self.SIMPLE_ESCAPES[c])
        if c == "d":
            return cls(PERL_D)
        if c == "D":
            return cls(negate_ranges(PERL_D))
        if c == "s":
            return cls(PERL_S)
        if c == "S":
            return cls(negate_ranges(PERL_S))
        if c == "w":
            return cls(PERL_W)
        if c == "W":
            return cls(negate_ranges(PERL_W))
        if c == "b":
            return Node(Op.WORD_BOUNDARY)
        if c == "B":
            return Node(Op.NO_WORD_BOUNDARY)
        if c == "A":
            return Node(Op.BEGIN_TEXT)
        if c == "z":
            return Node(Op.END_TEXT)
        if c == "Q":
            # \Q...\E literal text
            end = self.pat.find("\\E", self.pos)
            if end < 0:
                text = self.pat[self.pos:]
                self.pos = len(self.pat)
            else:
                text = self.pat[self.pos:end]
                self.pos = end + 2
            parts = [self._literal_char(ord(ch)) for ch in text]
            if not parts:
                return Node(Op.EMPTY)
            # Go pushes \Q runes individually, so a following quantifier
            # binds only the LAST rune (\Qab\E* == ab*); parse_term
            # splices the list into the surrounding concat.
            return parts
        if c == "E":
            return Node(Op.EMPTY)
        if c == "x":
            return self._literal_char(self._parse_hex())
        if c == "0":
            return self._literal_char(self._parse_octal())
        if c in "123456789":
            raise self.error("backreferences not supported")
        if c in ("p", "P"):
            ranges = self._parse_unicode_class()
            if c == "P":
                ranges = negate_ranges(ranges)
            if self.flags & FOLD:
                ranges = foldmod.fold_ranges(ranges)
            return cls(ranges)
        if not c.isalnum():
            return self._literal_char(ord(c))
        raise self.error(f"invalid escape sequence \\{c}")

    def _parse_hex(self) -> int:
        if self.eat("{"):
            end = self.pat.find("}", self.pos)
            if end < 0:
                raise self.error("invalid escape sequence")
            try:
                v = int(self.pat[self.pos:end], 16)
            except ValueError:
                raise self.error("invalid escape sequence")
            self.pos = end + 1
            if v > MAX_RUNE:
                raise self.error("invalid escape sequence (rune too large)")
            return v
        if self.pos + 2 > len(self.pat):
            raise self.error("invalid escape sequence")
        try:
            v = int(self.pat[self.pos:self.pos + 2], 16)
        except ValueError:
            raise self.error("invalid escape sequence")
        self.pos += 2
        return v

    def _parse_octal(self) -> int:
        v = 0
        for _ in range(2):
            if self.more() and self.peek() in "01234567":
                v = v * 8 + int(self.next())
            else:
                break
        return v

    def _parse_unicode_class(self):
        if self.eat("{"):
            end = self.pat.find("}", self.pos)
            if end < 0:
                raise self.error("invalid character class name")
            name = self.pat[self.pos:end]
            self.pos = end + 1
        else:
            if not self.more():
                raise self.error("invalid character class name")
            name = self.next()
        neg = False
        if name.startswith("^"):
            neg = True
            name = name[1:]
        ranges = unicode_tables.lookup(name)
        if ranges is None:
            raise self.error(f"invalid character class name {name!r}")
        if neg:
            ranges = negate_ranges(ranges)
        return ranges

    # -- character classes ---------------------------------------------
    def parse_class(self) -> Node:
        negated = self.eat("^")
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            if not self.more():
                raise self.error("missing closing ]")
            if self.peek() == "]" and not first:
                self.pos += 1
                break
            first = False
            # POSIX class [:alpha:]
            if self.pat.startswith("[:", self.pos):
                end = self.pat.find(":]", self.pos + 2)
                if end >= 0:
                    name = self.pat[self.pos + 2:end]
                    self.pos = end + 2
                    pneg = name.startswith("^")
                    if pneg:
                        name = name[1:]
                    if name not in POSIX_CLASSES:
                        raise self.error(f"invalid character class: [:{name}:]")
                    rs = POSIX_CLASSES[name]
                    ranges.extend(negate_ranges(rs) if pneg else rs)
                    continue
            lo = self._parse_class_char()
            if lo is None:
                # embedded class like \d — cannot form a range
                continue
            if (self.peek() == "-" and self.pos + 1 < len(self.pat)
                    and self.pat[self.pos + 1] != "]"):
                self.pos += 1
                hi = self._parse_class_char()
                if hi is None:
                    raise self.error("invalid character class range")
                if hi < lo:
                    raise self.error("invalid character class range")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        # stash embedded-class ranges collected via side channel
        ranges.extend(self._embedded)
        self._embedded = []
        if self.flags & FOLD:
            ranges = list(foldmod.fold_ranges(ranges))
        rs = normalize_ranges(ranges)
        if negated:
            rs = negate_ranges(rs)
        if not rs:
            return Node(Op.NO_MATCH)
        return Node(Op.CHAR_CLASS, ranges=rs)

    _embedded: List[Tuple[int, int]] = []

    def _parse_class_char(self) -> Optional[int]:
        c = self.next()
        if c != "\\":
            return ord(c)
        if not self.more():
            raise self.error("trailing backslash at end of expression")
        e = self.next()
        if e in self.SIMPLE_ESCAPES:
            return self.SIMPLE_ESCAPES[e]
        if e == "x":
            return self._parse_hex()
        if e == "0":
            return self._parse_octal()
        if e == "d":
            self._embedded.extend(PERL_D)
            return None
        if e == "D":
            self._embedded.extend(negate_ranges(PERL_D))
            return None
        if e == "s":
            self._embedded.extend(PERL_S)
            return None
        if e == "S":
            self._embedded.extend(negate_ranges(PERL_S))
            return None
        if e == "w":
            self._embedded.extend(PERL_W)
            return None
        if e == "W":
            self._embedded.extend(negate_ranges(PERL_W))
            return None
        if e in ("p", "P"):
            rs = self._parse_unicode_class()
            if e == "P":
                rs = negate_ranges(rs)
            self._embedded.extend(rs)
            return None
        if not e.isalnum():
            return ord(e)
        raise self.error(f"invalid escape sequence \\{e}")


class Parsed:
    """Result of parsing: AST + capture group info."""

    def __init__(self, ast: Node, ngroup: int, names: List[Optional[str]],
                 pattern: str):
        self.ast = ast
        self.num_captures = ngroup          # number of () groups (excl. group 0)
        self.group_names = names            # index i -> name of group i+1
        self.pattern = pattern

    def subexp_names(self) -> List[str]:
        """Like Go's Regexp.SubexpNames: index 0 = whole match (empty name)."""
        return [""] + [(n or "") for n in self.group_names]


def parse(pattern: str, flags: int = 0) -> Parsed:
    p = _Parser(pattern, flags)
    p._embedded = []
    ast_root = p.parse()
    return Parsed(ast_root, p.ngroup, p.group_names, pattern)
