# Copy of coregex_tpu/syntax/__init__.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
from .ast import Node, Op, MAX_RUNE
from .parser import (FOLD, MULTILINE, DOT_NL, UNGREEDY, ParseError, Parsed,
                     parse)

__all__ = ["Node", "Op", "MAX_RUNE", "FOLD", "MULTILINE", "DOT_NL",
           "UNGREEDY", "ParseError", "Parsed", "parse"]
