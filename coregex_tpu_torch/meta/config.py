# Copy of coregex_tpu/meta/config.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Engine configuration (meta/config.go analogue)."""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class Config:
    """Compile/search configuration with validation (meta/config.go:31-168
    analogue).  `with_*` style updates via `replace()`."""
    enable_dfa: bool = True          # eager determinization (else PikeVM)
    enable_prefilter: bool = True    # literal/prefix strategies
    state_limit: int = 20_000        # DFA state budget (DeterminizationLimit)
    batch_threshold: int = 1 << 14   # bytes below which host paths win
    max_literals: int = 64           # alternation size for literal engines
    min_literal_len: int = 2         # inner literal minimum
    max_repair: int = 4              # chunk-scan fixpoint repair rounds
    max_onepass_states: int = 4096

    def validate(self) -> "Config":
        if self.state_limit < 16:
            raise ValueError("state_limit must be >= 16")
        if self.max_literals < 1 or self.max_literals > 256:
            raise ValueError("max_literals must be in [1, 256]")
        if self.max_repair < 0:
            raise ValueError("max_repair must be >= 0")
        return self


DEFAULT = Config()


# -- debug logging (meta/debug.go analogue) --------------------------------

_LEVEL = None


def debug_level() -> int:
    global _LEVEL
    if _LEVEL is None:
        try:
            _LEVEL = int(os.environ.get("COREGEX_TPU_DEBUG", "0"))
        except ValueError:
            _LEVEL = 0
    return _LEVEL


def debug(level: int, msg: str) -> None:
    if debug_level() >= level:
        print(f"[coregex-tpu] {msg}", file=sys.stderr)
