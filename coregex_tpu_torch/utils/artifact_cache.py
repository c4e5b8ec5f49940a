# Copy of coregex_tpu/utils/artifact_cache.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Compiled-artifact cache (the checkpoint/resume analogue, SURVEY.md §5).

The reference recompiles patterns on load (MarshalText persists only the
pattern string, regex.go:1602-1615) because its compile is microseconds;
here pattern compile includes eager determinization, so dense DFA tables
serialize to .npz keyed by a hash of (pattern, variant, format version).
Enabled when COREGEX_TPU_CACHE_DIR is set, or via explicit calls.

The port's keys carry the namespace ``coregex_tpu_torch`` (the reference's
do not), so the two copies of the pipeline never load each other's tables
from a shared directory.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from ..dfa.dense import DenseDFA

FORMAT_VERSION = 2
NAMESPACE = "coregex_tpu_torch"


def cache_dir() -> Optional[str]:
    return os.environ.get("COREGEX_TPU_CACHE_DIR")


def _key(pattern: str, variant: str) -> str:
    h = hashlib.sha256(
        f"{NAMESPACE}\x00{FORMAT_VERSION}\x00{variant}\x00{pattern}"
        .encode()).hexdigest()
    return h[:32]


def save_dense(pattern: str, variant: str, dfa: DenseDFA,
               directory: Optional[str] = None) -> Optional[str]:
    d = directory or cache_dir()
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, _key(pattern, variant) + ".npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, delta=dfa.delta, match_on=dfa.match_on,
        match_eoi=dfa.match_eoi, starts=dfa.starts, classes=dfa.classes,
        meta=np.array([int(dfa.anchored), int(dfa.break_at_match),
                       int(dfa.reverse), dfa.num_nfa_states]))
    os.replace(tmp, path)
    return path


def load_dense(pattern: str, variant: str,
               directory: Optional[str] = None) -> Optional[DenseDFA]:
    d = directory or cache_dir()
    if not d:
        return None
    path = os.path.join(d, _key(pattern, variant) + ".npz")
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        meta = z["meta"]
        return DenseDFA(
            delta=z["delta"], match_on=z["match_on"],
            match_eoi=z["match_eoi"], starts=z["starts"],
            classes=z["classes"], anchored=bool(meta[0]),
            break_at_match=bool(meta[1]), reverse=bool(meta[2]),
            pattern=pattern, num_nfa_states=int(meta[3]))
    except Exception:
        return None
