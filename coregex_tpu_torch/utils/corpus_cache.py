"""Device corpus cache for torch devices.

Ports ``coregex_tpu/utils/corpus_cache.py`` (:25-82): an LRU of corpus
entries per (device, corpus fingerprint).  An entry holds the ASCII verdict,
the device buffer, its flipped copy for reverse scans, and the tiles derived
from them (count/span word tiles, reverse symbol tiles), so everything a
corpus pins on the device is evicted with it under one bound.

The ASCII verdict is computed on the host, once per entry, before anything
is uploaded: callers decide from it which tables serve the corpus, and a
call the device path does not serve never uploads the corpus.

Fingerprint contract (ROADMAP F5): the key is ``_fingerprint`` (a copy of
the reference's, :25-33), which samples 64 bytes plus the first and last 32
bytes and the length, not a hash of the whole buffer.  Two corpora of one length
that agree on every sampled byte share an entry, so a caller that mutates a
corpus in place between calls can be served the stale buffer and verdict.
Corpora are treated as immutable during searches.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

_MAX_ENTRIES = 4
_MAX_TILES = 3      # derived tile sets kept per entry (LRU within the entry)


def _fingerprint(arr: np.ndarray) -> tuple:
    n = len(arr)
    if n == 0:
        return (0,)
    step = max(1, n // 64)
    sample = bytes(arr[::step][:64].tobytes())
    head = bytes(arr[:32].tobytes())
    tail = bytes(arr[-32:].tobytes())
    return (n, hash(sample), hash(head), hash(tail))


class _Entry:
    __slots__ = ("ascii", "buf", "flipped", "tiles")

    def __init__(self, ascii_ok: bool):
        self.ascii = ascii_ok
        self.buf = None
        self.flipped = None
        self.tiles: "OrderedDict[Hashable, torch.Tensor]" = OrderedDict()


_cache: "OrderedDict[tuple, _Entry]" = OrderedDict()


def _entry(arr: np.ndarray, device) -> _Entry:
    key = (str(torch.device(device)), _fingerprint(arr))
    ent = _cache.get(key)
    if ent is None:
        ent = _Entry(len(arr) == 0 or int(arr.max()) < 0x80)
        _cache[key] = ent
        while len(_cache) > _MAX_ENTRIES:
            _cache.popitem(last=False)
    _cache.move_to_end(key)
    return ent


def corpus_is_ascii(arr: np.ndarray, device) -> bool:
    """Every byte < 0x80; computed on the host once per entry, without
    uploading the corpus."""
    return _entry(arr, device).ascii


def device_corpus(arr: np.ndarray, device) -> torch.Tensor:
    """Upload (or fetch the cached) uint8 buffer of a host corpus."""
    ent = _entry(arr, device)
    if ent.buf is None:
        with warnings.catch_warnings():
            # read-only host buffers (np.frombuffer) are only read here
            warnings.simplefilter("ignore", UserWarning)
            host = torch.from_numpy(np.ascontiguousarray(arr, np.uint8))
        ent.buf = host.to(device, copy=True)
    return ent.buf


def device_corpus_flipped(arr: np.ndarray, device) -> torch.Tensor:
    """Flipped copy of the device buffer, cached alongside it."""
    ent = _entry(arr, device)
    if ent.flipped is None:
        ent.flipped = torch.flip(device_corpus(arr, device), [0])
    return ent.flipped


def corpus_tiles(arr: np.ndarray, device, key: Hashable,
                 build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Tiles derived from the corpus's device buffers, cached on its entry
    under `key` (which names the layout: geometry, symbol tables); `build`
    makes them on a miss."""
    ent = _entry(arr, device)
    t = ent.tiles.get(key)
    if t is None:
        t = build()
        ent.tiles[key] = t
        while len(ent.tiles) > _MAX_TILES:
            ent.tiles.popitem(last=False)
    ent.tiles.move_to_end(key)
    return t


def release_flipped() -> None:
    """Drop the cached flipped copies and derived tiles (keep the forward
    buffers and verdicts)."""
    for ent in _cache.values():
        ent.flipped = None
        ent.tiles.clear()


def clear() -> None:
    _cache.clear()
