# Copy of coregex_tpu/utils/device_lock.py for coregex_tpu_torch,
# which imports nothing of coregex_tpu; changes are noted where made.
"""Per-device dispatch serialization.

Every device entry point serializes on the lock of its device (the port
keys it by the torch device, e.g. ``"torch:cuda:0"``); host paths
(PikeVM, backtracker) stay concurrent.  The reference is concurrent by
design (meta/engine.go:126-156); one card runs the port's kernels one
call at a time, so concurrent dispatch gains nothing.  The reference's
copy defaults the key to ``jax.default_backend()``; the port's key is
always explicit.

Reentrant because pipelines call each other (find_all -> count).
"""

from __future__ import annotations

import threading

_REGISTRY: dict = {}
_REGISTRY_GUARD = threading.Lock()


def device_lock(key: str) -> threading.RLock:
    """The dispatch lock for the device named `key`."""
    with _REGISTRY_GUARD:
        lk = _REGISTRY.get(key)
        if lk is None:
            lk = _REGISTRY[key] = threading.RLock()
        return lk
