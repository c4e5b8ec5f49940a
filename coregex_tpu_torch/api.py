"""Public API (ref. ``coregex_tpu/api.py``) over the torch Engine.

The device is an explicit argument: ``compile(p, device="cuda")`` runs the
corpus-scale paths through the CUDA kernels, ``device="cpu"`` through their
plain torch versions.
"""
from __future__ import annotations

from .meta.engine import Engine

Regex = Engine


def quote_meta(s: str) -> str:
    special = "\\.+*?()|[]{}^$"
    return "".join("\\" + c if c in special else c for c in s)


def compile(pattern, device="cuda", **kw):  # noqa: A001 - mirrors Go Compile
    return Engine.compile(pattern, device=device, **kw)


def must_compile(pattern, device="cuda", **kw):
    return compile(pattern, device=device, **kw)


def compile_posix(pattern, device="cuda", **kw):
    return compile(pattern, device=device, longest=True, **kw)
