"""Bidirectional span assembly on hit-sized arrays.

Ports from ``coregex_tpu/ops/span_chain.py``: ``_floor_log2`` (:464),
``cummax_fast`` (:476), ``_word_lastpos_table`` (:494),
``inner_flag_arrays_words`` (:603), ``_fit_words`` (:694), ``bidi_ends``
(:703-761) and ``bidi_assemble`` (:766-804).  The JAX package computes these
in XLA outside any Pallas kernel; here they are plain torch tensor code
around the K4 compactions of ``sparse_chain_payloads``.  ``_dev_i32``
(:945) caches device scalars to avoid host-to-device transfers; torch
passes host ints to its kernels as arguments, so it has no counterpart.

Forward: the span-event scan marks candidate match ends (flag words) and
each group's first flag; only first flags compact, and each group's end is
the last flag strictly before the next group's first flag.  Reverse: a
pre-reset flag scan over the flipped corpus, reset at the reversed ends;
each interval's last flag at or before the next reset is the match start.
Both sides keep int32 positions, so corpora must stay below 2^31 - 32
bytes (the caller checks).
"""

from __future__ import annotations

import numpy as np
import torch

from .compact2 import sparse_chain_payloads
from .span_scan import LOW_MASK

# EOI kinds (dfa/countdfa.py)
_EOI_EXTEND = 1
_EOI_EXTRA = 2
_EOI_COMPLEX = 3

_POS_BIG = 2 ** 31 - 1
# BIT[k] = int32 with only bit k set (BIT[31] = INT32_MIN)
BIT = (np.int64(1) << np.arange(32, dtype=np.int64)).astype(
    np.uint32).view(np.int32)


def _table(tbl: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tbl, device=like.device)


def _floor_log2(v):
    """floor(log2(v)) of int32 words read as unsigned (bit 31 set -> 31),
    -1 for v == 0.  frexp of the exact float64 value gives the exponent
    without rounding."""
    u = (v.to(torch.int64) & 0xFFFFFFFF).to(torch.float64)
    return (torch.frexp(u).exponent - 1).to(torch.int32)


def cummax_fast(x, neg: int):
    """Inclusive running max of a 1-D tensor through a [rows, 1024]
    reshape: torch's 1-D cummax is one long sequential scan (181 ms for
    64M int32 words on an H100 at 700 W), the row-wise scan is parallel over
    rows.  `neg` is the identity element (ref. cummax_fast)."""
    m = int(x.shape[0])
    C = 1024
    R = -(-m // C)
    if R * C != m:
        x = torch.cat([x, torch.full((R * C - m,), neg, dtype=x.dtype,
                                     device=x.device)])
    row = torch.cummax(x.reshape(R, C), 1).values
    carry = torch.cummax(row[:, -1], 0).values
    carry = torch.cat([torch.full((1,), neg, dtype=x.dtype,
                                  device=x.device), carry[:-1]])
    return torch.maximum(row, carry[:, None]).reshape(-1)[:m]


def _word_lastpos_table(bits_w, nw: int):
    """lastpos_w[i] = highest set-bit POSITION strictly before word i
    (-1 if none)."""
    base = torch.arange(nw, dtype=torch.int32, device=bits_w.device) * 32
    top = torch.where(bits_w != 0, base + _floor_log2(bits_w), -1)
    incl = cummax_fast(top, -1)
    return torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                 device=bits_w.device), incl[:-1]])


def _fit_words(w, nwb: int):
    m = int(w.shape[0])
    if m < nwb:
        return torch.cat([w, torch.zeros(nwb - m, dtype=torch.int32,
                                         device=w.device)])
    return w[:nwb]


def inner_flag_arrays_words(fw_raw, nwb1: int):
    """(flagw padded to nwb1, lastflag_w, global last flag) from the flag
    scan's word output over the [n+1] domain."""
    flagw = _fit_words(fw_raw, nwb1)
    lastflag_w = _word_lastpos_table(flagw, nwb1)
    base = torch.arange(nwb1, dtype=torch.int32, device=flagw.device) * 32
    top = torch.where(flagw != 0, base + _floor_log2(flagw), -1)
    return flagw, lastflag_w, top.max()


def _flip_roll(x, cnt):
    """jnp.roll(jnp.flip(x), cnt - len(x)) with a device count: entry i
    is x[(cnt - 1 - i) mod len(x)]."""
    m = int(x.shape[0])
    idx = torch.remainder(cnt.to(torch.int64) - 1
                          - torch.arange(m, device=x.device), m)
    return x[idx]


def bidi_ends(flagw, firstw, n: int, total, kind, capM: int, nwb: int,
              nwb1: int):
    """Forward events -> (ends [capM] ascending, final count, reversed
    reset positions rq [capM] ascending (dead = -1), reset words [nwb1],
    ok).  `total` and `kind` are 0-dim tensors or ints.

    The reference's rw scatter sends each dead rq = -1 to its last word
    (JAX wraps negative indices), which sets bit 31 there whenever the
    dead count is odd; here dead entries are dropped."""
    dev = flagw.device
    fw = _fit_words(flagw, nwb)
    gw = _fit_words(firstw, nwb)
    lastflag_w = _word_lastpos_table(fw, nwb)
    base = torch.arange(nwb, dtype=torch.int32, device=dev) * 32
    top = torch.where(fw != 0, base + _floor_log2(fw), -1)
    glob_f = top.max()
    f_pos, fwi, lfi, cntM, okE = sparse_chain_payloads(
        gw, [fw, lastflag_w], _POS_BIG, capM)
    idm = torch.arange(capM, dtype=torch.int32, device=dev)
    live = idm < cntM
    low = _table(LOW_MASK, fw)
    vf = fwi & low[(f_pos & 31).long()]          # bits strictly below
    lfb = torch.where(vf != 0, (f_pos & ~31) + _floor_log2(vf), lfi)
    ends_c = torch.cat([lfb[1:], torch.zeros(1, dtype=torch.int32,
                                             device=dev)])
    ends_c = torch.where(idm == cntM - 1, glob_f, ends_c)
    ok = okE & torch.where(live, ends_c >= f_pos, True).all()
    ends_c = torch.where(live, ends_c, n)
    ends_c = torch.where((idm == cntM - 1) & (kind == _EOI_EXTEND), n,
                         ends_c)
    extra = torch.as_tensor(kind == _EOI_EXTRA, device=dev).to(torch.int32)
    ends_c = torch.where((idm == cntM) & (extra == 1), n, ends_c)
    cntF = cntM + extra
    ok = ok & (cntF == total) & torch.as_tensor(kind != _EOI_COMPLEX,
                                                device=dev)
    liveF = idm < cntF
    rq = torch.where(liveF, n - _flip_roll(ends_c, cntF), -1)
    word = (rq >> 5).long()
    keep = (rq >= 0) & (word < nwb1)
    bits = torch.where(keep, _table(BIT, rq)[(rq & 31).long()], 0)
    rw = torch.zeros(nwb1, dtype=torch.int32, device=dev)
    rw.index_add_(0, torch.where(keep, word, 0), bits)
    return ends_c, cntF, rq, rw, ok


def bidi_assemble(ends_c, cntF, rw, fw_rev, n: int, capM: int, nwb1: int):
    """Reverse flags -> (spans [capM, 2], count, ok).  Reset events carry
    flag-word payloads; each interval's last flag at or before the next
    reset is the leftmost viable start; flip to ascending and cross-check
    against the forward ends."""
    dev = rw.device
    flagw_r, lastflag_r, glob = inner_flag_arrays_words(
        _fit_words(fw_rev, nwb1), nwb1)
    r_pos, fwi, lfi, cntR, okR = sparse_chain_payloads(
        rw, [flagw_r, lastflag_r], n + 1, capM)
    idx = torch.arange(capM, dtype=torch.int32, device=dev)
    live = idx < cntR
    incl = _table(LOW_MASK, rw)[(r_pos & 31).long() + 1]   # bits 0..bit
    vf = fwi & incl
    lfab = torch.where(vf != 0, (r_pos & ~31) + _floor_log2(vf), lfi)
    q_i = torch.cat([lfab[1:], torch.zeros(1, dtype=torch.int32,
                                           device=dev)])
    q_i = torch.where(idx == cntR - 1, glob, q_i)
    ok = okR & (cntR == cntF) & torch.where(live, q_i > r_pos, True).all()
    s_a = _flip_roll(n - q_i, cntR)
    e_a = _flip_roll(n - r_pos, cntR)
    s_a = torch.where(live, s_a, n)
    e_a = torch.where(live, e_a, s_a)
    ok = ok & torch.where(live, s_a < e_a, True).all()
    nxt = torch.cat([s_a[1:], torch.full((1,), _POS_BIG, dtype=torch.int32,
                                         device=dev)])
    ok = ok & torch.where(idx < cntR - 1, e_a <= nxt, True).all()
    ok = ok & torch.where(live, e_a == ends_c, True).all()
    return torch.stack([s_a, e_a], dim=1), cntR, ok
