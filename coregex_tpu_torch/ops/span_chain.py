"""Bidirectional span assembly on hit-sized arrays.

Ports from ``coregex_tpu/ops/span_chain.py``: ``_pad_pack`` (:42),
``line_event_words`` (:253-273), ``_line_cand_spans_jit`` (:343-418) as
the plain function ``line_cand_spans``, ``line_spans_candidates``
(:421-435), ``_floor_log2`` (:464), ``cummax_fast`` (:476),
``_word_lastpos_table`` (:494), ``_ctz32`` (:504), ``_word_nextpos_table``
(:515), ``inner_flag_arrays_words`` (:603), ``_fit_words`` (:694),
``bidi_ends`` (:703-761) and ``bidi_assemble`` (:766-804).  The JAX package computes these
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

Line shapes (``.*lit.*``, ``.*lit``, ``lit.*``, ``(?m)^P.*lit``): only the
literal's candidates compact; the newline words (and, anchored, the
line-start-with-prefix words) ride the chain as per-word payloads with
their last/next-position tables, and each candidate's line start and end
resolve from them.  One more compaction keeps the first (or last) valid
candidate of each line.
"""

from __future__ import annotations

import numpy as np
import torch

from .bytescan import _memmem_mask
from .compact2 import _bucket_up, compact_pay, pack_words, \
    sparse_chain_payloads
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


def _ctz32(v):
    """Lowest set-bit index of int32 words (-1 for 0)."""
    return _floor_log2(v & -v)


def _word_nextpos_table(bits_w, nw: int):
    """nextpos_w[i] = lowest set-bit POSITION strictly after word i
    (INT32_MAX if none): the mirror of _word_lastpos_table."""
    base = torch.arange(nw, dtype=torch.int32, device=bits_w.device) * 32
    low = torch.where(bits_w != 0, base + _ctz32(bits_w), _POS_BIG)
    incl = -torch.flip(cummax_fast(torch.flip(-low, [0]), -_POS_BIG), [0])
    return torch.cat([incl[1:], torch.full((1,), _POS_BIG, dtype=torch.int32,
                                          device=bits_w.device)])


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


# ---------------------------------------------------------------------------
# Line-shape family on the candidate chain
# ---------------------------------------------------------------------------

def _pad_pack(m, n: int):
    """Pack a [n] bool mask into words padded to the power-of-two word
    bucket; only the last partial word's bits are copied to pad them."""
    nw = _bucket_up(max(-(-n // 32), 1))
    full = n // 32
    out = torch.zeros(nw, dtype=torch.int32, device=m.device)
    if full:
        out[:full] = pack_words(m[:32 * full], full)
    if n > 32 * full:
        tail = torch.zeros(32, dtype=torch.bool, device=m.device)
        tail[:n - 32 * full] = m[32 * full:]
        out[full:full + 1] = pack_words(tail, 1)
    return out


def line_event_words(dev, lit, prefix, line_anchored: bool):
    """((newline words, candidate words[, line-start-with-prefix words]),
    (their counts as 0-dim device tensors))."""
    n = int(dev.shape[0])
    is_nl = dev == 10
    cand = _memmem_mask(dev, lit)
    outs = [_pad_pack(is_nl, n), _pad_pack(cand, n)]
    cnts = [is_nl.sum(dtype=torch.int32), cand.sum(dtype=torch.int32)]
    if line_anchored:
        is_ls = torch.ones(n, dtype=torch.bool, device=dev.device)
        is_ls[1:] = is_nl[:-1]
        if len(prefix):
            is_ls &= _memmem_mask(dev, prefix)
        outs.append(_pad_pack(is_ls, n))
        cnts.append(is_ls.sum(dtype=torch.int32))
    return tuple(outs), tuple(cnts)


def line_cand_spans(candw, nlw, lspw, n: int, nwb: int, cap: int,
                    mode: str, anchored: bool, k: int, plen: int):
    """Candidate-only line extraction: one chain over the candidate words
    with the newline (and anchored line-start-prefix) words and their
    position tables as payloads.  Returns (spans [cap, 2], match count,
    ok) as device tensors."""
    dev = candw.device
    pays = [nlw, _word_lastpos_table(nlw, nwb), _word_nextpos_table(nlw, nwb)]
    if anchored:
        pays += [lspw, _word_lastpos_table(lspw, nwb)]
    out = sparse_chain_payloads(candw, pays, _POS_BIG, cap)
    c_pos, nlw_i, lastnl_i, nextnl_i = out[:4]
    cnt, okc = out[-2], out[-1]
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    live = idx < cnt
    low = _table(LOW_MASK, candw)
    bitc = (c_pos & 31).long()
    below = low[bitc]                                 # bits < bitc
    word0 = c_pos & ~31
    v = nlw_i & below
    bol = torch.where(v != 0, word0 + _floor_log2(v), lastnl_i) + 1
    v2 = nlw_i & ~below                               # bits >= bitc
    eol = torch.where(v2 != 0, word0 + _ctz32(v2), nextnl_i)
    eol = torch.clamp(eol, max=n)    # the final unterminated line ends at n
    if anchored:
        lspw_i, lastlsp_i = out[4], out[5]
        v3 = lspw_i & low[bitc + 1]                   # bits <= bitc
        lsp_last = torch.where(v3 != 0, word0 + _floor_log2(v3), lastlsp_i)
        valid = live & (lsp_last == bol) & (c_pos >= bol + plen)
    else:
        valid = live
    if mode == "bol_to_last":
        # the LAST valid candidate of a line: its BOL is below every later
        # valid candidate's
        bolv = torch.where(valid, bol, _POS_BIG)
        nxtmin = -torch.flip(cummax_fast(torch.flip(-bolv, [0]), -_POS_BIG),
                             [0])
        nxtmin = torch.cat([nxtmin[1:], torch.full(
            (1,), _POS_BIG, dtype=torch.int32, device=dev)])
        keep = valid & (bol < nxtmin)
        s_v, e_v = bol, c_pos + k
    else:
        # the first valid candidate of a line
        bolv = torch.where(valid, bol, -1)
        prevmax = torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                        device=dev),
                             cummax_fast(bolv, -1)[:-1]])
        keep = valid & (bol > prevmax)
        s_v = c_pos if mode == "first_to_eol" else bol
        e_v = eol
    _, s_c, e_c, cntm, okc2 = compact_pay(keep, [s_v, e_v], cap)
    livem = idx < cntm
    ok = okc & okc2 & torch.where(livem, s_c < e_c, True).all()
    nxt = torch.cat([s_c[1:], torch.full((1,), _POS_BIG, dtype=torch.int32,
                                         device=dev)])
    ok = ok & torch.where(idx < cntm - 1, e_c <= nxt, True).all()
    e_c = torch.where(livem, e_c, s_c)
    s_c = torch.where(livem, s_c, n)
    return torch.stack([s_c, e_c], dim=1), cntm, ok


def line_spans_candidates(words, n: int, cap: int, mode: str,
                          anchored: bool, k: int, plen: int):
    """Line extraction from line_event_words' words (cap bounds the
    candidates).  Returns (spans [cap, 2], match count, ok) as device
    tensors."""
    nlw, candw = words[0], words[1]
    lspw = words[2] if anchored else candw
    nwb = _bucket_up(max(int(candw.shape[0]), 1))
    return line_cand_spans(_fit_words(candw, nwb), _fit_words(nlw, nwb),
                           _fit_words(lspw, nwb), n, nwb, cap, mode,
                           anchored, k, plen)
