"""Bidirectional span assembly on hit-sized arrays.

Ports from ``coregex_tpu/ops/span_chain.py``: ``_pad_pack`` (:42),
``line_event_words`` (:253-273), ``_line_cand_spans_jit`` (:343-418) and
``line_spans_candidates`` (:421-435) as ``_line_select`` and
``line_spans_pieces`` (in runs of candidates, the line choice carried),
``_floor_log2`` (:464), ``cummax_fast`` (:476),
``_word_lastpos_table`` (:494), ``_ctz32`` (:504), ``_word_nextpos_table``
(:515), ``inner_flag_arrays_words`` (:603), ``_fit_words`` (:694),
``bidi_ends`` (:703-761), ``bidi_assemble`` (:766-804), the class-run
producers ``class_run_words`` (:72) and ``class_run_masks_dense`` (:97),
``pair_spans_sparse`` with ``_pair_spans_jit`` (:966-994), and the nullable
fill ``_rune_boundaries`` (:835), ``nullable_fill_words`` (:866, as
``nullable_fill_range`` over a range of positions) and ``nullable_merge``
(:895, as ``nullable_merge_into``), and the literal producers ``literal_words``
(:63), ``multi_literal_words`` (:117), ``_ml_slice_words`` (:167),
``_ml_counts`` (:200), ``multi_literal_words_big`` (:206),
``literal_spans_sparse`` (:933-961), and the INNER candidate pipeline's
``_shift_words`` (:145), ``inner_cand_symbols`` (:529),
``inner_cand_arrays`` (:557), ``inner_flag_arrays`` (:583) and
``inner_assemble`` (:622-690).  ``leftmost_first_spans`` has no
counterpart: the reference hands overlapping literal hits to its host loop.
Its tail, ``chain_select``, is the chain walk of the reference's host
``go_select`` (meta/batch.py:122-144) on the device, which the general
find_all also runs; ``expand_class_runs`` is the reference's host split of
``{m,k}`` class runs (meta/batch.py:2060-2072) on the device.
The JAX package computes these in XLA outside any Pallas kernel; here they
are plain torch tensor code around the K4 compactions of
``sparse_chain_payloads``.  ``cumsum_i32_fast`` (:819) is an
XLA workaround; ``torch.cumsum`` is its natural form here.  ``_dev_i32``
(:945) caches device scalars to avoid host-to-device transfers; torch
passes host ints to its kernels as arguments, so it has no counterpart.

Forward: the span-event scan marks candidate match ends (flag words) and
each group's first flag; only first flags compact, and each group's end is
the last flag strictly before the next group's first flag.  Reverse: a
pre-reset flag scan over the flipped corpus, reset at the reversed ends;
each interval's last flag at or before the next reset is the match start.
Both sides keep int32 positions, so corpora must stay below 2^31 - 32
bytes (the caller checks).

Past the span limit (a result that one compaction may not hold) the
``*_pieces`` / ``*_into`` forms cut the chains into runs of whole words
(``compact2.word_pieces``), compact each run with a cap within the limit and
write its share of one output at its offset, positions absolute; a
selection that walks from one candidate to the next carries its state
across the seams (the last accepted end, a line's bol).  They have no
counterpart: the reference's device routes stop at its limit.

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

from .bytescan import _bucket, _class_mask_from_table, _memmem_mask, \
    _range_mask, mask_count
from .compact2 import _bucket_up, compact_pay, pack_words, \
    sparse_chain_payloads, sparse_positions_words, word_pieces
from .span_scan import LOW_MASK

# sparse-chain crossover (hits / n) of the reference (span_chain.py:39):
# below it the chain wins, above it callers take their dense single-level
# compactions
SPARSE_OK = 1.0 / 18

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


def bidi_ends_pieces(flagw, firstw, n: int, total: int, kind: int,
                     nwb: int, limit: int, ends):
    """bidi_ends past the span limit: the group words cut into runs of at
    most `limit` groups (word_pieces), one chain each; each group's end is
    the last flag before the next group's first flag, so a run's first
    group closes the previous run's last one.  The `total` ends go into
    `ends` (an int32 [total] view).  Returns (pieces, ok); raises when the
    groups do not add up to `total` (before writing past it)."""
    dev = flagw.device
    fw = _fit_words(flagw, nwb)
    gw = _fit_words(firstw, nwb)
    lastflag_w = _word_lastpos_table(fw, nwb)
    base = torch.arange(nwb, dtype=torch.int32, device=dev) * 32
    glob_f = torch.where(fw != 0, base + _floor_log2(fw), -1).max()
    del base
    low = _table(LOW_MASK, fw)
    extra = int(kind == _EOI_EXTRA)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    g = pieces = 0
    prev_f = None
    for w0, w1, c in word_pieces(gw, limit, total=total - extra):
        if c == 0:
            continue
        if g + c + extra > total:
            raise RuntimeError("bidirectional span assembly: more groups "
                               "than matches")
        f_pos, fwi, lfi, cnt, okE = sparse_chain_payloads(
            gw[w0:w1], [fw[w0:w1], lastflag_w[w0:w1]], _POS_BIG,
            _bucket(c, 16))
        f_pos, fwi, lfi = f_pos[:c] + 32 * w0, fwi[:c], lfi[:c]
        vf = fwi & low[(f_pos & 31).long()]          # bits strictly below
        lfb = torch.where(vf != 0, (f_pos & ~31) + _floor_log2(vf), lfi)
        ok = ok & okE & (cnt == c) & (lfb[1:] >= f_pos[:-1]).all()
        if g:
            ends[g - 1:g - 1 + c] = lfb
            ok = ok & (lfb[0] >= prev_f)
        else:
            ends[:c - 1] = lfb[1:]
        prev_f = f_pos[c - 1]
        g += c
        pieces += 1
    if g == 0 or g + extra != total or kind == _EOI_COMPLEX:
        raise RuntimeError("bidirectional span assembly failed its "
                           "consistency check")
    ends[g - 1] = n if kind == _EOI_EXTEND else glob_f
    ok = ok & (glob_f >= prev_f)
    if extra:
        ends[g] = n
    return pieces, ok


def reset_words(ends, n: int, nwb1: int):
    """bidi_ends' reset words from the match ends: bit n - e for each end
    e, over nwb1 words, _CHECK_ROWS ends at a time."""
    m = torch.zeros(nwb1 * 32, dtype=torch.bool, device=ends.device)
    for i in range(0, int(ends.shape[0]), _CHECK_ROWS):
        m[(n - ends[i:i + _CHECK_ROWS]).long()] = True
    return pack_words(m, nwb1)


def bidi_assemble_pieces(rw, fw_rev, n: int, nwb1: int, limit: int, out):
    """bidi_assemble past the span limit: the reset words cut into runs of
    at most `limit` resets, one chain each.  Reset j (reversed order) is
    forward match T - 1 - j; its start is the last reverse flag at or
    before reset j + 1, so a run's first reset gives the previous run's
    last start.  Fills out[:, 0] (the starts) and checks out[:, 1] (the
    forward ends) against the resets.  Returns (pieces, ok)."""
    dev = rw.device
    T = int(out.shape[0])
    flagw_r, lastflag_r, glob = inner_flag_arrays_words(
        _fit_words(fw_rev, nwb1), nwb1)
    low = _table(LOW_MASK, rw)
    s_col, e_col = out[:, 0], out[:, 1]
    ok = torch.ones((), dtype=torch.bool, device=dev)
    j = pieces = 0
    prev_r = None
    for w0, w1, c in word_pieces(rw, limit, total=T):
        if c == 0:
            continue
        if j + c > T:
            raise RuntimeError("bidirectional span assembly: more resets "
                               "than matches")
        r_pos, fwi, lfi, cnt, okR = sparse_chain_payloads(
            rw[w0:w1], [flagw_r[w0:w1], lastflag_r[w0:w1]], n + 1,
            _bucket(c, 16))
        r_pos, fwi, lfi = r_pos[:c] + 32 * w0, fwi[:c], lfi[:c]
        vf = fwi & low[(r_pos & 31).long() + 1]       # bits 0..bit
        lfab = torch.where(vf != 0, (r_pos & ~31) + _floor_log2(vf), lfi)
        ok = ok & okR & (cnt == c) & (lfab[1:] > r_pos[:-1]).all()
        ok = ok & (e_col[T - j - c:T - j].flip(0) == n - r_pos).all()
        t0 = 1 if j == 0 else 0
        if j:
            ok = ok & (lfab[0] > prev_r)
        s_col[T - j - c + 1:T - j - t0 + 1] = (n - lfab[t0:]).flip(0)
        prev_r = r_pos[c - 1]
        j += c
        pieces += 1
    if j != T:
        raise RuntimeError("bidirectional span assembly failed its "
                           "consistency check")
    s_col[0] = n - glob
    return pieces, ok & (glob > prev_r) & spans_ok(out)


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


def _line_tables(nlw, lspw, nwb: int, anchored: bool):
    """The per-word payloads of the candidate chain: the newline words
    with their last/next-position tables (and, anchored, the
    line-start-with-prefix words with theirs)."""
    pays = [nlw, _word_lastpos_table(nlw, nwb), _word_nextpos_table(nlw, nwb)]
    if anchored:
        pays += [lspw, _word_lastpos_table(lspw, nwb)]
    return pays


def _line_select(candw, pays, n: int, cap: int, mode: str, anchored: bool,
                 k: int, plen: int, base: int = 0, carry=None):
    """One chain over candidate words `candw` (word 0 at position `base`)
    with the per-word payloads of _line_tables for the same words: (keep,
    span starts, span ends, ok, carry) over cap slots, keep marking the
    candidate each line keeps.  `carry` is a 0-dim int32 device tensor of
    the candidates on the other side of this run: the largest valid bol
    before it (first modes), the smallest after it ("bol_to_last"); None
    when there are none.  The carry returned adds this run's."""
    dev = candw.device
    out = sparse_chain_payloads(candw, pays, _POS_BIG, cap)
    c_pos, nlw_i, lastnl_i, nextnl_i = out[:4]
    cnt, okc = out[-2], out[-1]
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    live = idx < cnt
    if base:
        c_pos = torch.where(live, c_pos + base, c_pos)
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
        tail = (torch.full((1,), _POS_BIG, dtype=torch.int32, device=dev)
                if carry is None else carry.reshape(1))
        # the carry reaches every live slot, not only the last of cap
        nxtmin = torch.minimum(torch.cat([nxtmin[1:], tail]), tail)
        keep = valid & (bol < nxtmin)
        carry = torch.minimum(tail[0], bolv.min())
        s_v, e_v = bol, c_pos + k
    else:
        # the first valid candidate of a line
        bolv = torch.where(valid, bol, -1)
        head = (torch.full((1,), -1, dtype=torch.int32, device=dev)
                if carry is None else carry.reshape(1))
        prevmax = torch.maximum(
            torch.cat([head, cummax_fast(bolv, -1)[:-1]]), head)
        keep = valid & (bol > prevmax)
        carry = torch.maximum(head[0], bolv.max())
        s_v = c_pos if mode == "first_to_eol" else bol
        e_v = eol
    return keep, s_v, e_v, okc, carry


def line_spans_pieces(words, n: int, cand_total: int, limit: int,
                      mode: str, anchored: bool, k: int, plen: int):
    """Candidate-only line extraction (ref. line_spans_candidates) from
    line_event_words' words: one chain over the candidate words with the
    newline (and anchored line-start-prefix) words and their position
    tables as payloads (_line_tables), then one compaction of the kept
    candidates; past `limit` candidates the candidate words are cut into
    runs of at most `limit` (word_pieces), one chain and one compaction
    each, the line choice carried across the seams
    (_line_select's carry): forward for the first candidate of a line,
    backward for the last ("bol_to_last"), whose runs go from the last.
    Each run's spans are kept at their own size (a line keeps one span of
    its many candidates) and joined in order.  Returns (spans [count, 2],
    count, ok, pieces); one sync a run."""
    nlw, candw = words[0], words[1]
    lspw = words[2] if anchored else candw
    nwb = _bucket_up(max(int(candw.shape[0]), 1))
    candw, nlw, lspw = (_fit_words(w, nwb) for w in (candw, nlw, lspw))
    pays = _line_tables(nlw, lspw, nwb, anchored)
    dev = candw.device
    backward = mode == "bol_to_last"
    runs = word_pieces(candw, limit, total=cand_total)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    carry, parts = None, []
    for w0, w1, c in (reversed(runs) if backward else runs):
        if c == 0:
            continue
        cap = _bucket(c, 16)
        keep, s_v, e_v, okc, carry = _line_select(
            candw[w0:w1], [p[w0:w1] for p in pays], n, cap, mode, anchored,
            k, plen, 32 * w0, carry)
        _, s_c, e_c, cntm, okk = compact_pay(keep, [s_v, e_v], cap)
        del keep, s_v, e_v
        m = int(cntm)
        ok = ok & okc & okk
        parts.append(torch.stack([s_c[:m], e_c[:m]], dim=1))
        del s_c, e_c
    if backward:
        parts.reverse()
    spans = (parts[0] if len(parts) == 1 else torch.cat(parts)) if parts \
        else torch.empty((0, 2), dtype=torch.int32, device=dev)
    return spans, int(spans.shape[0]), ok & spans_ok(spans), len(parts)


# ---------------------------------------------------------------------------
# The INNER candidate pipeline (class-run prefix, literal, suffix)
# ---------------------------------------------------------------------------

def _u32_to_i32(x):
    """int64 values in [0, 2^32) -> the int32 words with those bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _shift_words(win, k: int, out_len: int):
    """[out_len] words holding bit p + k for each bit p of `win` (ref.
    :145-165, its uint32 logical shifts through int64)."""
    dev = win.device
    wu = win.to(torch.int64) & 0xFFFFFFFF
    woff, bs = k // 32, k % 32
    out = torch.zeros(out_len, dtype=torch.int32, device=dev)
    a = _u32_to_i32((wu << bs) & 0xFFFFFFFF)
    m = max(0, min(int(a.shape[0]), out_len - woff))
    out[woff:woff + m] = a[:m]
    if bs:
        b = _u32_to_i32(wu >> (32 - bs))
        m = max(0, min(int(b.shape[0]), out_len - woff - 1))
        out[woff + 1:woff + 1 + m] |= b[:m]
    return out


def _inner_masks(dev, ranges, lit, m: int):
    """(member [n], candidates [n]) of an INNER plan's class-run prefix:
    the literal's hits with at least m members right before them and
    room for a reset bit after them (c + k < n: a non-empty suffix cannot
    match at the end)."""
    n = int(dev.shape[0])
    k = len(lit)
    member = _range_mask(dev, ranges)
    valid = _memmem_mask(dev, lit)
    for j in range(1, m + 1):
        if j < n:
            valid[j:] &= member[:-j]
        valid[:min(j, n)] = False
    valid[max(0, n - k):] = False
    return member, valid


def _inner_words(member, valid, n: int):
    nwb = _bucket_up(max(-(-n // 32), 1))
    candw = _pad_pack(valid, n)
    mw = _pad_pack(member, n)
    lastnm_w = _word_lastpos_table(_pad_pack(~member, n), nwb)
    return candw, mw, lastnm_w


def inner_cand_arrays(dev, ranges, lit, m: int):
    """(candw, mw, lastnm_w, rmask [n] bool, candidate count) (ref.
    :557-580): the candidate words, the member words and each word's last
    nonmember position before it, and the reset mask (each candidate + k,
    where the suffix's anchored run starts)."""
    n = int(dev.shape[0])
    k = len(lit)
    member, valid = _inner_masks(dev, ranges, lit, m)
    rmask = torch.zeros(n, dtype=torch.bool, device=dev.device)
    if k < n:
        rmask[k:] = valid[:-k]
    return (*_inner_words(member, valid, n), rmask, mask_count(valid))


def inner_cand_symbols(dev, ranges, lit, m: int, bounds):
    """inner_cand_arrays fused with the suffix flag scan's symbol build
    (ref. :529-554): (candw, mw, lastnm_w, symbols uint8 [n + 32] of
    2 * segment + reset, candidate count)."""
    n = int(dev.shape[0])
    k = len(lit)
    member, valid = _inner_masks(dev, ranges, lit, m)
    sym = torch.zeros(n + 32, dtype=torch.uint8, device=dev.device)
    for b in bounds:
        sym[:n] += (dev >= b).to(torch.uint8)
    sym[:n] *= 2
    if k < n:
        sym[k:n] += valid[:n - k].to(torch.uint8)
    return (*_inner_words(member, valid, n), sym, mask_count(valid))


def inner_flag_arrays(flag, eoi_flag):
    """(flagw over the [n + 1] domain, lastflag_w, global last flag) from
    a suffix scan's per-position flags and its EOI acceptance (ref.
    :583-598)."""
    n = int(flag.shape[0])
    flag1 = torch.cat([flag, torch.as_tensor(eoi_flag, dtype=torch.bool,
                                             device=flag.device).reshape(1)])
    nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
    return inner_flag_arrays_words(_pad_pack(flag1, n + 1), nwb1)


def reset_interval_ends(flagw, resets, n: int):
    """The end of the anchored run from each reset: the last flag strictly
    inside (r_i, r_{i+1}) (past the last reset, the last flag of all), or
    -1 where that interval holds no flag.  `flagw`: position-major flag
    words of a reset scan over at least n + 1 positions (bits past n are
    ignored); `resets` [c] int32 ascending.  The reference's
    ``_interleaved_ends`` (meta/batch.py:1232-1244) finds these with corpus
    -sized running minima; here each reset reads its word and the words'
    last-flag table, as ``inner_assemble`` does."""
    if int(resets.shape[0]) == 0:
        return resets.clone()
    nw = int(flagw.shape[0])
    base = torch.arange(nw, dtype=torch.int64, device=flagw.device) * 32
    fw = flagw & _table(LOW_MASK, flagw)[(n + 1 - base).clamp(0, 32)]
    lastflag_w = _word_lastpos_table(fw, nw)
    top = torch.where(fw != 0, base.to(torch.int32) + _floor_log2(fw), -1)
    w = (resets >> 5).long()
    vf = fw[w] & _table(LOW_MASK, fw)[(resets & 31).long()]
    lf = torch.where(vf != 0, (resets & ~31) + _floor_log2(vf), lastflag_w[w])
    ends = torch.cat([lf[1:], top.max().reshape(1)])
    return torch.where(ends > resets, ends, -1)


def inner_assemble(c_pos, mw_i, lastnm_i, r_pos, flagw_i, lastflag_i,
                   cntA, cntB, okAB, glob_lf, conv, interf, n: int,
                   cap: int, k: int, m: int, M: int, b_empty: bool = False,
                   fixed_ends=None):
    """Per candidate (smin, smax, end) from the chained payloads, the
    flexible Go selection (span_kernels.go_select_flex's rounds) and one
    K4 compaction of the selected spans (ref. :622-690).  smin: after the
    last nonmember before the candidate (at most M members back); smax:
    m members back; end: the suffix's last flag strictly inside (r_i,
    r_{i+1}), the global last flag (with the EOI bit at n) for the last
    candidate.  b_empty: no suffix, every candidate verified with
    `fixed_ends`.  Returns (spans [cap, 2], selected count, ok)."""
    from .span_kernels import _go_select_flex_round
    d = c_pos.device
    low = _table(LOW_MASK, c_pos)
    idx = torch.arange(cap, dtype=torch.int32, device=d)
    live = idx < cntA
    v = (~mw_i) & low[(c_pos & 31).long()]
    lastnm = torch.where(v != 0, (c_pos & ~31) + _floor_log2(v), lastnm_i)
    smin = lastnm + 1
    if M != -1:
        smin = torch.maximum(smin, c_pos - M)
    smax = c_pos - m
    if b_empty:
        ends = fixed_ends
        verified = live
    else:
        vf = flagw_i & low[(r_pos & 31).long()]
        lf_here = torch.where(vf != 0, (r_pos & ~31) + _floor_log2(vf),
                              lastflag_i)
        ends = torch.cat([lf_here[1:], lf_here.new_zeros(1)])
        ends = torch.where(idx == cntA - 1, glob_lf, ends)
        verified = live & (ends > r_pos)
    smax_sel = torch.where(verified, smax, -2)
    sel, stable, starts = _go_select_flex_round(smin, smax_sel, ends,
                                                verified, 24)
    sel = sel & verified
    _, s_c, e_c, nsel, okc = compact_pay(sel, [starts, ends], cap)
    livem = idx < nsel
    e_c = torch.where(livem, e_c, s_c)
    s_c = torch.where(livem, s_c, n)
    ok = okAB & okc & stable & (cntA == cntB) & conv & ~interf
    return torch.stack([s_c, e_c], dim=1), nsel, ok


# ---------------------------------------------------------------------------
# Class runs
# ---------------------------------------------------------------------------

def class_run_masks_dense(dev, ranges, mmin: int):
    """(smask, emask) [n] bool: the first and the LAST member position of
    each maximal run of the class of length >= mmin."""
    mask = _range_mask(dev, ranges)
    n = int(mask.shape[0])
    smask = mask.clone()
    smask[1:] &= ~mask[:-1]
    emask = mask.clone()
    emask[:-1] &= ~mask[1:]
    if mmin > 1:
        # a run start needs mmin members from it on, a run end mmin
        # members up to it
        ok_fwd = mask.clone()
        ok_bwd = mask.clone()
        for j in range(1, mmin):
            s = min(j, n)
            ok_fwd[:n - s] &= mask[s:]
            ok_fwd[n - s:] = False
            ok_bwd[s:] &= mask[:n - s]
            ok_bwd[:s] = False
        smask &= ok_fwd
        emask &= ok_bwd
    return smask, emask


def class_run_words(dev, ranges, mmin: int):
    """(start words, end words, start count, end count) of the class runs
    of class_run_masks_dense, packed to the power-of-two word bucket for
    the sparse chain."""
    n = int(dev.shape[0])
    smask, emask = class_run_masks_dense(dev, ranges, mmin)
    return (_pad_pack(smask, n), _pad_pack(emask, n), mask_count(smask),
            mask_count(emask))


def pair_spans_sparse(words_s, words_e, ns: int, ne: int, cap: int,
                      end_adjust: int = 0, dense: bool = False,
                      take: int = -1):
    """Two chains zipped into spans: (spans [cap, 2], count, ok).  ns / ne
    are the mask domains (their positions' sentinels); end_adjust is added
    to live ends (a class run's end words mark its LAST member).  ok
    checks both chains, equal counts, start < end and end <= next
    start.  dense=True compacts the unpacked masks with K4 instead of the
    chains (word_positions).  With take >= 0 only the first take pairs are
    wanted (cap >= take): the truncated compactions keep the first cap
    positions and count at least min(total, cap) of them, so ok then
    checks those pairs and that both counts reach take, and the count
    returned is only a lower bound of the total."""
    starts, cs, ok1 = word_positions(words_s, ns, cap, dense)
    ends, ce, ok2 = word_positions(words_e, ne, cap, dense)
    idx = torch.arange(cap, dtype=torch.int32, device=starts.device)
    n_live = cs if take < 0 else cs.clamp(max=take)
    live = idx < n_live
    if end_adjust:
        ends = torch.where(live, ends + end_adjust, ends)
    ok = (ok1 & ok2 & (cs == ce) if take < 0
          else (cs >= take) & (ce >= take))
    ok = ok & torch.where(live, starts < ends, True).all()
    nxt = torch.cat([starts[1:], torch.full((1,), _POS_BIG,
                                            dtype=torch.int32,
                                            device=starts.device)])
    ok = ok & torch.where(idx < n_live - 1, ends <= nxt, True).all()
    ends = torch.where(live, ends, starts)
    return torch.stack([starts, ends], dim=1), cs, ok


# rows a check over a pieced span array reads at once
_CHECK_ROWS = 1 << 26
# the smallest cap at which word_positions' chain could pass 2^31 entries
_CHAIN_CAP = 1 << 28


def spans_ok(spans, strict: bool = True):
    """Device bool: every row of `spans` [T, 2] is ordered (start < end,
    or <= when not strict) and ends at or before the next row starts;
    read _CHECK_ROWS rows at a time, so its transients stay bounded."""
    T = int(spans.shape[0])
    ok = torch.ones((), dtype=torch.bool, device=spans.device)
    for i in range(0, T, _CHECK_ROWS):
        j = min(T, i + _CHECK_ROWS)
        s, e = spans[i:j, 0], spans[i:j, 1]
        ok = ok & ((s < e) if strict else (s <= e)).all()
        nxt = spans[i + 1:j + 1, 0]
        ok = ok & (e[:int(nxt.shape[0])] <= nxt).all()
    return ok


def word_positions_into(words, n: int, out, limit: int, dense: bool = False,
                        take: int = -1, total: int = -1):
    """Set-bit positions of bucket-padded words over the [n] domain,
    ascending, written into `out` (an int32 1-D view, a span column among
    them): the first `take` (all when take < 0), in runs of whole words
    of at most `limit` positions (word_pieces), each one word_positions
    with a cap of at most _bucket(max(limit, 32)).  `total`, where the
    caller knows it, is the words' set bits (word_pieces).  Returns
    (positions written, pieces, ok)."""
    off = pieces = 0
    ok = torch.ones((), dtype=torch.bool, device=words.device)
    for w0, w1, cf in word_pieces(words, limit, take, total):
        c = cf if take < 0 else min(cf, take - off)
        if c <= 0:
            continue
        base = 32 * w0
        pos, cnt, okp = word_positions(words[w0:w1], min(n, 32 * w1) - base,
                                       _bucket(cf, 16), dense)
        ok = ok & okp & (cnt == cf)
        out[off:off + c] = pos[:c] + base
        off += c
        pieces += 1
    return off, pieces, ok


def pair_spans_pieces(words_s, words_e, ns: int, ne: int, total: int,
                      limit: int, end_adjust: int = 0, dense: bool = False,
                      take: int = -1):
    """pair_spans_sparse past the span limit: `total` starts zipped with
    as many ends, the first `take` pairs when take >= 0, each column
    compacted in pieces (word_positions_into) into one [count, 2] array.
    Returns (spans, ok, pieces)."""
    T = total if take < 0 else min(total, take)
    out = torch.empty((T, 2), dtype=torch.int32, device=words_s.device)
    cs, ps, ok1 = word_positions_into(words_s, ns, out[:, 0], limit, dense,
                                      T, total)
    ce, pe, ok2 = word_positions_into(words_e, ne, out[:, 1], limit, dense,
                                      T, total)
    if end_adjust:
        out[:, 1] += end_adjust
    ok = ok1 & ok2 & spans_ok(out) & (cs == T) & (ce == T)
    if take < 0 and T > limit:
        # one piece counted every end bit; pieces cut at the T-th do not
        ok = ok & (popcount_sum(words_e) == T)
    return out, ok, max(ps, pe)


# ---------------------------------------------------------------------------
# Literals and literal sets
# ---------------------------------------------------------------------------
# The fused set producer holds, beside the corpus, about 6 transient bytes
# per corpus byte: the start and end masks, one literal's hit and win masks
# with a compare temporary, then packing's int64 product and its shift.
# MULTI_FUSED_LIMIT = 1 GiB keeps that at 6 GiB, under a tenth of an 80 GB
# card, beside the resident corpus and other engines' tiles; past it,
# slices of _ML_SEG = 256 MiB hold 1.5 GiB whatever the corpus.  The
# reference (span_chain.py:141-142, sized for a 16 GB chip) also shrinks
# its slices as J grows, since XLA fuses all J literals' transients into
# one program; eager torch frees each literal's compares before the next,
# so the slice does not depend on J here.
MULTI_FUSED_LIMIT = 1 << 30
_ML_SEG = 256 * 1024 * 1024


def unpack_words(words, n: int):
    """Bucket-padded int32 words -> [n] bool mask (bit j of word i is entry
    32i + j): each byte of the little-endian words shifted by 0..7."""
    b = words.contiguous().view(torch.uint8)[:-(-n // 8)]
    sh = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((b[:, None] >> sh) & 1).reshape(-1)[:n].view(torch.bool)


def word_positions(words, n: int, cap: int, dense: bool):
    """Set-bit positions of bucket-padded words over the [n] domain:
    (pos [cap] padded with n, count, ok).  The sparse chain, or, when
    `dense`, one K4 compaction of the unpacked mask (the reference's dense
    branches compact their rebuilt masks).  The chain's last level holds 8
    bits of each of up to min(4 words, cap) live bytes, which passes a
    compaction's 2^31 entries from cap 2^28 on: such caps take the mask."""
    if dense or cap >= _CHAIN_CAP:
        return compact_pay(unpack_words(words, n), (), cap)
    return sparse_positions_words(words, n, cap)


def popcount_sum(words):
    """Set bits of int32 words as a 0-dim int32 tensor: a SWAR popcount of
    each byte (uint8, so shifts are logical and nothing overflows)."""
    b = words.contiguous().view(torch.uint8)
    x = b - ((b >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return ((x + (x >> 4)) & 0x0F).sum(dtype=torch.int32)


def literal_words(dev, lit):
    """(start words bucket-padded over [n], hit count) of a literal (ref.
    span_chain.py:63-68)."""
    m = _memmem_mask(dev, lit)
    return _pad_pack(m, int(dev.shape[0])), mask_count(m)


def multi_literal_words(dev, lits):
    """(start words over [n], end words over [n+1], start count, end count)
    of a literal set (ref. span_chain.py:117-133): starts are every hit;
    at a start the first-listed literal wins, and its end is set."""
    n = int(dev.shape[0])
    seen = torch.zeros(n, dtype=torch.bool, device=dev.device)
    emask = torch.zeros(n + 1, dtype=torch.bool, device=dev.device)
    for lit in lits:
        k = len(lit)
        if k > n:
            continue
        hit = _memmem_mask(dev, lit)
        emask[k:] |= (hit & ~seen)[:n + 1 - k]
        seen |= hit
        del hit
    return (_pad_pack(seen, n), _pad_pack(emask, n + 1), mask_count(seen),
            mask_count(emask))


def _ml_slice_words(ext, lits, lead: int, emit_n: int):
    """Start and end words of emit positions [lead, lead + emit_n) of the
    extended slice `ext` (ref. span_chain.py:167-196); emit_n is a
    multiple of 32."""
    m = int(ext.shape[0])
    seen = torch.zeros(m, dtype=torch.bool, device=ext.device)
    emask = torch.zeros(emit_n, dtype=torch.bool, device=ext.device)
    for lit in lits:
        hit = _memmem_mask(ext, lit)
        win = hit & ~seen
        seen |= hit
        # end bit j <- win at local j + lead - k
        lo = lead - len(lit)
        a, b = max(lo, 0), min(lo + emit_n, m)
        if a < b:
            emask[a - lo:b - lo] |= win[a:b]
        del hit, win
    smask = torch.zeros(emit_n, dtype=torch.bool, device=ext.device)
    t = min(emit_n, m - lead)
    smask[:t] = seen[lead:lead + t]
    nw = emit_n // 32
    return pack_words(smask, nw), pack_words(emask, nw)


def _ml_counts(seen_w, ew):
    """(start count, end count) of the segmented words (ref. :200-203)."""
    return popcount_sum(seen_w), popcount_sum(ew)


def multi_literal_words_big(dev, lits):
    """multi_literal_words in slices of _ML_SEG bytes (ref.
    span_chain.py:206-240), both word arrays padded to the [n+1] bucket.
    Exact: the only cross-position state, priority, is per position.  A
    slice reads kmax bytes before it, where the reference reads kmax - 1
    and so drops the end of a longest literal that ends on a slice seam
    (it then finds fewer ends than starts and hands the call to its host
    loop)."""
    n = int(dev.shape[0])
    kmax = max(len(x) for x in lits)
    seg = max(32, _ML_SEG - _ML_SEG % 32)
    ws, we = [], []
    a = 0
    while a < n:
        b = min(a + seg, n)
        lo, hi = max(0, a - kmax), min(n, b + kmax - 1)
        emit = b - a if b < n else n + 1 - a
        sw, ew = _ml_slice_words(dev[lo:hi], lits, a - lo,
                                 -(-emit // 32) * 32)
        ws.append(sw)
        we.append(ew)
        a = b
    nwb1 = _bucket_up(max(-(-(n + 1) // 32), 1))
    ws = _fit_words(torch.cat(ws), nwb1)
    we = _fit_words(torch.cat(we), nwb1)
    return (ws, we, *_ml_counts(ws, we))


def literal_spans_sparse(words, n: int, cap: int, k: int,
                         dense: bool = False):
    """Positions plus the fixed length k: (spans [cap, 2], count, ok) of a
    literal whose hits do not overlap (ref. span_chain.py:933-961).
    dense=True takes K4 over the unpacked mask instead of the chain."""
    starts, cnt, ok = word_positions(words, n, cap, dense)
    live = torch.arange(cap, dtype=torch.int32, device=words.device) < cnt
    ends = torch.where(live, starts + k, starts)
    return torch.stack([starts, ends], dim=1), cnt, ok


def literal_lengths(dev, starts, cnt, lits, cap: int):
    """The length of the first-listed literal of `lits` that matches at
    each of the cnt hit `starts` [cap] (0 past cnt), one gather per
    literal byte; ok checks that every hit has one."""
    n = int(dev.shape[0])
    live = torch.arange(cap, dtype=torch.int32, device=dev.device) < cnt
    length = torch.zeros(cap, dtype=torch.int32, device=dev.device)
    for lit in reversed(lits):      # earlier literals overwrite later ones
        hit = live & (starts <= n - len(lit))
        for i, byte in enumerate(lit):
            at = dev.index_select(0, (starts + i).clamp_(max=n - 1))
            hit &= at == byte
        length = torch.where(hit, len(lit), length)
    del at, hit
    return length, torch.where(live, length > 0, True).all()


def leftmost_first_spans(dev, starts, cnt, lits, cap: int):
    """Go's leftmost-first matches of a literal set from ALL its hits,
    overlapping or not: (spans [cap, 2] with [n, n] past the count, count,
    ok).  `starts` [cap] are the hit positions ascending (n past `cnt`).
    The first-listed literal that matches at a start wins
    (``literal_lengths``), and ``chain_select`` keeps Go's matches among
    the hits.  Every array is int32 or bool of cap (+ 1) entries, about 30
    bytes per cap slot live at once with `starts` (BatchEngine's
    span-limit note)."""
    n = int(dev.shape[0])
    length, ok = literal_lengths(dev, starts, cnt, lits, cap)
    # a dead hit (start n, length 0) ends at n
    spans, total, ok_c = chain_select(starts, starts + length, cnt, n, cap)
    return spans, total, ok & ok_c


def chain_select(starts, ends, cnt, n: int, cap: int):
    """Go's leftmost-first selection over candidate matches that are never
    empty (the chain walk of the reference's ``go_select``,
    meta/batch.py:122-144): `starts` [cap] ascending and distinct, n past
    `cnt`; `ends` [cap] the match end of each start, n past `cnt`.  A match
    [s, e) hands over to the first start at or after e (`searchsorted`);
    the matches are the chain of those links from start 0, marked by
    pointer doubling in bit_length(cap) rounds of a scatter and a gather;
    one K4 compaction collects them.  Returns (spans [cap, 2] with [n, n]
    past the count, count, ok): ok is K4's."""
    d = starts.device
    own = torch.arange(cap + 1, dtype=torch.int32, device=d)
    live = own[:cap] < cnt
    ext = torch.cat([starts, own.new_full((1,), n)])
    # a link from the last match, or from a dead start (end n), leads to a
    # node at or past cnt; node cap loops on itself
    jump = torch.cat([torch.searchsorted(ext, ends, out_int32=True),
                      own[cap:]])
    del ext
    mark = torch.zeros(cap + 1, dtype=torch.int32, device=d)
    mark[0] = 1
    for _ in range(cap.bit_length()):
        # marked: next^t(0) for t < 2^r, and jump = next^(2^r).  A link
        # past the last start pushes its node onto itself, so the marked
        # nodes' pushes meet at no common target (no atomic contention)
        tgt = torch.where(jump < cnt, jump, own)
        mark |= torch.zeros_like(mark).index_add_(0, tgt, mark)
        jump = jump.index_select(0, jump)
    del tgt, jump
    keep = live & (mark[:cap] != 0)
    del mark, live
    s_c, e_c, total, ok_c = compact_pay(keep, [starts, ends], cap)[1:]
    del keep
    dead = own[:cap] >= total
    s_c.masked_fill_(dead, n)
    e_c.masked_fill_(dead, n)
    return torch.stack([s_c, e_c], dim=1), total, ok_c


def chain_select_pieces(pieces, n: int, out):
    """Go's leftmost-first selection (chain_select) over candidate matches
    that come in pieces: `pieces` yields (starts, ends) int32 device
    tensors, starts ascending and distinct, each piece's after the
    previous one's, no match empty.  The next match begins at the first
    start at or after the previous match's end, so each piece begins its
    chain at its first start at or after the end carried from the pieces
    before it (the state the reference's go_select carries in its one
    pass); a piece whose matches from there are disjoint keeps them all.
    The selected spans go to `out` in order.  Returns (count, ok); one
    sync a piece for the disjoint test (and the chain's total where
    matches overlap), one more for where the carried end falls in each
    piece after the first that kept spans."""
    off = 0
    ok = torch.ones((), dtype=torch.bool, device=out.device)
    for st, en in pieces:
        f = 0
        if off:
            f = int(torch.searchsorted(st, out[off - 1:off, 1])[0])
        c = int(st.shape[0]) - f
        if c <= 0:
            continue
        st, en = st[f:], en[f:]
        if bool((en[:-1] <= st[1:]).all()):
            out[off:off + c, 0] = st
            out[off:off + c, 1] = en
            t = c
        else:
            cap = _bucket(c, 16)
            stp = torch.full((cap,), n, dtype=torch.int32, device=st.device)
            enp = torch.full((cap,), n, dtype=torch.int32, device=st.device)
            stp[:c] = st
            enp[:c] = en
            spans, total, ok_c = chain_select(stp, enp, c, n, cap)
            del stp, enp
            t = int(total)
            ok = ok & ok_c
            out[off:off + t] = spans[:t]
        off += t
    return off, ok


def expand_class_runs(runs, mn: int, mx: int, n: int, limit: int = -1):
    """The matches of [class]{mn,mx} (mx = -1: no upper bound) in the
    maximal class runs `runs` [r, 2] (each of length >= mn): a run of length
    L holds L // mx + (L % mx >= mn) matches, greedy mx-chunks from its
    start and the remainder when it reaches mn, or one match of the whole
    run when mx = -1 (the reference's host split,
    meta/batch.py:2060-2072).  Expanded on the device: match g lies in the
    run whose running total first passes g, at index g - (the totals
    before it) in that run, a searchsorted of _CHECK_ROWS matches at a
    time, so a run of any length expands in bounded memory; one sync for
    the total.  Returns (spans [count, 2], count), at most `limit` matches
    when limit >= 0."""
    d = runs.device
    s, e = runs[:, 0], runs[:, 1]
    if mx < 0:
        per = torch.ones_like(s)
    else:
        L = e - s
        per = L // mx + (L % mx >= mn).to(torch.int32)
    cum = torch.cumsum(per, 0, dtype=torch.int64)
    every = int(cum[-1]) if int(cum.shape[0]) else 0
    total = every if limit < 0 else min(every, limit)
    out = torch.empty((total, 2), dtype=torch.int32, device=d)
    for i in range(0, total, _CHECK_ROWS):
        j = min(total, i + _CHECK_ROWS)
        g = torch.arange(i, j, dtype=torch.int64, device=d)
        run = torch.searchsorted(cum, g, right=True)
        if mx < 0:
            out[i:j] = runs[run]
            continue
        q = (g - (cum[run] - per[run])).to(torch.int32)
        st = s[run] + q * mx
        out[i:j, 0] = st
        out[i:j, 1] = torch.minimum(st + mx, e[run])
    return out, total


# ---------------------------------------------------------------------------
# Nullable fill-in
# ---------------------------------------------------------------------------
# FindAll(R) = FindAll(core) + an empty match at every Go rune boundary not
# covered by a core span and not equal to a core span's end (the
# factorization of meta/nullable.py, host twin fill_empties).

def _rune_boundaries(dev, n: int):
    """[n+1] bool twin of meta/nullable.py:rune_boundary_mask: position p
    is a boundary unless a valid 2-, 3- or 4-byte UTF-8 sequence started
    before p runs past it (callers gate n >= 4)."""
    d = dev
    pad = torch.cat([d, torch.zeros(3, dtype=d.dtype, device=d.device)])
    cont = (pad & 0xC0) == 0x80
    s2 = pad[1:n + 1]
    c2, c3, c4 = cont[1:n + 1], cont[2:n + 2], cont[3:n + 3]
    two = (d >= 0xC2) & (d <= 0xDF) & c2
    three = (((d == 0xE0) & (s2 >= 0xA0) & (s2 <= 0xBF))
             | ((d >= 0xE1) & (d <= 0xEC) & c2)
             | ((d == 0xED) & (s2 >= 0x80) & (s2 <= 0x9F))
             | ((d >= 0xEE) & (d <= 0xEF) & c2)) & c3
    four = (((d == 0xF0) & (s2 >= 0x90) & (s2 <= 0xBF))
            | ((d >= 0xF1) & (d <= 0xF3) & c2)
            | ((d == 0xF4) & (s2 >= 0x80) & (s2 <= 0x8F))) & c3 & c4
    t = torch.ones(3, dtype=torch.bool, device=d.device)
    b1 = torch.cat([t[:1], ~(two | three | four)])
    m3 = torch.cat([t[:2], ~(three | four)[:n - 1]])
    m4 = torch.cat([t, ~four[:n - 2]])
    return b1 & m3 & m4


def nullable_class_masks(dev, table):
    """(smask, emask) [n+1] bool of a nullable pattern whose core is
    [class]+, on an ASCII corpus: starts are run starts and accepted
    empties, ends are exclusive run ends and the same empties.  An empty
    match sits at every position that is neither a member nor a run's
    exclusive end (ref. batch.py:615-624)."""
    n = int(dev.shape[0])
    member = torch.zeros(n + 1, dtype=torch.bool, device=dev.device)
    member[:n] = _class_mask_from_table(dev, table)
    prev = torch.zeros_like(member)
    prev[1:] = member[:-1]
    runend1 = prev & ~member
    empties = ~(member | runend1)
    return (member & ~prev) | empties, runend1 | empties


def rune_boundaries_range(dev, a: int, b: int):
    """_rune_boundaries of positions [a, b) of the [n+1] domain (n >= 4):
    a position's verdict reads the three bytes before it and the
    continuation bytes of a sequence that starts there, so the slice
    three bytes wider on either side gives it."""
    n = int(dev.shape[0])
    lo, hi = max(0, a - 3), min(n, b + 3)
    m = _rune_boundaries(dev[lo:hi], hi - lo)
    return m if (lo, hi, b) == (a, n, n + 1) else m[a - lo:b - lo].clone()


def nullable_fill_range(dev, a: int, b: int, S, E, ends, ascii_only: bool):
    """The empty fill (ref. nullable_fill_words) over the positions [a, b)
    of the [n+1] domain (b <= n + 1), cut where no core span crosses:
    rune boundaries minus the positions core spans cover minus core span
    ends, as (empty-position words of those b - a positions, padded to the
    word bucket, positions relative to a; empty count).  S, E are the core
    spans that start in [a, b) (each ends at or before b), live ones only
    (the reference marks dead ones with 2^30, which lands inside the domain
    past 2^30 bytes: ROADMAP F2); `ends` every core span end in [a, b),
    one of an earlier piece's span at a among them, which Go's rule bars
    an empty match from (the piece carries it).  Rune boundaries read
    three bytes on either side."""
    m = b - a
    if ascii_only:
        B = torch.ones(m, dtype=torch.bool, device=dev.device)
    else:
        B = rune_boundaries_range(dev, a, b)
    diff = torch.zeros(m + 1, dtype=torch.int32, device=dev.device)
    one = torch.ones(int(S.shape[0]), dtype=torch.int32, device=dev.device)
    diff.index_add_(0, (S - a).long(), one)
    diff.index_add_(0, (E - a).long(), -one)
    B &= torch.cumsum(diff[:m], 0, dtype=torch.int32) == 0
    del diff
    B[(ends - a).long()] = False
    return _pad_pack(B, m), mask_count(B)


def nullable_merge_into(out, core, emp):
    """The reference's nullable_merge (the searchsorted twin of
    meta/nullable.py:fill_empties) into `out` [c + ne, 2]: the c core
    spans `core` [c, 2] and the ne empty matches at the ascending
    positions `emp` interleaved by position, each row's index its rank
    among both, _CHECK_ROWS rows at a time.  Positions are distinct: an
    empty match never lies inside or at the start of a core span."""
    dev = out.device
    S = core[:, 0].contiguous()
    c, ne = int(S.shape[0]), int(emp.shape[0])
    for i in range(0, c, _CHECK_ROWS):
        j = min(c, i + _CHECK_ROWS)
        pos = (torch.arange(i, j, dtype=torch.int64, device=dev)
               + torch.searchsorted(emp, S[i:j]))
        out[pos] = core[i:j]
    for i in range(0, ne, _CHECK_ROWS):
        j = min(ne, i + _CHECK_ROWS)
        e = emp[i:j]
        pos = (torch.arange(i, j, dtype=torch.int64, device=dev)
               + torch.searchsorted(S, e))
        out[pos] = e[:, None].expand(j - i, 2)
