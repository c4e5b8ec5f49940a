"""The sharded find_all's gate (ROADMAP P6) on a virtual mesh of 4 CPU
devices.

``_sharded_starts`` hands the unanchored reverse table to the transfer walk,
which takes at most ``transfer_scan.MAX_STATES`` states and a one-warp block
within shared memory.  A keyword list of 100 words or more has a reverse
table past that gate: the hook declines it before anything is uploaded, so
the one-device path serves the call, as the reference's Engine does when
its sharded path fails.  The lists are chip_smoke.py's band
(``\\b(?:w1|...|wN)\\b`` over ``chip_smoke.big_words``), on a 96 KiB cut of
its base corpus; the spans are compared with ``re``'s, exactly.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
import coregex_tpu_torch as ct
from coregex_tpu_torch.ops import transfer_scan
from coregex_tpu_torch.parallel import shard
from coregex_tpu_torch.utils import corpus_cache

torch.set_num_threads(1)

MESH = 4
N = 96 << 10      # past the hook's 2^16 bytes, a multiple of MESH


@pytest.fixture(scope="module")
def band():
    """(the band's patterns by name, the corpus)."""
    base = chip_smoke.build_base(size=chip_smoke.BIG_CUT + (64 << 10))
    tile = chip_smoke.big_cut(base)
    return dict(chip_smoke.band_patterns(tile)), tile[:N]


# (list, reverse table within the walk's gate: the hook serves it)
CASES = [("KW50", True), ("KW100", False), ("KW200", False)]


@pytest.mark.parametrize("name, served", CASES)
def test_sharded_find_all_declines_past_the_walk_gate(monkeypatch, band,
                                                       name, served):
    """KW100's reverse table has more than MAX_STATES states and KW200's
    one-warp block is past shared memory: _sharded_starts returns None
    before make_sharded_ends builds anything, and find_all_index gives
    re's spans from the one-device path.  KW50 still takes the hook."""
    pats, corpus = band
    monkeypatch.setattr(shard, "default_mesh",
                        lambda n_devices=None, device=None, axis="data":
                        shard.Mesh([device] * MESH, axis))
    built = []
    make = shard.make_sharded_ends

    def spy_make(*args, **kw):
        built.append(args[1])
        return make(*args, **kw)
    monkeypatch.setattr(shard, "make_sharded_ends", spy_make)
    corpus_cache.clear()
    eng = ct.compile(pats[name], device="cpu")
    eng.batch_threshold = 0
    be = eng.batch_engine()
    S, nseg = be._full_scan_route()[0].tables.packed.shape
    assert transfer_scan.walk_gate(S, nseg) is served, (S, nseg)
    if name == "KW100":
        assert S > transfer_scan.MAX_STATES
    if name == "KW200":
        assert transfer_scan.smem_bytes(S, nseg) > transfer_scan.SMEM_LIMIT
    hook, out = be._sharded_starts, []

    def spy(rev, data):
        out.append(hook(rev, data))
        return out[-1]
    monkeypatch.setattr(be, "_sharded_starts", spy)
    want = [m.span() for m in re.finditer(pats[name].encode(), corpus)]
    assert len(want) > 1000
    assert eng.find_all_index(corpus) == want
    assert out and (out[-1] is not None) is served
    assert bool(built) is served
    assert be.host_routes == 0


@pytest.mark.parametrize("S, nseg, ok", [
    (transfer_scan.MAX_STATES, 8, True),
    (transfer_scan.MAX_STATES + 1, 8, False),
    (500, 128, False),
    (300, 64, True)])
def test_walk_gate_bounds(S, nseg, ok):
    """walk_gate: at most MAX_STATES states and a one-warp block within
    SMEM_LIMIT, the same on every device."""
    assert transfer_scan.walk_gate(S, nseg) is ok
    assert (S <= transfer_scan.MAX_STATES and transfer_scan.smem_bytes(
        S, nseg) <= transfer_scan.SMEM_LIMIT) is ok
