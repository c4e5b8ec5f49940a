"""The port's three tools that mirror the JAX package's, run on the CPU at
KiB scale: tools/threaded_throughput_torch.py (1 and 2 threads on 64 KiB
slices), tools/profile_bidi_torch.py (the bidirectional path's stages,
whose spans must equal find_all_spans_device's) and
tools/scaling_report_torch.py (ShardedPhaseProbe on a virtual mesh of 4
shards, whose counts must equal the sharded count's).  Each prints its
table; tests/test_torch_import.py runs them with jax blocked."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import profile_bidi_torch  # noqa: E402
import scaling_report_torch  # noqa: E402
import threaded_throughput_torch  # noqa: E402

torch.set_num_threads(1)


def test_threaded_throughput_prints_its_table(capsys):
    rows = threaded_throughput_torch.main(
        ["--mib", "0.0625", "--threads", "1,2", "--seconds", "0.05",
         "--repeats", "3", "--device", "cpu"])
    assert [r[0] for r in rows] == [1, 2]
    assert all(r[1] > 0 and r[4] <= r[2] <= r[5] and r[3] >= 0
               for r in rows)
    out = capsys.readouterr().out
    assert "lock wait s" in out and out.count("[threads]") == 4


def test_profile_bidi_prints_its_table(capsys):
    rows = profile_bidi_torch.main(["--mib", "0.0625", "--device", "cpu",
                                    "ip", "email"])
    assert [r[0] for r in rows] == ["ip", "email"]
    assert all(r[1] > 0 and len(r[2]) == 4 for r in rows)
    out = capsys.readouterr().out
    assert "assemble ms" in out and "[bidi] ip |" in out


def test_scaling_report_prints_its_table(capsys):
    from coregex_tpu_torch.parallel.shard import Mesh
    from coregex_tpu_torch.parallel.sharded_count import ShardedGoCount
    import coregex_tpu_torch as ct
    rows = scaling_report_torch.main(["--shards", "4", "--mib", "0.125",
                                      "--device", "cpu"])
    assert [r[1] for r in rows] == [p[0] for p in
                                    scaling_report_torch.PATTERNS]
    data = scaling_report_torch.token_corpus(0.125)
    cut = len(data) // 4 * 4
    for (_dev, name, S, t1, tg, t2, eff, count), (_, pattern) in zip(
            rows, scaling_report_torch.PATTERNS):
        assert min(t1, tg, t2) > 0 and 0 < eff <= 1
        cd = ct.compile(pattern, device="cpu").batch_engine() \
            ._count_scanner_for(True).cd
        assert S == cd.num_states
        # the probe counts the matches its shards commit, with no EOI
        # commit; the sharded count of the same cut adds that commit
        full = ShardedGoCount(cd, Mesh(["cpu"] * 4)).count(
            torch.from_numpy(np.ascontiguousarray(data[:cut])))
        assert full - 1 <= count <= full
    out = capsys.readouterr().out
    assert "predicted 2-host eff" in out and out.count("[scaling] cpu |") == 4
