"""Worker of tests/test_torch_multihost.py: one process of a 2-process
torch.distributed world (gloo on the CPU, joined through a file), holding
half the corpus on two virtual CPU devices, running coregex_tpu_torch's
distributed_count of `\\d+\\.\\d+`.  Imports no jax.

argv: init_url num_processes process_id out_path
"""

import os
import sys

import numpy as np


def main():
    url, nproc, pid, out_path = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    torch.set_num_threads(1)
    from coregex_tpu_torch.dfa.determinize import determinize
    from coregex_tpu_torch.nfa.thompson import compile_nfa
    from coregex_tpu_torch.ops.dfa_scan import DFATables
    from coregex_tpu_torch.parallel import distributed as dist
    from coregex_tpu_torch.parallel.shard import Mesh
    from coregex_tpu_torch.syntax.parser import parse

    ok = dist.initialize(url, nproc, pid, backend="gloo")
    assert ok and torch.distributed.get_world_size() == nproc
    assert dist.initialize(url, nproc, pid) is True    # idempotent
    mesh = dist.global_mesh(device="cpu")
    assert mesh.process_count == nproc and mesh.process_index == pid
    # two virtual CPU devices in this process
    mesh = Mesh(["cpu", "cpu"], "data", nproc, pid)
    assert mesh.shape["data"] == 2 * nproc

    dense = determinize(compile_nfa(parse(r"\d+\.\d+"), with_captures=False),
                        anchored=False, break_at_match=False)
    rng = np.random.default_rng(7)
    n = 32_768
    corpus = rng.choice(list(b"ab 12.5 cd 3.14.15 x\n"),
                        size=n).astype(np.uint8)
    shard = n // nproc
    local = corpus[pid * shard:(pid + 1) * shard]
    got = dist.distributed_count(DFATables.from_dense(dense), local, mesh)
    exp = int(dense.scan_all_ends(corpus).sum())
    torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        f.write(f"{got} {exp}\n")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "coregex_tpu"))
    assert not bad, bad
    assert got == exp, f"process {pid}: {got} != {exp}"


if __name__ == "__main__":
    main()
