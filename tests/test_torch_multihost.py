"""coregex_tpu_torch's distributed_count in a real 2-process
torch.distributed world: gloo on the CPU, joined through a file in the
test's directory, two virtual CPU devices a process, each process holding
half of a seeded 32 KiB corpus (tests/torch_multihost_worker.py, which
imports no jax).  Both processes must return the same count, and it must
equal the host scan of the whole corpus."""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def test_two_process_distributed_count(tmp_path):
    worker = os.path.join(HERE, "torch_multihost_worker.py")
    url = f"file://{tmp_path / 'rendezvous'}"
    nproc = 2
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    outs = [tmp_path / f"out{pid}.txt" for pid in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, worker, url, str(nproc), str(pid), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid, out in enumerate(outs)]
    deadline = time.monotonic() + 110
    try:
        results = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, (_so, se)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, (
            f"worker {pid} rc={p.returncode}\n{se.decode()[-2000:]}")
    got_exp = [tuple(map(int, out.read_text().split())) for out in outs]
    assert got_exp[0] == got_exp[1]
    got, exp = got_exp[0]
    assert got == exp > 0
