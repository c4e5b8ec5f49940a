"""Several processes, one corpus: the sharded count over torch.distributed.

Ports ``coregex_tpu/parallel/distributed.py``: ``initialize`` (:42-67),
``global_mesh`` (:70-72), ``hybrid_mesh`` (:75-95), ``make_global_corpus``
(:98-107) and ``distributed_count`` (:110-125).  The reference runs its
jitted shard_map programs SPMD across the processes of a
``jax.distributed`` world; here each process runs phase 1 on its own shards
(``parallel/shard.py``), the [S] maps of every shard are all-gathered over
``torch.distributed`` (NCCL between CUDA devices, gloo on the CPU), and
every process folds them and returns the same count.  Nothing here reads
a cluster's environment but ``env://``'s variables: the caller gives the
coordinator's address (``host:port``, a ``tcp://`` or a ``file://`` URL),
the world size and the rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .shard import Mesh, _Tables, default_mesh, phase1, place, sharded_total


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group (idempotent): `coordinator_address` is
    ``host:port`` (tcp), or a ``tcp://`` or ``file://`` URL; with none,
    ``env://`` when MASTER_ADDR and WORLD_SIZE are set, else nothing to
    join.  `backend` defaults to NCCL where CUDA is available, else gloo.
    Returns whether the world holds more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=url,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    return dist.get_world_size() > 1


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(axis: str = "data", device=None) -> Mesh:
    """The 1-D mesh over every process's devices: this process holds its
    own (``default_mesh(device=device)``), placed at its rank."""
    world, rank = _world()
    return Mesh(default_mesh(device=device).devices, axis, world, rank)


def hybrid_mesh(dcn_axis: str = "hosts", ici_axis: str = "data",
                device=None) -> Mesh:
    """The 2-D (processes x devices of a process) mesh: shape {dcn_axis:
    processes, ici_axis: devices of this process}; the corpus shards over
    the devices axis and only the maps cross processes."""
    mesh = global_mesh(ici_axis, device)
    mesh.shape = {dcn_axis: mesh.process_count, ici_axis: mesh.size}
    return mesh


def make_global_corpus(mesh: Mesh, local_data, axis: str = "data"):
    """This process's shard of the corpus (every process holds an equal
    slice, in rank order) placed on its devices: ``shard.place``'s runs."""
    return place(mesh, local_data)


def distributed_count(tables, local_data, mesh: Optional[Mesh] = None,
                      axis: str = "data") -> int:
    """The exact all-match-ends count of a corpus spread over the world:
    `local_data` is this process's equal-length slice, its length divisible
    by the mesh's devices.  Phase 1 on the local shards, the maps of every
    shard all-gathered (whenever a process group is up, a world of one
    included), the fold; every process returns the same count.
    `tables` is the DFA's ``dfa_scan.DFATables``."""
    mesh = mesh or global_mesh(axis)
    tb = _Tables(tables)
    dev0 = mesh.devices[0]
    Fs, Es = phase1(tb, make_global_corpus(mesh, local_data, axis), dev0)
    if dist.is_initialized():
        comm = dev0 if dist.get_backend() == "nccl" else torch.device("cpu")
        world = dist.get_world_size()
        both = torch.stack([Fs, Es]).to(comm)
        parts = [torch.empty_like(both) for _ in range(world)]
        dist.all_gather(parts, both)
        Fs, Es = torch.cat(parts, dim=1).to(dev0)
    return int(sharded_total(tb, Fs, Es))
