"""Multi-host launch: the process group's lifecycle and host-sharded IO
(counterpart of ``quest_tpu/parallel/multihost.py``).

Every process runs this same program, one a GPU, as ``torchrun
--nnodes=N --nproc-per-node=G`` starts them; it sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``, from which :func:`initialize_cluster` forms the group.
The global mesh then puts tensor parallelism on a host's GPUs (NVLink)
and data parallelism across hosts, so that Quest's per-head selection
stays on a GPU and only activation-sized collectives cross hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from quest_tpu_torch.parallel.mesh import DP_AXIS, make_mesh, rank_device


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` from the launcher's
    environment, or from explicit arguments (``coordinator_address``
    "host:port", ``num_processes``, ``process_id``). NCCL on the card,
    gloo on the CPU; each process takes the card ``LOCAL_RANK``.

    Idempotent: with a group already formed it returns, unless explicit
    arguments disagree with that group, which raises RuntimeError (two
    programs that think they are one cluster are a caller's bug, as
    JAX's ordering check says). A single process with no cluster
    environment and no arguments does nothing.
    """
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        want = (num_processes if num_processes is not None else have[0],
                process_id if process_id is not None else have[1])
        if want != have:
            raise RuntimeError(
                f"initialize_cluster(num_processes={num_processes}, "
                f"process_id={process_id}) disagrees with the process "
                f"group already formed (world {have[0]}, rank {have[1]})")
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if (num_processes or 1) > 1:
            raise RuntimeError("a cluster of several processes needs a "
                               "coordinator address (MASTER_ADDR)")
        return                         # a single process: nothing to form
    if num_processes is None or process_id is None:
        raise RuntimeError("a cluster needs num_processes and process_id "
                           "(WORLD_SIZE and RANK)")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_global_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                     device="cuda"):
    """A mesh over every rank of the cluster (every rank calls it with the
    same arguments). Defaults: tp = the processes of a host
    (``LOCAL_WORLD_SIZE``: its GPUs), dp = world / tp (the hosts)."""
    n = dist.get_world_size()
    if tp is None:
        tp = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if dp is None:
        dp = n // tp
    assert dp * tp == n, (dp, tp, n)
    return make_mesh(dp, tp, device)


def global_batch(mesh, host_tokens) -> torch.Tensor:
    """The global [B, T] batch on every rank, from each dp group's
    [B / dp, T] slab (a rank gives its dp group's rows; numpy or a
    tensor), all-gathered over dp in batch order, on the rank's device."""
    t = torch.as_tensor(np.asarray(host_tokens)).to(rank_device(mesh))
    dp = mesh.size(mesh.mesh_dim_names.index(DP_AXIS))
    if dp == 1:
        return t
    parts = torch.empty((dp,) + t.shape, dtype=t.dtype, device=t.device)
    dist.all_gather(list(parts.unbind(0)), t.contiguous(),
                    group=mesh.get_group(DP_AXIS))
    return parts.reshape((-1,) + t.shape[1:])


def host_local_logits(logits: torch.Tensor, mesh) -> np.ndarray:
    """The rows of the global ``logits`` [B, ...] this rank's dp group
    owns, in batch order, once each (the tp ranks of a group hold the
    same rows), as numpy."""
    dp = mesh.size(mesh.mesh_dim_names.index(DP_AXIS))
    return logits.chunk(dp)[mesh.get_local_rank(DP_AXIS)].cpu().numpy()

