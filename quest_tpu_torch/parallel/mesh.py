"""Device mesh and sharding rules (counterpart of
``quest_tpu/parallel/mesh.py``).

One process per rank (``torch.distributed``), ranks laid out on a
``DeviceMesh`` with dims ``("dp", "tp")``: weights and KV pages are
split along the KV-head axis over ``tp`` so that Quest's per-head page
selection (estimate -> top-k -> sparse attention) stays on each rank,
with collectives only on the attention and MLP outputs (Megatron TP)
and the vocab-split logits; ``dp`` splits the request batch and the
physical page pool.

A spec is a tuple of mesh-dim names (or None) a tensor axis, as JAX's
``PartitionSpec``; a rank's slice of a tensor is its block along each
named axis (``local_slice``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from quest_tpu_torch.kv.paged_kv import PagedKVCache
from quest_tpu_torch.models.quantize import QuantizedLinear
from quest_tpu_torch.ops.utils import resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"

Spec = Tuple[Optional[str], ...]


def make_mesh(dp: int, tp: int, device="cuda"):
    """A ``(dp, tp)`` DeviceMesh over the ranks of the default process
    group (``parallel/multihost.py:initialize_cluster`` or
    ``torch.distributed.init_process_group`` first); rank r sits at
    ``(r // tp, r % tp)``. ``device`` ("cuda" unless the caller asks for
    the CPU) is the ranks' device type."""
    from torch.distributed.device_mesh import init_device_mesh
    world = torch.distributed.get_world_size()
    assert dp * tp == world, (dp, tp, world)
    return init_device_mesh(resolve_device(device).type, (dp, tp),
                            mesh_dim_names=(DP_AXIS, TP_AXIS))


def rank_device(mesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def param_specs() -> dict:
    """Specs of the stacked params pytree (``models/llama.py``): the q, k,
    v, gate and up projections split by column (over heads), the o and
    down projections by row, the lm_head over the vocab, the rest
    replicated."""
    return {
        "embed": (),                                # replicated
        "layers": {
            "wq": (None, None, TP_AXIS),            # heads sharded
            "wk": (None, None, TP_AXIS),
            "wv": (None, None, TP_AXIS),
            "wo": (None, TP_AXIS, None),            # row-parallel
            "w_gate": (None, None, TP_AXIS),
            "w_up": (None, None, TP_AXIS),
            "w_down": (None, TP_AXIS, None),
            "ln_attn": (),
            "ln_mlp": (),
        },
        "final_norm": (),
        "lm_head": (None, TP_AXIS),                 # vocab sharded
    }


def cache_specs() -> PagedKVCache:
    """The paged cache's specs: KV heads on tp, physical pages on dp (each
    dp group runs its own allocator over its slice of the pool, and its
    block-table VALUES are local to that slice: ``kv/paged_kv.py:
    init_cache(dp=)``), the min/max metadata (keyed by physical block)
    like the pool, and the batch rows on dp."""
    return PagedKVCache(
        kv_pages=(None, TP_AXIS, DP_AXIS, None, None, None),
        k_max=(None, TP_AXIS, DP_AXIS, None, None),
        k_min=(None, TP_AXIS, DP_AXIS, None, None),
        block_tab=(DP_AXIS, None),
        seq_lens=(DP_AXIS,),
    )


def local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view): along each axis
    named by a mesh dim, block ``coordinate`` of ``size`` equal blocks."""
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.size(mesh.mesh_dim_names.index(name))
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not "
                             f"split over {n} {name} ranks")
        x = x.chunk(n, dim=axis)[mesh.get_local_rank(name)]
    return x


def shard_params(params, mesh):
    """This rank's slices of ``params`` (the whole model's, on any device)
    under :func:`param_specs`, contiguous on the rank's device. Plain
    weights only, as JAX's ``shard_params`` maps over plain leaves:
    quantized weights under a mesh are refused."""
    dev = rank_device(mesh)

    def shard(x, spec):
        if isinstance(x, QuantizedLinear):
            raise NotImplementedError("quantized weights are not sharded "
                                      "over a mesh")
        return local_slice(x, spec, mesh).to(dev).contiguous()

    specs = param_specs()
    return {
        "embed": shard(params["embed"], specs["embed"]),
        "layers": {k: shard(v, specs["layers"][k])
                   for k, v in params["layers"].items()},
        "final_norm": shard(params["final_norm"], specs["final_norm"]),
        "lm_head": shard(params["lm_head"], specs["lm_head"]),
    }
