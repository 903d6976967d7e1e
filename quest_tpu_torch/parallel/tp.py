"""Tensor- and data-parallel step functions over ``torch.distributed``
(counterpart of ``quest_tpu/parallel/tp.py``).

JAX runs one controller over a mesh (``shard_map``); the port runs one
process per rank, each with the same host program. A rank holds its tp
shard of the weights (``mesh.py:shard_params``) and of the KV heads,
and its dp group's rows and slice of the page pool
(:func:`init_sharded_cache`). Its model makes the only tp collectives:
two all-reduces a layer and the logits' all-gather
(``models/llama.py:QuestModel(tp_group=...)``). The step functions take
the global batch, as JAX's do, run the rank's dp rows, and give every
rank the global result, all-gathered over dp. Each rank runs the
unsharded path's kernels over its own heads.

The decode steps are compiled (``engine/graphs.py``), as JAX jits them:
over NCCL each is captured once as a CUDA graph, its collectives
included, and replayed. gloo's collectives cannot be captured, so over
gloo the steps run eager: the choice is made from the process groups'
backend (:func:`graph_capture`), never by catching a failed capture.
Prefill stays eager.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.kv.paged_kv import PagedKVCache, init_cache
from quest_tpu_torch.models.llama import QuestModel
from quest_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, rank_device


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0, (
        f"heads ({cfg.num_heads}/{cfg.num_kv_heads}) not divisible by tp={tp}")
    assert cfg.vocab_size % tp == 0, "vocab must divide tp for lm_head shard"
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


class Shard:
    """One rank's part of a sharded model: its local ``QuestModel`` (the
    tp group's shard of ``params``, as :func:`~quest_tpu_torch.parallel.
    mesh.shard_params` gives them) and the rows of a global batch its dp
    group owns, and the graphs of its compiled steps (captured over NCCL,
    eager over gloo: :func:`graph_capture`)."""

    def __init__(self, cfg: ModelConfig, quest: QuestConfig, mesh, params):
        from quest_tpu_torch.engine.graphs import StepGraphs
        self.mesh = mesh
        self.tp = mesh.size(mesh.mesh_dim_names.index(TP_AXIS))
        self.dp = mesh.size(mesh.mesh_dim_names.index(DP_AXIS))
        self.dp_rank = mesh.get_local_rank(DP_AXIS)
        self.dp_group = mesh.get_group(DP_AXIS) if self.dp > 1 else None
        self.model = QuestModel(
            local_config(cfg, self.tp), quest, params,
            tp_group=mesh.get_group(TP_AXIS) if self.tp > 1 else None)
        self.device = self.model.embed.device
        self.graphs = StepGraphs(self.device, capture=graph_capture(mesh))

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The dp group's rows of a global batch ``x`` [B, ...], on the
        rank's device."""
        B = x.shape[0]
        assert B % self.dp == 0, (B, self.dp)
        n = B // self.dp
        return x[self.dp_rank * n:(self.dp_rank + 1) * n].to(self.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp group's rows [B / dp, ...] joined in batch order: the
        global [B, ...] on every rank (no collective at dp = 1)."""
        if self.dp_group is None:
            return x
        parts = torch.empty((self.dp,) + x.shape, dtype=x.dtype,
                            device=x.device)
        dist.all_gather(list(parts.unbind(0)), x.contiguous(),
                        group=self.dp_group)
        return parts.reshape((-1,) + x.shape[1:])


def graph_capture(mesh) -> bool:
    """Whether a rank of ``mesh`` captures its steps as CUDA graphs: on a
    card whose dp and tp groups run NCCL. A gloo group runs eager."""
    return rank_device(mesh).type == "cuda" and all(
        dist.get_backend(mesh.get_group(ax)) == "nccl"
        for ax in (DP_AXIS, TP_AXIS))


def _shards(cfg: ModelConfig, quest: QuestConfig, mesh, steps):
    """``params -> (Shard, its compiled steps)``: built at the first call
    with a params tree and kept (its model and captured steps are made
    once); ``steps(shard)`` gives the dict of step bodies to compile."""
    built: Dict[int, tuple] = {}

    def of(params):
        hit = built.get(id(params))
        if hit is None or hit[0] is not params:
            s = Shard(cfg, quest, mesh, params)
            fns = {k: s.graphs.compile(f, module=s.model)
                   for k, f in steps(s).items()}
            hit = built[id(params)] = (params, s, fns)
        return hit[1], hit[2]
    return of


def make_sharded_fns(cfg: ModelConfig, quest: QuestConfig, mesh):
    """Returns (prefill_fn, decode_fn), the same on every rank:

    prefill_fn(params, cache, tokens [B, T], new_lens [B]) ->
        (logits [B, T, V], cache)
    decode_fn(params, cache, tokens [B]) -> (logits [B, V], cache)

    ``params``: the rank's shard (``shard_params``); ``cache``: its own
    (:func:`init_sharded_cache`), updated in place and returned; tokens
    and lengths the global batch, logits the global f32 logits. Batch B
    must be divisible by the mesh's dp, heads and vocab by its tp.
    ``decode_fn`` is compiled; its logits are a static buffer that the
    next call overwrites.
    """
    shard = _shards(cfg, quest, mesh, lambda s: {
        "decode": lambda cache, tokens: s.gather(
            s.model.decode_step(cache, s.rows(tokens)))})

    def prefill_fn(params, cache: PagedKVCache, tokens, new_lens):
        s, _ = shard(params)
        logits = s.model.prefill(cache, s.rows(tokens), s.rows(new_lens))
        return s.gather(logits), cache

    def decode_fn(params, cache: PagedKVCache, tokens):
        return shard(params)[1]["decode"](cache, tokens), cache

    return prefill_fn, decode_fn


def make_serving_fns(cfg: ModelConfig, quest: QuestConfig, mesh):
    """Sharded steps of the continuous-batching scheduler, the same on
    every rank: (prefill_last_fn, decode_token_fn, decode_sample_fn),
    with the single-device model's signatures and the global batch:

    prefill_last_fn(params, cache, tokens [B, T], new_lens [B])
        -> (logits [B, 1, V], cache)
    decode_token_fn(params, cache, tokens [B], active [B])
        -> (next_tokens [B], cache)
    decode_sample_fn(params, cache, tokens [B], generator, temps [B],
        active [B]) -> (next_tokens [B], generator, cache)

    The generator stands for JAX's replicated key: every rank seeds its
    device generator alike, so the tp ranks of a dp group draw the same
    tokens from the same gathered logits, and dp groups draw with the
    same stream over different rows. The two decode steps are compiled
    (their tokens are static buffers that the next call overwrites).
    """
    shard = _shards(cfg, quest, mesh, lambda s: {
        "token": lambda cache, tokens, active: s.gather(
            s.model.decode_token_step(cache, s.rows(tokens),
                                      s.rows(active))),
        "sample": lambda cache, tokens, generator, temps, active: s.gather(
            s.model.decode_sample_step(cache, s.rows(tokens), generator,
                                       s.rows(temps), s.rows(active)))})

    def prefill_last_fn(params, cache, tokens, new_lens):
        s, _ = shard(params)
        return s.gather(s.model.prefill_last(cache, s.rows(tokens),
                                             s.rows(new_lens))), cache

    def decode_token_fn(params, cache, tokens, active):
        return shard(params)[1]["token"](cache, tokens, active), cache

    def decode_sample_fn(params, cache, tokens, generator, temps, active):
        out = shard(params)[1]["sample"](cache, tokens, generator, temps,
                                         active)
        return out, generator, cache

    return prefill_last_fn, decode_token_fn, decode_sample_fn


def init_sharded_cache(cfg: ModelConfig, quest: QuestConfig, mesh,
                       batch_size: int,
                       total_pages: int | None = None) -> PagedKVCache:
    """This rank's shard of the cache, allocated on its device: its tp
    group's KV heads, its dp group's slice of the pool, block-table rows
    and lengths. ``total_pages`` counts physical pages PER DP SHARD (each
    dp group owns an independent slice of the pool; block tables are
    shard-local — ``mesh.py:cache_specs``)."""
    tp = mesh.size(mesh.mesh_dim_names.index(TP_AXIS))
    dp = mesh.size(mesh.mesh_dim_names.index(DP_AXIS))
    dev = rank_device(mesh)
    # The dp = 1 cache of one group's rows and one tp shard's heads is
    # the rank's block of the whole dp cache (the table's values are
    # local and repeat in every group).
    assert batch_size % dp == 0, (batch_size, dp)
    return init_cache(local_config(cfg, tp), quest, batch_size // dp,
                      total_pages=total_pages, device=dev)
