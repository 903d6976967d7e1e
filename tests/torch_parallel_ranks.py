"""The rank side of ``tests/test_torch_parallel.py``: what each gloo rank
runs on the CPU. It imports only ``torch`` and the port (never ``jax``):
the parent process computes the JAX side, writes the inputs as ``.npy``
files under its temporary directory and compares what the ranks write
back there.

``run(rank, world, root)`` forms the group (gloo, ``file://`` init, a
60 s collective timeout) and runs the jobs of its world size in order;
every rank runs every job, each over a fresh ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine, Request
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.parallel import (DP_AXIS, TP_AXIS, global_batch,
                                      host_local_logits, init_sharded_cache,
                                      initialize_cluster, make_global_mesh,
                                      make_mesh, make_serving_fns,
                                      make_sharded_fns, shard_params)

# tests/test_sharding.py's model and engine; tests/
# test_continuous_batching.py's for the scheduler (its prefix
# configuration: blocks of 32 tokens).
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16)
QUEST = dict(page_size=8, token_budget=16, max_seq_len=128, skip_layers=1)
SCHED_MODEL = dict(MODEL, num_heads=4)
SCHED_QUEST = dict(page_size=8, token_budget=32, max_seq_len=256,
                   skip_layers=1)
PREFIX_QUEST = dict(SCHED_QUEST, block_pages=4)
DECODE_STEPS = 3          # decode steps after the first, as
                          # test_sharded_multi_step_decode runs them

# Jobs a world size runs: (kind, dp, tp).
JOBS = {
    2: [("cache", 2, 1), ("cache", 1, 2), ("sharded", 2, 1),
        ("sharded", 1, 2), ("multihost", 0, 0)],
    4: [("params", 2, 2), ("cache", 4, 1), ("cache", 2, 2),
        ("sharded", 1, 4), ("sharded", 2, 2), ("serving", 2, 2),
        ("scheduler", 2, 2), ("prefix", 2, 2), ("multihost", 0, 0)],
    8: [("params", 2, 4), ("cache", 2, 4), ("sharded", 2, 4)],
}


def model_config(**kw) -> ModelConfig:
    return ModelConfig(rope=RopeConfig(), dtype=torch.float32, **kw)


def quest_config(**kw) -> QuestConfig:
    return QuestConfig(kv_dtype=torch.float32, **kw)


def sched_requests(kind: str):
    """The scheduler jobs' requests (the JAX mesh tests' prompts, and one
    more): four requests on four slots and a fifth that waits for the
    first slot to free (its prefill tick has one prefilling row in one dp
    group and none in the other), or a shared 80-token prefix with two
    tails, served one after the other."""
    if kind == "scheduler":
        rng = np.random.default_rng(21)
        prompts = [rng.integers(1, 256, size=n).tolist()
                   for n in (12, 30, 7, 21, 18)]
        return [[Request(uid=i, prompt=p, max_new_tokens=k)
                 for i, (p, k) in enumerate(zip(prompts, [5, 3, 6, 4, 4]))]]
    rng = np.random.default_rng(33)
    prefix = rng.integers(1, 256, size=80).tolist()
    tails = [rng.integers(1, 256, size=n).tolist() for n in (11, 17)]
    return [[Request(uid=i, prompt=prefix + t, max_new_tokens=6)]
            for i, t in enumerate(tails)]


def load_params(root: Path, name: str):
    """The whole model's parameters (written by the parent as .npy
    files), as the port's tensors on the CPU."""
    d = root / name
    tree = {"layers": {}}
    for f in d.glob("*.npy"):
        key = f.stem
        if key.startswith("layers."):
            tree["layers"][key[7:]] = np.load(f)
        else:
            tree[key] = np.load(f)
    return params_from_numpy(tree, device="cpu")


def _save(root: Path, name: str, **arrays) -> None:
    out = root / "out"
    out.mkdir(exist_ok=True)
    np.savez(out / f"{name}.npz", **{k: np.asarray(v) for k, v in
                                     arrays.items()})


def job_params(root, rank, mesh, tag):
    """This rank's slices of the params (the parent joins them)."""
    sp = shard_params(load_params(root, "params"), mesh)
    flat = {k: v for k, v in sp.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in sp["layers"].items()})
    _save(root, f"params_{tag}_r{rank}", **{k: v.numpy()
                                            for k, v in flat.items()})


def job_cache(root, rank, mesh, tag, dp):
    """This rank's cache shard at B = 2 dp rows, 40 pages a shard."""
    cache = init_sharded_cache(model_config(**MODEL), quest_config(**QUEST),
                               mesh, 2 * dp, total_pages=40)
    _save(root, f"cache_{tag}_r{rank}",
          **{f.name: getattr(cache, f.name).numpy()
             for f in dataclasses.fields(cache)})


def job_sharded(root, rank, mesh, tag):
    """Prefill, then 1 + DECODE_STEPS decode steps through
    make_sharded_fns; the global logits every rank gets, and its cache's
    lengths."""
    cfg, quest = model_config(**MODEL), quest_config(**QUEST)
    inp = np.load(root / "sharded_inputs.npz")
    toks, lens, steps = (torch.from_numpy(inp[k])
                         for k in ("toks", "lens", "steps"))
    prefill_fn, decode_fn = make_sharded_fns(cfg, quest, mesh)
    params = shard_params(load_params(root, "params"), mesh)
    cache = init_sharded_cache(cfg, quest, mesh, toks.shape[0])
    logits, cache = prefill_fn(params, cache, toks, lens)
    dec = []
    for t in steps:
        d, cache = decode_fn(params, cache, t)
        dec.append(d)
    _save(root, f"sharded_{tag}_r{rank}", prefill=logits.numpy(),
          decode=torch.stack(dec).numpy(), seq_lens=cache.seq_lens.numpy())


def job_serving(root, rank, mesh, tag):
    """The serving fns over the sharded-inputs batch: the prefill's last
    logits, greedy and sampled tokens for 1 + DECODE_STEPS steps, the
    generator seeded alike on every rank."""
    cfg, quest = model_config(**MODEL), quest_config(**QUEST)
    inp = np.load(root / "sharded_inputs.npz")
    toks, lens, steps = (torch.from_numpy(inp[k])
                         for k in ("toks", "lens", "steps"))
    pre, tok_fn, sample_fn = make_serving_fns(cfg, quest, mesh)
    params = shard_params(load_params(root, "params"), mesh)
    out = {}
    for mode in ("greedy", "sampled"):
        cache = init_sharded_cache(cfg, quest, mesh, toks.shape[0])
        last, cache = pre(params, cache, toks, lens)
        out[f"{mode}_last"] = last.numpy()
        gen = torch.Generator().manual_seed(5)
        temps = torch.full((toks.shape[0],), 0.9)
        active = torch.ones(toks.shape[0], dtype=torch.bool)
        t, seq = steps[0], []
        for _ in range(1 + DECODE_STEPS):
            if mode == "greedy":
                t, cache = tok_fn(params, cache, t, active)
            else:
                t, gen, cache = sample_fn(params, cache, t, gen, temps,
                                          active)
            seq.append(t)
        out[mode] = torch.stack(seq).numpy()
    _save(root, f"serving_{tag}_r{rank}", **out)


def job_scheduler(root, rank, mesh, tag, kind):
    """ContinuousBatchingEngine(mesh=...) over the requests: every
    request's tokens, the prefix hits, each group pool's free pages
    (with what the prefix registries hold) after the drain, and each
    prefill tick's prefilling slots a dp group."""
    cfg = model_config(**SCHED_MODEL)
    quest = quest_config(**(SCHED_QUEST if kind == "scheduler"
                            else PREFIX_QUEST))
    eng = ContinuousBatchingEngine(cfg, quest, load_params(root, "sched"),
                                   max_batch=4, prefill_bucket=16, mesh=mesh)
    tick, per_group = eng._prefill_tick, []

    def prefill_tick(pf):
        per_group.append([sum(eng._group(b) == g for b in pf)
                          for g in range(eng.dp)])
        return tick(pf)
    eng._prefill_tick = prefill_tick
    outs, hits = {}, []
    for reqs in sched_requests(kind):
        outs.update(eng.run(reqs))
        hits.append([eng.prefix_hits, eng.prefix_hit_tokens])
    held = [sorted({b for ent in reg.values() for b in ent})
            for reg in eng._prefixes]
    res = dict(outs={str(k): v for k, v in outs.items()}, hits=hits,
               pools=[[p.free_pages(), p.total_pages, len(h)]
                      for p, h in zip(eng.pools, held)],
               prefill_groups=per_group)
    (root / "out").mkdir(exist_ok=True)
    (root / "out" / f"{kind}_{tag}_r{rank}.json").write_text(json.dumps(res))


def job_multihost(root, rank, world):
    """tests/test_multihost.py's three cases where torch has the same
    state: initialize_cluster is idempotent and refuses arguments that
    disagree with the group; make_global_mesh's shapes and defaults;
    global_batch and host_local_logits round trip."""
    res = {}
    initialize_cluster()                              # the group exists
    try:
        initialize_cluster(coordinator_address="127.0.0.1:1234",
                           num_processes=world + 1, process_id=0)
        res["refused"] = False
    except RuntimeError:
        res["refused"] = True
    os.environ["LOCAL_WORLD_SIZE"] = "2"              # 2 ranks a host
    m = make_global_mesh(device="cpu")
    res["default"] = [m.size(0), m.size(1)]
    m = make_global_mesh(dp=1, tp=world, device="cpu")
    res["explicit"] = [m.size(0), m.size(1)]
    mesh = make_global_mesh(dp=world // 2, tp=2, device="cpu")
    toks = np.arange(world * 6, dtype=np.int32).reshape(world, 6)
    dp, g = world // 2, mesh.get_local_rank(DP_AXIS)
    rows = toks.reshape(dp, -1, 6)[g]                 # this group's slab
    res["global_batch"] = global_batch(mesh, rows).tolist()
    logits = torch.arange(world * 3, dtype=torch.float32).reshape(world, 3)
    res["local_logits"] = host_local_logits(logits, mesh).tolist()
    res["coord"] = [g, mesh.get_local_rank(TP_AXIS)]
    (root / "out").mkdir(exist_ok=True)
    (root / "out" / f"multihost_w{world}_r{rank}.json").write_text(
        json.dumps(res))


def run(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root}/init_{world}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        for kind, dp, tp in JOBS[world]:
            if kind == "multihost":
                job_multihost(root, rank, world)
                continue
            mesh = make_mesh(dp, tp, device="cpu")
            tag = f"{dp}x{tp}"
            if kind == "params":
                job_params(root, rank, mesh, tag)
            elif kind == "cache":
                job_cache(root, rank, mesh, tag, dp)
            elif kind == "sharded":
                job_sharded(root, rank, mesh, tag)
            elif kind == "serving":
                job_serving(root, rank, mesh, tag)
            else:
                job_scheduler(root, rank, mesh, tag, kind)
    finally:
        dist.destroy_process_group()
