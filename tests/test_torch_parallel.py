"""Multi-GPU over ``torch.distributed`` (``quest_tpu_torch/parallel``)
against the JAX package's mesh, on the CPU.

JAX runs one controller over the 8-device virtual CPU mesh of
``tests/conftest.py``; the port runs one process a rank. Each world size
(2, 4 and 8 ranks) is spawned once for the module: gloo, ``file://`` init
under a temporary directory (no port to race for between xdist
workers), a 60 s collective timeout, one thread a rank, and a deadline
on the join after which the parent kills the ranks and fails. The
parent writes the parameters and inputs as ``.npy`` files, the ranks
(``tests/torch_parallel_ranks.py``, which imports only ``torch`` and the
port) write their outputs beside them, and the parent compares them with
JAX's ``make_sharded_fns`` and scheduler, and with the single-process
port: shard_params bit for bit, ``init_cache(dp=)`` bit for bit, the
sharded prefill and decode within JAX's own 2e-4
(``tests/test_sharding.py``), the serving fns' tokens equal on every
rank, the (dp, tp) = (2, 2) scheduler's tokens equal to the unsharded
scheduler's with its pools drained and its prefix cache live, and
``tests/test_multihost.py``'s three cases.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from quest_tpu.config import ModelConfig as JModelConfig
from quest_tpu.config import QuestConfig as JQuestConfig
from quest_tpu.config import RopeConfig as JRopeConfig
from quest_tpu.kv.paged_kv import init_cache as jinit_cache
from quest_tpu.models.llama import QuestModel as JQuestModel
from quest_tpu.models.llama import init_params as jinit_params
from quest_tpu.parallel import make_mesh as jmake_mesh
from quest_tpu.parallel import make_sharded_fns as jmake_sharded_fns
from quest_tpu.parallel import shard_params as jshard_params
from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel
from quest_tpu_torch.parallel import (cache_specs, initialize_cluster,
                                      param_specs)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 2e-4               # tests/test_sharding.py's tolerance
SPAWN_DEADLINE_S = 240   # a world's whole run, its ranks' start included


def jax_configs(model=ranks.MODEL, quest=ranks.QUEST):
    return (JModelConfig(rope=JRopeConfig(), dtype=jnp.float32, **model),
            JQuestConfig(kv_dtype=jnp.float32, **quest))


def write_params(d, tree):
    d.mkdir()
    for k, v in tree.items():
        if k == "layers":
            for lk, lv in v.items():
                np.save(d / f"layers.{lk}.npy", np.asarray(lv))
        else:
            np.save(d / f"{k}.npy", np.asarray(v))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The inputs every world reads: the sharded model's and the
    scheduler model's parameters (JAX's init, as numpy) and the sharded
    batch: prompts of 40 tokens and the decode steps' tokens."""
    d = tmp_path_factory.mktemp("parallel")
    jcfg, _ = jax_configs()
    write_params(d / "params", jax.tree.map(np.asarray, jinit_params(
        jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)))
    scfg, _ = jax_configs(ranks.SCHED_MODEL, ranks.SCHED_QUEST)
    write_params(d / "sched", jax.tree.map(np.asarray, jinit_params(
        scfg, jax.random.PRNGKey(1), dtype=jnp.float32)))
    rng = np.random.default_rng(1)
    steps = np.asarray([[s + 1, s + 7] for s in range(1 + ranks.DECODE_STEPS)],
                       np.int32)
    np.savez(d / "sharded_inputs.npz",
             toks=rng.integers(0, 256, size=(2, 40)).astype(np.int32),
             lens=np.full((2,), 40, np.int32), steps=steps)
    return d


def spawn(root, world):
    """Run ``ranks.run`` on ``world`` gloo ranks; kill them and fail at
    the deadline or when one fails."""
    ctx = torch.multiprocessing.start_processes(
        ranks.run, args=(world, str(root)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.time() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                pytest.fail(f"{world} ranks passed their {SPAWN_DEADLINE_S} s "
                            "deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def world2(root):
    spawn(root, 2)
    return root / "out"


@pytest.fixture(scope="module")
def world4(root):
    spawn(root, 4)
    return root / "out"


@pytest.fixture(scope="module")
def world8(root):
    spawn(root, 8)
    return root / "out"


def rank_outputs(out, name, world):
    return [dict(np.load(out / f"{name}_r{r}.npz")) for r in range(world)]


def coord(rank, tp):
    return rank // tp, rank % tp


def join(parts, spec, dp, tp):
    """The whole tensor from the ranks' blocks under ``spec`` (rank r at
    mesh coordinate (r // tp, r % tp)); a block of an axis no dim splits
    is taken from coordinate 0."""
    sizes = {"dp": dp, "tp": tp}
    grid = {coord(r, tp): p for r, p in enumerate(parts)}
    axes = [(a, n) for a, n in enumerate(spec) if n is not None]

    def assemble(fixed):
        free = [(a, n) for a, n in axes if n not in fixed]
        if not free:
            return grid[(fixed.get("dp", 0), fixed.get("tp", 0))]
        a, n = free[0]
        return np.concatenate([assemble({**fixed, n: i})
                               for i in range(sizes[n])], axis=a)
    return assemble({})


# --------------------------------------------------------------------------
# Layout: params and cache.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world,dp,tp", [(4, 2, 2), (8, 2, 4)])
def test_shard_params_rejoin_bitwise(request, root, world, dp, tp):
    """The ranks' slices under param_specs, put back together, are the
    whole parameters bit for bit; replicated leaves are the same on every
    rank."""
    out = request.getfixturevalue(f"world{world}")
    parts = rank_outputs(out, f"params_{dp}x{tp}", world)
    specs = param_specs()
    flat_specs = {k: v for k, v in specs.items() if k != "layers"}
    flat_specs.update({f"layers.{k}": v for k, v in specs["layers"].items()})
    for key, spec in flat_specs.items():
        whole = np.load(root / "params" / f"{key}.npy")
        got = join([p[key] for p in parts], spec, dp, tp)
        np.testing.assert_array_equal(got, whole, err_msg=key)
        if not any(spec):
            for p in parts[1:]:
                np.testing.assert_array_equal(p[key], whole, err_msg=key)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_init_cache_dp_matches_jax(dp):
    """init_cache(dp=) is JAX's layout bit for bit: dp pool replicas, the
    block-table values local to each shard, total_pages a shard."""
    jcfg, jquest = jax_configs()
    cfg, quest = ranks.model_config(**ranks.MODEL), ranks.quest_config(
        **ranks.QUEST)
    for total in (None, 40):
        want = jinit_cache(jcfg, jquest, 2 * dp, total_pages=total, dp=dp)
        got = init_cache(cfg, quest, 2 * dp, total_pages=total, dp=dp,
                         device="cpu")
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)),
                                          err_msg=f.name)


@pytest.mark.parametrize("world,dp,tp", [(2, 2, 1), (2, 1, 2), (4, 4, 1),
                                         (4, 2, 2), (8, 2, 4)])
def test_sharded_cache_rejoins_to_init_cache(request, world, dp, tp):
    """The ranks' init_sharded_cache shards, joined under cache_specs, are
    init_cache(dp=) of the whole batch (and so JAX's)."""
    out = request.getfixturevalue(f"world{world}")
    parts = rank_outputs(out, f"cache_{dp}x{tp}", world)
    cfg, quest = ranks.model_config(**ranks.MODEL), ranks.quest_config(
        **ranks.QUEST)
    whole = init_cache(cfg, quest, 2 * dp, total_pages=40, dp=dp,
                       device="cpu")
    specs = cache_specs()
    for f in dataclasses.fields(whole):
        got = join([p[f.name] for p in parts], getattr(specs, f.name), dp, tp)
        np.testing.assert_array_equal(got, getattr(whole, f.name).numpy(),
                                      err_msg=f.name)


# --------------------------------------------------------------------------
# Sharded prefill and decode.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def references(root):
    """JAX single-device and the single-process port over the sharded
    inputs: prefill logits and 1 + DECODE_STEPS decode steps' logits."""
    jcfg, jquest = jax_configs()
    inp = np.load(root / "sharded_inputs.npz")
    tree = {"layers": {}}
    for f in (root / "params").glob("*.npy"):
        if f.stem.startswith("layers."):
            tree["layers"][f.stem[7:]] = np.load(f)
        else:
            tree[f.stem] = np.load(f)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = JQuestModel(jcfg, jquest)
    cache = jinit_cache(jcfg, jquest, 2)
    jpre, cache = model.prefill(jparams, cache, jnp.asarray(inp["toks"]),
                                jnp.asarray(inp["lens"]))
    jdec = []
    for t in inp["steps"]:
        d, cache = model.decode_step(jparams, cache, jnp.asarray(t))
        jdec.append(np.asarray(d))
    cfg, quest = ranks.model_config(**ranks.MODEL), ranks.quest_config(
        **ranks.QUEST)
    tmodel = QuestModel(cfg, quest, params_from_numpy(tree, device="cpu"))
    tcache = init_cache(cfg, quest, 2, device="cpu")
    tpre = tmodel.prefill(tcache, torch.from_numpy(inp["toks"]),
                          torch.from_numpy(inp["lens"])).numpy()
    tdec = [tmodel.decode_step(tcache, torch.from_numpy(t)).numpy()
            for t in inp["steps"]]
    return dict(tree=tree, jparams=jparams, inp=inp, jax=(np.asarray(jpre),
                                                          np.stack(jdec)),
                port=(tpre, np.stack(tdec)))


@pytest.mark.parametrize("world,dp,tp", [(2, 2, 1), (2, 1, 2), (4, 1, 4),
                                         (4, 2, 2), (8, 2, 4)])
def test_sharded_fns_match_jax_and_port(request, references, world, dp, tp):
    """make_sharded_fns at each (dp, tp): every rank gets the same global
    logits, within 2e-4 of the single-process port and of JAX's single
    device, over the prefill and 1 + DECODE_STEPS decode steps; each
    rank's cache holds its dp rows' lengths."""
    out = request.getfixturevalue(f"world{world}")
    parts = rank_outputs(out, f"sharded_{dp}x{tp}", world)
    for p in parts[1:]:
        np.testing.assert_array_equal(p["prefill"], parts[0]["prefill"])
        np.testing.assert_array_equal(p["decode"], parts[0]["decode"])
    for want in (references["port"], references["jax"]):
        np.testing.assert_allclose(parts[0]["prefill"], want[0], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(parts[0]["decode"], want[1], rtol=TOL,
                                   atol=TOL)
    n = 40 + 1 + ranks.DECODE_STEPS
    for p in parts:
        assert p["seq_lens"].tolist() == [n] * (2 // dp)


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2), (2, 4)])
def test_sharded_fns_match_jax_sharded_fns(request, references, dp, tp):
    """The port's sharded prefill and first decode step against JAX's
    make_sharded_fns on the same mesh shape, within 2e-4."""
    world = dp * tp
    out = request.getfixturevalue(f"world{world}")
    got = rank_outputs(out, f"sharded_{dp}x{tp}", world)[0]
    jcfg, jquest = jax_configs()
    inp = references["inp"]
    mesh = jmake_mesh(dp, tp)
    prefill_fn, decode_fn = jmake_sharded_fns(jcfg, jquest, mesh)
    sparams = jshard_params(references["jparams"], mesh)
    from quest_tpu.parallel import init_sharded_cache as jinit_sharded
    cache = jinit_sharded(jcfg, jquest, mesh, 2)
    logits, cache = prefill_fn(sparams, cache, jnp.asarray(inp["toks"]),
                               jnp.asarray(inp["lens"]))
    dec, cache = decode_fn(sparams, cache, jnp.asarray(inp["steps"][0]))
    np.testing.assert_allclose(got["prefill"], np.asarray(logits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["decode"][0], np.asarray(dec), rtol=TOL,
                               atol=TOL)


def test_serving_fns_agree_on_every_rank(world4, references):
    """make_serving_fns at (dp, tp) = (2, 2): the prefill's last logits and
    the greedy and the sampled tokens are the same on every rank (each
    rank's generator seeded alike, as JAX replicates its key); the greedy
    tokens are the single-process port's argmax."""
    parts = rank_outputs(world4, "serving_2x2", 4)
    for p in parts[1:]:
        for k in parts[0]:
            np.testing.assert_array_equal(p[k], parts[0][k], err_msg=k)
    pre, _ = references["port"]
    np.testing.assert_allclose(parts[0]["greedy_last"][:, 0], pre[:, -1],
                               rtol=TOL, atol=TOL)
    assert parts[0]["greedy"][0].tolist() == np.argmax(
        references["port"][1][0], axis=-1).tolist()
    assert parts[0]["sampled"].shape == parts[0]["greedy"].shape
    assert (parts[0]["sampled"] >= 0).all() and (
        parts[0]["sampled"] < ranks.MODEL["vocab_size"]).all()


# --------------------------------------------------------------------------
# The scheduler under a (2, 2) mesh.
# --------------------------------------------------------------------------

def unsharded_runs(root, kind, prefix_cache_entries=64, max_batch=4):
    cfg = ranks.model_config(**ranks.SCHED_MODEL)
    quest = ranks.quest_config(**(ranks.SCHED_QUEST if kind == "scheduler"
                                  else ranks.PREFIX_QUEST))
    eng = ContinuousBatchingEngine(cfg, quest, ranks.load_params(root,
                                                                 "sched"),
                                   max_batch=max_batch, prefill_bucket=16,
                                   prefix_cache_entries=prefix_cache_entries,
                                   device="cpu")
    outs = {}
    for reqs in ranks.sched_requests(kind):
        outs.update(eng.run(reqs))
    return {str(k): v for k, v in outs.items()}


def scheduler_results(out, kind):
    res = [json.loads((out / f"{kind}_2x2_r{r}.json").read_text())
           for r in range(4)]
    for r in res[1:]:
        assert r == res[0]
    return res[0]


def test_scheduler_under_mesh_matches_unsharded(root, world4):
    """ContinuousBatchingEngine(mesh=(2, 2)): two dp groups of two slots,
    each with its own pool; every rank takes the same decisions, every
    request's tokens equal the unsharded port scheduler's, and every
    group's pool is drained at the end. A prefill tick whose groups have
    different prefilling counts occurred (the smaller group's rows are
    padded with its other slots)."""
    res = scheduler_results(world4, "scheduler")
    assert len(res["pools"]) == 2
    assert res["prefill_groups"][0] == [2, 2]
    assert any(a != b for a, b in res["prefill_groups"])
    assert res["outs"] == unsharded_runs(root, "scheduler")
    assert all(free == total for free, total, _ in res["pools"])


def test_prefix_cache_under_mesh(root, world4):
    """Prefix caching is live under the (2, 2) mesh: the second request
    borrows the first one's two full blocks in its group (one hit of 64
    tokens), the generations equal an unsharded engine's without prefix
    caching, and each group's pool holds only its registry's blocks."""
    res = scheduler_results(world4, "prefix")
    assert res["hits"] == [[0, 0], [1, 64]]
    assert all(groups == [1, 0] for groups in res["prefill_groups"])
    assert res["outs"] == unsharded_runs(root, "prefix",
                                         prefix_cache_entries=0,
                                         max_batch=2)
    assert all(free + held == total for free, total, held in res["pools"])


# --------------------------------------------------------------------------
# Multi-host launch (tests/test_multihost.py's cases).
# --------------------------------------------------------------------------

def test_initialize_cluster_single_process_noop():
    """With no cluster environment, initialize_cluster in a single
    process forms no group (and raises nothing)."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        assert k not in os.environ
    initialize_cluster()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_on_ranks(request, world):
    """On every rank: initialize_cluster is a no-op once the group exists
    and raises RuntimeError on arguments that disagree with it;
    make_global_mesh takes tp from LOCAL_WORLD_SIZE (2) and dp = world /
    tp; global_batch gives every rank the global batch from its dp
    group's slab; host_local_logits its dp group's rows, once each."""
    out = request.getfixturevalue(f"world{world}")
    res = [json.loads((out / f"multihost_w{world}_r{r}.json").read_text())
           for r in range(world)]
    toks = np.arange(world * 6).reshape(world, 6).tolist()
    logits = np.arange(world * 3, dtype=np.float32).reshape(world, 3)
    seen = {}
    for r in res:
        assert r["refused"]
        assert r["default"] == [world // 2, 2]
        assert r["explicit"] == [1, world]
        assert r["global_batch"] == toks
        seen[r["coord"][0]] = r["local_logits"]
    assert np.concatenate([seen[g] for g in sorted(seen)]).tolist() == \
        logits.tolist()
