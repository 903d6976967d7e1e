"""The port's compiled decode steps (``quest_tpu_torch/engine/graphs.py``,
the counterpart of ``jax.jit`` over the JAX package's decode steps).

On the CPU every compiled step runs its static-buffer body with no graph:
the engine's compiled ``decode``, ``generate_ondevice``,
``greedy_ondevice`` and ``score_ondevice`` and the scheduler's greedy
bursts are held to the JAX package (f32, a 2-layer model with the
sparse path live: 32-token budget over prompts of 45-90 tokens); the
compiled burst to its single steps bit for bit; the signatures, the
``eager()`` switch, the launch counters' replay (with a stub graph
object), a capture error, the workspaces' hold and the gloo choice are
checked on their own. The card cases (``cuda`` marker) replay each
decode step against its eager run bit for bit, the sampled one from the
same generator state, replay after a workspace grew, and capture again
for a new cache: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphs.py``.
"""

import copy
import dataclasses
import gc
import os
import sys
import types
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
from quest_tpu_torch.engine import ContinuousBatchingEngine, QuestEngine
from quest_tpu_torch.engine.graphs import StepGraphs, eager, is_eager
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel
from quest_tpu_torch.ops import decode_common
from quest_tpu_torch.ops.qdot import qgemv
from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
from quest_tpu_torch.ops.utils import holding

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the scheduler requests)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16)
QUEST = dict(page_size=8, token_budget=32, max_seq_len=256, skip_layers=1,
             block_pages=4)
NLL_TOL = 2e-3            # f32 NLLs, port vs JAX


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu import config as jconfig
    from quest_tpu import engine as jengine
    from quest_tpu.models.llama import init_params
    jcfg = jconfig.ModelConfig(rope=jconfig.RopeConfig(), dtype=jnp.float32,
                               **MODEL)
    jquest = jconfig.QuestConfig(kv_dtype=jnp.float32, **QUEST)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    return types.SimpleNamespace(
        jengine=jengine, jcfg=jcfg, jquest=jquest, params=params,
        cfg=ModelConfig(rope=RopeConfig(), dtype=torch.float32, **MODEL),
        quest=QuestConfig(kv_dtype=torch.float32, **QUEST),
        tparams=params_from_numpy(params, device="cpu"))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in lens]


def _drive(eng):
    """The same calls on a JAX or a port engine: two decode steps, then
    a new conversation's generate_ondevice, then score and greedy after
    another prefill."""
    out = {}
    logits = eng.prefill(_prompts(1, (90, 57)))
    steps = []
    for _ in range(2):
        logits = eng.decode(np.argmax(logits, -1))
        steps.append(logits)
    out["decode"] = np.stack(steps)
    eng.clear()
    out["generate_ondevice"] = np.asarray(
        eng.generate_ondevice(_prompts(2, (70, 45)), 7))
    eng.clear()
    eng.prefill(_prompts(3, (60, 80)))
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, size=(2, 9)).astype(np.int32)
    out["score_ondevice"] = eng.score_ondevice(toks, np.roll(toks, -1, 1),
                                               sync_every=4)
    out["greedy_ondevice"] = eng.greedy_ondevice([5, 6], 6, sync_every=4)
    out["lens"] = np.asarray(eng.seq_lens).tolist()
    return out


@pytest.fixture(scope="module")
def engines(jx):
    j = jx.jengine.QuestEngine(jx.jcfg, jx.jquest, jx.params, batch_size=2,
                               prefill_bucket=16)
    t = QuestEngine(jx.cfg, jx.quest, jx.tparams, batch_size=2,
                    prefill_bucket=16, device="cpu")
    return dict(jax=_drive(j), port=_drive(t), engine=t)


@pytest.mark.parametrize("method", ["decode", "generate_ondevice",
                                    "score_ondevice", "greedy_ondevice"])
def test_compiled_engine_matches_jax(engines, method):
    """Each method through the engine's compiled steps gives JAX's
    tokens (decode: the argmax of logits within 2e-3), NLLs within
    2e-3, and leaves the same lengths."""
    got, want = engines["port"][method], engines["jax"][method]
    assert got.shape == want.shape
    if method == "decode":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=NLL_TOL, atol=NLL_TOL)
    elif method == "score_ondevice":
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=NLL_TOL, atol=NLL_TOL)
    else:
        np.testing.assert_array_equal(got, want)
    assert engines["port"]["lens"] == engines["jax"]["lens"] == [75, 95]
    eng = engines["engine"]
    fn = {"decode": eng._decode_fn, "generate_ondevice": eng._tok_fn,
          "greedy_ondevice": eng._tok_fn, "score_ondevice": eng._nll_fn}
    assert fn[method].calls > 0 and len(fn[method].entries) == 1


def _prefilled_engine(jx, prompts, B=2):
    eng = QuestEngine(jx.cfg, jx.quest, jx.tparams, batch_size=B,
                      prefill_bucket=16, device="cpu")
    eng.prefill(prompts)
    return eng


@pytest.mark.parametrize("n", [1, 3])
def test_compiled_burst_equals_compiled_steps_bitwise(jx, n):
    prompts = _prompts(5, (66, 41))
    a, b = _prefilled_engine(jx, prompts), _prefilled_engine(jx, prompts)
    tok = torch.tensor([7, 9], dtype=torch.int32)
    burst = a._burst_fn(a.cache, tok, n).clone()
    steps, t = [], tok
    for _ in range(n):
        t = b._tok_fn(b.cache, t).clone()
        steps.append(t)
    assert burst.shape == (2, n) and burst.dtype == torch.int32
    assert torch.equal(burst, torch.stack(steps, 1))
    for f in ("kv_pages", "k_max", "k_min", "seq_lens"):
        assert torch.equal(getattr(a.cache, f), getattr(b.cache, f)), f


def test_scheduler_greedy_bursts_match_jax(jx):
    """The scheduler's compiled token step, replayed K times a burst (K
    changing from burst to burst), against JAX's scheduler tick for
    tick: one signature serves every burst."""
    kw = chip_smoke.scheduler_kwargs(jx.quest)
    bt = jx.quest.block_pages * jx.quest.page_size
    reqs = [dataclasses.replace(r, temperature=0.0)
            for r in chip_smoke.scheduler_requests(256, bt)]
    t = ContinuousBatchingEngine(jx.cfg, jx.quest, jx.tparams, device="cpu",
                                 **kw)
    j = jx.jengine.ContinuousBatchingEngine(jx.jcfg, jx.jquest, jx.params,
                                            **kw)
    for r in reqs:
        t.submit(copy.deepcopy(r))
        j.submit(jx.jengine.Request(**dataclasses.asdict(r)))
    bursts = 0
    while j.has_work():
        jev, tev = j.step(), t.step()
        assert t.last_tick == j.last_tick
        assert [(e.uid, e.token, e.finished) for e in tev] == [
            (e.uid, e.token, e.finished) for e in jev]
        bursts += t.last_tick == "decode"
        np.testing.assert_array_equal(t.cache.seq_lens.numpy(),
                                      np.asarray(j.cache.seq_lens))
    assert not t.has_work() and bursts > 1
    assert t._sample_fn.calls == 0 and len(t._tok_fn.entries) == 1
    assert t._tok_fn.calls >= bursts


def test_new_signature_new_entry_and_clear_keeps_it(jx):
    """A compiled step gets an entry a new batch size, burst length or
    cache, and keeps its entries across ``clear()``."""
    eng = _prefilled_engine(jx, _prompts(6, (40, 50)))
    tok = torch.tensor([1, 2], dtype=torch.int32)
    eng._tok_fn(eng.cache, tok)
    eng._tok_fn(eng.cache, tok)
    assert len(eng._tok_fn.entries) == 1
    eng.clear()
    eng.prefill(_prompts(7, (30, 20)))
    eng._tok_fn(eng.cache, tok)
    assert len(eng._tok_fn.entries) == 1            # clear() keeps it
    eng._burst_fn(eng.cache, tok, 2)
    eng._burst_fn(eng.cache, tok, 3)
    eng._burst_fn(eng.cache, tok, 2)
    assert len(eng._burst_fn.entries) == 2           # n is static
    old = eng.cache
    eng.cache = init_cache(jx.cfg, jx.quest, 2, device="cpu")
    eng._tok_fn(eng.cache, tok)
    assert len(eng._tok_fn.entries) == 2             # a new cache
    small = init_cache(jx.cfg, jx.quest, 1, device="cpu")
    eng._tok_fn(small, tok[:1])
    assert len(eng._tok_fn.entries) == 3             # a new batch size
    eng._tok_fn(old, tok)
    assert len(eng._tok_fn.entries) == 3             # the first again


def test_eager_nests_and_restores(jx):
    calls = []
    g = StepGraphs("cpu").compile(lambda x: calls.append(x) or x + 1)
    assert not is_eager()
    with eager():
        with eager():
            assert is_eager()
        assert is_eager()
        x = torch.ones(2)
        g(x)
        assert calls[-1] is x and not g.entries    # the plain call
    assert not is_eager()
    with pytest.raises(ValueError):
        with eager():
            raise ValueError("inside")
    assert not is_eager()
    x = torch.ones(2)
    g(x)
    assert calls[-1] is not x and len(g.entries) == 1   # a static buffer
    assert g.calls == 2


class StubGraph:
    """A graph object whose capture runs the body (recording what a real
    capture records: the counters move on the host) and whose replay
    launches nothing."""
    replays = 0
    fail = False

    def __init__(self, graphs_):
        self.graphs = graphs_

    def capture(self, body, generators):
        if StubGraph.fail:
            raise RuntimeError("capture refused")
        return body()

    def replay(self):
        StubGraph.replays += 1


def test_counters_add_the_capture_delta_on_each_replay(monkeypatch):
    """A step that launches qgemv 3 times and the sparse kernel once:
    its warm-up counts 4 launches, its capture none (the delta is taken
    back), and every replay adds the capture's 4 again."""
    monkeypatch.setattr(StubGraph, "replays", 0)

    def step(x):
        qgemv.launches += 3
        sparse_decode_attention.launches += 1
        return x * 2

    before = (qgemv.launches, sparse_decode_attention.launches)
    fn = StepGraphs("cpu", new_graph=StubGraph).compile(step)
    x = torch.arange(3.0)
    try:
        assert torch.equal(fn(x), x * 2)                     # warm-up
        assert (qgemv.launches - before[0],
                sparse_decode_attention.launches - before[1]) == (3, 1)
        for i in range(1, 4):
            fn(x + i)
            assert StubGraph.replays == i
            assert (qgemv.launches - before[0],
                    sparse_decode_attention.launches - before[1]) == (
                        3 * (i + 1), i + 1)
        entry = next(iter(fn.entries.values()))
        assert entry.delta == {qgemv: 3, sparse_decode_attention: 1}
        assert torch.equal(entry.args[0], x + 3)         # copied in
        assert fn.calls == 4
    finally:
        qgemv.launches, sparse_decode_attention.launches = before


def test_capture_error_propagates(monkeypatch):
    """A failed capture raises, leaves no entry and the counters as they
    were after the warm-up; the next call captures (and fails) again,
    never running eager in its place."""
    monkeypatch.setattr(StubGraph, "fail", True)
    before = qgemv.launches

    def step(x):
        qgemv.launches += 1
        return x + 1

    fn = StepGraphs("cpu", new_graph=StubGraph).compile(step)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="capture refused"):
                fn(torch.zeros(2))
            assert not fn.entries
        assert qgemv.launches - before == 2          # the two warm-ups

        def broken(x):
            raise ValueError("body failed")

        monkeypatch.setattr(StubGraph, "fail", False)
        with pytest.raises(ValueError, match="body failed"):
            StepGraphs("cpu", new_graph=StubGraph).compile(broken)(
                torch.zeros(2))
    finally:
        qgemv.launches = before


def test_capture_holds_the_workspace_it_was_given():
    """A workspace taken during a capture stays alive when a larger plan
    replaces it in the cache (the use-after-free a replay would hit), and
    only as long as what holds it."""
    dev = torch.device("cpu")
    decode_common._workspaces.pop(dev, None)
    small = decode_common.decode_plan(1, 2, 1, 16, 8, 16, 8)
    big = decode_common.decode_plan(8, 8, 4, 16, 256, 16, 1024)
    try:
        with holding() as held:
            decode_common.workspace(dev, small)
        assert len(held) == 2                   # partials and tickets
        refs = [weakref.ref(t) for t in held]
        decode_common.workspace(dev, big)       # replaces both
        assert all(r() is not None and all(r() is not t for t in
                                           decode_common._workspaces[dev])
                   for r in refs)
        del held
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        decode_common._workspaces.pop(dev, None)


def test_gloo_runs_eager_nccl_captures(tmp_path, monkeypatch):
    """The tp steps' capture is chosen by the groups' backend: a gloo
    group (whatever the device) runs eager, NCCL on a card captures."""
    import torch.distributed as dist

    from quest_tpu_torch.parallel import make_mesh, tp
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cpu")
        assert not tp.graph_capture(mesh)
        monkeypatch.setattr(tp, "rank_device",
                            lambda m: torch.device("cuda", 0))
        assert not tp.graph_capture(mesh)                # gloo
        monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
        assert tp.graph_capture(mesh)
    finally:
        dist.destroy_process_group()


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def _card_pair(cuda, B=2):
    """A 4-layer bf16 model (head dim 128, GQA group 4, sparse path
    live) and two caches after the same prefill."""
    from quest_tpu_torch.config import small_tpu_model
    from quest_tpu_torch.models.llama import init_params
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2, dtype=torch.bfloat16)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=2048,
                        block_pages=16, kv_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(5),
                         device=cuda)
    model = QuestModel(cfg, quest, params)
    toks = torch.randint(1, cfg.vocab_size, (B, 700),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32).to(cuda)
    lens = torch.tensor([700, 411][:B], dtype=torch.int32, device=cuda)
    caches = []
    for _ in range(2):
        c = init_cache(cfg, quest, B, device=cuda)
        model.prefill_last(c, toks, lens)
        caches.append(c)
    return cfg, model, caches


def _same_cache(a, b):
    for f in ("kv_pages", "k_max", "k_min", "seq_lens"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


STEPS = {
    "decode_step": lambda m, c, t, g, temps: m.decode_step(c, t),
    "decode_token_step": lambda m, c, t, g, temps: m.decode_token_step(c, t),
    "decode_nll_step": lambda m, c, t, g, temps: m.decode_nll_step(
        c, t, (t * 7 + 3) % 1000),
    "decode_sample_step": lambda m, c, t, g, temps: m.decode_sample_step(
        c, t, g, temps),
}


@pytest.mark.cuda
@pytest.mark.parametrize("step", sorted(STEPS))
def test_replay_equals_eager_bitwise(cuda, step):
    """Five calls of each decode step: under ``eager()`` on one cache,
    compiled (warm-up, capture, four replays) on the other; every output
    and the caches bit for bit, and the sampled step's generator, seeded
    alike, ends in the same state."""
    cfg, model, (c_eager, c_graph) = _card_pair(cuda)
    f = STEPS[step]
    fn = StepGraphs(cuda).compile(
        lambda c, t, g, temps: f(model, c, t, g, temps), module=model)
    temps = torch.tensor([0.0, 0.9], device=cuda)
    gens = [torch.Generator(device=cuda).manual_seed(4) for _ in range(2)]
    tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    outs = {"eager": [], "graph": []}
    for name, cache, gen in (("eager", c_eager, gens[0]),
                             ("graph", c_graph, gens[1])):
        t = tok
        for _ in range(5):
            if name == "eager":
                with eager():
                    out = fn(cache, t, gen, temps)
            else:
                out = fn(cache, t, gen, temps)
            out = out.clone()
            outs[name].append(out)
            t = (out if out.dtype == torch.int32
                 else (out.argmax(-1) if out.dim() == 2
                       else t + 1).to(torch.int32))
    for a, b in zip(outs["eager"], outs["graph"]):
        assert torch.equal(a, b)
    _same_cache(c_eager, c_graph)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert len(fn.entries) == 1 and fn.calls == 10


@pytest.mark.cuda
def test_replay_after_the_workspace_grew(cuda):
    """Capture at B=2, then a B=8 eager decode grows (replaces) the
    decode workspace and fresh tensors take the freed memory: replays
    still equal the eager run and leave those tensors untouched."""
    cfg, model, (c_eager, c_graph) = _card_pair(cuda)
    fn = StepGraphs(cuda).compile(model.decode_step)
    tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    fn(c_graph, tok)
    with eager():
        model.decode_step(c_eager, tok)
    dev = c_graph.kv_pages.device
    before = decode_common._workspaces[dev][0].data_ptr()
    big = init_cache(cfg, model.quest, 8, device=cuda)
    big.seq_lens.fill_(1500)
    with eager():
        model.decode_step(big, torch.ones(8, dtype=torch.int32, device=cuda))
    assert decode_common._workspaces[dev][0].data_ptr() != before
    del big
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), 7.0, device=cuda) for _ in range(64)]
    for _ in range(3):
        got = fn(c_graph, tok).clone()
        with eager():
            want = model.decode_step(c_eager, tok)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert all(bool((j == 7.0).all()) for j in junk)


@pytest.mark.cuda
def test_new_cache_captures_again(cuda):
    cfg, model, (c1, c2) = _card_pair(cuda)
    fn = StepGraphs(cuda).compile(model.decode_token_step)
    tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    a1 = fn(c1, tok).clone()
    b1 = fn(c2, tok).clone()
    assert len(fn.entries) == 2
    assert all(e.graph is not None for e in fn.entries.values())
    a2, b2 = fn(c1, a1).clone(), fn(c2, b1).clone()
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    _same_cache(c1, c2)
    assert len(fn.entries) == 2
