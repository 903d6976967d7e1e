"""The port's model and engine against the JAX package, in f32 on the
CPU, with the sparse path live (page 8, a 32-token budget, prompts of
over 100 tokens): parameters, logits of prefill and decode, greedy
generation token for token; and the port's import isolation and device
rule."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu.config as jconfig
from quest_tpu.config import QuestConfig as JQuestConfig
from quest_tpu.config import tiny_test_model as j_tiny
from quest_tpu.engine.engine import QuestEngine as JQuestEngine
from quest_tpu.models.llama import init_params as j_init_params
import quest_tpu_torch.config as tconfig
from quest_tpu_torch.config import QuestConfig, tiny_test_model
from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
QUEST = dict(page_size=8, token_budget=32, max_seq_len=256, block_pages=8,
             skip_layers=1)
PROMPT_LENS = (120, 103)
NEW_TOKENS = 6


def _jax_tree_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """Tiny GQA model in f32: JAX parameters as numpy, both configs, the
    prompts, and the JAX engine's outputs."""
    jcfg = dataclasses.replace(j_tiny(num_kv_heads=2), dtype=jnp.float32)
    jquest = JQuestConfig(kv_dtype=jnp.float32, **QUEST)
    params = _jax_tree_numpy(j_init_params(jcfg, jax.random.PRNGKey(3),
                                           dtype=jnp.float32))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in PROMPT_LENS]
    eng = JQuestEngine(jcfg, jquest, params, batch_size=2, prefill_bucket=16)
    prefill_logits = eng.prefill(prompts)
    first = np.argmax(prefill_logits, axis=-1).astype(np.int32)
    decode_logits = eng.decode(first)
    eng.clear()
    tokens = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    cfg = dataclasses.replace(tiny_test_model(num_kv_heads=2),
                              dtype=torch.float32)
    quest = QuestConfig(kv_dtype=torch.float32, **QUEST)
    return dict(params=params, cfg=cfg, quest=quest, prompts=prompts,
                prefill_logits=prefill_logits, first=first,
                decode_logits=decode_logits, tokens=tokens)


@pytest.mark.parametrize("preset", [
    "llama31_8b", "mistral_7b_v03", "longchat_7b_v15_32k",
    "yarn_llama2_7b_128k", "tiny_test_model", "small_tpu_model"])
def test_config_presets_match_jax(preset):
    j, t = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jnp.dtype(jd.pop("dtype")) == jnp.bfloat16
    assert td.pop("dtype") == torch.bfloat16
    assert jd == td


def test_quest_config_matches_jax():
    for kw in ({}, dict(page_size=32, max_seq_len=100000),
               dict(page_size=8, token_budget=40, block_pages=128)):
        j, t = JQuestConfig(**kw), QuestConfig(**kw)
        assert (t.page_budget, t.max_pages) == (j.page_budget, j.max_pages)
    js = jconfig.serving_quest_config(32768)
    ts = tconfig.serving_quest_config(32768)
    assert (ts.page_size, ts.topk_method, ts.max_pages) == (
        js.page_size, js.topk_method, js.max_pages)
    assert ts.meta_dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="below one page"):
        QuestConfig(page_size=32, token_budget=16)
    with pytest.raises(ValueError, match="fp8"):
        QuestConfig(fused_decode=True, meta_dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="selection"):
        QuestConfig(selection="per_token")


def test_params_from_numpy_roundtrip():
    cfg = j_tiny(num_kv_heads=2)                       # bf16 leaves
    tree = _jax_tree_numpy(j_init_params(cfg, jax.random.PRNGKey(0)))
    got = params_from_numpy(tree, device="cpu")
    assert got["layers"]["wq"].dtype == torch.bfloat16
    assert tuple(got["layers"]["wq"].shape) == tree["layers"]["wq"].shape
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      tree[name].astype(np.float32))
    for name, arr in tree["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].float().numpy(),
                                      arr.astype(np.float32))
    f32 = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32


def test_prefill_and_decode_logits_match_jax(setup):
    s = setup
    model = QuestModel(s["cfg"], s["quest"],
                       params_from_numpy(s["params"], device="cpu"))
    cache = init_cache(s["cfg"], s["quest"], batch_size=2, device="cpu")
    T = 128                                    # the engine's bucket
    toks = np.zeros((2, T), np.int32)
    for b, p in enumerate(s["prompts"]):
        toks[b, :len(p)] = p
    lens = torch.tensor(PROMPT_LENS, dtype=torch.int32)
    logits = model.prefill_last(cache, torch.from_numpy(toks), lens)
    np.testing.assert_allclose(logits[:, 0].numpy(), s["prefill_logits"],
                               rtol=2e-3, atol=2e-3)
    assert cache.seq_lens.tolist() == list(PROMPT_LENS)
    # 120 and 103 tokens hold 15 and 13 pages: above the 4-page budget,
    # so the decode step below runs estimate -> top-k -> sparse.
    assert all((n + 7) // 8 > s["quest"].page_budget for n in PROMPT_LENS)
    dec = model.decode_step(cache, torch.from_numpy(s["first"]))
    np.testing.assert_allclose(dec.numpy(), s["decode_logits"], rtol=2e-3,
                               atol=2e-3)


def test_generate_token_identical_to_jax(setup):
    s = setup
    eng = QuestEngine(s["cfg"], s["quest"],
                      params_from_numpy(s["params"], device="cpu"),
                      batch_size=2, prefill_bucket=16, device="cpu")
    assert eng.generate(s["prompts"], max_new_tokens=NEW_TOKENS) == s["tokens"]
    eng.clear()
    assert eng.seq_lens.tolist() == [0, 0]
    assert eng.generate_ondevice(s["prompts"],
                                 max_new_tokens=NEW_TOKENS) == s["tokens"]
    # Chunked prefill: 120 = 110 + 10 tokens, 103 = 103 + 0, so the
    # second chunk carries an empty row (routed to scratch).
    chunked = QuestEngine(s["cfg"], s["quest"],
                          params_from_numpy(s["params"], device="cpu"),
                          batch_size=2, prefill_bucket=16, prefill_chunk=110,
                          device="cpu")
    assert chunked.generate(s["prompts"],
                            max_new_tokens=NEW_TOKENS) == s["tokens"]


def test_decode_token_step_is_decode_step_argmax(setup):
    s = setup
    params = params_from_numpy(s["params"], device="cpu")
    caches, models = [], []
    for _ in range(2):
        m = QuestModel(s["cfg"], s["quest"], params)
        c = init_cache(s["cfg"], s["quest"], batch_size=2, device="cpu")
        m.prefill_last(c, torch.tensor([s["prompts"][0][:40],
                                        s["prompts"][1][:40]]))
        caches.append(c)
        models.append(m)
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        want = torch.argmax(models[0].decode_step(caches[0], tok), dim=-1)
        got = models[1].decode_token_step(caches[1], tok)
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist()
        tok = got
    assert torch.equal(caches[0].kv_pages, caches[1].kv_pages)


def test_port_imports_no_jax():
    code = ("import sys, quest_tpu_torch, quest_tpu_torch.config, "
            "quest_tpu_torch.kv, quest_tpu_torch.ops, quest_tpu_torch.models, "
            "quest_tpu_torch.engine, quest_tpu_torch.ops._build, "
            "quest_tpu_torch.ops.estimate, quest_tpu_torch.ops.fused_decode, "
            "quest_tpu_torch.utils.benchmarking, "
            "quest_tpu_torch.ops.copy_probe, quest_tpu_torch.ops.select_pieces, "
            "quest_tpu_torch.ops.silu_mul, quest_tpu_torch.ops.rms_norm, "
            "quest_tpu_torch.kv.paged_kv, "
            "quest_tpu_torch.exp.dma_probe, quest_tpu_torch.exp.gather_ab, "
            "quest_tpu_torch.exp.select_compile2, "
            "quest_tpu_torch.exp.fused_stages, "
            "quest_tpu_torch.ops.decode_common, "
            "quest_tpu_torch.exp.decode_ablation, "
            "quest_tpu_torch.kv.pool, quest_tpu_torch.engine.scheduler, "
            "quest_tpu_torch.scripts.bench_kernels, "
            "quest_tpu_torch.scripts.bench_textgen, "
            "quest_tpu_torch.scripts.bench_serving, "
            "quest_tpu_torch.scripts.profile_textgen, "
            "quest_tpu_torch.scripts.accuracy_delta, "
            "quest_tpu_torch.scripts.accuracy_proxies, "
            "quest_tpu_torch.scripts.example_textgen, "
            "quest_tpu_torch.scripts.example_demo; "
            "bad = [m for m in sys.modules if m in ('jax', 'quest_tpu') or "
            "m.startswith(('jax.', 'quest_tpu.'))]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "quest_tpu." not in smoke


def test_engine_defaults_to_cuda():
    cfg, quest = tiny_test_model(), QuestConfig(max_seq_len=64)
    if torch.cuda.is_available():
        from quest_tpu_torch.ops.utils import resolve_device
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        QuestEngine(cfg, quest, params={})
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, quest)
