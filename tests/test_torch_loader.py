"""The port's HF checkpoint loader against the JAX package's, on the CPU:
``config_from_hf`` field for field (Llama with each of the four rope
types, Mistral, a plain namespace), ``params_from_state_dict`` bit for
bit (bf16 and f32, torch and numpy state dicts, tied embeddings),
``load_hf_model`` from a ``save_pretrained`` directory in both packages;
and the port's model at full budget against transformers'
``LlamaForCausalLM`` (4 and 2 KV heads) and ``MistralForCausalLM``
within 2e-3, as ``tests/test_model_parity.py`` holds the JAX model."""

import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, llama31_8b
from quest_tpu_torch.engine import QuestEngine
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.llama import QuestModel, init_params
from quest_tpu_torch.models.loader import (config_from_hf, load_hf_model,
                                           params_from_state_dict)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card's loader phase, run here small)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

transformers = pytest.importorskip("transformers")

ROPE_SCALINGS = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 8.0},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192},
    "yarn": {"rope_type": "yarn", "factor": 32.0,
             "original_max_position_embeddings": 4096},
}


@pytest.fixture(scope="module")
def jl():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from quest_tpu.models import loader
    return types.SimpleNamespace(jnp=jnp, loader=loader)


def _llama_config(num_kv_heads=4, rope="default", tie=False):
    return transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=num_kv_heads, max_position_embeddings=512,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=False,
        tie_word_embeddings=tie, rope_scaling=ROPE_SCALINGS[rope])


def _mistral_config():
    return transformers.MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=1e6,
        sliding_window=None, tie_word_embeddings=False)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("which", sorted(ROPE_SCALINGS) + ["mistral"])
def test_config_from_hf_matches_jax(jl, which):
    hf = _mistral_config() if which == "mistral" else _llama_config(
        rope=which)
    got = config_from_hf(hf)
    assert _fields(got) == _fields(jl.loader.config_from_hf(hf))
    assert got.dtype == torch.bfloat16
    assert got.rope.scaling == (None if which in ("default", "mistral")
                                else which)


def test_config_from_hf_takes_a_namespace():
    """Llama-3.1-8B's published config.json fields as a plain namespace
    (chip_smoke.py's; no transformers needed) give the preset."""
    ns = chip_smoke.llama31_8b_hf_config()
    assert config_from_hf(ns) == llama31_8b()
    ns.rope_scaling = {"rope_type": "dynamic", "factor": 2.0}
    with pytest.raises(ValueError, match="dynamic"):
        config_from_hf(ns)


def _hf_model(cfg, seed=0):
    torch.manual_seed(seed)
    cls = (transformers.MistralForCausalLM
           if isinstance(cfg, transformers.MistralConfig)
           else transformers.LlamaForCausalLM)
    return cls(cfg).eval()


def _assert_params_equal(got, want):
    """The port's tensors against JAX arrays, bit for bit."""
    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def tbits(t):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())

    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(got[name].shape) == np.asarray(want[name]).shape
        np.testing.assert_array_equal(tbits(got[name]), bits(want[name]))
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, arr in want["layers"].items():
        assert tuple(got["layers"][name].shape) == np.asarray(arr).shape
        np.testing.assert_array_equal(tbits(got["layers"][name]), bits(arr))


@pytest.mark.parametrize("source", ["torch", "numpy", "tied"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_state_dict_bitwise(jl, dtype, source):
    hf_cfg = _llama_config(num_kv_heads=2, tie=source == "tied")
    sd = _hf_model(hf_cfg).state_dict()
    if source == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    if source == "tied":
        sd.pop("lm_head.weight", None)
    cfg = config_from_hf(hf_cfg)
    got = params_from_state_dict(sd, cfg, getattr(torch, dtype), device="cpu")
    want = jl.loader.params_from_state_dict(sd, jl.loader.config_from_hf(
        hf_cfg), getattr(jl.jnp, dtype))
    _assert_params_equal(got, want)
    assert got["layers"]["wq"].dtype == getattr(torch, dtype)


def test_load_hf_model_matches_jax(jl, tmp_path):
    hf_cfg = _llama_config(num_kv_heads=2, rope="llama3")
    _hf_model(hf_cfg, seed=3).save_pretrained(str(tmp_path))
    cfg, params = load_hf_model(str(tmp_path), device="cpu")
    jcfg, jparams = jl.loader.load_hf_model(str(tmp_path))
    assert _fields(cfg) == _fields(jcfg)
    _assert_params_equal(params, jparams)


def _full_budget():
    return QuestConfig(page_size=8, token_budget=512, max_seq_len=256,
                       skip_layers=2, kv_dtype=torch.float32)


@pytest.mark.parametrize("which", ["llama_kv4", "llama_kv2", "mistral"])
def test_full_budget_matches_hf(which):
    """Budget over the whole sequence: prefill logits of 21 tokens and two
    decode steps against transformers' full-context forward, within
    2e-3."""
    hf_cfg = {"llama_kv4": lambda: _llama_config(4),
              "llama_kv2": lambda: _llama_config(2),
              "mistral": _mistral_config}[which]()
    hf = _hf_model(hf_cfg, seed=1)
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=torch.float32)
    params = params_from_state_dict(hf.state_dict(), cfg, device="cpu")
    quest = _full_budget()
    model = QuestModel(cfg, quest, params)
    cache = init_cache(cfg, quest, batch_size=1, device="cpu")
    toks = np.random.default_rng(7).integers(0, 256, size=(1, 21))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.numpy()
    logits = model.prefill(cache, torch.from_numpy(toks).int()).numpy()
    np.testing.assert_allclose(logits, want, rtol=2e-3, atol=2e-3)
    cur, last = toks, logits[0, -1]
    for _ in range(2):
        nxt = np.array([int(last.argmax())])
        cur = np.concatenate([cur, nxt[None]], axis=1)
        with torch.no_grad():
            want = hf(torch.from_numpy(cur)).logits.numpy()[:, -1]
        dec = model.decode_step(cache, torch.from_numpy(nxt).int()).numpy()
        np.testing.assert_allclose(dec, want, rtol=2e-3, atol=2e-3)
        last = dec[0]


def test_engine_greedy_matches_hf_generate():
    hf_cfg = _llama_config(2)
    hf = _hf_model(hf_cfg, seed=2)
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=torch.float32)
    eng = QuestEngine(cfg, _full_budget(),
                      params_from_state_dict(hf.state_dict(), cfg,
                                             device="cpu"),
                      prefill_bucket=16, device="cpu")
    prompt = np.random.default_rng(2).integers(0, 256, size=13).tolist()
    got = eng.generate([prompt], max_new_tokens=6)[0]
    with torch.no_grad():
        out = hf.generate(torch.tensor([prompt]), max_new_tokens=6,
                          do_sample=False, num_beams=1, pad_token_id=0)
    assert got == out[0, len(prompt):].tolist()


def test_loader_defaults_to_the_card(tmp_path):
    hf_cfg = _llama_config(2)
    hf = _hf_model(hf_cfg)
    if torch.cuda.is_available():
        got = params_from_state_dict(hf.state_dict(), config_from_hf(hf_cfg))
        assert got["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_state_dict(hf.state_dict(), config_from_hf(hf_cfg))
    hf.save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        load_hf_model(str(tmp_path))


def test_hf_state_dict_round_trip():
    """chip_smoke.py's loader phase at a tiny size: parameters under HF
    names (views) load back bit for bit, bf16 and f32."""
    from quest_tpu_torch.config import tiny_test_model
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(tiny_test_model(2), dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
        got = params_from_state_dict(chip_smoke.hf_state_dict(params), cfg,
                                     device="cpu")
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], params[k]) and got[k].is_contiguous()
        for k, v in params["layers"].items():
            assert torch.equal(got["layers"][k], v)
