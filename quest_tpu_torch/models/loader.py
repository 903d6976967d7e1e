"""HF Llama/Mistral checkpoints as the port's parameters (counterpart of
``quest_tpu/models/loader.py``).

:func:`config_from_hf` maps a transformers config (or any object with
the same attributes, e.g. a ``types.SimpleNamespace``) to a
``ModelConfig``, with all four rope types. :func:`params_from_state_dict`
converts an HF state dict (torch tensors or numpy arrays) into the
stacked ``[L, in, out]`` layout of ``models/llama.py:init_params``, one
tensor at a time into buffers preallocated on the device, cast there:
the host never holds more than the state dict itself. The values equal
JAX's ``params_from_state_dict`` bit for bit (both round to the target
dtype to nearest even). :func:`load_hf_model` reads a local checkpoint
directory; it needs ``transformers``, imported only there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from quest_tpu_torch.config import ModelConfig, RopeConfig
from quest_tpu_torch.models.convert import _tensor
from quest_tpu_torch.models.llama import LAYER_KEYS, Params
from quest_tpu_torch.ops.utils import resolve_device

# Port layer key -> (HF name within model.layers.{i}., transposed).
HF_LAYER_NAMES = {
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "ln_attn": ("input_layernorm.weight", False),
    "ln_mlp": ("post_attention_layernorm.weight", False),
}


def config_from_hf(hf_config) -> ModelConfig:
    """Map a transformers Llama/Mistral config to ModelConfig."""
    rope_scaling = getattr(hf_config, "rope_scaling", None) or {}
    rope_type = rope_scaling.get("rope_type",
                                 rope_scaling.get("type", None))
    if rope_type in (None, "default"):
        rope = RopeConfig(theta=float(hf_config.rope_theta))
    elif rope_type == "linear":
        rope = RopeConfig(theta=float(hf_config.rope_theta),
                          scaling="linear",
                          factor=float(rope_scaling["factor"]))
    elif rope_type == "llama3":
        rope = RopeConfig(
            theta=float(hf_config.rope_theta), scaling="llama3",
            factor=float(rope_scaling["factor"]),
            low_freq_factor=float(rope_scaling["low_freq_factor"]),
            high_freq_factor=float(rope_scaling["high_freq_factor"]),
            original_max_position_embeddings=int(
                rope_scaling["original_max_position_embeddings"]))
    elif rope_type == "yarn":
        rope = RopeConfig(
            theta=float(hf_config.rope_theta), scaling="yarn",
            factor=float(rope_scaling["factor"]),
            original_max_position_embeddings=int(
                rope_scaling["original_max_position_embeddings"]))
    else:
        raise ValueError(f"unsupported rope scaling {rope_type!r}")

    num_heads = hf_config.num_attention_heads
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // num_heads)
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=num_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", num_heads),
        head_dim=head_dim,
        rms_norm_eps=hf_config.rms_norm_eps,
        rope=rope,
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        max_position_embeddings=hf_config.max_position_embeddings,
    )


def params_from_state_dict(state_dict: Dict[str, Any], cfg: ModelConfig,
                           dtype: Optional[torch.dtype] = None,
                           device="cuda") -> Params:
    """Convert an HF Llama/Mistral state dict (torch tensors or numpy
    arrays) to the stacked parameters on ``device`` in ``dtype``
    (default ``cfg.dtype``). Linear weights are transposed to ``[in,
    out]``; each tensor is moved to the device as it is and cast there
    into its slot of a preallocated stacked buffer."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype

    def get(name):
        t = state_dict[name]
        if hasattr(t, "detach"):
            return t.detach().to(dev)
        return _tensor(np.asarray(t), dev, None)

    def fill(buf, name, transpose):
        t = get(name)
        buf.copy_(t.T if transpose else t)

    L = cfg.num_layers
    layers = {}
    for k in LAYER_KEYS:
        name, tr = HF_LAYER_NAMES[k]
        first = state_dict[f"model.layers.0.{name}"]
        shape = tuple(first.shape[::-1] if tr else first.shape)
        buf = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for i in range(L):
            fill(buf[i], f"model.layers.{i}.{name}", tr)
        layers[k] = buf

    def single(name, transpose=False):
        shape = tuple(state_dict[name].shape)
        buf = torch.empty(shape[::-1] if transpose else shape, dtype=dtype,
                          device=dev)
        fill(buf, name, transpose)
        return buf

    embed = single("model.embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in state_dict:
        lm_head = embed.T.contiguous()
    else:
        lm_head = single("lm_head.weight", transpose=True)
    return {"embed": embed, "layers": layers,
            "final_norm": single("model.norm.weight"), "lm_head": lm_head}


def load_hf_model(model_path: str, dtype: Optional[torch.dtype] = None,
                  device="cuda"):
    """Load a local HF checkpoint directory -> (ModelConfig, params on
    ``device``). The weights are read in their stored dtype and cast on
    the device (the same values as reading them in f32 first)."""
    import transformers

    dev = resolve_device(device)
    hf_cfg = transformers.AutoConfig.from_pretrained(model_path)
    cfg = config_from_hf(hf_cfg)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        model_path, torch_dtype="auto", low_cpu_mem_usage=True)
    params = params_from_state_dict(model.state_dict(), cfg, dtype, dev)
    del model
    return cfg, params
