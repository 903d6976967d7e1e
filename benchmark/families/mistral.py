"""The ``mistral`` family: the dense Llama/Mistral decoder that
``quest_tpu_torch`` runs (``config.ModelConfig``, ``models/llama.py``):
grouped-query attention, a SwiGLU MLP, RMSNorm, rope; Quest on every
layer from ``skip_layers`` on.

What the harness takes from a family (``benchmark/README.md``):
``weights``, ``model_config``, ``reference``, ``trace_ranges`` and
``linear_params``; this family keeps ``bench/work.py``'s own counts of
the attention and of a step.

Random weights are made on the card from the run's seed, in the port's
layout (``{"embed", "layers": {...}, "final_norm", "lm_head"}`` with
stacked ``[L, in, out]`` linears), in the dtype they are served in.
Each stacked weight is one draw of ``torch.randn`` on the device's
generator, scaled in place: a few large calls, no host copy. Every
linear is N(0, gain^2 / fan_in), the norms' weights ones. Four scales
differ from the port's own ``init_params`` (unit gains, embedding s.d.
0.02), so that the check of the served tokens has decisions to check:

- ``EMBED_STD`` 5 and ``DOWN_GAIN`` 0.5 on ``w_down``: the token's
  embedding outweighs what 32-40 random layers add to the residual
  stream, so greedy answers wander over the vocabulary;
- ``O_GAIN`` 2 on ``wo``: with a larger gain, attention's average over
  a shared 32K-token document feeds a component common to every
  position back through the layers until it decides every logit, and
  each answer repeats one token with a margin no fp8 model crosses;
- ``QK_GAIN`` 1.25 on ``wq`` and ``wk``: attention logits of s.d. 1.56,
  so the top 2048 tokens by score hold about half of a head's weight at
  32K and the pages Quest selects matter; at 1.6 the random model
  turned chaotic, and bf16's rounding moved the logits nearly as far as
  fp8's.

PERF.md gives the readings behind each choice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from quest_tpu_torch.config import ModelConfig, RopeConfig
from quest_tpu_torch.models.llama import TRACE_RANGES as trace_ranges
from reference.quest_ref import Sequence_, Shape, forward_logits

QK_GAIN = 1.25
O_GAIN = 2.0
EMBED_STD = 5.0
DOWN_GAIN = 0.5


def weights(dims: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weights of a decoder of ``dims`` (``hidden_size``,
    ``intermediate_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``num_key_value_heads``, ``head_dim``, ``vocab_size``) drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, hid = dims["num_hidden_layers"], dims["hidden_size"]
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    inter, V = dims["intermediate_size"], dims["vocab_size"]

    def draw(shape, std):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(std)

    def lin(shape, fan_in, gain=1.0):
        return draw(shape, gain / math.sqrt(fan_in))

    ones = dict(dtype=dtype, device=device)
    return {
        "embed": draw((V, hid), EMBED_STD),
        "layers": {
            "wq": lin((L, hid, H * D), hid, QK_GAIN),
            "wk": lin((L, hid, Hkv * D), hid, QK_GAIN),
            "wv": lin((L, hid, Hkv * D), hid),
            "wo": lin((L, H * D, hid), H * D, O_GAIN),
            "w_gate": lin((L, hid, inter), hid),
            "w_up": lin((L, hid, inter), hid),
            "w_down": lin((L, inter, hid), inter, DOWN_GAIN),
            "ln_attn": torch.ones((L, hid), **ones),
            "ln_mlp": torch.ones((L, hid), **ones),
        },
        "final_norm": torch.ones((hid,), **ones),
        "lm_head": lin((hid, V), hid),
    }


def model_config(dims: Dict) -> ModelConfig:
    """The port's configuration of the decoder of ``dims`` (plain rope at
    ``rope_theta``)."""
    return ModelConfig(
        vocab_size=dims["vocab_size"], hidden_size=dims["hidden_size"],
        intermediate_size=dims["intermediate_size"],
        num_layers=dims["num_hidden_layers"],
        num_heads=dims["num_attention_heads"],
        num_kv_heads=dims["num_key_value_heads"], head_dim=dims["head_dim"],
        rms_norm_eps=dims["rms_norm_eps"],
        max_position_embeddings=dims["max_position_embeddings"],
        rope=RopeConfig(theta=dims["rope_theta"]),
        tie_word_embeddings=dims["tie_word_embeddings"],
        dtype=getattr(torch, dims["torch_dtype"]))


def shape_of(dims: Dict, quest: Dict) -> Shape:
    return Shape(hidden=dims["hidden_size"], layers=dims["num_hidden_layers"],
                 heads=dims["num_attention_heads"],
                 kv_heads=dims["num_key_value_heads"],
                 head_dim=dims["head_dim"], eps=dims["rms_norm_eps"],
                 rope_theta=dims["rope_theta"], page=quest["page_size"],
                 budget_tokens=quest["token_budget"],
                 skip_layers=quest["skip_layers"])


def reference(weights: Dict, dims: Dict, quest: Dict, prefix: torch.Tensor,
              seqs: Sequence[Sequence_], low_precision: bool = False
              ) -> List[Dict]:
    """``reference/quest_ref.py:forward_logits`` of the decoder of
    ``dims`` under ``quest``."""
    return forward_logits(weights, shape_of(dims, quest), prefix, seqs,
                          low_precision=low_precision)


def linear_params(dims: Dict) -> Tuple[int, int]:
    """(parameters of every layer's linears, of the head): every token
    reads and multiplies all of them."""
    hid, inter = dims["hidden_size"], dims["intermediate_size"]
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    per = hid * H * D + 2 * hid * Hkv * D + H * D * hid + 3 * hid * inter
    return dims["num_hidden_layers"] * per, hid * dims["vocab_size"]
