"""Configuration dataclasses for the PyTorch/CUDA port of quest-tpu.

Counterpart of ``quest_tpu/config.py``: the same three frozen
dataclasses, the same defaults and checks, with dtypes as
``torch.dtype``. The port runs the exact top-k only, so the serving
configuration maps ``approx`` and ``exact_fast`` to ``exact``. The JAX
fused kernel's ring and tiling knobs (``fused_select_group``,
``fused_block_p``, ``fused_gather_slots``) have no counterpart: the CUDA
kernel has no such pipeline, and passing them raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary position embedding settings: plain (``scaling=None``),
    linear position interpolation (``"linear"``), Llama-3.1 frequency
    bands (``"llama3"``) or YaRN (``"yarn"``)."""

    theta: float = 10000.0
    scaling: Optional[str] = None  # None | "linear" | "llama3" | "yarn"
    factor: float = 1.0
    # llama3-specific
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn-specific
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0


FULL, WINDOW = "full_attention", "sliding_attention"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of a Llama/Mistral-family decoder-only transformer:
    every layer full attention at ``rope`` and a SwiGLU MLP of
    ``intermediate_size`` (:class:`SparseWindowConfig` adds window layers
    and experts; here they are absent)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope: RopeConfig = dataclasses.field(default_factory=RopeConfig)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    dtype: torch.dtype = torch.bfloat16
    # Not fields here: SparseWindowConfig's, read by the model and cache.
    layer_types = None
    sliding_window = None
    window_rope = None
    num_experts = 0
    num_experts_per_tok = 0
    moe_intermediate_size = 0

    @property
    def num_groups(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    def is_window(self, layer: int) -> bool:
        return (self.layer_types is not None
                and self.layer_types[layer] == WINDOW)

    @property
    def full_layers(self) -> Tuple[int, ...]:
        return tuple(l for l in range(self.num_layers)
                     if not self.is_window(l))

    @property
    def window_layers(self) -> Tuple[int, ...]:
        return tuple(l for l in range(self.num_layers) if self.is_window(l))


@dataclasses.dataclass(frozen=True)
class SparseWindowConfig(ModelConfig):
    """A decoder whose layers may attend through a window and whose MLPs
    may be sparse experts. ``layer_types`` (one of :data:`FULL`,
    :data:`WINDOW` a layer; None: every layer full) makes some layers
    attend only to their last ``sliding_window`` keys, rotated by
    ``window_rope`` (None: ``rope``). ``num_experts > 0`` replaces every
    MLP by that many SwiGLU experts of ``moe_intermediate_size``, of
    which each token takes the ``num_experts_per_tok`` with the largest
    softmax router weight, renormalised to sum 1."""

    layer_types: Optional[Tuple[str, ...]] = None
    sliding_window: Optional[int] = None
    window_rope: Optional[RopeConfig] = None
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0

    def __post_init__(self):
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_layers or any(
                    t not in (FULL, WINDOW) for t in self.layer_types):
                raise ValueError(f"layer_types must give {FULL!r} or "
                                 f"{WINDOW!r} for each of the "
                                 f"{self.num_layers} layers")
            if WINDOW in self.layer_types and not self.sliding_window:
                raise ValueError("window layers need a sliding_window")
        if self.num_experts and not (
                0 < self.num_experts_per_tok <= self.num_experts
                and self.moe_intermediate_size > 0):
            raise ValueError("experts need 0 < num_experts_per_tok <= "
                             "num_experts and a moe_intermediate_size")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class QuestConfig:
    """Engine (KV sparsity) settings; defaults are the paper protocol:
    page 16, 2048-token budget, bf16 KV and metadata, exact top-k,
    per-KV-head selection, first two layers dense."""

    page_size: int = 16
    token_budget: int = 2048
    max_seq_len: int = 32768
    skip_layers: int = 2          # first N layers always run dense
    group_agg: str = "sum"        # GQA score combine: "sum" | "max"
    selection: str = "per_kv_head"  # | "per_q_head"
    kv_dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the per-page min/max-Key metadata; None = kv_dtype.
    meta_dtype: Optional[torch.dtype] = None
    # The port runs exact top-k; "approx"/"exact_fast" (the JAX
    # package's TPU-only methods) are accepted and run exact.
    topk_method: str = "exact"
    # Run each sparse layer's decode attention as ONE fused launch
    # (ops/fused_decode.py: estimate -> exact top-k -> decode) instead of
    # the three-call pipeline, where the model's gate allows it
    # (models/llama.py:fused_gate; elsewhere the pipeline runs).
    fused_decode: bool = False
    # Physical-pool allocation granularity, in pages (kv/paged_kv.py).
    block_pages: int = 64

    def __post_init__(self):
        for name, value, allowed in (
                ("group_agg", self.group_agg, ("sum", "max")),
                ("selection", self.selection, ("per_kv_head", "per_q_head")),
                ("topk_method", self.topk_method,
                 ("exact", "approx", "exact_fast"))):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}; expected one of {allowed}")
        meta = self.meta_dtype if self.meta_dtype is not None else self.kv_dtype
        if self.fused_decode and _itemsize(meta) < 2:
            raise ValueError(
                "fused_decode=True with sub-bf16 (fp8) metadata is a "
                "refused configuration: use the unfused pipeline with fp8 "
                "metadata, or bf16 metadata with the fused kernel.")
        if self.fused_decode and _itemsize(self.kv_dtype) < 2:
            raise ValueError(
                "fused_decode=True does not support fp8 KV pages; use the "
                "unfused pipeline.")
        if self.token_budget < self.page_size:
            raise ValueError(
                f"token_budget={self.token_budget} below one page "
                f"({self.page_size}); the budget must cover at least "
                "the always-kept current page.")

    @property
    def resolved_meta_dtype(self) -> torch.dtype:
        return self.meta_dtype if self.meta_dtype is not None else self.kv_dtype

    @property
    def page_budget(self) -> int:
        """Number of top-K page slots (includes the always-kept last page)."""
        return max(1, self.token_budget // self.page_size)

    @property
    def max_pages(self) -> int:
        """Per-sequence logical page-table size, rounded up to a multiple
        of the allocation block (and of 64)."""
        p = (self.max_seq_len + self.page_size - 1) // self.page_size
        m = max(64, self.block_pages)
        return ((p + m - 1) // m) * m


def serving_quest_config(max_seq_len: int, token_budget: int = 2048,
                         **overrides) -> QuestConfig:
    """The serving configuration of ``quest_tpu``: page 32, fp8 e4m3
    metadata, and the selection method of ``ops.topk.serving_method``
    (which the port runs as exact top-k)."""
    from quest_tpu_torch.ops.topk import serving_method

    page = overrides.pop("page_size", 32)
    probe = QuestConfig(page_size=page, token_budget=token_budget,
                        max_seq_len=max_seq_len)
    return dataclasses.replace(
        probe,
        meta_dtype=overrides.pop("meta_dtype", torch.float8_e4m3fn),
        topk_method=overrides.pop(
            "topk_method",
            serving_method(probe.max_pages, probe.page_budget)),
        **overrides)


# ---------------------------------------------------------------------------
# Presets.
# ---------------------------------------------------------------------------

def longchat_7b_v15_32k() -> ModelConfig:
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=32768,
        rope=RopeConfig(theta=10000.0, scaling="linear", factor=8.0),
    )


def yarn_llama2_7b_128k() -> ModelConfig:
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=131072,
        rope=RopeConfig(theta=10000.0, scaling="yarn", factor=32.0,
                        original_max_position_embeddings=4096),
    )


def llama31_8b() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=131072,
        rope=RopeConfig(theta=500000.0, scaling="llama3", factor=8.0,
                        low_freq_factor=1.0, high_freq_factor=4.0,
                        original_max_position_embeddings=8192),
    )


def mistral_7b_v03() -> ModelConfig:
    return ModelConfig(
        vocab_size=32768, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=32768,
        rope=RopeConfig(theta=1000000.0),
    )


def mellum2_12b_a2_5b() -> SparseWindowConfig:
    """JetBrains Mellum2-12B-A2.5B: three 1024-token window layers then one
    full layer, seven times; 64 experts of width 896, 8 a token."""
    return SparseWindowConfig(
        vocab_size=98304, hidden_size=2304, intermediate_size=7168,
        num_layers=28, num_heads=32, num_kv_heads=4, head_dim=128,
        rms_norm_eps=1e-6, max_position_embeddings=131072,
        rope=RopeConfig(theta=500000.0, scaling="yarn", factor=16.0,
                        original_max_position_embeddings=8192,
                        beta_fast=32.0, beta_slow=1.0),
        layer_types=(WINDOW, WINDOW, WINDOW, FULL) * 7, sliding_window=1024,
        window_rope=RopeConfig(theta=500000.0), num_experts=64,
        num_experts_per_tok=8, moe_intermediate_size=896)


def tiny_test_model(num_kv_heads: int = 4) -> ModelConfig:
    """Small config for unit tests (CPU-runnable)."""
    return ModelConfig(
        vocab_size=256, hidden_size=128, intermediate_size=352,
        num_layers=4, num_heads=4, num_kv_heads=num_kv_heads, head_dim=32,
        rms_norm_eps=1e-5, max_position_embeddings=4096,
        rope=RopeConfig(theta=10000.0),
    )


def small_tpu_model() -> ModelConfig:
    """Small config with head_dim 128 (the width the CUDA kernels take):
    smoke runs of the full stack on the card."""
    return ModelConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=8192,
        rope=RopeConfig(theta=10000.0),
    )
