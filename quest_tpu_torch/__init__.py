"""quest_tpu_torch: the PyTorch/CUDA port of quest-tpu.

Paged KV cache with per-page min/max Key metadata, query-aware page
estimation, top-K page selection and sparse paged flash-decode, with
hand-written CUDA kernels for Hopper (sm_90a). The JAX package
``quest_tpu`` is the reference; this package imports none of it.
"""

from quest_tpu_torch.config import (ModelConfig, QuestConfig, RopeConfig,
                                    llama31_8b, longchat_7b_v15_32k,
                                    mistral_7b_v03, small_tpu_model,
                                    tiny_test_model, yarn_llama2_7b_128k)

__version__ = "0.1.0"

__all__ = [
    "ModelConfig", "QuestConfig", "RopeConfig",
    "llama31_8b", "longchat_7b_v15_32k", "mistral_7b_v03",
    "small_tpu_model", "tiny_test_model", "yarn_llama2_7b_128k",
]
