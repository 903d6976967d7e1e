from quest_tpu_torch.kv.paged_kv import (LayerKV, PagedKVCache,
                                         append_decode, append_decode_at,
                                         append_prefill, append_prefill_at,
                                         init_cache)

__all__ = ["LayerKV", "PagedKVCache", "append_decode", "append_decode_at",
           "append_prefill", "append_prefill_at", "init_cache"]
