"""The port's in-place appends against the JAX package's functional ones:
the same sequence of prefill and decode appends (inactive rows, empty
prefill rows, a chunk that crosses an allocation block, non-finite
inputs) leaves the pool, the metadata, the block table and the lengths
bit for bit equal, outside physical block 0 (scratch: JAX's scatter of
duplicate indices into it has no defined order)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.config import ModelConfig as JModelConfig
from quest_tpu.config import QuestConfig as JQuestConfig
from quest_tpu.kv import paged_kv as jkv
from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.kv import paged_kv as tkv

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# name: (JAX KV dtype, torch KV dtype, metadata dtype name or None).
# fp8 e4m3 as the serving configuration stores it: fp8 metadata over a
# bf16 pool, and the fp8 KV option.
DTYPES = {"f32": (jnp.float32, torch.float32, None),
          "bf16": (jnp.bfloat16, torch.bfloat16, None),
          "bf16_fp8meta": (jnp.bfloat16, torch.bfloat16, "float8_e4m3fn"),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn, None)}


def _np(x):
    """Array of either framework as f32 numpy (bf16 -> f32 is exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
                   else x)
    return x


def _assert_same(jc, tc, bpp):
    np.testing.assert_array_equal(_np(tc.kv_pages)[:, :, bpp:],
                                  _np(jc.kv_pages)[:, :, bpp:])
    np.testing.assert_array_equal(_np(tc.k_max)[:, :, 1:],
                                  _np(jc.k_max)[:, :, 1:])
    np.testing.assert_array_equal(_np(tc.k_min)[:, :, 1:],
                                  _np(jc.k_min)[:, :, 1:])
    np.testing.assert_array_equal(_np(tc.block_tab), _np(jc.block_tab))
    np.testing.assert_array_equal(_np(tc.seq_lens), _np(jc.seq_lens))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_append_sequence_matches_jax_bitwise(dtype):
    jdt, tdt, meta = DTYPES[dtype]
    B, H, D, page, bpp, L = 3, 2, 16, 8, 4, 2      # 32-token blocks
    jquest = JQuestConfig(page_size=page, max_seq_len=256, block_pages=bpp,
                          kv_dtype=jdt,
                          meta_dtype=meta and getattr(jnp, meta))
    tquest = QuestConfig(page_size=page, max_seq_len=256, block_pages=bpp,
                         kv_dtype=tdt,
                         meta_dtype=meta and getattr(torch, meta))
    jc = jkv.init_cache(JModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        jquest, batch_size=B, num_layers=L)
    tc = tkv.init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        tquest, batch_size=B, num_layers=L, device="cpu")
    _assert_same(jc, tc, bpp)

    # A shuffled block table (each row keeps distinct, non-scratch blocks).
    rng = np.random.default_rng(7)
    NPB, NB = jc.k_max.shape[2], jc.block_tab.shape[1]
    tab = rng.permutation(np.arange(1, NPB))[:B * NB].reshape(B, NB)
    tab = tab.astype(np.int32)
    jc = dataclasses.replace(jc, block_tab=jnp.asarray(tab))
    tc.block_tab = torch.from_numpy(tab.copy())

    def prefill(T, lens, layer):
        k = rng.standard_normal((B, T, H, D)).astype(np.float32)
        v = rng.standard_normal((B, T, H, D)).astype(np.float32)
        k[0, 1, 0, 3] = np.inf
        v[0, 2, 1, 5] = np.nan
        nl = np.asarray(lens, np.int32)
        jout = jkv.append_prefill_at(jc, layer, jnp.asarray(k), jnp.asarray(v),
                                     new_lens=jnp.asarray(nl))
        tkv.append_prefill_at(tc, layer, torch.from_numpy(k),
                              torch.from_numpy(v), new_lens=torch.from_numpy(nl))
        return jout, nl

    def decode(act, layer):
        k = rng.standard_normal((B, H, D)).astype(np.float32)
        v = rng.standard_normal((B, H, D)).astype(np.float32)
        a = np.asarray(act, bool)
        jout = jkv.append_decode_at(jc, layer, jnp.asarray(k), jnp.asarray(v),
                                    active=jnp.asarray(a))
        tkv.append_decode_at(tc, layer, torch.from_numpy(k),
                             torch.from_numpy(v), active=torch.from_numpy(a))
        return jout, a.astype(np.int32)

    def advance(jout, adv):
        nonlocal jc
        seq = np.asarray(jc.seq_lens) + adv
        jc = dataclasses.replace(jout, seq_lens=jnp.asarray(seq, jnp.int32))
        tc.seq_lens += torch.from_numpy(adv.astype(np.int32))

    steps = [
        ("prefill", 20, [20, 13, 0]),           # row 2 empty -> scratch
        ("decode", None, [True, True, False]),  # row 2 inactive
        ("decode", None, [True, True, False]),
        ("prefill", 40, [40, 0, 25]),           # row 0 crosses a block
        ("decode", None, [True, True, True]),
        ("prefill", 16, [9, 16, 16]),
        ("decode", None, [False, True, True]),
    ]
    for kind, T, arg in steps:
        for layer in range(L):
            if kind == "prefill":
                jout, adv = prefill(T, arg, layer)
            else:
                jout, adv = decode(arg, layer)
            jc = dataclasses.replace(jout, seq_lens=jc.seq_lens)
        advance(jc, adv)
        _assert_same(jc, tc, bpp)
    assert np.isfinite(_np(tc.kv_pages)).all()


def test_layer_view_matches_jax():
    B, H, D, page, bpp = 2, 2, 8, 8, 4
    jquest = JQuestConfig(page_size=page, max_seq_len=128, block_pages=bpp,
                          kv_dtype=jnp.float32)
    tquest = QuestConfig(page_size=page, max_seq_len=128, block_pages=bpp,
                         kv_dtype=torch.float32)
    jc = jkv.init_cache(JModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        jquest, batch_size=B, num_layers=1)
    tc = tkv.init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        tquest, batch_size=B, num_layers=1, device="cpu")
    rng = np.random.default_rng(1)
    k = rng.standard_normal((B, 37, H, D)).astype(np.float32)
    v = rng.standard_normal((B, 37, H, D)).astype(np.float32)
    jc = jkv.append_prefill_at(jc, 0, jnp.asarray(k), jnp.asarray(v))
    tkv.append_prefill_at(tc, 0, torch.from_numpy(k), torch.from_numpy(v))
    jv, tv = jc.layer(0), tc.layer(0)
    for name in ("kv_pages", "k_max", "k_min"):
        np.testing.assert_array_equal(_np(getattr(tv, name)),
                                      _np(getattr(jv, name)))


def test_init_cache_total_pages_matches_jax():
    """A pool smaller than the full reservation: rows that do not fit
    start on the scratch block, as in JAX."""
    H, D, page, bpp, B = 2, 8, 8, 4, 3
    jquest = JQuestConfig(page_size=page, max_seq_len=512, block_pages=bpp,
                          kv_dtype=jnp.float32)
    tquest = QuestConfig(page_size=page, max_seq_len=512, block_pages=bpp,
                         kv_dtype=torch.float32)
    total = bpp + 2 * jquest.max_pages + 5     # two rows fit, one does not
    jc = jkv.init_cache(JModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        jquest, batch_size=B, num_layers=1, total_pages=total)
    tc = tkv.init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                        tquest, batch_size=B, num_layers=1, total_pages=total,
                        device="cpu")
    np.testing.assert_array_equal(_np(tc.block_tab), _np(jc.block_tab))
    assert (_np(tc.block_tab)[2] == 0).all()
    for name in ("kv_pages", "k_max", "k_min", "seq_lens"):
        assert tuple(getattr(tc, name).shape) == getattr(jc, name).shape
