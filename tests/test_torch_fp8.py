"""The port's fp8 e4m3 path against the JAX package on the CPU (Pallas
in interpret mode), and the fp8 branches of the CUDA kernels against
their plain versions (on the card only).

CPU: ``upcast_fp8`` bit for bit on all 256 codes; sparse, dense and
prefill attention over an fp8 pool and the streaming estimate over fp8
metadata; the engine with the serving configuration (page 32, fp8
metadata) with a bf16 and with an fp8 KV pool. Inputs stay below 448 in
magnitude: torch's cast saturates there, jax's gives NaN from 464 on.
The JAX side needs ``jax`` and is skipped without it, so the card cases
run on a machine that has no JAX: ``python -m pytest --noconftest -m
cuda tests/test_torch_fp8.py``.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import (QuestConfig, serving_quest_config,
                                    tiny_test_model)
from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.ops.dense_decode import (dense_decode_attention,
                                              dense_decode_attention_plain)
from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                          page_scores_kernel_plain,
                                          page_scores_physical)
from quest_tpu_torch.ops.prefill import (prefill_attention,
                                         prefill_attention_plain)
from quest_tpu_torch.ops.sparse_decode import (sparse_decode_attention,
                                               sparse_decode_attention_plain)
from quest_tpu_torch.ops.topk import select_pages
from quest_tpu_torch.ops.utils import check_pool_dtype, upcast_fp8
from test_torch_attention import (CARD_TOL, Q_DTYPES, card_pool,  # noqa: F401
                                  cuda, rel_err)
from test_torch_fused import ESTIMATE_SHAPES, estimate_operands

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FP8 = torch.float8_e4m3fn
LAYER = 1


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (Pallas in interpret mode on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu.ops.dense_decode import dense_decode_attention as dense
    from quest_tpu.ops.estimate import page_scores_kernel as est
    from quest_tpu.ops.pallas_utils import upcast_fp8 as upcast
    from quest_tpu.ops.prefill import prefill_attention as prefill
    from quest_tpu.ops.sparse_decode import sparse_decode_attention as sparse

    def fp8(t):
        """The same fp8 bytes as a JAX array."""
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)

    return types.SimpleNamespace(jax=jax, jnp=jnp, dense=dense, est=est,
                                 upcast=upcast, prefill=prefill, sparse=sparse,
                                 fp8=fp8)


def rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


# --------------------------------------------------------------------------
# upcast_fp8 and the dtype rule.
# --------------------------------------------------------------------------

def test_upcast_fp8_bitwise_on_all_codes(jx):
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jx.upcast(jx.jnp.asarray(codes).view(
        jx.jnp.float8_e4m3fn))).view(np.uint16)
    got = upcast_fp8(torch.from_numpy(codes).view(FP8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)
    # Denormals flush to zero where a plain cast keeps them.
    tiny = torch.tensor([1e-3]).to(FP8)
    assert float(tiny.float()) != 0.0 and float(upcast_fp8(tiny)) == 0.0


def test_check_pool_dtype():
    assert [check_pool_dtype(d) for d in
            (torch.float32, torch.bfloat16, FP8)] == [0, 1, 2]
    for bad in (torch.float8_e5m2, torch.float16):
        with pytest.raises(TypeError):
            check_pool_dtype(bad)


# --------------------------------------------------------------------------
# Attention over an fp8 pool, against the JAX kernels in interpret mode.
# --------------------------------------------------------------------------

def fp8_pool(seed, B, Hkv, D, page, bpp, NB, L=2):
    """Random fp8 pool [L, Hkv, NP, 2, page, D] (|x| < 448, denormals
    included) and a shuffled block table [B, NB] over blocks 1.."""
    rng = np.random.default_rng(seed)
    NPB = B * NB + 2
    pool = rng.standard_normal((L, Hkv, NPB * bpp, 2, page, D)) * 2.0
    tab = (1 + rng.permutation(NPB - 1)[:B * NB]).reshape(B, NB)
    return rng, torch.from_numpy(pool.astype(np.float32)).to(FP8), \
        tab.astype(np.int32)


# seed, seq_lens, Hq, Hkv, page, bpp, NB, budget
SPARSE_CASES = {
    "gqa4_page32": (21, [300, 141], 8, 2, 32, 2, 6, 5),
    "mha_page16": (22, [150, 61], 4, 4, 16, 4, 4, 4),
}


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_fp8_plain_matches_jax(jx, name):
    seed, seq_lens, Hq, Hkv, page, bpp, NB, budget = SPARSE_CASES[name]
    D, B = 32, len(seq_lens)
    rng, pool, tab = fp8_pool(seed, B, Hkv, D, page, bpp, NB)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    seq = np.asarray(seq_lens, np.int32)
    scores = rng.standard_normal((B, Hkv, NB * bpp)).astype(np.float32)
    idx, nv = select_pages(torch.from_numpy(scores), torch.from_numpy(seq),
                           page, budget)
    J, T = jx.jnp.asarray, torch.from_numpy
    sm = 1.0 / np.sqrt(D)
    want = jx.sparse(J(q), jx.fp8(pool), J(idx.numpy()), J(nv.numpy()),
                     J(seq), sm_scale=sm, layer=LAYER, block_tab=J(tab),
                     block_pages=bpp)
    got = sparse_decode_attention(T(q), pool, idx, nv, T(seq), sm_scale=sm,
                                  layer=LAYER, block_tab=T(tab),
                                  block_pages=bpp)
    rel_close(got.numpy(), np.asarray(want), 2e-3)


def test_dense_fp8_plain_matches_jax(jx):
    D, page, bpp, NB, Hq, Hkv = 32, 32, 2, 4, 8, 2
    seq = np.asarray([250, 33], np.int32)
    rng, pool, tab = fp8_pool(23, 2, Hkv, D, page, bpp, NB)
    q = rng.standard_normal((2, Hq, D)).astype(np.float32)
    J, T = jx.jnp.asarray, torch.from_numpy
    sm = 1.0 / np.sqrt(D)
    want = jx.dense(J(q), jx.fp8(pool), J(seq), sm_scale=sm, layer=LAYER,
                    block_tab=J(tab), block_pages=bpp, max_pages=NB * bpp)
    got = dense_decode_attention(T(q), pool, T(seq), sm_scale=sm, layer=LAYER,
                                 block_tab=T(tab), block_pages=bpp)
    rel_close(got.numpy(), np.asarray(want), 2e-3)


def test_prefill_fp8_plain_matches_jax(jx):
    D, page, bpp, NB, Hq, Hkv, T_ = 32, 32, 2, 3, 8, 2, 40
    off = np.asarray([70, 0], np.int32)
    kvl = np.asarray([110, 29], np.int32)
    rng, pool, tab = fp8_pool(24, 2, Hkv, D, page, bpp, NB)
    q = rng.standard_normal((2, T_, Hq, D)).astype(np.float32)
    J, T = jx.jnp.asarray, torch.from_numpy
    sm = 1.0 / np.sqrt(D)
    want = np.asarray(jx.prefill(J(q), jx.fp8(pool), J(off), J(kvl),
                                 sm_scale=sm, layer=LAYER, block_tab=J(tab),
                                 block_pages=bpp, max_pages=NB * bpp))
    got = prefill_attention(T(q), pool, T(off), T(kvl), sm_scale=sm,
                            layer=LAYER, block_tab=T(tab), block_pages=bpp)
    rel_close(got.numpy(), want, 2e-3)


@pytest.mark.parametrize("group_agg", ["sum", "max"])
def test_page_scores_kernel_fp8_plain_matches_jax(jx, group_agg):
    B, Hkv, G, P, D = 2, 2, 4, 256, 64
    rng = np.random.default_rng(25)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    a = rng.standard_normal((B, Hkv, P, D)).astype(np.float32)
    b = rng.standard_normal((B, Hkv, P, D)).astype(np.float32)
    kmax = torch.from_numpy(np.maximum(a, b)).to(FP8)
    kmin = torch.from_numpy(np.minimum(a, b)).to(FP8)
    want = jx.est(jx.jnp.asarray(q), jx.fp8(kmax), jx.fp8(kmin),
                  group_agg=group_agg)
    got = page_scores_kernel(torch.from_numpy(q), kmax, kmin,
                             group_agg=group_agg)
    rel_close(got.numpy(), np.asarray(want), 1e-5)


# --------------------------------------------------------------------------
# The serving configuration end to end: the port's engine against JAX's.
# --------------------------------------------------------------------------

def assert_storage_close(got, want, mant):
    """Cache contents equal bit for bit, but where a value lies on a
    rounding boundary of the storage dtype (``mant`` mantissa bits): the
    two sides' f32 activations differ by a few ulps (RMSNorm, matmul
    order), and there they round to neighbouring values, one step apart.
    The appends themselves are bitwise (tests/test_torch_paged_kv.py)."""
    g = got.float().numpy()
    w = np.asarray(want.astype(np.float32))
    diff = g != w
    assert diff.mean() <= 0.01, diff.mean()
    step = np.maximum(np.abs(g), np.abs(w)) * 2.0 ** -mant + 2.0 ** -9
    assert np.all(np.abs(g - w)[diff] <= step[diff])


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"])
def test_serving_config_engine_matches_jax(jx, kv):
    """Tiny GQA model in f32 with ``serving_quest_config`` (page 32, fp8
    metadata, a 4-page budget, prompts of 7 and 6 pages): greedy tokens
    identical to the JAX engine over 9 decode steps with the sparse path
    live, logits within 2e-3 at every step, the pool and the metadata
    as :func:`assert_storage_close` says (outside scratch block 0), and
    the pages selected from them bit for bit."""
    from quest_tpu.config import serving_quest_config as j_serving
    from quest_tpu.config import tiny_test_model as j_tiny
    from quest_tpu.engine.engine import QuestEngine as JQuestEngine
    from quest_tpu.models.llama import init_params as j_init_params
    from quest_tpu.ops.estimate import page_scores_physical as j_scores
    from quest_tpu.ops.topk import select_pages as j_select

    jnp = jx.jnp
    over = dict(token_budget=128, block_pages=8, skip_layers=1)
    jquest = j_serving(256, kv_dtype=getattr(jnp, kv), **over)
    quest = serving_quest_config(256, kv_dtype=getattr(torch, kv), **over)
    assert (quest.page_size, quest.page_budget, quest.max_pages) == (
        jquest.page_size, jquest.page_budget, jquest.max_pages) == (32, 4, 64)
    assert quest.resolved_meta_dtype == FP8
    jcfg = dataclasses.replace(j_tiny(num_kv_heads=2), dtype=jnp.float32)
    params = jx.jax.tree.map(np.asarray, j_init_params(
        jcfg, jx.jax.random.PRNGKey(6), dtype=jnp.float32))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (200, 170)]
    steps = 9
    jeng = JQuestEngine(jcfg, jquest, params, batch_size=2, prefill_bucket=16)
    cfg = dataclasses.replace(tiny_test_model(num_kv_heads=2),
                              dtype=torch.float32)
    eng = QuestEngine(cfg, quest, params_from_numpy(params, device="cpu"),
                      batch_size=2, prefill_bucket=16, device="cpu")
    want, got = jeng.prefill(prompts), eng.prefill(prompts)
    assert all((len(p) + 31) // 32 > quest.page_budget for p in prompts)
    for step in range(steps + 1):
        rel_close(got, want, 2e-3)
        tok = np.argmax(want, axis=-1).astype(np.int32)
        assert (np.argmax(got, axis=-1) == tok).all(), step
        if step < steps:
            want, got = jeng.decode(tok), eng.decode(tok)

    jc, tc = jeng.cache, eng.cache
    bpp = tc.block_pages
    assert tc.kv_pages.dtype == getattr(torch, kv) and tc.k_max.dtype == FP8
    mant = 3 if kv == "float8_e4m3fn" else 7
    assert_storage_close(tc.kv_pages[:, :, bpp:], jc.kv_pages[:, :, bpp:],
                         mant)
    for name in ("k_max", "k_min"):
        assert_storage_close(getattr(tc, name)[:, :, 1:],
                             getattr(jc, name)[:, :, 1:], 3)
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))
    # The pages the last layer would select for a fresh query.
    q = rng.standard_normal((2, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    seq = tc.seq_lens.numpy() + 1
    layer = cfg.num_layers - 1
    js = j_scores(jnp.asarray(q), jc.k_max[layer], jc.k_min[layer],
                  jc.block_tab, group_agg=jquest.group_agg)
    jidx, jnv = j_select(js, jnp.asarray(seq), 32, quest.page_budget)
    ts = page_scores_physical(torch.from_numpy(q), tc.k_max[layer],
                              tc.k_min[layer], tc.block_tab,
                              group_agg=quest.group_agg)
    tidx, tnv = select_pages(ts, torch.from_numpy(seq), 32, quest.page_budget)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))


def test_serving_config_refuses_fused_fp8():
    with pytest.raises(ValueError, match="fp8"):
        serving_quest_config(4096, fused_decode=True)
    with pytest.raises(ValueError, match="fp8"):
        QuestConfig(fused_decode=True, meta_dtype=torch.bfloat16, kv_dtype=FP8)


# --------------------------------------------------------------------------
# The fp8 branches of the CUDA kernels against their plain versions (card
# only): the pools of tests/test_torch_attention.py, cast to fp8 e4m3.
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 8)])
def test_sparse_fp8_kernel_matches_plain(cuda, q_dtype, page, Hq, Hkv):
    B, NB, bpp = 3, 6, 8
    g, pool, tab = card_pool(31, B, Hkv, NB, FP8, page=page)
    seq = torch.tensor([700, 95, 16], dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    scores = torch.randn((B, Hkv, NB * bpp), generator=g, device=cuda)
    idx, nv = select_pages(scores, seq, page, 10)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = sparse_decode_attention(q, pool, idx, nv, seq, **kw)
    want = sparse_decode_attention_plain(q, pool, idx, nv, seq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (16, 2)])
def test_dense_fp8_kernel_matches_plain(cuda, q_dtype, page, Hq, Hkv):
    B, NB, bpp = 3, 8, 8
    g, pool, tab = card_pool(32, B, Hkv, NB, FP8, page=page)
    seq = torch.tensor([1021, 1, 500], dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = dense_decode_attention(q, pool, seq, **kw)
    want = dense_decode_attention_plain(q, pool, seq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("T,offs,kv_lens,Hq,Hkv,NB,bpp", [
    (100, [0, 0], [100, 37], 32, 8, 4, 8),
    (130, [64, 0], [194, 0], 16, 2, 4, 8),
    (100, [300, 17], [400, 117], 16, 8, 4, 8),    # G = 2
    (40, [0, 8], [40, 48], 8, 8, 3, 1),           # tiles past the table
])
def test_prefill_fp8_kernel_matches_plain(cuda, q_dtype, page, T, offs,
                                          kv_lens, Hq, Hkv, NB, bpp):
    B = len(offs)
    g, pool, tab = card_pool(33, B, Hkv, NB, FP8, page=page, bpp=bpp)
    q = torch.randn((B, T, Hq, 128), generator=g, device=cuda).to(q_dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = prefill_attention(q, pool, off, kvl, **kw)
    want = prefill_attention_plain(q, pool, off, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[torch.bfloat16]
    assert torch.all(got[kvl == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("P,layout", ESTIMATE_SHAPES)
def test_estimate_fp8_kernel_matches_plain(cuda, q_dtype, G, P, layout):
    """fp8 metadata with denormals and the NaN code (read as 480), at page
    counts below, at and off one CTA's pages, in both layouts."""
    B, Hkv = 3, 4
    g = torch.Generator(device="cuda").manual_seed(40 + G)
    kmax, kmin, layer = estimate_operands(g, B, Hkv, P, layout, scale=1e-2)
    kmax, kmin = kmax.to(FP8), kmin.to(FP8)
    first = kmax[LAYER] if layer is not None else kmax
    first.view(torch.uint8)[0, 0, 0, :4] = 0x7F
    q = torch.randn((B, Hkv * G, 128), generator=g, device=cuda).to(q_dtype)
    agg = "max" if G % 4 else "sum"
    got = page_scores_kernel(q, kmax, kmin, agg, layer=layer)
    want = page_scores_kernel_plain(q, kmax, kmin, agg, layer=layer)
    torch.cuda.synchronize()
    assert got.shape == (B, Hkv, P)
    assert rel_err(got, want) <= 1e-5
