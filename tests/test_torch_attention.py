"""The port's attention ops against the JAX package's Pallas kernels
(run in interpret mode on the CPU), and the CUDA kernels against their
plain versions (on the card only).

Every case reads one layer of a shared whole-model pool through a
shuffled block table, with partial last pages. The JAX side needs
``jax`` and is skipped without it, so the card cases run on a machine
that has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_attention.py``.
"""

import os
import types

import numpy as np
import pytest
import torch

from quest_tpu_torch.ops.dense_decode import (dense_decode_attention,
                                              dense_decode_attention_plain)
from quest_tpu_torch.ops.prefill import (prefill_attention,
                                         prefill_attention_plain)
from quest_tpu_torch.ops.sparse_decode import (sparse_decode_attention,
                                               sparse_decode_attention_plain)
from quest_tpu_torch.ops.topk import select_pages

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LAYER = 1


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels (Pallas, interpret mode on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from quest_tpu.ops.dense_decode import dense_decode_attention as dense
    from quest_tpu.ops.prefill import prefill_attention as prefill
    from quest_tpu.ops.sparse_decode import sparse_decode_attention as sparse
    return types.SimpleNamespace(jnp=jnp, dense=dense, prefill=prefill,
                                 sparse=sparse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def make_pool(seed, B, Hkv, D, page, bpp, NB, L=2):
    """Random pool [L, Hkv, NP, 2, page, D] f32 and a shuffled block
    table [B, NB] over blocks 1.. (block 0 is scratch)."""
    rng = np.random.default_rng(seed)
    NPB = B * NB + 2
    pool = rng.standard_normal((L, Hkv, NPB * bpp, 2, page, D)).astype(
        np.float32)
    tab = (1 + rng.permutation(NPB - 1)[:B * NB]).reshape(B, NB)
    return rng, pool, tab.astype(np.int32)


def sparse_case(seed, seq_lens, Hq, Hkv, per_q_head, budget, inject):
    D, page, bpp, NB = 32, 8, 4, 6
    B = len(seq_lens)
    rng, pool, tab = make_pool(seed, B, Hkv, D, page, bpp, NB)
    Hsel = Hq if per_q_head else Hkv
    seq = np.asarray(seq_lens, np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    P = NB * bpp
    if inject:
        # Shuffled distinct per-head pages, the current page not always in.
        idx = np.stack([np.stack([rng.permutation((s + page - 1) // page)[:budget]
                                  for _ in range(Hsel)]) for s in seq_lens])
        nv = np.asarray([idx.shape[-1]] * B, np.int32)
        idx = idx.astype(np.int32)
    else:
        scores = rng.standard_normal((B, Hsel, P)).astype(np.float32)
        idx, nv = select_pages(torch.from_numpy(scores),
                               torch.from_numpy(seq), page, budget)
        idx, nv = idx.numpy(), nv.numpy()
    return dict(q=q, pool=pool, idx=idx, nv=nv, seq=seq, tab=tab, bpp=bpp,
                sm=1.0 / np.sqrt(D), per_q_head=per_q_head, sorted=not inject)


SPARSE_CASES = {
    "gqa4": (1, [77, 150], 8, 2, False, 6, False),
    "mha": (2, [33, 9], 2, 2, False, 4, False),       # short row: dense
    "per_q_head": (3, [120, 61], 8, 2, True, 5, False),
    "injected": (4, [150, 100], 8, 2, False, 7, True),
}


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_plain_matches_jax(jx, name):
    c = sparse_case(*SPARSE_CASES[name])
    J = jx.jnp.asarray
    want = jx.sparse(J(c["q"]), J(c["pool"]), J(c["idx"]), J(c["nv"]),
                     J(c["seq"]), sm_scale=c["sm"], layer=LAYER,
                     per_q_head=c["per_q_head"], block_tab=J(c["tab"]),
                     block_pages=c["bpp"], sorted_selection=c["sorted"])
    T = torch.from_numpy
    got = sparse_decode_attention(
        T(c["q"]), T(c["pool"]), T(c["idx"]), T(c["nv"]), T(c["seq"]),
        sm_scale=c["sm"], layer=LAYER, block_tab=T(c["tab"]),
        block_pages=c["bpp"], per_q_head=c["per_q_head"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


DENSE_CASES = {"gqa4": (5, [77, 190], 8, 2), "mha": (6, [1, 64], 2, 2)}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_plain_matches_jax(jx, name):
    seed, seq_lens, Hq, Hkv = DENSE_CASES[name]
    D, page, bpp, NB = 32, 8, 4, 6
    B = len(seq_lens)
    rng, pool, tab = make_pool(seed, B, Hkv, D, page, bpp, NB)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    seq = np.asarray(seq_lens, np.int32)
    sm = 1.0 / np.sqrt(D)
    J = jx.jnp.asarray
    want = jx.dense(J(q), J(pool), J(seq), sm_scale=sm, layer=LAYER,
                    block_tab=J(tab), block_pages=bpp, max_pages=NB * bpp)
    T = torch.from_numpy
    got = dense_decode_attention(T(q), T(pool), T(seq), sm_scale=sm,
                                 layer=LAYER, block_tab=T(tab),
                                 block_pages=bpp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


PREFILL_CASES = {
    "fresh_gqa4": (7, 20, [0, 0], [20, 13], 8, 2),
    "chunked_mha": (8, 24, [37, 5], [61, 29], 2, 2),
    "chunked_gqa4": (9, 16, [70, 0], [86, 0], 8, 2),   # row 1 empty
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_plain_matches_jax(jx, name):
    seed, T_, offs, kv_lens, Hq, Hkv = PREFILL_CASES[name]
    D, page, bpp, NB = 32, 8, 4, 4
    B = len(offs)
    rng, pool, tab = make_pool(seed, B, Hkv, D, page, bpp, NB)
    q = rng.standard_normal((B, T_, Hq, D)).astype(np.float32)
    off = np.asarray(offs, np.int32)
    kvl = np.asarray(kv_lens, np.int32)
    sm = 1.0 / np.sqrt(D)
    J = jx.jnp.asarray
    want = np.asarray(jx.prefill(J(q), J(pool), J(off), J(kvl), sm_scale=sm,
                                 layer=LAYER, block_tab=J(tab),
                                 block_pages=bpp, max_pages=NB * bpp))
    T = torch.from_numpy
    got = prefill_attention(T(q), T(pool), T(off), T(kvl), sm_scale=sm,
                            layer=LAYER, block_tab=T(tab),
                            block_pages=bpp).numpy()
    # Rows of a slot with no key at all are 0/0 in JAX and zeros here.
    live = kvl > 0
    np.testing.assert_allclose(got[live], want[live], rtol=2e-3, atol=2e-3)
    assert np.all(got[~live] == 0)


# --------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only).
# --------------------------------------------------------------------------

def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def card_pool(seed, B, Hkv, NB, dtype, page=16, bpp=8, D=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    NPB = B * NB + 2
    pool = torch.randn((2, Hkv, NPB * bpp, 2, page, D), generator=g,
                       device="cuda").to(dtype)
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(seed))
    tab = (1 + perm[:B * NB]).reshape(B, NB).to(torch.int32).cuda()
    return g, pool, tab


CARD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}


# The serving path hands the kernels a bf16 query (rope casts back to the
# model dtype); an f32 model hands them f32.
Q_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv,per_q_head,inject", [
    (32, 8, False, False), (8, 8, False, False), (64, 8, False, True),
    (32, 8, True, False)])
def test_sparse_kernel_matches_plain(cuda, q_dtype, dtype, Hq, Hkv,
                                     per_q_head, inject):
    B, NB, bpp, page, budget = 3, 6, 8, 16, 20
    g, pool, tab = card_pool(11, B, Hkv, NB, dtype)
    seq = torch.tensor([700, 95, 16], dtype=torch.int32, device=cuda)
    Hsel = Hq if per_q_head else Hkv
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    if inject:
        # Shuffled distinct pages per head; row 2 has one page only.
        idx = torch.zeros((B, Hsel, 6), dtype=torch.int32, device=cuda)
        for b, s in enumerate((700, 95)):
            for h in range(Hsel):
                idx[b, h] = torch.randperm((s + page - 1) // page,
                                           device=cuda)[:6]
        nv = torch.tensor([6, 6, 1], dtype=torch.int32, device=cuda)
    else:
        scores = torch.randn((B, Hsel, NB * bpp), generator=g, device=cuda)
        idx, nv = select_pages(scores, seq, page, budget)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp, per_q_head=per_q_head)
    got = sparse_decode_attention(q, pool, idx, nv, seq, **kw)
    want = sparse_decode_attention_plain(q, pool, idx, nv, seq, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 8), (16, 2)])
def test_dense_kernel_matches_plain(cuda, q_dtype, dtype, Hq, Hkv):
    B, NB, bpp = 3, 8, 8
    g, pool, tab = card_pool(12, B, Hkv, NB, dtype)
    seq = torch.tensor([1021, 1, 500], dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = dense_decode_attention(q, pool, seq, **kw)
    want = dense_decode_attention_plain(q, pool, seq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[dtype]


# The bf16 kernel's CTA takes 128 rows (128 / G positions x G heads) and
# 128-token K/V tiles of whole pages: cases at G = 1, 2, 4, 8, page 16 and
# 32, T and offsets off both tiles, padded rows (kv_len < offset + T),
# an empty row, and tiles that run past the block table (NB * bpp * page).
PREFILL_CARD_CASES = [
    # T, offsets, kv_lens, Hq, Hkv, page, NB, bpp
    (100, [0, 0], [100, 37], 32, 8, 16, 4, 8),
    (64, [300, 17], [364, 50], 8, 8, 16, 4, 8),
    (130, [64, 0], [194, 0], 16, 2, 16, 4, 8),
    (100, [300, 17], [400, 117], 16, 8, 16, 4, 8),
    (77, [200, 0], [277, 77], 32, 8, 32, 4, 4),
    (90, [0, 5], [90, 95], 32, 8, 16, 3, 2),      # 96 tokens in the table
    (40, [0, 8], [40, 48], 8, 8, 16, 3, 1),       # 48 tokens in the table
    (45, [0, 51], [45, 96], 16, 2, 32, 3, 1),     # 96 tokens in the table
]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,offs,kv_lens,Hq,Hkv,page,NB,bpp",
                         PREFILL_CARD_CASES)
def test_prefill_kernel_matches_plain(cuda, q_dtype, dtype, T, offs, kv_lens,
                                      Hq, Hkv, page, NB, bpp):
    B = len(offs)
    g, pool, tab = card_pool(13, B, Hkv, NB, dtype, page=page, bpp=bpp)
    q = torch.randn((B, T, Hq, 128), generator=g, device=cuda).to(q_dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = prefill_attention(q, pool, off, kvl, **kw)
    want = prefill_attention_plain(q, pool, off, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[dtype]
    # A slot with no key at all gives zeros.
    assert torch.all(got[kvl == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float32])
def test_prefill_kernel_masks_keys_past_table(cuda, dtype):
    """A kv_len past the block table's NB * bpp * page = 48 tokens: keys
    past the table do not exist, as in the plain version, in the TMA
    kernel (bf16, fp8 pools) and in the FMA kernel (f32 pools) alike; the
    engine never makes such a row."""
    g, pool, tab = card_pool(15, 2, 2, 3, dtype, page=16, bpp=1)
    q = torch.randn((2, 60, 8, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    off = torch.zeros(2, dtype=torch.int32, device=cuda)
    kvl = torch.tensor([60, 20], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab, block_pages=1)
    got = prefill_attention(q, pool, off, kvl, **kw)
    want = prefill_attention_plain(q, pool, off, kvl, **kw)
    torch.cuda.synchronize()
    assert rel_err(got, want) <= CARD_TOL.get(dtype, CARD_TOL[torch.bfloat16])


def prefill_group_case(device, Hq, Hkv, dtype):
    """A 16-token fresh prefill of one row with Hq // Hkv query heads a
    group, over a random pool of ``dtype``."""
    g = torch.Generator().manual_seed(14)
    pool = torch.randn((2, Hkv, 16, 2, 16, 128), generator=g).to(dtype)
    q = torch.randn((1, 16, Hq, 128), generator=g).to(torch.bfloat16)
    off = torch.zeros(1, dtype=torch.int32)
    args = [t.to(device) for t in (q, pool, off, off + 16)]
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER,
              block_tab=torch.tensor([[1]], dtype=torch.int32, device=device),
              block_pages=8)
    return args, kw


def test_prefill_cpu_takes_any_group():
    """On the CPU the wrapper runs the plain version, whatever the group."""
    args, kw = prefill_group_case("cpu", 12, 4, torch.bfloat16)
    got = prefill_attention(*args, **kw)
    assert torch.equal(got, prefill_attention_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(12, 4), (32, 2)])
def test_prefill_kernel_refuses_group(cuda, Hq, Hkv):
    """The bf16 and fp8 kernel takes G = 1, 2, 4, 8 and raises on any
    other group; the f32 FMA kernel takes every G."""
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        args, kw = prefill_group_case(cuda, Hq, Hkv, dtype)
        with pytest.raises(NotImplementedError, match="GQA groups"):
            prefill_attention(*args, **kw)
    args, kw = prefill_group_case(cuda, Hq, Hkv, torch.float32)
    got = prefill_attention(*args, **kw)
    want = prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert rel_err(got, want) <= CARD_TOL[torch.float32]
