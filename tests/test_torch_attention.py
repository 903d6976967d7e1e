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

from quest_tpu_torch.ops.decode_common import (MAX_SPLITS, decode_plan,
                                               workspace)
from quest_tpu_torch.ops.dense_decode import (dense_decode_attention,
                                              dense_decode_attention_plain)
from quest_tpu_torch.ops.prefill import (TMA_PAGES, prefill_attention,
                                         prefill_attention_plain,
                                         prefill_route)
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


def sparse_case(seed, seq_lens, Hq, Hkv, per_q_head, budget, inject,
                page=8):
    D, NB = 32, 6
    bpp = 32 // page              # 192 tokens of table at every page size
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
    "gqa4_page4": (21, [77, 150], 8, 2, False, 12, False, 4),
    "per_q_head_page16": (22, [120, 61], 8, 2, True, 3, False, 16),
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


DENSE_CASES = {"gqa4": (5, [77, 190], 8, 2), "mha": (6, [1, 64], 2, 2),
               "gqa4_page4": (23, [77, 190], 8, 2, 4),
               "mha_page16": (24, [1, 131], 2, 2, 16)}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_plain_matches_jax(jx, name):
    seed, seq_lens, Hq, Hkv, page = (DENSE_CASES[name] + (8,))[:5]
    D, NB = 32, 6
    bpp = 32 // page              # 192 tokens of table at every page size
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


# GQA groups the presets do not have (Qwen2-7B has 7, Qwen2.5-14B 5) and
# groups above the kernels' 16-head CTA (sub-groups), two KV heads each.
GROUPS = [3, 6, 16, 32]
GROUP_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def group_case(kernel, G, dtype, seed=40):
    """One call's operands at a GQA group of G over two KV heads, as numpy
    (f32; a bf16 pool is the f32 values rounded once, handed to both
    sides): a shuffled table, rows ending mid-page, a chunked prefill."""
    D, page, bpp, NB, Hkv = 32, 8, 4, 6, 2
    rng, pool, tab = make_pool(seed + G, 2, Hkv, D, page, bpp, NB)
    if dtype == "bfloat16":
        pool = torch.from_numpy(pool).bfloat16().float().numpy()
    c = dict(pool=pool, tab=tab, bpp=bpp, sm=1.0 / np.sqrt(D),
             max_pages=NB * bpp)
    if kernel == "prefill":
        c.update(q=rng.standard_normal((2, 20, Hkv * G, D)).astype(np.float32),
                 off=np.asarray([37, 0], np.int32),
                 kvl=np.asarray([57, 13], np.int32))
        return c
    seq = np.asarray([150, 61], np.int32)
    c.update(q=rng.standard_normal((2, Hkv * G, D)).astype(np.float32),
             seq=seq)
    if kernel == "sparse":
        scores = rng.standard_normal((2, Hkv, NB * bpp)).astype(np.float32)
        idx, nv = select_pages(torch.from_numpy(scores),
                               torch.from_numpy(seq), page, 5)
        c.update(idx=idx.numpy(), nv=nv.numpy())
    return c


def group_call(kernel, c, T, **extra):
    """The port's wrapper (T: numpy -> tensor) on a group case."""
    kw = dict(sm_scale=c["sm"], layer=LAYER, block_tab=T(c["tab"]),
              block_pages=c["bpp"], **extra)
    if kernel == "sparse":
        return sparse_decode_attention(T(c["q"]), T(c["pool"]), T(c["idx"]),
                                       T(c["nv"]), T(c["seq"]), **kw)
    if kernel == "dense":
        return dense_decode_attention(T(c["q"]), T(c["pool"]), T(c["seq"]),
                                      **kw)
    return prefill_attention(T(c["q"]), T(c["pool"]), T(c["off"]),
                             T(c["kvl"]), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("kernel", ["sparse", "dense", "prefill"])
def test_group_plain_matches_jax(jx, kernel, G, dtype):
    """Each decode-side kernel's plain version against the JAX kernel
    (Pallas, interpret mode) at groups of 3, 6, 16 and 32 query heads a KV
    head, f32 and bf16 pools: within 2e-4 and 2e-2 (max |d| / max |JAX|)."""
    c = group_case(kernel, G, dtype)
    J = jx.jnp.asarray
    pool = J(c["pool"], getattr(jx.jnp, dtype))
    common = dict(sm_scale=c["sm"], layer=LAYER, block_tab=J(c["tab"]),
                  block_pages=c["bpp"])
    if kernel == "sparse":
        want = jx.sparse(J(c["q"]), pool, J(c["idx"]), J(c["nv"]),
                         J(c["seq"]), sorted_selection=True, **common)
    elif kernel == "dense":
        want = jx.dense(J(c["q"]), pool, J(c["seq"]),
                        max_pages=c["max_pages"], **common)
    else:
        want = jx.prefill(J(c["q"]), pool, J(c["off"]), J(c["kvl"]),
                          max_pages=c["max_pages"], **common)
    tdt = getattr(torch, dtype)
    got = group_call(kernel, c, lambda a: (torch.from_numpy(a).to(tdt)
                                           if a is c["pool"]
                                           else torch.from_numpy(a)))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= GROUP_TOL[dtype], err


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


# Pools of every dtype the decode kernels take: bf16 and fp8 e4m3 go
# through the ring kernel, f32 through the FMA body.
POOL_DTYPES = [torch.bfloat16, torch.float8_e4m3fn, torch.float32]
DECODE_PAGES = [4, 8, 16, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("page", DECODE_PAGES)
@pytest.mark.parametrize("Hq,Hkv,per_q_head,inject", [
    (32, 8, False, False), (8, 8, False, False), (64, 8, False, True),
    (32, 8, True, False)])
def test_sparse_kernel_matches_plain(cuda, q_dtype, dtype, page, Hq, Hkv,
                                     per_q_head, inject):
    """Rows of 700 tokens (ending mid-page), 95 (fewer pages than the
    budget: num_valid < S) and one token, at every page size."""
    B, NB, budget = 3, 6, 20
    bpp = 128 // page                 # 768 tokens of table at every page
    g, pool, tab = card_pool(11, B, Hkv, NB, dtype, page=page, bpp=bpp)
    seq = torch.tensor([700, 95, 1], dtype=torch.int32, device=cuda)
    Hsel = Hq if per_q_head else Hkv
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    if inject:
        # Shuffled distinct pages per head (at most 6); row 2 has one page
        # only.
        idx = torch.zeros((B, Hsel, 6), dtype=torch.int32, device=cuda)
        n_pages = [min(6, (s + page - 1) // page) for s in (700, 95, 1)]
        for b, s in enumerate((700, 95)):
            for h in range(Hsel):
                idx[b, h, :n_pages[b]] = torch.randperm(
                    (s + page - 1) // page, device=cuda)[:6]
        nv = torch.tensor(n_pages, dtype=torch.int32, device=cuda)
    else:
        scores = torch.randn((B, Hsel, NB * bpp), generator=g, device=cuda)
        idx, nv = select_pages(scores, seq, page, budget)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp, per_q_head=per_q_head)
    got = sparse_decode_attention(q, pool, idx, nv, seq, **kw)
    want = sparse_decode_attention_plain(q, pool, idx, nv, seq, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL.get(dtype, CARD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("page", DECODE_PAGES)
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 8), (16, 2)])
def test_dense_kernel_matches_plain(cuda, q_dtype, dtype, page, Hq, Hkv):
    """Rows of 1021 tokens (several splits, ending mid-page), one token
    and 500, at every page size."""
    B, NB = 3, 8
    bpp = 128 // page                 # 1024 tokens of table at every page
    g, pool, tab = card_pool(12, B, Hkv, NB, dtype, page=page, bpp=bpp)
    seq = torch.tensor([1021, 1, 500], dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(q_dtype)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    got = dense_decode_attention(q, pool, seq, **kw)
    want = dense_decode_attention_plain(q, pool, seq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL.get(dtype, CARD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", POOL_DTYPES)
def test_decode_kernels_repeat_bitwise(cuda, dtype):
    """Two calls in a row on the same inputs give the same bits: the
    splits merge in a fixed order, and the merge tickets the first call
    leaves are zero for the second (a row of 4000 tokens merges 8 dense
    splits; 64 selected pages, 8 sparse splits)."""
    B, Hq, Hkv, NB, bpp, page = 2, 32, 8, 16, 16, 16
    g, pool, tab = card_pool(16, B, Hkv, NB, dtype, page=page, bpp=bpp)
    seq = torch.tensor([4000, 700], dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hq, 128), generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    scores = torch.randn((B, Hkv, NB * bpp), generator=g, device=cuda)
    idx, nv = select_pages(scores, seq, page, 64)
    for call in (lambda: dense_decode_attention(q, pool, seq, **kw),
                 lambda: sparse_decode_attention(q, pool, idx, nv, seq, **kw)):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_decode_plan_reads_shapes_only():
    """The decode launch plan is a function of shapes and the card's SM
    count (ints), never of a tensor's values: the wrappers read no device
    value on the host, so a decode step has no host sync. A full table
    spreads over one wave of CTAs, no split below min_tokens, at most
    MAX_SPLITS a (row, head); one ticket a (row, head)."""
    # Dense at the kernel case: 2048 pages of 16 tokens, 264 CTAs a wave.
    p = decode_plan(2, 8, 4, 16, 2048, 512, 264)
    assert (p.per_split, p.nsplit, p.grid) == (128, 16, (16, 8, 2))
    assert (p.part_o, p.part_ml, p.tickets) == (2 * 8 * 16 * 4 * 128,
                                                2 * 8 * 16 * 4 * 2, 16)
    # A short table keeps splits of at least min_tokens tokens.
    assert decode_plan(2, 8, 4, 16, 64, 512, 264).per_split == 32
    # Sparse: a 2048-token budget at any page size fills the same wave.
    for page, per in ((4, 32), (8, 16), (16, 8), (32, 4)):
        q = decode_plan(2, 8, 4, page, 2048 // page, 128, 264)
        assert (q.per_split, q.nsplit, q.grid) == (per, 16, (16, 8, 2))
    # Per-query-head selection: 32 selection heads a row.
    assert decode_plan(2, 32, 1, 16, 128, 128, 264).grid == (4, 32, 2)
    # A long table at page 1: at most MAX_SPLITS splits merge.
    r = decode_plan(1, 8, 8, 1, 1 << 20, 512, 8 * MAX_SPLITS * 4)
    assert r.nsplit <= MAX_SPLITS and r.nsplit * r.per_split >= 1 << 20
    assert decode_plan(1, 1, 1, 16, 0, 512, 264).nsplit == 1


def test_decode_workspace_is_cached_and_grown():
    """One workspace a device, reused by a smaller plan and grown (its
    tickets zeroed) for a larger one."""
    dev = torch.device("cpu")
    small, large = decode_plan(1, 2, 4, 16, 64, 128, 264), decode_plan(
        2, 8, 4, 16, 2048, 512, 264)
    o1, ml1, t1 = workspace(dev, small)
    o2, ml2, t2 = workspace(dev, small)
    assert o1.data_ptr() == o2.data_ptr() and t1.data_ptr() == t2.data_ptr()
    o3, ml3, t3 = workspace(dev, large)
    assert (o3.numel(), ml3.numel(), t3.numel()) == (
        large.part_o, large.part_ml, large.tickets)
    assert torch.all(t3 == 0)
    o4, _, _ = workspace(dev, small)
    assert o4.data_ptr() == o3.data_ptr()


def test_decode_ablation_cpu_smoke(capsys):
    """The decode ablation script's --cpu run: the plain dense op on a
    small pool, finite."""
    from quest_tpu_torch.exp import decode_ablation
    assert decode_ablation.main(["--cpu"]) == 0
    assert "finite True" in capsys.readouterr().out


@pytest.mark.parametrize("dtype,page,G,route", [
    (torch.bfloat16, 16, 4, "tma"), (torch.bfloat16, 4, 4, "fma"),
    (torch.float8_e4m3fn, 4, 1, "fma"), (torch.float8_e4m3fn, 32, 8, "tma"),
    (torch.bfloat16, 256, 2, "fma"), (torch.float32, 16, 4, "fma"),
    (torch.float32, 4, 3, "fma")])
def test_prefill_route_by_shape(dtype, page, G, route):
    """The prefill wrapper picks its card kernel by dtype and page alone:
    TMA + wgmma for bf16 and fp8 pools with pages in TMA_PAGES, the FMA
    kernel for f32 pools and for other pages, whatever the group."""
    assert prefill_route(dtype, page, G) == route
    assert (route == "tma") == (dtype != torch.float32 and page in TMA_PAGES)


def test_prefill_route_refuses_group():
    """No GQA group is refused any more: bf16 and fp8 pools take groups of
    3, 5, 7, 16 and 32 on either route (padded to 4, 8, 8, 16 and sub-groups
    of 16); only a group of no head is."""
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        for page in (4, 16):
            for G in (3, 5, 7, 16, 32):
                assert prefill_route(dtype, page, G) == (
                    "tma" if page in TMA_PAGES else "fma")
            with pytest.raises(ValueError, match="GQA group"):
                prefill_route(dtype, page, 0)


# The bf16 kernel's CTA takes 128 rows (128 / G positions x G heads) and
# 128-token K/V tiles of whole pages: cases at G = 1, 2, 4, 8, page 16 and
# 32, T and offsets off both tiles, padded rows (kv_len < offset + T),
# an empty row (kv_len 0), a row with cached keys and no new token
# (kv_len == offset > 0), and tiles that run past the block table
# (NB * bpp * page).
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
    (96, [0, 250, 0], [96, 250, 0], 16, 4, 16, 4, 8),
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
    """The groups the bf16 and fp8 kernel once refused (3, and 16 a KV
    head) now run on it, as on the f32 FMA kernel, within their
    tolerance of the plain version."""
    for dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float32):
        args, kw = prefill_group_case(cuda, Hq, Hkv, dtype)
        got = prefill_attention(*args, **kw)
        want = prefill_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        assert rel_err(got, want) <= CARD_TOL.get(dtype,
                                                  CARD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("page", [4, 24])
def test_prefill_kernel_small_pages(cuda, q_dtype, dtype, page):
    """bf16 and fp8 pools with pages the TMA kernel does not box take the
    FMA kernel on their element type (fresh and chunked rows, an empty
    row, GQA 4)."""
    B, Hq, Hkv, NB = 2, 32, 8, 4
    bpp = 96 // page
    g, pool, tab = card_pool(17, B, Hkv, NB, dtype, page=page, bpp=bpp)
    q = torch.randn((B, 70, Hq, 128), generator=g, device=cuda).to(q_dtype)
    off = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    kvl = torch.tensor([70, 263], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    assert prefill_route(dtype, page, Hq // Hkv) == "fma"
    got = prefill_attention(q, pool, off, kvl, **kw)
    want = prefill_attention_plain(q, pool, off, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("kernel", ["sparse", "dense", "prefill"])
def test_group_kernels_match_plain(cuda, kernel, G, dtype, q_dtype):
    """Groups of 3, 6, 16 and 32 query heads a KV head (padded to 4, 8 and
    16 heads a CTA; 32 runs two sub-groups of 16) on the card kernels of
    every pool dtype, against the plain versions: rows of 700 tokens and
    of one, a chunked and a fresh prefill (a padded head written would
    land on another head's row)."""
    B, Hkv, NB, page = 2, 2, 6, 16
    bpp = 128 // page
    g, pool, tab = card_pool(21 + G, B, Hkv, NB, dtype, page=page, bpp=bpp)
    kw = dict(sm_scale=128 ** -0.5, layer=LAYER, block_tab=tab,
              block_pages=bpp)
    if kernel == "prefill":
        q = torch.randn((B, 70, Hkv * G, 128), generator=g,
                        device=cuda).to(q_dtype)
        args = (q, pool, torch.tensor([200, 0], dtype=torch.int32,
                                      device=cuda),
                torch.tensor([270, 61], dtype=torch.int32, device=cuda))
        got = prefill_attention(*args, **kw)
        want = prefill_attention_plain(*args, **kw)
    else:
        seq = torch.tensor([700, 1], dtype=torch.int32, device=cuda)
        q = torch.randn((B, Hkv * G, 128), generator=g,
                        device=cuda).to(q_dtype)
        if kernel == "sparse":
            scores = torch.randn((B, Hkv, NB * bpp), generator=g,
                                 device=cuda)
            idx, nv = select_pages(scores, seq, page, 20)
            got = sparse_decode_attention(q, pool, idx, nv, seq, **kw)
            want = sparse_decode_attention_plain(q, pool, idx, nv, seq, **kw)
        else:
            got = dense_decode_attention(q, pool, seq, **kw)
            want = dense_decode_attention_plain(q, pool, seq, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert rel_err(got, want) <= CARD_TOL.get(dtype, CARD_TOL[torch.bfloat16])
