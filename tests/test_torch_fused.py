"""The fused decode slice of the port against the JAX package on the
CPU (Pallas in interpret mode), and its CUDA kernels against their plain
versions (on the card only).

CPU: the streaming estimate, the exact top-K select (ids identical,
ties included), the fused decode op in the shared-pool mode, the
model's fused gate, and the engine with ``fused_decode=True`` against
the JAX engine's unfused path. The JAX side needs ``jax`` and is skipped
without it, so the card cases run on a machine that has no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_fused.py``.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, tiny_test_model
from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.models import llama as tllama
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel, fused_gate, init_params
from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                          page_scores_kernel_plain)
from quest_tpu_torch.ops.fused_decode import (exact_topk_select,
                                              exact_topk_select_plain,
                                              fused_sparse_decode,
                                              fused_sparse_decode_plain,
                                              slot_page_scores)
from quest_tpu_torch.ops.reference import selection_flips
from quest_tpu_torch.ops.topk import select_pages

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LAYER = 1


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (Pallas in interpret mode on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu.ops import fused_decode as jfused
    from quest_tpu.ops.estimate import page_scores_kernel as jest
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, est=jest, fused=jfused.fused_sparse_decode,
        select=jax.jit(jfused._exact_topk_select, static_argnums=(1, 4)),
        compact=jax.jit(jfused._compact_ids, static_argnums=(2,)))


def rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


# --------------------------------------------------------------------------
# Streaming estimate.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("group_agg,meta,stacked", [
    ("sum", "float32", False), ("max", "bfloat16", False),
    ("sum", "bfloat16", True), ("max", "float32", True)])
def test_page_scores_kernel_plain_matches_jax(jx, group_agg, meta, stacked):
    B, Hkv, G, P, D = 2, 2, 4, 256, 64
    rng = np.random.default_rng(31)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    shape = ((3,) if stacked else ()) + (B, Hkv, P, D)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    kmax, kmin = np.maximum(a, b), np.minimum(a, b)
    layer = LAYER if stacked else None
    jdt = getattr(jx.jnp, meta)
    want = jx.est(jx.jnp.asarray(q), jx.jnp.asarray(kmax, jdt),
                  jx.jnp.asarray(kmin, jdt), group_agg=group_agg,
                  layer=layer)
    tdt = getattr(torch, meta)
    T = torch.from_numpy
    got = page_scores_kernel(T(q), T(kmax).to(tdt), T(kmin).to(tdt),
                             group_agg=group_agg, layer=layer)
    assert got.shape == (B, Hkv, P) and got.dtype == torch.float32
    rel_close(got.numpy(), np.asarray(want), 1e-5)


# --------------------------------------------------------------------------
# Exact top-K select: ids identical to _exact_topk_select + _compact_ids.
# --------------------------------------------------------------------------

def jax_select(jx, s, seq, K, page=16):
    P = len(s)
    n = (seq + page - 1) // page
    sel, slot, nv = jx.select(jx.jnp.asarray(s.reshape(P // 128, 128)), 1,
                              jx.jnp.int32(n), jx.jnp.int32(n - 1), K)
    Kp = ((K + 127) // 128) * 128
    ids = np.asarray(jx.compact(sel, slot, Kp))[0, :K].astype(np.int64)
    return ids, int(nv)


def tie_cases():
    """The boundary-tie cases of tests/test_fused_decode.py (scores,
    K, seq_len), and one +0.0 / -0.0 tie."""
    page = 16
    s2 = np.zeros(256, np.float32)
    s2[:10] = 7.0
    s2[10:200] = 3.25
    s3 = np.concatenate([np.full(128, -2.5, np.float32),
                         np.zeros(128, np.float32)])
    s5 = np.zeros(128, np.float32)
    s5[::2] = -0.0
    return [(np.full(256, 1.5, np.float32), 40, 256 * page),
            (s2, 64, 256 * page),
            (s3, 130, 256 * page - 3),
            (np.linspace(0, 1, 128).astype(np.float32), 8, 5),
            (s5, 20, 128 * page)]


def random_cases():
    rng = np.random.default_rng(7)
    out = []
    for P in (128, 256, 512, 2048):
        K = int(rng.integers(2, min(P, 200)))
        seq = int(rng.integers(1, P * 16))
        out.append((rng.standard_normal(P).astype(np.float32) * 10, K, seq))
    return out


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_exact_topk_select_ids_identical_to_jax(jx, kind):
    page = 16
    for s, K, seq in (random_cases() if kind == "random" else tie_cases()):
        want, want_nv = jax_select(jx, s, seq, K, page)
        n = (seq + page - 1) // page
        ids, nv = exact_topk_select(torch.from_numpy(s)[None],
                                    torch.tensor([n]), K)
        assert int(nv[0]) == want_nv == min(K, n)
        assert ids[0].tolist() == want.tolist(), (K, seq)
        if np.any((s == 0) & np.signbit(s)):
            continue     # select_pages compares floats: -0.0 == +0.0
        # The valid ids are select_pages' set, ascending.
        idx, nv2 = select_pages(torch.from_numpy(s)[None, None],
                                torch.tensor([seq]), page, K)
        assert ids[0, :want_nv].tolist() == idx[0, 0, :int(nv2[0])].tolist()


def test_exact_topk_select_rows_and_junk():
    """Several rows at once, num_pages 1, short and long rows; junk
    slots hold page 0; K > P."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    n = torch.tensor([1, 5, 64, 40])
    ids, nv = exact_topk_select(s, n, 8)
    assert nv.tolist() == [1, 5, 8, 8]
    assert ids[0].tolist() == [0] * 8
    assert ids[1].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    for r in (2, 3):
        m = int(n[r])
        top = torch.topk(s[r, :m - 1], 7).indices.tolist()
        assert ids[r].tolist() == sorted(top + [m - 1])
    ids, nv = exact_topk_select(s, n, 80)
    assert nv.tolist() == [1, 5, 64, 40]
    assert ids[2].tolist() == list(range(64)) + [0] * 16


@pytest.mark.parametrize("shape", [(2,), (4, 1), (8,)])
def test_exact_topk_select_rejects_misshapen_num_pages(shape):
    """num_pages needs one entry a row: a [B] vector where [B*Hkv] is
    meant raises (on the card the kernel would read past it)."""
    s = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="num_pages"):
        exact_topk_select(s, torch.ones(shape, dtype=torch.int32), 8)


# --------------------------------------------------------------------------
# Fused decode, shared-pool mode.
# --------------------------------------------------------------------------

def shared_pool(seed, B, Hkv, G, page, D, NB, bpp, seqs, dtype, L=2):
    """A pool [L, Hkv, NP, 2, page, D], its physical-page metadata, a
    shuffled block table (block 0 is scratch) and a query, as numpy."""
    rng = np.random.default_rng(seed)
    NPB = B * NB + 2
    kv = (rng.standard_normal((L, Hkv, NPB * bpp, 2, page, D)) * 0.3).astype(
        np.float32)
    kv = torch.from_numpy(kv).to(dtype)
    k = kv[:, :, :, 0].float()
    kmax = k.amax(dim=3).to(dtype).reshape(L, Hkv, NPB, bpp, D)
    kmin = k.amin(dim=3).to(dtype).reshape(L, Hkv, NPB, bpp, D)
    tab = (1 + rng.permutation(NPB - 1)[:B * NB]).reshape(B, NB)
    q = (rng.standard_normal((B, Hkv * G, D)) * 0.5).astype(np.float32)
    return dict(q=torch.from_numpy(q), kv=kv, kmax=kmax, kmin=kmin,
                tab=torch.from_numpy(tab.astype(np.int32)),
                seq=torch.tensor(seqs, dtype=torch.int32), bpp=bpp,
                sm=1.0 / np.sqrt(D))


# B, Hkv, G, page, D, NB, bpp, K, seqs, dtype, group_agg: 128 logical
# pages a slot. MHA; GQA with a short row (num_pages < K) and a ragged
# last page in bf16; GQA with max aggregation.
FUSED_CASES = {
    "mha_f32": (1, 2, 1, 8, 64, 8, 16, 16, (900,), "float32", "sum"),
    "gqa4_bf16_short": (2, 2, 4, 8, 64, 8, 16, 24, (1001, 77), "bfloat16",
                        "sum"),
    "gqa2_f32_max": (1, 2, 2, 16, 64, 4, 32, 20, (1999,), "float32", "max"),
}


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_plain_matches_jax(jx, name):
    B, Hkv, G, page, D, NB, bpp, K, seqs, dt, agg = FUSED_CASES[name]
    c = shared_pool(11, B, Hkv, G, page, D, NB, bpp, seqs, getattr(torch, dt))
    J = jx.jnp.asarray
    jdt = getattr(jx.jnp, dt)
    want = jx.fused(J(c["q"].numpy()), J(c["kv"].float().numpy(), jdt),
                    J(c["kmax"].float().numpy(), jdt),
                    J(c["kmin"].float().numpy(), jdt), J(c["seq"].numpy()),
                    sm_scale=c["sm"], budget_pages=K, group_agg=agg,
                    layer=LAYER, block_tab=J(c["tab"].numpy()),
                    block_pages=bpp)
    got = fused_sparse_decode(c["q"], c["kv"], c["kmax"], c["kmin"],
                              c["seq"], sm_scale=c["sm"], budget_pages=K,
                              group_agg=agg, layer=LAYER, block_tab=c["tab"],
                              block_pages=bpp)
    rel_close(got.numpy(), np.asarray(want),
              2e-2 if dt == "bfloat16" else 2e-3)


def test_fused_plain_selects_like_the_pipeline():
    """The plain fused op selects the pages that the streaming estimate
    and select_pages select, and on f32 data equals the plain pipeline
    when q and the pool are f32."""
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    c = shared_pool(5, 2, 2, 4, 8, 64, 8, 16, (1000, 200), torch.float32)
    kw = dict(layer=LAYER, block_tab=c["tab"], block_pages=c["bpp"])
    out, ids = fused_sparse_decode(c["q"], c["kv"], c["kmax"], c["kmin"],
                                   c["seq"], sm_scale=c["sm"],
                                   budget_pages=12, return_ids=True, **kw)
    scores = slot_page_scores(c["q"], c["kmax"], c["kmin"], group_agg="sum",
                              **kw)
    idx, nv = select_pages(scores, c["seq"], 8, 12)
    assert torch.equal(ids, idx)
    want = sparse_decode_attention(c["q"], c["kv"], idx, nv, c["seq"],
                                   sm_scale=c["sm"], **kw)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    n = (c["seq"].long() + 7) // 8
    assert selection_flips(ids.reshape(4, 12), idx.reshape(4, 12),
                           scores.reshape(4, -1),
                           n.repeat_interleave(2)) == (0, 0.0)


def test_fused_stages_cpu_smoke(capsys):
    """The stage-clock script's --cpu run: the plain fused op on its kernel
    case (a 2048-token pool), finite."""
    from quest_tpu_torch.exp import fused_stages
    assert fused_stages.main(["--cpu"]) == 0
    assert "finite True" in capsys.readouterr().out


# --------------------------------------------------------------------------
# The model's gate.
# --------------------------------------------------------------------------

GATES = [
    # page, max_seq_len, token_budget, block_pages, selection
    (16, 32768, 2048, 64, "per_kv_head"),     # the serving default: open
    (16, 1024, 2048, 64, "per_kv_head"),      # 64 pages: closed
    (16, 2048, 2048, 64, "per_kv_head"),      # 128 pages: open
    (4, 512, 32, 8, "per_kv_head"),           # open
    (16, 4096, 512, 128, "per_kv_head"),      # 256 pages, fq 128: open
    (16, 2048, 512, 128, "per_kv_head"),      # 128 < 2 * fq: closed
    (16, 16384, 512, 96, "per_kv_head"),      # 96 vs 64 quantum: closed
    (16, 8192, 8192, 32, "per_kv_head"),      # 512 slots: closed
    (16, 8192, 4096, 32, "per_kv_head"),      # 256 slots: open
    (16, 32768, 2048, 64, "per_q_head"),      # closed
]


@pytest.mark.parametrize("page,max_seq_len,budget,bpp,selection", GATES)
def test_fused_gate_matches_jax(jx, monkeypatch, page, max_seq_len, budget,
                                bpp, selection):
    """Stub the attention ops of both models and record which route one
    sparse decode layer takes."""
    import quest_tpu.models.llama as jllama
    from quest_tpu.config import QuestConfig as JQuestConfig
    from quest_tpu.config import tiny_test_model as j_tiny

    kw = dict(page_size=page, max_seq_len=max_seq_len, token_budget=budget,
              block_pages=bpp, selection=selection, fused_decode=True)
    routes = []
    for mod, name in ((jllama, "fused_sparse_decode"),
                      (jllama, "sparse_decode_attention"),
                      (tllama, "fused_sparse_decode"),
                      (tllama, "sparse_decode_attention")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: routes.append(
            _n))
    for mod in (jllama, tllama):
        monkeypatch.setattr(mod, "page_scores_physical", lambda *a, **k: None)
        monkeypatch.setattr(mod, "select_pages", lambda *a, **k: (None, None))

    jq = JQuestConfig(**kw)
    jcache = types.SimpleNamespace(
        block_pages=min(bpp, jq.max_pages), max_pages=jq.max_pages,
        kv_pages=None, k_max=[None] * 3, k_min=[None] * 3, block_tab=None)
    jllama.QuestModel(j_tiny(), jq)._attn_decode(None, jcache, 2, True, None)

    tq = QuestConfig(**kw)
    cfg = tiny_test_model()
    model = QuestModel(cfg, tq, init_params(cfg, torch.Generator(),
                                            device="cpu"))
    tcache = types.SimpleNamespace(**vars(jcache))
    model._attn_decode(None, tcache, 2, True, None)
    assert routes[0] == routes[1]
    assert (routes[1] == "fused_sparse_decode") == fused_gate(
        tq, tcache.max_pages, tcache.block_pages)


# --------------------------------------------------------------------------
# The slice as a whole: the port's fused engine against the JAX engine.
# --------------------------------------------------------------------------

def test_fused_engine_matches_jax_unfused_engine(jx, monkeypatch):
    """Tiny GQA model in f32, the fused gate open (page 4, 128 logical
    pages, 8-page budget), prompts past the budget: greedy tokens
    identical to the JAX engine's unfused path, logits within 2e-3 at
    every step, and every sparse layer through the fused op."""
    from quest_tpu.config import QuestConfig as JQuestConfig
    from quest_tpu.config import tiny_test_model as j_tiny
    from quest_tpu.engine.engine import QuestEngine as JQuestEngine
    from quest_tpu.models.llama import init_params as j_init_params

    jnp = jx.jnp
    quest_kw = dict(page_size=4, token_budget=32, max_seq_len=512,
                    block_pages=8, skip_layers=1)
    jcfg = dataclasses.replace(j_tiny(num_kv_heads=2), dtype=jnp.float32)
    params = jx.jax.tree.map(np.asarray, j_init_params(
        jcfg, jx.jax.random.PRNGKey(4), dtype=jnp.float32))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (120, 103)]
    steps = 5
    jeng = JQuestEngine(jcfg, JQuestConfig(kv_dtype=jnp.float32, **quest_kw),
                        params, batch_size=2, prefill_bucket=16)
    want_logits = [jeng.prefill(prompts)]
    want_tokens = [np.argmax(want_logits[-1], axis=-1).astype(np.int32)]
    for _ in range(steps):
        want_logits.append(jeng.decode(want_tokens[-1]))
        want_tokens.append(np.argmax(want_logits[-1], axis=-1).astype(np.int32))

    quest = QuestConfig(kv_dtype=torch.float32, fused_decode=True, **quest_kw)
    assert fused_gate(quest, quest.max_pages, quest.block_pages)
    calls = []
    real = tllama.fused_sparse_decode
    monkeypatch.setattr(tllama, "fused_sparse_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(tiny_test_model(num_kv_heads=2),
                              dtype=torch.float32)
    eng = QuestEngine(cfg, quest, params_from_numpy(params, device="cpu"),
                      batch_size=2, prefill_bucket=16, device="cpu")
    got = eng.prefill(prompts)
    rel_close(got, want_logits[0], 2e-3)
    for step in range(steps):
        got = eng.decode(want_tokens[step])
        rel_close(got, want_logits[step + 1], 2e-3)
        assert (np.argmax(got, axis=-1) == want_tokens[step + 1]).all()
    assert len(calls) == steps * (cfg.num_layers - quest.skip_layers)
    eng.clear()
    greedy = eng.generate(prompts, max_new_tokens=steps + 1)
    assert greedy == np.stack(want_tokens, axis=1).tolist()


# --------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only).
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def card_rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# Page counts of the estimate's card cases, with the metadata layout: a
# warp takes 16 pages over bf16 and fp8 metadata (4 over f32 at these
# shapes), a CTA four warps, so 700 and 33 leave ragged tiles, 12 and 1
# are below one tile, 64 is a multiple; "stacked" is [L, B, Hkv, P, D]
# read at ``layer``, "flat" is [B, Hkv, P, D].
ESTIMATE_SHAPES = [(700, "stacked"), (12, "flat"), (33, "stacked"),
                   (64, "flat"), (1, "stacked")]


def estimate_operands(g, B, Hkv, P, layout, scale=1.0):
    """k_max / k_min in f32 (a random pair ordered elementwise), of shape
    [2, B, Hkv, P, 128] (stacked) or [B, Hkv, P, 128] (flat), and the
    ``layer`` argument that reads them."""
    lead = (2,) if layout == "stacked" else ()
    a = torch.randn(lead + (B, Hkv, P, 128), generator=g, device="cuda")
    b = torch.randn(lead + (B, Hkv, P, 128), generator=g,
                    device="cuda") * scale
    return (torch.maximum(a, b), torch.minimum(a, b),
            LAYER if layout == "stacked" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("meta", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("P,layout", ESTIMATE_SHAPES)
def test_estimate_kernel_matches_plain(cuda, q_dtype, meta, G, P, layout):
    B, Hkv = 3, 4
    g = torch.Generator(device="cuda").manual_seed(G)
    kmax, kmin, layer = estimate_operands(g, B, Hkv, P, layout)
    kmax, kmin = kmax.to(meta), kmin.to(meta)
    q = torch.randn((B, Hkv * G, 128), generator=g, device=cuda).to(q_dtype)
    agg = "max" if G % 4 else "sum"
    got = page_scores_kernel(q, kmax, kmin, agg, layer=layer)
    want = page_scores_kernel_plain(q, kmax, kmin, agg, layer=layer)
    torch.cuda.synchronize()
    assert got.shape == (B, Hkv, P)
    assert card_rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "short", "all_equal", "one_page",
                                  "ties", "signed_zeros"])
def test_select_kernel_bitwise(cuda, case):
    R, P, K = 6, 1000, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    s = torch.randn((R, P), generator=g, device=cuda) * 10
    n = torch.tensor([1000, 999, 700, 129, 128, 300], device=cuda)
    if case == "short":
        n = torch.tensor([1, 2, 127, 50, 5, 128], device=cuda)
    elif case == "all_equal":
        s = torch.full((R, P), 1.5, device=cuda)
    elif case == "one_page":
        n = torch.ones(R, dtype=torch.int64, device=cuda)
    elif case == "ties":
        s = torch.round(s / 8)                       # few distinct values
    elif case == "signed_zeros":
        s = torch.zeros((R, P), device=cuda)
        s[:, ::3] = -0.0
    ids, nv = exact_topk_select(s, n, K)
    want, want_nv = exact_topk_select_plain(s, n, K)
    torch.cuda.synchronize()
    assert torch.equal(nv, want_nv)
    assert torch.equal(ids, want)


@pytest.mark.cuda
def test_select_kernel_rejects_misshapen_num_pages(cuda):
    s = torch.zeros((16, 256), device=cuda)
    with pytest.raises(ValueError, match="num_pages"):
        exact_topk_select(s, torch.ones(2, dtype=torch.int32, device=cuda), 8)


def kernel_selection(q, kmax, kmin, tab, bpp, seq, page, K, agg):
    """The plain selection over the streaming estimate kernel's scores of
    every logical page of every row, which are bit for bit the fused
    kernel's own (the same device code on the same query split)."""
    Hkv, D = kmax.shape[1], kmax.shape[-1]
    B = tab.shape[0]
    phys = (tab.long()[:, :, None] * bpp
            + torch.arange(bpp, device=tab.device)).reshape(B, -1)
    km = kmax[LAYER].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    kn = kmin[LAYER].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    scores = page_scores_kernel(q, km, kn, agg)
    n = ((seq.long() + page - 1) // page).repeat_interleave(Hkv)
    ids, _ = exact_topk_select_plain(scores.reshape(B * Hkv, -1), n, K)
    return ids.reshape(B, Hkv, K)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool,meta", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [16, 32])
def test_fused_kernel_matches_plain(cuda, q_dtype, pool, meta, G, page):
    B, Hkv, NB, bpp, K = 4, 2, 6, 32, 40
    g = torch.Generator(device="cuda").manual_seed(G)
    NPB = B * NB + 2
    kv = torch.randn((2, Hkv, NPB * bpp, 2, page, 128), generator=g,
                     device=cuda).to(pool)
    k = kv[:, :, :, 0].float()
    kmax = k.amax(dim=3).to(meta).reshape(2, Hkv, NPB, bpp, 128)
    kmin = k.amin(dim=3).to(meta).reshape(2, Hkv, NPB, bpp, 128)
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(G))
    tab = (1 + perm[:B * NB]).reshape(B, NB).to(torch.int32).to(cuda)
    # A long row, a row of 20 pages (< K), one page, a ragged last page.
    seq = torch.tensor([NB * bpp * page, 20 * page, 9, 1500], device=cuda,
                       dtype=torch.int32)
    q = torch.randn((B, Hkv * G, 128), generator=g, device=cuda).to(q_dtype)
    kw = dict(sm_scale=128 ** -0.5, budget_pages=K, layer=LAYER,
              block_tab=tab, block_pages=bpp,
              group_agg="max" if G == 2 else "sum", return_ids=True)
    got, ids = fused_sparse_decode(q, kv, kmax, kmin, seq, **kw)
    want, want_ids = fused_sparse_decode_plain(q, kv, kmax, kmin, seq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 2e-2 if torch.bfloat16 in (pool, meta) else 2e-3
    assert card_rel_err(got, want) <= tol
    scores = slot_page_scores(q, kmax, kmin, layer=LAYER, block_tab=tab,
                              block_pages=bpp, group_agg=kw["group_agg"])
    n = ((seq.long() + page - 1) // page).repeat_interleave(Hkv)
    flips, worst = selection_flips(ids.reshape(B * Hkv, K),
                                   want_ids.reshape(B * Hkv, K),
                                   scores.reshape(B * Hkv, -1), n)
    assert flips == 0 or worst <= 1e-5, (flips, worst)
    assert torch.equal(ids, kernel_selection(q, kmax, kmin, tab, bpp, seq,
                                             page, K, kw["group_agg"]))


def tie_levels(case, P=320):
    """Per-page score levels of one tie case (row of P = 320 pages at page
    16, split over the cluster's 8 CTAs in segments of ceil(n / 8) pages),
    with its seq_len and K."""
    rng = np.random.default_rng(9)
    lev = rng.integers(1, 5, P).astype(np.float32)
    if case == "straddle":       # n = 203 (segments of 26): the tie band
        lev[:20] = 10 + np.arange(20)    # 20..80 holds the boundary and
        lev[20:81] = 5                   # crosses segments at 26, 52, 78
        return lev, 203 * 16 - 5, 70
    if case == "all_equal":      # every page ties; 63 + the last taken
        return np.full(P, 3, np.float32), P * 16, 64
    if case == "one_page":
        return lev, 9, 16
    if case == "short":          # n = 37 < K, every page taken
        return lev, 37 * 16 - 3, 64
    if case == "k1":             # only the last page (+inf)
        return lev, 100 * 16 - 1, 1
    if case == "k256":           # n = 300, 10 levels, ties at the boundary
        return rng.integers(0, 10, P).astype(np.float32), 300 * 16 - 7, 256
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("pool,meta", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32)])
@pytest.mark.parametrize("case", ["straddle", "all_equal", "one_page",
                                  "short", "k1", "k256"])
def test_fused_kernel_select_ties(cuda, pool, meta, case):
    """Exact ties inside one CTA's segment and across the cluster's
    segment boundaries, an all-equal row, n = 1, n < K, n off a multiple
    of 8, K = 1 and K = 256: the metadata rows hold one integer level a
    page and q is all ones, so scores are exact and equal levels tie
    exactly. The ids are bit for bit the plain selection."""
    Hkv, G, page, NB, bpp, D = 2, 4, 16, 10, 32, 128
    lev, seq_len, K = tie_levels(case)
    g = torch.Generator(device="cuda").manual_seed(3)
    NPB = NB + 2
    kv = torch.randn((2, Hkv, NPB * bpp, 2, page, D), generator=g,
                     device=cuda).to(pool)
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(3))
    tab = (1 + perm[:NB]).reshape(1, NB).to(torch.int32).to(cuda)
    phys = (tab.long()[0, :, None] * bpp
            + torch.arange(bpp, device=cuda)).reshape(-1)
    levels = torch.from_numpy(np.stack([lev, np.roll(lev, 7)])).to(cuda)
    meta_f = torch.zeros((2, Hkv, NPB * bpp, D), device=cuda)
    meta_f[LAYER][:, phys] = levels[:, :, None].expand(-1, -1, D)
    kmax = kmin = meta_f.to(meta).reshape(2, Hkv, NPB, bpp, D)
    q = torch.ones((1, Hkv * G, D), device=cuda, dtype=torch.bfloat16)
    seq = torch.tensor([seq_len], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=D ** -0.5, budget_pages=K, layer=LAYER,
              block_tab=tab, block_pages=bpp, group_agg="sum",
              return_ids=True)
    got, ids = fused_sparse_decode(q, kv, kmax, kmin, seq, **kw)
    want, want_ids = fused_sparse_decode_plain(q, kv, kmax, kmin, seq, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ids, want_ids)
    assert torch.equal(ids, kernel_selection(q, kmax, kmin, tab, bpp, seq,
                                             page, K, "sum"))
    assert torch.isfinite(got).all()
    tol = 2e-2 if pool == torch.bfloat16 else 2e-3
    assert card_rel_err(got, want) <= tol
