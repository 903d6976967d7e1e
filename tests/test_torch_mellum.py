"""Mellum2's block in the port (window layers beside Quest's full layers,
YaRN and plain rope, a softmax router over SwiGLU experts) against the
benchmark's plain reference, ``benchmark/reference/mellum_ref.py``,
loaded by path: one reference for the benchmark and the tests.

A tiny configuration keeps Mellum2's pattern: 8 layers, three window
layers then a full one, twice; a 32-token window; 8 experts, 2 a token;
heads of 32; page 16, a 32-token budget (so Quest selects past 32
tokens), 64-token allocation blocks, ``skip_layers`` 2. Everything runs
in f32 on the CPU through ``ContinuousBatchingEngine``; the card cases
(``cuda`` marker) hold the kernels to the plain path:
``python -m pytest --noconftest -m cuda tests/test_torch_mellum.py``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import (FULL, WINDOW, ModelConfig, QuestConfig,
                                    RopeConfig, SparseWindowConfig)
from quest_tpu_torch.engine import ContinuousBatchingEngine, Request
from quest_tpu_torch.engine.graphs import eager
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.llama import LAYER_KEYS, QuestModel, init_params
from quest_tpu_torch.ops.moe import (KERNEL_ROWS, moe_experts,
                                     moe_experts_grouped, moe_experts_plain,
                                     moe_route, moe_route_plain)
from quest_tpu_torch.utils.trace import RECORDER

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"mellum_test_{name}", BENCH / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


REF = _load("mellum_ref")
QREF = sys.modules["reference.quest_ref"]     # the one REF imports

W = 32                      # the window
PATTERN = (WINDOW, WINDOW, WINDOW, FULL) * 2


def make_cfg(dtype=torch.float32, head_dim=32, **kw) -> SparseWindowConfig:
    args = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=8,
        num_heads=4, num_kv_heads=2, head_dim=head_dim, rms_norm_eps=1e-6,
        max_position_embeddings=1024,
        rope=RopeConfig(theta=5e5, scaling="yarn", factor=4.0,
                        original_max_position_embeddings=128),
        layer_types=PATTERN, sliding_window=W,
        window_rope=RopeConfig(theta=5e5), num_experts=8,
        num_experts_per_tok=2, moe_intermediate_size=48, dtype=dtype)
    args.update(kw)
    return SparseWindowConfig(**args)


def make_quest(dtype=torch.float32) -> QuestConfig:
    return QuestConfig(page_size=16, token_budget=32, max_seq_len=512,
                       skip_layers=2, block_pages=4, kv_dtype=dtype)


def ref_shape(cfg: ModelConfig, quest: QuestConfig):
    return REF.MellumShape(
        quest=QREF.Shape(hidden=cfg.hidden_size, layers=cfg.num_layers,
                         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                         head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
                         rope_theta=cfg.rope.theta, page=quest.page_size,
                         budget_tokens=quest.token_budget,
                         skip_layers=quest.skip_layers),
        windowed=tuple(cfg.is_window(l) for l in range(cfg.num_layers)),
        window=cfg.sliding_window, window_theta=cfg.window_rope.theta,
        yarn_factor=cfg.rope.factor,
        yarn_original=cfg.rope.original_max_position_embeddings,
        beta_fast=cfg.rope.beta_fast, beta_slow=cfg.rope.beta_slow,
        experts=cfg.num_experts, top_k=cfg.num_experts_per_tok)


@pytest.fixture(scope="module")
def model():
    cfg, quest = make_cfg(), make_quest()
    params = init_params(cfg, torch.Generator().manual_seed(7),
                         dtype=torch.float32, device="cpu")
    # Larger embeddings than init_params' 0.02, so the residual stream and
    # the logits are of order one and the decisions are not all ties.
    params["embed"].mul_(50.0)
    return cfg, quest, params


def engine(model, **kw):
    cfg, quest, params = model
    args = dict(max_batch=2, prefill_bucket=8, burst=4, prefill_chunk=48,
                total_pages=16 * 40, device="cpu")
    args.update(kw)
    return ContinuousBatchingEngine(cfg, quest, params, **args)


def served_logits(eng, req, feed=None):
    """Serve ``req`` alone on ``eng``; (its tokens, the logits each was
    chosen from [n, V]): the prefill's last, then each decode step's.
    With ``feed`` (tokens), decode step i is fed ``feed[i]`` in place of
    the engine's own token."""
    rec = []
    fed = iter(feed or ())
    prefill_last, decode_step = eng.model.prefill_last, eng.model.decode_step

    def on_prefill(cache, toks, new_lens=None):
        out = prefill_last(cache, toks, new_lens)
        rec.append(("p", out[0, 0].clone()))
        return out

    def on_decode(cache, tokens, active=None):
        b = int(np.flatnonzero(active.cpu().numpy())[0])
        if feed is not None:
            tokens = tokens.clone()
            tokens[b] = next(fed)
        out = decode_step(cache, tokens, active)
        rec.append(("d", out[b].clone()))
        return out

    eng.model.prefill_last, eng.model.decode_step = on_prefill, on_decode
    try:
        toks = eng.run([req])[req.uid]
    finally:
        del eng.model.prefill_last, eng.model.decode_step
    first = max(i for i, (k, _) in enumerate(rec) if k == "p")
    logits = [rec[first][1]] + [t for k, t in rec[first + 1:] if k == "d"]
    return toks, torch.stack(logits[:len(toks)])


def reference(model, doc, tail, toks, low_precision=False):
    cfg, quest, params = model
    seq = QREF.Sequence_(tail=torch.tensor(tail), served=torch.tensor(toks))
    return REF.forward_logits(params, ref_shape(cfg, quest),
                              torch.tensor(doc), [seq],
                              low_precision=low_precision, block=64)[0]


def gaps(logits, toks, ref):
    """(largest |program - reference| logit of the served token, largest
    amount by which it lies below the reference's best)."""
    served = torch.tensor(toks)
    prog = logits.gather(1, served[:, None])[:, 0]
    return (float((prog - ref["served"]).abs().max()),
            float((ref["best"] - ref["served"]).max()))


# The program and the reference are both f32: the same products in
# another order (blocked attention, grouped experts, the paged cache)
# differ by 3.6e-6 of logits up to 4.3 here. The tolerance, 2e-3, leaves
# 500 times that; the reference in fp8 (the control) lies 1.9 away, 1000
# times the tolerance, and the test asks for at least 10 times.
TOL = 2e-3


def rng_tokens(seed, n):
    return np.random.default_rng(seed).integers(1, 256, n).tolist()


def test_prefill_and_decode_across_the_window_match_the_reference(model):
    # 150 + 10 prompt tokens in chunks of 48 (window edges inside and
    # across chunks), then 60 decode steps: past the window, across
    # allocation blocks, with Quest selecting on the full layers.
    doc, tail = rng_tokens(1, 150), rng_tokens(2, 10)
    eng = engine(model)
    toks, logits = served_logits(eng, Request(0, doc + tail, 60))
    assert len(toks) == 60 and len(set(toks)) > 5
    ref = reference(model, doc, tail, toks)
    diff, below = gaps(logits, toks, ref)
    assert diff <= TOL and below <= TOL, (diff, below)
    low = reference(model, doc, tail, toks, low_precision=True)
    ldiff, lbelow = gaps(logits, toks, low)
    assert max(ldiff, lbelow) > 10 * TOL, (ldiff, lbelow)


def test_router_ids_are_the_references():
    g = torch.Generator().manual_seed(3)
    h = torch.randn(200, 64, generator=g)
    w = torch.randn(64, 8, generator=g) / 8.0
    ids, wts = moe_route(h, w, 2)
    rids, rwts = REF.route(h, w, 2)
    assert torch.equal(ids.long(), rids)
    assert torch.allclose(wts, rwts, atol=1e-6)
    assert torch.allclose(wts.sum(-1), torch.ones(200), atol=1e-6)


@pytest.mark.parametrize("N", [12, 40])
@pytest.mark.parametrize("path", [moe_experts_plain, moe_experts_grouped])
def test_experts_are_each_tokens_weighted_sum(path, N):
    g = torch.Generator().manual_seed(4)
    H, E, I, k = 16, 6, 8, 2
    h = torch.randn(N, H, generator=g)
    wg, wu = (torch.randn(E, H, I, generator=g) for _ in range(2))
    wd = torch.randn(E, I, H, generator=g)
    ids, wts = moe_route_plain(h, torch.randn(H, E, generator=g), k)
    active = torch.arange(N) % 3 != 0
    count = torch.zeros(1, dtype=torch.int32)
    out = path(h, ids, wts, wg, wu, wd, active, count)
    for n in range(N):
        want = torch.zeros(H)
        if active[n]:
            for j in range(k):
                e = int(ids[n, j])
                a = torch.nn.functional.silu(h[n] @ wg[e]) * (h[n] @ wu[e])
                want += wts[n, j] * (a @ wd[e])
        assert torch.allclose(out[n], want, atol=1e-5), n
    assert int(count) == len(set(ids[active].flatten().tolist()))


def test_the_experts_kernels_refuse_cpu_rows_and_chunks():
    h = torch.zeros(KERNEL_ROWS, 16)
    ids = torch.zeros(KERNEL_ROWS, 2, dtype=torch.int32)
    w = torch.zeros(4, 16, 16)
    with pytest.raises(ValueError, match="at most 16 rows on the card"):
        moe_experts(h, ids, ids.float(), w, w, w)


def test_prefix_hit_restores_the_window_state(model):
    doc = rng_tokens(5, 192)                      # 3 blocks of 64
    qa, qb = rng_tokens(6, 9), rng_tokens(7, 12)
    warm = engine(model)
    warm.run([Request(0, doc + qa, 5)])
    hits = warm.prefix_hit_tokens
    toks, logits = served_logits(warm, Request(1, doc + qb, 40))
    assert warm.prefix_hit_tokens - hits == 192
    assert warm.prefix_hits == 1
    cold_toks, cold = served_logits(engine(model), Request(1, doc + qb, 40))
    assert toks == cold_toks
    assert torch.allclose(logits, cold, atol=TOL, rtol=0)


def test_a_boundary_without_window_state_backs_off(model):
    doc = rng_tokens(8, 192)
    eng = engine(model)
    eng.run([Request(0, doc + rng_tokens(9, 9), 3)])
    # doc[:128] + a tail: blocks 1 and 2 are registered, but only the
    # prompt's last full block (3) kept its window state.
    short = doc[:128] + rng_tokens(10, 11)
    toks, logits = served_logits(eng, Request(1, short, 20))
    assert eng.prefix_hit_tokens == 0
    cold_toks, cold = served_logits(engine(model), Request(1, short, 20))
    assert toks == cold_toks and torch.equal(logits, cold)
    eng.run([Request(2, doc + rng_tokens(11, 5), 3)])
    assert eng.prefix_hit_tokens == 192


def test_window_blocks_stay_bounded_and_are_freed(model):
    eng = engine(model, max_batch=3)
    bt = eng.block_tokens
    reqs = [Request(i, rng_tokens(20 + i, 70 + 37 * i), 90)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    per_slot = 0
    while eng.has_work():
        before = eng._hlens.copy()
        eng.step()
        for b, s in enumerate(eng.slots):
            mapped = np.flatnonzero(eng._wtab[b])
            per_slot = max(per_slot, len(mapped))
            if s is None:
                assert len(mapped) == 0
            elif eng._hlens[b] != before[b]:
                # Nothing below the window of the position this tick
                # started the slot at.
                assert mapped.min() >= max(0, int(before[b]) - W + 1) // bt
    # A 48-token chunk or a 4-step burst and the 31 keys before it: at
    # most 3 blocks of 64 a slot.
    assert per_slot <= 3
    held = eng.wpool.total_pages - eng.wpool.free_pages()
    assert held == sum(len(v) for v in eng._wstate.values())
    ticks = RECORDER.spans("tick")[-5:]
    assert all("window_blocks" in t.attrs and "experts_read" in t.attrs
               for t in ticks if t.attrs.get("kind"))


@pytest.mark.parametrize("explicit", [False, True])
def test_a_dense_config_builds_todays_model(explicit):
    base = ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                       num_layers=3, num_heads=4, num_kv_heads=2,
                       head_dim=16, dtype=torch.float32)
    cfg = (SparseWindowConfig(**base.__dict__, layer_types=(FULL,) * 3)
           if explicit else base)
    quest = QuestConfig(page_size=4, token_budget=8, max_seq_len=128,
                        skip_layers=1, block_pages=4,
                        kv_dtype=torch.float32)
    params = init_params(base, torch.Generator().manual_seed(1),
                         device="cpu")
    outs = []
    for c in (base, cfg):
        m = QuestModel(c, quest, params)
        cache = init_cache(c, quest, 2, device="cpu")
        assert cache.window is None
        assert set(params["layers"]) == set(LAYER_KEYS)
        assert not hasattr(m, "experts_read")
        toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12]] * 2)
        logits = [m.prefill(cache, toks)[:, -1]]
        for t in (3, 4, 5):
            logits.append(m.decode_step(cache, torch.tensor([t, t + 1])))
        outs.append(torch.stack(logits))
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# The card.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


# Card against plain: max|d| / max|plain|. The experts' kernels sum in
# another order than the library's products, so a bf16 rounding here and
# there differs by one unit: 1.6e-3 and 2.2e-3 at 1 and 8 rows of
# Mellum2's widths on the card. The window kernels read 0.9e-4-3.6e-4
# there. A wrong expert, a lost pair or a planted window edge one key
# off moves the output by the size of the output.
CARD_TOL = 5e-3
ATTN_TOL = 2e-3


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 512])
def test_moe_kernels_match_plain_on_card(cuda, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    H, E, I, k = 2304, 64, 896, 8
    h = torch.randn(rows, H, generator=g, device=cuda).bfloat16()
    wr = (torch.randn(H, E, generator=g, device=cuda) / H ** 0.5).bfloat16()
    wg, wu = ((torch.randn(E, H, I, generator=g, device=cuda)
               / H ** 0.5).bfloat16() for _ in range(2))
    wd = (torch.randn(E, I, H, generator=g, device=cuda) / I ** 0.5).bfloat16()
    ids, wts = moe_route(h, wr, k)
    pids, pwts = moe_route_plain(h, wr, k)
    # Rows whose k-th and next logits lie within 1e-4 may pick either.
    top = (h.float() @ wr.float()).topk(k + 1).values
    clear = top[:, k - 1] - top[:, k] > 1e-4
    assert torch.equal(ids.sort(-1).values[clear], pids.sort(-1).values[clear])
    assert torch.allclose(wts.sort(-1).values[clear],
                          pwts.sort(-1).values[clear], atol=1e-5)
    active = torch.arange(rows, device=cuda) % 3 != 1
    path = moe_experts if rows <= KERNEL_ROWS else moe_experts_grouped
    c1 = torch.zeros(1, dtype=torch.int32, device=cuda)
    c2 = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = path(h, ids, wts, wg, wu, wd, active, c1)
    want = moe_experts_plain(h, ids, wts, wg, wu, wd, active, c2)
    torch.cuda.synchronize()
    assert int(c1) == int(c2) == len(set(ids[active].flatten().tolist()))
    assert _rel(out, want) <= CARD_TOL
    assert not out[~active].any()


def _plant(kv, tab, b, t, v, bpp):
    """Token ``t`` of row ``b``: keys 2.0 (a score of 22.6 against a query
    of ones at head 128, above every random key's), values ``v``."""
    page = kv.shape[-2]
    blk, off = divmod(t, bpp * page)
    pg = int(tab[b, blk]) * bpp + off // page
    kv[0, :, pg, 0, off % page] = 2.0
    kv[0, :, pg, 1, off % page] = v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_kernels_match_plain_on_card(cuda, dtype):
    from quest_tpu_torch.ops.dense_decode import (
        dense_decode_attention, dense_decode_attention_plain)
    from quest_tpu_torch.ops.prefill import (prefill_attention,
                                             prefill_attention_plain)
    g = torch.Generator(device=cuda).manual_seed(0)
    B, Hkv, G, D, page, bpp, NB = 3, 4, 8, 128, 16, 64, 4
    kv = torch.randn(1, Hkv, (B * NB + 1) * bpp, 2, page, D, generator=g,
                     device=cuda).to(dtype)
    tab = (1 + torch.arange(B * NB, device=cuda, dtype=torch.int32)
           ).reshape(B, NB)
    lens = torch.tensor([1500, 700, 3000], dtype=torch.int32, device=cuda)
    # The window's edge planted for decode at 100 keys: each row's first
    # key inside (+4) and the one before it (-2). A query of ones reads 4
    # where the edge is right, 1 with both keys and about 0 with neither.
    for b, n in enumerate(lens.tolist()):
        _plant(kv, tab, b, n - 100, 4.0, bpp)
        _plant(kv, tab, b, n - 101, -2.0, bpp)
    q = torch.randn(B, Hkv * G, D, generator=g, device=cuda).bfloat16()
    for window in (0, 1024, 100):
        kw = dict(sm_scale=D ** -0.5, layer=0, block_tab=tab,
                  block_pages=bpp, window=window)
        for qq in (q, torch.ones_like(q)):
            got = dense_decode_attention(qq, kv, lens, **kw)
            want = dense_decode_attention_plain(qq, kv, lens, **kw)
            assert _rel(got, want) <= ATTN_TOL, window
        if window == 100:
            assert float(want.mean(dim=(1, 2)).min()) > 3.9
    T = 300
    qp = torch.randn(B, T, Hkv * G, D, generator=g, device=cuda).bfloat16()
    offs = torch.tensor([0, 900, 2500], dtype=torch.int32, device=cuda)
    kv_lens = offs + torch.tensor([300, 250, 7], dtype=torch.int32,
                                  device=cuda)
    # Prefill: row 1's query at 1000 has keys 901 (+4) and 900 (-2) at
    # its window's edge; its rows at 1000 and 1001 read 4 and about 0
    # (neither), those from 901 to 999 read 1 (both).
    _plant(kv, tab, 1, 901, 4.0, bpp)
    _plant(kv, tab, 1, 900, -2.0, bpp)
    real = (torch.arange(T, device=cuda)[None] <
            (kv_lens - offs)[:, None])
    for window in (0, 1024, 100):
        kw = dict(sm_scale=D ** -0.5, layer=0, block_tab=tab,
                  block_pages=bpp, window=window)
        for qq in (qp, torch.ones_like(qp)):
            got = prefill_attention(qq, kv, offs, kv_lens, **kw)
            want = prefill_attention_plain(qq, kv, offs, kv_lens, **kw)
            assert _rel(got[real], want[real]) <= ATTN_TOL, window
        if window == 100:
            m = want[1].mean(dim=(1, 2))
            assert abs(float(m[50]) - 1) < 0.1 and float(m[100]) > 3.9


@pytest.mark.cuda
def test_mellum_engine_on_card_matches_the_cpu(cuda):
    cfg = make_cfg(torch.bfloat16, head_dim=128, num_heads=8,
                   num_kv_heads=2, hidden_size=256, sliding_window=64,
                   moe_intermediate_size=128)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=1024,
                        skip_layers=2, block_pages=4)
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         dtype=torch.bfloat16, device="cpu")
    params["embed"].mul_(50.0)
    reqs = [Request(i, rng_tokens(30 + i, 100 + 80 * i), 40)
            for i in range(4)]
    out = {}
    for dev in ("cpu", cuda):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        with eager():           # every step through served_logits' hooks
            out[str(dev)] = [served_logits(ContinuousBatchingEngine(
                cfg, quest, p, max_batch=2, prefill_bucket=16, burst=4,
                prefill_chunk=96, total_pages=16 * 40, device=dev), r,
                feed=out["cpu"][i][0] if dev == cuda else None)
                for i, r in enumerate(reqs)]
    # The card is fed the CPU's tokens. bf16 on two paths: the CPU's and
    # the library's products round differently, and this model's two best
    # logits often lie within 0.1 (a CPU build of another torch version
    # forks a greedy answer at a gap of 0.064), so the card's best may
    # differ at near ties. How far the CPU's token lies below the card's
    # best, on the card: 0.0348 on the mean over the 4 requests' 160
    # steps, the benchmark's measure, bounded at 0.05; 1.10 at the worst
    # step, not bounded (a router near tie in bf16 can swap one of a
    # token's 2 experts of 8; not shown). The card's best is the CPU's
    # token at 77.5-92.5% of a request's steps.
    agree, gaps = [], []
    for (ct, _), (gt, gl) in zip(out["cpu"], out["cuda"]):
        gl = gl.float()
        mine = gl.gather(1, torch.tensor(ct, device=gl.device)[:, None])
        gaps.append((gl.max(dim=1).values - mine[:, 0]).cpu())
        agree.append(np.mean(np.asarray(gt) == np.asarray(ct)))
    gaps = torch.cat(gaps)
    print(f"gap max {float(gaps.max()):.4f} mean {float(gaps.mean()):.4f}; "
          f"argmax agrees {agree}")
    assert float(gaps.mean()) <= 0.05
    assert np.mean(agree) >= 0.75, agree
