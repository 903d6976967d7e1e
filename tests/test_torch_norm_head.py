"""RMSNorm with its residual add folded in (``ops/rms_norm.py``) and the
bf16 lm_head's f32 product (``ops/head_gemv.py``, routed by
``models/quantize.py:qdot``).

CPU: the plain versions against the JAX package on seeded numpy inputs.
``rms_norm_plain(x, w, eps, residual=r)`` against JAX's ``rms_norm(x +
r, w, eps)`` in bf16 and f32 at widths 128, 4096 and 4100: ``h`` bit for
bit, the variance within 4 f32 ulps, and given JAX's variance the port's
ops give JAX's norm bit for bit (ROADMAP note d). ``qdot`` of f32 x and a bf16 head against
JAX's ``x.astype(f32) @ w`` within 1e-6 relative; the chunked route for
more than 16 rows against the plain product; ``head_gemv_plan``'s
launches. Models built from JAX's bf16 parameters keep a bf16 lm_head of
the JAX leaf's bytes: with f32 activations their logits and greedy tokens
match JAX's as ``test_torch_model.py``'s f32 cases do; in bf16 the
prefill's last logits agree within 2e-2. A forward runs 2L + 1 norms,
2L of them with the residual folded in.

Card (``cuda``-marked): ``csrc/rms_norm.cu`` against the plain version
(``h`` bit for bit, the variance within 4 f32 ulps, and given the
kernel's variance the plain version's norm bit for bit) and ``csrc/head_gemv.cu`` against the f32
product within 1e-5 over row counts, widths, splits and odd vocabularies,
and a captured graph of both replayed with their launches counted. The
JAX side is imported inside a fixture, so the card cases run without it:
``python -m pytest --noconftest -m cuda tests/test_torch_norm_head.py``.
"""

import dataclasses
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, tiny_test_model
from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.models import llama as tllama
from quest_tpu_torch.models import quantize as tquant
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.quantize import qdot
from quest_tpu_torch.ops.head_gemv import (HeadPlan, head_gemv,
                                           head_gemv_plain, head_gemv_plan)
from quest_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_plain,
                                          rms_scale_plain)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import ulp_distance as ulps  # noqa: E402

EPS = 1e-5
WIDTHS = (128, 4096, 4100)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
VAR_ULPS = 4              # note d's bound on the variance, f32 ulps
HEAD_TOL = 1e-6           # CPU products, max |d| / max |ref|
CARD_HEAD_TOL = 1e-5      # the kernel against the f32 product
QUEST = dict(page_size=8, token_budget=32, max_seq_len=256, block_pages=8,
             skip_layers=1)
PROMPT_LENS = (120, 103)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's norm, config, engine and parameters."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu.config import QuestConfig as JQuestConfig
    from quest_tpu.config import tiny_test_model as j_tiny
    from quest_tpu.engine.engine import QuestEngine as JQuestEngine
    from quest_tpu.models.llama import init_params as j_init_params
    from quest_tpu.ops.rms_norm import rms_norm as j_rms_norm
    return SimpleNamespace(jax=jax, jnp=jnp, JQuestConfig=JQuestConfig,
                           j_tiny=j_tiny, JQuestEngine=JQuestEngine,
                           j_init_params=j_init_params, rms_norm=j_rms_norm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def norm_inputs(rows, width, dtype, seed=0):
    """x, residual and weight as seeded numpy f32 (exact in ``dtype``):
    rows of different scales, a weight around 1."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-2, 2, size=(rows, 1))
    x = (rng.standard_normal((rows, width)) * scale).astype(np.float32)
    r = (rng.standard_normal((rows, width)) * scale).astype(np.float32)
    w = (1.0 + 0.5 * rng.standard_normal(width)).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (x, r, w)]
    return [a.float().numpy() for a in t], t


# --------------------------------------------------------------------------
# RMSNorm, CPU.

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_plain_with_residual_matches_jax(jx, dt, width):
    jnp = jx.jnp
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}[dt]
    (xn, rn, wn), (x, r, w) = norm_inputs(6, width, DTYPES[dt], seed=width)
    h, out = rms_norm_plain(x, w, EPS, residual=r)
    jh = jnp.asarray(xn).astype(jdt) + jnp.asarray(rn).astype(jdt)
    jout = jx.rms_norm(jh, jnp.asarray(wn).astype(jdt), EPS)
    want_h = torch.from_numpy(np.array(jh.astype(jnp.float32)))
    want = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    assert torch.equal(h.float(), want_h)
    # The variance each side computes, within note d's f32 bound; given
    # JAX's, the port's ops give JAX's norm bit for bit.
    hf = h.float()
    var = (hf * hf).mean(dim=-1)
    jf = jh.astype(jnp.float32)
    jvar = torch.from_numpy(np.array(jnp.mean(jf * jf, axis=-1)))
    assert int(ulps(var, jvar).max()) <= VAR_ULPS
    assert torch.equal(rms_scale_plain(h, jvar, w, EPS).float(), want)
    assert float((out.float() - want).abs().max()) <= 2e-2 * float(
        want.abs().max())
    # Without the residual it is the norm alone.
    alone = rms_norm_plain(h, w, EPS)
    assert torch.equal(alone, out)


def test_rms_norm_on_cpu_is_the_plain_version():
    _, (x, r, w) = norm_inputs(3, 4096, torch.bfloat16)
    before = rms_norm.launches
    h, out = rms_norm(x, w, EPS, residual=r)
    want_h, want = rms_norm_plain(x, w, EPS, residual=r)
    assert torch.equal(h, want_h) and torch.equal(out, want)
    assert torch.equal(rms_norm(x, w, EPS), rms_norm_plain(x, w, EPS))
    assert rms_norm.launches == before


def test_forward_folds_every_residual_add_into_a_norm(monkeypatch):
    """A forward (prefill or decode step) runs 2L + 1 norms: layer 0's
    first alone, every other with the residual add folded in."""
    from quest_tpu_torch.kv.paged_kv import init_cache
    cfg = dataclasses.replace(tiny_test_model(2), dtype=torch.float32)
    quest = QuestConfig(kv_dtype=torch.float32, **QUEST)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(2),
                                device="cpu")
    calls = []

    def counted(x, weight, eps=1e-5, residual=None):
        calls.append(residual is not None)
        return rms_norm(x, weight, eps, residual)
    monkeypatch.setattr(tllama, "rms_norm", counted)
    model = tllama.QuestModel(cfg, quest, params)
    cache = init_cache(cfg, quest, batch_size=2, device="cpu")
    toks = torch.randint(1, 256, (2, 40),
                         generator=torch.Generator().manual_seed(0))
    L = cfg.num_layers
    for run in (lambda: model.prefill_last(cache, toks),
                lambda: model.decode_step(cache, toks[:, -1])):
        calls.clear()
        assert torch.isfinite(run()).all()
        assert calls == [False] + [True] * (2 * L)


# --------------------------------------------------------------------------
# The head product, CPU.

def head_inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return x, torch.from_numpy(w).bfloat16()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("N", [1000, 8192])
@pytest.mark.parametrize("M", [1, 2, 16, 17])
def test_qdot_of_f32_x_and_bf16_head_matches_jax(jx, M, N):
    jnp = jx.jnp
    x, w = head_inputs(M, 256, N, seed=M + N)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jnp.asarray(x).astype(jnp.float32) @ jw)
    got = qdot(torch.from_numpy(x), w, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert rel(got.numpy(), want) <= HEAD_TOL
    before = head_gemv.launches
    assert torch.equal(head_gemv(torch.from_numpy(x), w),
                       head_gemv_plain(torch.from_numpy(x), w))
    assert head_gemv.launches == before


def test_widened_product_takes_column_chunks(monkeypatch):
    """The card's route above 16 rows, run here on CPU tensors: chunks of
    columns with a ragged last one, the plain product's values."""
    monkeypatch.setattr(tquant, "HEAD_CHUNK_COLS", 300)
    tquant._buffers.clear()
    x, w = head_inputs(40, 64, 1000, seed=3)
    xt = torch.from_numpy(x).reshape(2, 20, 64)
    got = tquant.widened_product(xt, w)
    assert tuple(got.shape) == (2, 20, 1000)
    assert rel(got.reshape(40, -1).numpy(),
               head_gemv_plain(torch.from_numpy(x), w).numpy()) <= HEAD_TOL
    assert tquant._buffers[(torch.device("cpu"), torch.float32)].numel() \
        == 64 * 300                      # never the whole head widened
    tquant._buffers.clear()


def test_qdot_refuses_other_mixed_dtypes():
    with pytest.raises(NotImplementedError):
        qdot(torch.ones(2, 8, dtype=torch.bfloat16),
             torch.ones(8, 4, dtype=torch.float32))


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("K,N", [(4096, 128256), (4096, 64128), (4096, 999),
                                 (64, 1000), (14336, 4096), (7, 33)])
def test_head_gemv_plan_covers_the_rows(M, K, N):
    """Every plan covers w's rows with no empty split and stages x within
    48 KB; at Llama-3.1-8B's head (501 tiles of 256 columns over 132 SMs)
    M = 1 takes one split (one wave at 4 CTAs an SM) and M = 2 three (4
    waves at 3 an SM, the last 80% full, where one split left a wave of
    105 CTAs)."""
    p = head_gemv_plan(K, N, 132, M)
    mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
    assert p.chunk * p.ksplit >= K > p.chunk * (p.ksplit - 1)
    assert mt * p.chunk * 4 <= 48 << 10 and p.chunk % 16 == 0
    if (K, N) == (4096, 128256) and M <= 2:
        assert p == (HeadPlan(4096, 1) if M == 1 else HeadPlan(1376, 3))
    if (K, N) == (64, 1000):
        assert -(-N // 256) * p.ksplit >= 4


# --------------------------------------------------------------------------
# Models from JAX's bf16 parameters, CPU.

def _jax_setup(jx, dtype):
    """JAX's tiny GQA model (bf16 parameters from its init) in ``dtype``
    activations and KV pool, and the port's engine on the same numpy
    parameters; both prefill the same prompts."""
    jnp = jx.jnp
    jcfg = jx.j_tiny(num_kv_heads=2)                  # bf16 leaves
    params = jx.jax.tree.map(np.asarray, jx.j_init_params(
        jcfg, jx.jax.random.PRNGKey(3)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jcfg, dtype=jdt)
    jeng = jx.JQuestEngine(jcfg, jx.JQuestConfig(kv_dtype=jdt, **QUEST),
                           params, batch_size=2, prefill_bucket=16)
    cfg = dataclasses.replace(tiny_test_model(2), dtype=dtype)
    teng = QuestEngine(cfg, QuestConfig(kv_dtype=dtype, **QUEST),
                       params_from_numpy(params, device="cpu"),
                       batch_size=2, prefill_bucket=16, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in PROMPT_LENS]
    return params, jeng, teng, prompts


def test_bf16_parameters_keep_a_bf16_head_and_match_jax(jx):
    """bf16 parameters, f32 activations and pool, as JAX runs them: the
    head stays bf16 (the JAX leaf's bytes, no f32 copy), every linear is
    the widened f32 product, and the logits and greedy tokens are JAX's
    as in ``test_torch_model.py``'s f32 cases."""
    params, jeng, teng, prompts = _jax_setup(jx, torch.float32)
    head = teng.model.lm_head
    assert head.dtype == torch.bfloat16
    assert head.numel() * head.element_size() == params["lm_head"].nbytes
    assert not any(b.dtype == torch.float32 and b.shape == head.shape
                   for b in teng.model.buffers())
    jl, tl = jeng.prefill(prompts), teng.prefill(prompts)
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
    first = np.argmax(jl, axis=-1).astype(np.int32)
    np.testing.assert_allclose(teng.decode(first), jeng.decode(first),
                               rtol=2e-3, atol=2e-3)
    jeng.clear()
    teng.clear()
    assert teng.generate(prompts, max_new_tokens=6) == jeng.generate(
        prompts, max_new_tokens=6)


def test_bf16_model_keeps_a_bf16_head_and_its_prefill_logits(jx):
    """The all-bf16 model: the head bf16 at the JAX leaf's bytes; the
    prefill's last logits (f32, from the bf16 head) within the bf16 gate
    of 2e-2 of JAX's (the two sides' bf16 products round differently)."""
    params, jeng, teng, prompts = _jax_setup(jx, torch.bfloat16)
    head = teng.model.lm_head
    assert head.dtype == torch.bfloat16
    assert head.numel() * head.element_size() == params["lm_head"].nbytes
    jl, tl = jeng.prefill(prompts), teng.prefill(prompts)
    assert tl.dtype == np.float32
    assert rel(tl, jl) <= 2e-2
    assert (np.argmax(tl, -1) == np.argmax(jl, -1)).all()


# --------------------------------------------------------------------------
# The card.

@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 4096), (64, 4096), (3, 4100),
                                   (5, 128), (2, 3, 24), (9000, 640)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_matches_plain_on_card(cuda, dt, shape, residual):
    rows, width = int(np.prod(shape[:-1])), shape[-1]
    _, (x, r, w) = norm_inputs(rows, width, DTYPES[dt], seed=rows + width)
    x, r, w = (t.to(cuda) for t in (x, r, w))
    x, r = x.reshape(shape), r.reshape(shape)
    var = torch.empty(rows, device=cuda)
    if residual:
        h, out = rms_norm(x, w, EPS, residual=r, var_out=var)
        want_h, want = rms_norm_plain(x, w, EPS, residual=r)
        assert torch.equal(h, want_h)
    else:
        out = rms_norm(x, w, EPS, var_out=var)
        want, want_h = rms_norm_plain(x, w, EPS), x
    torch.cuda.synchronize()
    hf = want_h.float().reshape(rows, width)
    assert int(ulps(var, (hf * hf).mean(dim=-1)).max()) <= VAR_ULPS
    assert torch.equal(out, rms_scale_plain(want_h, var.reshape(shape[:-1]),
                                            w, EPS))
    assert float((out.float() - want.float()).abs().max()) <= 2e-2 * float(
        want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("K,N", [(4096, 8192), (4096, 999), (100, 1000),
                                 (4096, 64128), (33, 7)])
def test_head_gemv_matches_plain_on_card(cuda, M, K, N):
    x, w = head_inputs(M, K, N, seed=M * 7 + N)
    x, w = torch.from_numpy(x).to(cuda), w.to(cuda)
    want = head_gemv_plain(x, w)
    before = head_gemv.launches
    got = head_gemv(x, w)
    torch.cuda.synchronize()
    assert head_gemv.launches == before + 1
    assert rel(got.cpu(), want.cpu()) <= CARD_HEAD_TOL
    # Every split count gives the same values within the bound, and two
    # calls in a row the same bits (the tickets are left at zero). The
    # kernel stages x's rows rounded up to a power of two within 48 KB.
    mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
    for ks in (2, 3, 7):
        chunk = (-(-K // ks) + 15) // 16 * 16
        if chunk * (ks - 1) >= K or mt * chunk * 4 > 48 << 10:
            continue
        plan = HeadPlan(chunk, -(-K // chunk))
        a = head_gemv(x, w, plan=plan)
        b = head_gemv(x, w, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert rel(a.cpu(), want.cpu()) <= CARD_HEAD_TOL


@pytest.mark.cuda
def test_qdot_routes_the_bf16_head_on_card(cuda):
    """Up to 16 rows one head_gemv launch; more the chunked product, no
    launch, within the bound of the plain product."""
    x, w = head_inputs(40, 512, 20000, seed=5)
    x, w = torch.from_numpy(x).to(cuda), w.to(cuda)
    before = head_gemv.launches
    small = qdot(x[:16], w, torch.float32)
    big = qdot(x, w, torch.float32)
    torch.cuda.synchronize()
    assert head_gemv.launches == before + 1
    want = head_gemv_plain(x, w)
    assert rel(small.cpu(), want[:16].cpu()) <= CARD_HEAD_TOL
    assert rel(big.cpu(), want.cpu()) <= CARD_HEAD_TOL


@pytest.mark.cuda
def test_norm_and_head_replay_count_their_launches(cuda):
    """A captured step of a residual norm, a plain norm and the head
    product: replayed on new inputs it gives the eager calls' bits, and
    each replay adds the capture's launches to both wrappers."""
    from quest_tpu_torch.engine.graphs import StepGraphs
    _, (x, r, w) = norm_inputs(2, 4096, torch.bfloat16, seed=1)
    x, r, w = x.to(cuda), r.to(cuda), w.to(cuda)
    head = head_inputs(1, 4096, 32000, seed=2)[1].to(cuda)

    def step(a, b):
        h, y = rms_norm(a, w, EPS, residual=b)
        z = rms_norm(h, w, EPS)
        return qdot((y + z).float(), head, torch.float32)
    graphs = StepGraphs(cuda)
    fn = graphs.compile(step)
    fn(x, r)                                  # runs, then captures
    n, g = rms_norm.launches, head_gemv.launches
    x2, r2 = x.flip(0).contiguous(), (r * 0.5).contiguous()
    got = fn(x2, r2).clone()
    torch.cuda.synchronize()
    assert (rms_norm.launches - n, head_gemv.launches - g) == (2, 1)
    assert torch.equal(got, step(x2, r2))


def test_bench_kernels_times_the_norm_and_head_stages_when_named():
    """``rms_norm``, ``rms_norm_prefill`` and ``head_gemv`` run when named
    (not in "all", which stays the JAX script's stages), with their byte
    counts, and launch nothing on the CPU."""
    from quest_tpu_torch.scripts import bench_kernels
    argv = ["--ctx", "512", "--budget", "64", "--heads", "4", "--kv-heads",
            "2", "--batch", "2", "--vocab", "1000", "--iters", "1",
            "--device", "cpu", "--stages",
            "rms_norm,rms_norm_prefill,head_gemv"]
    detail = {}
    out = bench_kernels.run_bench_kernels(bench_kernels.parse_args(argv),
                                          detail)
    assert set(out) == {"rms_norm_decode", "rms_norm_prefill", "head_gemv"}
    hid = 4 * 128
    assert detail["rms_norm_decode"]["bytes"] == bench_kernels.norm_bytes(
        2, hid) == 4 * 2 * hid * 2 + hid * 2
    assert detail["rms_norm_prefill"]["bytes"] == bench_kernels.norm_bytes(
        2 * 512, hid)
    assert detail["head_gemv"]["bytes"] == bench_kernels.head_bytes(
        2, hid, 1000) == hid * 1000 * 2 + 2 * (hid + 1000) * 4
    assert all(r["launches"] == 0 for r in detail.values())
    assert {r["kernel"] for r in detail.values()} == {"rms_norm",
                                                      "head_gemv"}
