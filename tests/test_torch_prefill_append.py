"""The prefill's KV append (``kv/paged_kv.py:append_prefill_at``) and the
MLP's SiLU product (``ops/silu_mul.py:silu_mul``).

CPU: the plain versions against the JAX package on shared numpy inputs.
The append bit for bit outside scratch block 0, over every (pool,
metadata) dtype pair the kernel takes, on a two-layer cache whose pool
and metadata start random under a shuffled block table, over three
chunks (``chip_smoke.append_prefill_case``): rows with new_lens 0,
below T and equal to T, offsets inside a page, a window clamped at the
pool's end, W = P, inf and NaN in k and v, a page whose only valid key
is below -3.0e38, bf16 and f32 inputs. The SiLU product
against ``jax.nn.silu(g) * u`` in bf16 and f32, within one rounding of
the output dtype; a 2-layer model's prefill and decode logits against
JAX's; the wrappers' refusals; the new stages of ``bench_kernels``.

Card (``cuda``-marked): ``csrc/append.cu``'s prefill route bit for bit
against ``append_prefill_at_plain`` outside scratch at head dim 128 over
the same chunks, and ``csrc/silu_mul.cu`` against ``silu_mul_plain``
within 1 ulp. The JAX side is imported inside fixtures, so the card
cases run without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_prefill_append.py``.
"""

import dataclasses
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quest_tpu_torch.kv import paged_kv as tkv
from quest_tpu_torch.ops import silu_mul as tsilu

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import (LAYER_DTYPES as DT, clone_cache,  # noqa: E402
                        append_prefill_case, prefill_append_bytes,
                        prefill_inputs, same_outside_scratch, ulp_distance)

PAIRS = [(p, m) for p in DT for m in DT]            # (pool, metadata)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's cache and append."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu.kv import paged_kv as jkv
    return SimpleNamespace(jax=jax, jnp=jnp, jkv=jkv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def _f32(x):
    """A tensor or JAX array as f32 numpy (every cast here exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype("float32"))


# --------------------------------------------------------------------------
# The prefill append.

@pytest.mark.parametrize("pool,meta", PAIRS)
def test_prefill_plain_matches_jax_bitwise(jx, pool, meta):
    jnp, jkv = jx.jnp, jx.jkv
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
           "fp8": jnp.float8_e4m3fn}
    tc, steps = append_prefill_case(pool, meta, page=8, bpp=4, seed=1)
    bpp = tc.block_pages
    H, D = tc.kv_pages.shape[1], tc.kv_pages.shape[-1]
    for i, (lens, nl, T) in enumerate(steps):
        inp = ("bf16", "f32")[i % 2]
        # A key below -3.0e38 where neither pool nor metadata is e4m3
        # (whose cast of it differs between jax and torch versions).
        k, v = prefill_inputs(4, T, H, D, inp, seed=i,
                              low="fp8" not in (pool, meta))
        jc = jkv.PagedKVCache(
            jnp.asarray(_f32(tc.kv_pages)).astype(jdt[pool]),
            jnp.asarray(_f32(tc.k_max)).astype(jdt[meta]),
            jnp.asarray(_f32(tc.k_min)).astype(jdt[meta]),
            jnp.asarray(tc.block_tab.numpy()), jnp.asarray(lens.numpy()))
        jc = jkv.append_prefill_at(
            jc, 1, jnp.asarray(_f32(k)).astype(jdt[inp]),
            jnp.asarray(_f32(v)).astype(jdt[inp]),
            new_lens=jnp.asarray(nl.numpy()))
        tc.seq_lens = lens
        tkv.append_prefill_at(tc, 1, k, v, new_lens=nl)
        for t, j, lo in ((tc.kv_pages, jc.kv_pages, bpp),
                         (tc.k_max, jc.k_max, 1), (tc.k_min, jc.k_min, 1)):
            np.testing.assert_array_equal(_f32(t)[:, :, lo:],
                                          _f32(j)[:, :, lo:],
                                          err_msg=f"chunk {i} (T={T})")
    assert np.isfinite(_f32(tc.kv_pages)).all()


def test_prefill_append_on_cpu_is_the_plain_version():
    tc, steps = append_prefill_case("bf16", "fp8", page=8, bpp=4)
    ref = clone_cache(tc)
    before = tkv.append_prefill_at.launches
    for lens, nl, T in steps:
        k, v = prefill_inputs(4, T, 2, 16, "bf16", seed=T)
        for c, fn in ((tc, tkv.append_prefill_at),
                      (ref, tkv.append_prefill_at_plain)):
            c.seq_lens = lens
            fn(c, 0, k, v, new_lens=nl)
    assert tkv.append_prefill_at.launches == before
    for name in ("kv_pages", "k_max", "k_min"):
        assert torch.equal(getattr(tc, name).view(torch.uint8),
                           getattr(ref, name).view(torch.uint8))


def test_prefill_append_refusals():
    """What the kernel does not take raises before a launch (the checks
    run here on CPU tensors)."""
    tc, steps = append_prefill_case("bf16", "bf16", page=8, bpp=4, H=2, D=128)
    lens, nl, T = steps[0]
    tc.seq_lens = lens
    k, v = prefill_inputs(4, T, 2, 128, "bf16", seed=0)
    ptrs, dims, codes, W = tkv._prefill_launch_args(tc, 1, k, v, nl)
    assert W == T // 8 + 2
    assert dims == [tc.kv_pages.shape[2], 8, tc.k_max.shape[2], 4,
                    tc.block_tab.shape[1]] and codes[:3] == [1, 1, 1]
    args = tkv._prefill_launch_args
    with pytest.raises(NotImplementedError):              # head_dim 64
        kk = k[..., :64].contiguous()
        args(tc, 1, kk, kk, nl)
    with pytest.raises(TypeError):                        # mixed dtypes
        args(tc, 1, k, v.float(), nl)
    with pytest.raises(TypeError):                        # f16 inputs
        args(tc, 1, k.half(), v.half(), nl)
    with pytest.raises(TypeError):                        # int64 new_lens
        args(tc, 1, k, v, nl.long())
    with pytest.raises(ValueError):                       # not contiguous
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)
        args(tc, 1, kt, kt, nl)
    P = tc.max_pages                                      # 8 pages of 8
    big = torch.zeros((4, P * 8 + 1, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):  # T > W x page
        args(tc, 1, big, big, nl)


# --------------------------------------------------------------------------
# The SiLU product.

def silu_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (4 * rng.standard_normal(shape)).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_silu_mul_plain_matches_jax(jx, dtype):
    jnp = jx.jnp
    g, u = silu_inputs((3, 5, 700), seed=1)
    tg, tu = (torch.from_numpy(x).to(DT[dtype]) for x in (g, u))
    got = _f32(tsilu.silu_mul(tg, tu))
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}[dtype]
    jg, ju = (jnp.asarray(_f32(t)).astype(jdt) for t in (tg, tu))
    want = _f32(jx.jax.nn.silu(jg) * ju)
    # JAX's silu is x * sigmoid(x), torch's x / (1 + exp(-x)). In f32 a
    # few ulps apart: 4 ulps (2^-21 of the value; 2.2e-7 read). In bf16
    # JAX rounds the sigmoid to bf16 before its product with x, so the
    # silu lands a bf16 step (2^-7 of the value) from torch's, and each
    # side's products round on their own (up to 2^-7 more between them):
    # 3 x 2^-7 of the value (0.0155 read, a third of the elements differ).
    rel = 3 * 2.0 ** -7 if dtype == "bf16" else 2.0 ** -21
    diff = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert diff.max() <= rel, diff.max()


def test_silu_mul_on_cpu_is_the_plain_version_and_refusals():
    g, u = (torch.from_numpy(x).bfloat16() for x in silu_inputs((4, 33)))
    before = tsilu.silu_mul.launches
    assert torch.equal(tsilu.silu_mul(g, u), tsilu.silu_mul_plain(g, u))
    assert torch.equal(tsilu.silu_mul_plain(g, u),
                       torch.nn.functional.silu(g) * u)
    assert tsilu.silu_mul.launches == before
    assert tsilu._launch_code(g, u) == 1
    assert tsilu._launch_code(g.float(), u.float()) == 0
    with pytest.raises(TypeError):
        tsilu._launch_code(g, u.float())
    with pytest.raises(TypeError):
        tsilu._launch_code(g.half(), u.half())
    with pytest.raises(TypeError):
        tsilu._launch_code(g, u[:, :32])
    with pytest.raises(ValueError):
        tsilu._launch_code(g.t(), u.t())


# --------------------------------------------------------------------------
# The model and the tools.

def test_two_layer_model_logits_match_jax(jx):
    """A 2-layer tiny model in f32: prefill and decode logits within the
    2e-3 that ``test_torch_model.py`` holds, the prefill append and the
    SiLU product on their plain versions."""
    jax, jnp = jx.jax, jx.jnp
    from quest_tpu.config import QuestConfig as JQuestConfig
    from quest_tpu.config import tiny_test_model as j_tiny
    from quest_tpu.engine.engine import QuestEngine as JQuestEngine
    from quest_tpu.models.llama import init_params as j_init_params
    from quest_tpu_torch.config import QuestConfig, tiny_test_model
    from quest_tpu_torch.models.convert import params_from_numpy
    from quest_tpu_torch.models.llama import QuestModel
    quest_kw = dict(page_size=8, token_budget=32, max_seq_len=256,
                    block_pages=8, skip_layers=1)
    jcfg = dataclasses.replace(j_tiny(num_kv_heads=2), dtype=jnp.float32,
                               num_layers=2)
    params = jax.tree.map(np.asarray, j_init_params(
        jcfg, jax.random.PRNGKey(4), dtype=jnp.float32))
    rng = np.random.default_rng(2)
    lens = (120, 103)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in lens]
    eng = JQuestEngine(jcfg, JQuestConfig(kv_dtype=jnp.float32, **quest_kw),
                       params, batch_size=2, prefill_bucket=16)
    want_pre = eng.prefill(prompts)
    first = np.argmax(want_pre, axis=-1).astype(np.int32)
    want_dec = eng.decode(first)
    cfg = dataclasses.replace(tiny_test_model(num_kv_heads=2),
                              dtype=torch.float32, num_layers=2)
    quest = QuestConfig(kv_dtype=torch.float32, **quest_kw)
    model = QuestModel(cfg, quest, params_from_numpy(params, device="cpu"))
    cache = tkv.init_cache(cfg, quest, batch_size=2, device="cpu")
    toks = np.zeros((2, 128), np.int32)               # the engine's bucket
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    got = model.prefill_last(cache, torch.from_numpy(toks),
                             torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(got[:, 0].numpy(), want_pre, rtol=2e-3,
                               atol=2e-3)
    dec = model.decode_step(cache, torch.from_numpy(first))
    np.testing.assert_allclose(dec.numpy(), want_dec, rtol=2e-3, atol=2e-3)


def test_new_kernels_count_through_graph_replays():
    """Both wrappers are known to ``engine/graphs.py`` (a replayed step
    adds their captured launches) and to ``chip_smoke.py``'s checks."""
    from chip_smoke import KERNEL_META, kernel_wrappers, layer_launches
    from quest_tpu_torch.engine.graphs import launch_counters
    known = set(launch_counters())
    assert tkv.append_prefill_at in known and tsilu.silu_mul in known
    wrappers = kernel_wrappers()
    assert wrappers["append_prefill"] is tkv.append_prefill_at
    assert wrappers["silu_mul"] is tsilu.silu_mul
    assert set(KERNEL_META) == set(wrappers)
    got = layer_launches(32, 3, 2)          # a prefill chunk, two steps
    assert got["append_prefill"] == 32 and got["silu_mul"] == 96


def test_bench_kernels_times_the_prefill_append_and_silu_stages():
    """``append_prefill``, ``silu_mul`` and ``silu_mul_prefill`` run when
    named, with their byte counts (the same count as ``chip_smoke.py``'s
    for a chunk from position 0)."""
    from quest_tpu_torch.scripts import bench_kernels
    argv = ["--ctx", "512", "--budget", "64", "--heads", "4", "--kv-heads",
            "2", "--iters", "1", "--device", "cpu", "--batch", "2",
            "--inter", "96", "--prefill-lens", "500,0", "--stages",
            "append_prefill,silu_mul,silu_mul_prefill"]
    detail = {}
    out = bench_kernels.run_bench_kernels(bench_kernels.parse_args(argv),
                                          detail)
    assert set(out) == {"append_prefill", "silu_mul_decode",
                        "silu_mul_prefill"}
    # One row of 500 tokens: k and v read and 512 pool rows written (2 x
    # 2 x 512 x 2 x 128 bf16), 32 pages of metadata (2 x 32 x 2 x 128),
    # W = min(P, 512 // 16 + 2) = 34 table entries (P = 64: the pool's
    # pages a row round up to 64) and the two rows' lengths; the empty
    # row its lengths only.
    want = (4 * 512 * 2 * 128 * 2 + 2 * 32 * 2 * 128 * 2 + 4 * 34 + 16)
    assert detail["append_prefill"]["bytes"] == want
    assert detail["silu_mul_decode"]["bytes"] == 3 * 2 * 96 * 2
    assert detail["silu_mul_prefill"]["bytes"] == 3 * 2 * 512 * 96 * 2
    assert all(r["launches"] == 0 for r in detail.values())   # plain, CPU
    # A chunk of 5 at offset 5 of page 8 (W = 2): the page's 5 old keys
    # below the offset read too; one f32 k/v row into an fp8 pool with
    # bf16 metadata.
    tc, _ = append_prefill_case("fp8", "bf16", page=8, bpp=4, H=2, D=128, B=1)
    tc.seq_lens = torch.tensor([5], dtype=torch.int32)
    k = torch.zeros((1, 5, 2, 128))
    assert prefill_append_bytes(tc, k, torch.tensor([3])) == (
        8 + 2 * 5 * 256 * (4 + 1) + 5 * 256 + 2 * 1 * 256 * 2 + 4 * 2)


# --------------------------------------------------------------------------
# Card cases: the kernels against the plain versions.

@pytest.mark.cuda
@pytest.mark.parametrize("pool,meta", PAIRS)
def test_prefill_kernel_matches_plain_on_card(cuda, pool, meta):
    for page, bpp in ((16, 64), (32, 64), (16, 1)):
        for inp in ("bf16", "f32"):
            c, steps = append_prefill_case(pool, meta, page, bpp, H=8, D=128,
                                    seed=page + bpp, device=cuda)
            for i, (lens, nl, T) in enumerate(steps):
                k, v = prefill_inputs(4, T, 8, 128, inp, seed=i,
                                      device=cuda, large=True, low=True)
                c.seq_lens = lens
                ref = clone_cache(c)
                before = tkv.append_prefill_at.launches
                tkv.append_prefill_at(c, 1, k, v, new_lens=nl)
                assert tkv.append_prefill_at.launches == before + 1
                tkv.append_prefill_at_plain(ref, 1, k, v, new_lens=nl)
                torch.cuda.synchronize()
                assert same_outside_scratch(c, ref), (page, bpp, inp, i)
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.zeros((4, c.max_pages * page + 1, 8, 128),
                          dtype=torch.bfloat16, device=cuda)
        tkv.append_prefill_at(c, 1, big, big, new_lens=nl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_silu_mul_kernel_matches_plain_on_card(cuda, dtype):
    for shape, shift in (((2, 1, 14336), 0), ((1, 2048, 14336), 0),
                         ((3, 1000003), 0), ((5, 14336), 1)):
        g, u = (torch.from_numpy(x).to(DT[dtype]) for x in
                silu_inputs(shape, seed=len(shape)))
        gs = torch.empty(g.numel() + shift, dtype=g.dtype, device=cuda)
        us = torch.empty(g.numel() + shift, dtype=g.dtype, device=cuda)
        gs[shift:], us[shift:] = g.reshape(-1), u.reshape(-1)
        g, u = gs[shift:].view(shape), us[shift:].view(shape)
        before = tsilu.silu_mul.launches
        got = tsilu.silu_mul(g, u)
        assert tsilu.silu_mul.launches == before + 1
        want = tsilu.silu_mul_plain(g, u)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert int(ulp_distance(got, want).max()) <= 1, shape
    with pytest.raises(ValueError):
        tsilu.silu_mul(g.t(), u.t())
