"""The decode step's KV append (``kv/paged_kv.py:append_decode_at``) and
rope (``ops/rope.py:rotate_qk``).

CPU: the plain versions against the JAX package on shared numpy inputs.
The append bit for bit, over every (pool, metadata) dtype pair the
kernel takes and bf16 and f32 inputs, on layers whose pool and metadata
start random: inactive rows on the scratch block, a page's first token
(the fold resets) and the next (it folds), a row whose block index
passes the table's last (``p_log // bpp`` clamps, ``p_log % bpp`` does
not), a block shared by two rows' tables, non-finite inputs; pages of 16
and 32, blocks of 1 and 64 pages, one and four rows. Rope against
``apply_rope`` at head dim 128: q and k of different head counts,
decode (T = 1) and prefill shapes, a position a row, the four variants.
The e4m3 routines of ``csrc/append.cu``, mirrored in numpy, against
torch's casts on every bf16 code.

Card (``cuda``-marked): ``csrc/append.cu`` and ``csrc/rope.cu`` bit for
bit against those plain versions at head dim 128 (the append also on
all 65536 bf16 codes into an fp8 pool), and a captured graph of both,
replayed on new lengths, table, mask and inputs, equal to the eager
calls. The JAX side is imported inside a fixture, so the card cases run
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_append_rope.py``.
"""

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
from quest_tpu_torch.kv import paged_kv as tkv
from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                      rotate, rotate_plain, rotate_qk)
from quest_tpu_torch.ops.utils import fp8_cast_codes

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import (LAYER_DTYPES as DT, append_case,  # noqa: E402
                        append_inputs, clone_cache, fp8_code_case, same_bits)

FP8 = torch.float8_e4m3fn
PAIRS = [(p, m) for p in DT for m in DT]            # (pool, metadata)
# (page, block_pages, B): pages of 16 and 32, blocks of 1 and 64 pages,
# one and four rows.
GEOMS = ((16, 1, 4), (32, 64, 4), (16, 64, 1))
ROPES = {
    "plain": dict(theta=10000.0),
    "linear": dict(theta=10000.0, scaling="linear", factor=8.0),
    "llama3": dict(theta=500000.0, scaling="llama3", factor=8.0,
                   low_freq_factor=1.0, high_freq_factor=4.0,
                   original_max_position_embeddings=8192),
    "yarn": dict(theta=10000.0, scaling="yarn", factor=32.0,
                 original_max_position_embeddings=4096),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's cache, append and rope."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from quest_tpu.config import RopeConfig as JRopeConfig
    from quest_tpu.kv import paged_kv as jkv
    from quest_tpu.ops.rope import apply_rope, compute_rope_params
    return SimpleNamespace(jnp=jnp, jkv=jkv, apply_rope=apply_rope,
                           rope_params=compute_rope_params,
                           RopeConfig=JRopeConfig)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The append.

def _f32(x):
    """A tensor or JAX array as f32 numpy (every cast here exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("inp", ["bf16", "f32"])
@pytest.mark.parametrize("pool,meta", PAIRS)
def test_append_plain_matches_jax_bitwise(jx, pool, meta, inp):
    jnp, jkv = jx.jnp, jx.jkv
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
           "fp8": jnp.float8_e4m3fn}
    for g, (page, bpp, B) in enumerate(GEOMS):
        tc, steps = append_case(pool, meta, page, bpp, B, seed=g)
        H, D = tc.kv_pages.shape[1], tc.kv_pages.shape[-1]
        jc = jkv.PagedKVCache(
            jnp.asarray(_f32(tc.kv_pages)).astype(jdt[pool]),
            jnp.asarray(_f32(tc.k_max)).astype(jdt[meta]),
            jnp.asarray(_f32(tc.k_min)).astype(jdt[meta]),
            jnp.asarray(tc.block_tab.numpy()), None)
        for i, (lens, act) in enumerate(steps):
            k, v = append_inputs(B, H, D, inp, seed=10 * g + i)
            tc.seq_lens = lens
            jc = jkv.PagedKVCache(jc.kv_pages, jc.k_max, jc.k_min,
                                  jc.block_tab, jnp.asarray(lens.numpy()))
            jc = jkv.append_decode_at(
                jc, 1, jnp.asarray(_f32(k)).astype(jdt[inp]),
                jnp.asarray(_f32(v)).astype(jdt[inp]),
                active=None if act is None else jnp.asarray(act.numpy()))
            tkv.append_decode_at(tc, 1, k, v, active=act)
            for t, j in ((tc.kv_pages, jc.kv_pages), (tc.k_max, jc.k_max),
                         (tc.k_min, jc.k_min)):
                np.testing.assert_array_equal(_f32(t), _f32(j),
                                              err_msg=f"{(page, bpp, B)} "
                                              f"step {i}")
        assert np.isfinite(_f32(tc.kv_pages)).all()


def test_append_on_cpu_is_the_plain_version():
    tc, steps = append_case("bf16", "fp8", 16, 1, 4)
    ref, _ = append_case("bf16", "fp8", 16, 1, 4)
    k, v = append_inputs(4, 2, 16, "bf16", seed=3)
    before = tkv.append_decode_at.launches
    for c, fn in ((tc, tkv.append_decode_at), (ref, tkv.append_decode_at_plain)):
        c.seq_lens = steps[0][0]
        fn(c, 0, k, v, active=steps[0][1])
    assert tkv.append_decode_at.launches == before
    for a, b in ((tc.kv_pages, ref.kv_pages), (tc.k_max, ref.k_max)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# The e4m3 casts of csrc/append.cu (c10's routines), in numpy.

def fp8_from_f32(f, ovf, carry):
    u = np.uint64
    bits = np.asarray(f, np.float32).view(np.uint32).astype(u)
    sign = bits & u(0x80000000)
    bits = bits ^ sign
    with np.errstate(invalid="ignore", over="ignore"):
        den = (bits.astype(np.uint32).view(np.float32)
               + np.float32(2.0 ** 14)).view(np.uint32).astype(u)
    den = (den - u(141 << 23)) & u(0xFF)
    norm = (((bits + u((7 - 127) % 2 ** 32 << 23) + u(0x7FFFF)
              + ((bits >> u(20)) & u(1))) % u(2 ** 32)) >> u(20)) & u(0xFF)
    norm = np.where(norm == u(0x7F), u(carry), norm)
    r = np.where(bits >= u(1087 << 20),
                 np.where(bits > u(0x7F800000), u(0x7F), u(ovf)),
                 np.where(bits < u(121 << 23), den, norm))
    return (r | (sign >> u(24))).astype(np.uint8)


def test_fp8_routine_equals_torch_cast_on_every_bf16_code():
    codes = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = codes.view(torch.bfloat16)
    ovf, carry = fp8_cast_codes(torch.device("cpu"), torch.bfloat16)
    want = x.to(FP8).view(torch.uint8).numpy()
    got = fp8_from_f32(x.float().numpy(), ovf, carry)
    finite = torch.isfinite(x).numpy()
    np.testing.assert_array_equal(got[finite], want[finite])
    # f32 values between bf16 codes round the same way.
    rng = np.random.default_rng(0)
    f = (rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(
        -9, 3, 1 << 16)).astype(np.float32)
    o32, c32 = fp8_cast_codes(torch.device("cpu"), torch.float32)
    np.testing.assert_array_equal(
        fp8_from_f32(f, o32, c32),
        torch.from_numpy(f).to(FP8).view(torch.uint8).numpy())
    # The widening keeps denormals, as .float() does.
    u = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    assert (u.view(FP8).float()[1:8] > 0).all()


# --------------------------------------------------------------------------
# Rope.

def rope_inputs(T, B=2, Hq=8, Hkv=2, D=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    start = np.array([5, 1500])[:B, None]            # a position a row
    pos = (start + np.arange(T)[None]).astype(np.int32)
    return q, k, pos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", sorted(ROPES))
def test_rotate_qk_matches_jax_rope(jx, variant, dtype):
    jnp = jx.jnp
    D = 128
    j_inv, j_ps, j_as = jx.rope_params(jx.RopeConfig(**ROPES[variant]), D)
    inv, ps, att = compute_rope_params(RopeConfig(**ROPES[variant]), D)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    for T in (1, 37):                                 # decode, prefill
        q, k, pos = rope_inputs(T, seed=T)
        tq = torch.from_numpy(q).to(DT[dtype])
        tk = torch.from_numpy(k).to(DT[dtype])
        got_q, got_k = rotate_qk(tq, tk, *rope_cos_sin(
            torch.from_numpy(pos), inv, ps, att))
        for x, got in ((tq, got_q), (tk, got_k)):
            want = _f32(jx.apply_rope(jnp.asarray(_f32(x)).astype(jdt),
                                      jnp.asarray(pos), j_inv, j_ps, j_as))
            assert got.dtype == x.dtype and got.shape == x.shape
            # f32: 1e-5, as test_torch_ops.py's rope (the two compute cos
            # and sin each their own way). bf16: that, plus one bf16
            # rounding step (2^-7 of the value) where the f32 results
            # fall on two sides of a rounding boundary.
            tol = 1e-5 + (2.0 ** -7 * np.abs(want) if dtype == "bf16" else 0)
            assert np.all(np.abs(_f32(got) - want) <= tol), variant


def test_rotate_on_cpu_is_the_plain_version():
    q, k, pos = rope_inputs(4)
    inv, ps, att = compute_rope_params(RopeConfig(), 128)
    cs = rope_cos_sin(torch.from_numpy(pos), inv, ps, att)
    x = torch.from_numpy(q).bfloat16()
    before = rotate_qk.launches
    assert torch.equal(rotate(x, *cs), rotate_plain(x, *cs))
    qo, ko = rotate_qk(x, torch.from_numpy(k).bfloat16(), *cs)
    assert torch.equal(qo, rotate_plain(x, *cs))
    assert torch.equal(ko, rotate_plain(torch.from_numpy(k).bfloat16(), *cs))
    assert rotate_qk(x, None, *cs)[1] is None
    assert rotate_qk.launches == before


# --------------------------------------------------------------------------
# Card cases: the kernels against the plain versions, bit for bit.

def _same_cache(a, b, what):
    for name in ("kv_pages", "k_max", "k_min"):
        assert same_bits(getattr(a, name), getattr(b, name)), \
            f"{what}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("inp", ["bf16", "f32"])
@pytest.mark.parametrize("pool,meta", PAIRS)
def test_append_kernel_matches_plain_on_card(cuda, pool, meta, inp):
    for g, (page, bpp, B) in enumerate(GEOMS):
        cache, steps = append_case(pool, meta, page, bpp, B, H=8, D=128,
                                   seed=g, device=cuda)
        ref = clone_cache(cache)
        for i, (lens, act) in enumerate(steps):
            k, v = append_inputs(B, 8, 128, inp, seed=10 * g + i,
                                 device=cuda, large=True)
            cache.seq_lens = ref.seq_lens = lens
            before = tkv.append_decode_at.launches
            tkv.append_decode_at(cache, 1, k, v, active=act)
            assert tkv.append_decode_at.launches == before + 1
            tkv.append_decode_at_plain(ref, 1, k, v, active=act)
            torch.cuda.synchronize()
            _same_cache(cache, ref, f"{(page, bpp, B)} step {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("inp", ["bf16", "f32"])
@pytest.mark.parametrize("meta", ["f32", "bf16", "fp8"])
def test_append_kernel_fp8_pool_on_every_bf16_code(cuda, meta, inp):
    """k takes each of the 65536 bf16 codes once (v a permutation), into
    an fp8 pool over 64 rows on distinct pages: half at a page's first
    token, half folding into random metadata."""
    cache, k, v = fp8_code_case(meta, inp, device=cuda)
    ref = clone_cache(cache)
    tkv.append_decode_at(cache, 0, k, v)
    tkv.append_decode_at_plain(ref, 0, k, v)
    torch.cuda.synchronize()
    _same_cache(cache, ref, f"fp8 pool, {meta} metadata, {inp} codes")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,Hq,Hkv", [(1, 32, 8), (1, 8, 2), (37, 32, 8),
                                      (1024, 32, 8), (5, 4, 4)])
def test_rope_kernel_matches_plain_on_card(cuda, dtype, T, Hq, Hkv):
    gen = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn((2, T, Hq, 128), generator=gen, device=cuda).to(DT[dtype])
    k = torch.randn((2, T, Hkv, 128), generator=gen, device=cuda).to(DT[dtype])
    inv, ps, att = compute_rope_params(RopeConfig(**ROPES["llama3"]), 128)
    pos = (torch.tensor([[7], [30000]], device=cuda)
           + torch.arange(T, device=cuda)[None]).to(torch.int32)
    cs = rope_cos_sin(pos, inv, ps, att)
    before = rotate_qk.launches
    qo, ko = rotate_qk(q, k, *cs)
    assert rotate_qk.launches == before + 1
    assert same_bits(qo, rotate_plain(q, *cs))
    assert same_bits(ko, rotate_plain(k, *cs))
    assert same_bits(rotate(q, *cs), qo)
    with pytest.raises(ValueError):
        rotate_qk(q, k, cs[0][:1], cs[1][:1])
    with pytest.raises(ValueError):
        rotate_qk(q.transpose(1, 2), None, *cs)


@pytest.mark.cuda
def test_append_and_rope_replay_equals_eager(cuda):
    """One graph of rope then the append; replayed after new lengths, a
    new table row, a new mask and new inputs are copied into its static
    tensors, it leaves what the eager calls leave."""
    B, Hq, H, D, page = 4, 32, 8, 128, 16
    cache, steps = append_case("bf16", "fp8", page, 1, B, H=H, D=D,
                               device=cuda)
    inv, ps, att = compute_rope_params(RopeConfig(**ROPES["llama3"]), D)
    inv = inv.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, 1, Hq, D), generator=gen, device=cuda).bfloat16()
    k = torch.randn((B, 1, H, D), generator=gen, device=cuda).bfloat16()
    v = torch.randn((B, H, D), generator=gen, device=cuda).bfloat16()
    cache.seq_lens = steps[0][0].clone()
    act = steps[0][1].clone()

    def step():
        cs = rope_cos_sin(cache.seq_lens[:, None], inv, ps, att)
        qo, ko = rotate_qk(q, k, *cs)
        tkv.append_decode_at(cache, 1, ko[:, 0], v, active=act)
        return qo

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()                               # warm-up: build, fp8 codes
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        qo = step()
    # New step values into the static tensors, then replay vs eager.
    cache.seq_lens.copy_(steps[1][0])
    cache.block_tab[2] = cache.block_tab[2].flip(0)
    act.copy_(torch.tensor([True, False, True, True], device=cuda))
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    ref = clone_cache(cache)
    cs = rope_cos_sin(ref.seq_lens[:, None], inv, ps, att)
    want_q, want_k = rotate_qk(q, k, *cs)
    tkv.append_decode_at(ref, 1, want_k[:, 0], v, active=act.clone())
    graph.replay()
    torch.cuda.synchronize()
    assert same_bits(qo, want_q)
    _same_cache(cache, ref, "replay")


def test_every_counted_kernel_counts_through_graph_replays():
    """A replayed step adds its capture's launches to each wrapper that
    ``engine/graphs.py`` knows; ``chip_smoke.py``'s launch checks count
    every kernel's wrapper, the append and rope included."""
    from chip_smoke import kernel_wrappers
    from quest_tpu_torch.engine.graphs import launch_counters
    known = set(launch_counters())
    assert tkv.append_decode_at in known and rotate_qk in known
    assert tkv.rope_append_decode_at in known
    assert all(w in known for w in kernel_wrappers().values())


def test_bench_kernels_times_the_layer_stages_when_named():
    """``rope``, ``rope_prefill`` and ``rope_append`` run when named (not
    in "all", which stays the JAX script's stages), with their byte
    counts."""
    from quest_tpu_torch.scripts import bench_kernels
    argv = ["--ctx", "512", "--budget", "64", "--heads", "4", "--kv-heads",
            "2", "--iters", "1", "--device", "cpu", "--stages",
            "append,rope,rope_prefill,rope_append"]
    detail = {}
    out = bench_kernels.run_bench_kernels(bench_kernels.parse_args(argv),
                                          detail)
    assert set(out) == {"append_decode", "rope_decode", "rope_prefill",
                        "rope_append_decode"}
    assert detail["rope_decode"]["bytes"] == bench_kernels.rope_bytes(
        1, 1, 4, 2, 128)
    assert detail["rope_prefill"]["bytes"] == bench_kernels.rope_bytes(
        1, 512, 4, 2, 128)
    # q read and written (4 x 128 bf16 each), k and v read and written
    # (2 x 128 x 4), metadata read and written (2 x 128 x 4), cos and sin
    # (64 f32 each), the length and the table entry.
    assert detail["rope_append_decode"]["bytes"] == \
        bench_kernels.rope_append_bytes(1, 4, 2, 128) == \
        2 * 512 * 2 + 4 * 256 * 2 + 4 * 256 * 2 + 2 * 64 * 4 + 8
    assert detail["rope_append_decode"]["kernel"] == "rope_append_decode_at"
    assert all(r["launches"] == 0 for r in detail.values())   # plain, CPU
