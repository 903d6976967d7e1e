"""The decode step's rope and KV append in one op
(``kv/paged_kv.py:rope_append_decode_at``) and the RMSNorm kernel's
contract at the shapes its redesign changed (``csrc/rms_norm.cu``).

CPU: the merged op's plain composition (``rotate_plain`` of q and k, then
``append_decode_at_plain`` of the rotated k) against the JAX package's
``apply_rope`` of q and k and its ``append_decode_at``, on shared numpy
inputs and JAX's own cos / sin: every (pool, metadata) dtype pair, bf16
and f32 inputs, groups G = 1, 4 and 8, an inactive row, a page's first
token and the next. The append is bit for bit: pool and metadata equal
JAX's ``append_decode_at`` of the same rotated key. The rotation is held
within the one rounding that sets the two apart: XLA contracts the
rope's ``x1 * cos - x2 * sin`` into an FMA on the CPU, where the port
(torch's separate kernels, and ``csrc/rope.cu`` and ``csrc/append.cu``
after them) rounds each product (ROADMAP note s). A decode forward calls
the merged op once a layer and ``rotate_qk`` never; a prefill chunk
calls ``rotate_qk`` once a layer and the merged op never.

Card (``cuda``-marked; this file imports JAX only in a fixture):
``csrc/append.cu``'s rotate flag bit for bit against the plain
composition over the same cases at head dim 128, G = 4, 1, 8, 3 and 32;
``csrc/rms_norm.cu`` to note d at a decode step's rows, a prefill chunk,
a width that loops past the registers and one that takes the element
path; a captured graph of the merged op replayed on new lengths, mask
and inputs equal to the eager call. ``python -m pytest --noconftest -m
cuda tests/test_torch_rope_append.py``.
"""

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, RopeConfig, tiny_test_model
from quest_tpu_torch.kv import paged_kv as tkv
from quest_tpu_torch.models import llama as tllama
from quest_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_plain,
                                          rms_scale_plain)
from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                      rotate_plain)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import (LAYER_DTYPES as DT, append_case,  # noqa: E402
                        append_inputs, clone_cache, same_bits)
from chip_smoke import ulp_distance as ulps  # noqa: E402

PAIRS = [(p, m) for p in DT for m in DT]            # (pool, metadata)
# (page, block_pages, B): pages of 16 and 32, blocks of 1 and 64 pages,
# one and four rows (append_case: a page's first token and the next, an
# inactive row on scratch, a clamped block, a shared block).
GEOMS = ((16, 1, 4), (32, 64, 4), (16, 64, 1))
LLAMA3 = dict(theta=500000.0, scaling="llama3", factor=8.0,
              low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position_embeddings=8192)
EPS = 1e-5
VAR_ULPS = 4              # note d's bound on the variance, f32 ulps


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


def _f32(x):
    """A tensor or JAX array as f32 numpy (every cast here exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype("float32"))


def query(B, Hq, D, inp, seed, device="cpu"):
    """q [B, Hq, D] of dtype ``inp`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = 2 * rng.standard_normal((B, Hq, D)).astype(np.float32)
    return torch.from_numpy(q).to(DT[inp]).to(device)


def rope_bound(x, cos, sin):
    """What one rounding of a product can move a rotation by: 2^-23 x
    (|x1 cos| + |x2 sin|) on each half, in f32 (x [B, H, D], cos / sin
    [B, 1, D/2] numpy)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    a = np.abs(x1 * cos) + np.abs(x2 * sin)
    b = np.abs(x2 * cos) + np.abs(x1 * sin)
    return 2.0 ** -23 * np.concatenate([a, b], axis=-1)


def assert_rotation_close(got, want, x, cos, sin):
    """The port's rotation against JAX's: the same non-finite lanes (the
    inputs hold inf and NaN), the finite ones within :func:`rope_bound`,
    and one step of the output dtype where that crosses its rounding."""
    got, want = _f32(got), _f32(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    with np.errstate(invalid="ignore"):
        tol = rope_bound(_f32(x), cos, sin)
        if x.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * np.abs(want)
        assert np.all(np.abs(got - want)[fin] <= tol[fin])


# --------------------------------------------------------------------------
# CPU: the plain composition against the JAX package.

@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("inp", ["bf16", "f32"])
@pytest.mark.parametrize("pool,meta", PAIRS)
def test_rope_append_plain_matches_jax(jx, pool, meta, inp, G):
    jnp, jkv = jx.jnp, jx.jkv
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
           "fp8": jnp.float8_e4m3fn}
    D = 16
    inv, ps, att = jx.rope_params(jx.RopeConfig(**LLAMA3), D)
    for g, (page, bpp, B) in enumerate(GEOMS):
        tc, steps = append_case(pool, meta, page, bpp, B, D=D, seed=g)
        H = tc.kv_pages.shape[1]
        jc = jkv.PagedKVCache(
            jnp.asarray(_f32(tc.kv_pages)).astype(jdt[pool]),
            jnp.asarray(_f32(tc.k_max)).astype(jdt[meta]),
            jnp.asarray(_f32(tc.k_min)).astype(jdt[meta]),
            jnp.asarray(tc.block_tab.numpy()), None)
        for i, (lens, act) in enumerate(steps):
            k, v = append_inputs(B, H, D, inp, seed=10 * g + i)
            q = query(B, H * G, D, inp, seed=10 * g + i + 100)
            pos = jnp.asarray(lens.numpy())[:, None]
            # JAX's cos / sin, as apply_rope makes them (rope_cos_sin's
            # values can differ from XLA's in the last bit).
            ang = (pos.astype(jnp.float32) / ps)[..., None] * inv
            cos = np.array(jnp.cos(ang) * att)             # [B, 1, D/2]
            sin = np.array(jnp.sin(ang) * att)
            tc.seq_lens = lens
            got_q = tkv.rope_append_decode_at(
                tc, 1, q, k, v, torch.from_numpy(cos),
                torch.from_numpy(sin), active=act)
            assert got_q.dtype == q.dtype and got_q.shape == q.shape
            k_rot = rotate_plain(k, torch.from_numpy(cos),
                                 torch.from_numpy(sin))
            for x, got in ((q, got_q), (k, k_rot)):
                want = jx.apply_rope(
                    jnp.asarray(_f32(x)).astype(jdt[inp])[:, None], pos,
                    inv, ps, att)[:, 0]
                assert_rotation_close(got, want, x, cos, sin)
            jc = jkv.PagedKVCache(jc.kv_pages, jc.k_max, jc.k_min,
                                  jc.block_tab, jnp.asarray(lens.numpy()))
            jc = jkv.append_decode_at(
                jc, 1, jnp.asarray(_f32(k_rot)).astype(jdt[inp]),
                jnp.asarray(_f32(v)).astype(jdt[inp]),
                active=None if act is None else jnp.asarray(act.numpy()))
            for t, j in ((tc.kv_pages, jc.kv_pages), (tc.k_max, jc.k_max),
                         (tc.k_min, jc.k_min)):
                np.testing.assert_array_equal(
                    _f32(t), _f32(j), err_msg=f"{(page, bpp, B)} step {i}")
        assert np.isfinite(_f32(tc.kv_pages)).all()


def test_rope_append_on_cpu_is_the_plain_composition():
    """On the CPU the wrapper is rotate_plain of q, and the plain append
    of rotate_plain(k), launching nothing."""
    tc, steps = append_case("bf16", "fp8", 16, 1, 4, D=128)
    ref = clone_cache(tc)
    k, v = append_inputs(4, 2, 128, "bf16", seed=3)
    q = query(4, 8, 128, "bf16", seed=4)
    inv, ps, att = compute_rope_params(RopeConfig(**LLAMA3), 128)
    lens, act = steps[0]
    cos, sin = rope_cos_sin(lens[:, None], inv, ps, att)  # [4, 1, 1, 64]
    tc.seq_lens = ref.seq_lens = lens
    before = tkv.rope_append_decode_at.launches
    got = tkv.rope_append_decode_at(tc, 1, q, k, v, cos, sin, active=act)
    assert tkv.rope_append_decode_at.launches == before
    cs, sn = cos[:, 0], sin[:, 0]                          # [4, 1, 64]
    assert torch.equal(got, rotate_plain(q, cs, sn))
    tkv.append_decode_at_plain(ref, 1, rotate_plain(k, cs, sn), v,
                               active=act)
    for name in ("kv_pages", "k_max", "k_min"):
        assert same_bits(getattr(tc, name), getattr(ref, name)), name


def test_decode_forward_merges_rope_into_the_append(monkeypatch):
    """A decode step calls the merged op once a layer, with the step's
    mask, and rotate_qk never; a prefill chunk calls rotate_qk once a
    layer and the merged op never."""
    from quest_tpu_torch.kv.paged_kv import init_cache
    cfg = tiny_test_model(2)
    quest = QuestConfig(page_size=8, token_budget=32, max_seq_len=256,
                        block_pages=8, skip_layers=1,
                        kv_dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(2),
                                device="cpu")
    calls = {"rope": 0, "merged": 0, "active": []}
    rotate_qk, merged = tllama.rotate_qk, tllama.rope_append_decode_at

    def count_rope(*a, **kw):
        calls["rope"] += 1
        return rotate_qk(*a, **kw)

    def count_merged(*a, active=None, **kw):
        calls["merged"] += 1
        calls["active"].append(active)
        return merged(*a, active=active, **kw)
    monkeypatch.setattr(tllama, "rotate_qk", count_rope)
    monkeypatch.setattr(tllama, "rope_append_decode_at", count_merged)
    model = tllama.QuestModel(cfg, quest, params)
    cache = init_cache(cfg, quest, batch_size=2, device="cpu")
    toks = torch.randint(1, 256, (2, 40),
                         generator=torch.Generator().manual_seed(0))
    L = cfg.num_layers
    assert torch.isfinite(model.prefill_last(cache, toks)).all()
    assert (calls["rope"], calls["merged"]) == (L, 0)
    calls["rope"] = 0
    live = torch.tensor([True, False])
    assert torch.isfinite(model.decode_step(cache, toks[:, -1],
                                            active=live)).all()
    assert (calls["rope"], calls["merged"]) == (0, L)
    assert all(torch.equal(a, live) for a in calls["active"])


def test_merged_decode_step_equals_the_two_op_step(monkeypatch):
    """The model's decode step through the merged op gives the logits and
    cache of the step as it ran before the merge: rotate_qk of q and k,
    then append_decode_at of the rotated k."""
    from quest_tpu_torch.kv.paged_kv import init_cache
    cfg = tiny_test_model(2)
    quest = QuestConfig(page_size=8, token_budget=32, max_seq_len=256,
                        block_pages=8, skip_layers=1,
                        kv_dtype=torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(5),
                                device="cpu")
    model = tllama.QuestModel(cfg, quest, params)
    toks = torch.randint(1, 256, (2, 30),
                         generator=torch.Generator().manual_seed(1))
    caches = []
    for split in (False, True):
        cache = init_cache(cfg, quest, batch_size=2, device="cpu")
        model.prefill_last(cache, toks)
        if split:
            def two_ops(cache, l, q, k, v, cos, sin, active=None):
                qr, kr = tllama.rotate_qk(q[:, None], k[:, None], cos, sin)
                tkv.append_decode_at(cache, l, kr[:, 0], v, active=active)
                return qr[:, 0]
            monkeypatch.setattr(tllama, "rope_append_decode_at", two_ops)
        logits = model.decode_step(cache, toks[:, -1])
        caches.append((logits, cache))
    (la, ca), (lb, cb) = caches
    assert torch.equal(la, lb)
    for name in ("kv_pages", "k_max", "k_min", "seq_lens"):
        assert torch.equal(getattr(ca, name), getattr(cb, name)), name


def test_rope_append_refuses_what_the_kernel_cannot_take():
    """Shape checks run before anything is launched: they hold on any
    device, so they are checked here on tensors that claim a card."""
    tc, steps = append_case("bf16", "bf16", 16, 1, 4, D=128)
    k, v = append_inputs(4, 2, 128, "bf16", seed=1)
    q = query(4, 8, 128, "bf16", seed=2)
    inv, ps, att = compute_rope_params(RopeConfig(), 128)
    cos, sin = rope_cos_sin(steps[0][0][:, None], inv, ps, att)

    class OnCard(torch.Tensor):          # is_cuda without a card
        @property
        def is_cuda(self):
            return True
    for bad_q, bad_cos in ((q[:, :7], cos), (q.float(), cos),
                           (q, cos[:2]), (q, cos.double())):
        with pytest.raises(ValueError):
            tkv.rope_append_decode_at(tc, 1, bad_q.as_subclass(OnCard), k,
                                      v, bad_cos, sin)


def test_step_kernels_script_runs_on_cpu():
    """``python -m quest_tpu_torch.exp.step_kernels --cpu``: the A/B
    script's rows and its reading of a tiny model's decode step."""
    from quest_tpu_torch.exp import step_kernels
    out = step_kernels.main(["--cpu", "--steps", "2", "--label", "cpu"])
    assert set(out["timer_ms"]) == {"rms_norm_decode", "rms_norm_chunk_64",
                                    "rope_then_append", "rope_append"}
    assert all(len(v["host"]) == 2 for v in out["timer_ms"].values())
    assert out["step"]["wall_ms_per_step"] > 0
    assert out["step"]["kernels"] == {}          # no device on the CPU
    assert out["norm_in_graph_us"] == {}


# --------------------------------------------------------------------------
# Card cases: the kernels against the plain versions.

def _same_cache(a, b, what):
    for name in ("kv_pages", "k_max", "k_min"):
        assert same_bits(getattr(a, name), getattr(b, name)), \
            f"{what}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("inp", ["bf16", "f32"])
@pytest.mark.parametrize("pool,meta", PAIRS)
def test_rope_append_kernel_matches_plain_on_card(cuda, pool, meta, inp):
    """Over the geometries' 7 appends the group takes each of G = 4, 1, 8,
    3 and 32 (8 KV heads: 8 to 256 query heads, 1 to 31 rotating warps
    a CTA)."""
    inv, ps, att = compute_rope_params(RopeConfig(**LLAMA3), 128)
    inv = inv.to(cuda)
    H, n = 8, 0
    for g, (page, bpp, B) in enumerate(GEOMS):
        cache, steps = append_case(pool, meta, page, bpp, B, H=H, D=128,
                                   seed=g, device=cuda)
        ref = clone_cache(cache)
        for i, (lens, act) in enumerate(steps):
            G, n = (4, 1, 8, 3, 32)[n % 5], n + 1
            k, v = append_inputs(B, H, 128, inp, seed=10 * g + i,
                                 device=cuda, large=True)
            q = query(B, H * G, 128, inp, seed=10 * g + i + 100,
                      device=cuda)
            cos, sin = rope_cos_sin(lens[:, None], inv, ps, att)
            cache.seq_lens = ref.seq_lens = lens
            before = tkv.rope_append_decode_at.launches
            got = tkv.rope_append_decode_at(cache, 1, q, k, v, cos, sin,
                                            active=act)
            assert tkv.rope_append_decode_at.launches == before + 1
            want = tkv.rope_append_decode_at_plain(ref, 1, q, k, v, cos,
                                                   sin, active=act)
            torch.cuda.synchronize()
            assert same_bits(got, want), f"q_rot {(page, bpp, B)} step {i}"
            _same_cache(cache, ref, f"{(page, bpp, B)} step {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 1, 4096), (1, 8192, 4096),
                                   (3, 14336), (7, 4099), (2000, 4096)])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_rms_norm_keeps_note_d_on_card(cuda, dt, shape, residual):
    """Decode rows, a prefill chunk, a width past a thread's registers
    (14336: the loop), one that takes the element path (4099: no 16-byte
    pieces) and more rows than the grid, against the plain
    version: h bit for bit, the variance within 4 f32 ulps, the norm bit
    for bit given it; two calls give the same bits."""
    dtype = DT[dt]
    rows, H = int(np.prod(shape[:-1])), shape[-1]
    gen = torch.Generator(device=cuda).manual_seed(rows + H)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    r = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.5 * torch.randn((H,), generator=gen, device=cuda)).to(dtype)
    var = torch.empty(rows, device=cuda)
    if residual:
        h, out = rms_norm(x, w, EPS, residual=r, var_out=var)
        want_h, _ = rms_norm_plain(x, w, EPS, residual=r)
        assert same_bits(h, want_h)
        again = rms_norm(x, w, EPS, residual=r)[1]
    else:
        out = rms_norm(x, w, EPS, var_out=var)
        want_h = x
        again = rms_norm(x, w, EPS)
    torch.cuda.synchronize()
    hf = want_h.float().reshape(rows, H)
    assert int(ulps(var, (hf * hf).mean(dim=-1)).max()) <= VAR_ULPS
    assert same_bits(out, rms_scale_plain(want_h, var.reshape(shape[:-1]),
                                          w, EPS))
    assert same_bits(out, again)


@pytest.mark.cuda
def test_rope_append_replay_equals_eager(cuda):
    """One graph of the merged op; replayed after new lengths, a new table
    row, a new mask and new inputs are copied into its static tensors, it
    leaves what the eager call leaves and counts its launch."""
    from quest_tpu_torch.engine.graphs import StepGraphs
    B, G, H, D, page = 4, 4, 8, 128, 16
    cache, steps = append_case("bf16", "fp8", page, 1, B, H=H, D=D,
                               device=cuda)
    inv, ps, att = compute_rope_params(RopeConfig(**LLAMA3), D)
    inv = inv.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, H * G, D), generator=gen, device=cuda).bfloat16()
    k = torch.randn((B, H, D), generator=gen, device=cuda).bfloat16()
    v = torch.randn((B, H, D), generator=gen, device=cuda).bfloat16()
    cache.seq_lens = steps[0][0].clone()
    act = steps[0][1].clone()

    def step(q, k, v, act):
        cos, sin = rope_cos_sin(cache.seq_lens[:, None], inv, ps, att)
        return tkv.rope_append_decode_at(cache, 1, q, k, v, cos, sin,
                                         active=act)
    fn = StepGraphs(cuda).compile(step)
    fn(q, k, v, act)                          # runs, then captures
    cache.seq_lens.copy_(steps[1][0])
    cache.block_tab[2] = cache.block_tab[2].flip(0)
    act2 = torch.tensor([True, False, True, True], device=cuda)
    q2, k2, v2 = (torch.randn(t.shape, generator=gen, device=cuda)
                  .bfloat16() for t in (q, k, v))
    ref = clone_cache(cache)
    n = tkv.rope_append_decode_at.launches
    got = fn(q2, k2, v2, act2).clone()
    torch.cuda.synchronize()
    assert tkv.rope_append_decode_at.launches == n + 1
    cos, sin = rope_cos_sin(ref.seq_lens[:, None], inv, ps, att)
    want = tkv.rope_append_decode_at(ref, 1, q2, k2, v2, cos, sin,
                                     active=act2)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    _same_cache(cache, ref, "replay")
