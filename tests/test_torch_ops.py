"""The port's plain ops against the JAX package on shared numpy inputs:
rope (four variants), RMSNorm, the physical-page estimate, top-K page
selection (bit for bit) and the eager attention oracles."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.config import RopeConfig as JRopeConfig
from quest_tpu.ops import reference as jref
from quest_tpu.ops.estimate import page_scores as j_scores
from quest_tpu.ops.estimate import page_scores_per_qhead as j_scores_per_q
from quest_tpu.ops.estimate import page_scores_physical as j_scores_phys
from quest_tpu.ops.rms_norm import rms_norm as j_rms_norm
from quest_tpu.ops.rope import apply_rope as j_apply_rope
from quest_tpu.ops.rope import compute_rope_params as j_rope_params
from quest_tpu.ops.topk import select_pages as j_select_pages
from quest_tpu_torch.config import RopeConfig
from quest_tpu_torch.ops import reference as tref
from quest_tpu_torch.ops.estimate import (page_scores,
                                          page_scores_per_qhead,
                                          page_scores_physical)
from quest_tpu_torch.ops.rms_norm import rms_norm
from quest_tpu_torch.ops.rope import apply_rope, compute_rope_params
from quest_tpu_torch.ops.topk import select_pages

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROPES = {
    "plain": dict(theta=10000.0),
    "linear": dict(theta=10000.0, scaling="linear", factor=8.0),
    "llama3": dict(theta=500000.0, scaling="llama3", factor=8.0,
                   low_freq_factor=1.0, high_freq_factor=4.0,
                   original_max_position_embeddings=8192),
    "yarn": dict(theta=10000.0, scaling="yarn", factor=32.0,
                 original_max_position_embeddings=4096),
}


@pytest.mark.parametrize("variant", sorted(ROPES))
def test_rope_matches_jax(variant):
    D = 64
    j_inv, j_ps, j_as = j_rope_params(JRopeConfig(**ROPES[variant]), D)
    t_inv, t_ps, t_as = compute_rope_params(RopeConfig(**ROPES[variant]), D)
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_inv), rtol=1e-6)
    assert (t_ps, t_as) == (j_ps, j_as)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, 600, size=(2, 7)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), j_inv, j_ps, j_as)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), t_inv,
                     t_ps, t_as)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    # f32: within four f32 ulps. XLA's CPU reduction tree for the mean
    # (windows of 32, then a multiply by 1/n) and its reciprocal square
    # root each round differently from PyTorch's by up to one ulp, and
    # the two products after them carry the difference on, so bit
    # equality is not reachable from eager PyTorch.
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))

    # bf16: within one bf16 ulp (2^-7 relative) of the JAX result.
    want16 = j_rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), 1e-5)
    want16 = np.asarray(want16.astype(jnp.float32))
    got16 = rms_norm(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16(), 1e-5).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want16), 1e-30))) - 7)
    assert np.all(np.abs(got16 - want16) <= ulp)


@pytest.mark.parametrize("group_agg,per_q_head", [
    ("sum", False), ("max", False), ("sum", True)])
def test_page_scores_physical_matches_jax(group_agg, per_q_head):
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, NPB, bpp, NB = 2, 8, 2, 32, 7, 4, 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kmax = rng.standard_normal((Hkv, NPB, bpp, D)).astype(np.float32)
    kmin = kmax - np.abs(rng.standard_normal((Hkv, NPB, bpp, D))).astype(
        np.float32)
    tab = np.stack([rng.permutation(np.arange(1, NPB))[:NB]
                    for _ in range(B)]).astype(np.int32)
    want = j_scores_phys(jnp.asarray(q), jnp.asarray(kmax), jnp.asarray(kmin),
                         jnp.asarray(tab), group_agg=group_agg,
                         per_q_head=per_q_head)
    got = page_scores_physical(torch.from_numpy(q), torch.from_numpy(kmax),
                               torch.from_numpy(kmin), torch.from_numpy(tab),
                               group_agg=group_agg, per_q_head=per_q_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("variant", ["max", "sum", "per_qhead"])
def test_page_scores_logical_match_jax(variant):
    rng = np.random.default_rng(5)
    B, Hq, Hkv, D, P = 2, 8, 2, 32, 11
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kmax = rng.standard_normal((B, Hkv, P, D)).astype(np.float32)
    kmin = kmax - np.abs(rng.standard_normal((B, Hkv, P, D))).astype(
        np.float32)
    J, T = jnp.asarray, torch.from_numpy
    if variant == "per_qhead":
        want = j_scores_per_q(J(q), J(kmax), J(kmin))
        got = page_scores_per_qhead(T(q), T(kmax), T(kmin))
    else:
        want = j_scores(J(q), J(kmax), J(kmin), group_agg=variant)
        got = page_scores(T(q), T(kmax), T(kmin), group_agg=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seq_lens,P,budget,H", [
    ([300, 41], 64, 8, 2),      # long row and short row (dense fallback)
    ([9, 1], 16, 4, 3),         # very short rows, junk tail slots
    ([1000, 999], 128, 16, 4),  # both rows long
    ([50, 130], 20, 24, 1),     # budget above the pool width
])
def test_select_pages_bitwise(seq_lens, P, budget, H):
    rng = np.random.default_rng(sum(seq_lens) + P)
    B = len(seq_lens)
    page = 8
    # Tie-free scores: a random permutation of distinct values.
    scores = rng.permutation(B * H * P).reshape(B, H, P).astype(np.float32)
    seq = np.asarray(seq_lens, np.int32)
    wi, wn = j_select_pages(jnp.asarray(scores), jnp.asarray(seq), page,
                            budget)
    gi, gn = select_pages(torch.from_numpy(scores), torch.from_numpy(seq),
                          page, budget)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert gi.dtype == torch.int32 and gn.dtype == torch.int32


def test_reference_oracles_match_jax():
    rng = np.random.default_rng(4)
    B, Hq, Hkv, D, P, page = 2, 4, 2, 16, 6, 8
    T = P * page
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    seq = np.asarray([37, 45], np.int32)
    sm = 1.0 / np.sqrt(D)
    J = lambda a: jnp.asarray(a)            # noqa: E731
    Tt = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)

    close(tref.dense_decode_attention_reference(Tt(q), Tt(k), Tt(v),
                                                Tt(seq), sm),
          jref.dense_decode_attention_reference(J(q), J(k), J(v), J(seq), sm))

    kp = k.reshape(B, Hkv, P, page, D)
    vp = v.reshape(B, Hkv, P, page, D)
    idx = np.stack([np.stack([rng.permutation(P)[:4] for _ in range(Hkv)])
                    for _ in range(B)]).astype(np.int32)
    nv = np.asarray([4, 3], np.int32)
    close(tref.sparse_decode_attention_reference(Tt(q), Tt(kp), Tt(vp),
                                                 Tt(idx), Tt(nv), Tt(seq), sm),
          jref.sparse_decode_attention_reference(J(q), J(kp), J(vp), J(idx),
                                                 J(nv), J(seq), sm))

    qp = rng.standard_normal((B, 5, Hq, D)).astype(np.float32)
    off = np.asarray([0, 30], np.int32)
    kvl = off + 5
    close(tref.prefill_attention_reference(Tt(qp), Tt(k), Tt(v), Tt(off),
                                           Tt(kvl), sm),
          jref.prefill_attention_reference(J(qp), J(k), J(v), J(off),
                                           J(kvl), sm))

    kmax = rng.standard_normal((B, Hkv, P, D)).astype(np.float32)
    kmin = kmax - 1.0
    close(tref.estimate_reference(Tt(q), Tt(kmin), Tt(kmax)),
          jref.estimate_reference(J(q), J(kmin), J(kmax)))
