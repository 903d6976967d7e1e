"""The port's weight-only quantization against the JAX package, on the
CPU: ``quantize_weight`` and ``dequantize_weight`` bit for bit, ``qdot``
within 1e-6 (f32), JAX's quantized and AWQ trees carried over by
``params_from_numpy``, a 2-layer f32 quantized model (logits within 1e-5
relative, greedy tokens equal), the AWQ search and the whole AWQ pass
(the same alphas); and the rule that no module of the port imports
``jax`` or ``quest_tpu``.

The card cases (``cuda`` marker) hold the ``qgemv`` and ``dequant``
kernels to their plain versions and need no JAX: ``python -m pytest
--noconftest -m cuda tests/test_torch_quantize.py``.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
from quest_tpu_torch.engine import QuestEngine
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models import awq as tawq
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import QuestModel, init_params
from quest_tpu_torch.models.quantize import (QUANT_KEYS, QuantizedLinear,
                                             dequantize_weight,
                                             init_params_quantized, qdot,
                                             quantize_params,
                                             quantize_weight)
from quest_tpu_torch.ops import qdot as tops

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card's AWQ phase, run here)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
QUEST = dict(page_size=8, token_budget=32, max_seq_len=256, skip_layers=1,
             block_pages=8)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's quantization and model modules, imported here so
    that the card cases run without JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu import config as jconfig
    from quest_tpu.engine.engine import QuestEngine as JEngine
    from quest_tpu.kv.paged_kv import init_cache as jinit_cache
    from quest_tpu.models import awq as jawq
    from quest_tpu.models import quantize as jquant
    from quest_tpu.models.llama import QuestModel as JModel
    from quest_tpu.models.llama import init_params as jinit
    jcfg = jconfig.ModelConfig(rope=jconfig.RopeConfig(), dtype=jnp.float32,
                               **MODEL)
    jquest = jconfig.QuestConfig(kv_dtype=jnp.float32, **QUEST)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jquant=jquant, jawq=jawq, JEngine=JEngine,
        JModel=JModel, jinit=jinit, jinit_cache=jinit_cache, jcfg=jcfg,
        jquest=jquest,
        cfg=ModelConfig(rope=RopeConfig(), dtype=torch.float32, **MODEL),
        quest=QuestConfig(kv_dtype=torch.float32, **QUEST))


def _weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(jx, w, dtype):
    """The same weights as a JAX array and a tensor (bf16 rounded once,
    by torch, and handed to both)."""
    t = torch.from_numpy(w)
    if dtype == "bf16":
        t = t.bfloat16()
        return jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16), t
    return jx.jnp.asarray(w), t


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)],
                         ids=["unstacked", "stacked"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_bitwise(jx, bits, dtype, shape):
    wj, wt = _pair(jx, _weights(bits + len(shape), shape), dtype)
    want = jx.jquant.quantize_weight(wj, bits)
    got = quantize_weight(wt, bits)
    assert got.bits == bits and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", [False, True], ids=["rtn", "inv_s"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_weight_bitwise(jx, bits, fold, out_dtype):
    w = _weights(11, (2, 64, 32))
    jw = jx.jquant.quantize_weight(jx.jnp.asarray(w), bits)
    inv = np.random.default_rng(12).uniform(0.5, 2.0, (2, 64)).astype(
        np.float32) if fold else None
    if fold:
        jw = dataclasses.replace(jw, inv_s=jx.jnp.asarray(inv))
    tw = QuantizedLinear(q=torch.from_numpy(np.asarray(jw.q)),
                         s=torch.from_numpy(np.asarray(jw.s)), bits=bits,
                         inv_s=None if inv is None else torch.from_numpy(inv))
    want = np.asarray(jx.jquant.dequantize_weight(
        jw, getattr(jx.jnp, out_dtype))).astype(np.float32)
    got = dequantize_weight(tw, getattr(torch, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fold", [False, True], ids=["rtn", "inv_s"])
@pytest.mark.parametrize("bits", [8, 4])
def test_qdot_matches_jax(jx, bits, fold):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jw = jx.jquant.quantize_weight(jx.jnp.asarray(w), bits)
    inv = rng.uniform(0.5, 2.0, 64).astype(np.float32) if fold else None
    if fold:
        jw = dataclasses.replace(jw, inv_s=jx.jnp.asarray(inv))
    want = np.asarray(jx.jquant.qdot(jx.jnp.asarray(x), jw))
    tw = params_from_numpy({"embed": x, "final_norm": x, "lm_head": jw,
                            "layers": {}}, device="cpu")["lm_head"]
    got = qdot(torch.from_numpy(x), tw).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # A plain weight is a plain product.
    np.testing.assert_array_equal(
        qdot(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        (torch.from_numpy(x) @ torch.from_numpy(w)).numpy())


def _jax_tree(jx, bits):
    params = jx.jinit(jx.jcfg, jx.jax.random.PRNGKey(2), dtype=jx.jnp.float32)
    return jx.jax.tree.map(np.asarray, jx.jquant.quantize_params(params, bits))


@pytest.mark.parametrize("kind", ["rtn8", "rtn4", "awq"])
def test_params_from_numpy_takes_quantized_trees(jx, request, kind):
    tree = (request.getfixturevalue("awq").jtree if kind == "awq"
            else _jax_tree(jx, int(kind[3:])))
    got = params_from_numpy(tree, device="cpu")
    for name in QUANT_KEYS + ("lm_head",):
        want = tree["lm_head"] if name == "lm_head" else tree["layers"][name]
        have = got["lm_head"] if name == "lm_head" else got["layers"][name]
        assert isinstance(have, QuantizedLinear) and have.bits == want.bits
        np.testing.assert_array_equal(have.q.numpy(), want.q)
        np.testing.assert_array_equal(have.s.numpy(), want.s)
        assert (have.inv_s is None) == (want.inv_s is None)
        if want.inv_s is not None:
            np.testing.assert_array_equal(have.inv_s.numpy(), want.inv_s)
    np.testing.assert_array_equal(got["layers"]["ln_attn"].numpy(),
                                  tree["layers"]["ln_attn"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_model_matches_jax(jx, bits):
    """2 layers in f32 with the sparse path live (prompts of 100 and 77
    tokens, a 4-page budget): prefill and decode logits within 1e-5 of
    JAX's (max |d| / max |JAX|), greedy tokens equal over 8 decode
    steps."""
    tree = _jax_tree(jx, bits)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (100, 77)]
    jeng = jx.JEngine(jx.jcfg, jx.jquest, tree, batch_size=2,
                      prefill_bucket=16)
    teng = QuestEngine(jx.cfg, jx.quest, params_from_numpy(tree, device="cpu"),
                       batch_size=2, prefill_bucket=16, device="cpu")
    want, got = jeng.prefill(prompts), teng.prefill(prompts)
    for _ in range(9):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        tok = np.argmax(want, axis=-1).astype(np.int32)
        np.testing.assert_array_equal(np.argmax(got, axis=-1), tok)
        want, got = jeng.decode(tok), teng.decode(tok)


def test_init_params_quantized_equals_quantize_params():
    cfg = ModelConfig(rope=RopeConfig(), dtype=torch.bfloat16, **MODEL)
    for bits in (8, 4):
        a = quantize_params(init_params(cfg, torch.Generator().manual_seed(6),
                                        device="cpu"), bits)
        b = init_params_quantized(cfg, torch.Generator().manual_seed(6), bits,
                                  device="cpu")
        for name in QUANT_KEYS + ("lm_head",):
            x = a["lm_head"] if name == "lm_head" else a["layers"][name]
            y = b["lm_head"] if name == "lm_head" else b["layers"][name]
            assert torch.equal(x.q, y.q) and torch.equal(x.s, y.s)
        assert torch.equal(a["embed"], b["embed"])


def test_qgemv_plan_fills_the_card():
    """At every full-width linear, both widths, M = 1..16 and both
    kernels: the splits cover the input rows in the kernel's steps, the
    staged x slice fits 48 KB, and the CTAs cover at least 80% of 132
    SMs; the lm_head (f32 x) at M <= 2 takes no split (501 column
    tiles)."""
    sms = 132
    for K, N in [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256)]:
        for bits in (8, 4):
            k_rows = K // 2 if bits == 4 else K
            for M in range(1, 17):
                for bf16 in (True, False):
                    chunk, ksplit = tops.qgemv_plan(k_rows, N, sms, M, bits,
                                                    bf16)
                    if bf16:
                        mt, xbytes, step = (8 if M <= 8 else 16), 2, 64
                    else:
                        mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
                        xbytes, step = 4, 16
                    assert chunk % step == 0
                    assert (ksplit - 1) * chunk < k_rows <= ksplit * chunk
                    assert (mt * (2 if bits == 4 else 1) * chunk * xbytes
                            <= 48 << 10)
                    assert -(-N // tops.TILE_N) * ksplit >= 0.8 * sms
    for bits in (8, 4):
        assert tops.qgemv_plan(4096 // (8 // bits), 128256, sms, 2, bits,
                               False)[1] == 1


# -- AWQ -----------------------------------------------------------------------

def _awq_setup(jx):
    """2 layers in f32 with salient input channels (8 embedding channels
    scaled by 6, as ``tests/test_quantize.py``'s AWQ case), calibration
    tokens, both packages' models and caches."""
    params = jx.jinit(jx.jcfg, jx.jax.random.PRNGKey(4), dtype=jx.jnp.float32)
    rng = np.random.default_rng(9)
    boost = np.ones(64, np.float32)
    boost[rng.choice(64, 8, replace=False)] = 6.0
    params = {**params, "embed": jx.jnp.asarray(
        np.asarray(params["embed"]) * boost[None, :])}
    tree = jx.jax.tree.map(np.asarray, params)
    toks = rng.integers(0, 256, size=(1, 64)).astype(np.int32)
    tparams = params_from_numpy(tree, device="cpu")
    return types.SimpleNamespace(
        params=params, tree=tree, toks=toks, tparams=tparams,
        jmodel=jx.JModel(jx.jcfg, jx.jquest),
        jcache=jx.jinit_cache(jx.jcfg, jx.jquest, batch_size=1),
        tmodel=QuestModel(jx.cfg, jx.quest, tparams),
        tcache=lambda: init_cache(jx.cfg, jx.quest, batch_size=1,
                                  device="cpu"))


@pytest.fixture(scope="module")
def awq(jx):
    s = _awq_setup(jx)
    s.jcal = jx.jawq.awq_calibrate(s.jmodel, s.params, s.jcache,
                                   jx.jnp.asarray(s.toks))
    s.tcal = tawq.awq_calibrate(s.tmodel, s.tcache(), torch.from_numpy(s.toks))
    s.japar = jx.jawq.awq_quantize_params(s.jmodel, s.params, s.jcache,
                                          jx.jnp.asarray(s.toks), bits=4,
                                          n_grid=6)
    s.jtree = jx.jax.tree.map(np.asarray, s.japar)
    return s


def test_awq_calibration_matches_jax(awq):
    assert sorted(awq.tcal) == sorted(awq.jcal)
    for name, ents in awq.jcal.items():
        assert len(awq.tcal[name]) == len(ents)
        for want, got in zip(ents, awq.tcal[name]):
            for key in ("a_mean", "rows"):
                w = np.asarray(want[key])
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", ["wq", "w_down", "lm_head"])
def test_awq_search_scale_matches_jax(jx, awq, name):
    """The same calibration entry in both: the same alpha, inv_s within
    1e-6 relative, the same grid of errors within 1e-5 relative."""
    for l, ent in enumerate(awq.jcal[name]):
        w = (awq.tree["lm_head"] if name == "lm_head"
             else awq.tree["layers"][name][l])
        a_mean, rows = np.asarray(ent["a_mean"]), np.asarray(ent["rows"])
        j_inv, j_alpha, j_errs = jx.jawq.awq_search_scale(
            w, a_mean, rows, 4, n_grid=6)
        t_inv, t_alpha, t_errs = tawq.awq_search_scale(
            torch.from_numpy(w), torch.from_numpy(a_mean),
            torch.from_numpy(rows), 4, n_grid=6)
        assert t_alpha == j_alpha, (name, l, t_errs, j_errs)
        np.testing.assert_allclose(t_inv.numpy(), j_inv, rtol=1e-6)
        np.testing.assert_allclose(t_errs, j_errs, rtol=1e-5)


def test_awq_quantize_params_matches_jax_and_beats_rtn(jx, awq):
    """The whole pass on both sides (n_grid 6): every linear's alpha
    equal (each side searching its own calibration, which agree within
    1e-5), so inv_s within 1e-5 relative and q equal; and on the
    calibration rows AWQ's output error is at most RTN's, per linear and
    layer."""
    japar = awq.japar
    tapar = tawq.awq_quantize_params(awq.tmodel, awq.tparams, awq.tcache(),
                                     torch.from_numpy(awq.toks), bits=4,
                                     n_grid=6)
    for name in QUANT_KEYS + ("lm_head",):
        jw = japar["lm_head"] if name == "lm_head" else japar["layers"][name]
        tw = tapar["lm_head"] if name == "lm_head" else tapar["layers"][name]
        for l in range(len(awq.jcal[name])):
            ents = (awq.jcal[name][l], awq.tcal[name][l])
            w = (awq.tree["lm_head"] if name == "lm_head"
                 else awq.tree["layers"][name][l])
            _, ja, _ = jx.jawq.awq_search_scale(
                w, np.asarray(ents[0]["a_mean"]), np.asarray(ents[0]["rows"]),
                4, n_grid=6)
            _, ta, _ = tawq.awq_search_scale(
                torch.from_numpy(w), ents[1]["a_mean"], ents[1]["rows"], 4,
                n_grid=6)
            assert ta == ja, (name, l)
        np.testing.assert_allclose(tw.inv_s.numpy(), np.asarray(jw.inv_s),
                                   rtol=1e-5)
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_allclose(tw.s.numpy(), np.asarray(jw.s), rtol=1e-5)
        # AWQ <= RTN on the calibration rows.
        for l, ent in enumerate(awq.tcal[name]):
            w = (awq.tparams["lm_head"].float() if name == "lm_head"
                 else awq.tparams["layers"][name][l])
            x = ent["rows"]
            ref = x @ w
            rtn = dequantize_weight(quantize_weight(w, 4), torch.float32)
            one = tw if name == "lm_head" else tw.layer(l)
            e_rtn = float(((x @ rtn - ref) ** 2).mean())
            e_awq = float(((qdot(x, one) - ref) ** 2).mean())
            assert e_awq <= e_rtn * 1.001, (name, l, e_awq, e_rtn)


# -- the port's imports ----------------------------------------------------------

def test_no_module_of_the_port_imports_jax():
    """Every module of quest_tpu_torch, found by walking the package,
    imported in a fresh interpreter: neither jax nor quest_tpu is in
    sys.modules afterwards, and chip_smoke.py names neither."""
    code = (
        "import importlib, pkgutil, sys, quest_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "quest_tpu_torch.__path__, 'quest_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 40, names\n"
        "bad = [m for m in sys.modules if m in ('jax', 'quest_tpu') or "
        "m.startswith(('jax.', 'quest_tpu.'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "quest_tpu." not in smoke


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fold", [False, True], ids=["rtn", "inv_s"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", list(range(1, 17)))
def test_qgemv_matches_plain_on_card(cuda, M, bits, fold, dtype):
    """M = 1..16 rows, in 256 x 528 (a partial column tile, the input
    split across CTAs), within 2e-2 (bf16; int4 sums its halves in f32,
    JAX rounds each) or 1e-5 (f32) of the plain expression; two calls
    bitwise equal (the tickets are left at zero)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(M * 8 + bits)
    K, N = 256, 528
    w = quantize_weight(torch.randn((K, N), generator=g, device=cuda), bits)
    inv = (torch.rand((K,), generator=g, device=cuda) + 0.5) if fold else None
    x = torch.randn((M, K), generator=g, device=cuda).to(dt)
    qd = tops.qgemv.launches
    got = tops.qgemv(x, w.q, w.s, inv, bits)
    again = tops.qgemv(x, w.q, w.s, inv, bits)
    torch.cuda.synchronize()
    assert tops.qgemv.launches == qd + 2
    want = tops.qgemv_plain(x, w.q, w.s, inv, bits, dt)
    assert got.dtype == dt and got.shape == (M, N)
    assert _rel(got, want) <= (2e-2 if dt == torch.bfloat16 else 1e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 1024), (1024, 4096), (64, 16)])
@pytest.mark.parametrize("bits", [8, 4])
def test_qgemv_layer_shapes_on_card(cuda, bits, shape):
    """Layer-like widths (many splits, many tiles) and a tiny one, a view
    of one layer of a stacked weight, M = 2 and 16, bf16 and f32."""
    K, N = shape
    g = torch.Generator(device=cuda).manual_seed(K + bits)
    stacked = quantize_weight(torch.randn((3, K, N), generator=g,
                                          device=cuda), bits)
    one = stacked.layer(1)
    for M in (2, 16):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=g, device=cuda).to(dt)
            got = qdot(x, one)
            want = tops.qgemv_plain(x, one.q, one.s, None, bits, dt)
            assert _rel(got, want) <= (2e-2 if dt == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fold", [False, True], ids=["rtn", "inv_s"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matches_plain_on_card(cuda, bits, fold, dtype):
    """The kernel bitwise equal to dequantize_weight, into a fresh tensor
    and into a larger buffer."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(bits)
    K, N = 384, 272
    w = quantize_weight(torch.randn((K, N), generator=g, device=cuda), bits)
    inv = (torch.rand((K,), generator=g, device=cuda) + 0.5) if fold else None
    want = tops.dequant_plain(w.q, w.s, inv, bits, dt)
    n = tops.dequant.launches
    got = tops.dequant(w.q, w.s, inv, bits, dt)
    buf = torch.full((K * N + 100,), 7, dtype=dt, device=cuda)
    into = tops.dequant(w.q, w.s, inv, bits, dt, out=buf)
    torch.cuda.synchronize()
    assert tops.dequant.launches == n + 2
    assert torch.equal(got, want) and torch.equal(into, want)
    assert (buf[K * N:] == 7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_qdot_routes_by_rows_on_card(cuda, bits):
    """Up to 16 rows launch qgemv, more rows dequant (then torch.matmul),
    with no launch of the other."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = quantize_weight(torch.randn((512, 256), generator=g, device=cuda),
                        bits)
    for rows, kernel in ((16, tops.qgemv), (17, tops.dequant)):
        other = tops.dequant if kernel is tops.qgemv else tops.qgemv
        a, b = kernel.launches, other.launches
        x = torch.randn((rows, 512), generator=g, device=cuda)
        got = qdot(x, w)
        want = tops.qgemv_plain(x, w.q, w.s, None, bits, torch.float32)
        assert _rel(got, want) <= 1e-5
        assert (kernel.launches, other.launches) == (a + 1, b)


def test_qgemv_ablation_script_on_cpu(capsys):
    from quest_tpu_torch.exp import qgemv_ablation
    assert qgemv_ablation.main(["--cpu"]) == 0
    assert "finite True" in capsys.readouterr().out


def test_chip_smoke_awq_phase_on_cpu():
    """chip_smoke.py's AWQ phase on the CPU's plain path: with salient
    activation channels in every layer, no linear's held-out output error
    is above RTN's (the phase asserts it), and the sum falls."""
    sums = chip_smoke.small_awq_phase("cpu")
    assert sums["awq"] < sums["rtn"]
