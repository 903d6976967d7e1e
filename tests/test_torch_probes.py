"""The port's probe kernels against the JAX package's probe scripts on
the CPU (their Pallas kernels in interpret mode), and the CUDA kernels
against their plain versions (on the card only).

The JAX probes keep their kernels inside ``main`` (``exp/dma_probe.py``,
``exp/gather_ab.py``) or trace them at import (``exp/select_compile2.py``),
so the tests run the scripts with ``pl.pallas_call`` wrapped: the wrapper
takes the kernel and its grid as the script built them, and the test
calls them in interpret mode on its own inputs. Nothing under ``exp/``
changes. The JAX side needs ``jax`` and is skipped without it, so the
card cases run on a machine that has no JAX: ``python -m pytest
--noconftest -m cuda tests/test_torch_probes.py``.
"""

import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.exp import dma_probe, gather_ab, select_compile2
from quest_tpu_torch.ops.copy_probe import (copy_probe, copy_probe_plain,
                                            stage_plan)
from quest_tpu_torch.ops.select_pieces import (STAGES, select_pieces,
                                               select_pieces_plain)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EXP = Path(__file__).resolve().parents[1] / "exp"


class _Built(Exception):
    """Raised by the wrapped pallas_call once the kernel is taken."""


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jexp_{name}",
                                                  EXP / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    return types.SimpleNamespace(jnp=jnp, pl=pl)


def jax_probe_kernel(jx, monkeypatch, script, argv):
    """The Pallas kernel and grid that ``exp/<script>.py`` builds for
    ``argv``, taken at its first pallas_call (which then stops it)."""
    built = {}

    def take(kernel, **kw):
        built.update(kernel=kernel, kw=kw)
        raise _Built

    mod = _load(script)
    monkeypatch.setattr(sys, "argv", [script] + [str(a) for a in argv])
    monkeypatch.setattr(jx.pl, "pallas_call", take)
    if script == "gather_ab":    # it times first: one traced call instead
        import quest_tpu.utils.benchmarking as jbench
        monkeypatch.setattr(jbench, "bench_op",
                            lambda fn, q0, env, **kw: fn(q0, env))
    with pytest.raises(_Built):
        mod.main()
    monkeypatch.undo()
    assert built["kw"]["interpret"]
    return built["kernel"], built["kw"]


def pool(total_mb, page_kb, seed=0):
    """The scripts' draws: a permutation of the pages, then the pool."""
    total = total_mb * 1024 * 1024 // 2
    PAGE = page_kb * 1024 // 2
    rng = np.random.default_rng(seed)
    perm = rng.permutation(total // PAGE).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal(total).astype(np.float32)).to(
        torch.bfloat16).reshape(total // PAGE, PAGE // 128, 128)
    return perm, x


# mode, page KB, nsem: 1 MB in 64 KB chunks, 3 slots.
COPY_CASES = [(m, p, s) for m in ("contig", "gather") for p in (8, 16)
              for s in (1, 2)]


@pytest.mark.parametrize("mode,page_kb,nsem", COPY_CASES)
def test_copy_probe_plain_matches_jax(jx, monkeypatch, mode, page_kb, nsem):
    kernel, kw = jax_probe_kernel(jx, monkeypatch, "dma_probe",
                                  [mode, 64, 3, 1, nsem, page_kb])
    perm, x = pool(1, page_kb)
    order = perm if mode == "gather" else np.arange(len(perm), dtype=np.int32)
    q = np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    J = jx.jnp.asarray
    xj = J(x.view(torch.int16).numpy()).view(jx.jnp.bfloat16)
    want = np.asarray(jx.pl.pallas_call(kernel, **kw)(J(order), J(q), xj))
    ppc = 64 // page_kb
    got = copy_probe(torch.from_numpy(order), torch.from_numpy(q), x,
                     ppc=ppc, nsem=nsem, contig=mode == "contig").numpy()
    np.testing.assert_allclose(got - q, want - q, rtol=1e-5, atol=1e-12)
    # The script's own CPU check: the plain version against the formula.
    assert dma_probe.main([mode, 64, 3, 1, nsem, page_kb, "--cpu"]) == 0


def test_gather_ab_plain_matches_jax(jx, monkeypatch):
    """exp/gather_ab.py's kernel (1024 KB chunks, one copy a page) on
    2 MB of 8 KB pages, with the port's draws in the script's order."""
    kernel, kw = jax_probe_kernel(jx, monkeypatch, "gather_ab", [2, 3, 8, 1])
    run = gather_ab.build_runs(2, [8], "cpu")[0]
    J = jx.jnp.asarray
    q = np.zeros((8, 128), np.float32)
    xj = J(run.xp.view(torch.int16).numpy()).view(jx.jnp.bfloat16)
    want = np.asarray(jx.pl.pallas_call(kernel, **kw)(J(run.idx.numpy()),
                                                      J(q), xj))
    got = run(torch.from_numpy(q), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert gather_ab.main(["2", "3", "8,16", "1", "--cpu"]) == 0


def test_stage_plan():
    """1024 KB chunks of 8 KB pages on 132 SMs: 64 KB stages, a
    192 KB ring, and the stages dealt out whole."""
    p = stage_plan(32768, 8192, 128, 3, 1, 132)
    assert (p.pps, p.nstage, p.per_cta, p.nctas, p.smem) == (
        8, 4096, 32, 128, 3 * 65536)
    assert stage_plan(64, 32768, 4, 3, 2, 132).pps == 2
    with pytest.raises(ValueError):
        stage_plan(64, 32768, 4, 3, 4, 132)      # 4 semaphores, 2 pages
    with pytest.raises(ValueError):
        stage_plan(64, 8192, 128, 4, 1, 132)     # a 256 KB ring


# --------------------------------------------------------------------------
# Select pieces.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpieces(jx):
    """exp/select_compile2.py, loaded with pallas_call in interpret mode
    (it compiles a stage at import); tests set its STAGE and SG."""
    real = jx.pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.pl, "pallas_call",
                   lambda *a, **k: real(*a, **dict(k, interpret=True)))
        mp.setattr(sys, "argv", ["select_compile2.py", "full", "1"])
        yield _load("select_compile2")


@pytest.mark.parametrize("SG", [1, 2, 8])
@pytest.mark.parametrize("stage", STAGES)
def test_select_pieces_plain_matches_jax(jx, jpieces, stage, SG):
    s = select_compile2.make_input(stage, SG, seed=SG)
    if stage == "cumsum":
        assert np.all(s == np.round(s))            # integer-valued input
    jpieces.STAGE, jpieces.SG = stage, SG
    want = np.asarray(jpieces.run.__wrapped__(jx.jnp.asarray(s)))
    got = select_pieces(torch.from_numpy(s), stage).numpy()
    if stage in select_compile2.SUM_STAGES:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, err
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert select_compile2.main([stage, str(SG), "--cpu"]) == 0


def test_select_pieces_rejects_bad_input():
    with pytest.raises(ValueError, match="stage"):
        select_pieces(torch.zeros((1, 16, 128)), "sort")
    with pytest.raises(ValueError, match="16, 128"):
        select_pieces(torch.zeros((1, 8, 128)), "full")


# --------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only).
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["contig", "gather"])
@pytest.mark.parametrize("page_kb,nsem,nslot,ctas", [
    (8, 1, 3, None), (8, 2, 2, 5), (16, 4, 1, 3), (32, 2, 3, 7),
    (32, 1, 3, 1)])
def test_copy_probe_kernel_matches_plain(cuda, mode, page_kb, nsem, nslot,
                                         ctas):
    """16 MB in 1024 KB chunks; few CTAs make each walk its ring many
    times."""
    perm, x = pool(16, page_kb, seed=page_kb)
    order = perm if mode == "gather" else np.arange(len(perm), dtype=np.int32)
    idx, x = torch.from_numpy(order).to(cuda), x.to(cuda)
    q = torch.randn((8, 128), device=cuda)
    ppc = 1024 // page_kb
    got = copy_probe(idx, q, x, ppc=ppc, nslot=nslot, nsem=nsem,
                     contig=mode == "contig", ctas=ctas)
    want = copy_probe_plain(idx, q, x, ppc)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / (want - q).abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("SG", [1, 2, 8, 100])
@pytest.mark.parametrize("stage", STAGES)
def test_select_pieces_kernel_matches_plain(cuda, stage, SG):
    s = torch.from_numpy(select_compile2.make_input(stage, SG)).to(cuda)
    got, want = select_pieces(s, stage), select_pieces_plain(s, stage)
    torch.cuda.synchronize()
    assert select_compile2.mismatch(got, want, stage) == 0
