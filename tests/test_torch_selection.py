"""The unfused decode step's page selection: the estimate over the
physical pool (``ops/estimate.py:page_scores_physical``) and the exact
top-k (``ops/topk.py:select_pages``).

CPU: the port's plain versions against the JAX package on shared numpy
inputs: the select kernel's plain version with the junk id P - 1 gives
``select_pages``' ids and num_valid bit for bit (random rows, tie rows,
rows of 0 and 1 pages, K > P, per-query-head row counts); the physical
estimate over block tables that share a block and park an idle slot on
the scratch block, at pages 16 and 32, over bf16 and fp8 metadata with
denormal codes; the two together select what JAX selects;
``chip_smoke.py``'s yardstick and readings of the estimate. Card
(``cuda``-marked): the estimate's physical route (``csrc/estimate.cu``:
its launch plan, every page of a row in one unit within the kernel's
limits; bpp 1-128, groups of 1-128, rows over 8192 pages, scratch and
shared blocks, a second launch bitwise equal) and the select kernel
(``csrc/topk_select.cu``) against those plain versions, and a decode
step's launches. The JAX side is imported inside
a fixture, so the card cases run without it: ``python -m pytest
--noconftest -m cuda tests/test_torch_selection.py``.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.ops.estimate import (page_scores_physical,
                                          page_scores_physical_plain,
                                          physical_plan)
from quest_tpu_torch.ops.fused_decode import (exact_topk_select,
                                              exact_topk_select_plain)
from quest_tpu_torch.ops.reference import selection_flips
from quest_tpu_torch.ops.topk import select_pages, select_pages_plain

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the estimate's yardstick and readings)

FP8 = torch.float8_e4m3fn
D = 128


@pytest.fixture(scope="module")
def jx():
    """The JAX package's select_pages and page_scores_physical."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from quest_tpu.ops.estimate import page_scores_physical as jphys
    from quest_tpu.ops.topk import select_pages as jselect
    return jnp, jphys, jselect


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# Selection rows: (scores [B, H, P] f32, seq_lens [B] int32, page, K).

def tie_rows():
    """All-equal scores, a tie band across the boundary, negative ties
    and zeros, a single-page row (one row each, H = 1, page 16)."""
    s2 = np.zeros(256, np.float32)
    s2[:10], s2[10:200] = 7.0, 3.25
    s3 = np.concatenate([np.full(128, -2.5, np.float32),
                         np.zeros(128, np.float32)])
    return [(np.full(256, 1.5, np.float32), 40, 256 * 16),
            (s2, 64, 256 * 16), (s3, 130, 256 * 16 - 3),
            (np.linspace(0, 1, 128, dtype=np.float32), 8, 5)]


def select_rows(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":            # B=2, 8 KV heads, a long and a short row
        s = rng.standard_normal((2, 8, 64)).astype(np.float32)
        return [(s, np.array([1000, 313]), 16, 16)]
    if kind == "page32":
        s = rng.standard_normal((3, 8, 48)).astype(np.float32)
        return [(s, np.array([1536, 700, 33]), 32, 12)]
    if kind == "per_q_head":        # B x Hq rows of one length each
        s = rng.standard_normal((2, 32, 64)).astype(np.float32)
        return [(s, np.array([1024, 250]), 16, 16)]
    if kind == "ties":              # few distinct values, no -0.0
        s = rng.integers(-3, 4, size=(2, 4, 96)).astype(np.float32)
        return [(s, np.array([1536, 900]), 16, 20)]
    if kind == "rows_0_1":          # idle slot, one token, one and two pages
        s = rng.standard_normal((4, 8, 32)).astype(np.float32)
        return [(s, np.array([0, 1, 16, 17]), 16, 8)]
    if kind == "k_above_p":         # the budget above the pool's pages
        s = rng.standard_normal((2, 2, 20)).astype(np.float32)
        return [(s, np.array([300, 130]), 16, 24)]
    if kind == "tie_rows":
        return [(s[None, None], np.array([sl]), 16, k)
                for s, k, sl in tie_rows()]
    raise ValueError(kind)


SELECT_KINDS = ["random", "page32", "per_q_head", "ties", "rows_0_1",
                "k_above_p", "tie_rows"]


def main_path_select(fn, scores, seq, page, K):
    """fn (the select kernel's wrapper or plain version) as
    ``select_pages`` calls it on the card: junk id P - 1, lengths in
    tokens, one length a batch row. Returns ([B, H, K], [B])."""
    B, H, P = scores.shape
    ids, nv = fn(scores.reshape(B * H, P), seq, K, junk=P - 1,
                 page_size=page, rows_per_len=H)
    return ids.reshape(B, H, K), nv


@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_select_plain_with_junk_equals_select_pages_and_jax(jx, kind):
    jnp, _, jselect = jx
    for s, seq, page, K in select_rows(kind):
        seq = seq.astype(np.int32)
        wi, wn = jselect(jnp.asarray(s), jnp.asarray(seq), page, K)
        ts, tseq = torch.from_numpy(s), torch.from_numpy(seq)
        pi, pn = select_pages(ts, tseq, page, K)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(wn))
        for fn in (exact_topk_select_plain, exact_topk_select):
            gi, gn = main_path_select(fn, ts, tseq, page, K)
            assert gi.dtype == torch.int32 and gn.dtype == torch.int32
            assert torch.equal(gi, pi) and torch.equal(gn, pn), (kind, fn)


def test_select_plain_keeps_the_fused_probe_contract():
    """Page counts (page_size 1), one a row, junk 0: the fused kernel's
    probe as it was."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    n = torch.tensor([0, 5, 64, 40])
    ids, nv = exact_topk_select_plain(s, n, 8)
    assert nv.tolist() == [0, 5, 8, 8]
    assert ids[0].tolist() == [0] * 8
    assert ids[1].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    ids, nv = exact_topk_select_plain(s, n, 8, junk=63)
    assert ids[1].tolist() == [0, 1, 2, 3, 4, 63, 63, 63]


@pytest.mark.parametrize("rows_per_len,shape", [(3, (2,)), (2, (4,)),
                                                 (4, (2,))])
def test_select_refuses_lengths_that_do_not_cover_the_rows(rows_per_len,
                                                           shape):
    """8 rows at rows_per_len 3 do not split; at 2 they need 4 lengths,
    at 4 they need 2 (the last is accepted)."""
    s = torch.zeros((8, 16))
    lens = torch.ones(shape, dtype=torch.int32)
    if rows_per_len == 4:
        ids, nv = exact_topk_select(s, lens, 4, rows_per_len=4)
        assert ids.shape == (8, 4) and nv.shape == (2,)
        return
    with pytest.raises(ValueError, match="num_pages"):
        exact_topk_select(s, lens if rows_per_len == 3 else lens[:2], 4,
                          rows_per_len=rows_per_len)


# --------------------------------------------------------------------------
# The estimate over the physical pool.

def fp8_codes(rng, shape):
    """Random fp8 e4m3 codes, no NaN (0x7f, 0xff), every denormal code
    (1-7, 129-135) among them."""
    codes = rng.integers(0, 256, size=shape).astype(np.uint8)
    codes[codes & 0x7F == 0x7F] = 0x38
    flat = codes.reshape(-1)
    flat[:14] = list(range(1, 8)) + list(range(129, 136))
    return codes


def physical_operands(seed, meta, page, B=3, Hkv=2, G=4, NPB=8):
    """q [B, Hq, D] f32 and one layer's metadata [Hkv, NPB, bpp, D] as
    numpy arrays of the metadata dtype's values (fp8: uint8 codes), and a
    block table: row 1 shares row 0's first block, row 2 is an idle slot
    on scratch block 0, and every row's last entry is block 0 too."""
    rng = np.random.default_rng(seed)
    bpp = 64 // page                    # 64 tokens a block
    NB = 3
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    shape = (Hkv, NPB, bpp, D)
    if meta == "fp8":
        kmax, kmin = fp8_codes(rng, shape), fp8_codes(rng, shape)
    else:
        kmax = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        kmin = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
    tab = np.zeros((B, NB), np.int32)
    tab[0, :2] = [3, 5]
    tab[1, :2] = [3, 6]
    return q, kmax, kmin, tab


def as_torch_meta(a, meta):
    t = torch.from_numpy(a)
    return t.view(FP8) if meta == "fp8" else t.to(torch.bfloat16)


def as_jax_meta(jnp, a, meta):
    import ml_dtypes
    if meta == "fp8":
        return jnp.asarray(a.view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(a).astype(jnp.bfloat16)


ESTIMATE_CASES = [(page, meta, mode) for page in (16, 32)
                  for meta in ("bf16", "fp8")
                  for mode in ("max", "sum", "per_q_head")]


@pytest.mark.parametrize("page,meta,mode", ESTIMATE_CASES)
def test_physical_estimate_plain_matches_jax(jx, page, meta, mode):
    jnp, jphys, _ = jx
    q, kmax, kmin, tab = physical_operands(page + len(meta), meta, page)
    kw = dict(group_agg="sum" if mode == "sum" else "max",
              per_q_head=mode == "per_q_head")
    want = np.asarray(jphys(jnp.asarray(q), as_jax_meta(jnp, kmax, meta),
                            as_jax_meta(jnp, kmin, meta), jnp.asarray(tab),
                            **kw))
    got = page_scores_physical(torch.from_numpy(q), as_torch_meta(kmax, meta),
                               as_torch_meta(kmin, meta),
                               torch.from_numpy(tab), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_fp8_metadata_keeps_denormals():
    """Each fp8 code, denormals included, reads as PyTorch's cast reads
    it: page p holds code p in dim 0 of k_max, a query of ones on dim 0
    gives code p's value (upcast_fp8 would flush codes 1-7 to zero)."""
    codes = np.arange(256, dtype=np.uint8)
    codes[[0x7F, 0xFF]] = 0                       # NaN codes: see the card
    kx = np.zeros((1, 4, 64, D), np.uint8)
    kx.reshape(256, D)[:, 0] = codes
    kn = np.zeros_like(kx)
    q = np.zeros((1, 1, D), np.float32)
    q[0, 0, 0] = 1.0
    tab = np.array([[0, 1, 2, 3]], np.int32)
    got = page_scores_physical(torch.from_numpy(q), as_torch_meta(kx, "fp8"),
                               as_torch_meta(kn, "fp8"),
                               torch.from_numpy(tab))
    want = torch.from_numpy(codes).view(FP8).float()
    assert torch.equal(got[0, 0], want)
    assert (got[0, 0, 1:8] > 0).all()             # the denormals


@pytest.mark.parametrize("page,meta", [(16, "bf16"), (32, "fp8")])
def test_physical_selection_selects_what_jax_selects(jx, page, meta):
    """The estimate and the select of the main path, plain, against
    JAX's page_scores_physical + select_pages: no id flipped outside
    1e-5 of the K-th score."""
    jnp, jphys, jselect = jx
    q, kmax, kmin, tab = physical_operands(7, meta, page)
    seq = np.array([128 - 5, 64 + 7, 0], np.int32)   # the tables' blocks
    K = 3
    js = jphys(jnp.asarray(q), as_jax_meta(jnp, kmax, meta),
               as_jax_meta(jnp, kmin, meta), jnp.asarray(tab))
    wi, wn = jselect(js, jnp.asarray(seq), page, K)
    ts = page_scores_physical(torch.from_numpy(q), as_torch_meta(kmax, meta),
                              as_torch_meta(kmin, meta), torch.from_numpy(tab))
    gi, gn = main_path_select(exact_topk_select_plain, ts,
                              torch.from_numpy(seq), page, K)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    B, H, P = ts.shape
    n = torch.from_numpy((seq + page - 1) // page).repeat_interleave(H)
    flips, gap = selection_flips(gi.reshape(B * H, K),
                                 torch.from_numpy(np.asarray(wi)).reshape(
                                     B * H, K),
                                 torch.from_numpy(np.asarray(js)).reshape(
                                     B * H, P), n)
    assert flips == 0 or gap <= 1e-5, (flips, gap)
    # Junk slots hold P - 1, as JAX's.
    nv = gn.long()[:, None, None]
    slot = torch.arange(K)[None, None, :]
    assert (gi[slot.expand_as(gi) >= nv] == P - 1).all()


def test_selection_wrappers_launch_nothing_on_cpu():
    q, kmax, kmin, tab = physical_operands(1, "bf16", 16)
    before = (page_scores_physical.launches, exact_topk_select.launches)
    s = page_scores_physical(torch.from_numpy(q), as_torch_meta(kmax, "bf16"),
                             as_torch_meta(kmin, "bf16"),
                             torch.from_numpy(tab))
    select_pages(s, torch.tensor([100, 50, 0], dtype=torch.int32), 16, 4)
    assert (page_scores_physical.launches,
            exact_topk_select.launches) == before


@pytest.mark.parametrize("meta", ["bf16", "fp8"])
@pytest.mark.parametrize("page", [16, 32])
def test_bmm_yardstick_computes_the_per_query_head_scores(meta, page):
    """``chip_smoke.py``'s ``torch.bmm`` yardstick of the estimate (its
    library time) computes the physical route's function: its product is
    the per-query-head scores of the plain version, over shared and
    scratch blocks."""
    q, kmax, kmin, tab = physical_operands(page + len(meta), meta, page)
    args = (torch.from_numpy(q), as_torch_meta(kmax, meta),
            as_torch_meta(kmin, meta), torch.from_numpy(tab))
    qc, mc = chip_smoke.bmm_yardstick(*args)
    want = page_scores_physical_plain(*args, per_q_head=True)
    got = torch.bmm(qc, mc).reshape(want.shape)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_in_turns_times_each_version_in_order_then_in_reverse():
    from quest_tpu_torch.utils.benchmarking import in_turns
    seen = []
    fns = {n: (lambda n=n: n) for n in ("kernel", "plain", "library")}
    out = in_turns(lambda fn: seen.append(fn()) or float(len(seen)), fns)
    assert seen == ["kernel", "plain", "library", "library", "plain",
                    "kernel"]
    assert out == {"kernel": [1.0, 6.0], "plain": [2.0, 5.0],
                   "library": [3.0, 4.0]}


def test_ptxas_kernels_reads_registers_spills_and_static_smem():
    """``chip_smoke.py``'s reading of an ``-Xptxas -v`` log, whose lines
    for the physical route it logs."""
    name = "_ZN2qt24estimate_physical_kernelI13__nv_bfloat16EEvPKv"
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 154 registers, used 1 barriers, 256 bytes "
           "smem, 472 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function 'k2' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, 380 bytes cmem[0]\n")
    got = chip_smoke.ptxas_kernels(log)
    assert got == {name: (154, 8, 12, 256), "k2": (40, 0, 0, 0)}
    assert chip_smoke.registers_of(got, "estimate_physical_kernelI13") == (
        "154 registers, 256 bytes static shared memory, 8/12 bytes "
        "spilled (stores/loads)")


def test_estimate_stages_script_runs_its_plain_version(capsys):
    """``exp/estimate_stages.py --cpu``: the script's pool of scratch and
    shared blocks through the plain version."""
    from quest_tpu_torch.exp import estimate_stages
    assert estimate_stages.main(["--cpu"]) == 0
    assert "scores (2, 8, 128), finite True" in capsys.readouterr().out


# --------------------------------------------------------------------------
# On the card: the kernels against the plain versions.

def card_rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


# The physical route's launch plan, as csrc/estimate.cu's launcher works
# it out on the card.

def plan_units(plan, bpp, NB):
    """(first page, pages) of each unit of a (row, KV head), in the order
    csrc/estimate.cu:phys_unit numbers them."""
    sp, P = plan["stage_pages"], NB * bpp
    if plan["bulk"]:
        return [(n * bpp + k, min(sp, bpp - k)) for n in range(NB)
                for k in range(0, bpp, sp)]
    return [(p0, min(sp, P - p0)) for p0 in range(0, P, sp)]


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.float32, torch.bfloat16, FP8])
@pytest.mark.parametrize("bpp", [1, 2, 4, 16, 32, 48, 64, 100, 128])
@pytest.mark.parametrize("G", [1, 4, 128])
def test_physical_plan_covers_every_page_within_the_kernel_limits(
        cuda, meta, bpp, G):
    NB, B, Hkv = 7, 3, 8
    kmax = torch.empty((Hkv, 1, bpp, D), dtype=meta, device=cuda)
    plan = physical_plan(kmax, B, NB, G)
    row = D * kmax.element_size()
    assert plan["bulk"] == (bpp * row >= 2048)
    stage = 2 * plan["stage_pages"] * row
    assert 1 <= plan["stage_pages"] <= (128 if plan["bulk"] else 64)
    assert stage <= 32 << 10 and 2 <= plan["stages"] <= 16
    assert plan["smem_bytes"] == plan["stages"] * stage + G * D * 4
    assert plan["ctas_per_sm"] in (1, 2)
    units = plan_units(plan, bpp, NB)
    assert plan["units"] == B * Hkv * len(units)
    assert 1 <= plan["grid"] == min(plan["units"],
                                    plan["ctas_per_sm"] * sm_count(cuda))
    # Every page of a row once, in order; a bulk unit inside one block,
    # a 16-byte-path unit over at most 64 table entries.
    assert [p for p0, n in units for p in range(p0, p0 + n)] == list(
        range(NB * bpp))
    for p0, n in units:
        first, last = p0 // bpp, (p0 + n - 1) // bpp
        assert first == last if plan["bulk"] else last - first < 64


@pytest.mark.cuda
@pytest.mark.parametrize("meta,page,tokens,B,G,want", [
    (torch.bfloat16, 16, 32768, 1, 4, (1, 64, 3, 256, 2)),  # 32K
    (torch.bfloat16, 16, 131072, 1, 4, (1, 64, 3, 1024, 2)),
    (torch.bfloat16, 16, 16384, 2, 4, (1, 64, 3, 256, 2)),  # serving
    (FP8, 32, 32768, 1, 4, (1, 64, 6, 128, 2)),             # fp8, page 32
    (torch.float32, 16, 32768, 1, 128, (1, 32, 3, 512, 1)),
])
def test_physical_plan_of_the_main_path(cuda, meta, page, tokens, B, G,
                                        want):
    """Llama-3.1-8B (8 KV heads, G = 4), 64-page blocks: one unit a block
    (two bulk copies of 16 KB, 8 KB in fp8), a 96 KB ring, two CTAs an
    SM. 128 query rows of f32 q (64 KB) beside an f32 ring leave room for
    one."""
    kmax = torch.empty((8, 1, 64, D), dtype=meta, device=cuda)
    plan = physical_plan(kmax, B, tokens // page // 64, G)
    assert (plan["bulk"], plan["stage_pages"], plan["stages"],
            plan["units"], plan["ctas_per_sm"]) == want
    assert plan["grid"] == min(plan["units"], want[-1] * sm_count(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.float32, torch.bfloat16, FP8])
@pytest.mark.parametrize("bpp", [1, 2, 4, 32, 48, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 16, 32, 128])
@pytest.mark.parametrize("mode", ["max", "sum", "per_q_head"])
def test_physical_estimate_kernel_matches_plain(cuda, meta, bpp, G, mode):
    gen = torch.Generator(device=cuda).manual_seed(G * 100 + bpp)
    B, Hkv, NPB, NB = 3, 4, 12, 5
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda)
    shape = (Hkv, NPB, bpp, D)
    kmax = torch.randn(shape, generator=gen, device=cuda).to(meta)
    kmin = torch.randn(shape, generator=gen, device=cuda).to(meta)
    tab = torch.randint(1, NPB, (B, NB), generator=gen, device=cuda,
                        dtype=torch.int32)
    tab[1, 0] = tab[0, 0]                              # a shared block
    tab[2] = 0                                         # an idle slot
    kw = dict(group_agg="sum" if mode == "sum" else "max",
              per_q_head=mode == "per_q_head")
    for qd in (torch.bfloat16, torch.float32):
        got = page_scores_physical(q.to(qd), kmax, kmin, tab, **kw)
        want = page_scores_physical_plain(q.to(qd), kmax, kmin, tab, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert card_rel_err(got, want) <= 1e-5, (qd, card_rel_err(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.float32, torch.bfloat16, FP8])
@pytest.mark.parametrize("bpp,NB", [(64, 129), (2, 1000)])
@pytest.mark.parametrize("G", [3, 4, 8])
@pytest.mark.parametrize("mode", ["max", "sum", "per_q_head"])
def test_physical_estimate_kernel_long_rows(cuda, meta, bpp, NB, G, mode):
    """B=4, 8 KV heads, rows of more than 8192 pages at bpp 64 (more
    units than CTAs: ranges that cross (row, head) boundaries, the ring
    wrapping, whole blocks a unit), and of 2000 pages at bpp 2 (the
    16-byte path): rows 0 and 1 share their first three blocks, row 2
    points at one of row 0's blocks, row 3 is an idle slot on scratch
    block 0. Every page matches the plain version, and a second launch
    is bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(bpp + NB + G)
    B, Hkv = 4, 8
    NPB = B * NB + 1
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda)
    shape = (Hkv, NPB, bpp, D)
    kmax = torch.randn(shape, generator=gen, device=cuda).to(meta)
    kmin = torch.randn(shape, generator=gen, device=cuda).to(meta)
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(2))
    tab = (1 + perm[:B * NB]).reshape(B, NB).to(torch.int32).to(cuda)
    tab[1, :3] = tab[0, :3]
    tab[2, NB // 2] = tab[0, NB // 3]
    tab[3] = 0
    kw = dict(group_agg="sum" if mode == "sum" else "max",
              per_q_head=mode == "per_q_head")
    qb = q.to(torch.bfloat16)
    got = page_scores_physical(qb, kmax, kmin, tab, **kw)
    again = page_scores_physical(qb, kmax, kmin, tab, **kw)
    want = page_scores_physical_plain(qb, kmax, kmin, tab, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, Hkv * (G if kw["per_q_head"]
                                                 else 1), NB * bpp)
    assert torch.equal(got, again)
    assert card_rel_err(got, want) <= 1e-5, card_rel_err(got, want)


@pytest.mark.cuda
def test_physical_estimate_reads_every_fp8_code(cuda):
    codes = torch.arange(256, dtype=torch.uint8, device=cuda)
    kx = torch.zeros((1, 4, 64, D), dtype=torch.uint8, device=cuda)
    kn = torch.zeros_like(kx)
    kx.view(256, D)[:, 0] = codes
    kn.view(256, D)[:, 5] = codes
    kx, kn = kx.view(FP8), kn.view(FP8)
    q = torch.zeros((1, 2, D), device=cuda)
    q[0, 0, 0], q[0, 1, 5] = 1.0, -1.0
    tab = torch.tensor([[3, 1, 0, 2]], dtype=torch.int32, device=cuda)
    got = page_scores_physical(q, kx, kn, tab, per_q_head=True)
    want = page_scores_physical_plain(q, kx, kn, tab, per_q_head=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    vals = codes.view(FP8).float().reshape(4, 64)[tab[0].long()].reshape(-1)
    torch.testing.assert_close(got[0, 0], vals, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SELECT_KINDS + ["long"])
def test_main_path_select_kernel_bitwise(cuda, kind):
    if kind == "long":              # the main path's row: 2048 pages
        rng = np.random.default_rng(11)
        rows = [(rng.standard_normal((2, 8, 2048)).astype(np.float32),
                 np.array([32768, 7001]), 16, 128)]
    else:
        rows = select_rows(kind)
    for s, seq, page, K in rows:
        ts = torch.from_numpy(s).to(cuda)
        tseq = torch.from_numpy(seq.astype(np.int32)).to(cuda)
        launches = exact_topk_select.launches
        gi, gn = select_pages(ts, tseq, page, K)
        wi, wn = select_pages_plain(ts, tseq, page, K)
        torch.cuda.synchronize()
        assert exact_topk_select.launches == launches + 1
        assert torch.equal(gi, wi) and torch.equal(gn, wn), kind


@pytest.mark.cuda
def test_decode_step_selects_on_the_kernels(cuda):
    """A sparse decode step of a 2-layer model launches the estimate's
    physical route and the select once a sparse layer, and its logits
    equal the step's with the plain selection (the same ids)."""
    import dataclasses

    import quest_tpu_torch.models.llama as llama
    from quest_tpu_torch.config import QuestConfig, small_tpu_model
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.engine.graphs import eager
    from quest_tpu_torch.models.llama import init_params
    cfg = dataclasses.replace(small_tpu_model(), num_layers=3, num_heads=8,
                              num_kv_heads=2, dtype=torch.float32)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=1024,
                        kv_dtype=torch.float32, skip_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (300, 170)]
    logits = {}
    for plain in (False, True):
        eng = QuestEngine(cfg, quest, params, batch_size=2, device="cuda")
        tok = np.argmax(eng.prefill(prompts), axis=-1)
        with eager(), pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(llama, "page_scores_physical",
                           page_scores_physical_plain)
                mp.setattr(llama, "select_pages", select_pages_plain)
            before = (page_scores_physical.launches,
                      exact_topk_select.launches)
            logits[plain] = eng.decode(tok)
            torch.cuda.synchronize()
            got = (page_scores_physical.launches - before[0],
                   exact_topk_select.launches - before[1])
        assert got == ((0, 0) if plain else (2, 2)), got
    np.testing.assert_allclose(logits[False], logits[True], rtol=0,
                               atol=1e-4 * np.abs(logits[True]).max())
