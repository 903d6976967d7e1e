"""The port's serving path against the JAX package, in f32 on the CPU: the
continuous-batching scheduler (step for step: tick kinds, block tables,
lengths, pool free counts, tokens, prefix hits), the host page pool
(over one random op sequence), the model's burst, NLL and sampling
steps, the engine's eval bursts, and the per-slot append oracles (and
the serving path's appends against them). The card cases (``cuda`` marker) hold the scheduler on the card
to the CPU path and need no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_serving.py``.

The JAX model is ``tests/test_continuous_batching.py``'s: vocab 256,
hidden 64, 2 layers, 4 heads of 16, page 8, a 32-token budget,
``max_seq_len`` 256, ``skip_layers=1``, here with 4-page (32-token)
allocation blocks so that prompts span several blocks.
"""

import copy
import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
from quest_tpu_torch.engine import (ContinuousBatchingEngine, QuestEngine,
                                    Request)
from quest_tpu_torch.kv import paged_kv as tkv
from quest_tpu_torch.kv.pool import PagePool
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import (QuestModel, init_params,
                                          sample_tokens)
from quest_tpu_torch.utils.trace import RECORDER

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card phase's request set)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16)
QUEST = dict(page_size=8, token_budget=32, max_seq_len=256, skip_layers=1,
             block_pages=4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side: its configs, numpy parameters, and the
    port's configs and parameters made from the same numpy arrays."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu import config as jconfig
    from quest_tpu import engine as jengine
    from quest_tpu.kv import paged_kv as jkv
    from quest_tpu.kv import pool as jpool
    from quest_tpu.models.llama import init_params
    jcfg = jconfig.ModelConfig(rope=jconfig.RopeConfig(), dtype=jnp.float32,
                               **MODEL)
    jquest = jconfig.QuestConfig(kv_dtype=jnp.float32, **QUEST)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(1),
                                                  dtype=jnp.float32))
    cfg = ModelConfig(rope=RopeConfig(), dtype=torch.float32, **MODEL)
    quest = QuestConfig(kv_dtype=torch.float32, **QUEST)
    return types.SimpleNamespace(
        jnp=jnp, jconfig=jconfig, jengine=jengine, jkv=jkv, jpool=jpool,
        jcfg=jcfg, jquest=jquest, params=params, cfg=cfg, quest=quest,
        tparams=params_from_numpy(params, device="cpu"))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in lens]


# -- the scheduler -----------------------------------------------------------

# Settings: the card phase's (3 slots, bursts of 4, chunks of one block,
# 6 usable blocks: chunked prefill, an admission waiting for blocks, a
# prefix hit), and whole-prompt prefill on 2 slots with a full
# reservation and no prefix cache.
SCHEDULER_SETTINGS = {
    "chunked_prefix": None,
    "whole_prompt": dict(max_batch=2, burst=16, prefill_chunk=None,
                         prefill_bucket=16, prefix_cache_entries=0),
}


@pytest.mark.parametrize("setting", sorted(SCHEDULER_SETTINGS))
def test_scheduler_matches_jax_step_for_step(jx, setting):
    kw = SCHEDULER_SETTINGS[setting] or chip_smoke.scheduler_kwargs(jx.quest)
    bt = jx.quest.block_pages * jx.quest.page_size
    port = lambda: ContinuousBatchingEngine(jx.cfg, jx.quest, jx.tparams,
                                            device="cpu", **kw)
    # The EOS token: the third token uid 2 generates without one.
    eos = port().run(chip_smoke.scheduler_requests(256, bt))[2][2]
    reqs = chip_smoke.scheduler_requests(256, bt, eos_token_id=eos)
    t = port()
    j = jx.jengine.ContinuousBatchingEngine(jx.jcfg, jx.jquest, jx.params,
                                            **kw)
    for r in reqs:
        t.submit(copy.deepcopy(r))
        j.submit(jx.jengine.Request(**dataclasses.asdict(r)))
    tg = {r.uid: [] for r in reqs}
    jg = {r.uid: [] for r in reqs}
    ticks = []
    while j.has_work():
        for ev in j.step():
            jg[ev.uid].append(ev.token)
        for ev in t.step():
            tg[ev.uid].append(ev.token)
        ticks.append(j.last_tick)
        assert t.last_tick == j.last_tick, len(ticks)
        np.testing.assert_array_equal(t.cache.block_tab.numpy(),
                                      np.asarray(j.cache.block_tab))
        np.testing.assert_array_equal(t.cache.seq_lens.numpy(),
                                      np.asarray(j.cache.seq_lens))
        assert [t.pools[0].free_pages()] == [p.free_pages() for p in j.pools]
    assert not t.has_work()
    assert "decode" in ticks and ticks.count("prefill") >= 3
    assert (t.prefix_hits, t.prefix_hit_tokens) == (j.prefix_hits,
                                                    j.prefix_hit_tokens)
    if setting == "chunked_prefix":
        assert t.prefix_hits == 1 and t.prefix_hit_tokens == 2 * bt
    for r in reqs:
        if r.temperature > 0:      # JAX's key vs a torch.Generator
            assert tg[r.uid][0] == jg[r.uid][0]
            assert len(tg[r.uid]) == len(jg[r.uid]) == r.max_new_tokens
            assert all(0 <= x < 256 for x in tg[r.uid])
        else:
            assert tg[r.uid] == jg[r.uid], r.uid
    assert len(tg[2]) < reqs[2].max_new_tokens      # stopped at its EOS


def test_scheduler_drains_and_releases_every_block(jx):
    eng = ContinuousBatchingEngine(jx.cfg, jx.quest, jx.tparams, device="cpu",
                                   **chip_smoke.scheduler_kwargs(jx.quest))
    bt = jx.quest.block_pages * jx.quest.page_size
    out = eng.run(chip_smoke.scheduler_requests(256, bt))
    assert sorted(out) == list(range(6))
    assert eng.pools[0].total_pages == 6
    held = {b for ent in eng._prefixes[0].values() for b in ent}
    assert held and eng.pools[0].free_pages() + len(held) == 6
    assert not eng.cache.block_tab.any() and not eng.cache.seq_lens.any()
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(Request(9, [1] * 250, 10))


@pytest.mark.parametrize("eos", [False, True])
def test_kernel_tap_takes_every_batch_kind(jx, eos):
    """chip_smoke.py's tap over the scheduler phase's request set (with
    and without the EOS stop, as its f32 and bf16 runs have them), here
    on the CPU where the wrappers run their plain versions: it takes a
    call on every kind of row each kernel must be held on, and each
    taken call equals its plain version on the copied operands."""
    kw = chip_smoke.scheduler_kwargs(jx.quest)
    bt = jx.quest.block_pages * jx.quest.page_size
    eng = ContinuousBatchingEngine(jx.cfg, jx.quest, jx.tparams, device="cpu",
                                   **kw)
    stop = None
    if eos:
        stop = eng.run(chip_smoke.scheduler_requests(256, bt))[2][2]
        eng = ContinuousBatchingEngine(jx.cfg, jx.quest, jx.tparams,
                                       device="cpu", **kw)
    with chip_smoke.KernelTap(chip_smoke.scheduler_tap_rule(eng),
                              device="cpu") as tap:
        eng.run(chip_smoke.scheduler_requests(256, bt, eos_token_id=stop))
    cases = chip_smoke.check_taps(tap, "cpu", chip_smoke.tap_needs(jx.quest))
    assert sorted(cases) == ["dense_decode", "prefill", "sparse_decode"]
    assert all(c["max_rel_err"] == 0 for cs in cases.values() for c in cs)
    # A prefill call holds the prefilling rows alone, two or more at once.
    assert all(set(c["rows"].split(", ")) <= set(chip_smoke.PREFILL_KINDS)
               for c in cases["prefill"])
    assert any(c["case"] != "scheduler cpu: B=1" for c in cases["prefill"])


# -- prefill ticks over the prefilling rows ------------------------------------

def _rows_engine(seed=7):
    """4 slots, whole-prompt prefill in 16-token buckets, bursts of 4, the
    port's own random f32 weights (no JAX)."""
    cfg = ModelConfig(rope=RopeConfig(), dtype=torch.float32, **MODEL)
    quest = QuestConfig(kv_dtype=torch.float32, **QUEST)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    return ContinuousBatchingEngine(cfg, quest, params, max_batch=4,
                                    prefill_bucket=16, burst=4, device="cpu")


def _tap_prefill(eng):
    """Wrap ``eng.model.prefill_last`` as the benchmark's harness does; each
    call appends (the cache it got, tokens, lengths, logits, a copy of the
    engine's whole cache as the call found it)."""
    calls, last = [], eng.model.prefill_last

    def prefill_last(cache, toks, new_lens=None):
        found = _snapshot(eng.cache)
        out = last(cache, toks, new_lens)
        calls.append((cache, toks.clone(), new_lens.clone(), out.clone(),
                      found))
        return out
    eng.model.prefill_last = prefill_last
    return calls


def _snapshot(cache):
    return tkv.PagedKVCache(*(t.clone() for t in dataclasses.astuple(cache)))


# (first requests: prompt lengths and new tokens; later prompt lengths).
LATE_PREFILL = {
    # Slots 0 and 1 decoding, a third request admitted into slot 2 while
    # slot 3 stays empty.
    "one_row": ([(70, 40), (90, 40)], [37]),
    # Slots 0 and 2 decoding; slot 1's short request finished, and two
    # requests are admitted into slots 1 and 3 (rows 0 and 1 of the call).
    "two_rows": ([(70, 40), (20, 2), (90, 40)], [37, 45]),
}


@pytest.fixture(scope="module", params=sorted(LATE_PREFILL))
def late_prefill(request):
    """The prefill tick that writes only the prompts of requests admitted
    while other slots decode at context, with the cache as its call found
    it and the tick's calls and events."""
    first, later = LATE_PREFILL[request.param]
    eng = _rows_engine()
    calls = _tap_prefill(eng)
    for uid, (p, (_, new)) in enumerate(zip(
            _prompts(11, [n for n, _ in first]), first)):
        eng.submit(Request(uid, p, new))
    decoding = [b for b, (_, new) in enumerate(first) if new > 2]
    while eng.last_tick != "decode" or any(
            eng.slots[b] is None or eng.slots[b].prefilling
            for b in decoding) or eng.num_active > len(decoding):
        eng.step()
    for uid, p in enumerate(_prompts(12, later), start=len(first)):
        eng.submit(Request(uid, p, 5))
    before, n_calls = _snapshot(eng.cache), len(calls)
    seq_lens = eng.cache.seq_lens
    events = eng.step()
    assert eng.last_tick == "prefill" and len(calls) == n_calls + 1
    pf = [b for b in range(4) if b not in decoding][:len(later)]
    return types.SimpleNamespace(
        eng=eng, before=before, call=calls[-1], calls=calls, events=events,
        later=later, pf=pf, first=first, seq_lens=seq_lens,
        uids=range(len(first), len(first) + len(later)))


def _blocks(tab_row):
    return sorted({int(x) for x in tab_row if int(x) != 0})


def test_prefill_tick_leaves_ride_along_rows_untouched(late_prefill):
    """The tick computes the prefilling rows alone: ``prefill_last`` gets
    a batch of their number, and every other slot's table row, length,
    pool pages and min/max metadata are bit for bit what they were; the
    new rows' lengths are written back into the cache's own tensor."""
    eng, before, pf = late_prefill.eng, late_prefill.before, late_prefill.pf
    cache, toks, new_lens, _, _ = late_prefill.call
    assert cache is not eng.cache and cache.batch_size == len(pf)
    assert toks.shape == (len(pf), 48)
    assert new_lens.tolist() == late_prefill.later
    assert eng.cache.seq_lens is late_prefill.seq_lens
    after, bpp = eng.cache, eng.cache.block_pages
    others = [b for b in range(4) if b not in pf]
    for b in others:
        assert torch.equal(after.block_tab[b], before.block_tab[b])
        assert after.seq_lens[b] == before.seq_lens[b]
    for b, n in zip(pf, late_prefill.later):
        assert after.seq_lens[b] == n
    written = {blk for b in pf for blk in _blocks(after.block_tab[b])}
    kept = [blk for blk in range(1, after.k_max.shape[2])   # not scratch
            if blk not in written]
    held = [blk for b in others for blk in _blocks(before.block_tab[b])]
    assert held and set(held) <= set(kept)
    pages = torch.tensor([blk * bpp + i for blk in kept for i in range(bpp)])
    assert torch.equal(after.kv_pages[:, :, pages],
                       before.kv_pages[:, :, pages])
    for name in ("k_max", "k_min"):
        assert torch.equal(getattr(after, name)[:, :, kept],
                           getattr(before, name)[:, :, kept])


def test_prefill_tick_rows_equal_the_full_batch(late_prefill):
    """The tick's logits for each of its rows equal a ``prefill_last`` over
    all 4 slots of a copy of the cache as the call found it (the others
    at ``new_lens = 0``), as the tick ran before, within f32 round-off,
    and so do the rows' KV pages; each greedy first token is the one the
    tick emitted for that row's request."""
    eng, pf = late_prefill.eng, late_prefill.pf
    _, toks, new_lens, out, ref = late_prefill.call
    full_toks = torch.zeros((4, toks.shape[1]), dtype=torch.int32)
    full_lens = torch.zeros((4,), dtype=torch.int32)
    full_toks[pf], full_lens[pf] = toks, new_lens
    full = QuestModel.prefill_last(eng.model, ref, full_toks, full_lens)
    scale = float(full.abs().max())
    torch.testing.assert_close(out, full[pf], rtol=1e-5, atol=1e-5 * scale)
    assert out.argmax(-1).tolist() == full[pf].argmax(-1).tolist()
    assert sorted((e.uid, e.token) for e in late_prefill.events) == [
        (uid, int(full[b, 0].argmax()))
        for uid, b in zip(late_prefill.uids, pf)]
    assert torch.equal(eng.cache.seq_lens, ref.seq_lens)
    pages = torch.tensor([blk * eng.cache.block_pages + i for b in pf
                          for blk in _blocks(ref.block_tab[b])
                          for i in range(eng.cache.block_pages)])
    torch.testing.assert_close(eng.cache.kv_pages[:, :, pages],
                               ref.kv_pages[:, :, pages], rtol=1e-5,
                               atol=1e-5)


def test_prefill_tick_records_its_rows_and_computed_tokens(late_prefill):
    """Each prefill tick span's ``rows`` is the batch ``prefill_last``
    computed, ``padded_tokens`` rows x the padded width, and
    ``prompt_tokens`` the real tokens."""
    eng, calls = late_prefill.eng, late_prefill.calls
    ticks = [s for s in RECORDER.spans("tick") if s.engine == eng._trace_id
             and s.attrs["kind"] == "prefill"]
    assert len(ticks) == len(calls) == 2
    for t, (_, toks, new_lens, _, _) in zip(ticks, calls):
        assert t.attrs["rows"] == toks.shape[0]
        assert t.attrs["padded_tokens"] == toks.shape[0] * toks.shape[1]
        assert t.attrs["prompt_tokens"] == int(new_lens.sum())
    assert [t.attrs["rows"] for t in ticks] == [len(late_prefill.first),
                                                len(late_prefill.pf)]
    assert ticks[-1].attrs["padded_tokens"] == len(late_prefill.pf) * 48


def test_prefill_tick_of_every_slot_computes_every_row():
    """When every slot prefills, the call is the whole batch, every slot's
    table row in slot order, and the lengths land in the cache's own
    tensor."""
    eng = _rows_engine()
    calls = _tap_prefill(eng)
    lens_t = eng.cache.seq_lens
    for uid, p in enumerate(_prompts(13, (20, 33, 5, 17))):
        eng.submit(Request(uid, p, 3))
    eng.step()
    assert eng.last_tick == "prefill" and len(calls) == 1
    cache, toks, new_lens, _, _ = calls[0]
    assert cache.batch_size == 4 and toks.shape == (4, 48)
    assert torch.equal(cache.block_tab, eng.cache.block_tab)
    assert new_lens.tolist() == [20, 33, 5, 17]
    assert eng.cache.seq_lens is lens_t
    assert eng.cache.seq_lens.tolist() == [20, 33, 5, 17]


@pytest.mark.parametrize("pf,groups", [
    ([0, 1, 4], [[0, 1], [4, 6]]),
    ([0, 1, 2, 4], [[0, 1, 2], [4, 6, 7]]),
    ([5], [[2], [5]]),
])
def test_prefill_groups_pad_with_the_shortest_slots(pf, groups):
    """Under dp every group computes the largest group's count of rows; a
    group with fewer prefilling slots pads with its other slots, empty or
    shortest cached first (a padded row still reads its whole context),
    each group's rows in slot order."""
    stub = types.SimpleNamespace(
        dp=2, _slots_per_group=4, _group=lambda b: b // 4,
        _hlens=np.array([60, 900, 30, 500, 0, 900, 0, 40]))
    assert ContinuousBatchingEngine._prefill_groups(stub, pf) == groups


# -- the host page pool ----------------------------------------------------------

def _pool_ops(seed, n=400):
    """A seeded random op sequence: (name, args), sequences named by the
    order they were created in."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        k = rng.integers(0, 7)
        if k == 0:
            ops.append(("seq_create", ()))
        elif k == 1:
            ops.append(("seq_extend", (int(rng.integers(0, 8)),
                                       int(rng.integers(0, 100)))))
        elif k == 2:
            ops.append(("seq_release", (int(rng.integers(0, 8)),)))
        elif k in (3, 4):
            pages = rng.integers(0, 24, size=rng.integers(1, 4)).tolist()
            ops.append(("pages_retain" if k == 3 else "pages_release",
                        (pages,)))
        else:
            ops.append(("fill_batch_tables",
                        (rng.integers(0, 8, size=rng.integers(1, 4)).tolist(),
                         int(rng.integers(1, 10)))))
    return ops


def _apply(pool, ops):
    """Run ``ops`` on ``pool``; a sequence index names the live sequence
    of that rank (ops on none are skipped, as the three pools raise
    differently for an unknown id). Returns every outcome."""
    live, log = [], []
    for name, args in ops:
        try:
            if name == "seq_create":
                sid = pool.seq_create()
                live.append(sid)
                res = sid
            elif name in ("seq_extend", "seq_release"):
                if args[0] >= len(live):
                    continue
                sid = live[args[0]]
                if name == "seq_release":
                    live.remove(sid)
                res = getattr(pool, name)(sid, *args[1:])
                if name == "seq_extend":
                    res = (res, pool.seq_len(sid), pool.seq_pages(sid))
            elif name == "fill_batch_tables":
                ids = [live[i] for i in args[0] if i < len(live)]
                if not ids:
                    continue
                tab, lens = pool.fill_batch_tables(ids, args[1], pad_page=-1)
                res = (tab.tolist(), lens.tolist())
            else:
                res = getattr(pool, name)(*args)
        except (MemoryError, RuntimeError, ValueError) as e:
            res = type(e).__name__
        log.append((name, res, pool.free_pages()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_jax(jx, seed):
    ops = _pool_ops(seed)
    got = _apply(PagePool(24, 8, max_seqs=5), ops)
    assert got == _apply(jx.jpool.PagePool(24, 8, max_seqs=5), ops)
    kinds = {r for _, r, _ in got if isinstance(r, str)}
    assert {"MemoryError", "RuntimeError", "ValueError"} <= kinds


def test_page_pool_refuses_unknown_ids_and_pages():
    """An unknown sequence, an unowned page and a short pool raise and
    change nothing."""
    p = PagePool(4, 2, max_seqs=1)
    with pytest.raises(KeyError):
        p.seq_release(0)
    with pytest.raises(ValueError):
        p.pages_retain([7])
    sid = p.seq_create()
    assert p.seq_extend(sid, 5) == 3 and p.seq_pages(sid) == [0, 1, 2]
    with pytest.raises(ValueError):
        p.pages_release([1, 3])            # page 3 is free
    with pytest.raises(MemoryError):
        p.seq_extend(sid, 4)
    assert p.free_pages() == 1 and p.seq_len(sid) == 5
    with pytest.raises(RuntimeError):
        p.seq_create()
    p.pages_retain([0])
    p.seq_release(sid)
    assert p.free_pages() == 3
    p.pages_release([0])
    assert p.free_pages() == 4


# -- model steps ---------------------------------------------------------------

def _prefilled(jx, prompts, batch=2):
    model = QuestModel(jx.cfg, jx.quest, jx.tparams)
    cache = tkv.init_cache(jx.cfg, jx.quest, batch_size=batch, device="cpu")
    T = max(map(len, prompts))
    toks = np.zeros((batch, T), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    model.prefill_last(cache, torch.from_numpy(toks),
                       torch.tensor([len(p) for p in prompts]))
    return model, cache


@pytest.mark.parametrize("n", [1, 5])
def test_decode_token_burst_equals_steps(jx, n):
    prompts = _prompts(4, (70, 45))
    (m1, c1), (m2, c2) = _prefilled(jx, prompts), _prefilled(jx, prompts)
    active = torch.tensor([True, False])
    tok = torch.tensor([7, 9], dtype=torch.int32)
    burst = m1.decode_token_burst(c1, tok, n, active)
    steps = []
    for _ in range(n):
        tok = m2.decode_token_step(c2, tok, active)
        steps.append(tok)
    assert burst.dtype == torch.int32 and burst.shape == (2, n)
    assert torch.equal(burst, torch.stack(steps, dim=1))
    assert torch.equal(c1.kv_pages, c2.kv_pages)
    assert c1.seq_lens.tolist() == [70 + n, 45]


def test_decode_nll_step_is_logsumexp_minus_target(jx):
    prompts = _prompts(5, (60, 33))
    (m1, c1), (m2, c2) = _prefilled(jx, prompts), _prefilled(jx, prompts)
    tok, tgt = torch.tensor([3, 4]), torch.tensor([10, 200])
    nll = m1.decode_nll_step(c1, tok, tgt)
    logits = m2.decode_step(c2, tok).double()
    want = torch.logsumexp(logits, -1) - logits[[0, 1], [10, 200]]
    assert nll.dtype == torch.float32
    np.testing.assert_allclose(nll.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_sample_tokens_follows_softmax(temp):
    """Gumbel-max draws against softmax(l / t): 6000 draws, a chi-square
    bound at p = 1e-3 for 5 degrees of freedom (20.5)."""
    logits = torch.tensor([1.0, 0.5, -0.2, 2.0, 0.0, -1.0])
    N = 6000
    gen = torch.Generator().manual_seed(11)
    draws = sample_tokens(logits.expand(N, -1), torch.full((N,), temp), gen)
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=6)
    p = torch.softmax(logits.double() / temp, -1).numpy()
    chi2 = float(((counts - N * p) ** 2 / (N * p)).sum())
    assert chi2 < 20.5, (chi2, counts, N * p)
    again = sample_tokens(logits.expand(N, -1), torch.full((N,), temp),
                          torch.Generator().manual_seed(11))
    assert torch.equal(draws, again)


def test_decode_sample_step_greedy_rows_and_seed(jx):
    """Rows with temperature 0 take the argmax of the step's logits; the
    same generator seed gives the same tokens."""
    prompts = _prompts(6, (50, 41))
    temps = torch.tensor([0.0, 1.5])
    runs = []
    for _ in range(2):
        (ms, cs), (md, cd) = _prefilled(jx, prompts), _prefilled(jx, prompts)
        gen = torch.Generator().manual_seed(3)
        tok, out = torch.tensor([1, 2], dtype=torch.int32), []
        for _ in range(4):
            logits = md.decode_step(cd, tok)
            tok = ms.decode_sample_step(cs, tok, gen, temps)
            assert tok.dtype == torch.int32
            assert int(tok[0]) == int(torch.argmax(logits[0]))
            out.append(tok)
        runs.append(torch.stack(out, 1))
    assert torch.equal(runs[0], runs[1])


# -- the engine's eval bursts ------------------------------------------------------

@pytest.fixture(scope="module")
def eval_engines(jx):
    """The JAX and the port engine after the same prefill, then the eval
    bursts of both: score, then feed + greedy."""
    prompts = _prompts(8, (90, 57))
    rng = np.random.default_rng(9)
    toks = rng.integers(1, 256, size=(2, 12)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    feed = rng.integers(1, 256, size=(2, 7)).astype(np.int32)
    out = {}
    for name, make in (
            ("jax", lambda: jx.jengine.QuestEngine(
                jx.jcfg, jx.jquest, jx.params, batch_size=2,
                prefill_bucket=16)),
            ("port", lambda: QuestEngine(jx.cfg, jx.quest, jx.tparams,
                                         batch_size=2, prefill_bucket=16,
                                         device="cpu"))):
        eng = make()
        eng.prefill(prompts)
        nll = eng.score_ondevice(toks, tgts, sync_every=5)
        eng.feed_ondevice(feed, sync_every=3)
        greedy = eng.greedy_ondevice([5, 6], 6, sync_every=4)
        out[name] = dict(nll=nll, greedy=greedy,
                         lens=np.asarray(eng.seq_lens).tolist(),
                         host=eng._host_lens.tolist())
    return out


def test_score_ondevice_matches_jax(eval_engines):
    j, t = eval_engines["jax"], eval_engines["port"]
    assert t["nll"].shape == (2, 12) and t["nll"].dtype == np.float32
    np.testing.assert_allclose(t["nll"], j["nll"], rtol=1e-5, atol=1e-5)


def test_feed_then_greedy_ondevice_matches_jax(eval_engines):
    j, t = eval_engines["jax"], eval_engines["port"]
    assert t["greedy"].dtype == np.int32 and t["greedy"].shape == (2, 6)
    np.testing.assert_array_equal(t["greedy"], j["greedy"])
    assert t["lens"] == j["lens"] == [90 + 25, 57 + 25]
    assert t["host"] == j["host"] == t["lens"]


# -- per-slot append oracles -------------------------------------------------------

APPEND_DTYPES = {"f32": ("float32", torch.float32),
                 "bf16": ("bfloat16", torch.bfloat16),
                 "fp8": ("float8_e4m3fn", torch.float8_e4m3fn)}


def _layer_pair(jx, dtype, seq_lens, seed, P=6, page=8, H=2, D=16):
    """The same random per-slot layer in both packages."""
    jname, tdt = APPEND_DTYPES[dtype]
    jdt = getattr(jx.jnp, jname)
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    kv = rng.standard_normal((B, H, P, 2, page, D)).astype(np.float32) * 3
    km = rng.standard_normal((B, H, P, D)).astype(np.float32)
    jl = jx.jkv.LayerKV(jx.jnp.asarray(kv).astype(jdt),
                        jx.jnp.asarray(km + 1).astype(jdt),
                        jx.jnp.asarray(km - 1).astype(jdt),
                        jx.jnp.asarray(seq_lens, jx.jnp.int32))
    tl = tkv.LayerKV(*(torch.from_numpy(np.array(
        a.astype(jx.jnp.float32))).to(tdt) for a in (jl.kv_pages, jl.k_max,
                                                     jl.k_min)),
                     torch.tensor(seq_lens, dtype=torch.int32))
    return jl, tl, rng


def _same_layer(jl, tl):
    for a, b in ((jl.kv_pages, tl.kv_pages), (jl.k_max, tl.k_max),
                 (jl.k_min, tl.k_min)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a.astype(np.float32)))


@pytest.mark.parametrize("dtype", sorted(APPEND_DTYPES))
def test_append_decode_matches_jax_bitwise(jx, dtype):
    jl, tl, rng = _layer_pair(jx, dtype, [0, 13, 47, 16], seed=1)
    for step in range(3):
        k = rng.standard_normal((4, 2, 16)).astype(np.float32) * 4
        v = rng.standard_normal((4, 2, 16)).astype(np.float32)
        if step == 1:
            k[1, 0, 3] = np.inf                       # routed to 0
        jl = jx.jkv.append_decode(jl, jx.jnp.asarray(k), jx.jnp.asarray(v))
        tl = tkv.append_decode(tl, torch.from_numpy(k), torch.from_numpy(v))
        _same_layer(jl, tl)
        jl = dataclasses.replace(jl, seq_lens=jl.seq_lens + 1)
        tl = dataclasses.replace(tl, seq_lens=tl.seq_lens + 1)


@pytest.mark.parametrize("dtype", sorted(APPEND_DTYPES))
def test_append_prefill_matches_jax_bitwise(jx, dtype):
    # Offsets at a page start, mid-page, past the window's clamp (the
    # write start slides back so the chunk fits) and an empty row.
    seq_lens = [0, 5, 30, 44]
    jl, tl, rng = _layer_pair(jx, dtype, seq_lens, seed=2)
    for T, lens in ((11, [11, 7, 0, 3]), (16, [16, 16, 9, 1])):
        k = rng.standard_normal((4, T, 2, 16)).astype(np.float32) * 4
        v = rng.standard_normal((4, T, 2, 16)).astype(np.float32)
        k[2, 1, 1, 0] = np.nan
        jl = jx.jkv.append_prefill(jl, jx.jnp.asarray(k), jx.jnp.asarray(v),
                                   jx.jnp.asarray(lens, jx.jnp.int32))
        tl = tkv.append_prefill(tl, torch.from_numpy(k), torch.from_numpy(v),
                                torch.tensor(lens, dtype=torch.int32))
        _same_layer(jl, tl)


def _slot_cache(dtype, seq_lens, seed, NB=3, bpp=2, page=8, H=2, D=16):
    """A two-layer shared pool of random contents whose rows own
    shuffled blocks (block 0 is scratch, owned by none)."""
    tdt = APPEND_DTYPES[dtype][1]
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    NP = (1 + B * NB) * bpp
    meta = torch.from_numpy(rng.standard_normal(
        (2, H, NP // bpp, bpp, D)).astype(np.float32))
    tab = 1 + rng.permutation(B * NB).reshape(B, NB)
    cache = tkv.PagedKVCache(
        kv_pages=torch.from_numpy(rng.standard_normal(
            (2, H, NP, 2, page, D)).astype(np.float32) * 3).to(tdt),
        k_max=(meta + 1).to(tdt), k_min=(meta - 1).to(tdt),
        block_tab=torch.from_numpy(tab.astype(np.int32)),
        seq_lens=torch.tensor(seq_lens, dtype=torch.int32))
    return cache, rng


def _same_view(cache, want, scratch):
    """Layer 1 of ``cache`` seen through its table equals the oracle's
    ``want``, and the scratch block is untouched."""
    got = cache.layer(1)
    for a, b in ((got.kv_pages, want.kv_pages), (got.k_max, want.k_max),
                 (got.k_min, want.k_min)):
        assert torch.equal(a.float(), b.float())
    assert torch.equal(cache.kv_pages[1, :, :2].float(), scratch)


@pytest.mark.parametrize("dtype", sorted(APPEND_DTYPES))
def test_append_decode_at_matches_oracle(dtype):
    """The serving path's in-place decode append, through shuffled block
    tables, equals the per-slot oracle bitwise: a first token, a page's
    first entry (the min/max reset) and mid-page entries."""
    cache, rng = _slot_cache(dtype, [0, 15, 44], seed=3)
    scratch = cache.kv_pages[1, :, :2].float().clone()
    for step in range(3):
        k = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(
            np.float32) * 4)
        v = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(
            np.float32))
        if step == 1:
            k[2, 0, 3] = np.inf                       # routed to 0
        want = tkv.append_decode(cache.layer(1), k, v)
        tkv.append_decode_at(cache, 1, k, v)
        _same_view(cache, want, scratch)
        cache.seq_lens += 1


@pytest.mark.parametrize("dtype", sorted(APPEND_DTYPES))
def test_append_prefill_at_matches_oracle(dtype):
    """The serving path's in-place prefill append equals the per-slot
    oracle bitwise: chunks from offset 0, mid-page, and past the
    window's clamp (the write start slides back), with padded tails."""
    cache, rng = _slot_cache(dtype, [0, 5, 40], seed=4)
    scratch = cache.kv_pages[1, :, :2].float().clone()
    for T, lens in ((11, [11, 7, 3]), (8, [8, 2, 1])):
        k = torch.from_numpy(rng.standard_normal((3, T, 2, 16)).astype(
            np.float32) * 4)
        v = torch.from_numpy(rng.standard_normal((3, T, 2, 16)).astype(
            np.float32))
        k[1, 1, 1, 0] = np.nan
        lens = torch.tensor(lens, dtype=torch.int32)
        want = tkv.append_prefill(cache.layer(1), k, v, lens)
        tkv.append_prefill_at(cache, 1, k, v, new_lens=lens)
        _same_view(cache, want, scratch)
        cache.seq_lens += lens


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_scheduler_on_card_matches_cpu(cuda, fused, kv):
    """chip_smoke.py's 4-layer scheduler phase: head dim 128; with an f32
    pool the card's ticks, greedy tokens, prefix hits and tables equal
    the CPU's; with either pool the kernels' calls on every kind of
    batch agree with their plain versions."""
    res, cases = chip_smoke.small_scheduler_phase(fused, getattr(torch, kv))
    assert res["prefix_hits"] == 1
    assert {"prefill", "dense_decode"} <= set(cases)


def _card_model(dtype):
    """phase 5's 4-layer model (head dim 128, GQA group 4) in ``dtype``,
    its KV pool too."""
    from quest_tpu_torch.config import small_tpu_model
    from quest_tpu_torch.models.llama import init_params
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2, dtype=dtype)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=2048,
                        block_pages=16, kv_dtype=dtype)
    return cfg, quest, init_params(cfg, torch.Generator().manual_seed(5),
                                   device="cpu")


@pytest.mark.cuda
def test_scheduler_and_engine_alternate_bitwise(cuda):
    """bf16 decode launches (which merge their splits in the same launch,
    by ticket) of two batch sizes alternate on one stream: an engine of
    2 rows and a scheduler of 3 share the decode workspace and its
    tickets. Every logit and token is bitwise that of a run of each
    alone, and of a repeat."""
    cfg, quest, params = _card_model(torch.bfloat16)
    prompts = _prompts(12, (700, 300))
    bt = quest.block_pages * quest.page_size

    def run(engine_on, sched_on):
        eng = QuestEngine(cfg, quest, params, batch_size=2, device=cuda)
        sch = ContinuousBatchingEngine(cfg, quest, params, device=cuda,
                                       **chip_smoke.scheduler_kwargs(quest))
        for r in chip_smoke.scheduler_requests(cfg.vocab_size, bt)[:3]:
            sch.submit(r)
        logits, events = [], []
        if engine_on:
            logits.append(eng.prefill(prompts))
        for _ in range(8):
            if engine_on:
                logits.append(eng.decode(np.argmax(logits[-1], -1)))
            if sched_on:
                events.append([(e.uid, e.token) for e in sch.step()])
        return logits, events

    both, again = run(True, True), run(True, True)
    alone_logits, alone_events = run(True, False)[0], run(False, True)[1]
    for a, b, c in zip(both[0], again[0], alone_logits):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert both[1] == again[1] == alone_events
    assert any(len(ev) > 1 for ev in both[1])      # decode bursts ran


@pytest.mark.cuda
def test_decode_sample_step_on_card_is_async_and_seeded(cuda):
    cfg, quest, params = _card_model(torch.bfloat16)
    model = QuestModel(cfg, quest, params).to(cuda)
    out = []
    for _ in range(2):
        cache = tkv.init_cache(cfg, quest, batch_size=2, device=cuda)
        model.prefill_last(cache, torch.ones((2, 256), dtype=torch.int32,
                                             device=cuda))
        gen = torch.Generator(device=cuda).manual_seed(4)
        temps = torch.tensor([0.0, 0.9], device=cuda)
        tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
        toks = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(5):
                tok = model.decode_sample_step(cache, tok, gen, temps)
                toks.append(tok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out.append(torch.stack(toks, 1).cpu())
    assert torch.equal(out[0], out[1])
    assert ((out[0] >= 0) & (out[0] < cfg.vocab_size)).all()
