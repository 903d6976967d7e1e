"""Where the sparse and dense decode kernels' time goes, on the card.

Usage: python -m quest_tpu_torch.exp.decode_ablation [--cpu]

Times ``sparse_decode_attention`` and ``dense_decode_attention`` (median
of 20 runs, L2 flushed in between: ``utils/benchmarking.py:Timer``) over
bf16 and fp8 e4m3 pools of Llama-3.1-8B attention (8 KV heads, G = 4,
page 16, a shuffled block table, a bf16 query) at B=2: dense over rows
of 32768 + 5003 tokens in a 32768-token table (the kernel case of
``chip_smoke.py``) and over the serving engine's 6000 + 3000 and full
16384 + 16384 rows in a 16384-token table; sparse over 128 selected
pages of rows of 32768 + 7001 tokens. Each at 1 to 4 CTAs an SM in the
launch plan (``CTAS_PER_SM`` of the wrapper), and with the kernels
built a second time with ``-DQT_DECODE_NO_MMA -DQT_DECODE_NO_COPY``
(the producer signals each stage without copying it, the consumers skip
the products: what remains is the launch, the page lookups, the ring's
hand-offs and the merges). ``--cpu`` runs the plain versions once on a
small pool (a smoke run of the script).
"""

from __future__ import annotations

import sys
from unittest import mock

import torch

from quest_tpu_torch.config import QuestConfig, llama31_8b
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.ops import _build, dense_decode, sparse_decode
from quest_tpu_torch.ops.estimate import page_scores_physical
from quest_tpu_torch.ops.topk import select_pages
from quest_tpu_torch.ops.utils import resolve_device

SKELETON = ("QT_DECODE_NO_MMA", "QT_DECODE_NO_COPY")
# (table tokens, dense rows) of each pool.
CASES = ((32768, ((32768, 5003),)), (16384, ((6000, 3000), (16384, 16384))))
SPARSE_LENS = (32768, 7001)


def make_pool(device, max_seq_len, kv_dtype, seed=0):
    """A one-layer Llama-3.1-8B pool of random K/V, its metadata and a
    shuffled block table at B=2; returns (cache, q)."""
    cfg = llama31_8b()
    quest = QuestConfig(max_seq_len=max_seq_len, kv_dtype=kv_dtype)
    cache = init_cache(cfg, quest, batch_size=2, num_layers=1, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    cache.kv_pages.copy_(torch.randn(cache.kv_pages.shape, generator=g,
                                     device=device))
    k = cache.kv_pages[:, :, :, 0].float()
    cache.k_max.copy_(k.amax(dim=3).reshape(cache.k_max.shape))
    cache.k_min.copy_(k.amin(dim=3).reshape(cache.k_min.shape))
    NPB, NB = cache.k_max.shape[2], cache.block_tab.shape[1]
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(1))
    cache.block_tab.copy_((1 + perm[:2 * NB]).reshape(2, NB))
    q = torch.randn((2, cfg.num_heads, cfg.head_dim), generator=g,
                    device=device).to(torch.bfloat16)
    return cache, q


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def main(argv):
    cpu = "--cpu" in argv
    device = resolve_device("cpu" if cpu else "cuda")
    if cpu:
        cache, q = make_pool(device, 512, torch.bfloat16)
        kw = dict(sm_scale=128 ** -0.5, layer=0, block_tab=cache.block_tab,
                  block_pages=cache.block_pages)
        lens = torch.tensor([500, 77], dtype=torch.int32)
        out = dense_decode.dense_decode_attention(q, cache.kv_pages, lens,
                                                  **kw)
        print(f"cpu: dense plain version, output {tuple(out.shape)}, "
              f"finite {bool(torch.isfinite(out).all())}")
        return 0
    from quest_tpu_torch.utils.benchmarking import Timer
    _build.build(["sparse_decode", "dense_decode"])
    _build.build(["sparse_decode", "dense_decode"], SKELETON)
    load = _build.load
    timer = Timer()
    print(f"card: {torch.cuda.get_device_name(0)}; us, median of 20")
    for kv in (torch.bfloat16, torch.float8_e4m3fn):
        tag = str(kv).split(".")[-1]
        for cap, rows in CASES:
            cache, q = make_pool(device, cap, kv)
            kw = dict(sm_scale=128 ** -0.5, layer=0,
                      block_tab=cache.block_tab,
                      block_pages=cache.block_pages)
            calls = []
            for lens in rows:
                seq = torch.tensor(lens, dtype=torch.int32, device=device)
                calls.append((f"dense {lens[0]}+{lens[1]}", dense_decode,
                              lambda seq=seq: dense_decode.dense_decode_attention(
                                  q, cache.kv_pages, seq, **kw),
                              lambda seq=seq: dense_decode.dense_decode_attention_plain(
                                  q, cache.kv_pages, seq, **kw)))
            if cap == CASES[0][0]:
                seq = torch.tensor(SPARSE_LENS, dtype=torch.int32,
                                   device=device)
                s = page_scores_physical(q, cache.k_max[0], cache.k_min[0],
                                         cache.block_tab, group_agg="sum")
                idx, nv = select_pages(s, seq, cache.page_size, 128)
                calls.append(("sparse 128 pages", sparse_decode,
                              lambda: sparse_decode.sparse_decode_attention(
                                  q, cache.kv_pages, idx, nv, seq, **kw),
                              lambda: sparse_decode.sparse_decode_attention_plain(
                                  q, cache.kv_pages, idx, nv, seq, **kw)))
            for label, mod, call, plain in calls:
                want = plain()
                cells = []
                for defines in ((), SKELETON):
                    with mock.patch.object(
                            _build, "load",
                            lambda name, d=(), defines=defines: load(
                                name, defines)):
                        for cps in (1, 2, 3, 4):
                            with mock.patch.object(mod, "CTAS_PER_SM", cps):
                                if not defines:
                                    err = rel_err(call(), want)
                                    assert err <= 2e-2, (label, cps, err)
                                us = timer(call) * 1e3
                                cells.append(f"{'skeleton ' if defines else ''}"
                                             f"{cps}/SM {us:.1f}")
                print(f"{tag} {label}: " + ", ".join(cells))
            del cache
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
