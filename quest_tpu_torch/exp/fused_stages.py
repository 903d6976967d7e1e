"""Where the fused decode kernel's time goes, stage by stage, on the card.

Usage: python -m quest_tpu_torch.exp.fused_stages [BUDGET ...] [--cpu]

Builds ``csrc/fused_decode.cu`` a second time with ``-DQT_FUSED_STAGES``:
thread 0 of every CTA then reads its SM's cycle counter at the kernel's
start and at the end of each stage (the scoring, the cluster barrier that
completes every CTA's keys, the radix select, the compaction, the first
attention chunk's load, the rest of the attention, the merge), and the
global nanosecond timer at its start and end, which give the SM clock's
rate during the run and the span from the first CTA's start to the last
one's end. The kernel runs at the fused path's kernel case (Llama-3.1-8B
attention, B=2, rows of 32768 and 7001 tokens in a 32768-token bf16
pool, page 16, a shuffled block table, a bf16 query) at each page budget
(default 128 and 8), 20 times with the L2 flushed in between, and the
script prints each stage's cycles (median over CTAs and runs, and the
slowest CTA's median), in us at the measured clock, beside the grid's
span and the uninstrumented kernel's time (``utils/benchmarking.py:
Timer``). The stamps are on the CTA's own clock, so the launch and the
wait for the cluster to be scheduled are outside them. ``--cpu`` runs the
plain version once on a 2048-token pool (a smoke run of the script).
"""

from __future__ import annotations

import ctypes
import math
import statistics
import sys
from unittest import mock

import torch

from quest_tpu_torch.config import QuestConfig, llama31_8b
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.fused_decode import fused_sparse_decode
from quest_tpu_torch.ops.utils import resolve_device

# The spans between the kernel's stamps (csrc/fused_decode.cu QT_STAMP).
STAGES = ("scoring", "key barrier", "radix select", "compaction",
          "first chunk load", "attention", "merge")
DEFINES = ("QT_FUSED_STAGES",)
CLOCKS = len(STAGES) + 1          # cycle stamps a CTA; then two ns stamps


def kernel_case(device, max_seq_len=32768, lens=(32768, 7001), seed=0):
    """Pool, metadata, block table, lengths and query of the kernel case;
    returns (q, args, kw) for fused_sparse_decode."""
    cfg = llama31_8b()
    quest = QuestConfig(max_seq_len=max_seq_len)
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
    seq = torch.tensor(lens, dtype=torch.int32, device=device)
    q = torch.randn((2, cfg.num_heads, cfg.head_dim), generator=g,
                    device=device).to(torch.bfloat16)
    kw = dict(sm_scale=1.0 / math.sqrt(cfg.head_dim),
              group_agg=quest.group_agg, layer=0, block_tab=cache.block_tab,
              block_pages=cache.block_pages)
    return q, (cache.kv_pages, cache.k_max, cache.k_min, seq), kw


def stage_cycles(q, args, kw, budget, runs=20):
    """[runs, CTAs, CLOCKS + 2] stamps of each CTA: cycles, then ns."""
    lib = _build.load("fused_decode", DEFINES)
    real = _build.load
    Hkv = args[0].shape[1]
    stamps = torch.zeros((runs, q.shape[0] * Hkv * 8, CLOCKS + 2),
                         dtype=torch.int64,
                         device=q.device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=q.device)
    with mock.patch.object(_build, "load", lambda name, defines=(): (
            lib if name == "fused_decode" else real(name, defines))):
        fused_sparse_decode(q, *args, budget_pages=budget, **kw)   # warm-up
        for r in range(runs):
            flush.zero_()
            _build.check(lib, lib.fused_decode_stamps(
                _build.ptr(stamps[r])), "fused_decode_stamps")
            fused_sparse_decode(q, *args, budget_pages=budget, **kw)
        torch.cuda.synchronize()
        _build.check(lib, lib.fused_decode_stamps(None), "fused_decode_stamps")
    return stamps.cpu()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    budgets = [int(a) for a in argv if a != "--cpu"] or [128, 8]
    dev = torch.device("cpu") if cpu else resolve_device("cuda")
    q, args, kw = kernel_case(dev, 2048, (2048, 700)) if cpu else \
        kernel_case(dev)
    if cpu:
        out = fused_sparse_decode(q, *args, budget_pages=budgets[0], **kw)
        print(f"plain fused decode on the CPU: {tuple(out.shape)}, finite "
              f"{bool(torch.isfinite(out).all())}")
        return 0
    from quest_tpu_torch.utils.benchmarking import Timer
    lib = _build.load("fused_decode", DEFINES)
    lib.fused_decode_stamps.argtypes = [ctypes.c_void_p]
    lib.fused_decode_stamps.restype = ctypes.c_int
    timer = Timer()
    print(torch.cuda.get_device_name(0))
    for budget in budgets:
        st = stage_cycles(q, args, kw, budget)
        cyc = st[..., 1:CLOCKS] - st[..., :CLOCKS - 1]
        ns = (st[..., CLOCKS + 1] - st[..., CLOCKS]).float()
        mhz = statistics.median(
            ((st[..., CLOCKS - 1] - st[..., 0]).float() / ns * 1e3)
            .flatten().tolist())
        span = statistics.median(
            (st[..., CLOCKS + 1].amax(dim=1) - st[..., CLOCKS].amin(dim=1))
            .float().tolist())
        ms = timer(lambda: fused_sparse_decode(q, *args, budget_pages=budget,
                                               **kw))
        med = cyc.float().median(dim=1).values     # [runs, stages] over CTAs
        worst = cyc.float().amax(dim=1)                # the slowest CTA
        parts = []
        for i, name in enumerate(STAGES):
            c = statistics.median(med[:, i].tolist())
            w = statistics.median(worst[:, i].tolist())
            parts.append(f"{name} {c:.0f} cycles {c / mhz:.2f} us (slowest "
                         f"CTA {w / mhz:.2f} us)")
        total = statistics.median(cyc.sum(dim=2).float().amax(dim=1).tolist())
        print(f"budget {budget}: SM clock {mhz:.0f} MHz; " + "; ".join(parts)
              + f"; CTA lifetime {total / mhz:.2f} us; first start to last "
              f"end {span / 1e3:.2f} us; kernel {ms * 1e3:.2f} us (Timer)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
