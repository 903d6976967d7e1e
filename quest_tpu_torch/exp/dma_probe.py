"""Page-copy bandwidth probe on the card (counterpart of
``exp/dma_probe.py``; same arguments, defaults and output line).

Usage: python -m quest_tpu_torch.exp.dma_probe MODE CHUNK_KB NSLOT
           [TOTAL_MB] [NSEM] [PAGE_KB] [--cpu]
  MODE: contig | gather | gather_hi
contig:    copy TOTAL_MB (default 32) of bf16 pages in order, CHUNK_KB
           chunks, an NSLOT-stage ring a CTA (ops/copy_probe.py maps the
           chunks onto stages and CTAs and prints the mapping).
gather:    the same bytes, pages taken in a random permutation order
           (PAGE_KB pages, default 8): one bulk copy a page.
gather_hi: gather on a CUDA stream of the highest priority. The card
           has no per-copy priority, which the TPU's DMA start took.
NSEM > 1 splits each stage's pages into NSEM contiguous shares, one
mbarrier each (the TPU's semaphores a slot).

Prints `MODE chunk=.. nslot=.. nsem=.. page=.. <us> us <GB/s> GB/s` from
the card's CUDA-event time (utils/benchmarking.py:Timer), GB/s =
TOTAL bytes / time. ``--cpu`` runs the plain version instead and prints
OK or MISMATCH against the formula, as the JAX script does off the TPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from quest_tpu_torch.ops.copy_probe import copy_probe, stage_plan
from quest_tpu_torch.ops.utils import resolve_device


def formula(xs: np.ndarray, order: np.ndarray, ppc: int) -> np.ndarray:
    """out for q = 0, from the pages as f32 numpy [npages, rows, 128]."""
    return xs[order[::ppc], :8, :].sum(0) * 1e-6


def probe(mode: str, chunk_kb: int, nslot: int, total_mb: int = 32,
          nsem: int = 1, page_kb: int = 8, device="cuda", timer=None) -> dict:
    """One probe run: the pool and page order of the JAX script's draws,
    the kernel's output against the formula, and on the card its time.
    Returns ``label``, ``ok``, ``plan`` and, on the card, ``us`` and
    ``gbps``."""
    if mode not in ("contig", "gather", "gather_hi"):
        raise ValueError(f"unknown mode {mode}")
    PAGE = page_kb * 1024 // 2                   # bf16 elements a page
    total = total_mb * 1024 * 1024 // 2
    ppc = chunk_kb * 1024 // 2 // PAGE           # pages a chunk
    npages = total // PAGE
    assert ppc % nsem == 0
    rng = np.random.default_rng(0)
    perm = rng.permutation(npages).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal(total).astype(np.float32)).to(
        torch.bfloat16)
    order = perm if mode.startswith("gather") else np.arange(npages,
                                                              dtype=np.int32)
    dev = resolve_device(device)
    xp = x.reshape(npages, PAGE // 128, 128).to(dev)
    idx = torch.from_numpy(order).to(dev)
    q0 = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    kw = dict(ppc=ppc, nslot=nslot, nsem=nsem, contig=mode == "contig")
    res = dict(label=f"{mode} chunk={chunk_kb}KB nslot={nslot} nsem={nsem} "
                     f"page={page_kb}KB")
    want = formula(x.reshape(npages, PAGE // 128, 128).float().numpy(),
                   order, ppc)
    if dev.type == "cpu":
        out = copy_probe(idx, q0, xp, **kw).numpy()
        res["ok"] = bool(np.allclose(out, want, rtol=1e-2, atol=1e-5))
        return res
    from quest_tpu_torch.utils.benchmarking import Timer
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res["plan"] = stage_plan(npages, PAGE * 2, ppc, nslot, nsem,
                             sms).describe(PAGE * 2, ppc)
    stream = (torch.cuda.Stream(priority=-1) if mode == "gather_hi"
              else torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = copy_probe(idx, q0, xp, **kw).cpu().numpy()
        res["ok"] = bool(np.allclose(out, want, rtol=1e-2, atol=1e-5))
        ms = (timer or Timer())(lambda: copy_probe(idx, q0, xp, **kw))
    res["us"] = ms * 1e3
    res["gbps"] = total * 2 / (ms * 1e-3) / 1e9
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    try:
        res = probe(args[0], int(args[1]), int(args[2]),
                    *(int(a) for a in args[3:6]),
                    device="cpu" if cpu else "cuda")
    except ValueError as e:
        raise SystemExit(str(e))
    if cpu:
        print(f"{res['label']} plain {'OK' if res['ok'] else 'MISMATCH'}",
              flush=True)
        return 0 if res["ok"] else 1
    print(f"mapping: {res['plan']}", flush=True)
    print(f"{res['label']} {res['us']:.1f} us {res['gbps']:.0f} GB/s"
          f"{'' if res['ok'] else ' MISMATCH'}", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
