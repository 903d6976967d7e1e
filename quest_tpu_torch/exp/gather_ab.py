"""Random-page gather bandwidth by page size, measured in turns in one
process (counterpart of ``exp/gather_ab.py``; same arguments, defaults
and output line).

Usage: python -m quest_tpu_torch.exp.gather_ab [TOTAL_MB] [NSLOT]
           [PAGE_KB,...] [ROUNDS] [--cpu]
Defaults: 64 MB, 3 slots, pages of 8, 16 and 32 KB (one K+V page of
Llama-3.1-8B in bf16 at page 16, 32 and 64), 3 rounds, 1024 KB chunks.
Each round times every page size once, in turns, so that the spread
between rounds shows. ``--cpu`` runs the plain version instead and
prints OK or MISMATCH for each page size against the formula.

Prints `round=R page=..KB nslot=.. <us> us <GB/s> GB/s` from the card's
CUDA-event time (utils/benchmarking.py:Timer); GB/s = TOTAL bytes / time.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from quest_tpu_torch.exp.dma_probe import formula
from quest_tpu_torch.ops.copy_probe import copy_probe, copy_probe_plain
from quest_tpu_torch.ops.utils import resolve_device

CHUNK_KB = 1024


@dataclasses.dataclass
class ProbeRun:
    mode: str              # "gather" or "contig"
    page_kb: int
    idx: torch.Tensor      # [npages] page order
    xp: torch.Tensor       # the pool as [npages, PAGE / 128, 128] bf16
    ppc: int               # pages a chunk

    def __call__(self, q: torch.Tensor, nslot: int) -> torch.Tensor:
        return copy_probe(self.idx, q, self.xp, ppc=self.ppc, nslot=nslot,
                          contig=self.mode == "contig")


def build_runs(total_mb: int, pages_kb, device, modes=("gather",),
               seed: int = 0) -> List[ProbeRun]:
    """One bf16 pool of TOTAL_MB and a run per (page size, mode). Draws
    as the JAX script does: the pool first, then one permutation a page
    size, in the order given."""
    rng = np.random.default_rng(seed)
    total = total_mb * 1024 * 1024 // 2
    x = torch.from_numpy(rng.standard_normal(total).astype(np.float32)).to(
        torch.bfloat16).to(device)
    runs = []
    for pk in pages_kb:
        PAGE = pk * 1024 // 2
        npages = total // PAGE
        perm = rng.permutation(npages).astype(np.int32)
        for mode in modes:
            order = perm if mode == "gather" else np.arange(npages,
                                                            dtype=np.int32)
            runs.append(ProbeRun(mode, pk, torch.from_numpy(order).to(device),
                                 x.view(npages, PAGE // 128, 128),
                                 CHUNK_KB * 1024 // 2 // PAGE))
    return runs


def check(runs: List[ProbeRun], nslot: int) -> Dict[Tuple[str, int], float]:
    """Each run's output against its plain version on the same inputs:
    max |out - plain| over max |plain - q|, the part the copies add."""
    errs = {}
    for run in runs:
        q = torch.zeros((8, 128), dtype=torch.float32, device=run.xp.device)
        got = run(q, nslot)
        want = copy_probe_plain(run.idx, q, run.xp, run.ppc)
        errs[(run.mode, run.page_kb)] = float(
            (got - want).abs().max() / (want - q).abs().max())
    return errs


def measure(runs: List[ProbeRun], nslot: int, rounds: int, timer,
            log=print) -> Dict[Tuple[str, int], List[float]]:
    """Times every run once a round, in turns; returns the ms of each."""
    times: Dict[Tuple[str, int], List[float]] = {}
    for r in range(rounds):
        for run in runs:
            q = torch.zeros((8, 128), dtype=torch.float32, device=run.xp.device)
            ms = timer(lambda: run(q, nslot))
            times.setdefault((run.mode, run.page_kb), []).append(ms)
            t, nbytes = ms * 1e-3, run.xp.numel() * 2
            prefix = "" if run.mode == "gather" else f"{run.mode} "
            log(f"{prefix}round={r} page={run.page_kb}KB nslot={nslot} "
                f"{t * 1e6:.1f} us {nbytes / t / 1e9:.0f} GB/s")
    return times


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    total_mb = int(args[0]) if len(args) > 0 else 64
    nslot = int(args[1]) if len(args) > 1 else 3
    pages_kb = [int(x) for x in (args[2] if len(args) > 2
                                 else "8,16,32").split(",")]
    rounds = int(args[3]) if len(args) > 3 else 3
    dev = torch.device("cpu") if cpu else resolve_device("cuda")
    runs = build_runs(total_mb, pages_kb, dev)
    if cpu:
        ok = True
        for run in runs:
            q = torch.zeros((8, 128), dtype=torch.float32)
            out = run(q, nslot).numpy()
            want = formula(run.xp.float().numpy(), run.idx.numpy(), run.ppc)
            good = np.allclose(out, want, rtol=1e-2, atol=1e-5)
            ok &= good
            print(f"page={run.page_kb}KB nslot={nslot} plain "
                  f"{'OK' if good else 'MISMATCH'}", flush=True)
        return 0 if ok else 1
    from quest_tpu_torch.utils.benchmarking import Timer
    errs = check(runs, nslot)
    print(f"kernel vs plain, max rel err: {max(errs.values()):.2e}", flush=True)
    measure(runs, nslot, rounds, Timer(), log=lambda s: print(s, flush=True))
    return 0 if max(errs.values()) <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
