"""Launch one select piece on the card and check it against its plain
version (counterpart of ``exp/select_compile2.py``, which only compiled
the piece for the TPU).

Usage: python -m quest_tpu_torch.exp.select_compile2 STAGE [SG] [--cpu]
stages: reduce3 cumsum full radix thr slice2d dot2d

The input s [SG, 16, 128] f32 (numpy seed 0) is integer-valued for
``cumsum`` and ``thr``, uniform in [0, 1) for the sums of ``reduce3``
and ``dot2d`` (no cancellation, so an error relative to the sum means
what it says) and normal otherwise. Prints `OK stage=.. SG=..`
when the kernel matches: bit for bit, or within 1e-6 relative for the
f32 sums of ``reduce3`` and ``dot2d``. ``--cpu`` runs the plain version
on the CPU (a smoke run of the script).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from quest_tpu_torch.ops.select_pieces import (STAGES, select_pieces,
                                               select_pieces_plain)
from quest_tpu_torch.ops.utils import resolve_device

INTEGER_STAGES = ("cumsum", "thr")     # read int(s)
SUM_STAGES = ("reduce3", "dot2d")      # f32 sums in another order


def make_input(stage: str, SG: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if stage in INTEGER_STAGES:
        return rng.integers(-8, 9, size=(SG, 16, 128)).astype(np.float32)
    if stage in SUM_STAGES:
        return rng.random((SG, 16, 128)).astype(np.float32)
    return rng.standard_normal((SG, 16, 128)).astype(np.float32)


def mismatch(got: torch.Tensor, want: torch.Tensor, stage: str) -> float:
    """0 when the kernel's output is right: the relative error for the
    sum stages (limit 1e-6), else the number of differing elements."""
    if stage in SUM_STAGES:
        err = float((got - want).abs().max() / want.abs().max())
        return 0.0 if err <= 1e-6 else err
    return float((got.view(torch.int32) != want.view(torch.int32)).sum())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    stage = args[0]
    SG = int(args[1]) if len(args) > 1 else 2
    if stage not in STAGES:
        raise SystemExit(f"unknown stage {stage}")
    dev = torch.device("cpu") if cpu else resolve_device("cuda")
    s = torch.from_numpy(make_input(stage, SG)).to(dev)
    bad = mismatch(select_pieces(s, stage), select_pieces_plain(s, stage),
                   stage)
    print(f"{'OK' if bad == 0 else f'MISMATCH ({bad:g})'} stage={stage} "
          f"SG={SG}", flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
