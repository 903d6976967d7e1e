"""Where the quantized weight product's time goes, on the card.

Usage: python -m quest_tpu_torch.exp.qgemv_ablation [--cpu]

Times ``ops/qdot.py:qgemv`` (median of 20 runs, L2 flushed in between:
``utils/benchmarking.py:Timer``) at Llama-3.1-8B's wq (4096 x 4096) and
w_gate (4096 x 14336), int8 and int4 (RTN of a random bf16 weight), a
bf16 activation of M = 1, 2, 4 and 16 rows, in four builds of
``csrc/qgemv.cu``: as it is; with ``-DQT_QGEMV_NO_MATH`` (the loads,
each word added once: the streaming alone); with ``-DQT_QGEMV_NO_LOAD``
(the bytes made from the address: the arithmetic alone); with both (what
remains is the launch, the staging of x, the reduction of the row lanes
and the split merge). Beside them the bytes bound and one bf16
``torch.matmul`` over the unquantized weight. ``--cpu`` runs the plain
version once on a small weight (a smoke run of the script).
"""

from __future__ import annotations

import sys
from unittest import mock

import torch

from quest_tpu_torch.models.quantize import quantize_weight
from quest_tpu_torch.ops import _build, qdot
from quest_tpu_torch.ops.utils import resolve_device

BUILDS = {"full": (), "no_math": ("QT_QGEMV_NO_MATH",),
          "no_load": ("QT_QGEMV_NO_LOAD",),
          "neither": ("QT_QGEMV_NO_LOAD", "QT_QGEMV_NO_MATH")}
SHAPES = (("wq", 4096, 4096), ("w_gate", 4096, 14336))
ROWS = (1, 2, 4, 16)
HBM_BYTES_PER_S = 3.35e12


def main(argv):
    cpu = "--cpu" in argv
    device = resolve_device("cpu" if cpu else "cuda")
    g = torch.Generator(device=device).manual_seed(0)
    if cpu:
        w = quantize_weight(torch.randn((64, 48), generator=g), 4)
        x = torch.randn((2, 64), generator=g).bfloat16()
        out = qdot.qgemv(x, w.q, w.s, None, 4)
        print(f"cpu: qgemv plain version, output {tuple(out.shape)}, "
              f"finite {bool(torch.isfinite(out.float()).all())}")
        return 0
    from quest_tpu_torch.utils.benchmarking import Timer
    for defines in BUILDS.values():
        _build.build(["qgemv"], defines)
    load = _build.load
    timer = Timer()
    print(f"card: {torch.cuda.get_device_name(0)}; us, median of 20")
    for label, K, N in SHAPES:
        w = (torch.randn((K, N), generator=g, device=device)
             / K ** 0.5).bfloat16()
        for bits in (8, 4):
            qw = quantize_weight(w, bits)
            for M in ROWS:
                x = torch.randn((M, K), generator=g, device=device).bfloat16()
                cells = []
                for name, defines in BUILDS.items():
                    with mock.patch.object(
                            _build, "load",
                            lambda n, d=(), defines=defines: load(n, defines)):
                        us = timer(lambda: qdot.qgemv(x, qw.q, qw.s, None,
                                                      bits)) * 1e3
                    cells.append(f"{name} {us:.1f}")
                bound = (qw.q.numel() + 4 * N + 2 * M * (K + N)) / (
                    HBM_BYTES_PER_S) * 1e6
                mm = timer(lambda: x @ w) * 1e3
                print(f"{label} int{bits} M={M}: " + ", ".join(cells)
                      + f"; bound {bound:.1f}, bf16 matmul {mm:.1f}",
                      flush=True)
            del qw
        del w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
