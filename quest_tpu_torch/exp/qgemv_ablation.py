"""Where the quantized weight products' time goes, on the card.

Usage: python -m quest_tpu_torch.exp.qgemv_ablation [--sweep [--all]]
       [--cpu]

Times ``ops/qdot.py:qgemv`` with a bf16 activation (median of 20 runs,
L2 flushed in between: ``utils/benchmarking.py:Timer``) at Llama-3.1-8B's
w_gate (4096 x 14336) and wk (4096 x 1024), int8 and int4 (RTN of a
random bf16 weight), M = 2, 4 and 16 rows, in these builds of
``csrc/qgemv.cu``'s ring kernel, in turns:

- ``full``: as it is;
- ``scale_each``: each weight scaled and rounded as JAX does (design step
  1c taken out);
- ``ticket_merge``: the splits merged through global partials and a
  ticket, as the f32 kernel does, instead of inside the cluster (step 1b
  taken out);
- ``no_merge``: each CTA writes its own partial (no merge at all);
- ``no_math``: no unpacking and no mma (the ring and the merge);
- ``ring_only``: neither the arithmetic nor the merge (the stream);
- ``no_load``: no TMA (the arithmetic, the merge and the fixed cost);
- ``neither``: no TMA and no arithmetic (the launch, the staging of x,
  the ring's barriers, the reduction and the merge);
- ``launch_only``: ``neither`` without the ring's barriers.

Beside them the bytes bound, one bf16 ``torch.matmul`` over the
unquantized weight, both again with the L2 flushed by a 256 MB read
instead of a memset (``Timer(flush="read")``: no dirty lines for the
kernel to write back), and the plan. Then ``dequant`` at w_gate and wq
(int8, int4, to bf16), with plain stores and with the evict-first hint
(``-DQT_DEQUANT_STCS``), alone (L2 flushed) and followed by the
``torch.matmul`` of a 2048-row prefill chunk without the flush (the
matrix it wrote may still sit in the 50 MB L2), in turns.

``--sweep`` also times every ring plan (tile 64/128/256, 1-8 splits, 2,
4 or the most stages, and the plan's own) of the full build at w_gate,
wk, wq and w_down, M = 2 and 16, against the plan's choice (``--all``
prints every plan's time). The ring itself (design step 1a, against the
earlier kernel's prefetch in registers) is read by running the parent
commit's copy of this script right after it on the same card.
``--cpu`` runs the plain version once on a small weight (a smoke run of
the script).
"""

from __future__ import annotations

import sys
from unittest import mock

import torch

from quest_tpu_torch.models.quantize import quantize_weight
from quest_tpu_torch.ops import _build, qdot
from quest_tpu_torch.ops.decode_common import sm_count
from quest_tpu_torch.ops.utils import resolve_device

BUILDS = {"full": (), "scale_each": ("QT_QGEMV_SCALE_EACH",),
          "ticket_merge": ("QT_QGEMV_TICKET_MERGE",),
          "no_merge": ("QT_QGEMV_NO_MERGE",),
          "no_math": ("QT_QGEMV_NO_MATH",),
          "ring_only": ("QT_QGEMV_NO_MATH", "QT_QGEMV_NO_MERGE"),
          "no_load": ("QT_QGEMV_NO_LOAD",),
          "neither": ("QT_QGEMV_NO_LOAD", "QT_QGEMV_NO_MATH"),
          "launch_only": ("QT_QGEMV_NO_LOAD", "QT_QGEMV_NO_MATH",
                          "QT_QGEMV_NO_RING")}
DEQ_BUILDS = {"plain_store": (), "evict_first": ("QT_DEQUANT_STCS",)}
SHAPES = (("w_gate", 4096, 14336), ("wk", 4096, 1024))
SWEEP_SHAPES = SHAPES + (("wq", 4096, 4096), ("w_down", 14336, 4096))
DEQ_SHAPES = (("w_gate", 4096, 14336), ("wq", 4096, 4096))
ROWS = (2, 4, 16)
PREFILL_ROWS = 2048
HBM_BYTES_PER_S = 3.35e12


def with_build(defines):
    """A context in which ``qdot`` loads the library built with
    ``defines`` (the ticket-merge build also gets its workspace)."""
    load = _build.load
    patches = [mock.patch.object(
        _build, "load", lambda n, d=(), defines=defines: load(n, defines))]
    if "QT_QGEMV_TICKET_MERGE" in defines:
        patches.append(mock.patch.object(qdot, "RING_TICKETS", True))

    class _Ctx:
        def __enter__(self):
            for p in patches:
                p.start()

        def __exit__(self, *exc):
            for p in reversed(patches):
                p.stop()
    return _Ctx()


def sweep(timer, label, qw, x, bits, sms, build="full"):
    """Every ring plan of one build at M = x's rows; the best three and
    the plan's choice."""
    q_rows, N = qw.q.shape
    M = x.shape[0]
    chosen = qdot.qgemv_plan(q_rows, N, sms, M, bits, True)
    rows = []
    for tile_n in qdot.RING_TILES:
        stage_rows = qdot.RING_STAGE_BYTES // tile_n
        for ks in range(1, qdot.RING_MAX_CLUSTER + 1):
            chunk = -(-q_rows // ks)
            chunk = -(-chunk // stage_rows) * stage_rows
            if (ks - 1) * chunk >= q_rows:
                continue
            most = min(qdot.RING_MAX_STAGES, chunk // stage_rows)
            picks = {min(2, most), min(4, most), most}
            if (tile_n, ks) == (chosen.tile_n, chosen.ksplit):
                picks.add(chosen.stages)
            for stages in sorted(picks):
                if stages * qdot.RING_STAGE_BYTES < 2048 * M:
                    continue
                plan = qdot.QgemvPlan(chunk, ks, tile_n, stages)
                smem = qdot.ring_smem(bits, M, chunk, ks, tile_n, stages)
                if smem + qdot.RING_STATIC_BYTES > qdot.BLOCK_SHARED_BYTES:
                    continue
                with with_build(BUILDS[build]):
                    us = timer(lambda: qdot.qgemv(x, qw.q, qw.s, None, bits,
                                                  plan=plan)) * 1e3
                rows.append((us, tuple(plan)))
    rows.sort()
    mine = next(us for us, p in rows if p == tuple(chosen))
    print(f"sweep {build} {label} int{bits} M={M}: plan {tuple(chosen)} "
          f"{mine:.1f} us; best " + ", ".join(f"{p} {us:.1f}"
                                              for us, p in rows[:5]),
          flush=True)
    return rows


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
    for defines in list(BUILDS.values()) + list(DEQ_BUILDS.values()):
        _build.build(["qgemv"], defines)
    timer, clean = Timer(), Timer(flush="read")
    sms = sm_count(torch.device(device))
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
                    with with_build(defines):
                        us = timer(lambda: qdot.qgemv(x, qw.q, qw.s, None,
                                                      bits)) * 1e3
                    cells.append(f"{name} {us:.1f}")
                bound = (qw.q.numel() + 4 * N + 2 * M * (K + N)) / (
                    HBM_BYTES_PER_S) * 1e6
                mm = timer(lambda: x @ w) * 1e3
                full_r = clean(lambda: qdot.qgemv(x, qw.q, qw.s, None,
                                                  bits)) * 1e3
                mm_r = clean(lambda: x @ w) * 1e3
                plan = qdot.qgemv_plan(qw.q.shape[0], N, sms, M, bits, True)
                print(f"{label} int{bits} M={M}: " + ", ".join(cells)
                      + f"; bound {bound:.1f}, bf16 matmul {mm:.1f}; "
                      f"read flush: full {full_r:.1f}, bf16 matmul "
                      f"{mm_r:.1f}; plan {tuple(plan)}", flush=True)
            del qw
        del w
        torch.cuda.empty_cache()
    if "--sweep" in argv:
        for label, K, N in SWEEP_SHAPES:
            w = (torch.randn((K, N), generator=g, device=device)
                 / K ** 0.5).bfloat16()
            for bits in (8, 4):
                qw = quantize_weight(w, bits)
                for M in (2, 16):
                    x = torch.randn((M, K), generator=g,
                                    device=device).bfloat16()
                    rows = sweep(timer, label, qw, x, bits, sms)
                    if "--all" in argv:
                        print("  " + "; ".join(f"{p} {us:.1f}"
                                               for us, p in rows))
                del qw
            del w
            torch.cuda.empty_cache()
    for label, K, N in DEQ_SHAPES:
        w = (torch.randn((K, N), generator=g, device=device)
             / K ** 0.5).bfloat16()
        xs = torch.randn((PREFILL_ROWS, K), generator=g,
                         device=device).bfloat16()
        buf = torch.empty((K, N), dtype=torch.bfloat16, device=device)
        for bits in (8, 4):
            qw = quantize_weight(w, bits)
            bound = (qw.q.numel() + 4 * N + 2 * K * N) / HBM_BYTES_PER_S * 1e6
            cells = []
            for turn in (0, 1):
                order = list(DEQ_BUILDS.items())
                for name, defines in (order if turn == 0 else order[::-1]):
                    with with_build(defines):
                        alone = timer(lambda: qdot.dequant(
                            qw.q, qw.s, None, bits, torch.bfloat16,
                            out=buf)) * 1e3
                        pair = timer(lambda: xs @ qdot.dequant(
                            qw.q, qw.s, None, bits, torch.bfloat16, out=buf),
                            flush=False) * 1e3
                        read = clean(lambda: qdot.dequant(
                            qw.q, qw.s, None, bits, torch.bfloat16,
                            out=buf)) * 1e3
                    cells.append(f"{name} {alone:.1f} (read flush {read:.1f},"
                                 f" pair {pair:.1f})")
            mm = timer(lambda: xs @ buf, flush=False) * 1e3
            print(f"dequant {label} int{bits} -> bf16: " + ", ".join(cells)
                  + f"; bound {bound:.1f}; matmul alone {mm:.1f} "
                  f"({PREFILL_ROWS} rows, no flush)", flush=True)
            del qw
        del w, xs, buf
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
