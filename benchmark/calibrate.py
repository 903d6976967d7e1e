"""Readings for the limit of a cell's check, several seeds in one
process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control 1]

Each seed is a whole run of the cell (set-up, the window at the cell's
load, the drain, the check), as ``run.py`` makes it, and prints one JSON
line: the widest gap of a served token below the reference's best (the
lower reading's sample), the tokens compared, and with ``--control 1``
the control's readings: the mean and widest gap, in the float32
reference, of the tokens the fp8 reference puts first at the same
positions (the upper reading's sample). No run of the benchmark
computes the control. With ``--fault <name>`` (``bench/faults.py``) the
fault is planted under the timed path for every seed, and the readings
are those of the faulty program.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from bench.manifest import load_module  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    run = load_module(HERE / "run.py", "bench_run_")
    from bench.faults import planted
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with (planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            res, cmp, info = run.run_cell(args.workload, seed, args.seconds,
                                          False, t0=t,
                                          control=bool(args.control))
        print(json.dumps(dict(seed=seed, fault=args.fault,
                              correct=res["correct"],
                              compared=cmp, info=info,
                              metrics={k: v["value"] for k, v in
                                       res["metrics"].items()},
                              peak=res["device"]["memory_peak_bytes"],
                              run_s=time.perf_counter() - t)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
