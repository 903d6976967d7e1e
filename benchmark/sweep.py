"""The knee of an open-loop cell: the highest arrival rate its engine
sustains without a growing backlog, by one sweep of rates after one
set-up:

    python3 benchmark/sweep.py --workload <name> --seed <n> \
        --rates 3,4,5 --seconds 40

For each rate the cell's traffic is made again at that rate (the same
documents) and served for ``--seconds``, then drained. A rate is
sustained when the requests due in the window's last third wait, from
due time to first token, no longer at the median than those of its
first third, within 25%, and the queue at the window's close holds no
more requests than there are slots. Prints one JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from bench import readers, serve  # noqa: E402
from bench.manifest import load_module  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default=None,
                    help="a seed a rate for its requests' order and ids "
                         "(default: --seed); the documents stay --seed's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep.py: no CUDA card", file=sys.stderr)
        return 2
    run = load_module(HERE / "run.py", "bench_run_")
    cell = run.Cell(args.workload, args.seed, args.seconds)
    c, dims, mix = cell.c, cell.dims, dict(cell.mix)
    gen, traffic, eng, server = cell.gen, cell.traffic, cell.eng, cell.server
    rates = [float(r) for r in args.rates.split(",")]
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else [args.seed] * len(rates))
    for rate, seed in zip(rates, seeds):
        mix["rate_per_s"] = rate
        t = gen.make(mix, dims["vocab_size"], seed, args.seconds)
        t.docs = traffic.docs
        rec = serve.Record(cell=c["workload"], dims=dims, quest=dims["quest"],
                           engine=traffic.engine, seconds=args.seconds)
        server.traffic, server.rec, server.inst.rec = t, rec, rec
        queue_at_close = []

        class Probe:
            def before_tick(self, elapsed, seconds):
                if elapsed >= seconds and not queue_at_close:
                    queue_at_close.append(len(eng.queue))

            def after_tick(self):
                return False

            def finish(self):
                pass

        t0 = time.perf_counter()
        server.window(args.seconds, Probe())
        reqs = sorted(rec.window_requests(), key=lambda st: st.due)
        third = max(1, len(reqs) // 3)

        def med_wait(rs):
            return statistics.median(
                (st.first if st.first is not None else rec.t_stop) - st.due
                for st in rs)
        first, last = med_wait(reqs[:third]), med_wait(reqs[-third:])
        sustained = (last <= 1.25 * first + 0.05
                     and (queue_at_close or [0])[0] <= eng.max_batch)
        print(json.dumps(dict(
            rate=rate, seed=seed, requests=len(reqs),
            unanswered=sum(not st.done for st in reqs),
            ttft_p50_ms=1e3 * readers.percentile(readers.ttft_s(rec), 50),
            ttft_p90_ms=1e3 * readers.percentile(readers.ttft_s(rec), 90),
            tpot_p90_ms=1e3 * readers.percentile(readers.tpot_s(rec), 90),
            wait_first_third_ms=1e3 * first, wait_last_third_ms=1e3 * last,
            queue_at_close=(queue_at_close or [0])[0],
            tokens_per_s=readers.tokens_per_s(rec),
            decode_step_ms=readers.decode_step_ms(rec),
            sustained=sustained, wall_s=time.perf_counter() - t0)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
