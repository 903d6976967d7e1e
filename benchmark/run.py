"""One run of one cell of the benchmark of quest_tpu_torch.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for (``BENCHMARK.json``). It builds or loads the port's kernels, makes
the weights and the traffic from the seed, serves the documents and the
warm-up requests (set-up), measures for ``--seconds``, drains, checks
the served tokens against the plain reference, and prints one JSON
object as its last line: the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics (read from a profiled sub-window) with
``--trace 1``. See benchmark/README.md.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# Caches of anything that compiles, at fixed paths inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "quest_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Cell:
    """A cell's set-up: its manifest entries, traffic, weights, engine,
    record and server, with the documents and the warm-up served."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 device: str = "cuda", here: Path = HERE):
        from bench import manifest, serve

        self.man = manifest.manifest(here)
        c = self.c = manifest.cell(self.man, workload, here)
        self.dims, self.mix = c["config"], c["traffic"]
        self.quest = self.dims["quest"]
        self.fam = manifest.family(self.dims["model_type"], here)
        if device == "cuda":
            from quest_tpu_torch.ops import _build
            _build.build()
        self.gen = manifest.generator(self.mix["kind"], here)
        self.traffic = self.gen.make(self.mix, self.dims["vocab_size"], seed,
                                     seconds)
        self.weights = self.fam.weights(self.dims, seed, device)
        self.eng = serve.build_engine(self.fam.model_config(self.dims),
                                      self.quest, self.weights,
                                      self.traffic.engine, seed, device)
        self.rec = serve.Record(cell=c["workload"], dims=self.dims,
                                quest=self.quest, engine=self.traffic.engine,
                                seconds=seconds, here=here)
        self.server = serve.Server(self.eng, self.traffic, self.rec)
        self.server.serve_all(self.traffic.setup)
        self.server.serve_all(self.traffic.warm)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", here: Path = HERE, t0: float = None,
             control: bool = False):
    """The whole run; returns (result dict, compared dict, info dict)."""
    import torch

    from bench import check, manifest, trace as tracing

    t0 = T0 if t0 is None else t0
    cell = Cell(workload, seed, seconds, device, here)
    man, c, dims, quest, fam = (cell.man, cell.c, cell.dims, cell.quest,
                                cell.fam)
    traffic, weights, eng = cell.traffic, cell.weights, cell.eng
    rec, server = cell.rec, cell.server
    del cell
    tracer = None
    if trace:
        tracer = tracing.Tracer(traffic.trace_ticks)
        tracer.warm()
    if device == "cuda":
        torch.cuda.synchronize()
        rec.peaks = manifest.peaks(torch.cuda.get_device_name(0), here)
    rec.setup_s = time.perf_counter() - t0
    server.window(seconds, tracer)
    if tracer is not None:
        rec.device = tracer.summary(extra_skip=fam.trace_ranges)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    metrics = {}
    for m in manifest.metrics_of(man, workload, per_layer=trace):
        v = manifest.reader(m["name"], here).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    wreqs = rec.window_requests()
    failed = sum(not st.done for st in wreqs)
    doc, picks = check.sample(rec, seed, traffic.check["max_checked_tokens"],
                              traffic.check["head_tokens"])
    from bench.readers import percentile, ttft_s
    ttft = ttft_s(rec)
    info = dict(window_ticks=len(rec.window_ticks()),
                # Not a metric: its spread between runs exceeds any bound
                # (PERF.md); printed for the record.
                ttft_p50_ms=1e3 * (percentile(ttft, 50) or 0.0),
                ttft_p90_ms=1e3 * (percentile(ttft, 90) or 0.0),
                window_requests=len(wreqs),
                served_tokens=sum(len(st.tokens) for st in wreqs),
                window_s=rec.t_close - rec.t_open,
                drain_s=rec.t_stop - rec.t_close,
                lateness_max_s=max(rec.lateness, default=0.0),
                lateness_mean_s=(sum(rec.lateness) / len(rec.lateness)
                                 if rec.lateness else 0.0),
                checked_doc=doc, checked_requests=len(picks))
    # The program's state goes before the reference runs.
    server.inst.detach()
    del server, eng, tracer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cmp = (check.compare(fam.reference, weights, dims, quest,
                         traffic.docs[doc], picks, control=control) if picks
           else
           dict(gap=float("inf"), mean_gap=float("inf"), tokens=0,
                seconds=0.0))
    info.update(reference_s=cmp["seconds"], widest_gap=cmp["gap"],
                mismatched_tokens=cmp.get("mismatched"),
                near_ties=cmp.get("near_ties"),
                distinct_tokens=cmp.get("distinct"))
    if control:
        info.update(control_gap=cmp.get("control_gap"),
                    control_mean_gap=cmp.get("control_mean_gap"),
                    control_mismatched=cmp.get("control_mismatched"))
    chk = traffic.check
    compared = {
        "logit_gap_mean": {"value": cmp["mean_gap"],
                           "limit": chk["mean_gap_limit"]},
        "unanswered": {"value": failed, "limit": 0},
        "tokens_checked_at_least": {"value": cmp["tokens"],
                                    "limit": chk["min_checked_tokens"]},
    }
    correct = (cmp["mean_gap"] <= chk["mean_gap_limit"] and failed == 0
               and cmp["tokens"] >= chk["min_checked_tokens"])
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else device),
               count=int(c["workload"]["chips"]), memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=len(wreqs), failed=failed,
                  metrics=metrics, device=dev)
    if trace and rec.device is not None:
        d = rec.device
        dev.update(busy_s=d["busy_s"], window_s=d["window_s"])
        ops = sorted(d["ops"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(d["gaps"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = dict(
            device_ops=[[n[:200], s] for n, s in ops],
            idle_gaps=[[f"{n} (gaps {g[1]}, longest {g[2]!r} s)", g[0]]
                       for n, g in gaps])
    del weights
    return result, compared, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench import manifest
    man = manifest.manifest()
    chips = int(manifest.cell(man, args.workload)["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result, compared, info = run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace))
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"run.py: modules of JAX or of the JAX package are loaded: "
              f"{bad}: no result", file=sys.stderr)
        return 3
    info["card"] = card_line()
    print(json.dumps(dict(info=info)), flush=True)
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
