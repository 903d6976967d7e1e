"""Find a cell's pieces by name: the manifest (``BENCHMARK.json`` at the
root of the checkout), the configuration file, its architecture's family
(``families/<model_type>.py``), the traffic mix
(``traffic/<traffic>.json``) and its generator (``traffic/<kind>.py``),
each metric's reader (``metrics/<name>.py``, or ``metrics/<base>.py``
for ``<base>.<suffix>``) and each kernel group
(``roofline/<group>.py``). Adding a configuration, an architecture, a
mix, a metric or a kernel group is adding files and entries: nothing
here names one."""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent        # benchmark/


def load_module(path: Path, prefix: str):
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(here: Path = HERE) -> Dict:
    return json.loads((here.parent / "BENCHMARK.json").read_text())


def cell(man: Dict, workload: str, here: Path = HERE) -> Dict:
    """The workload entry, its configuration (the file's contents) and its
    traffic mix (the file's contents)."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    confs = {c["name"]: c for c in man["configs"]}
    conf = json.loads((here.parent / confs[w["config"]]["file"]).read_text())
    mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    return dict(workload=w, config=conf, traffic=mix)


def generator(kind: str, here: Path = HERE):
    return load_module(here / "traffic" / f"{kind}.py", "bench_traffic_")


def family(model_type: str, here: Path = HERE):
    """``families/<model_type>.py``: what the harness needs of one
    architecture (benchmark/README.md). An unknown ``model_type`` stops
    the run, naming the known families; nothing falls back to another."""
    return _family(model_type, Path(here))


@functools.lru_cache(maxsize=None)
def _family(model_type: str, here: Path):
    path = here / "families" / f"{model_type}.py"
    if not path.is_file():
        known = sorted(p.stem for p in (here / "families").glob("*.py"))
        raise SystemExit(f"unknown model_type {model_type!r}; known "
                         f"families: {known}")
    return load_module(path, "bench_family_")


def metrics_of(man: Dict, workload: str, per_layer: bool) -> List[Dict]:
    """The cell's end-to-end or per-layer metrics. A metric with a
    ``workloads`` key is the listed cells'; one without is every cell's
    (an end-to-end one), or every cell's that reports its ``moves``."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``, or for a name with a suffix (``a.b``) that
    has no file of its own, the reader it shares: ``metrics/a.py``."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_module(path, "bench_metric_")


def group(name: str, here: Path = HERE):
    return load_module(here / "roofline" / f"{name}.py", "bench_roofline_")


def peaks(device_name: str, here: Path = HERE):
    table = json.loads((here / "roofline" / "peaks.json").read_text())
    return table.get(device_name)
