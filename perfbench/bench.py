"""What every cell of the benchmark shares: finding a cell's files by name,
the cache directories, the import check, the device record, the metric
readers and the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``: the
configuration's file (``configs`` entry), the traffic mix
``traffic/<traffic>.json`` (its ``runner`` key names the runner module,
``serve`` or ``train``), the limits ``limits/<cell>.json``, each per-layer
metric's reader ``metrics/<metric>.py`` (or, for ``a.b.c``, the shared
``metrics/a.b.py``, then ``metrics/a.py``) and the kernel-name lists
``kernels/<group>.json``.  Adding a cell, a configuration or a metric adds
files; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names a run may never load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, so that only the
    first run of a checkout builds (the port builds its CUDA libraries
    under ``build/repro_torch`` by itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration, traffic and limits, read from their
    files under the checkout ``root``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    pb = root / "perfbench"
    return {"cell": cell,
            "config": load_json(root / conf["file"]),
            "traffic": load_json(pb / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(pb / "limits" / f"{workload}.json")}


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: the end-to-end ones without
    ``--trace``, the per-layer ones with it.  An end-to-end metric with
    a ``workloads`` key is reported in those cells, one without it in
    every cell; a per-layer metric in the cells its ``workloads`` key
    lists."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def _load_module(path: Path, name: str):
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The reader module of a per-layer metric: ``metrics/<metric>.py``,
    else the reader of its name without the last dotted part."""
    parts = metric.split(".")
    while parts:
        path = root / "perfbench" / "metrics" / (".".join(parts) + ".py")
        if path.exists():
            return _load_module(path, "perfbench_metric_" + "_".join(parts))
        parts = parts[:-1]
    raise SystemExit(f"no reader for the metric {metric!r} under "
                     f"perfbench/metrics/")


def runner(name: str):
    return _load_module(HERE / f"{name}.py", f"perfbench_runner_{name}")


def kernel_names(group: str, root: Path = ROOT) -> list:
    """Substrings that name a group's kernels in the device trace: the
    union of every ``kernels/<group>*.json`` list, so a later kernel adds
    its names in a file of its own."""
    names: list = []
    for p in sorted((root / "perfbench" / "kernels").glob(f"{group}*.json")):
        names += load_json(p)["match"]
    return names


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, as
    a whole word, one of :data:`FORBIDDEN`: ``repro_torch`` is not
    ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def device_record(torch, count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (each number
    compared, with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                     f"({'met' if v['ok'] else 'FAILED'})"
                     for k, v in checks.items())
