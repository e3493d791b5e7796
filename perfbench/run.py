"""The benchmark of the PyTorch/CUDA port ``repro_torch``: one run of one
cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic and limits are found by name from
``BENCHMARK.json`` (``perfbench/bench.py``).  Without ``--trace`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the traced window's device record and a breakdown.
The last line of standard output is the result as one JSON object; the
numbers compared for ``correct`` are the last lines of standard error
and the result's last key.  Exits non-zero, printing no result, without
enough CUDA devices, without the port beside the benchmark, or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(torch, bench_spec: dict, workload: str, chips: int, res: dict,
           trace: bool) -> str:
    metrics = {}
    for m in bench.metrics_for(bench_spec, workload, trace):
        value = bench.reader(m["name"]).read(res["ctx"]) if trace \
            else res["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = bench.device_record(torch, chips, res["peak"])
    breakdown = None
    prof = res.get("profile")
    if trace and prof:
        from perfbench import profiling

        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        breakdown = {"device_ops": profiling.top_ops(prof["events"]),
                     "idle_gaps": profiling.idle_gaps(prof)}
    correct = all(c["ok"] for c in res["checks"].values())
    return bench.result_line(
        correct=correct, attempted=res["attempted"], failed=res["failed"],
        metrics=metrics, device=device, breakdown=breakdown,
        checks={k: {"value": v["value"], "limit": v["limit"]}
                for k, v in res["checks"].items()})


def main(argv=None) -> int:
    args = parse_args(argv)
    bench.set_cache_dirs()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the port (src/repro_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    spec = bench.spec()
    files = bench.cell_files(spec, args.workload)
    chips = files["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    job = {"config": files["config"], "traffic": files["traffic"],
           "limits": files["limits"], "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "device": "cuda", "t_start": T_START}
    res = bench.runner(files["traffic"]["runner"]).run(torch, job)
    line = report(torch, spec, args.workload, chips, res, bool(args.trace))
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for note in res.get("notes", []) + [
            f"reference {res['reference_s']:.1f} s"]:
        print(f"perfbench: {note}", file=sys.stderr)
    print(bench.checks_text(res["checks"]), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
