"""The sustained rate of a cell with arrivals: the same cell at several
offered rates, one process, and at each the backlog (requests due and not
yet admitted) at each quarter of the window.  A rate is sustained where
the backlog does not grow through the window.  Run once, on the chip, to
set a cell's rate; the benchmark never searches for one.

    python3 perfbench/sweep.py --workload <cell> --rates 4,6,8 \\
        --seconds 20 --seed 1
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench  # noqa: E402


def backlog_at(queueing: list, t: float) -> int:
    return sum(1 for due, adm in queueing if due <= t < adm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    files = bench.cell_files(bench.spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(files["traffic"])
        mix["rate"] = rate
        res = bench.runner(mix["runner"]).run(torch, {
            "config": files["config"], "traffic": mix,
            "limits": files["limits"], "seed": args.seed,
            "seconds": args.seconds, "trace": False, "device": "cuda",
            "t_start": time.perf_counter(), "check": False})
        w0, w1 = res["ctx"]["window"]
        quarters = [backlog_at(res["queueing"], w0 + (w1 - w0) * q / 4)
                    for q in (1, 2, 3, 4)]
        print(json.dumps({"rate": rate, "backlog_quarters": quarters,
                          "due": len(res["queueing"]),
                          "failed": res["failed"], **res["e2e"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
