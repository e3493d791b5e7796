"""Readings for the limits of a cell, on the chip and at the cell's own
size: the numbers that ``correct`` compares, for the program, for the
low-precision control and for each planted fault, over several seeds in
one process (set-up is paid once a seed; nothing is built twice).

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--control] [--fault <kind>[,<kind>...]] \\
        [--out <file.jsonl>]

Each seed prints one JSON line: the program's numbers and, with
``--control``, the control's (serving: the mean and the widest gap of
the tokens the fp8 reference puts first; training: the fp8 reference's
three numbers against the f32 one).  With ``--fault`` each seed runs with each fault
listed planted in turn (``perfbench/faults.py``).  This is not the benchmark's command:
the benchmark's runs plant nothing and run no control.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, faults  # noqa: E402


def reading(torch, files: dict, seed: int, seconds: float, control: bool,
            fault: str | None, device: str = "cuda") -> dict:
    kind = files["traffic"]["runner"]
    job = {"config": files["config"], "traffic": files["traffic"],
           "limits": files["limits"], "seed": seed, "seconds": seconds,
           "trace": False, "device": device, "t_start": time.perf_counter(),
           "control": control}
    plant = contextlib.nullcontext()
    if fault and kind == "serve":
        plant = faults.serve_fault(fault, files["config"]["model"]["vocab"])
    elif fault:
        plant = faults.train_fault(fault)
    with plant:
        res = bench.runner(kind).run(torch, job)
    out = {"seed": seed, "fault": fault, "e2e": res["e2e"],
           "checks": {k: v["value"] for k, v in res["checks"].items()},
           "correct": all(c["ok"] for c in res["checks"].values()),
           "reference_s": res["reference_s"]}
    if kind == "serve":
        out.update(gaps=res["gaps"])
    else:
        out.update(gaps=res["gaps"], program=res["program"],
                   reference=res["reference"])
        if control:
            from perfbench import train
            from perfbench.reference import lowp, train_ref
            from perfbench.traffic import lm_batches

            conf, mix = files["config"], files["traffic"]
            step0 = conf["training"]["step0"]
            fb = lm_batches.batches(torch, mix, seed, conf["model"]["vocab"],
                                    step0, 3, device)
            low = train_ref.run(conf["model"], conf["training"], seed,
                                [{k: v[i] for k, v in fb.items()}
                                 for i in range(3)], device,
                                mm=lowp.fp8_mm_ste)
            out["control"] = train.compare(low, res["reference"])
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    files = bench.cell_files(bench.spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    for fault in (args.fault.split(",") if args.fault else [None]):
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(reading(torch, files, seed, args.seconds,
                                      args.control, fault))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
