"""Host-bound decode step of the port, timed in turns across checkouts.

Serving per-token latency is host-bound and varies between machine
sessions, and within one session by tens of percent between processes.
This script times the one thing a change to the serving host path moves:
``models.decode_step`` of full-width bert-base-sten, dense and n:m:g
1:4:8 gr64 on FFN and attention, 4 slots, with a device sync after every
step. Each turn is a fresh process that imports ``repro_torch`` from the
checkout it is given; the turns rotate through the checkouts so that none
always runs first.

    python3 scripts/decode_ab.py parent=build/ab_parent change=. \\
        [--rounds 8] [--steps 200]

Prints the card's name and power limit, one JSON line per turn, and a
summary: per checkout and configuration, the median over turns of each
turn's median ms per step, and the quartiles of those turn medians.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def _worker(steps: int) -> None:
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_config("bert-base-sten")
    dense = init_lm(cfg, seed=0, device="cuda")
    out = {}
    for label, params in (
            ("dense", dense),
            ("sparse_attn", sparsify_for_serving(dense, 1, 4, 8, gr=64,
                                                 attn=True))):
        cache = init_cache(cfg, 4, 128, device="cuda")
        tok = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
        pos = torch.full((4,), 16, dtype=torch.int32, device="cuda")
        times = []
        for i in range(steps + 10):
            t0 = time.perf_counter()
            with torch.no_grad():
                decode_step(params, cfg, tok, cache, pos)
            torch.cuda.synchronize()
            if i >= 10:                                   # 10 warm-up steps
                times.append((time.perf_counter() - t0) * 1e3)
        out[label] = float(np.median(times))
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="LABEL=DIR checkouts")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.steps)
        return 0
    trees = [t.split("=", 1) for t in args.trees]
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    me = os.path.abspath(__file__)
    res: dict = {}
    for r in range(args.rounds):
        for k in range(len(trees)):
            label, d = trees[(r + k) % len(trees)]
            env = dict(os.environ,
                       PYTHONPATH=os.path.join(os.path.abspath(d), "src"))
            got = subprocess.run(
                [sys.executable, me, "--worker", "x=.", "--steps",
                 str(args.steps)], env=env, cwd=d, check=True,
                capture_output=True, text=True).stdout.strip().splitlines()
            turn = json.loads(got[-1])
            print(json.dumps({"round": r, "tree": label, **turn}),
                  flush=True)
            for cfg_name, ms in turn.items():
                res.setdefault((label, cfg_name), []).append(ms)
    summary = {f"{lab}/{c}": {"median_ms": float(np.median(v)),
                              "q1_ms": float(np.percentile(v, 25)),
                              "q3_ms": float(np.percentile(v, 75)),
                              "turns": len(v)}
               for (lab, c), v in sorted(res.items())}
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
