#!/usr/bin/env python3
"""How much of its bound run (b)'s training parity uses, at several seeds,
on one GPU.

    python3 scripts/train_margin.py [--src DIR] [--seeds 1 2 3 4]

For each seed, ``chip_smoke.py``'s run (b) model (full-width
bert-base-sten, the inline threshold 0.5 on ``mlp.wi`` through the fused
``matmul_threshold`` kernel, NMSparsifier(2, 4) FixedMask ``mlp.wo`` /
``attn.wo`` built through ``nm_mask``) is drawn from the seed, and its
first step's loss and ``mlp.wi`` gradient through the kernels are held
against the same step through the plain versions: the loss within 1e-3
relative, the gradient within 2**-6 relative (Frobenius norm).  ``--src``
runs the port from another tree (e.g. a ``git archive`` of an earlier
commit unpacked into ``build/``).  Prints one line per seed and a JSON
list, writes ``chiprun_out/train_margin.json``, and exits 1 if a seed is
over a bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch to run")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import repro_torch  # noqa: F401  (bound to --src before chip_smoke)

    if not torch.cuda.is_available():
        print("train_margin: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    card = chip_smoke.nvidia_smi_line()
    rows = chip_smoke.train_margins(args.seeds, check=False)
    bad = 0
    for r in rows:
        over = r["loss_rel_err"] > 1e-3 or r["wi_grad_rel_err"] > 2 ** -6
        bad += over
        print(f"seed {r['seed']} on {card} ({repro_torch.__file__}): loss "
              f"rel err {r['loss_rel_err']:.3e} (bound 1e-3), mlp.wi "
              f"gradient rel err {r['wi_grad_rel_err']:.5f} (bound 2**-6 = "
              f"0.015625, {r['wi_grad_share_of_bound'] * 100:.1f}%)"
              + (" OVER THE BOUND" if over else ""))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_margin.json").write_text(json.dumps(
        {"card": card, "src": args.src, "seeds": rows}, indent=1))
    print(json.dumps(rows))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
