"""CLI: ``python -m repro_torch.check`` — see the package docstring."""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.check import run_check
from repro_torch.check.entries import ENTRY_NAMES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static sparse-program verifier (ATen graph + CUDA "
                    "graph capture lint).",
    )
    p.add_argument("--entry", action="append", choices=ENTRY_NAMES,
                   help="entry point(s) to check (default: serve + train)")
    p.add_argument("--config", action="append",
                   help="model config name(s) (default: bert-base-sten)")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on warnings too, not just errors")
    p.add_argument("--json", metavar="PATH",
                   help="write the full diagnostic report as JSON")
    p.add_argument("--ignore", action="append", default=[],
                   metavar="RULE[:entry-glob]",
                   help="suppress a rule, optionally only for matching "
                        "entries (e.g. R5 or R2:*/train:*)")
    p.add_argument("--differential", action="store_true",
                   help="also cross-check static route predictions against "
                        "runtime kernel counters from a quick engine warmup")
    p.add_argument("--no-hlo", action="store_true",
                   help="skip capturing entries as CUDA graphs (graph "
                        "passes only)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu for "
                        "the plain versions")
    args = p.parse_args(argv)

    entries = tuple(args.entry or ("serve", "train"))
    configs = tuple(args.config or ("bert-base-sten",))

    reports = []
    for arch in configs:
        reports.append(run_check(
            entries, arch=arch, hlo=not args.no_hlo,
            differential=args.differential, ignore=tuple(args.ignore),
            device=args.device,
        ))

    merged = reports[0]
    for r in reports[1:]:
        merged.programs.extend(r.programs)
        merged.extend(r.diagnostics)

    rendered = merged.render()
    if rendered:
        print(rendered)
    print(merged.summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(merged.to_json(), f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return merged.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
