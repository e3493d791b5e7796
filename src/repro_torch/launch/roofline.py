"""Roofline table generator (port of ``repro/launch/roofline.py``): reads
the dry-run JSONs (``launch/dryrun.py``) and prints the per-(arch x
shape x mesh) three-term roofline analysis as markdown, against the H100's
rates (``launch/hw.py``).

With ``--bench BENCH_bench.json`` it also prints the **kernel roofline**
section: every benchmark record carrying a ``roofline_ideal_us`` as
measured-vs-ideal distance.

    python -m repro_torch.launch.roofline [--dir experiments/dryrun] \\
        [--mesh 16x16] [--bench BENCH_bench.json] [--device-kind KIND]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.hw import DEFAULT_HW_KIND, HW_BY_KIND, hw_for_device

__all__ = ["fmt_s", "advice", "load", "table", "kernel_table", "main"]


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1.0:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def advice(rec) -> str:
    dom = rec["roofline"]["dominant"]
    shape = rec["shape"]
    if dom == "memory":
        if "decode" in shape or "long" in shape:
            return "shrink cache bytes/token (int8 KV, window/ring caches)"
        return "cut HBM traffic: fuse, remat less, bf16 intermediates"
    if dom == "collective":
        return "cut NVLink bytes: value-only sparse all-reduce, overlap, " \
               "reduce-scatter instead of all-reduce"
    return "raise tensor-core utilization: bigger per-GPU tiles, less " \
           "padding"


def load(dir_: str, mesh: str | None, tag: str = "baseline"):
    recs = []
    for p in sorted(pathlib.Path(dir_).glob("*.json")):
        r = json.loads(p.read_text())
        if mesh and r.get("mesh") != mesh:
            continue
        if r.get("tag", "baseline") != tag:
            continue
        recs.append(r)
    return recs


def table(recs, *, full: bool = True) -> str:
    lines = [
        "| arch | shape | mesh | compute | memory | collective | dominant |"
        " bound | MODEL_FLOPs/counted | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"SKIP | — | — | {r['skipped']} |"
            )
            continue
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"FAIL | — | — | {r.get('error', '')[:60]} |"
            )
            continue
        t = r["roofline"]
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        ratio = r.get("useful_flops_ratio", 0.0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(t['compute_s'])} | {fmt_s(t['memory_s'])} "
            f"| {fmt_s(t['collective_s'])} | **{t['dominant']}** "
            f"| {fmt_s(bound)} | {ratio:.2f} | {advice(r)} |"
        )
    return "\n".join(lines)


def kernel_table(bench_path: str) -> str:
    """Markdown kernel-roofline section from a ``BENCH_bench.json``: one
    row per record that carries a modelled ``roofline_ideal_us``.
    Distance is measured/ideal, honest only when the benchmark ran on
    the device the constants describe."""
    doc = json.loads(pathlib.Path(bench_path).read_text())
    rows = [r for r in doc.get("results", [])
            if isinstance(r, dict) and "roofline_ideal_us" in r]
    if not rows:
        return f"(no kernel-roofline records in {bench_path})"
    lines = [
        "| kernel | us/call | sequential us | speedup | ideal us |"
        " distance |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['us_per_call']:.1f} "
            f"| {r.get('sequential_us', 0.0):.1f} "
            f"| {r.get('speedup_vs_sequential', 0.0):.2f}x "
            f"| {r['roofline_ideal_us']:.2f} "
            f"| {r['us_per_call'] / r['roofline_ideal_us']:.1f}x |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--bench", default=None,
                    help="BENCH_bench.json to render the kernel-roofline "
                         "section from")
    ap.add_argument("--device-kind", default=DEFAULT_HW_KIND,
                    help="device constants to model against (keys of "
                         f"launch/hw.py:HW_BY_KIND: "
                         f"{', '.join(sorted(HW_BY_KIND))})")
    args = ap.parse_args(argv)
    recs = load(args.dir, args.mesh, args.tag)
    hw, matched = hw_for_device(args.device_kind)
    kind = args.device_kind if matched else DEFAULT_HW_KIND
    if not matched:
        print(f"warning: device kind {args.device_kind!r} has no "
              f"HW_BY_KIND entry; modelling against {DEFAULT_HW_KIND} "
              f"(the repro_torch.check R7 diagnostic flags this too)")
    print(f"hardware ({kind}): {hw['peak_flops_bf16'] / 1e12:.0f} TF/s "
          f"bf16, {hw['hbm_bw'] / 1e9:.0f} GB/s HBM, "
          f"{hw['nvlink_bw'] / 1e9:.0f} GB/s NVLink per GPU\n")
    print(table(recs))
    if args.bench:
        print("\n### kernel roofline\n")
        print(kernel_table(args.bench))


if __name__ == "__main__":
    main()
