#!/usr/bin/env python3
"""Where the wall time of a replayed decode chunk goes, on the card.

    python3 scripts/graph_gaps.py [--arch bert-base-sten|qwen1.5-4b|
        mamba2-370m|hymba-1.5b] [--reps 10]

For each served configuration of the architecture (bert-base-sten: dense,
n:m:g 1:4:8 gr64 on the FFN, gr64 and gr16 with ``attn=True``;
qwen1.5-4b and hymba-1.5b: dense and gr64 with ``attn=True``;
mamba2-370m: dense and gr64 on its mixer's projections,
``chip_smoke.py:ssm_sparsify``), at full width with seeded random
weights, the engine's 8-step chunk program at 4 slots
(``serve/graphs.py:DecodeGraph``) is captured and then replayed:

- host phases of one ``DecodeGraph.run`` plus the token fetch (medians
  over ``--reps``): the input copy, the replay's enqueue
  (``cudaGraphLaunch``), the wait for the device, the fetch; and the
  device span of the replay from CUDA events recorded around it;
- one replay under ``torch.profiler``: the kernels' busy time, the span
  from the first kernel's start to the last one's end, and the idle time
  between consecutive kernels, in total and by the kind of kernel that
  follows the gap (the port's CUDA kernels, cuBLAS, PyTorch's own), with
  the largest gaps, and the kernels that take the most busy time, by
  name; then the host phases again, after that profiler session.

With ``--launch-cost`` it instead times the host's ``cudaGraphLaunch``
of graphs of 256 launches of one kind: the decode GEMV (bf16, 1:4:8
gr64, R = 2560, M = 4) at K = 6912, whose K parts run as one
thread-block cluster (``cudaLaunchKernelEx``), and at K = 512, one part
and a plain launch; and ``torch.matmul`` at the same shapes; each before
and after one ``torch.profiler`` session in the process.

Prints one line per configuration and writes the details to
``chiprun_out/graph_gaps_<arch>.json``.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def kind_of(name: str) -> str:
    if "nmg_" in name or "nm_mask" in name or "matmul_threshold" in name:
        return "port"
    if name.startswith(("nvjet", "sm90_", "cutlass", "gemm", "gemv")) or \
            "gemm" in name or "gemv" in name:
        return "cublas"
    return "torch"


def timeline(fn) -> list:
    """(start_us, end_us, name) of every device kernel of one call of
    ``fn`` under torch.profiler, sorted by start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "Memcpy" not in e.name \
                and "Memset" not in e.name:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def gaps(tl: list) -> dict:
    busy = sum(e - s for s, e, _ in tl)
    span = tl[-1][1] - tl[0][0]
    by_kind, idle, top = {}, 0.0, []
    end = tl[0][1]
    for s, e, name in tl[1:]:
        gap = max(0.0, s - end)
        idle += gap
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + gap
        top.append((gap, name[:60]))
        end = max(end, e)
    counts, by_name = {}, {}
    for s, e, name in tl:
        counts[kind_of(name)] = counts.get(kind_of(name), 0) + 1
        n, us = by_name.get(name[:60], (0, 0.0))
        by_name[name[:60]] = (n + 1, us + e - s)
    top.sort(reverse=True)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels": len(tl), "kernels_by_kind": counts,
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_ms": idle / 1e3,
            "idle_before_ms": {k: v / 1e3 for k, v in by_kind.items()},
            "idle_us_per_kernel": idle / max(1, len(tl) - 1),
            "largest_gaps_us": [(round(g, 2), n) for g, n in top[:6]],
            "top_kernels": [{"name": n, "count": c, "busy_ms": us / 1e3}
                            for n, (c, us) in heavy]}


def measure(cfg, params, label: str, reps: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.engine import _decode_chunk_fn
    from repro_torch.serve.graphs import DecodeGraph

    B, T = 4, 8
    rng = np.random.default_rng(2)
    cache = init_cache(cfg, B, 96, device="cuda")
    for slot in range(B):
        prefill_into_slot(params, cfg, torch.as_tensor(
            rng.integers(0, cfg.vocab, (1, 32)), dtype=torch.int32,
            device="cuda"), cache, slot)
    g = DecodeGraph(_decode_chunk_fn(cfg, T), params, cache, B)
    tok, pos = np.zeros(B, np.int32), np.full(B, 40, np.int32)
    g.run(tok, pos).cpu()                    # eager run, then the capture
    for _ in range(3):
        g.run(tok, pos).cpu()
    io = torch.from_numpy(np.stack([tok, pos]))
    med = run_phases(g, io, reps)

    def one():
        g._io.copy_(io)
        g.graph.replay()
        g.out.cpu()

    tl = gaps(timeline(one))
    return {"label": label, "phases_ms": med, "profile": tl,
            "phases_after_profile_ms": run_phases(g, io, reps),
            "nodes_per_chunk": tl["kernels"]}


def run_phases(g, io, reps: int) -> dict:
    """Medians of the host phases of a replay and its event span."""
    import torch

    phases = {k: [] for k in ("copy", "enqueue", "wait", "fetch", "wall",
                              "event_span")}
    for _ in range(reps):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        g._io.copy_(io)
        t1 = time.perf_counter()
        ev0.record()
        g.graph.replay()
        ev1.record()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        g.out.cpu()
        t4 = time.perf_counter()
        for k, v in (("copy", t1 - t0), ("enqueue", t2 - t1),
                     ("wait", t3 - t2), ("fetch", t4 - t3),
                     ("wall", t4 - t0)):
            phases[k].append(v * 1e3)
        phases["event_span"].append(ev0.elapsed_time(ev1))
    return {k: statistics.median(v) for k, v in phases.items()}


def launch_cost(reps: int) -> list:
    """Host ms of one ``cudaGraphLaunch`` (median over ``reps``) of a graph
    of 256 launches, and its device span from CUDA events."""
    import torch

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_gemv
    from repro_torch.kernels.nmg_gemv import row_plan

    out, graphs = [], []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for K in (6912, 512):
        dense = torch.randn(K, 2560, device="cuda", generator=gen)
        w = dense_to_grouped_nm(dense, 1, 4, 8, gr=64, sparse_dim=0).to(
            "cuda", torch.bfloat16)
        x = torch.randn(K, 4, device="cuda", generator=gen).to(
            torch.bfloat16)
        plan = row_plan(64, 4, w.val.shape[1] * w.val.shape[2],
                        torch.bfloat16)
        wd = dense.to(torch.bfloat16)
        for kind, fn in (("gemv", lambda w=w, x=x: nmg_gemv.nmg_gemv(
                w, x, out_dtype=torch.bfloat16)),
                         ("matmul", lambda wd=wd, x=x: wd.T @ x)):
            fn()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                fn()
            torch.cuda.current_stream().wait_stream(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                for _ in range(256):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            # the graph holds raw pointers: keep its operands alive
            graphs.append((kind, K, plan.parts, g, (w, x, wd)))
    for when in ("before", "after"):
        if when == "after":   # one profiler session over one replay
            timeline(graphs[0][3].replay)
        for kind, K, parts, g, _ in graphs:
            host, span = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t0 = time.perf_counter()
                g.replay()
                host.append((time.perf_counter() - t0) * 1e3)
                e1.record()
                torch.cuda.synchronize()
                span.append(e0.elapsed_time(e1))
            out.append({"kind": kind, "K": K, "parts": parts,
                        "profiler_run": when,
                        "launch_ms": statistics.median(host),
                        "span_ms": statistics.median(span)})
    return out


def configs(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    cfg = get_config(arch)
    params = init_lm(cfg, seed=0, device="cuda")
    yield cfg, params, "dense"
    if cfg.attn_type == "none":
        from chip_smoke import ssm_sparsify

        yield cfg, ssm_sparsify(params, 64), "sparse_ssm"
        return
    if arch == "bert-base-sten":
        yield cfg, sparsify_for_serving(params, 1, 4, 8, gr=64), "sparse_ffn"
    yield cfg, sparsify_for_serving(params, 1, 4, 8, gr=64, attn=True), \
        "sparse_attn"
    if arch == "bert-base-sten":
        yield cfg, sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True), \
            "sparse_attn_gr16"


def main(argv=None) -> int:
    import subprocess

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="bert-base-sten",
                    choices=["bert-base-sten", "qwen1.5-4b", "mamba2-370m",
                             "hymba-1.5b"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--launch-cost", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_gaps: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.launch_cost:
        rows = launch_cost(args.reps)
        for r in rows:
            print(f"graph of 256 x {r['kind']} K={r['K']} (parts "
                  f"{r['parts']}), {r['profiler_run']} a profiler session, "
                  f"on {card}: cudaGraphLaunch "
                  f"{r['launch_ms']:.3f} ms host "
                  f"({r['launch_ms'] * 1e3 / 256:.2f} us a node), device "
                  f"span {r['span_ms']:.3f} ms")
        return 0
    results = []
    for cfg, params, label in configs(args.arch):
        r = measure(cfg, params, label, args.reps)
        results.append(r)
        p, t = r["phases_ms"], r["profile"]
        print(f"{args.arch} {label} on {card}: wall {p['wall']:.3f} ms = "
              f"copy {p['copy']:.3f} + enqueue {p['enqueue']:.3f} + wait "
              f"{p['wait']:.3f} + fetch {p['fetch']:.3f}; event span "
              f"{p['event_span']:.3f}; profiled: {t['kernels']} kernels, "
              f"busy {t['busy_ms']:.3f}, span {t['span_ms']:.3f}, idle "
              f"{t['idle_ms']:.3f} ({t['idle_us_per_kernel']:.2f} us a "
              f"kernel; before " + ", ".join(
                  f"{k} {v:.3f}" for k, v in t["idle_before_ms"].items())
              + f"); largest gaps {t['largest_gaps_us'][:3]}; most busy "
              + ", ".join(f"{k['name'][:40]} x{k['count']} "
                          f"{k['busy_ms']:.3f} ms"
                          for k in t["top_kernels"][:5]))
        a = r["phases_after_profile_ms"]
        print(f"    after its profiler session: wall {a['wall']:.3f} ms, "
              f"enqueue {a['enqueue']:.3f}, event span "
              f"{a['event_span']:.3f}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"graph_gaps_{args.arch}.json").write_text(json.dumps(
        {"card": card, "arch": args.arch, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
