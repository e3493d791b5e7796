"""Serving CLI of the port (port of ``repro/launch/serve.py``).  Two
modes:

* one-shot (without ``--engine``): :func:`run_oneshot`, prefill then
  greedy ``decode_step`` over one batch of ``--batch`` prompts (eager),
  with ``--sparse`` on n:m:g FFN weights;
* ``--engine``: a queue of synthetic requests is served through the
  engine, dense or, with ``--sparse``, dense and n:m:g side by side,
  over the slot KV cache or, with ``--paged``, the paged one
  (``--page-size``, which must divide prompt-len + gen-len,
  ``--num-pages``, ``--no-prefix-sharing``); with ``--slo-tpot-ms`` /
  ``--tiers`` through the SLO control loop (resident sparsity tiers,
  default ``dense,1:4:8-gr64``; ``--slo-ttft-ms`` for the attainment
  metric; ``--faults`` injects the seeded fault schedule), every tier's
  programs built by ``ServeEngine.warm_tiers`` first.

``--trace PATH`` turns the ``repro_torch.obs`` flight recorder on and
writes a Chrome/Perfetto trace to PATH at exit (``python -m
repro_torch.obs validate PATH`` checks it).  ``--check`` runs the static
checker's serve entry (``repro_torch.check.preflight``, after the tuning
table is loaded) first and exits 1 on an ERROR.  ``--arrival-gap S``
spaces the synthetic requests' arrivals S seconds apart (request i
arrives at i * S).

    python -m repro_torch.launch.serve --arch bert-base-sten --engine --sparse
    python -m repro_torch.launch.serve --arch qwen1.5-4b --engine --sparse \
        --nm 1:4:8
    python -m repro_torch.launch.serve --arch starcoder2-15b --engine --sparse
    python -m repro_torch.launch.serve --arch gemma2-9b --engine --sparse
    python -m repro_torch.launch.serve --arch paligemma-3b --engine --sparse
    python -m repro_torch.launch.serve --arch minicpm3-4b --engine --sparse
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --engine
    python -m repro_torch.launch.serve --arch mamba2-370m --engine
    python -m repro_torch.launch.serve --arch hymba-1.5b --engine --sparse
    python -m repro_torch.launch.serve --arch qwen1.5-4b --engine --paged
    python -m repro_torch.launch.serve --arch qwen1.5-4b --engine \
        --tiers dense,2:4,1:4:8-gr64 --slo-tpot-ms 14 --faults --trace t.json
    python -m repro_torch.launch.serve --arch bert-base-sten --batch 4

runs on the card (gemma2-9b's local layers keep a ring cache of its
4096-token window, so ``--prompt-len`` may exceed it; paligemma-3b's
synthetic requests are text alone, since an image prefix is admitted
through ``prefill_into_slot(prefix_embeds=)``, not the engine; minicpm3-4b
caches MLA's compressed latent; for a MoE model, moonshot-v1-16b-a3b or
arctic-480b at ``--smoke``, ``--sparse`` serves a copy with nothing
converted, as the reference's does: its conversion leaves attention
dense and no glob matches an expert; likewise for mamba2-370m, whose
layers hold no ``attn`` or ``mlp`` leaf; hymba-1.5b's ``--sparse``
converts its attention and MLP, not its SSM mixer, and its all-local
layers keep a full-length cache attended over the 2048-token window;
an SSM model serves prompts of at least its ``conv_width - 1`` = 3
tokens; whisper-large-v3, an enc-dec model, exits non-zero: the engine
takes no encoder frames); ``--device cpu``
runs the plain versions on the CPU (with ``--smoke`` for a size the CPU
can take).  ``--tuning-table PATH``
(or ``$REPRO_TUNE_TABLE``) routes through a table of ``python -m
repro_torch.tune``; ``--tune`` tunes the served shapes in the warmup.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_lm, prefill
from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY
from repro_torch.serve import FaultConfig, FaultInjector, Request, \
    SamplingParams, ServeEngine, SLOConfig, compare_dense_sparse, \
    sparsify_for_serving, trace_events, warmup_engine
from repro_torch.serve.engine import check_servable
from repro_torch.tune import load_table_cli
from repro_torch.tune.table import device_kind

__all__ = ["main", "make_requests", "run_oneshot"]


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_oneshot(params, cfg, prompts: torch.Tensor, gen_len: int):
    """The reference's single-batch loop: prefill ``prompts`` [B, S] into
    a fresh cache of ``S + gen_len`` rows, then greedy ``decode_step``
    eagerly (the reference jits one step; no graph here).  Returns
    (generated tokens [B, gen_len], prefill seconds, decode seconds)."""
    B, S = prompts.shape
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, prompts, cache_len=S + gen_len)
    _sync(logits)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        pos = torch.tensor(S + i, dtype=torch.int32, device=prompts.device)
        logits, cache = decode_step(params, cfg, tok, cache, pos)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(tok)
    return torch.cat(out, dim=1), t_prefill, time.perf_counter() - t0


def make_requests(cfg, n: int, prompt_len: int, gen_len: int,
                  seed: int, arrival_gap: float = 0.0) -> list:
    """Synthetic requests with prompt lengths stepping down from
    ``prompt_len`` (so admission happens mid-stream), tokens from a
    seeded numpy generator; request ``i`` arrives at ``i *
    arrival_gap`` seconds."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = max(4, prompt_len - (i % 4) * 2)
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, plen, dtype=np.int32),
            max_new_tokens=gen_len,
            sampling=SamplingParams(greedy=True, seed=i),
            arrival_time=i * arrival_gap))
    return reqs


def _run_slo_engine(args, cfg, params, reqs, ekw, warm) -> int:
    """``--engine`` with the SLO control loop: resident sparsity tiers,
    the hysteresis ladder, optionally the seeded fault schedule."""
    tiers = [t.strip() for t in (args.tiers or "dense,1:4:8-gr64").split(",")
             if t.strip()]
    slo = SLOConfig(
        tpot_ms=args.slo_tpot_ms if args.slo_tpot_ms is not None else 50.0,
        ttft_ms=args.slo_ttft_ms)
    faults = None
    if args.faults:
        faults = FaultInjector(FaultConfig(
            seed=args.seed, spike_prob=0.02, error_prob=0.02,
            slow_windows=((20, 40, 3.0),)))
    eng = ServeEngine(params, cfg, slo=slo, tiers=tiers, faults=faults,
                      **ekw)
    if warm:
        eng.warm_tiers(sorted({int(r.prompt.size) for r in reqs}))
    built_after_warm = dict(trace_events())
    eng.run(reqs)
    print(eng.metrics(label="slo").report())
    print(f"tiers: {', '.join(tiers)} | tier switches "
          f"{eng.stats['tier_switches']} | shed {eng.stats['shed']} | "
          f"timeout {eng.stats['timeout']} | fault retries "
          f"{eng.stats['fault_retries']}")
    new_builds = {k: v - built_after_warm.get(k, 0)
                  for k, v in trace_events().items()
                  if v != built_after_warm.get(k, 0)}
    if new_builds:
        print(f"WARNING: serving built programs after warmup: {new_builds}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-base-sten")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="serve dense and n:m:g weights side by side")
    ap.add_argument("--nm", default="1:4:16", help="n:m:g for --sparse")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of the one-shot batch")
    ap.add_argument("--engine", action="store_true",
                    help="serve a request queue through the "
                         "continuous-batching engine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="seconds between request arrivals (--engine)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page-table indirection + "
                         "copy-on-write prefix sharing) instead of one "
                         "full-length row per slot")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged); must divide "
                         "prompt-len + gen-len")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (--paged); default sizes the "
                         "pool to the slot cache's KV footprint")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="--paged: disable content-hash prefix sharing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--tuning-table", default=None, metavar="PATH",
                    help="load a tuning table (written by `python -m "
                         "repro_torch.tune`) so kernel routing uses its "
                         "measured decisions; $REPRO_TUNE_TABLE otherwise")
    ap.add_argument("--tune", action="store_true",
                    help="tune the served shapes' kernel routing in the "
                         "warmup, before the engine's programs are built")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="--engine mode: enable the SLO control loop with "
                         "this per-token-latency objective (hysteresis "
                         "ladder: defer admissions -> sparser weight tier "
                         "-> shed)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="optional time-to-first-token objective for the "
                         "SLO attainment metric")
    ap.add_argument("--tiers", default=None,
                    help="comma-separated sparsity tiers, densest first "
                         "(e.g. 'dense,2:4,1:4:8-gr64'); implies the SLO "
                         "control loop (default SLO if --slo-tpot-ms is "
                         "not given)")
    ap.add_argument("--faults", action="store_true",
                    help="--engine mode with SLO loop: inject the seeded "
                         "fault schedule (latency spikes, slow-decode "
                         "windows, retried transient errors)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the repro_torch.obs flight recorder and "
                         "write a Chrome/Perfetto trace (request "
                         "lifecycles, controller decisions, fault "
                         "injections, kernel routes) to PATH on exit")
    ap.add_argument("--check", action="store_true",
                    help="run the repro_torch.check static verifier over "
                         "the serve entry before doing anything; abort on "
                         "ERROR diagnostics")
    args = ap.parse_args(argv)
    if args.paged and not args.engine:
        ap.error("--paged requires --engine (the one-shot path has no "
                 "slot scheduler to page)")
    if (args.slo_tpot_ms is not None or args.tiers or args.faults) \
            and not args.engine:
        ap.error("--slo-tpot-ms/--slo-ttft-ms/--tiers/--faults require "
                 "--engine (the SLO control loop runs the continuous-"
                 "batching scheduler)")
    if args.faults and args.slo_tpot_ms is None and not args.tiers:
        ap.error("--faults needs the SLO control loop; pass --slo-tpot-ms "
                 "and/or --tiers")
    if args.tune and not args.engine:
        # the one-shot path has no warmup to tune in
        ap.error("--tune requires --engine")
    if args.tune and args.no_warmup:
        # tuning runs inside the warmup, before the programs are built;
        # without it the run would serve default routing reported as tuned
        ap.error("--tune requires the warmup pass; drop --no-warmup")

    max_seq = args.prompt_len + args.gen_len
    if args.paged and max_seq % args.page_size:
        ap.error(f"--page-size {args.page_size} must divide max_seq_len "
                 f"{max_seq} (prompt-len + gen-len)")

    device = resolve_device(args.device)
    # --tuning-table or $REPRO_TUNE_TABLE, before any model is built
    load_table_cli(args.tuning_table, device=device_kind(device))
    if args.check:
        # after the table load on purpose: R6 must judge the routed
        # configs of the table the run is about to serve under
        from repro_torch.check import preflight

        rc = preflight(("serve",), arch=args.arch, device=device)
        if rc:
            print("repro_torch.check: serve preflight failed — not serving")
            return rc
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    try:
        check_servable(cfg)
    except ValueError as e:
        ap.error(str(e))
    params = init_lm(cfg, args.seed, device=device)
    if args.trace:
        obs.enable()
    try:
        if args.engine:
            return _run_engine(args, cfg, params, device, max_seq)
        return _run_oneshot_cli(args, cfg, params, device)
    finally:
        if args.trace:
            obs.dump(args.trace, registry_snapshot=REGISTRY.snapshot())
            obs.disable()
            print(f"wrote trace to {args.trace}")


def _run_oneshot_cli(args, cfg, params, device) -> int:
    if args.sparse:
        n, m, g = (int(v) for v in args.nm.split(":"))
        params = sparsify_for_serving(params, n, m, g)
        print(f"serving with {n}:{m}:{g} sparse FFN weights")
    B, S, G = args.batch, args.prompt_len, args.gen_len
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S), dtype=np.int32), device=device)
    gen, t_prefill, t_decode = run_oneshot(params, cfg, prompts, G)
    print(f"prefill {S} toks x {B} batch: {t_prefill * 1e3:.1f} ms")
    print(f"decode  {G - 1} steps: {t_decode / max(1, G - 1) * 1e3:.2f} "
          f"ms/token")
    print("sample:", gen[0, :12].cpu().numpy())
    return 0


def _run_engine(args, cfg, params, device, max_seq) -> int:
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen_len,
                         args.seed, args.arrival_gap)
    ekw = dict(max_slots=args.max_slots, max_seq_len=max_seq,
               decode_chunk=args.decode_chunk, device=device)
    if args.paged:
        ekw.update(paged=True, page_size=args.page_size,
                   num_pages=args.num_pages,
                   prefix_sharing=not args.no_prefix_sharing)
    warm = not args.no_warmup
    if args.slo_tpot_ms is not None or args.tiers:
        return _run_slo_engine(args, cfg, params, reqs, ekw, warm)
    if args.sparse:
        n, m, g = (int(v) for v in args.nm.split(":"))
        results = compare_dense_sparse(params, cfg, reqs, nm=(n, m, g),
                                       engine_kwargs=ekw, warmup=warm,
                                       tune=args.tune)
        for _, met in results.values():
            print(met.report())
        d, s = results["dense"][1], results["sparse"][1]
        if d.tok_latency_p50 > 0:
            print(f"sparse/dense per-token p50 ratio: "
                  f"{s.tok_latency_p50 / d.tok_latency_p50:.3f}")
    else:
        eng = ServeEngine(params, cfg, **ekw)
        if warm:
            warmup_engine(eng, reqs, tune=args.tune)
        outs = eng.run(reqs)
        print(eng.metrics(label="dense").report())
        results = {"dense": (outs, None)}
    n_served = len(next(iter(results.values()))[0])
    kind = "paged" if args.paged else "slot"
    print(f"served {n_served} requests through {args.max_slots}-slot "
          f"continuous batching ({kind} KV cache) on {device}")
    if args.paged and not args.sparse:
        kv = eng.kv.stats
        print(f"paged KV: peak {kv['peak_pages_in_use']} pages in use, "
              f"{kv['shared_tokens']} prompt tokens prefix-shared, "
              f"{kv['cow_copies']} copy-on-write page copies, "
              f"{eng.stats['preemptions']} preemptions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
