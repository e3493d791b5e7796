"""Serving CLI of the port, engine mode (port of the ``--engine`` mode of
``repro/launch/serve.py``): a queue of synthetic requests is served
through the slot engine, dense or, with ``--sparse``, dense and n:m:g side
by side.

    python -m repro_torch.launch.serve --arch bert-base-sten --engine --sparse
    python -m repro_torch.launch.serve --arch qwen1.5-4b --engine --sparse \
        --nm 1:4:8

runs on the card; ``--device cpu`` runs the plain versions on the CPU
(with ``--smoke`` for a size the CPU can take).  ``--tuning-table PATH``
(or ``$REPRO_TUNE_TABLE``) routes through a table of ``python -m
repro_torch.tune``; ``--tune`` tunes the served shapes in the warmup.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import init_lm
from repro_torch.serve import Request, SamplingParams, ServeEngine, \
    compare_dense_sparse, warmup_engine
from repro_torch.tune import load_table_cli
from repro_torch.tune.table import device_kind

__all__ = ["main", "make_requests"]


def make_requests(cfg, n: int, prompt_len: int, gen_len: int,
                  seed: int) -> list:
    """Synthetic requests with prompt lengths stepping down from
    ``prompt_len`` (so admission happens mid-stream), tokens from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = max(4, prompt_len - (i % 4) * 2)
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, plen, dtype=np.int32),
            max_new_tokens=gen_len,
            sampling=SamplingParams(greedy=True, seed=i)))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-base-sten")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="serve dense and n:m:g weights side by side")
    ap.add_argument("--nm", default="1:4:16", help="n:m:g for --sparse")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(the only mode ported)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8)
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
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("only --engine mode is ported")
    if args.tune and args.no_warmup:
        # tuning runs inside the warmup, before the programs are built;
        # without it the run would serve default routing reported as tuned
        ap.error("--tune requires the warmup pass; drop --no-warmup")

    device = resolve_device(args.device)
    # --tuning-table or $REPRO_TUNE_TABLE, before any model is built
    load_table_cli(args.tuning_table, device=device_kind(device))
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_lm(cfg, args.seed, device=device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen_len,
                         args.seed)
    ekw = dict(max_slots=args.max_slots,
               max_seq_len=args.prompt_len + args.gen_len,
               decode_chunk=args.decode_chunk, device=device)
    warm = not args.no_warmup
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
    print(f"served {n_served} requests through {args.max_slots}-slot "
          f"continuous batching on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
