"""Serving CLI of the port, engine mode (port of the ``--engine`` mode of
``repro/launch/serve.py``): a queue of synthetic requests is served
through the engine, dense or, with ``--sparse``, dense and n:m:g side
by side, over the slot KV cache or, with ``--paged``, the paged one
(``--page-size``, which must divide prompt-len + gen-len,
``--num-pages``, ``--no-prefix-sharing``).

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

import numpy as np

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import init_lm
from repro_torch.serve import Request, SamplingParams, ServeEngine, \
    compare_dense_sparse, warmup_engine
from repro_torch.serve.engine import check_servable
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
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("only --engine mode is ported")
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
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    try:
        check_servable(cfg)
    except ValueError as e:
        ap.error(str(e))
    params = init_lm(cfg, args.seed, device=device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen_len,
                         args.seed)
    ekw = dict(max_slots=args.max_slots, max_seq_len=max_seq,
               decode_chunk=args.decode_chunk, device=device)
    if args.paged:
        ekw.update(paged=True, page_size=args.page_size,
                   num_pages=args.num_pages,
                   prefix_sharing=not args.no_prefix_sharing)
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
