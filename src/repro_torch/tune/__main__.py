"""Offline tuner CLI (port of ``python -m repro.tune``).

    PYTHONPATH=src python -m repro_torch.tune [--quick] [--out tune_table.json]

Runs the measurement grid on the card (``--device cpu``: on the CPU,
through the plain versions) and writes (merges) that device's section of
the JSON tuning table:

* the GEMV/SpMM crossover (``decode_m_max``) per (shape bucket, n:m:g,
  gr, dtype), with the ``matmul_latency`` entries of the same sweep,
* lossless layout-conversion costs (``convert_cost/...``) for the
  dispatcher's tie-breaker,
* the fused-QKV decision (``fused_qkv``) at the reference's fig11
  serving shapes,
* on the card: the decode body's ``{rows, parts}`` (``gemv_cuda/...``)
  and the SpMM's K split (``spmm_cuda/...``), in bf16;
* on the CPU: the plain SpMM's block cap (``spmm_block_elems``), a knob
  of the plain version, which the card's path does not run.

``--quick`` shrinks the grid (a few shapes, fewer repetitions); the
table is still valid, only coarser.  Load a table with
``--tuning-table`` on ``repro_torch.launch.serve`` / ``train`` or with
``$REPRO_TUNE_TABLE``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.tune import bench, routing
from repro_torch.tune.table import SCHEMA_VERSION, TuningTable, bucket, \
    device_kind, dtype_name, shape_key

DEFAULT_OUT = "tune_table.json"

# (K, R) probe shapes: serving FFN projections small and large; the
# (256, 4096) / (4096, 256) pair is the reference's fig11 smoke wi / wo
SHAPES_QUICK = ((256, 4096), (4096, 256))
SHAPES_FULL = ((256, 256), (1024, 1024), (256, 4096), (4096, 256),
               (1024, 4096), (4096, 1024))

# (n, m, g, gr): the serving default plus 2:4 row-shared and the paper's
# per-fiber format
FMTS_QUICK = ((1, 4, 8, 64),)
FMTS_FULL = ((1, 4, 8, 64), (2, 4, 16, 64), (1, 4, 16, 1))

MS_QUICK = (1, 4, 8, 16, 32, 64)
MS_FULL = (1, 2, 4, 8, 16, 24, 32, 48, 64, 128)

#: (K, R, M, N) of the kernel-config sweeps on the card: decode width M,
#: prefill width N
CUDA_CONFIG_SHAPES = ((1024, 1024, 8, 256),)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--quick", action="store_true",
                    help="small grid (fewer shapes, formats, reps)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="tuning-table JSON path (sections for other "
                         "devices in an existing file are kept)")
    ap.add_argument("--cuda-configs", action="store_true",
                    help="sweep the CUDA kernels' configs (gemv_cuda, "
                         "spmm_cuda); the default on the card, and an "
                         "error without one")
    ap.add_argument("--skip-convert", action="store_true",
                    help="skip the layout-conversion cost sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if args.cuda_configs and not on_card:
        ap.error("--cuda-configs times the CUDA kernels, which need a card")

    shapes = SHAPES_QUICK if args.quick else SHAPES_FULL
    fmts = FMTS_QUICK if args.quick else FMTS_FULL
    ms = MS_QUICK if args.quick else MS_FULL
    dtypes = (torch.float32,) if args.quick else (torch.float32,
                                                  torch.bfloat16)
    reps = 3 if args.quick else 7

    table = TuningTable.for_device(device_kind(device))
    t0 = time.time()
    print(f"repro_torch.tune: device {table.device}, "
          f"{'quick' if args.quick else 'full'} grid")

    print("decision,key,value")
    for (K, R) in shapes:
        for (n, m, g, gr) in fmts:
            for dt in dtypes:
                crossover = bench.tune_decode_threshold(
                    table, K=K, R=R, fmt=(n, m, g), gr=gr, dtype=dt,
                    ms=ms, reps=reps, device=device)
                key = shape_key("decode_m_max", K=K, R=R, fmt=(n, m, g),
                                gr=gr, dtype=dt)
                print(f"decode_m_max,{key},{crossover}")

    if on_card:
        print("spmm_block_elems,skipped,(a knob of the plain SpMM, which "
              "the card's path does not run)")
    else:
        blk = bench.tune_spmm_block(
            table, reps=reps, device=device,
            candidates=(1 << 20, 1 << 22) if args.quick
            else (1 << 18, 1 << 20, 1 << 22, 1 << 24))
        print(f"spmm_block_elems,spmm_block_elems,{blk}")

    if not args.skip_convert:
        for k, us in bench.tune_conversion_costs(table, reps=reps,
                                                 device=device).items():
            print(f"convert_cost,{k},{us:.1f}")

    # the fused route is the shipped default: this confirms it or vetoes
    for dt in dtypes:
        win = bench.tune_fused_qkv(table, reps=reps, dtype=dt, device=device)
        print(f"fused_qkv,fig11-shapes/{dtype_name(dt)},{win}")

    if on_card:
        for K, R, M, N in CUDA_CONFIG_SHAPES:
            for (n, m, g, gr) in fmts:
                cfg = bench.tune_gemv_cuda(
                    table, K=K, R=R, M=M, fmt=(n, m, g), gr=gr,
                    reps=max(1, reps // 2), device=device)
                key = routing.gemv_cuda_key(K=K, fmt=(n, m, g), gr=gr,
                                            dtype=torch.bfloat16)
                print(f"gemv_cuda,{key},{json.dumps(cfg)}")
                if gr % 64:
                    continue
                scfg = bench.tune_spmm_cuda(
                    table, K=K, R=R, Ns=(N,), fmt=(n, m, g), gr=gr,
                    reps=max(1, reps // 2), device=device)
                key = shape_key("spmm_cuda", K=K, R=R, fmt=(n, m, g),
                                gr=gr, dtype=torch.bfloat16)
                print(f"spmm_cuda,{key},{json.dumps(scfg)}")
    else:
        print("gemv_cuda,skipped,(no card: the CUDA kernels need one)")
        print("spmm_cuda,skipped,(no card: the CUDA kernels need one)")

    table.meta.update({
        "generated_by": "python -m repro_torch.tune"
                        + (" --quick" if args.quick else ""),
        "schema": SCHEMA_VERSION,
        "elapsed_s": round(time.time() - t0, 2),
        "shapes": [[bucket(K), bucket(R)] for K, R in shapes],
    })
    table.save(args.out)
    print(f"wrote {len(table)} entries for {table.device} to {args.out} "
          f"in {table.meta['elapsed_s']}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
