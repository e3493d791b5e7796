#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch/CUDA versions; the
   port's CUDA kernels are built from ``src/repro_torch/csrc`` (one nvcc
   per source, started together).
2. Kernel phase, bf16 at the shapes of both served models (bert-base-sten
   and qwen1.5-4b, 1:4:8 gr64) and of the training path (``nm_mask`` 2:4
   on the stacked and per-layer ``mlp.wo`` / ``attn.wo``, 16:32, 5:20,
   special values and a misaligned view, bitwise, each naming the body it
   took; ``matmul_threshold``
   at 1024 tokens x 768 x 3072): each kernel's wrapper against its plain
   PyTorch version on the same inputs (fused QKV bitwise against three
   GEMV launches, the fused gated FFN bitwise against the GEMV followed by
   PyTorch's silu and multiply; every redesigned kernel also bitwise
   against a second launch, and the SpMM's bf16 [N, R] epilogue bitwise
   against its f32 output cast and transposed), then timed with CUDA
   events against the plain version and a library yardstick
   (``torch.matmul`` on the densified weight, plus ``silu(u) * v`` for the
   FFN; the port never calls it).  The decode kernels (GEMV, QKV, FFN, at
   M = 1, 4, 8, 16) report the body and plan they ran (``tc`` at gr64),
   and the tensor-core bodies their registers a thread (``-Xptxas -v``)
   and shared memory a block.  The device L2 is flushed before every
   timed launch: on the serving path a layer's weights are cold when its
   turn comes.
   a. Every gr the reference takes, at bert-base-sten's ``wi`` / ``wq``:
      the GEMV, fused QKV, FFN and SpMM at gr 1, 16 and 24 (the ``tc``
      decode body at 16, the ``general`` one at 1 and 24; the SpMM through
      the GEMV kernel over 16-column chunks) with the same checks.
3. Main paths, each with the launch counts zeroed right before its run
   and read right after:
   a. full-width bert-base-sten (12 layers, d_model 768, d_ff 3072, vocab
      30522, bf16) with seeded random weights serves 8 requests through
      the port's ServeEngine — dense, n:m:g 1:4:8 gr64 on the FFN (fig11's
      setting), n:m:g on FFN and attention (``attn=True``), and the same
      at gr16 (the format the parity tests use on the CPU);
   b. full-width, full-depth qwen1.5-4b (40 layers, d_model 2560, d_ff
      6912 gated, QKV bias, vocab 151936, bf16, seeded random weights)
      serves the same trace dense and n:m:g 1:4:8 gr64 with ``attn=True``;
      every decode-shaped FFN goes through the fused FFN kernel.
   Each configuration is served twice: replaying the engine's programs
   as CUDA graphs (the default: one admission prefill per prompt length
   and the decode chunk) and with ``graphs=False`` (eager), each engine
   warmed first with the trace's prompt lengths, which builds its
   programs (trace events: ``slot_prefill`` 4, ``decode_chunk`` 1, and
   none added by the measured run); token streams and launch counts
   (replays included) must be equal, TTFT p50/p99 is reported both
   ways, and each length's replayed admission is held bitwise against
   eager ``prefill_into_slot``.  Each ``attn=True`` model's prefill and
   decode logits through the kernels are then held against the same
   steps through the plain versions (bert at gr64 and gr16).  The graph
   phase then holds, in all six configurations, the replayed 8-step
   chunk and single step bitwise against the eager programs across an
   admission, and reports the chunk's wall and device time eager and
   replayed, the capture and instantiation cost and the graph pool's
   size.  The prefill phase does the same for the admission programs
   of bert and qwen (dense and ``attn=True`` gr64) at S = 16, 24, 32
   and 64: replay bitwise eager into slots 1 and 3, counts equal, wall
   replayed and eager, device time, capture cost and pool per length.
   c. full-width bert-base-sten trains (bf16, batch 8 x 128 tokens,
      AdamW, GMP): (a) the CLI's default masked path through
      ``repro_torch.launch.train`` (``--sparsity 0.75 --gmp iterative``,
      magnitude-pruned FixedMask leaves, 20 steps); (b) the library API
      with the inline threshold 0.5 on the dense ``mlp.wi`` (the fused
      matmul-threshold kernel in every forward) and NMSparsifier(2, 4)
      FixedMask leaves on ``mlp.wo`` / ``attn.wo`` (the nm_mask kernel at
      the build and at every GMP recompute), 10 steps.  Each run goes
      through the graph trainer (the CLI's default: the step captured once
      as a CUDA graph and replayed, recomputes eager between replays,
      chunks of 5 steps) and through the host loop (``--host-loop``), and
      the two must agree bit for bit (losses, gradient norms, params,
      masks, moments, step counter); the graph run's launch counts are
      the main path's.  After each run, chunks of 5 steps with no
      recompute are timed replayed and eager (and profiled last).  Run
      (b)'s first step is repeated from the same state through the plain
      versions (loss and ``mlp.wi`` gradient compared), also from fresh
      models at three more seeds.
   d. checkpoint and resume at full width: run (a)'s model over 6 steps
      with a checkpoint every 3, then a run resumed from a copy of its
      step-3 checkpoint in a temporary directory must end bit for bit
      where it ended.
   e. the programming model (``repro_torch.sten``): (s1) the library at
      the model's shapes, bf16 — ``NMTensor.from_dense`` through
      ``nm_mask``, ``sten.linear`` / ``sten.matmul`` on n:m:g weights
      through the GEMV and SpMM routes, the fused ``sparsified_op``
      through ``matmul_threshold``, each held to its plain version, and
      the CSR/COO products against dense; (s2) full-width bert-base-sten
      under a plan (masked-dense n:m:g ``mlp.wi``, 2:4 ``mlp.wo``, 2:4 on
      the ``mlp.act`` intermediate, a gradient format on ``attn.wo``):
      five library-API training steps and an eval forward with ``mlp.wo``
      an NMTensor (the lossless NMTensor -> FixedMaskTensor route), held
      to the same run through the plain versions.
   f. tuning (``repro_torch.tune``): ``python -m repro_torch.tune
      --quick`` in a subprocess (its decision lines, its table loaded);
      at bert ``mlp.wi`` / ``mlp.wo`` and qwen ``attn.wq``, packed
      ``mlp.wi`` and ``mlp.wo`` (bf16 1:4:8 gr64) the tuned decode config
      and SpMM split held against the plain versions, and the GEMV and
      SpMM device times at M = 8, 12, 16, 17, 20, 24, 32 with the
      kernels' own configs and the tuned ones, with each crossover; then
      bert and qwen ``attn=True`` gr64 served by an engine warmed with
      ``warmup_engine(..., tune=True)`` beside one with default routing:
      every routed counter ``[table]``, ``predict_route`` equal to one
      replay's counters (decode chunk and each admission), tokens equal
      where no route or config moved and logits within the serve
      phase's bound of the default routing's, a replay bitwise unchanged
      under another table activated after capture, and per-token p50 and
      TTFT p99 tuned and default in turns.
4. Summary: a compact ``{"serve": ..., "train": ...}`` line, a
   ``{"kernels": [...]}`` line (one entry per TPU kernel, naming the body
   and gr it was timed at: serving kernels at qwen1.5-4b shapes with
   launches from its n:m:g run, training kernels at bert-base-sten
   training shapes with launches from run (b)'s graph trainer),
   the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
   Every ``torch.profiler`` session runs after all unprofiled timing
   (one session slows every later launch of the process).
   Details go to ``chiprun_out/chip_smoke.json``.

Any failure raises and the script exits non-zero; without CUDA it exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
REPS = 30
SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's ~1.98 GHz boost clock

# each served model's projections as [K, N] weights (sparse along K):
# which of them the decode GEMV and the prefill SpMM take on its path, the
# prompt widths its SpMM sees, and the packed gated weight of the fused FFN
MODELS = {
    "bert": dict(shapes={"wi": (768, 3072), "wo_ffn": (3072, 768),
                         "wq": (768, 768)},
                 gemv=("wi", "wo_ffn", "wq"), spmm_n=(17, 24, 32, 64, 128),
                 ffn=None),
    "qwen": dict(shapes={"wi": (2560, 13824), "wo_ffn": (6912, 2560),
                         "wq": (2560, 2560)},
                 gemv=("wo_ffn", "wq"), spmm_n=(24, 32, 64), ffn="wi"),
}
DECODE_M = (1, 4, 8, 16)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, flush) -> float:
    """Device time of ``fn``: median of REPS CUDA-event timings, the L2
    flushed before each launch (a 64 MiB write evicts the 50 MB L2).  A
    ~2 ms device spin before each timed launch keeps the device busy while
    the host enqueues the launch, so the events bracket device work only
    and not the host's launch cost (that is ``host_ms``)."""
    import torch

    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_ms(fn, n: int = 50) -> float:
    """Host time to issue one call of ``fn`` (checks, ctypes, launch), with
    the device kept busy so no call waits for it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def timings(kernel, plain, library, flush) -> dict:
    """Device times of the kernel, its plain version and the library
    yardstick (None where no single PyTorch call computes the function),
    and the host cost of issuing the kernel."""
    return {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": None if library is None
            else time_ms(library, flush),
            "host_ms": host_ms(kernel)}


def bound(nbytes: int, flops: int, rate: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def storage_bytes(w) -> int:
    cols = w.gather_plan().cols
    return w.val.numel() * w.val.element_size() + cols.numel() * 4


def _ptxas_entry(lib: str, entry: str) -> dict:
    """Registers a thread and static shared memory of one kernel entry,
    from ``-Xptxas -v``'s report of the library's build."""
    from repro_torch.kernels import _build

    lines = _build.ptxas_log(lib).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            for used in lines[i + 1:i + 8]:
                if "Compiling entry function" in used:
                    break
                m = re.search(r"Used (\d+) registers", used)
                if m:
                    sm = re.search(r"(\d+) bytes smem", used)
                    return {"registers": int(m.group(1)),
                            "static_smem_bytes": int(sm.group(1)) if sm
                            else 0}
    raise RuntimeError(f"ptxas log of {lib} names no entry {entry}")


def spmm_resources(w, b) -> dict:
    """The bf16 SpMM body's block at this shape: warps, n8 tiles, column
    tiles, K splits, registers a thread (ptxas) and shared memory a block
    (its dynamic ring and B buffers)."""
    from repro_torch.kernels import _build

    fn = _build.load("nmg_spmm").nmg_spmm_tc_plan
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = None
    plan = (ctypes.c_int * 6)()
    fn(w.val.shape[0], b.shape[1], w.val.shape[1] * w.val.shape[2], w.gr,
       b.data_ptr(), b.stride(0), b.stride(1), plan)
    warps, nt8, col_tiles, splits, smem, staged = list(plan)
    # the kernel's template arguments: n8 tiles, warps along the rows
    res = _ptxas_entry("nmg_spmm",
                       f"nmg_spmm_tc_kernelILi{nt8}ELi{warps // 2}E")
    return {"warps": warps, "n8_tiles": nt8, "col_tiles": col_tiles,
            "splits": splits, "staged": bool(staged),
            "registers": res["registers"],
            "smem_bytes": smem + res["static_smem_bytes"]}


def rows_resources(lib: str, w, b) -> dict:
    """The decode body the wrappers pick for ``w`` against B (its plan from
    ``row_plan``), with, for the ``tc`` body, registers a thread (ptxas)
    and dynamic shared memory a block of its bf16-output entry."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.nmg_gemv import chunk_geometry, row_plan

    KN = w.val.shape[1] * w.val.shape[2]
    p = row_plan(w.gr, b.shape[1], KN, b.dtype)
    out = {"body": p.body, "gr": w.gr, "tile_rows": p.rows, "parts": p.parts,
           "slabs_per_part": p.per}
    if p.body != "tc":
        return out
    nw = 2 if lib == "nmg_ffn" else 1
    fn = _build.load("nmg_gemv").nmg_rows_tc_smem_bytes
    fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_int
    res = _ptxas_entry(lib, f"{lib}_tc_kernelILi{p.nt8}ELi{p.rows // 16}E"
                       "13__nv_bfloat16")
    return {**out, "warps": p.rows // 16, "n8_tiles": p.nt8,
            "registers": res["registers"],
            "smem_bytes": fn(p.rows, nw, p.nt8, p.per, p.parts, b.data_ptr(),
                             b.stride(0), b.stride(1), *chunk_geometry(w),
                             min(b.shape[1], 16))
            + res["static_smem_bytes"]}


def matmul_threshold_resources() -> dict:
    """The bf16 matmul_threshold body's registers a thread (ptxas) and
    shared memory a block (its ring, reused by the epilogue)."""
    from repro_torch.kernels import _build

    fn = _build.load("matmul_threshold").matmul_threshold_tc_smem_bytes
    fn.restype = ctypes.c_int
    res = _ptxas_entry("matmul_threshold", "matmul_threshold_tc_kernel")
    return {"registers": res["registers"],
            "smem_bytes": fn() + res["static_smem_bytes"]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(gen, model: str) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    spec = MODELS[model]
    shapes = spec["shapes"]
    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def weight(K, N):
        dense = (torch.randn(K, N, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        return dense_to_grouped_nm(dense, 1, 4, 8, gr=64, sparse_dim=0)

    W = {name: weight(K, N) for name, (K, N) in shapes.items()}
    Dq = shapes["wq"][0]
    qkv = [W["wq"], weight(Dq, Dq), weight(Dq, Dq)]
    dense_of = {id(w): w.to_dense() for w in list(W.values()) + qkv}
    cases = []

    def x_of(M, K):
        return torch.randn(M, K, generator=gen, device="cuda").to(bf16)

    def case(kernel, wname, K, N, M, err, tol, fns, nbytes, flops, **kw):
        b, t = bound(nbytes, flops)
        cases.append(dict(kernel=kernel, model=model, weight=wname, K=K, N=N,
                          M=M, max_abs_err=err, tol=tol, **kw,
                          **timings(*fns, flush), bound_ms=b, bound_by=t))

    # GEMV (decode): the main path calls it with B = x.T, a bf16 epilogue
    # and the transposed [M, N] output
    for name in spec["gemv"]:
        w = W[name]
        K, N = shapes[name]
        for M in DECODE_M:
            x = x_of(M, K)
            got32 = nmg_gemv.nmg_gemv(w, x.T, transpose_out=True)
            ref32 = nmg_gemv.nmg_gemv_plain(w, x.T, transpose_out=True)
            err32 = (got32 - ref32).abs().max().item()
            tol32 = 1e-4 * max(1.0, ref32.abs().max().item())
            got = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            ref = nmg_gemv.nmg_gemv_plain(w, x.T, out_dtype=bf16,
                                          transpose_out=True)
            err16 = (got.float() - ref.float()).abs().max().item()
            # one bf16 rounding step of the output on top of the f32 bound
            tol16 = 2 ** -8 * ref.float().abs().max().item() + tol32
            assert err32 <= tol32 and err16 <= tol16, (name, M, err32, err16)
            assert torch.equal(got, nmg_gemv.nmg_gemv(
                w, x.T, out_dtype=bf16, transpose_out=True)), \
                f"GEMV launches disagree ({name}, M={M})"
            wd = dense_of[id(w)]
            case("nmg_gemv", name, K, N, M, err32, tol32,
                 (lambda: nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_gemv.nmg_gemv_plain(w, x.T, out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: torch.matmul(x, wd)),
                 storage_bytes(w) + x.numel() * 2 + M * N * 2,
                 2 * w.val.numel() * M, max_abs_err_bf16_out=err16,
                 bitwise_relaunch=True,
                 **rows_resources("nmg_gemv", w, x.T))

    # fused QKV: one launch over three segments, bitwise equal to three
    wqkv = torch.cat([dense_of[id(w)] for w in qkv], dim=1)
    for M in DECODE_M:
        x = x_of(M, Dq)
        fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        for f, w in zip(fused, qkv):
            seq = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            assert torch.equal(f, seq), "fused QKV differs from 3 launches"
        again = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        assert all(torch.equal(a, f) for a, f in zip(again, fused)), \
            f"fused QKV launches disagree (M={M})"
        plain32 = nmg_fused.nmg_qkv_plain(qkv, x.T, transpose_out=True)
        got32 = nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True)
        err32 = max((g - p).abs().max().item()
                    for g, p in zip(got32, plain32))
        tol32 = 1e-4 * max(1.0, max(p.abs().max().item() for p in plain32))
        assert err32 <= tol32, ("qkv", M, err32)
        case("nmg_qkv", "wq|wk|wv", Dq, 3 * Dq, M, err32, tol32,
             (lambda: nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                        transpose_out=True),
              lambda: nmg_fused.nmg_qkv_plain(qkv, x.T, out_dtype=bf16,
                                              transpose_out=True),
              lambda: torch.matmul(x, wqkv)),
             sum(storage_bytes(w) for w in qkv) + x.numel() * 2
             + 3 * M * Dq * 2, 2 * sum(w.val.numel() for w in qkv) * M,
             bitwise_vs_3_gemv=True, bitwise_relaunch=True,
             **rows_resources("nmg_gemv", qkv[0], x.T))

    # fused gated FFN (decode) on the packed [D, 2F] weight: f32 output
    # against the plain version; the bf16 output the main path takes
    # bitwise against the sequential CUDA path (GEMV, PyTorch's silu, mul)
    if spec["ffn"] is not None:
        w = W[spec["ffn"]]
        K, N2 = shapes[spec["ffn"]]
        Fh = N2 // 2
        wd = dense_of[id(w)]

        def library(x):
            u, v = torch.matmul(x, wd).chunk(2, dim=-1)
            return F.silu(u) * v

        for M in DECODE_M:
            x = x_of(M, K)
            got32 = nmg_fused.nmg_ffn(w, x.T, transpose_out=True)
            ref32 = nmg_fused.nmg_ffn_plain(w, x.T, transpose_out=True)
            err32 = (got32 - ref32).abs().max().item()
            tol32 = 1e-4 * max(1.0, ref32.abs().max().item())
            assert err32 <= tol32, ("ffn", M, err32)
            fused = nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                      transpose_out=True)
            u, v = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                     transpose_out=True).chunk(2, dim=-1)
            assert torch.equal(fused, F.silu(u) * v), \
                "fused FFN differs from GEMV + silu + mul"
            assert torch.equal(fused, nmg_fused.nmg_ffn(
                w, x.T, out_dtype=bf16, transpose_out=True)), \
                f"fused FFN launches disagree (M={M})"
            case("nmg_ffn", spec["ffn"], K, N2, M, err32, tol32,
                 (lambda: nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_fused.nmg_ffn_plain(w, x.T, out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: library(x)),
                 storage_bytes(w) + x.numel() * 2 + M * Fh * 2,
                 2 * w.val.numel() * M, bitwise_vs_sequential=True,
                 bitwise_relaunch=True,
                 **rows_resources("nmg_ffn", w, x.T))

    # SpMM (prefill): B = x.T with N prompt tokens, at every shape the main
    # path gives it.  The f32 [R, N] output against the plain version and
    # against a second launch (bitwise); the main path's form (one cast to
    # bf16, written [N, R]) bitwise against the f32 output cast and
    # transposed, and timed as the main path calls it (``ms``), beside the
    # f32 [R, N] form (``ms_f32_out``, the form of the earlier slices'
    # times)
    for name, (K, R) in shapes.items():
        w = W[name]
        for Ntok in spec["spmm_n"]:
            x = x_of(Ntok, K)
            got = nmg_spmm.nmg_spmm(w, x.T)
            ref = nmg_spmm.nmg_spmm_plain(w, x.T)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, (name, Ntok, err)
            assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T)), \
                f"SpMM launches disagree ({name}, N={Ntok})"
            yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16,
                                   transpose_out=True)
            assert torch.equal(yt, got.to(bf16).T), \
                f"SpMM bf16 [N, R] epilogue differs ({name}, N={Ntok})"
            wd = dense_of[id(w)]
            case("nmg_spmm", name, K, R, Ntok, err, tol,
                 (lambda: nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16,
                                            transpose_out=True),
                  lambda: nmg_spmm.nmg_spmm_plain(w, x.T, out_dtype=bf16,
                                                  transpose_out=True),
                  lambda: torch.matmul(x, wd)),
                 storage_bytes(w) + x.numel() * 2 + R * Ntok * 2,
                 2 * w.val.numel() * Ntok, bitwise_relaunch=True,
                 ms_f32_out=time_ms(lambda: nmg_spmm.nmg_spmm(w, x.T), flush),
                 body="spmm_tc", gr=w.gr, **spmm_resources(w, x.T))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 2a: every gr the reference takes
# ---------------------------------------------------------------------------

ANY_GR = (1, 16, 24)


def any_gr_phase(gen) -> list:
    """The decode kernels and the SpMM at gr 1, 16 and 24, at bert-base-sten's
    ``wi`` ([768, 3072], 1:4:8, bf16; F = 1536 when read as a packed gated
    weight, a multiple of each gr) and its ``wq`` (three of them for the
    fused QKV launch).  gr 16 takes the ``tc`` decode body, gr 1 and 24 the
    ``general`` one; the SpMM routes all three through the GEMV kernel over
    16-column chunks.  Each result against its plain version (f32 output,
    the tolerance of the kernel phase), bitwise against a second launch,
    fused QKV bitwise against three GEMV launches, the FFN bitwise against
    the GEMV followed by PyTorch's silu and multiply, and the SpMM's bf16
    [N, R] output bitwise against its f32 output cast and transposed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    K, R = 768, 3072
    cases = []

    def weight(rows, gr):
        dense = (torch.randn(K, rows, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        return dense_to_grouped_nm(dense, 1, 4, 8, gr=gr, sparse_dim=0)

    def close(got, ref, what):
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert err <= tol, (what, err, tol)
        return err, tol

    for gr in ANY_GR:
        w = weight(R, gr)
        qkv = [weight(K, gr) for _ in range(3)]
        wd = w.to_dense()
        for M in (1, 4, 16):
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
            err, tol = close(nmg_gemv.nmg_gemv(w, x.T, transpose_out=True),
                             nmg_gemv.nmg_gemv_plain(w, x.T,
                                                     transpose_out=True),
                             ("gemv", gr, M))
            y = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16, transpose_out=True)
            assert torch.equal(y, nmg_gemv.nmg_gemv(
                w, x.T, out_dtype=bf16, transpose_out=True)), ("gemv", gr, M)
            fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                      transpose_out=True)
            for f, wq in zip(fused, qkv):
                assert torch.equal(f, nmg_gemv.nmg_gemv(
                    wq, x.T, out_dtype=bf16, transpose_out=True)), \
                    ("qkv vs 3 gemv", gr, M)
            close(torch.cat(nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True),
                            1),
                  torch.cat(nmg_fused.nmg_qkv_plain(qkv, x.T,
                                                    transpose_out=True), 1),
                  ("qkv", gr, M))
            ffn = nmg_fused.nmg_ffn(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            u, v = y.chunk(2, dim=-1)
            assert torch.equal(ffn, F.silu(u) * v), ("ffn vs gemv", gr, M)
            assert torch.equal(ffn, nmg_fused.nmg_ffn(
                w, x.T, out_dtype=bf16, transpose_out=True)), ("ffn", gr, M)
            close(nmg_fused.nmg_ffn(w, x.T, transpose_out=True),
                  nmg_fused.nmg_ffn_plain(w, x.T, transpose_out=True),
                  ("ffn", gr, M))
            if M == 4:
                b, by = bound(storage_bytes(w) + x.numel() * 2 + M * R * 2,
                              2 * w.val.numel() * M)
                cases.append(dict(
                    kernel="nmg_gemv", model="bert-anygr", weight="wi", K=K,
                    N=R, M=M, max_abs_err=err, tol=tol, bound_ms=b,
                    bound_by=by,
                    **rows_resources("nmg_gemv", w, x.T),
                    **timings(lambda: nmg_gemv.nmg_gemv(
                        w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: nmg_gemv.nmg_gemv_plain(
                            w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: torch.matmul(x, wd), flush)))
        for Ntok in (17, 32):
            x = torch.randn(Ntok, K, generator=gen, device="cuda").to(bf16)
            got = nmg_spmm.nmg_spmm(w, x.T)
            err, tol = close(got, nmg_spmm.nmg_spmm_plain(w, x.T),
                             ("spmm", gr, Ntok))
            assert torch.equal(got, nmg_spmm.nmg_spmm(w, x.T)), \
                ("spmm relaunch", gr, Ntok)
            yt = nmg_spmm.nmg_spmm(w, x.T, out_dtype=bf16, transpose_out=True)
            assert torch.equal(yt, got.to(bf16).T), ("spmm [N, R]", gr, Ntok)
            if Ntok == 32:
                b, by = bound(storage_bytes(w) + x.numel() * 2
                              + R * Ntok * 2, 2 * w.val.numel() * Ntok)
                cases.append(dict(
                    kernel="nmg_spmm", model="bert-anygr", weight="wi", K=K,
                    N=R, M=Ntok, max_abs_err=err, tol=tol, bound_ms=b,
                    bound_by=by,
                    **rows_resources("nmg_gemv", w, x.T[:, :16]),
                    **timings(lambda: nmg_spmm.nmg_spmm(
                        w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: nmg_spmm.nmg_spmm_plain(
                            w, x.T, out_dtype=bf16, transpose_out=True),
                        lambda: torch.matmul(x, wd), flush)))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 2b: the training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
THRESHOLD = 0.5


def nm_mask_resources(x, n: int, m: int) -> dict:
    """The ``nm_mask`` body, grid and threads a launch on x takes (and the
    staged body's network slots), its entry's registers a thread (ptxas)
    and shared memory a block (static and dynamic)."""
    import torch

    from repro_torch.kernels import nm_mask as nmk

    plan = nmk.nm_mask_plan(x, n, m)
    t = "f" if x.dtype == torch.float32 else "13__nv_bfloat16"
    entry = {"vector": f"nm_mask_vec_kernelI{t}Li{m}E",
             "staged": f"nm_mask_staged_kernelI{t}Li{plan['slots']}E",
             "long": f"nm_mask_long_kernelI{t}E"}[plan["body"]]
    res = _ptxas_entry("nm_mask", entry)
    return {"body": plan["body"], "grid": plan["grid"],
            "threads": plan["threads"], "slots": plan["slots"],
            "registers": res["registers"],
            "smem_bytes": res["static_smem_bytes"] + plan["smem_bytes"]}


#: magnitudes at the edges of nm_mask's rank rule
SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 2e-39, -2e-39, 1.1754943508222875e-38,
           float("inf"), float("-inf"), float("nan"), 1.0, -0.5, 2.0)


def special_values(shape):
    """bf16 values drawn from SPECIAL, mostly zeros and subnormals, so that
    blocks hold ties among them."""
    import torch

    g = torch.Generator().manual_seed(17)
    p = torch.ones(len(SPECIAL))
    p[:6] = 4.0
    idx = torch.multinomial(p, shape[0] * shape[1], replacement=True,
                            generator=g)
    return torch.tensor(SPECIAL)[idx].reshape(shape).to("cuda",
                                                        torch.bfloat16)


def train_kernel_phase(gen) -> list:
    """The training kernels at run (b)'s shapes, bf16, L2 flushed.
    ``nm_mask`` 2:4 on the stacked leaves run (b) masks along their last
    axis at its recomputes ([12 * 3072, 768] ``mlp.wo``, [12 * 768, 768]
    ``attn.wo``) and on one layer of each (the per-layer build), 16:32 and
    5:20 on the stacked ``mlp.wo``, 2:4 on special values (subnormals,
    NaN, +-0, +-inf) and on the stacked ``mlp.wo`` one element into its
    storage (a misaligned view), each bitwise against its plain version
    and reporting the body it took (``vector``, ``staged`` or ``long``);
    no single PyTorch call computes the n:m mask, so its library time is
    None (``topk`` + ``scatter_`` is timed beside the 2:4 cases for
    reference only).  ``matmul_threshold`` at
    ``mlp.wi``'s shape (1024 tokens x 768 x 3072, t = 0.5, unit-RMS
    activations against the fan-in init): values within 1e-5 of the
    largest, the mask equal except where |y| lies within 1e-5 of t; the
    yardstick is ``torch.matmul`` of the bf16 operands followed by the
    threshold."""
    import torch

    from repro_torch.kernels import fused_sparse_matmul as fsm
    from repro_torch.kernels import nm_mask as nmk

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = []

    def nm_case(wname, x, n, m, **extra):
        """``nm_mask`` on x bitwise against its plain version, the body it
        took, timed; each element read once, its mask byte written once,
        m compares and adds per element on the CUDA cores."""
        assert torch.equal(nmk.nm_mask(x, n, m), nmk.nm_mask_plain(x, n, m)), \
            f"nm_mask {n}:{m} differs from its plain version on {wname}"
        b, by = bound(x.numel() * (x.element_size() + 1), 2 * m * x.numel(),
                      F32_FLOPS)
        cases.append(dict(
            kernel="nm_mask", model="bert-train", weight=wname,
            K=x.shape[-1], N=x.numel() // x.shape[-1], M=0, n_m=f"{n}:{m}",
            max_abs_err=0.0, tol=0.0, bitwise=True,
            **nm_mask_resources(x, n, m), **extra,
            **timings(lambda: nmk.nm_mask(x, n, m),
                      lambda: nmk.nm_mask_plain(x, n, m), None, flush),
            bound_ms=b, bound_by=by))

    # 2:4 on the stacked leaves (the recomputes) and on one layer of each
    # (the per-layer build: 24 of run (b)'s 30 launches)
    for wname, R, fan_in in (("mlp.wo", 12 * 3072, 3072),
                             ("attn.wo", 12 * 768, 768),
                             ("mlp.wo[layer]", 3072, 3072),
                             ("attn.wo[layer]", 768, 768)):
        x = (torch.randn(R, 768, generator=gen, device="cuda")
             / math.sqrt(fan_in)).to(bf16)

        def topk_scatter(x=x):
            blocks = x.abs().reshape(-1, 4)
            idx = torch.topk(blocks, 2, dim=-1).indices
            return torch.zeros(blocks.shape, dtype=torch.bool,
                               device="cuda").scatter_(-1, idx, True)

        nm_case(wname, x, 2, 4, topk_scatter_ms=time_ms(topk_scatter, flush))

    # 16:32 (the vector body's widest block) and 5:20 (the staged body;
    # 768 = 38 x 20 + 8 leaves a ragged last block): bitwise on the stacked
    # mlp.wo and on small integers full of ties
    wo = (torch.randn(12 * 3072, 768, generator=gen, device="cuda")
          / math.sqrt(3072)).to(bf16)
    ties = torch.randint(-2, 3, (3, 16, 131), generator=gen,
                         device="cuda").to(bf16)
    for n, m in ((16, 32), (5, 20)):
        assert torch.equal(nmk.nm_mask(ties, n, m),
                           nmk.nm_mask_plain(ties, n, m)), \
            f"nm_mask {n}:{m} differs from its plain version on ties"
        nm_case("mlp.wo", wo, n, m)
    # the special values (subnormals rank as 0, NaN kept and never counted,
    # +-0, +-inf, the smallest normal) at one layer's mlp.wo, and the
    # stacked mlp.wo one element into its storage (the staged body)
    nm_case("special", special_values((3072, 768)), 2, 4)
    flat = torch.empty(wo.numel() + 1, dtype=bf16, device="cuda")
    flat[1:] = wo.reshape(-1)
    nm_case("mlp.wo+1", flat[1:].view(wo.shape), 2, 4)
    del wo, ties, flat

    M, K, N = TRAIN_TOKENS, 768, 3072
    a = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(K, N, generator=gen, device="cuda")
         / math.sqrt(K)).to(bf16)
    val, mask = fsm.matmul_threshold(a, w, THRESHOLD)
    pv, pm = fsm.matmul_threshold_plain(a, w, THRESHOLD)
    y = a.double() @ w.double()
    diff = mask != pm
    near = (y.abs() - THRESHOLD).abs() <= 1e-5 * max(1.0, THRESHOLD)
    assert not bool((diff & ~near).any()), "threshold mask differs"
    err = (val - pv)[~diff].abs().max().item()
    tol = 1e-5 * max(1.0, pv.abs().max().item())
    assert err <= tol, ("matmul_threshold", err, tol)
    again = fsm.matmul_threshold(a, w, THRESHOLD)
    assert torch.equal(val, again[0]) and torch.equal(mask, again[1]), \
        "matmul_threshold launches disagree"

    def library():
        yy = torch.matmul(a, w)
        keep = yy.abs() >= THRESHOLD
        return yy.float() * keep, keep

    b, by = bound(a.numel() * 2 + w.numel() * 2 + M * N * (4 + 1),
                  2 * M * N * K)
    cases.append(dict(
        kernel="matmul_threshold", model="bert-train", weight="mlp.wi",
        K=K, N=N, M=M, threshold=THRESHOLD, max_abs_err=err, tol=tol,
        mask_flips=int(diff.sum()), kept_share=mask.float().mean().item(),
        bitwise_relaunch=True, **matmul_threshold_resources(),
        **timings(lambda: fsm.matmul_threshold(a, w, THRESHOLD),
                  lambda: fsm.matmul_threshold_plain(a, w, THRESHOLD),
                  library, flush),
        bound_ms=b, bound_by=by))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

KERNELS = ("nmg_gemv", "nmg_qkv", "nmg_spmm", "nmg_ffn")
TRAIN_KERNELS = ("nm_mask", "matmul_threshold")


def reset_counts() -> None:
    from repro_torch.kernels import ops

    ops.reset_kernel_counters()


def read_counts() -> dict:
    """Launches per kernel wrapper, and the routes, from one snapshot of
    both accounts (which count graph replays too)."""
    from repro_torch.kernels import ops

    snap = ops.counter_snapshot()
    counts = dict(snap["launches"])
    counts["routes"] = {f"{k}/{p}": v for (k, p), v in snap["routes"].items()}
    return counts


@contextlib.contextmanager
def plain_versions():
    """Run the model with every kernel wrapper swapped for its plain
    version (on the same CUDA tensors) — the reference side of the
    logit parity check."""
    from repro_torch.kernels.ops import KERNEL_WRAPPERS

    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in KERNEL_WRAPPERS.values()]
    for mod, attr, plain in KERNEL_WRAPPERS.values():
        setattr(mod, attr, getattr(mod, plain))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def requests_for(cfg):
    """The served trace: 8 requests, prompts cycling (32, 24, 64, 16)
    tokens, 32 new tokens each, greedy."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, PROMPT_LENS[i % 4], dtype=np.int32), max_new_tokens=32)
        for i in range(8)]


PROMPT_LENS = (32, 24, 64, 16)
ENGINE_KW = dict(max_slots=4, max_seq_len=max(PROMPT_LENS) + 32,
                 decode_chunk=8, device="cuda")


def serve_phase(cfg, params, label) -> dict:
    """The trace through the engine twice: replaying its programs as CUDA
    graphs (the default: each prompt length's admission and the decode
    chunk) and with ``graphs=False`` (eager).  Each engine is first warmed
    with the trace's prompt lengths (``warmup_engine``), which builds its
    programs: one ``slot_prefill`` trace event per distinct
    length and one ``decode_chunk``; the measured run, with the counts
    zeroed right before it and read right after, must build none.  The
    token streams must be equal, and so must the counts (a replay counts
    the launches it runs).  Then each prompt length's admission, replayed
    into slot 2, is held bitwise against eager ``prefill_into_slot`` on a
    clone of the cache."""
    import numpy as np
    import torch

    from repro_torch.models import prefill_into_slot
    from repro_torch.serve import ServeEngine, warmup_engine
    from repro_torch.serve.tracecount import reset_trace_events, \
        trace_events

    runs = {}
    lens = sorted(set(PROMPT_LENS))
    for mode, graphs in (("graph", True), ("eager", False)):
        kw = dict(ENGINE_KW, graphs=graphs)
        reset_trace_events()
        eng = ServeEngine(params, cfg, **kw)
        warmup_engine(eng, requests_for(cfg))
        built = trace_events()
        assert built == {"slot_prefill": len(lens), "decode_chunk": 1}, \
            (label, mode, built)
        torch.cuda.synchronize()
        reset_counts()
        outs = eng.run(requests_for(cfg))
        torch.cuda.synchronize()
        counts = read_counts()
        assert trace_events() == built, (label, mode, trace_events())
        print(f"serve[{label}, {mode}] trace events: {built} after the "
              f"warm-up, {trace_events()} after the served trace")
        assert len(outs) == 8, f"{label}: {len(outs)} of 8 requests finished"
        for o in outs:
            assert o.finish_reason == "length" and len(o.tokens) == 32, (
                label, mode, o.uid, o.finish_reason, len(o.tokens))
            assert all(0 <= t < cfg.vocab for t in o.tokens)
        assert not any(k.endswith("/plain") for k in counts["routes"]), counts
        assert eng._decode_chunk.info["captured"] == graphs
        pg = eng.kv.prefill_graphs
        assert sorted(pg) == lens, (label, sorted(pg))
        for g in pg.values():
            assert g.info["captured"] == graphs
            assert g.info["replays"] == (2 if graphs else 0), g.info
        runs[mode] = {"metrics": eng.metrics(label=label).to_dict(),
                      "counts": counts, "tokens": [o.tokens for o in outs],
                      "decode_steps": eng.stats["decode_steps"],
                      "chunk_graph": dict(eng._decode_chunk.info),
                      "prefill_graphs": {S: dict(g.info)
                                         for S, g in pg.items()},
                      "trace_events": built}
        if graphs:
            rng = np.random.default_rng(3)
            for S in lens:
                prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
                ref = {k: v.clone() for k, v in eng.kv.data.items()}
                got = eng.kv.write_prefill(params, prompt, 2).clone()
                want, _ = prefill_into_slot(
                    params, cfg, torch.as_tensor(prompt, device="cuda"),
                    ref, 2)
                assert torch.equal(got, want), f"{label}: prefill S={S}"
                for k in ("k", "v"):
                    assert torch.equal(eng.kv.data[k], ref[k]), (label, S, k)
            del ref
        del eng
    g, e = runs["graph"], runs["eager"]
    assert g["tokens"] == e["tokens"], f"{label}: graph and eager streams differ"
    assert g["counts"] == e["counts"], (label, g["counts"], e["counts"])
    return {"label": label, "metrics": g["metrics"],
            "eager_metrics": e["metrics"], "counts": g["counts"],
            "decode_steps": g["decode_steps"],
            "chunk_graph": g["chunk_graph"],
            "prefill_graphs": g["prefill_graphs"],
            "trace_events": g["trace_events"],
            "first_tokens": [t[:4] for t in g["tokens"]]}


def logit_parity(cfg, params, reference=None) -> dict:
    """Prefill (a 32-token prompt: SpMM; a 16-token prompt: GEMV, fused
    QKV and, for a gated MLP, fused FFN) and 4 decode steps, through the
    kernels and through the plain versions (or under ``reference``, a
    context manager, in their place), fed the same tokens.  Bound:
    5% of the largest plain logit — bf16 activations round at ~2**-8
    relative per op, and rounding flips between two summation orders
    compound over the layers.  The argmax must agree at every step unless
    the plain logits' top two lie within one bf16 step of each other (a
    tie at the logits' own resolution, which one flipped rounding
    breaks)."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(1)
    worst, scale, agree, ties, total = 0.0, 0.0, 0, 0, 0
    for S in (32, 16):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")

        def steps(feed=None):
            logits, cache = prefill(params, cfg, toks, cache_len=S + 8)
            out = [logits.float()]
            fed = []
            tok = torch.argmax(logits, -1)[:, None]
            for i in range(4):
                if feed is not None:
                    tok = feed[i]
                fed.append(tok)
                logits, cache = decode_step(params, cfg, tok, cache,
                                            torch.tensor(S + i, device="cuda"))
                out.append(logits.float())
                tok = torch.argmax(logits, -1)[:, None]
            return out, fed

        with (reference or plain_versions)():
            want, fed = steps()
        got, _ = steps(fed)
        for g, w in zip(got, want):
            worst = max(worst, (g - w).abs().max().item())
            scale = max(scale, w.abs().max().item())
            top2 = torch.topk(w, 2, dim=-1).values
            step = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
            tie = (top2[:, 0] - top2[:, 1]) <= step
            same = g.argmax(-1) == w.argmax(-1)
            assert bool((same | tie).all()), "kernel vs plain argmax differ"
            agree += int(same.all())
            ties += int(tie.any())
            total += 1
    tol = 0.05 * scale
    assert worst <= tol, f"kernel vs plain logits differ by {worst} > {tol}"
    return {"max_abs_err": worst, "tol": tol, "max_abs_logit": scale,
            "argmax_agree": f"{agree}/{total}", "top2_ties": ties}


def graph_phase(cfg, params, label) -> dict:
    """The engine's decode programs (``serve/graphs.py``) replayed as CUDA
    graphs against the same programs run eagerly, at 4 slots prefilled
    with 32-token prompts (decode chunk 8):

    - bitwise: three chunks with an admission (a 24-token prefill into
      slot 1) after the first, then two single steps, each replayed on the
      live cache and run eagerly on a clone: tokens, logits and caches
      equal, and a replay's launch counts equal the eager run's;
    - capture: host ms of capture and of instantiation, and the bytes the
      capture added to the graph pool (both programs share one pool);
    - where the time goes: the chunk's wall time (median of 5, ending in
      the token block's host fetch) eager and replayed, the replay's
      device span from CUDA events, and the host time to enqueue one
      chunk eagerly and as one replay; each's device time from
      ``torch.profiler`` (the sum of its kernels' device times), busy
      shares and the eager host cost per launch come from
      :func:`finish_graph` once :func:`run_profiles` has run the
      sessions this phase queues."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.engine import _decode_chunk_fn, _decode_fn
    from repro_torch.serve.graphs import DecodeGraph

    B, T = 4, 8
    rng = np.random.default_rng(2)

    def prompt(n):
        return torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                               dtype=torch.int32, device="cuda")

    cache = init_cache(cfg, B, 96, device="cuda")
    for slot in range(B):
        prefill_into_slot(params, cfg, prompt(32), cache, slot)
    ref = {k: v.clone() for k, v in cache.items()}
    pool = torch.cuda.graph_pool_handle()
    chunk_fn, step_fn = _decode_chunk_fn(cfg, T), _decode_fn(cfg)
    chunk = DecodeGraph(chunk_fn, params, cache, B, pool=pool)
    step = DecodeGraph(step_fn, params, cache, B, pool=pool)
    tok = np.zeros(B, np.int32)
    pos = np.full(B, 32, np.int32)

    def eager(fn, c=ref):
        ops.reset_kernel_counters()
        out = fn(params, torch.as_tensor(tok[:, None], device="cuda"), c,
                 torch.as_tensor(pos, device="cuda"))
        return out, ops.counter_snapshot()

    def held(graph, fn, what):
        ops.reset_kernel_counters()
        got = graph.run(tok, pos).clone()
        replayed = ops.counter_snapshot()
        want, counts = eager(fn)
        assert torch.equal(got, want), f"{label}: replayed {what} differs"
        for k in ("k", "v"):
            assert torch.equal(cache[k], ref[k]), f"{label}: {what} cache"
        assert replayed == counts, (label, what, replayed, counts)
        return got, counts

    for turn in range(3):
        got, chunk_counts = held(chunk, chunk_fn, f"chunk {turn}")
        tok, pos = got[-1].cpu().numpy().copy(), pos + T
        if turn == 0:
            p = prompt(24)
            for c in (cache, ref):
                prefill_into_slot(params, cfg, p, c, 1)
            tok[1], pos[1] = int(got[-1, 1]), 24
    for turn in range(2):
        got, _ = held(step, step_fn, f"step {turn}")
        tok, pos = got.argmax(-1).int().cpu().numpy(), pos + 1
    assert chunk.info["replays"] == 2 and step.info["replays"] == 1

    # timing at fixed inputs (each run rewrites the same cache rows)
    tok, pos = np.zeros(B, np.int32), np.full(B, 40, np.int32)
    tok_d = torch.as_tensor(tok[:, None], device="cuda")
    pos_d = torch.as_tensor(pos, device="cuda")

    def eager_chunk():
        t0 = time.perf_counter()
        chunk_fn(params, tok_d, ref, pos_d).cpu()
        return time.perf_counter() - t0

    def replay_chunk():
        t0 = time.perf_counter()
        chunk.run(tok, pos).cpu()
        return time.perf_counter() - t0

    eager_chunk()
    replay_chunk()
    eager_wall = statistics.median(eager_chunk() for _ in range(5))
    replay_wall = statistics.median(replay_chunk() for _ in range(5))
    # CUDA events around replays: the device span of one chunk, gaps
    # between its kernels included
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for s_, e_ in zip(starts, ends):
        torch.cuda.synchronize()
        s_.record()
        chunk.graph.replay()
        e_.record()
    torch.cuda.synchronize()
    replay_span_ms = statistics.median(
        s_.elapsed_time(e_) for s_, e_ in zip(starts, ends))
    # host time to enqueue one chunk, no sync: eagerly (the device keeps
    # up, so no launch waits for a full queue) and as one replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_fn(params, tok_d, ref, pos_d)
    eager_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk.graph.replay()
    replay_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {
        "label": label, "slots": B, "chunk": T,
        "bitwise": "3 chunks (admission after the first), 2 steps",
        "wrapper_launches_per_chunk": chunk_counts["launches"],
        "chunk_graph": dict(chunk.info), "step_graph": dict(step.info),
        "eager_wall_ms": eager_wall * 1e3,
        "replay_wall_ms": replay_wall * 1e3,
        "replay_event_span_ms": replay_span_ms,
        "eager_enqueue_ms": eager_enqueue_ms,
        "replay_enqueue_ms": replay_enqueue_ms,
        "eager_profile": profile_later(eager_chunk, eager_wall),
        "replay_profile": profile_later(replay_chunk, replay_wall)}


PREFILL_LENS = (16, 24, 32, 64)
TIMED_PREFILLS = 7


def prefill_phase(cfg, params, label) -> dict:
    """The engine's admission programs (``serve/graphs.py:PrefillGraph``,
    one per prompt length S in ``PREFILL_LENS``, sharing one graph pool)
    at 4 slots of 96 rows, each against the same program run eagerly (a
    ``PrefillGraph`` with capture off: the ``graphs=False`` admission):

    - bitwise: the first run (eager on the capture stream, then captured)
      into slot 1 and a replay into slot 3 at offset 8, each against eager
      ``prefill_into_slot`` on a clone of the cache: logits and caches
      equal, and the launch and route counts of each run equal the eager
      run's;
    - capture: host ms of capture and of instantiation, and the bytes the
      capture added to the pool;
    - wall time of one admission (median of ``TIMED_PREFILLS``, each
      ending in the logits' host fetch), replayed and eager, unprofiled,
      and the replay's device span from CUDA events; each's device time
      from ``torch.profiler`` is queued for :func:`run_profiles`."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.cache import _slot_prefill_fn
    from repro_torch.serve.graphs import PrefillGraph

    cache = init_cache(cfg, 4, 96, device="cuda")
    pool = torch.cuda.graph_pool_handle()
    fn = _slot_prefill_fn(cfg)
    rng = np.random.default_rng(4)
    rows = []
    for S in PREFILL_LENS:
        g = PrefillGraph(fn, params, cache, S, pool=pool)
        plain = PrefillGraph(fn, params, cache, S, capture=False)
        for turn, (slot, off) in enumerate(((1, 0), (3, 8))):
            prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)
            ref = {k: v.clone() for k, v in cache.items()}
            ops.reset_kernel_counters()
            got = g.run(prompt, slot, off).clone()
            replayed = ops.counter_snapshot()
            ops.reset_kernel_counters()
            want, _ = prefill_into_slot(
                params, cfg, torch.as_tensor(prompt, device="cuda"), ref,
                slot, write_offset=off)
            counts = ops.counter_snapshot()
            assert torch.equal(got, want), f"{label} S={S}: logits {turn}"
            for k in ("k", "v"):
                assert torch.equal(cache[k], ref[k]), (label, S, turn, k)
            assert replayed == counts, (label, S, turn, replayed, counts)
        del ref
        assert g.info["captured"] and g.info["replays"] == 1
        prompt = rng.integers(0, cfg.vocab, (1, S), dtype=np.int32)

        def timed(prog, prompt=prompt):
            def one():
                t0 = time.perf_counter()
                prog.run(prompt, 1, 0).cpu()
                return time.perf_counter() - t0
            return one

        eager_one, replay_one = timed(plain), timed(g)
        eager_one()
        replay_one()
        eager_wall = statistics.median(
            eager_one() for _ in range(TIMED_PREFILLS))
        replay_wall = statistics.median(
            replay_one() for _ in range(TIMED_PREFILLS))
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for s_, e_ in zip(starts, ends):
            torch.cuda.synchronize()
            s_.record()
            g.graph.replay()
            e_.record()
        torch.cuda.synchronize()
        rows.append({
            "S": S, "launches": counts["launches"],
            "graph": dict(g.info), "eager_wall_ms": eager_wall * 1e3,
            "replay_wall_ms": replay_wall * 1e3,
            "replay_event_span_ms": statistics.median(
                s_.elapsed_time(e_) for s_, e_ in zip(starts, ends)),
            "eager_profile": profile_later(eager_one, eager_wall),
            "replay_profile": profile_later(replay_one, replay_wall)})
    return {"label": label, "slots": 4, "cache_rows": 96,
            "bitwise": "first run (captured) into slot 1, a replay into "
                       "slot 3 at offset 8", "lens": rows}


def report_prefill(phases, card) -> None:
    for p in phases:
        for r in p["lens"]:
            e, rp, gi = r["eager_profile"], r["replay_profile"], r["graph"]

            def busy(prof, wall_ms):
                ms = prof.get("device_busy_ms")
                return ("not measured" if not ms else
                        f"busy {ms:.3f} ms ({ms / wall_ms * 100:.1f}%)")

            r["eager_busy_ms"] = e.get("device_busy_ms")
            r["replay_busy_ms"] = rp.get("device_busy_ms")
            print(f"prefill[{p['label']}] S={r['S']} on {card}: replay "
                  f"bitwise eager; replayed {r['replay_wall_ms']:.3f} ms "
                  f"wall, {busy(rp, r['replay_wall_ms'])}, event span "
                  f"{r['replay_event_span_ms']:.3f} ms; eager "
                  f"{r['eager_wall_ms']:.3f} ms wall, "
                  f"{busy(e, r['eager_wall_ms'])}, {e.get('launches')} "
                  f"launches; capture {gi['capture_ms']:.1f} ms + "
                  f"instantiate {gi['instantiate_ms']:.1f} ms, pool "
                  f"+{gi['pool_bytes'] / 2**20:.1f} MiB; kernels "
                  + " ".join(f"{k[4:]} {r['launches'][k]}" for k in KERNELS))


def finish_graph(p: dict) -> dict:
    """The numbers of a :func:`graph_phase` that read its profiles (after
    :func:`run_profiles`): busy times and shares, launches, host cost per
    launch."""
    e, r = p["eager_profile"], p["replay_profile"]
    busy, busy_from = r["device_busy_ms"], "profiler"
    if not busy:
        busy, busy_from = p["replay_event_span_ms"], "cuda events"
    p.update(
        eager_busy_ms=e["device_busy_ms"],
        eager_busy_share=e["device_busy_share"],
        replay_busy_ms=busy, replay_busy_from=busy_from,
        replay_busy_share=busy / p["replay_wall_ms"],
        replay_over_busy=p["replay_wall_ms"] / busy,
        launches_per_step=e["launches"] / p["chunk"],
        eager_host_us_per_launch=p["eager_enqueue_ms"] * 1e3 / e["launches"],
        eager_top_kernels=e["top_kernels"],
        replay_top_kernels=r["top_kernels"])
    return p


#: profiler sessions, run after every unprofiled timing of the script: one
#: torch.profiler session leaves every later launch in the process slower
#: (the host's enqueue of bert's replayed chunk 0.182 -> 4.323 ms, its
#: wall 14.518 -> 18.744 ms on an H100 80GB HBM3 at 700 W, measured by
#: scripts/graph_gaps.py)
_PROFILES: list = []


def profile_later(fn, wall_s: float, into: dict = None) -> dict:
    """``into`` (a new dict by default), which :func:`run_profiles` fills
    with :func:`device_profile` of ``fn``."""
    into = {} if into is None else into
    _PROFILES.append((fn, wall_s, into))
    return into


def run_profiles() -> None:
    while _PROFILES:
        fn, wall_s, into = _PROFILES.pop(0)
        into.update(device_profile(fn, wall_s))


def device_profile(fn, wall_s: float) -> dict:
    """One call of ``fn`` under torch.profiler: the kernels' device time
    (the sum of their self device times), launches, the top kernels, and
    the busy share against ``wall_s``, the unprofiled wall time of one
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = fn()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kern)
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    return {"wall_profiled_ms": wall_prof * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_busy_share": busy_us / 1e6 / wall_s if busy_us else None,
            "launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_us": dev_us(e)} for e in top]}


# ---------------------------------------------------------------------------
# phase 3c: training at full width
# ---------------------------------------------------------------------------


def _clone(tree):
    """A deep copy of a params tree (tensors and FixedMask leaves)."""
    from repro_torch.core.layouts import FixedMaskTensor

    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, FixedMaskTensor):
        return FixedMaskTensor(tree.val.clone(), tree.mask.clone(),
                               tree.origin)
    return tree.clone()


def _kept(params) -> dict:
    from repro_torch.core.layouts import FixedMaskTensor

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, FixedMaskTensor):
            out[".".join(path)] = t.mask.float().mean().item()

    walk(params, ())
    return out


def train_summary(label, out, counts, peak_gb, warm: int) -> dict:
    """Step times after the first ``warm`` steps (the first step, or the
    graph trainer's first chunk, which runs the step eagerly and captures
    it), tokens/s, losses."""
    steady = out["step_s"][warm:]
    step_ms = statistics.median(steady) * 1e3
    losses = out["losses"]
    assert all(math.isfinite(x) for x in losses), (label, losses)
    return {"label": label, "steps": len(losses),
            "step_ms_p50": step_ms,
            "step_ms_mean": statistics.mean(steady) * 1e3,
            "first_step_ms": out["step_s"][0] * 1e3,
            "tokens_per_s": TRAIN_TOKENS / (step_ms / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "recomputes": out["recomputes"],
            "peak_gb": peak_gb, "counts": counts,
            "kept": _kept(out["params"])}


def assert_same_training(graph, host, what) -> None:
    """The graph trainer's run and the host loop's, bit for bit: losses,
    gradient norms, recomputes, and every param, mask, moment and the
    step counter."""
    import torch

    from repro_torch.launch.graphs import state_tensors

    assert graph["losses"] == host["losses"], (what, "losses")
    assert graph["gnorms"] == host["gnorms"], (what, "gnorms")
    assert graph["recomputes"] == host["recomputes"], (what, "recomputes")
    a = state_tensors(graph["params"], graph["opt_state"])
    b = state_tensors(host["params"], host["opt_state"])
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, "state")


TIMED_STEPS = 5


def time_graph_steps(multi, out, data, step0: int) -> dict:
    """Where a replayed step's time goes: chunks of ``TIMED_STEPS`` steps
    after the run (no pattern recompute: the ramp has ended) from its
    final state, each ending in its one host fetch; wall per step the
    median of 3 chunks, timed now, and one more chunk under torch.profiler
    by :func:`run_profiles`."""
    import torch

    from repro_torch.launch import train as ttrain

    params, state = out["params"], out["opt_state"]
    at = [step0]

    def one():
        s = at[0]
        at[0] += TIMED_STEPS
        assert not multi.recomputes(s, TIMED_STEPS, s + TIMED_STEPS)
        t0 = time.perf_counter()
        _, _, m = multi(params, state, ttrain.stack_batches(
            data, s, s + TIMED_STEPS), s, s + TIMED_STEPS)
        torch.stack((m["loss"], m["gnorm"])).cpu()
        return time.perf_counter() - t0

    one()
    wall = statistics.median(one() for _ in range(3))
    return profile_later(one, wall, {"step_wall_ms": wall / TIMED_STEPS
                                     * 1e3, "steps": TIMED_STEPS})


def time_eager_steps(step_fn, out, data, step0: int) -> dict:
    """The host loop's steps timed as :func:`time_graph_steps` times the
    graph's: ``TIMED_STEPS`` eager steps, each fetching its loss and
    gradient norm as the host loop does."""
    import torch

    params, state = out["params"], out["opt_state"]
    at = [step0]

    def one():
        s = at[0]
        at[0] += TIMED_STEPS
        t0 = time.perf_counter()
        for k in range(s, s + TIMED_STEPS):
            batch = {key: torch.as_tensor(v, device="cuda")
                     for key, v in data.batch_at(k).items()}
            _, _, m = step_fn(params, state, batch)
            float(m["loss"])
            float(m["gnorm"])
        return time.perf_counter() - t0

    one()
    wall = statistics.median(one() for _ in range(3))
    return profile_later(one, wall, {"step_wall_ms": wall / TIMED_STEPS
                                     * 1e3, "steps": TIMED_STEPS})


def _peak_since(held) -> float:
    import torch

    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 1e9


def _fresh_peak() -> int:
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def train_cli_run() -> dict:
    """(a) The CLI's default masked path at full width: ``--sparsity 0.75
    --gmp iterative`` over 20 steps (magnitude-pruned FixedMask leaves on
    ``mlp`` and ``attn.wo``, a pattern recompute before each step of the
    ramp, steps 2..16), through the graph trainer (the default: chunks of
    ``--log-every 5`` steps, the step captured once and replayed) and
    through ``--host-loop``, held bit for bit.  Neither training kernel is
    on this path."""
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig

    argv = ["--arch", "bert-base-sten", "--steps", "20", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--sparsity", "0.75",
            "--gmp", "iterative", "--log-every", "5", "--device", "cuda"]
    runs = {}
    for mode, extra in (("graph", []), ("eager", ["--host-loop"])):
        held = _fresh_peak()
        args = ttrain.parse_args(argv + extra)
        reset_counts()
        out = ttrain.run(args)
        counts = read_counts()
        peak = _peak_since(held)
        assert out["rc"] == 0
        assert all(counts[k] == 0 for k in KERNELS + TRAIN_KERNELS), counts
        assert out["recomputes"] == list(range(2, 17)), out["recomputes"]
        # the magnitude mask keeps |x| >= the k-th largest |x|: every bf16
        # value tied with it is kept too (one bf16 step holds up to ~0.3%
        # of these weights near the threshold)
        for name, kept in _kept(out["params"]).items():
            assert 0.25 <= kept <= 0.255, (name, kept)
        runs[mode] = (out, counts, peak)
    (g, gc, gpeak), (h, hc, hpeak) = runs["graph"], runs["eager"]
    assert_same_training(g, h, "run (a)")
    assert g["trainer"].graph.info["captured"]
    cfg = g["cfg"]
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0))
    res = train_summary("a_cli_sparsity0.75", g, gc, gpeak, warm=5)
    res["eager"] = train_summary("a_cli_sparsity0.75", h, hc, hpeak, warm=1)
    res["graph"] = dict(g["trainer"].graph.info)
    res["timed_graph"] = time_graph_steps(g["trainer"], g, data, 20)
    res["timed_eager"] = time_eager_steps(
        ttrain.make_train_step(cfg, AdamWConfig()), h, data, 20)
    return res


def parity_numbers(cfg, params, batch) -> dict:
    """Run (b)'s first step (forward and backward) from the same state
    through the kernels and through the plain versions: the loss of each,
    and the ``mlp.wi`` gradient's relative error in the Frobenius norm."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ttrain

    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    kept = []
    route = kops.matmul_threshold

    def recording(a, w, t):    # the fused route, reading each mask's share
        val, mask = route(a, w, t)
        kept.append(mask.float().mean())
        return val, mask

    kops.matmul_threshold = recording
    try:
        lk, _, gk = ttrain.loss_and_grads(params, cfg, b)
    finally:
        kops.matmul_threshold = route
    with plain_versions():
        lp, _, gp = ttrain.loss_and_grads(params, cfg, b)
    lk, lp = float(lk), float(lp)
    gwk = gk["layers"]["mlp"]["wi"].float()
    gwp = gp["layers"]["mlp"]["wi"].float()
    return {"loss_kernels": lk, "loss_plain": lp,
            "loss_rel_err": abs(lk - lp) / abs(lp),
            "wi_grad_rel_err": ((gwk - gwp).norm() / gwp.norm()).item(),
            "wi_grad_max_abs_err": (gwk - gwp).abs().max().item(),
            "wi_grad_max_abs": gwp.abs().max().item(),
            "threshold_kept_share": torch.stack(kept).mean().item()}


def train_parity(cfg, params, batch) -> dict:
    """:func:`parity_numbers`, held to its bounds: loss within 1e-3
    relative; the ``mlp.wi`` gradient (bf16) within 2**-6 relative in the
    Frobenius norm — the two forwards differ by the f32 summation order
    of the fused product (and any mask entry on the threshold), which
    bf16 activations turn into rounding flips of 2**-8 relative that
    compound over 12 layers."""
    p = parity_numbers(cfg, params, batch)
    assert p["loss_rel_err"] <= 1e-3, ("loss", p)
    assert p["wi_grad_rel_err"] <= 2 ** -6, ("mlp.wi gradient", p)
    assert 0.1 <= p["threshold_kept_share"] <= 0.9, \
        ("kept share of the threshold", p)
    return p


def lib_model(seed: int):
    """Run (b)'s model: full-width bert-base-sten with the inline threshold
    on ``mlp.wi``, seeded random weights, NMSparsifier(2, 4) FixedMask
    ``mlp.wo`` / ``attn.wo`` (the nm_mask kernel at the build); and its
    data stream, seeded alike.  Returns (cfg, params, data)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.core.sparsifiers import NMSparsifier
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("bert-base-sten"),
                              mlp_inline_threshold=THRESHOLD)
    params = init_lm(cfg, seed=seed, device="cuda")
    sb = SparsityBuilder()
    for pat in ("*mlp.wo*", "*attn.wo*"):
        sb.set_weight(pat, NMSparsifier(2, 4), FixedMaskTensor)
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    return cfg, sb.sparsify_params(params), data


MARGIN_SEEDS = (2, 3, 4)


def train_margins(seeds=MARGIN_SEEDS, check: bool = True) -> list:
    """Run (b)'s first-step parity (kernels against plain versions) from
    fresh models at more seeds than the run's own: how much of the
    ``mlp.wi`` gradient's 2**-6 bound each uses.  With ``check`` a seed
    over a bound fails the run."""
    import torch

    out = []
    for seed in seeds:
        cfg, params, data = lib_model(seed)
        batch = data.batch_at(0)
        p = (train_parity if check else parity_numbers)(cfg, params, batch)
        out.append({"seed": seed, **p,
                    "wi_grad_share_of_bound": p["wi_grad_rel_err"] / 2 ** -6})
        del params
        torch.cuda.empty_cache()
    return out


def train_lib_run() -> dict:
    """(b) The library API at full width: ``mlp_inline_threshold=0.5`` on
    the dense ``mlp.wi`` and NMSparsifier(2, 4) FixedMask leaves on
    ``mlp.wo`` / ``attn.wo``, GMP iterative with recomputes before steps
    2, 5 and 8 of 10, through ``make_multi_step`` (chunks of 5, the step
    captured once: ``matmul_threshold`` runs inside the replayed step,
    ``nm_mask`` at the build and eagerly between replays) and through the
    host loop from a clone of the same start, held bit for bit.  The
    graph run's counts cover the build and the loop."""
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init

    steps = 10
    held = _fresh_peak()
    reset_counts()
    cfg, params, data = lib_model(1)
    gmp = GMPSchedule(mode="iterative", target_sparsity=0.5, begin_step=2,
                      end_step=8, recompute_every=3, num_layers=cfg.n_layers)
    start = _clone(params)
    multi = ttrain.make_multi_step(cfg, AdamWConfig(), gmp, 5)
    g = ttrain.fast_loop(params, adamw_init(params), multi, data, start=0,
                         stop=steps, log_every=5)
    counts = read_counts()
    peak = _peak_since(held)
    held = _fresh_peak()
    reset_counts()
    step_fn = ttrain.make_train_step(cfg, AdamWConfig())
    h = ttrain.train_loop(_clone(start), adamw_init(start), step_fn, data,
                          start=0, stop=steps, device="cuda", gmp=gmp,
                          log_every=5)
    host_counts = read_counts()
    host_peak = _peak_since(held)
    assert_same_training(g, h, "run (b)")
    assert g["recomputes"] == [2, 5, 8], g["recomputes"]
    want_mt = cfg.n_layers * steps                    # one per forward
    want_nm = 2 * cfg.n_layers + 2 * len(g["recomputes"])
    assert counts["matmul_threshold"] == want_mt, (counts, want_mt)
    assert counts["nm_mask"] == want_nm, (counts, want_nm)
    assert all(counts[k] == 0 for k in KERNELS), counts
    assert host_counts["matmul_threshold"] == want_mt, host_counts
    assert host_counts["nm_mask"] == 2 * len(h["recomputes"]), host_counts
    assert multi.graph.info["captured"]
    for name, kept in _kept(g["params"]).items():
        assert kept == 0.5, (name, kept)
    parity = train_parity(cfg, start, data.batch_at(0))
    del start
    res = train_summary("b_lib_nm2:4_threshold0.5", g, counts, peak, warm=5)
    res["eager"] = train_summary("b_lib_nm2:4_threshold0.5", h, host_counts,
                                 host_peak, warm=1)
    res["parity"] = parity
    res["graph"] = dict(multi.graph.info)
    res["timed_graph"] = time_graph_steps(multi, g, data, steps)
    res["timed_eager"] = time_eager_steps(step_fn, h, data, steps)
    return res


def ckpt_phase() -> dict:
    """Checkpoint and resume at full width through the CLI: run (a)'s
    model and schedule over 6 steps with a checkpoint every 3 (the graph
    trainer), then a second run resumed from a copy of that run's step-3
    checkpoint in another directory; its losses for steps 3..5 and its
    final params, masks, moments and step counter must equal the first
    run's bit for bit, and so must the two final checkpoints' hashes."""
    import shutil
    import tempfile

    from repro_torch.launch import train as ttrain

    def argv(d, *extra):
        return ["--arch", "bert-base-sten", "--steps", "6", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--sparsity",
                "0.75", "--gmp", "iterative", "--log-every", "3",
                "--ckpt-every", "3", "--ckpt-dir", str(d), "--device",
                "cuda", *extra]

    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        t0 = time.perf_counter()
        full = ttrain.run(ttrain.parse_args(argv(a)))
        full_s = time.perf_counter() - t0
        b.mkdir()
        shutil.copytree(a / "step_00000003", b / "step_00000003")
        (b / "LATEST").write_text("3")
        t0 = time.perf_counter()
        res = ttrain.run(ttrain.parse_args(argv(b, "--resume")))
        resumed_s = time.perf_counter() - t0
        assert full["rc"] == res["rc"] == 0 and res["start_step"] == 3
        assert res["losses"] == full["losses"][3:], (res["losses"],
                                                     full["losses"])
        tail = {"params": full["params"], "opt_state": full["opt_state"],
                "losses": full["losses"][3:], "gnorms": full["gnorms"][3:],
                "recomputes": [s for s in full["recomputes"] if s >= 3]}
        assert_same_training(res, tail, "resume")
        man = [json.loads((d / "step_00000006" / "MANIFEST.json")
                          .read_text()) for d in (a, b)]
        assert man[0]["index"] == man[1]["index"]
        size = sum(f.stat().st_size for f in (a / "step_00000006").iterdir())
    del full, res
    return {"steps": 6, "resumed_at": 3, "bitwise": True,
            "full_run_s": full_s, "resumed_run_s": resumed_s,
            "ckpt_bytes": size, "leaves": man[0]["num_leaves"]}


def report_train(runs, card) -> None:
    for r in runs:
        c = r["counts"]
        gi = r["graph"]
        print(f"train[{r['label']}] on {card}: {r['steps']} steps, graph "
              f"trainer bitwise the host loop; graph {r['step_ms_p50']:.2f} "
              f"ms/step p50 after the first chunk ({r['step_ms_mean']:.2f} "
              f"mean, first chunk {r['first_step_ms']:.1f} a step), host "
              f"loop {r['eager']['step_ms_p50']:.2f} ms/step p50; "
              f"{r['tokens_per_s']:.0f} tok/s, loss {r['loss_first']:.4f} "
              f"-> {r['loss_last']:.4f}, peak {r['peak_gb']:.2f} GB "
              f"(host loop {r['eager']['peak_gb']:.2f}), recomputes "
              f"{len(r['recomputes'])}, launches nm_mask {c['nm_mask']} "
              f"matmul_threshold {c['matmul_threshold']}")
        print(f"    capture {gi['capture_ms']:.1f} ms + instantiate "
              f"{gi['instantiate_ms']:.1f} ms, pool "
              f"{gi['pool_bytes'] / 2**20:.1f} MiB, {gi['replays']} replays")
        for mode in ("graph", "eager"):
            p = r[f"timed_{mode}"]
            busy = p["device_busy_share"]
            n = p["steps"]
            print(f"    {mode} steps (no recompute, {n} a call): "
                  f"{p['step_wall_ms']:.3f} ms wall a step, device "
                  + ("not measured (profiler saw no device time)"
                     if busy is None else
                     f"busy {p['device_busy_ms'] / n:.3f} ms a step "
                     f"({busy * 100:.1f}%, wall/busy {1 / busy:.3f})")
                  + f", {p['launches'] / n:.0f} launches a step")
            for k in p["top_kernels"][:5]:
                print(f"    {k['device_us']:9.1f} us x{k['count']:4d} "
                      f"{k['name']}")


def report_runs(runs, card) -> None:
    for mode, key in (("graph", "metrics"), ("eager", "eager_metrics")):
        dense_p50 = runs[0][key]["tok_latency_p50"]
        for r in runs:
            m = r[key]
            over = m["tok_latency_p50"] / dense_p50
            r.setdefault("sparse_over_dense_tok_p50", {})[mode] = over
            c = r["counts"]
            print(f"serve[{r['label']}, {mode}] on {card}: "
                  f"{m['num_requests']} requests {m['num_tokens']} tokens, "
                  f"{m['throughput_tok_s']:.1f} tok/s, per-token p50 "
                  f"{m['tok_latency_p50'] * 1e3:.3f} ms p99 "
                  f"{m['tok_latency_p99'] * 1e3:.3f} ms, ttft p50 "
                  f"{m['ttft_p50'] * 1e3:.3f} ms p99 "
                  f"{m['ttft_p99'] * 1e3:.3f} ms, sparse/dense p50 "
                  f"{over:.3f}, decode steps {r['decode_steps']}, launches "
                  + " ".join(f"{k[4:]} {c[k]}" for k in KERNELS))


def report_graphs(graphs, card) -> None:
    for p in graphs:
        cg, sg = p["chunk_graph"], p["step_graph"]
        eb = p["eager_busy_share"]
        print(f"decode chunk[{p['label']}] on {card}: 8 steps at 4 slots, "
              f"replay bitwise eager ({p['bitwise']}); eager "
              f"{p['eager_wall_ms']:.2f} ms wall, busy "
              + ("not measured" if eb is None else
                 f"{p['eager_busy_ms']:.3f} ms ({eb * 100:.1f}%)")
              + f"; replayed {p['replay_wall_ms']:.3f} ms wall, busy "
              f"{p['replay_busy_ms']:.3f} ms ({p['replay_busy_from']}, "
              f"{p['replay_busy_share'] * 100:.1f}%, wall/busy "
              f"{p['replay_over_busy']:.3f}), event span "
              f"{p['replay_event_span_ms']:.3f} ms; "
              f"{p['launches_per_step']:.0f} launches/step, eager host "
              f"{p['eager_host_us_per_launch']:.2f} us/launch "
              f"({p['eager_enqueue_ms']:.2f} ms a chunk), replay enqueue "
              f"{p['replay_enqueue_ms']:.3f} ms")
        print(f"    capture: chunk {cg['capture_ms']:.1f} ms + instantiate "
              f"{cg['instantiate_ms']:.1f} ms, pool "
              f"{cg['pool_bytes'] / 2**20:.1f} MiB; step "
              f"{sg['capture_ms']:.1f} + {sg['instantiate_ms']:.1f} ms, "
              f"pool +{sg['pool_bytes'] / 2**20:.1f} MiB")
        for k in p["replay_top_kernels"][:4]:
            print(f"    {k['device_us']:9.1f} us x{k['count']:4d} {k['name']}")


#: the body of the kernels whose cases do not name one
# ---------------------------------------------------------------------------
# phase 3e: the programming model (layouts, dispatch, sparse operators,
# intermediate and gradient plans)
# ---------------------------------------------------------------------------

STEN_STEPS = 5
LOSS_RTOL = 1e-3


def _launches(counts: dict) -> dict:
    return {k: counts[k] for k in KERNELS + TRAIN_KERNELS if counts.get(k)}


def sten_library_phase(gen) -> list:
    """(s1) The library at the model's published shapes, bf16: each case
    run through the kernels (the counts zeroed right before, read right
    after) and again under :func:`plain_versions`, held to the plain
    result by the kernel phase's rule, then timed (L2 flushed).

    - ``NMTensor.from_dense`` of ``mlp.wo`` [3072, 768] at 2:4 and 16:32
      (one ``nm_mask`` launch): offsets and values bitwise;
    - ``sten.linear`` with ``mlp.wi`` [768, 3072] as GroupedNMTensor 1:4:8
      gr64 (sparse_dim 0), x of 4 rows (the GEMV route) and of 1024 rows
      (the SpMM route): f32 error within 1e-4 of the largest output plus
      one bf16 rounding step;
    - ``sten.matmul`` on a sparse_dim=1 GroupedNMTensor of ``mlp.wo``'s
      transpose [768, 3072] against 8 and 1024 columns (``nmg_matmul``'s
      GEMV and SpMM routes, f32 out): within 1e-4 of the largest output;
    - ``sparsified_op(torch.matmul, (ScalarThreshold(0.5), FixedMask,
      KeepAll, FixedMask))`` on DenseTensor [1024, 768] x [768, 3072]: one
      fused ``matmul_threshold`` launch, no post-sparsifier; values within
      1e-5 of the largest, the mask equal except within 1e-5 of t;
    - CSR @ dense, dense @ CSR and COO + COO at [3072, 768], 70% sparse,
      f32 (no kernel: plain torch ops): allclose to the dense result."""
    import warnings

    import torch

    from repro_torch import sten
    from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
        FixedMaskTensor, NMTensor
    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.core.sparsifiers import KeepAll, ScalarThresholdSparsifier

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = []

    def run(label, fn, plain_check, kernels, timed=True):
        reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error", sten.SparseFallbackWarning)
            got = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k in kernels:
            assert counts[k] == 1, (label, k, counts)
        with plain_versions():
            want = fn()
        err, tol = plain_check(got, want)
        assert err <= tol, (label, err, tol)
        c = {"case": label, "launches": _launches(counts),
             "routes": {k: v for k, v in counts["routes"].items()
                        if not k.endswith("/cuda")},
             "max_abs_err": err, "tol": tol}
        if timed:
            c["ms"] = time_ms(fn, flush)
            with plain_versions():
                c["plain_ms"] = time_ms(fn, flush)
        cases.append(c)
        return got

    def bitwise(got, want):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        return (0.0 if same else float("inf")), 0.0

    wo = (torch.randn(3072, 768, generator=gen, device="cuda")
          / math.sqrt(3072)).to(bf16)
    for n, m in ((2, 4), (16, 32)):
        run(f"NMTensor.from_dense mlp.wo {n}:{m}",
            lambda n=n, m=m: (lambda t: (t.idx, t.val))(
                NMTensor.from_dense(wo, n, m)), bitwise, ("nm_mask",))

    def f32_rule(got, want):
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        tol = 1e-4 * max(1.0, top)
        if got.dtype == bf16:
            tol += 2 ** -8 * top
        return err, tol

    wi = dense_to_grouped_nm((torch.randn(768, 3072, generator=gen,
                                          device="cuda") / math.sqrt(768))
                             .to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
    for rows, kernel in ((4, "nmg_gemv"), (1024, "nmg_spmm")):
        x = torch.randn(rows, 768, generator=gen, device="cuda").to(bf16)
        run(f"sten.linear mlp.wi 1:4:8 gr64 x[{rows}]",
            lambda x=x: sten.linear(x, wi), f32_rule, (kernel,))
    wo_t = dense_to_grouped_nm(wo.T.contiguous(), 1, 4, 8, gr=64,
                               sparse_dim=1)
    for cols, kernel in ((8, "nmg_gemv"), (1024, "nmg_spmm")):
        b = torch.randn(3072, cols, generator=gen, device="cuda").to(bf16)
        run(f"sten.matmul sparse_dim=1 [768, 3072] x [3072, {cols}]",
            lambda b=b: sten.matmul(wo_t, b), f32_rule, (kernel,))
    del wo, wi, wo_t

    a = torch.randn(TRAIN_TOKENS, 768, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(768, 3072, generator=gen, device="cuda")
         / math.sqrt(768)).to(bf16)
    op = sten.sparsified_op(torch.matmul, sten.OutFormat(
        ScalarThresholdSparsifier(THRESHOLD), FixedMaskTensor, KeepAll(),
        FixedMaskTensor))
    y = a.double() @ w.double()
    near = (y.abs() - THRESHOLD).abs() <= 1e-5 * max(1.0, THRESHOLD)
    del y

    def threshold_rule(got, want):
        assert isinstance(got, FixedMaskTensor), type(got)
        diff = got.mask != want.mask
        assert not bool((diff & ~near).any()), "threshold mask differs"
        err = (got.val - want.val)[~diff].abs().max().item()
        return err, 1e-5 * max(1.0, want.val.abs().max().item())

    run("sparsified_op matmul + ScalarThreshold(0.5) [1024, 768] x "
        "[768, 3072]", lambda: op(DenseTensor(a), DenseTensor(w)),
        threshold_rule, ("matmul_threshold",))
    del a, w, near

    sp = sten.ScalarFractionSparsifier(0.7)
    wd = torch.randn(3072, 768, generator=gen, device="cuda")
    vd = torch.randn(3072, 768, generator=gen, device="cuda")
    csr = sten.apply_sparsifier(sp, wd, CsrTensor)
    b = torch.randn(768, 256, generator=gen, device="cuda")
    left = torch.randn(256, 3072, generator=gen, device="cuda")
    coo_a = sten.apply_sparsifier(sp, wd, CooTensor)
    coo_b = sten.apply_sparsifier(sp, vd, CooTensor)

    def allclose(got, want):
        got = got.to_dense() if hasattr(got, "to_dense") else got
        err = (got - want).abs().max().item()
        return err, 1e-4 * max(1.0, want.abs().max().item())

    dense = csr.to_dense()
    for label, fn, want in (
            ("CSR @ dense [3072, 768] x [768, 256]",
             lambda: sten.matmul(csr, b), dense @ b),
            ("dense @ CSR [256, 3072] x [3072, 768]",
             lambda: sten.matmul(left, csr), left @ dense),
            ("COO + COO [3072, 768]", lambda: sten.add(coo_a, coo_b),
             coo_a.to_dense() + coo_b.to_dense())):
        err, tol = allclose(fn(), want)
        assert err <= tol, (label, err, tol)
        cases.append({"case": label, "launches": {}, "max_abs_err": err,
                      "tol": tol, "ms": time_ms(fn, flush),
                      "density": csr.density()})
    del flush
    return cases


class _MaskRecorder:
    """Records every ``nm_mask`` result (through ``kernels/ops.py``, so
    the kernel or its plain version, whichever runs) while on."""

    def __init__(self):
        self.masks, self.on = [], False

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self._orig = kops.nm_mask

        def wrapped(x, n, m):
            out = self._orig(x, n, m)
            if self.on:
                self.masks.append(out.clone())
            return out

        kops.nm_mask = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops

        kops.nm_mask = self._orig


def sten_plan():
    """(s2)'s plan: ``mlp.wi`` masked-dense n:m:g 1:4:8 gr64 (the default
    FixedMaskTensor), ``mlp.wo`` NMSparsifier(2, 4) FixedMask (nm_mask per
    layer), ``mlp.act`` NMSparsifier(2, 4) in every forward, and a
    magnitude gradient format on ``attn.wo``."""
    from repro_torch import sten

    sb = sten.SparsityBuilder()
    sb.set_weight("*mlp.wi", sten.GroupedNMSparsifier(1, 4, 8, gr=64,
                                                      sparse_dim=0))
    sb.set_weight("*mlp.wo", sten.NMSparsifier(2, 4))
    sb.set_interm("mlp.act", sten.NMSparsifier(2, 4))
    sb.set_weight_grad("*attn.wo", sten.OutFormat(
        external=sten.ScalarFractionSparsifier(0.5)))
    return sb


def sten_model_run(params, data, n_layers) -> dict:
    """Build the plan's params, train ``STEN_STEPS`` library-API steps
    (``loss_and_grads`` under the plan, then ``sparse_aware_update`` with
    the builder's gradient formats), recording the last step's
    ``mlp.act`` masks, then rebuild ``mlp.wo`` as a stacked NMTensor and
    run one eval forward under the plan.  Returns the losses, masks,
    counts per stage and times."""
    import warnings

    import torch

    from repro_torch import sten
    from repro_torch.configs import get_config
    from repro_torch.core.layouts import DenseTensor, NMTensor
    from repro_torch.launch import train as ttrain
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.sparse_update import sparse_aware_update

    cfg = get_config("bert-base-sten")
    sb = sten_plan()
    plan = sb.plan()
    out = {"counts": {}}
    reset_counts()
    t0 = time.perf_counter()
    p = sb.sparsify_params(params)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["counts"]["build"] = read_counts()
    state = adamw_init(p)
    opt = AdamWConfig()
    losses, step_s = [], []
    with _MaskRecorder() as rec, warnings.catch_warnings():
        warnings.simplefilter("error", sten.SparseFallbackWarning)
        for s in range(STEN_STEPS):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in data.batch_at(s).items()}
            rec.on = s == STEN_STEPS - 1
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plan:
                loss, _, grads = ttrain.loss_and_grads(p, cfg, batch)
            rec.on = False
            p, state, _ = sparse_aware_update(
                lambda g, st, pp: adamw_update(g, st, pp, opt), grads, state,
                p, grad_formats=sb.grad_formats())
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            out["counts"][f"step{s}"] = read_counts()
        out["act_masks"] = rec.masks
        assert len(rec.masks) == n_layers, len(rec.masks)
        out["losses"], out["step_s"] = losses, step_s
        out["weight_masks"] = {k: p["layers"]["mlp"][k].mask.clone()
                               for k in ("wi", "wo")}
        # eval: mlp.wo as a stacked NMTensor through the n:m sparsifier
        reset_counts()
        wo = sten.SparsityBuilder().set_weight(
            "*mlp.wo", sten.NMSparsifier(2, 4), NMTensor).sparsify_params(
            {"mlp": {"wo": p["layers"]["mlp"]["wo"].to_dense()}})
        out["counts"]["eval_build"] = read_counts()
        ev = dict(p, layers=dict(p["layers"], mlp=dict(
            p["layers"]["mlp"], wo=wo["mlp"]["wo"])))
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch_at(STEN_STEPS).items()}
        disp = importlib.import_module("repro_torch.core.dispatch")
        conv = importlib.import_module("repro_torch.core.convert")
        disp.reset_dispatch_counters()
        conv.reset_conversion_log()
        reset_counts()
        with plan, torch.no_grad():
            ev_loss, _ = loss_fn(ev, cfg, batch)
        out["eval_loss"] = float(ev_loss)
        out["counts"]["eval"] = read_counts()
        out["eval_routes"] = sorted(
            (o, op, list(sig)) for (o, op, sig) in disp.dispatch_counters())
        out["eval_conversions"] = sorted({c[:2]
                                          for c in conv.conversion_log()})
        out["predict_route"] = disp.predict_route(
            "linear", (DenseTensor, NMTensor))
    out["params"], out["state"], out["eval_params"] = p, state, ev
    out["eval_batch"], out["cfg"], out["plan"] = batch, cfg, plan
    return out


def sten_model_phase(card) -> dict:
    """(s2) Full-width bert-base-sten (12 layers, d_model 768, d_ff 3072,
    vocab 30522, bf16, seeded random weights, batch 8 x 128 of the
    synthetic stream) under :func:`sten_plan`: the build, five library-API
    training steps and an eval forward with ``mlp.wo`` a stacked NMTensor,
    whose ``linear`` goes through the lossless NMTensor -> FixedMaskTensor
    conversion (the reference's route) with no fallback warning.  Run
    through the kernels, then from a clone of the same weights through
    the plain versions: each step's loss within 1e-3 (relative), the
    weight masks and the last step's ``mlp.act`` masks equal, and
    ``nm_mask`` launched once a layer at each build and in each forward.
    Reports ms a step (eager wall; device busy share by a profile run
    last), the conversions' share of the eval forward, and peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_lm, loss_fn

    cfg = get_config("bert-base-sten")
    L = cfg.n_layers
    params = init_lm(cfg, seed=5, device="cuda")
    start = _clone(params)
    data = SyntheticLMPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH, seed=5))
    held = _fresh_peak()
    k = sten_model_run(params, data, L)
    peak = _peak_since(held)
    del params
    with plain_versions():
        pl = sten_model_run(start, data, L)
    del start
    c = k["counts"]
    assert c["build"]["nm_mask"] == L, c["build"]
    for s in range(STEN_STEPS):
        assert c[f"step{s}"]["nm_mask"] == L, (s, c[f"step{s}"])
    assert c["eval_build"]["nm_mask"] == L and c["eval"]["nm_mask"] == L, c
    for stage in c.values():
        assert all(stage.get(x, 0) == 0 for x in KERNELS
                   + ("matmul_threshold",)), stage
    for a, b in zip(k["losses"], pl["losses"]):
        assert math.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b), \
            (k["losses"], pl["losses"])
    assert abs(k["eval_loss"] - pl["eval_loss"]) <= LOSS_RTOL * abs(
        pl["eval_loss"]), (k["eval_loss"], pl["eval_loss"])
    for name in ("wi", "wo"):
        assert torch.equal(k["weight_masks"][name], pl["weight_masks"][name])
    assert all(torch.equal(a, b) for a, b in zip(k["act_masks"],
                                                 pl["act_masks"]))
    want_routes = {("impl", "linear", ("DenseTensor", "NMTensor")),
                   ("impl", "linear", ("DenseTensor", "FixedMaskTensor")),
                   ("impl", "linear", ("DenseTensor", "DenseTensor"))}
    assert {(o, op, tuple(sig)) for o, op, sig in k["eval_routes"]} == \
        want_routes, k["eval_routes"]
    assert set(k["eval_conversions"]) == {
        ("NMTensor", "FixedMaskTensor"), ("DenseTensor", "FixedMaskTensor")}
    pr = k["predict_route"]
    assert pr["target_sig"] == ("DenseTensor", "FixedMaskTensor") and \
        pr["conversions"] == (("NMTensor", "FixedMaskTensor"),), pr
    kept_wo = k["weight_masks"]["wo"].float().mean().item()
    kept_wi = k["weight_masks"]["wi"].float().mean().item()
    assert kept_wo == 0.5 and kept_wi == 0.25, (kept_wo, kept_wi)

    # times: the eval forward and its conversions (CUDA events), one
    # training step eager (wall, and device busy by a profile run last)
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.optim.sparse_update import sparse_aware_update

    conv = importlib.import_module("repro_torch.core.convert")
    ev, plan, batch = k["eval_params"], k["plan"], k["eval_batch"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def forward():
        with plan, torch.no_grad():
            loss_fn(ev, cfg, batch)

    def conversions():
        for w in (ev["layers"]["mlp"]["wo"], ev["layers"]["attn"]["wo"]):
            for one in w.unbind(0):
                conv.convert(one, FixedMaskTensor)

    fwd_ms, conv_ms = time_ms(forward, flush), time_ms(conversions, flush)
    del flush
    sb = sten_plan()
    p, state = k["params"], k["state"]

    def step():
        b = {kk: torch.as_tensor(v, device="cuda")
             for kk, v in data.batch_at(STEN_STEPS + 1).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plan:
            loss, _, grads = ttrain.loss_and_grads(p, cfg, b)
        sparse_aware_update(lambda g, st, pp: adamw_update(
            g, st, pp, AdamWConfig()), grads, state, p,
            grad_formats=sb.grad_formats())
        float(loss)
        return time.perf_counter() - t0

    step()
    wall = statistics.median(step() for _ in range(3))
    res = {"card": card, "losses": k["losses"],
           "plain_losses": pl["losses"],
           "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                   zip(k["losses"], pl["losses"])),
           "eval_loss": k["eval_loss"], "plain_eval_loss": pl["eval_loss"],
           "eval_routes": k["eval_routes"],
           "eval_conversions": k["eval_conversions"],
           "predict_route": {kk: v for kk, v in k["predict_route"].items()},
           "counts": {st: _launches(v) for st, v in c.items()},
           "nm_mask_launches": sum(v.get("nm_mask", 0) for v in c.values()),
           "build_s": k["build_s"], "plain_build_s": pl["build_s"],
           "step_wall_ms_first": k["step_s"][0] * 1e3,
           "step_wall_ms": wall * 1e3,
           "plain_step_wall_ms_median": statistics.median(
               pl["step_s"][1:]) * 1e3,
           "eval_forward_ms": fwd_ms, "conversions_ms": conv_ms,
           "conversion_share": conv_ms / fwd_ms, "peak_gb": peak,
           "kept": {"mlp.wi": kept_wi, "mlp.wo": kept_wo}}
    res["profile"] = profile_later(step, wall)
    return res


def report_sten(lib, model) -> None:
    card = model["card"]
    print(f"sten library cases (bf16, L2 flushed, device ms) on {card}:")
    for c in lib:
        t = "" if "ms" not in c else f" | {c['ms']:.4f} ms" + (
            f" (plain {c['plain_ms']:.4f} ms)" if "plain_ms" in c else "")
        print(f"  sten {c['case']}: err {c['max_abs_err']:.2e} "
              f"(tol {c['tol']:.2e}) launches {c['launches']}{t}")
    print(f"sten model (bert-base-sten full width, plan: mlp.wi n:m:g "
          f"FixedMask, mlp.wo 2:4, mlp.act 2:4, attn.wo grad 50%) on "
          f"{card}: losses {[round(x, 4) for x in model['losses']]} "
          f"(plain max rel err {model['loss_max_rel_err']:.2e}), eval loss "
          f"{model['eval_loss']:.4f}; step {model['step_wall_ms']:.1f} ms "
          f"eager wall, device busy "
          f"{model['profile'].get('device_busy_ms') or 0:.1f} ms "
          f"({(model['profile'].get('device_busy_share') or 0) * 100:.1f}%, "
          f"{model['profile'].get('launches')} launches); eval forward "
          f"{model['eval_forward_ms']:.2f} ms, "
          f"conversions {model['conversions_ms']:.2f} ms "
          f"({model['conversion_share'] * 100:.1f}%); peak "
          f"{model['peak_gb']:.2f} GB; nm_mask launches "
          f"{model['nm_mask_launches']}")


# ---------------------------------------------------------------------------
# tuning phase (repro_torch.tune)
# ---------------------------------------------------------------------------

#: widths of the crossover sweep at the served widths, around decode's and
#: the short admission's 16
TUNE_MS = (8, 12, 16, 17, 20, 24, 32)
#: (model, weight) of the served projections the crossover is measured at
TUNE_WEIGHTS = (("bert", "wi"), ("bert", "wo_ffn"), ("qwen", "wq"),
                ("qwen", "wi"), ("qwen", "wo_ffn"))


def tune_cli() -> dict:
    """``python -m repro_torch.tune --quick --out <tmp>`` in a subprocess:
    its ``decision,key,value`` lines, and the table it wrote, loaded (a
    table that does not load fails the phase)."""
    import os
    import tempfile

    from repro_torch.tune import TuningTable

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "tune_table.json"
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--quick", "--out",
             str(path)], capture_output=True, text=True, timeout=600,
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        if p.returncode:
            raise RuntimeError(f"python -m repro_torch.tune failed "
                               f"({p.returncode}):\n{p.stdout}\n{p.stderr}")
        table = TuningTable.load(str(path))
    lines = [ln for ln in p.stdout.splitlines()
             if re.match(r"^[a-z_]+,", ln)]
    for ln in lines:
        print(f"  tune cli: {ln}")
    assert len(table) > 0 and any(k.startswith("gemv_cuda/")
                                  for k in table.entries), table.entries
    assert any(k.startswith("spmm_cuda/") for k in table.entries)
    assert "spmm_block_elems" not in table.entries
    return {"wall_s": wall, "device": table.device, "entries": len(table),
            "lines": lines}


def crossover_phase(gen) -> list:
    """At the served projections (bf16 1:4:8 gr64, B = x.T): the tuned
    decode config (M = 4, the engine's slots) and SpMM split (N = 24, 32,
    64, its prompts past 16), each held against the plain version at the
    kernel phase's tolerance; then the GEMV and SpMM device times at
    ``TUNE_MS`` with the kernels' own configs and with the tuned ones (the
    packed gated weight also with its gate, as the model runs it), and the
    measured crossover of each."""
    import torch

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_gemv, nmg_spmm
    from repro_torch.tune import TuningTable, bench, routing

    bf16 = torch.bfloat16
    out = []
    for model, name in TUNE_WEIGHTS:
        K, N = MODELS[model]["shapes"][name]
        w = dense_to_grouped_nm(
            (torch.randn(K, N, generator=gen, device="cuda")
             / math.sqrt(K)).to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
        table = TuningTable.for_device()
        ctx = dict(K=K, R=N, fmt=(1, 4, 8), gr=64, dtype=bf16)
        gcfg = bench.tune_gemv_cuda(table, M=4, reps=3, **ctx)
        scfg = bench.tune_spmm_cuda(table, Ns=(24, 32, 64), reps=3, **ctx)
        errs = {}
        for what, M, fn, plain in (
                ("gemv_cuda", 4, lambda b: nmg_gemv.nmg_gemv(
                    w, b, transpose_out=True, config=gcfg),
                 lambda b: nmg_gemv.nmg_gemv_plain(w, b, transpose_out=True)),
                ("spmm_cuda", 32, lambda b: nmg_spmm.nmg_spmm(
                    w, b, splits=scfg["splits"]),
                 lambda b: nmg_spmm.nmg_spmm_plain(w, b))):
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
            got, ref = fn(x.T), plain(x.T)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, (model, name, what, err, tol)
            errs[what] = err
        sweeps = {}
        # the packed gated weight also with its gate: what the model runs
        # (the fused FFN where the router fuses, else projection + gate)
        gated = (("gated", table, "silu"),) if name == "wi" and \
            MODELS[model]["ffn"] == "wi" else ()
        for which, tab, gate in (("own", None, None), ("tuned", table, None),
                                 *gated):
            routing.set_active_table(tab)
            try:
                recs = bench.sweep_m(w, TUNE_MS, dtype=bf16, reps=3,
                                     gate=gate)
            finally:
                routing.clear_active_table()
            sweeps[which] = {
                "gemv_ms": {r["M"]: r["us"] / 1e3 for r in recs
                            if r["path"] == "gemv"},
                "spmm_ms": {r["M"]: r["us"] / 1e3 for r in recs
                            if r["path"] == "spmm"},
                "crossover": bench.measured_crossover(recs)}
        own = nmg_gemv.row_plan(64, 4, w.val.shape[1] * w.val.shape[2], bf16)
        out.append({"model": model, "weight": name, "K": K, "N": N,
                    "gemv_cuda": gcfg,
                    "gemv_own": {"rows": own.rows, "parts": own.parts},
                    "spmm_cuda": scfg, "max_abs_err": errs, **sweeps})
    return out


def report_crossover(rows, card) -> None:
    for r in rows:
        for which in ("own", "tuned", "gated"):
            if which not in r:
                continue
            s = r[which]
            print(f"crossover[{r['model']} {r['weight']} K={r['K']} "
                  f"N={r['N']}, {which} configs] on {card}: " + " ".join(
                      f"M={m} gemv {s['gemv_ms'][m]:.4f} spmm "
                      f"{s['spmm_ms'][m]:.4f} ms;" for m in TUNE_MS)
                  + f" crossover {s['crossover']}")
        print(f"  chosen: gemv_cuda {r['gemv_cuda']} (own {r['gemv_own']}), "
              f"spmm_cuda {r['spmm_cuda']}; against plain: "
              f"{r['max_abs_err']}")


@contextlib.contextmanager
def default_routing():
    """Route with the shipped defaults (no table) inside the block."""
    from repro_torch.tune import routing

    held = routing.active_table()
    routing.clear_active_table()
    try:
        yield
    finally:
        routing.set_active_table(held)


def _projections(cfg, params):
    """(op, weight or group) of each routed projection of one layer."""
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    one = {k: v.layer(0) for k, v in {**attn, **{f"mlp_{k}": v
                                      for k, v in mlp.items()}}.items()
           if hasattr(v, "layer")}
    return [("mm_fused_qkv", tuple(one[k] for k in ("wq", "wk", "wv"))),
            ("nmg_linear", one["wo"]),
            ("mm_gated" if cfg.gated_mlp else "nmg_linear", one["mlp_wi"]),
            ("nmg_linear", one["mlp_wo"])]


def _predicted(cfg, params, M) -> dict:
    """``predict_route`` of one forward at M rows: each projection's keys,
    once per layer."""
    import collections

    from repro_torch.kernels import ops

    keys = collections.Counter()
    for op, w in _projections(cfg, params):
        ws = w if op == "mm_fused_qkv" else None
        keys.update(ops.predict_route(
            op, None if ws else w, ws=ws, M=M, dtype=cfg.tdtype,
            device=(ws or (w,))[0].val.device))
    return {f"{k}/{p}": n * cfg.n_layers for (k, p), n in keys.items()}


def _route_kinds(routes) -> dict:
    """Calls per route with the provenance left out."""
    kinds: dict = {}
    for k, n in routes.items():
        kind = re.sub(r"\[(table|default)\]$", "", k)
        kinds[kind] = kinds.get(kind, 0) + n
    return kinds


def serve_tuned(cfg, params, label) -> dict:
    """The trace served by an engine warmed with ``warmup_engine(...,
    tune=True)`` beside one warmed with the default routing (n:m:g
    ``attn=True`` params): every routed counter of the tuned run reads
    ``[table]``; ``predict_route`` of each projection, summed over the
    layers, equals the counters of one replay of the decode chunk (times
    its steps) and of each prompt length's admission; the tokens equal
    the default run's where no route or config moved, and the logits
    through the tuned routing stay within ``logit_parity``'s bound of the
    default routing's; a different table activated after capture leaves
    a chunk and an admission replay bitwise unchanged.  Then per-token
    p50 and TTFT p99, tuned and default, over two runs each in turns."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.nmg_gemv import row_plan
    from repro_torch.serve import ServeEngine, warmup_engine
    from repro_torch.tune import TuningTable, routing

    t0 = time.perf_counter()
    reqs = requests_for(cfg)
    routing.clear_active_table()
    default = ServeEngine(params, cfg, **ENGINE_KW)
    warmup_engine(default, reqs)
    reset_counts()
    d_outs = default.run(reqs)
    d_counts = read_counts()
    tuned = ServeEngine(params, cfg, **ENGINE_KW)
    t1 = time.perf_counter()
    warmup_engine(tuned, reqs, tune=True)
    warm_s = time.perf_counter() - t1
    table = routing.active_table()
    assert table is not None and table.device.startswith("torch-cuda:")
    reset_counts()
    t_outs = tuned.run(requests_for(cfg))
    torch.cuda.synchronize()
    t_counts = read_counts()
    routed = [k for k in t_counts["routes"] if "[" in k]
    assert routed and all(k.endswith("[table]") for k in routed), \
        (label, t_counts["routes"])
    assert all(len(o.tokens) == 32 for o in t_outs)

    # predict_route against one replay of each program
    chunk = tuned._decode_chunk
    slots = ENGINE_KW["max_slots"]
    tok = np.arange(1, slots + 1, dtype=np.int32)
    pos = np.full(slots, 40, np.int32)
    saved = {k: v.clone() for k, v in tuned.kv.data.items()}
    reset_counts()
    first = chunk.run(tok, pos).clone()
    replay_routes = read_counts()["routes"]
    want = {k: n * tuned.decode_chunk
            for k, n in _predicted(cfg, params, slots).items()}
    assert replay_routes == want, (label, replay_routes, want)
    after_first = {k: v.clone() for k, v in tuned.kv.data.items()}
    rng = np.random.default_rng(5)
    for S in sorted(tuned.kv.prefill_graphs):
        reset_counts()
        tuned.kv.write_prefill(params, rng.integers(
            0, cfg.vocab, (1, S), dtype=np.int32), 1)
        assert read_counts()["routes"] == _predicted(cfg, params, S), \
            (label, S, read_counts()["routes"])
    for k, v in after_first.items():
        tuned.kv.data[k].copy_(v)
    prompt = rng.integers(0, cfg.vocab, (1, 32), dtype=np.int32)
    logits_a = tuned.kv.write_prefill(params, prompt, 2).clone()
    cache_a = {k: v.clone() for k, v in tuned.kv.data.items()}

    # a different table after capture: replays unchanged, bit for bit
    other = TuningTable.for_device()
    for k, v in (("decode_m_max", 0), ("fused_qkv", False),
                 ("fused_ffn", False), ("spmm_cuda", {"splits": 1}),
                 ("gemv_cuda", {"rows": 16, "parts": 1})):
        other.put(k, v)
    routing.set_active_table(other)
    try:
        for k, v in saved.items():
            tuned.kv.data[k].copy_(v)
        reset_counts()
        again = chunk.run(tok, pos).clone()
        assert torch.equal(again, first), f"{label}: chunk replay moved"
        assert read_counts()["routes"] == replay_routes
        assert all(torch.equal(tuned.kv.data[k], v)
                   for k, v in after_first.items())
        logits_b = tuned.kv.write_prefill(params, prompt, 2).clone()
        assert torch.equal(logits_b, logits_a), f"{label}: admission moved"
        assert all(torch.equal(tuned.kv.data[k], v)
                   for k, v in cache_a.items())
        assert _predicted(cfg, params, slots) != \
            {k: n // tuned.decode_chunk for k, n in replay_routes.items()}
    finally:
        routing.set_active_table(table)
    for k, v in saved.items():
        tuned.kv.data[k].copy_(v)

    # tokens where nothing moved; logits wherever something did
    moved = _route_kinds(d_counts["routes"]) != _route_kinds(
        t_counts["routes"])
    for op, w in _projections(cfg, params):
        w0 = w[0] if isinstance(w, tuple) else w
        ctx = ops._route_ctx(w0, cfg.tdtype)
        cfg_t, _ = routing.gemv_cuda_config(**ctx)
        own = row_plan(w0.gr, slots, w0.val.shape[1] * w0.val.shape[2],
                       cfg.tdtype)
        if cfg_t is not None and cfg_t != {"rows": own.rows,
                                           "parts": own.parts}:
            moved = True
        s_cfg, _ = routing.spmm_cuda_config(**ctx)
        if s_cfg is not None and s_cfg.get("splits") is not None:
            moved = True
    d_tokens = [o.tokens for o in d_outs]
    t_tokens = [o.tokens for o in t_outs]
    same = sum(a == b for a, b in zip(d_tokens, t_tokens))
    if not moved:
        assert same == len(d_tokens), f"{label}: tokens moved"
    parity = logit_parity(cfg, params, reference=default_routing)

    # timings, in turns: default, tuned, tuned, default
    runs = {"default": [], "tuned": []}
    for which, eng in (("default", default), ("tuned", tuned),
                       ("tuned", tuned), ("default", default)):
        eng.reset_metrics()
        eng.run(requests_for(cfg))
        runs[which].append(eng.metrics(label=which).to_dict())
    routing.clear_active_table()
    entries = {k: v for k, v in table.entries.items()
               if not k.startswith("matmul_latency/")}
    del default, tuned
    torch.cuda.empty_cache()
    return {"label": label, "wall_s": time.perf_counter() - t0,
            "tune_warmup_s": warm_s, "entries": entries,
            "routes_tuned": t_counts["routes"],
            "routes_default": d_counts["routes"], "moved": moved,
            "same_streams": f"{same}/{len(d_tokens)}", "parity": parity,
            "tok_p50_ms": {k: [m["tok_latency_p50"] * 1e3 for m in v]
                           for k, v in runs.items()},
            "ttft_p99_ms": {k: [m["ttft_p99"] * 1e3 for m in v]
                            for k, v in runs.items()}}


def report_tuned(r, card) -> None:
    print(f"tuned serving[{r['label']}] on {card}: warm-up with tuning "
          f"{r['tune_warmup_s']:.1f} s, phase {r['wall_s']:.1f} s; routes "
          f"moved: {r['moved']}, streams equal {r['same_streams']}, logits "
          f"vs default routing {r['parity']['max_abs_err']:.4f} (bound "
          f"{r['parity']['tol']:.4f}, argmax {r['parity']['argmax_agree']})")
    for k in ("tok_p50_ms", "ttft_p99_ms"):
        print(f"  {k}: tuned " + ", ".join(
            f"{v:.3f}" for v in r[k]["tuned"]) + " | default " + ", ".join(
            f"{v:.3f}" for v in r[k]["default"]))
    for k, v in sorted(r["entries"].items()):
        print(f"  entry {k} = {json.dumps(v)}")


BODY_OF = {"matmul_threshold": "tc"}


def kernels_line(cases, counts, train_counts, sten_counts) -> list:
    """One entry per TPU kernel (every ``pl.pallas_call`` body): the
    serving kernels at qwen1.5-4b shapes (decode M = 4, prompt N = 32)
    with the launches of its n:m:g run; the SpMM's two schedules (rows 3
    and 4) are one CUDA kernel, listed once for each; the training kernels
    at run (b)'s shapes with the launches of run (b).  ``sten_launches``
    is each kernel's launches on the programming-model path (phase 3e:
    its library cases and its full-width model run)."""
    rows = [  # name, kernel, source, replaces, (model, weight, M)
        ("nmg_gemv", "nmg_gemv", "nmg_gemv.cu", "nmg_gemv.py:45",
         ("qwen", "wo_ffn", 4)),
        ("nmg_qkv", "nmg_qkv", "nmg_gemv.cu", "nmg_fused.py:120",
         ("qwen", "wq|wk|wv", 4)),
        ("nmg_spmm", "nmg_spmm", "nmg_spmm.cu", "nmg_spmm.py:93",
         ("qwen", "wi", 32)),
        ("nmg_spmm[grid]", "nmg_spmm", "nmg_spmm.cu", "nmg_spmm.py:67",
         ("qwen", "wi", 32)),
        ("nmg_ffn", "nmg_ffn", "nmg_ffn.cu", "nmg_fused.py:136",
         ("qwen", "wi", 4)),
        ("nm_mask", "nm_mask", "nm_mask.cu", "nm_mask.py:26",
         ("bert-train", "mlp.wo", 0)),
        ("matmul_threshold", "matmul_threshold", "matmul_threshold.cu",
         "fused_sparse_matmul.py:24", ("bert-train", "mlp.wi", TRAIN_TOKENS)),
    ]
    kernels = []
    for name, kernel, src, replaces, (model, wname, M) in rows:
        c = next(c for c in cases if c["kernel"] == kernel
                 and c["model"] == model and c["weight"] == wname
                 and c["M"] == M)
        launches = (train_counts if kernel in TRAIN_KERNELS else counts)
        kernels.append({
            "name": name, "route": "cuda",
            "body": c.get("body", BODY_OF.get(kernel)), "gr": c.get("gr"),
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[kernel],
            "sten_launches": sten_counts[kernel],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == kernel),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": f"{wname} K={c['K']} N={c['N']} M={M}",
            **{k: c[k] for k in ("registers", "smem_bytes") if k in c}})
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm
    from repro_torch.serve import sparsify_for_serving

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sources = ("nmg_gemv", "nmg_spmm", "nmg_ffn", "nm_mask",
               "matmul_threshold")
    build_s = _build.build_all(sources)
    print(f"kernels built in {build_s:.1f} s")
    for name in sources:   # one line per library: its entries' range
        log = _build.ptxas_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill stores", log))
        print(f"  ptxas {name}: {len(regs)} entries, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"{spills} bytes spill stores")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = (kernel_phase(gen, "bert") + kernel_phase(gen, "qwen")
             + any_gr_phase(gen) + train_kernel_phase(gen))
    print(f"kernel phase: {len(cases)} cases within bounds ({card})")
    for c in cases:
        lib = ("none" if c["library_ms"] is None
               else f"{c['library_ms']:.4f} ms")
        extra = "".join(f" {k} {c[k]:.4f}" for k in
                        ("topk_scatter_ms", "kept_share", "ms_f32_out")
                        if k in c)
        extra += "".join(f" {k} {c[k]}" for k in
                         ("body", "gr", "parts", "n_m", "registers",
                          "smem_bytes", "splits") if k in c)
        print(f"  {c['model']} {c['kernel']:8s} {c['weight']:9s} "
              f"M={c['M']:3d} err {c['max_abs_err']:.2e} | kernel "
              f"{c['ms']:.4f} ms (host {c['host_ms']:.4f} ms) "
              f"plain {c['plain_ms']:.4f} ms library {lib} "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}){extra}")

    # the tuning phase, part 1: the CLI, and the crossover and configs
    # at the served widths (a generator of its own: the later phases'
    # inputs stay as they were)
    t0 = time.perf_counter()
    tune = {"cli": tune_cli(),
            "crossover": crossover_phase(
                torch.Generator(device="cuda").manual_seed(22))}
    tune_s = time.perf_counter() - t0
    report_crossover(tune["crossover"], card)

    # (a) bert-base-sten: dense, sparse FFN, sparse FFN + attention
    cfg = get_config("bert-base-sten")
    params = init_lm(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    sparse_ffn = sparsify_for_serving(params, 1, 4, 8, gr=64)
    sparse_all = sparsify_for_serving(params, 1, 4, 8, gr=64, attn=True)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    # gr16, the format of the CPU parity models (prefill through the GEMV
    # kernel's SpMM route): served through the kernels too
    sparse_gr16 = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    runs = [serve_phase(cfg, params, "dense"),
            serve_phase(cfg, sparse_ffn, "sparse_ffn"),
            serve_phase(cfg, sparse_all, "sparse_attn"),
            serve_phase(cfg, sparse_gr16, "sparse_attn_gr16")]
    for r in runs[2:]:
        for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
            assert r["counts"][k] > 0, \
                f"{k} never launched on the {r['label']} path"
    assert runs[1]["counts"]["nmg_qkv"] == 0
    assert all(runs[0]["counts"][k] == 0 for k in KERNELS)
    assert all(r["counts"]["nmg_ffn"] == 0 for r in runs)
    report_runs(runs, card)
    parity = logit_parity(cfg, sparse_all)
    print(f"logit parity (bert attn=True, kernels vs plain): {parity}")
    parity16 = logit_parity(cfg, sparse_gr16)
    print(f"logit parity (bert attn=True gr16, kernels vs plain): "
          f"{parity16}")
    # timed now, profiled at the end (their profiles hold the params)
    graphs = [graph_phase(cfg, p, r["label"]) for p, r in zip(
        (params, sparse_ffn, sparse_all, sparse_gr16), runs)]
    prefills = [prefill_phase(cfg, params, "dense"),
                prefill_phase(cfg, sparse_all, "sparse_attn")]
    tune["serve"] = [serve_tuned(cfg, sparse_all, "bert_attn_gr64")]
    del params, sparse_ffn, sparse_all, sparse_gr16

    # (b) qwen1.5-4b at full width and depth: dense, sparse (attn=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # the bert graph phases' state
    qcfg = get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    qparams = init_lm(qcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    q_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qsparse = sparsify_for_serving(qparams, 1, 4, 8, gr=64, attn=True)
    torch.cuda.synchronize()
    q_convert_s = time.perf_counter() - t0
    # init draws each stacked [L, ...] leaf in f32 before the cast, so the
    # peak so far is init's; serving's own peak is read separately
    q_setup_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    torch.cuda.reset_peak_memory_stats()
    qruns = [serve_phase(qcfg, qparams, "qwen_dense"),
             serve_phase(qcfg, qsparse, "qwen_sparse")]
    qc = qruns[1]["counts"]
    # one fused FFN launch per layer for every decode-shaped forward: each
    # decode step, and each prefill of a prompt of at most 16 tokens
    short = sum(r.prompt.size <= 16 for r in requests_for(qcfg))
    want_ffn = qcfg.n_layers * (qruns[1]["decode_steps"] + short)
    assert qc["nmg_ffn"] == want_ffn, (qc["nmg_ffn"], want_ffn)
    for k in KERNELS:
        assert qc[k] > 0, f"{k} never launched on the qwen1.5-4b path"
    assert all(qruns[0]["counts"][k] == 0 for k in KERNELS)
    report_runs(qruns, card)
    q_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    print(f"qwen1.5-4b on {card}: init {q_init_s:.2f} s, n:m:g conversion "
          f"{q_convert_s:.2f} s, peak device memory {q_setup_peak_gb:.2f} GB "
          f"in init + conversion, {q_peak_gb:.2f} GB serving (dense and "
          f"n:m:g params resident)")
    q_parity = logit_parity(qcfg, qsparse)
    print(f"logit parity (qwen attn=True, kernels vs plain): {q_parity}")
    q_graphs = [graph_phase(qcfg, qparams, "qwen_dense"),
                graph_phase(qcfg, qsparse, "qwen_sparse")]
    prefills += [prefill_phase(qcfg, qparams, "qwen_dense"),
                 prefill_phase(qcfg, qsparse, "qwen_sparse")]
    tune["serve"].append(serve_tuned(qcfg, qsparse, "qwen_attn_gr64"))
    del qparams, qsparse
    for r in tune["serve"]:
        report_tuned(r, card)
    tune["wall_s"] = tune_s + sum(r["wall_s"] for r in tune["serve"])
    print(f"tuning phase on {card}: {tune['wall_s']:.1f} s (CLI "
          f"{tune['cli']['wall_s']:.1f} s, crossover and configs "
          f"{tune_s - tune['cli']['wall_s']:.1f} s, tuned serving "
          + ", ".join(f"{r['label']} {r['wall_s']:.1f} s"
                      for r in tune["serve"]) + ")")

    # (c) bert-base-sten training at full width: the CLI's masked path,
    # then the library API through both training kernels
    train = [train_cli_run(), train_lib_run()]
    ckpt = ckpt_phase()
    print(f"checkpoint/resume (a's model, 6 steps, resumed at step 3) on "
          f"{card}: bitwise the uninterrupted run; {ckpt['leaves']} leaves, "
          f"{ckpt['ckpt_bytes'] / 2**20:.1f} MiB a checkpoint; runs "
          f"{ckpt['full_run_s']:.1f} s and {ckpt['resumed_run_s']:.1f} s")
    print(f"train parity (b, kernels vs plain): {train[1]['parity']}")
    margins = [{"seed": 1, **train[1]["parity"],
                "wi_grad_share_of_bound":
                    train[1]["parity"]["wi_grad_rel_err"] / 2 ** -6}]
    margins += train_margins()
    for mg in margins:
        print(f"train parity (b) seed {mg['seed']}: loss rel err "
              f"{mg['loss_rel_err']:.3e} (bound 1e-3), mlp.wi gradient rel "
              f"err {mg['wi_grad_rel_err']:.5f} (bound 2**-6 = 0.015625, "
              f"{mg['wi_grad_share_of_bound'] * 100:.1f}% of it)")

    # (e) the programming model: the library at the model's shapes, then
    # full-width bert-base-sten under an intermediate and gradient plan
    sten_lib = sten_library_phase(gen)
    sten_model = sten_model_phase(card)
    sten_counts = {kk: sum(c["launches"].get(kk, 0) for c in sten_lib)
                   + sum(v.get(kk, 0) for v in sten_model["counts"].values())
                   for kk in KERNELS + TRAIN_KERNELS}
    for kk in ("nmg_gemv", "nmg_spmm", "nm_mask", "matmul_threshold"):
        assert sten_counts[kk] > 0, f"{kk} never launched on the sten path"

    # every profiler session last: one slows every later launch
    run_profiles()
    report_graphs([finish_graph(p) for p in graphs + q_graphs], card)
    report_prefill(prefills, card)
    report_train(train, card)
    report_sten(sten_lib, sten_model)

    kernels = kernels_line(cases, qc, train[1]["counts"], sten_counts)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s,
        "convert_s": convert_s, "qwen_init_s": q_init_s,
        "qwen_convert_s": q_convert_s, "qwen_setup_peak_gb": q_setup_peak_gb,
        "qwen_serve_peak_gb": q_peak_gb,
        "cases": cases, "runs": runs + qruns,
        "logit_parity": {"bert": parity, "bert_gr16": parity16,
                         "qwen": q_parity},
        "train_margins": margins,
        "graphs": graphs + q_graphs, "prefill": prefills,
        "train": train, "ckpt": ckpt,
        "sten": {"library": sten_lib, "model": sten_model},
        "tuning": tune,
        "kernels": kernels, "wall_s": time.perf_counter() - t_start},
        indent=1))
    print(json.dumps({"serve": {
        r["label"]: {mode: {
            "tok_s": round(r[key]["throughput_tok_s"], 2),
            "p50_ms": round(r[key]["tok_latency_p50"] * 1e3, 4),
            "p99_ms": round(r[key]["tok_latency_p99"] * 1e3, 4),
            "over_dense_p50": round(r["sparse_over_dense_tok_p50"][mode], 4)}
            for mode, key in (("graph", "metrics"),
                              ("eager", "eager_metrics"))}
        for r in runs + qruns},
        "chunk_wall_ms": {p["label"]: {
            "eager": round(p["eager_wall_ms"], 3),
            "replay": round(p["replay_wall_ms"], 3),
            "replay_busy": round(p["replay_busy_ms"], 3)}
            for p in graphs + q_graphs},
        "device_busy_share": {p["label"]: {
            "eager": p["eager_busy_share"], "replay": p["replay_busy_share"]}
            for p in graphs + q_graphs},
        "prefill_ms": {p["label"]: {r["S"]: {
            "replay": round(r["replay_wall_ms"], 3),
            "eager": round(r["eager_wall_ms"], 3),
            "replay_busy": r["replay_busy_ms"]} for r in p["lens"]}
            for p in prefills},
        "ttft_ms": {r["label"]: {mode: [
            round(r[key]["ttft_p50"] * 1e3, 3),
            round(r[key]["ttft_p99"] * 1e3, 3)]
            for mode, key in (("graph", "metrics"),
                              ("eager", "eager_metrics"))}
            for r in runs + qruns},
        "logit_err": {"bert": parity["max_abs_err"],
                      "bert_gr16": parity16["max_abs_err"],
                      "qwen": q_parity["max_abs_err"]},
        "logit_tol": {"bert": parity["tol"], "bert_gr16": parity16["tol"],
                      "qwen": q_parity["tol"]},
        "wi_grad_rel_err": {m["seed"]: m["wi_grad_rel_err"]
                            for m in margins},
        "qwen_peak_gb": {"setup": round(q_setup_peak_gb, 3),
                         "serve": round(q_peak_gb, 3)},
        "train": {r["label"]: {
            "step_ms_p50": round(r["step_ms_p50"], 3),
            "tok_s": round(r["tokens_per_s"], 1),
            "loss_first": round(r["loss_first"], 4),
            "loss_last": round(r["loss_last"], 4),
            "peak_gb": round(r["peak_gb"], 3),
            "host_loop_step_ms_p50": round(r["eager"]["step_ms_p50"], 3),
            **{f"{mode}_step": {
                "wall_ms": round(r[f"timed_{mode}"]["step_wall_ms"], 3),
                "device_busy_share": r[f"timed_{mode}"]["device_busy_share"],
                "launches": r[f"timed_{mode}"]["launches"]
                / r[f"timed_{mode}"]["steps"]}
               for mode in ("graph", "eager")},
            "capture_ms": round(r["graph"]["capture_ms"], 1),
            "instantiate_ms": round(r["graph"]["instantiate_ms"], 1),
            "pool_mib": round(r["graph"]["pool_bytes"] / 2**20, 1)}
            for r in train},
        "ckpt_resume_bitwise": ckpt["bitwise"],
        "tuning": {
            "wall_s": round(tune["wall_s"], 1),
            "crossover": {f"{r['model']}.{r['weight']}": {
                "own": r["own"]["crossover"],
                "tuned": r["tuned"]["crossover"],
                "gemv_cuda": r["gemv_cuda"], "spmm_cuda": r["spmm_cuda"]}
                for r in tune["crossover"]},
            "serve": {r["label"]: {
                "tok_p50_ms": r["tok_p50_ms"],
                "ttft_p99_ms": r["ttft_p99_ms"], "moved": r["moved"],
                "same_streams": r["same_streams"],
                "logit_err": r["parity"]["max_abs_err"]}
                for r in tune["serve"]}},
        "sten": {"loss_max_rel_err": sten_model["loss_max_rel_err"],
                 "step_wall_ms": round(sten_model["step_wall_ms"], 3),
                 "device_busy_share":
                     sten_model["profile"].get("device_busy_share"),
                 "conversion_share": round(
                     sten_model["conversion_share"], 4),
                 "peak_gb": round(sten_model["peak_gb"], 3),
                 "launches": {kk: v for kk, v in sten_counts.items() if v}},
        "wall_s": round(time.perf_counter() - t_start, 1)}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
