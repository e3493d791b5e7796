#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch/CUDA versions; the
   port's CUDA kernels are built from ``src/repro_torch/csrc`` (one nvcc
   per source, started together).
2. Kernel phase, bf16 at bert-base-sten 1:4:8 gr64 shapes: each kernel's
   wrapper against its plain PyTorch version on the same inputs (fused QKV
   bitwise against three GEMV launches), then timed with CUDA events
   against the plain version and one ``torch.matmul`` on the densified
   weight (a yardstick only; the port never calls it).  The device L2 is
   flushed before every timed launch: on the serving path a layer's
   weights are cold when its turn comes.
3. Main path: full-width bert-base-sten (12 layers, d_model 768, d_ff
   3072, vocab 30522, bf16) with seeded random weights serves 8 requests
   through the port's ServeEngine — dense, n:m:g 1:4:8 gr64 on the FFN
   (fig11's setting) and n:m:g on FFN and attention (``attn=True``).
   Launch counts are zeroed right before each run and read right after.
   The ``attn=True`` model's prefill and decode logits through the kernels
   are then held against the same steps through the plain versions.
4. Summary: a compact ``{"serve": ...}`` line, a ``{"kernels": [...]}``
   line, the ``nvidia-smi`` line, and last ``{"ok": true, "device":
   {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.

Any failure raises and the script exits non-zero; without CUDA it exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
REPS = 30
SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's ~1.98 GHz boost clock

# bert-base-sten projections as [K, N] weights (sparse along K)
SHAPES = {"wi": (768, 3072), "wo_ffn": (3072, 768), "wq": (768, 768)}


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
    yardstick, and the host cost of issuing the kernel."""
    return {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "host_ms": host_ms(kernel)}


def bound(nbytes: int, flops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def storage_bytes(w) -> int:
    cols = w.gather_plan().cols
    return w.val.numel() * w.val.element_size() + cols.numel() * 4


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(gen) -> list:
    import torch

    from repro_torch.core.nmg import dense_to_grouped_nm
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    W = {}
    for name, (K, N) in SHAPES.items():
        dense = (torch.randn(K, N, generator=gen, device="cuda")
                 / math.sqrt(K)).to(bf16)
        W[name] = dense_to_grouped_nm(dense, 1, 4, 8, gr=64, sparse_dim=0)
    qkv = [W["wq"]] + [dense_to_grouped_nm(
        (torch.randn(768, 768, generator=gen, device="cuda")
         / math.sqrt(768)).to(bf16), 1, 4, 8, gr=64, sparse_dim=0)
        for _ in range(2)]
    dense_of = {id(w): w.to_dense() for w in list(W.values()) + qkv}
    cases = []

    def x_of(M, K):
        return torch.randn(M, K, generator=gen, device="cuda").to(bf16)

    # GEMV (decode): the main path calls it with B = x.T, a bf16 epilogue
    # and the transposed [M, N] output
    for name in ("wi", "wo_ffn", "wq"):
        w = W[name]
        K, N = SHAPES[name]
        for M in (1, 4, 8, 16):
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
            wd = dense_of[id(w)]
            b, t = bound(storage_bytes(w) + x.numel() * 2 + M * N * 2,
                         2 * w.val.numel() * M)
            cases.append(dict(
                kernel="nmg_gemv", weight=name, K=K, N=N, M=M,
                max_abs_err=err32, tol=tol32, max_abs_err_bf16_out=err16,
                **timings(lambda: nmg_gemv.nmg_gemv(
                    w, x.T, out_dtype=bf16, transpose_out=True),
                    lambda: nmg_gemv.nmg_gemv_plain(
                        w, x.T, out_dtype=bf16, transpose_out=True),
                    lambda: torch.matmul(x, wd), flush),
                bound_ms=b, bound_by=t))

    # fused QKV: one launch over three segments, bitwise equal to three
    wqkv = torch.cat([dense_of[id(w)] for w in qkv], dim=1)
    for M in (1, 4, 8, 16):
        x = x_of(M, 768)
        fused = nmg_fused.nmg_qkv(qkv, x.T, out_dtype=bf16,
                                  transpose_out=True)
        for f, w in zip(fused, qkv):
            seq = nmg_gemv.nmg_gemv(w, x.T, out_dtype=bf16,
                                    transpose_out=True)
            assert torch.equal(f, seq), "fused QKV differs from 3 launches"
        plain32 = nmg_fused.nmg_qkv_plain(qkv, x.T, transpose_out=True)
        got32 = nmg_fused.nmg_qkv(qkv, x.T, transpose_out=True)
        err32 = max((g - p).abs().max().item()
                    for g, p in zip(got32, plain32))
        tol32 = 1e-4 * max(1.0, max(p.abs().max().item() for p in plain32))
        assert err32 <= tol32, ("qkv", M, err32)
        b, t = bound(sum(storage_bytes(w) for w in qkv) + x.numel() * 2
                     + 3 * M * 768 * 2, 2 * sum(w.val.numel() for w in qkv) * M)
        cases.append(dict(
            kernel="nmg_qkv", weight="wq|wk|wv", K=768, N=3 * 768, M=M,
            max_abs_err=err32, tol=tol32, bitwise_vs_3_gemv=True,
            **timings(lambda: nmg_fused.nmg_qkv(
                qkv, x.T, out_dtype=bf16, transpose_out=True),
                lambda: nmg_fused.nmg_qkv_plain(
                    qkv, x.T, out_dtype=bf16, transpose_out=True),
                lambda: torch.matmul(x, wqkv), flush),
            bound_ms=b, bound_by=t))

    # SpMM (prefill): B = x.T with N prompt tokens, f32 [R, N] out, at
    # every shape the main path gives it (its prompts are 24, 32 and 64
    # tokens; the attention projections are 768 x 768)
    for name in ("wi", "wo_ffn", "wq"):
        w = W[name]
        K, R = SHAPES[name]
        for Ntok in (17, 24, 32, 64, 128):
            x = x_of(Ntok, K)
            got = nmg_spmm.nmg_spmm(w, x.T)
            ref = nmg_spmm.nmg_spmm_plain(w, x.T)
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert err <= tol, (name, Ntok, err)
            wd = dense_of[id(w)]
            b, t = bound(storage_bytes(w) + x.numel() * 2 + R * Ntok * 4,
                         2 * w.val.numel() * Ntok)
            cases.append(dict(
                kernel="nmg_spmm", weight=name, K=K, N=R, M=Ntok,
                max_abs_err=err, tol=tol,
                **timings(lambda: nmg_spmm.nmg_spmm(w, x.T),
                          lambda: nmg_spmm.nmg_spmm_plain(w, x.T),
                          lambda: torch.matmul(x, wd), flush),
                bound_ms=b, bound_by=t))
    del flush
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm, ops

    ops.reset_kernel_counters()
    nmg_gemv.nmg_gemv.launches = 0
    nmg_fused.nmg_qkv.launches = 0
    nmg_spmm.nmg_spmm.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm, ops

    return {"nmg_gemv": nmg_gemv.nmg_gemv.launches,
            "nmg_qkv": nmg_fused.nmg_qkv.launches,
            "nmg_spmm": nmg_spmm.nmg_spmm.launches,
            "routes": {f"{k}/{p}": v
                       for (k, p), v in ops.kernel_counters().items()}}


@contextlib.contextmanager
def plain_versions():
    """Run the model with every kernel wrapper swapped for its plain
    version (on the same CUDA tensors) — the reference side of the
    logit parity check."""
    from repro_torch.kernels import nmg_fused, nmg_gemv, nmg_spmm

    saved = (nmg_gemv.nmg_gemv, nmg_spmm.nmg_spmm, nmg_fused.nmg_qkv)
    nmg_gemv.nmg_gemv = nmg_gemv.nmg_gemv_plain
    nmg_spmm.nmg_spmm = nmg_spmm.nmg_spmm_plain
    nmg_fused.nmg_qkv = nmg_fused.nmg_qkv_plain
    try:
        yield
    finally:
        nmg_gemv.nmg_gemv, nmg_spmm.nmg_spmm, nmg_fused.nmg_qkv = saved


def serve_phase(cfg, params, label, reqs_fn, ekw) -> dict:
    import torch

    from repro_torch.serve import ServeEngine, warmup_engine

    warmup_engine(params, cfg, reqs_fn(), engine_kwargs=ekw)
    torch.cuda.synchronize()
    reset_counts()
    eng = ServeEngine(params, cfg, **ekw)
    outs = eng.run(reqs_fn())
    torch.cuda.synchronize()
    counts = read_counts()
    assert len(outs) == 8, f"{label}: {len(outs)} of 8 requests finished"
    for o in outs:
        assert o.finish_reason == "length" and len(o.tokens) == 32, (
            label, o.uid, o.finish_reason, len(o.tokens))
        assert all(0 <= t < cfg.vocab for t in o.tokens)
    assert not any(k.endswith("/plain") for k in counts["routes"]), counts
    met = eng.metrics(label=label)
    return {"label": label, "metrics": met.to_dict(), "counts": counts,
            "first_tokens": [o.tokens[:4] for o in outs]}


def logit_parity(cfg, params) -> dict:
    """Prefill (a 32-token prompt: SpMM; a 16-token prompt: GEMV + fused
    QKV) and 4 decode steps, through the kernels and through the plain
    versions, fed the same tokens.  Bound: 5% of the largest plain logit —
    bf16 activations round at ~2**-8 relative per op, and rounding flips
    between two summation orders compound over 12 layers."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(1)
    worst, scale, agree, total = 0.0, 0.0, 0, 0
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

        with plain_versions():
            want, fed = steps()
        got, _ = steps(fed)
        for g, w in zip(got, want):
            worst = max(worst, (g - w).abs().max().item())
            scale = max(scale, w.abs().max().item())
            agree += int(torch.equal(g.argmax(-1), w.argmax(-1)))
            total += 1
    tol = 0.05 * scale
    assert worst <= tol, f"kernel vs plain logits differ by {worst} > {tol}"
    return {"max_abs_err": worst, "tol": tol, "max_abs_logit": scale,
            "argmax_agree": f"{agree}/{total}"}


def profile_decode(cfg, params, label) -> dict:
    """Where a decode step's time goes: one 8-step greedy chunk at 4 slots
    (prompts of 32 tokens), timed plain and then under torch.profiler.
    Device-busy time is the sum of the kernels' device times; the busy
    share divides it by the unprofiled wall time of the same chunk."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache, prefill_into_slot
    from repro_torch.serve.engine import decode_chunk

    rng = np.random.default_rng(2)
    cache = init_cache(cfg, 4, 96, device="cuda")
    for slot in range(4):
        prefill_into_slot(params, cfg, torch.as_tensor(
            rng.integers(0, cfg.vocab, (1, 32)), device="cuda"), cache, slot)
    tok = torch.zeros(4, 1, dtype=torch.int32, device="cuda")
    pos = torch.full((4,), 32, dtype=torch.int32, device="cuda")

    def chunk():
        t0 = time.perf_counter()
        toks, _ = decode_chunk(params, cfg, tok, cache, pos, 8)
        toks.cpu()
        return time.perf_counter() - t0

    chunk()
    wall = statistics.median(chunk() for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = chunk()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    return {
        "label": label, "chunk_wall_ms": wall * 1e3,
        "chunk_wall_profiled_ms": wall_prof * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
        "kernel_launches_per_step": launches / 8,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_us": dev_us(e)} for e in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, sparsify_for_serving

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = _build.build_all(["nmg_gemv", "nmg_spmm"])
    print(f"kernels built in {build_s:.1f} s")
    for name in ("nmg_gemv", "nmg_spmm"):
        for line in _build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = kernel_phase(gen)
    print(f"kernel phase: {len(cases)} cases within bounds ({card})")
    for c in cases:
        print(f"  {c['kernel']:8s} {c['weight']:9s} M={c['M']:3d} "
              f"err {c['max_abs_err']:.2e} | kernel {c['ms']:.4f} ms "
              f"(host {c['host_ms']:.4f} ms) "
              f"plain {c['plain_ms']:.4f} ms matmul {c['library_ms']:.4f} ms "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")

    cfg = get_config("bert-base-sten")
    params = init_lm(cfg, seed=0, device="cuda")
    prompt_lens = (32, 24, 64, 16)

    def reqs():
        rng = np.random.default_rng(0)
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, prompt_lens[i % 4], dtype=np.int32),
            max_new_tokens=32) for i in range(8)]

    ekw = dict(max_slots=4, max_seq_len=max(prompt_lens) + 32,
               decode_chunk=8, device="cuda")
    t0 = time.perf_counter()
    sparse_ffn = sparsify_for_serving(params, 1, 4, 8, gr=64)
    sparse_all = sparsify_for_serving(params, 1, 4, 8, gr=64, attn=True)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    runs = [serve_phase(cfg, params, "dense", reqs, ekw),
            serve_phase(cfg, sparse_ffn, "sparse_ffn", reqs, ekw),
            serve_phase(cfg, sparse_all, "sparse_attn", reqs, ekw)]
    main_counts = runs[2]["counts"]
    for k in ("nmg_gemv", "nmg_qkv", "nmg_spmm"):
        assert main_counts[k] > 0, f"{k} never launched on the main path"
    assert runs[1]["counts"]["nmg_qkv"] == 0
    assert runs[0]["counts"]["nmg_gemv"] == 0
    dense_p50 = runs[0]["metrics"]["tok_latency_p50"]
    for r in runs:
        m = r["metrics"]
        r["sparse_over_dense_tok_p50"] = m["tok_latency_p50"] / dense_p50
        print(f"serve[{r['label']}] on {card}: {m['num_requests']} requests "
              f"{m['num_tokens']} tokens, {m['throughput_tok_s']:.1f} tok/s, "
              f"per-token p50 {m['tok_latency_p50'] * 1e3:.3f} ms p99 "
              f"{m['tok_latency_p99'] * 1e3:.3f} ms, ttft p50 "
              f"{m['ttft_p50'] * 1e3:.3f} ms, sparse/dense p50 "
              f"{r['sparse_over_dense_tok_p50']:.3f}, launches "
              f"gemv {r['counts']['nmg_gemv']} qkv {r['counts']['nmg_qkv']} "
              f"spmm {r['counts']['nmg_spmm']}")
    parity = logit_parity(cfg, sparse_all)
    print(f"logit parity (attn=True, kernels vs plain): {parity}")
    profiles = [profile_decode(cfg, params, "dense"),
                profile_decode(cfg, sparse_all, "sparse_attn")]
    for p in profiles:
        busy = p["device_busy_share"]
        print(f"decode chunk[{p['label']}] on {card}: 8 steps "
              f"{p['chunk_wall_ms']:.2f} ms wall, device busy "
              + ("not measured (profiler saw no device time)" if busy is None
                 else f"{p['device_busy_ms']:.3f} ms ({busy * 100:.1f}%)")
              + f", {p['kernel_launches_per_step']:.0f} launches/step")
        for k in p["top_kernels"]:
            print(f"    {k['device_us']:9.1f} us x{k['count']:4d} {k['name']}")

    rep = {"nmg_gemv": ("wi", 4), "nmg_qkv": ("wq|wk|wv", 4),
           "nmg_spmm": ("wi", 32)}
    src = {"nmg_gemv": ("src/repro_torch/csrc/nmg_gemv.cu",
                        "src/repro/kernels/nmg_gemv.py:45"),
           "nmg_qkv": ("src/repro_torch/csrc/nmg_gemv.cu",
                       "src/repro/kernels/nmg_fused.py:120"),
           "nmg_spmm": ("src/repro_torch/csrc/nmg_spmm.cu",
                        "src/repro/kernels/nmg_spmm.py:93")}
    kernels = []
    for name, (wname, M) in rep.items():
        c = next(c for c in cases if c["kernel"] == name
                 and c["weight"] == wname and c["M"] == M)
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": main_counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": f"{wname} K={c['K']} N={c['N']} M={M}"})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s,
        "convert_s": convert_s, "cases": cases, "runs": runs,
        "logit_parity": parity, "profiles": profiles, "kernels": kernels,
        "wall_s": time.perf_counter() - t_start}, indent=1))
    print(json.dumps({"serve": {
        r["label"]: {"tok_s": round(r["metrics"]["throughput_tok_s"], 2),
                     "p50_ms": round(r["metrics"]["tok_latency_p50"] * 1e3, 4),
                     "p99_ms": round(r["metrics"]["tok_latency_p99"] * 1e3, 4),
                     "over_dense_p50": round(r["sparse_over_dense_tok_p50"],
                                             4)} for r in runs},
        "chunk_wall_ms": {p["label"]: round(p["chunk_wall_ms"], 3)
                          for p in profiles},
        "logit_err": parity["max_abs_err"], "logit_tol": parity["tol"]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
