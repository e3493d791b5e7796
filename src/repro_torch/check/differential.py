"""Differential mode: static route predictions against runtime counters
(port of ``repro/check/differential.py``).

``kernels/ops.py:predict_route`` follows the router's lookups without
running anything; this module serves a quick warm-up through the engine
(``serve/engine.py:warmup_engine``, the hook the benchmarks use) at
prompt lengths on both sides of the GEMV/SpMM crossover, then compares
the predicted ``kernel_counters`` keys with the ones the run recorded.
The port's keys also say where the work ran (``("nmg_gemv", "cuda")``
on the card, ``"plain"`` on the CPU) and, on the card, the SpMM's K split
(``("nmg_spmm_cuda", "auto[default]")``), so the comparison covers the
launches as well as the routes.  Any disagreement is an ERROR: either
the predictor (and so the checker's static story) or the router is
wrong, and both are load-bearing.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from repro_torch.check.diagnostics import Diagnostic, Severity
from repro_torch.check.entries import CHECK_GR, CHECK_NM, check_config, \
    init_params
from repro_torch.check.program import collect_sparse_weights
from repro_torch.core.layouts import GroupedNMTensor

__all__ = ["differential_check"]

#: the serving kernels' keys: the router's decisions and where each
#: kernel ran
_ROUTED = ("nmg_linear", "nmg_matmul", "nmg_gemv", "nmg_spmm",
           "nmg_spmm_cuda", "nmg_qkv", "nmg_ffn")


def _predicted_keys(cfg, sparse_params, widths, device) -> set:
    """Every routed key the engine should record when it runs each n:m:g
    weight at each activation width (a gated MLP's packed ``wi`` through
    the fused FFN entry)."""
    kops = importlib.import_module("repro_torch.kernels.ops")
    keys: set = set()
    for path, w in collect_sparse_weights(sparse_params).items():
        if not isinstance(w, GroupedNMTensor):
            continue
        w = w.layer(0) if w.stacked else w
        op = "mm_gated" if cfg.gated_mlp and path.endswith("wi") \
            else "nmg_linear"
        for M in widths:
            keys.update(kops.predict_route(op, w, M=M, dtype=cfg.tdtype,
                                           device=device))
    return {k for k in keys if k[0] in _ROUTED}


def differential_check(*, arch: str = "bert-base-sten",
                       prompt_lens: tuple = (24, 8), max_slots: int = 4,
                       seed: int = 0, device="cuda") -> tuple[list, dict]:
    """-> (diagnostics, detail).  Empty diagnostics means every routed op
    agreed between the static prediction and the runtime counters."""
    from repro_torch.serve import Request, SamplingParams, ServeEngine
    from repro_torch.serve.engine import sparsify_for_serving, warmup_engine

    disp = importlib.import_module("repro_torch.core.dispatch")
    kops = importlib.import_module("repro_torch.kernels.ops")

    device = torch.device(device)
    cfg = check_config(arch)
    n, m, g = CHECK_NM
    sparse = sparsify_for_serving(init_params(cfg, device), n, m, g,
                                  gr=CHECK_GR)

    # decode always runs at the full slot batch; prefill at each prompt len
    widths = sorted({max_slots, *prompt_lens})
    predicted = _predicted_keys(cfg, sparse, widths, device)

    rng = np.random.default_rng(seed)
    reqs = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=plen,
                                           dtype=np.int32),
                max_new_tokens=2, sampling=SamplingParams(greedy=True))
        for i, plen in enumerate(prompt_lens)
    ]
    kern_before = kops.kernel_counters()
    launches_before = kops.counter_snapshot()["launches"]
    disp_before = disp.dispatch_counters()
    eng = ServeEngine(sparse, cfg, max_slots=max_slots,
                      max_seq_len=max(prompt_lens) + 16, decode_chunk=4,
                      device=device)
    warmup_engine(eng, reqs)
    observed = {
        k for k, v in kops.kernel_counters().items()
        if v > kern_before.get(k, 0) and k[0] in _ROUTED
    }
    launches = {k: v - launches_before[k]
                for k, v in kops.counter_snapshot()["launches"].items()
                if v > launches_before[k]}
    fallbacks = {
        k: v - disp_before.get(k, 0)
        for k, v in disp.dispatch_counters().items()
        if v > disp_before.get(k, 0) and k[0] == "dense_fallback"
    }

    diags = []
    entry = f"{arch}/differential"
    for key in sorted(predicted - observed):
        diags.append(Diagnostic(
            rule="DIFF", severity=Severity.ERROR, entry=entry,
            message=f"predict_route expected counter {key} but the warmup "
                    f"never recorded it — the static route model is ahead "
                    f"of the runtime router",
            op=str(key), location="kernel-counters",
            fix="align kernels.ops.predict_route with the routing branch "
                "it mirrors",
        ))
    for key in sorted(observed - predicted):
        diags.append(Diagnostic(
            rule="DIFF", severity=Severity.ERROR, entry=entry,
            message=f"runtime recorded counter {key} that predict_route "
                    f"did not predict — the router took a path the static "
                    f"model does not know about",
            op=str(key), location="kernel-counters",
            fix="align kernels.ops.predict_route with the routing branch "
                "it mirrors",
        ))
    for key, count in sorted(fallbacks.items()):
        diags.append(Diagnostic(
            rule="DIFF", severity=Severity.ERROR, entry=entry,
            message=f"warmup ran through the dense fallback {key} "
                    f"({count}x) — the quick run is not on the sparse "
                    f"kernels at all",
            op=str(key), location="dispatch-counters",
        ))
    detail = {
        "predicted": sorted(map(str, predicted)),
        "observed": sorted(map(str, observed)),
        "launches": launches,
        "widths": widths,
        "agree": not diags,
    }
    return diags, detail
