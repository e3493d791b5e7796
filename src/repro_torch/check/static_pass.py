"""Run-evidence detectors (dispatch counters, conversion log, routed
shared-memory estimates, device kind): R1's counter half, R2, R6, R7
(port of ``repro/check/static_pass.py``).

R6 is re-targeted to Hopper.  The reference sizes a Pallas config's VMEM
working set; the port's knob is the decode ``tc`` body's ``{rows,
parts}`` (``tune/routing.py:gemv_cuda_config``, one entry for the GEMV,
the fused QKV launch and the FFN) and the SpMM's ``{splits}``
(``spmm_cuda_config``), and what a bad one overruns is the block's
shared memory.  The estimators below are Python copies of the CUDA
formulas, so they run on the CPU: ``tc::smem_bytes`` of
``csrc/nmg_rows.cuh`` (``nw = 2`` for the FFN's two weights a row,
``csrc/nmg_ffn.cu``) and ``tc_smem_bytes`` / ``tc_shape`` of
``csrc/nmg_spmm.cu``.  ``chip_smoke.py`` holds them equal to the
libraries' own figures (``nmg_rows_tc_smem_bytes``,
``nmg_spmm_tc_plan``).  Each estimate adds the entry's static shared
memory, and its registers a block, where the build log
(``kernels/_build.py:ptxas_usage``) has them, and is judged against the
device's per-block budgets in ``launch/hw.py``.  The ``rows`` and
``general`` decode bodies and the f32 SpMM take no dynamic shared memory.
"""

from __future__ import annotations

import collections
import importlib

import torch

from repro_torch.check.diagnostics import Diagnostic, Severity
from repro_torch.kernels.nmg_gemv import MAX_M, chunk_geometry, row_plan
from repro_torch.launch.hw import hw_for_device
from repro_torch.tune import routing

__all__ = ["static_r1", "static_r2", "static_r6", "static_r7",
           "gemv_smem", "spmm_smem", "tc_smem_bytes", "window_pitch",
           "spmm_tc_shape", "spmm_tc_smem_bytes"]


def static_r1(program) -> list:
    """Dense-fallback dispatches recorded while this program ran: a sparse
    layout was materialized for a reference dense op."""
    diags = []
    for (outcome, op, sig), count in sorted(program.fallbacks.items()):
        if outcome != "dense_fallback":
            continue
        diags.append(Diagnostic(
            rule="R1", severity=Severity.ERROR, entry=program.name,
            message=f"dispatcher fell back to the dense implementation of "
                    f"{op!r} for signature {list(sig)} ({count} call(s)) "
                    f"— the sparse operand was silently densified",
            op=op, location="dispatch-counters",
            fix=f"register a sparse implementation for ({op}, "
                f"{list(sig)}) or convert the operand to a supported "
                f"layout before the call",
        ))
    return diags


def static_r2(program) -> list:
    """Conversion churn: the same (layout -> layout, shape) conversion ran
    more than once in one run of a program — each repeat re-materializes
    and re-compresses the same weight."""
    counts = collections.Counter(
        (src, dst, shape) for src, dst, shape in program.conversions
        if src != "DenseTensor"
    )
    diags = []
    for (src, dst, shape), n in sorted(counts.items()):
        if n <= 1:
            continue
        diags.append(Diagnostic(
            rule="R2", severity=Severity.WARNING, entry=program.name,
            message=f"{src} -> {dst} conversion of shape {list(shape)} ran "
                    f"{n}x in one run of the program — convert once and "
                    f"reuse the converted layout",
            op=f"{src}->{dst}", location="conversion-log",
            fix="hoist the conversion out of the program (convert at "
                "load/sparsify time, not per call)",
        ))
    return diags


# ---------------------------------------------------------------------------
# R6: the routed configs' shared memory a block (the CUDA formulas)
# ---------------------------------------------------------------------------

#: csrc/nmg_rows.cuh, namespace tc
_TC_SLAB = 64
_TC_STAGES = 4


def window_pitch(per: int, cs: int, cx: int) -> int:
    """``tc::window_pitch``: row pitch (elements) of a part's staged B
    window."""
    v = per * _TC_SLAB
    return (((v + cs - 1) // cs + (v % cs != 0)) * cx
            + (7 if cx % 8 else 0) + 7) // 8 * 8


def tc_smem_bytes(rows: int, nw: int, nt8: int, per: int, parts: int,
                  wp: int, m: int) -> int:
    """``tc::smem_bytes``: the ring, the gathered B, the part sums a block
    receives and, when B is staged (``wp > 0``), the window and the
    part's plan entries."""
    ring = min(per, _TC_STAGES) * nw * rows * _TC_SLAB * 2
    sb = nw * 8 * nt8 * (per * _TC_SLAB + 8) * 2
    owned = (rows + parts - 1) // parts
    recv = (parts * nw * owned * m + 3) // 4 * 4 * 4
    staged = m * wp * 2 + nw * per * _TC_SLAB * 4 if wp > 0 else 0
    return ring + sb + recv + staged


#: csrc/nmg_spmm.cu, the bf16 body
_T_BK, _T_STAGES, _T_PK, _T_PX = 64, 4, 72, 256
_T_MAX_COLS, _T_MAX_STAGED_COLS = 64, 32
_SMS = 132


def spmm_tc_smem_bytes(row_warps: int, nt8: int, staged: bool) -> int:
    """``tc_smem_bytes``: a ring of stages (val slab, its cols, in staged
    mode every token's B window) and two gathered B slabs."""
    stage = (16 * row_warps * _T_PK * 2 + _T_BK * 4
             + (8 * nt8 * _T_PX * 2 if staged else 0))
    return _T_STAGES * stage + 2 * 8 * nt8 * _T_PK * 2


def _requested_splits(want: int, nslab: int) -> int:
    if want < 1 or want > nslab:
        return -1
    per = (nslab + want - 1) // want
    return want if (nslab + per - 1) // per == want else -1


def spmm_tc_shape(R_pad: int, N: int, KN: int, gr: int, staged: bool,
                  want: int = 0) -> dict:
    """``tc_shape``: the bf16 SpMM's block and split for this shape
    (``splits`` -1 when a requested split cannot be taken)."""
    row_warps = 8 if gr % 128 == 0 else 4
    widest = _T_MAX_STAGED_COLS if staged else _T_MAX_COLS
    ntiles = (N + widest - 1) // widest
    tile_cols = ((N + ntiles - 1) // ntiles + 7) // 8 * 8
    nt8 = tile_cols // 8
    col_tiles = (N + tile_cols - 1) // tile_cols
    tiles = R_pad // (16 * row_warps) * col_tiles
    nslab = (KN + _T_BK - 1) // _T_BK
    z = 1
    if want > 0:
        z = _requested_splits(want, nslab)
        if z < 0:
            return dict(row_warps=row_warps, nt8=nt8, col_tiles=col_tiles,
                        splits=-1, per=0, staged=staged, smem=0)
    elif tiles < _SMS:
        z = max(1, min((2 * _SMS + tiles - 1) // tiles, nslab // 2))
    per = (nslab + z - 1) // z
    return dict(row_warps=row_warps, nt8=nt8, col_tiles=col_tiles,
                splits=(nslab + per - 1) // per, per=per, staged=staged,
                smem=spmm_tc_smem_bytes(row_warps, nt8, staged))


def _ctx(w, dtype) -> dict:
    sd = w.sparse_dim % 2
    return dict(K=int(w.dense_shape[sd]), R=int(w.dense_shape[1 - sd]),
                fmt=(w.n, w.m, w.g), gr=w.gr, dtype=dtype)


def _stored(w) -> int:
    return int(w.val.shape[-2] * w.val.shape[-1])


def _estimate(kernel, cfg, src, width_key, width, device_kind, weight,
              dynamic, entry, threads, error=None, lib=None) -> dict:
    """One estimate: ``dynamic`` bytes from the formulas, plus the static
    shared memory and registers of ``entry`` in library ``lib`` (default
    ``kernel``'s) where its build log has them."""
    from repro_torch.kernels import _build

    hw, _ = hw_for_device(device_kind)
    res = _build.ptxas_usage(lib or kernel, entry) if entry else None
    static = res["static_smem_bytes"] if res else 0
    regs = res["registers"] * threads if res else None
    return {"kernel": kernel, "weight": weight, "config": cfg,
            "source": src, width_key: int(width), "entry": entry,
            "dynamic_bytes": dynamic, "static_bytes": static,
            "bytes": None if dynamic is None else dynamic + static,
            "budget": int(hw["smem_per_block_bytes"]),
            "registers": regs, "register_budget": int(hw["regs_per_sm"]),
            "device": device_kind, "error": error}


def gemv_smem(w, dtype, M: int, device_kind: str, *, weight: str = "",
              ffn: bool = False) -> dict:
    """Shared memory a block of the routed decode body for ``w`` against
    ``M`` columns of B = x.T (token-major x, staged when its rows allow
    16-byte copies): the GEMV's, or with ``ffn`` (a gated MLP's packed
    ``wi``) the fused FFN's where that launch takes it."""
    kops = importlib.import_module("repro_torch.kernels.ops")
    ctx = _ctx(w, dtype)
    cfg, src = routing.gemv_cuda_config(**ctx)
    kernel = "nmg_gemv"
    if ffn and kops._ffn_eligible(w) and routing.fused_ffn(**ctx)[0]:
        kernel = "nmg_ffn"
    try:
        plan = row_plan(w.gr, M, _stored(w), dtype, cfg)
    except ValueError as e:
        return _estimate(kernel, cfg, src, "M", M, device_kind, weight,
                         None, None, 0, error=str(e))
    if plan.body != "tc":
        return _estimate(kernel, cfg, src, "M", M, device_kind, weight,
                         0, f"{kernel}_kernel", 256)
    cs, cx = chunk_geometry(w)
    wp = window_pitch(plan.per, cs, cx) if ctx["K"] % 8 == 0 else 0
    nw = 2 if kernel == "nmg_ffn" else 1
    dynamic = tc_smem_bytes(plan.rows, nw, plan.nt8, plan.per, plan.parts,
                            wp, min(M, MAX_M))
    return _estimate(kernel, cfg, src, "M", M, device_kind, weight,
                     dynamic,
                     f"{kernel}_tc_kernelILi{plan.nt8}ELi{plan.rows // 16}E",
                     2 * plan.rows)


def spmm_smem(w, dtype, N: int, device_kind: str, *,
              weight: str = "") -> dict:
    """Shared memory a block of the routed prefill SpMM for ``w`` against
    ``N`` columns of B = x.T.  A gr not a multiple of 64 takes the GEMV
    kernel over 16-column chunks (no config); the bf16 body sizes its
    block from the shape and the routed K split; the f32 body has only
    static shared memory."""
    ctx = _ctx(w, dtype)
    staged = ctx["K"] % 8 == 0
    if w.gr % 64:
        plan = row_plan(w.gr, N, _stored(w), dtype)
        if plan.body != "tc":
            return _estimate("nmg_spmm", None, "default", "N", N,
                             device_kind, weight, 0, "nmg_gemv_kernel", 256,
                             lib="nmg_gemv")
        cs, cx = chunk_geometry(w)
        wp = window_pitch(plan.per, cs, cx) if staged else 0
        return _estimate(
            "nmg_spmm", None, "default", "N", N, device_kind, weight,
            tc_smem_bytes(plan.rows, 1, plan.nt8, plan.per, plan.parts, wp,
                          min(N, MAX_M)),
            f"nmg_gemv_tc_kernelILi{plan.nt8}ELi{plan.rows // 16}E",
            2 * plan.rows, lib="nmg_gemv")
    cfg, src = routing.spmm_cuda_config(**ctx)
    if dtype != torch.bfloat16:
        return _estimate("nmg_spmm", cfg, src, "N", N, device_kind,
                         weight, 0, "nmg_spmm_kernel", 256)
    want = 0 if cfg is None or cfg.get("splits") is None \
        else int(cfg["splits"])
    sh = spmm_tc_shape(int(w.val.shape[-3]), N, _stored(w), w.gr, staged,
                       want)
    if sh["splits"] < 0:
        return _estimate("nmg_spmm", cfg, src, "N", N, device_kind,
                         weight, None, None, 0,
                         error=f"the SpMM cannot cut K into {want} splits")
    return _estimate("nmg_spmm", cfg, src, "N", N, device_kind, weight,
                     sh["smem"],
                     f"nmg_spmm_tc_kernelILi{sh['nt8']}ELi{sh['row_warps']}E",
                     64 * sh["row_warps"])


def static_r6(program) -> list:
    """A routed kernel config whose block needs more shared memory (or
    registers) than the device gives one block, or that the kernel
    refuses outright."""
    diags = []
    for est in program.smem_estimates:
        where = (f"routed {est['kernel']} config {est['config']} (source: "
                 f"{est['source']}) for weight {est['weight'] or '?'}")
        if est["error"] is not None:
            problem = f"is refused by the kernel: {est['error']}"
        elif est["bytes"] > est["budget"]:
            problem = (f"needs {est['bytes']} B of shared memory a block "
                       f"— the budget is {est['budget']} B on "
                       f"{est['device']}")
        elif est["registers"] is not None \
                and est["registers"] > est["register_budget"]:
            problem = (f"needs {est['registers']} registers a block — "
                       f"an SM has {est['register_budget']} on "
                       f"{est['device']}")
        else:
            continue
        diags.append(Diagnostic(
            rule="R6", severity=Severity.ERROR, entry=program.name,
            message=f"{where} {problem}", op=est["kernel"],
            location="smem-estimate",
            fix="pick fewer slabs a part (more K parts) or fewer tile rows "
                "for this K bucket, or regenerate the tuning table on this "
                "device",
        ))
    return diags


def static_r7(program) -> list:
    """Device kind with no modelled entry: budgets fall back to the H100's
    (a warning: the run still works, the model is what is off)."""
    _, matched = hw_for_device(program.device_kind)
    if matched:
        return []
    return [Diagnostic(
        rule="R7", severity=Severity.WARNING, entry=program.name,
        message=f"device kind {program.device_kind!r} has no entry in "
                f"HW_BY_KIND — shared-memory budgets and roofline terms are "
                f"modelled against the H100's constants",
        op=program.device_kind, location="hw-model",
        fix="add this device kind to launch/hw.py:HW_BY_KIND",
    )]
