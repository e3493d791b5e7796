"""Shape-routed n:m:g matmul entry points (port of the serving half of
``repro/kernels/ops.py``).

  right operand        path                       regime
  -----------------    ------------------------   -------------------------
  M <= decode_m_max    ``nmg_gemv``  (decode)     weight-stationary GEMV,
                                                  x.dtype epilogue
  M >  decode_m_max    ``nmg_spmm``  (prefill)    fiber-group SpMM, f32 sum,
                                                  x.dtype epilogue

Decode-shaped groups also fuse: ``maybe_fused_qkv`` (q/k/v in one GEMV
launch) and ``maybe_fused_ffn`` (the packed gated-MLP weight, projection
and ``act(u) * v`` in one launch).  The training side adds ``nm_mask``
(the n:m sparsifier's keep mask) and ``matmul_threshold`` (matmul with
the fused inline threshold sparsifier).  Each op runs the CUDA kernel for
CUDA tensors and its plain version for CPU tensors.  ``kernel_counters``
is the port's own plain dict of routing decisions and launches per
(kernel, route): ``("nmg_linear",
"gemv[default]")`` for the router's choice, ``("nmg_gemv", "cuda")`` or
``("nmg_gemv", "plain")`` for where the work ran.  Routes read the shipped
defaults of ``tune/routing.py`` (no tuning tables yet), hence
``[default]``.  Each kernel wrapper (``KERNEL_WRAPPERS``) also counts its
own launches in its ``.launches`` attribute.  The reference counts traces;
the port counts calls executed: both accounts count on the host, so a CUDA
graph (``serve/graphs.py``) takes a :func:`counter_snapshot` around its
capture, puts the counters back (capture executes nothing) and adds the
captured :func:`counter_delta` at every replay (:func:`add_counters`).
"""

from __future__ import annotations

import collections

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import fused_sparse_matmul as _fsm, \
    nm_mask as _nm_mask, nmg_fused, nmg_gemv as _gemv, nmg_spmm as _spmm
from repro_torch.kernels.nmg_fused import fusable_ffn, fusable_qkv, \
    nmg_ffn_plain, nmg_qkv_plain
from repro_torch.kernels.nmg_gemv import nmg_gemv_plain
from repro_torch.kernels.nmg_spmm import nmg_spmm_plain
from repro_torch.tune import routing

__all__ = [
    "DECODE_M_MAX",
    "nmg_matmul",
    "nmg_spmm",
    "nmg_spmm_plain",
    "nmg_gemv",
    "nmg_gemv_plain",
    "nmg_linear",
    "nmg_qkv",
    "nmg_qkv_plain",
    "maybe_fused_qkv",
    "fusable_qkv",
    "nmg_ffn",
    "nmg_ffn_plain",
    "maybe_fused_ffn",
    "fusable_ffn",
    "nm_mask",
    "matmul_threshold",
    "kernel_counters",
    "reset_kernel_counters",
    "KERNEL_WRAPPERS",
    "counter_snapshot",
    "counter_delta",
    "add_counters",
    "restore_counters",
]

DECODE_M_MAX = routing.DEFAULT_DECODE_M_MAX

_KERNEL_COUNTS: collections.Counter = collections.Counter()


def kernel_counters() -> dict:
    """{(kernel, route): calls} since the last reset."""
    return dict(_KERNEL_COUNTS)


def reset_kernel_counters() -> None:
    """Zero both accounts: the routes and every wrapper's ``.launches``."""
    restore_counters({"routes": {}, "launches": {}})


#: {kernel: (module, wrapper attribute, plain-version attribute)} of every
#: CUDA kernel wrapper; the wrapper counts its launches in ``.launches``
KERNEL_WRAPPERS = {
    "nmg_gemv": (_gemv, "nmg_gemv", "nmg_gemv_plain"),
    "nmg_qkv": (nmg_fused, "nmg_qkv", "nmg_qkv_plain"),
    "nmg_spmm": (_spmm, "nmg_spmm", "nmg_spmm_plain"),
    "nmg_ffn": (nmg_fused, "nmg_ffn", "nmg_ffn_plain"),
    "nm_mask": (_nm_mask, "nm_mask", "nm_mask_plain"),
    "matmul_threshold": (_fsm, "matmul_threshold", "matmul_threshold_plain"),
}
# the wrapper functions themselves, so the counts read right while a
# caller has swapped a module attribute (e.g. for the plain version)
_WRAPPER_FNS = {k: getattr(mod, attr)
                for k, (mod, attr, _) in KERNEL_WRAPPERS.items()}


def counter_snapshot() -> dict:
    """Both accounts at once: {"routes": {(kernel, route): calls},
    "launches": {kernel: wrapper launches}}."""
    return {"routes": dict(_KERNEL_COUNTS),
            "launches": {k: f.launches for k, f in _WRAPPER_FNS.items()}}


def counter_delta(before: dict, after: dict) -> dict:
    """What ran between two snapshots, in the snapshot's form (entries
    that did not move are left out)."""
    routes = {k: n - before["routes"].get(k, 0)
              for k, n in after["routes"].items()}
    launches = {k: n - before["launches"][k]
                for k, n in after["launches"].items()}
    return {"routes": {k: n for k, n in routes.items() if n},
            "launches": {k: n for k, n in launches.items() if n}}


def add_counters(delta: dict) -> None:
    """Count ``delta`` (a :func:`counter_delta`) once more, as if the work
    it describes had run again."""
    for k, n in delta["routes"].items():
        _KERNEL_COUNTS[k] += n
    for k, n in delta["launches"].items():
        _WRAPPER_FNS[k].launches += n


def restore_counters(snap: dict) -> None:
    """Set both accounts to ``snap`` (a :func:`counter_snapshot`)."""
    _KERNEL_COUNTS.clear()
    _KERNEL_COUNTS.update({k: n for k, n in snap["routes"].items() if n})
    for k, f in _WRAPPER_FNS.items():
        f.launches = snap["launches"].get(k, 0)


def _where(b: torch.Tensor) -> str:
    return "plain" if b.device.type == "cpu" else "cuda"


def nmg_spmm(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False) -> torch.Tensor:
    """C = A_canonical[R, K] @ B[K, N]; [N, R] with ``transpose_out``; f32
    unless ``out_dtype``."""
    _KERNEL_COUNTS[("nmg_spmm", _where(b))] += 1
    return _spmm.nmg_spmm(a, b, out_dtype=out_dtype,
                          transpose_out=transpose_out)


def nmg_gemv(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False) -> torch.Tensor:
    """C = A_canonical[R, K] @ B[K, M] for narrow B; [M, R] with
    ``transpose_out``; f32 unless ``out_dtype``."""
    _KERNEL_COUNTS[("nmg_gemv", _where(b))] += 1
    return _gemv.nmg_gemv(a, b, out_dtype=out_dtype,
                          transpose_out=transpose_out)


def nmg_qkv(ws, b: torch.Tensor, *, out_dtype=None,
            transpose_out: bool = False) -> tuple:
    """Every projection of ``ws`` against one decode-shaped B in one
    launch."""
    _KERNEL_COUNTS[("nmg_qkv", _where(b))] += 1
    return nmg_fused.nmg_qkv(tuple(ws), b, out_dtype=out_dtype,
                             transpose_out=transpose_out)


def maybe_fused_qkv(x: torch.Tensor, ws):
    """y_i = x @ W_i for every projection in one launch, or None when the
    group is ineligible or x is prefill-shaped (callers then run
    per-projection ``nmg_linear``).  Outputs are in x.dtype."""
    ws = tuple(ws)
    if not (routing.DEFAULT_FUSED_QKV and fusable_qkv(ws)):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > DECODE_M_MAX:
        return None
    _KERNEL_COUNTS[("nmg_qkv", "fused[default]")] += 1
    ys = nmg_qkv(ws, x2.T, out_dtype=x.dtype, transpose_out=True)
    return tuple(y.reshape(*lead, -1) for y in ys)


def nmg_ffn(w: GroupedNMTensor, b: torch.Tensor, *, act: str = "silu",
            out_dtype=None, transpose_out: bool = False) -> torch.Tensor:
    """Fused gated-MLP pair: packed [D, 2F] weight against decode-shaped
    B[D, M], gate applied in the kernel's epilogue.  Returns [F, M] (or
    [M, F] with ``transpose_out``)."""
    _KERNEL_COUNTS[("nmg_ffn", _where(b))] += 1
    return nmg_fused.nmg_ffn(w, b, act=act, out_dtype=out_dtype,
                             transpose_out=transpose_out)


def maybe_fused_ffn(x: torch.Tensor, w, *, act: str = "silu"):
    """``act(u) * v`` of the packed gated weight in one launch, in x.dtype,
    or None when the weight is ineligible, x is prefill-shaped, or fusion
    is switched off (callers then run the projection, split and gate)."""
    if not isinstance(w, GroupedNMTensor):
        return None
    R = w.canonical_rows()
    if R % 2 or not fusable_ffn(w, R // 2):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > DECODE_M_MAX:
        return None
    if not routing.DEFAULT_FUSED_FFN:
        _KERNEL_COUNTS[("nmg_ffn", "sequential[default]")] += 1
        return None
    _KERNEL_COUNTS[("nmg_ffn", "fused[default]")] += 1
    y = nmg_ffn(w, x2.T, act=act, out_dtype=x.dtype, transpose_out=True)
    return y.reshape(*lead, -1)


def nmg_matmul(a: GroupedNMTensor, b: torch.Tensor) -> torch.Tensor:
    """Shape-routed sparse @ dense, f32 out either way."""
    if b.ndim == 2:
        if b.shape[1] <= DECODE_M_MAX:
            _KERNEL_COUNTS[("nmg_matmul", "gemv[default]")] += 1
            return nmg_gemv(a, b)
        _KERNEL_COUNTS[("nmg_matmul", "spmm[default]")] += 1
    return nmg_spmm(a, b)


def nmg_linear(x: torch.Tensor, w: GroupedNMTensor) -> torch.Tensor:
    """y = x @ W for an n:m:g weight stored with sparse_dim = input axis.
    x: [..., K] -> y: [..., N] in x.dtype.  Decode-shaped x takes the GEMV
    kernel and prefill-shaped x the SpMM kernel; both epilogues cast the
    f32 sum to x.dtype and write [M, N] order directly (one launch)."""
    if w.sparse_dim % 2 != 0:
        raise ValueError("n:m:g linear expects the weight sparse along its "
                         "input axis (sparse_dim=0)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] <= DECODE_M_MAX:
        _KERNEL_COUNTS[("nmg_linear", "gemv[default]")] += 1
        y = nmg_gemv(w, x2.T, out_dtype=x.dtype, transpose_out=True)
        return y.reshape(*lead, -1)
    _KERNEL_COUNTS[("nmg_linear", "spmm[default]")] += 1
    y = nmg_spmm(w, x2.T, out_dtype=x.dtype, transpose_out=True)
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# training-side kernels
# ---------------------------------------------------------------------------


def nm_mask(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Bool per-m-block top-n keep mask along the last axis of ``x``."""
    _KERNEL_COUNTS[("nm_mask", _where(x))] += 1
    return _nm_mask.nm_mask(x, n, m)


def matmul_threshold(a: torch.Tensor, b: torch.Tensor, threshold: float
                     ) -> tuple:
    """Matmul with the fused streaming threshold sparsifier: (masked f32
    values, bool mask), differentiable in ``a`` and ``b``."""
    _KERNEL_COUNTS[("matmul_threshold", _where(a))] += 1
    return _fsm.matmul_threshold(a, b, threshold)
