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
is the port's account of routing decisions and launches per (kernel,
route), kept on the ``repro_torch.obs`` registry as the reference keeps
its own (family ``kernel_routes``): ``("nmg_linear",
"gemv[default]")`` for the router's choice, ``("nmg_gemv", "cuda")`` or
``("nmg_gemv", "plain")`` for where the work ran.  Every decision is a
lookup in ``tune/routing.py`` (the active tuning table, else the shipped
default), and its provenance is counted as the reference counts it:
``gemv[table]`` / ``gemv[default]``, ``fused[...]``, ``sequential[...]``;
on the card the SpMM's K split adds ``("nmg_spmm_cuda", "auto[default]")``
or ``"splits<z>[table]"``.  :func:`predict_route` predicts these keys
without running anything.  Each kernel wrapper (``KERNEL_WRAPPERS``)
also counts its own launches in its ``.launches`` attribute, which the
registry reads and resets as ``kernel_launches``.  The
reference counts traces; the port counts calls executed: both accounts
count on the host, so a CUDA graph (``serve/graphs.py``) takes a
:func:`counter_snapshot` around its capture, puts the counters back
(capture executes nothing) and adds the captured :func:`counter_delta` at
every replay (:func:`add_counters`).
"""

from __future__ import annotations

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import fused_sparse_matmul as _fsm, \
    nm_mask as _nm_mask, nmg_fused, nmg_gemv as _gemv, nmg_spmm as _spmm
from repro_torch.kernels.nmg_fused import fusable_ffn, fusable_qkv, \
    nmg_ffn_plain, nmg_qkv_plain
from repro_torch.kernels.nmg_gemv import MAX_M, nmg_gemv_plain
from repro_torch.kernels.nmg_spmm import nmg_spmm_plain
from repro_torch.obs.registry import REGISTRY
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
    "predict_route",
]

DECODE_M_MAX = routing.DEFAULT_DECODE_M_MAX

# (kernel, route) -> calls.  A registry family: Counter semantics at every
# call site, the counts in the registry's snapshot, and with the flight
# recorder on each count a ``kernel_route`` event on the kernel track.
_KERNEL_COUNTS = REGISTRY.family(
    "kernel_routes", help="kernel routing and where the work ran: "
                          "(kernel, route) -> calls",
    trace_as="kernel_route", track="kernel")


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


class _WrapperLaunches:
    """The wrappers' ``.launches`` as one registry metric: its snapshot
    reads them, its reset zeroes them (the wrappers keep counting in
    their own attribute)."""

    def snapshot(self) -> dict:
        return {k: f.launches for k, f in _WRAPPER_FNS.items()}

    def reset(self) -> None:
        for f in _WRAPPER_FNS.values():
            f.launches = 0


REGISTRY.register("kernel_launches", _WrapperLaunches())


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


def _route_ctx(a: GroupedNMTensor, dtype) -> dict:
    """The routing-lookup context of a sparse operand: contraction extent,
    output extent, format, row sharing, activation dtype."""
    sd = a.sparse_dim % 2
    return dict(K=a.dense_shape[sd], R=a.dense_shape[1 - sd],
                fmt=(a.n, a.m, a.g), gr=a.gr, dtype=dtype)


def _fused_ctx(ws, dtype) -> dict:
    """Routing context of a fused projection group: shared contraction
    extent, summed output rows."""
    ctx = _route_ctx(ws[0], dtype)
    ctx["R"] = sum(w.canonical_rows() for w in ws)
    return ctx


def _spmm_config(a: GroupedNMTensor, dtype) -> tuple:
    """(splits or None, counter key) of the SpMM body for ``a``, or (None,
    None) where gr sends it through the GEMV kernel (no split to set)."""
    if a.gr % 64:
        return None, None
    cfg, src = routing.spmm_cuda_config(**_route_ctx(a, dtype))
    splits = None if cfg is None else cfg.get("splits")
    label = "auto" if splits is None else f"splits{int(splits)}"
    return splits, ("nmg_spmm_cuda", f"{label}[{src}]")


def nmg_spmm(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False) -> torch.Tensor:
    """C = A_canonical[R, K] @ B[K, N]; [N, R] with ``transpose_out``; f32
    unless ``out_dtype``.  On the card the kernel's K split comes from the
    ``spmm_cuda`` lookup, counted as ``("nmg_spmm_cuda",
    "auto[default]")`` or ``"splits<z>[table]"``."""
    where = _where(b)
    _KERNEL_COUNTS[("nmg_spmm", where)] += 1
    splits = None
    if where == "cuda":
        splits, key = _spmm_config(a, b.dtype)
        if key is not None:
            _KERNEL_COUNTS[key] += 1
    return _spmm.nmg_spmm(a, b, out_dtype=out_dtype,
                          transpose_out=transpose_out, splits=splits)


def nmg_gemv(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False) -> torch.Tensor:
    """C = A_canonical[R, K] @ B[K, M] for narrow B (any M: a table may
    route wider B here, taken 16 columns at a time); [M, R] with
    ``transpose_out``; f32 unless ``out_dtype``.  The decode body's config
    comes from the ``gemv_cuda`` lookup."""
    _KERNEL_COUNTS[("nmg_gemv", _where(b))] += 1
    cfg, _ = routing.gemv_cuda_config(**_route_ctx(a, b.dtype))
    return _gemv.nmg_gemv(a, b, out_dtype=out_dtype,
                          transpose_out=transpose_out, config=cfg,
                          max_m=None)


def nmg_qkv(ws, b: torch.Tensor, *, out_dtype=None,
            transpose_out: bool = False) -> tuple:
    """Every projection of ``ws`` against one decode-shaped B in one
    launch, with the per-projection GEMV's config (its R-free key)."""
    _KERNEL_COUNTS[("nmg_qkv", _where(b))] += 1
    cfg, _ = routing.gemv_cuda_config(**_fused_ctx(ws, b.dtype))
    return nmg_fused.nmg_qkv(tuple(ws), b, out_dtype=out_dtype,
                             transpose_out=transpose_out, config=cfg)


def _decode_m(M: int, ctx: dict) -> bool:
    """Whether a fused launch takes ``M`` columns: within the crossover
    and the fused kernels' 16-column tile (a crossover past 16 sends wider
    groups per projection)."""
    thr, _ = routing.decode_m_max(**ctx)
    return M <= min(thr, MAX_M)


def maybe_fused_qkv(x: torch.Tensor, ws):
    """y_i = x @ W_i for every projection in one launch, or None when the
    group is ineligible, x is prefill-shaped, or the table vetoes fusion
    (callers then run per-projection ``nmg_linear``).  Outputs are in
    x.dtype."""
    ws = tuple(ws)
    if not fusable_qkv(ws):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ctx = _fused_ctx(ws, x.dtype)
    if not _decode_m(x2.shape[0], ctx):
        return None
    fuse, src = routing.fused_qkv(**ctx)
    if not fuse:
        _KERNEL_COUNTS[("nmg_qkv", f"sequential[{src}]")] += 1
        return None
    _KERNEL_COUNTS[("nmg_qkv", f"fused[{src}]")] += 1
    ys = nmg_qkv(ws, x2.T, out_dtype=x.dtype, transpose_out=True)
    return tuple(y.reshape(*lead, -1) for y in ys)


def nmg_ffn(w: GroupedNMTensor, b: torch.Tensor, *, act: str = "silu",
            out_dtype=None, transpose_out: bool = False) -> torch.Tensor:
    """Fused gated-MLP pair: packed [D, 2F] weight against decode-shaped
    B[D, M], gate applied in the kernel's epilogue.  Returns [F, M] (or
    [M, F] with ``transpose_out``)."""
    _KERNEL_COUNTS[("nmg_ffn", _where(b))] += 1
    cfg, _ = routing.gemv_cuda_config(**_route_ctx(w, b.dtype))
    return nmg_fused.nmg_ffn(w, b, act=act, out_dtype=out_dtype,
                             transpose_out=transpose_out, config=cfg)


def _ffn_eligible(w) -> bool:
    if not isinstance(w, GroupedNMTensor):
        return False
    R = w.canonical_rows()
    return R % 2 == 0 and fusable_ffn(w, R // 2)


def maybe_fused_ffn(x: torch.Tensor, w, *, act: str = "silu"):
    """``act(u) * v`` of the packed gated weight in one launch, in x.dtype,
    or None when the weight is ineligible, x is prefill-shaped, or fusion
    is switched off (callers then run the projection, split and gate)."""
    if not _ffn_eligible(w):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ctx = _route_ctx(w, x.dtype)
    if not _decode_m(x2.shape[0], ctx):
        return None
    fuse, src = routing.fused_ffn(**ctx)
    if not fuse:
        _KERNEL_COUNTS[("nmg_ffn", f"sequential[{src}]")] += 1
        return None
    _KERNEL_COUNTS[("nmg_ffn", f"fused[{src}]")] += 1
    y = nmg_ffn(w, x2.T, act=act, out_dtype=x.dtype, transpose_out=True)
    return y.reshape(*lead, -1)


def nmg_matmul(a: GroupedNMTensor, b: torch.Tensor) -> torch.Tensor:
    """Shape-routed sparse @ dense, f32 out either way; the crossover
    comes from the ``decode_m_max`` lookup and the route and its
    provenance are counted as ``("nmg_matmul", "gemv[table]")`` etc."""
    if b.ndim == 2:
        thr, src = routing.decode_m_max(**_route_ctx(a, b.dtype))
        if b.shape[1] <= thr:
            _KERNEL_COUNTS[("nmg_matmul", f"gemv[{src}]")] += 1
            return nmg_gemv(a, b)
        _KERNEL_COUNTS[("nmg_matmul", f"spmm[{src}]")] += 1
    return nmg_spmm(a, b)


def nmg_linear(x: torch.Tensor, w: GroupedNMTensor) -> torch.Tensor:
    """y = x @ W for an n:m:g weight stored with sparse_dim = input axis.
    x: [..., K] -> y: [..., N] in x.dtype.  Decode-shaped x (M up to the
    ``decode_m_max`` lookup) takes the GEMV kernel and prefill-shaped x
    the SpMM kernel; both epilogues cast the f32 sum to x.dtype and write
    [M, N] order directly (one launch)."""
    if w.sparse_dim % 2 != 0:
        raise ValueError("n:m:g linear expects the weight sparse along its "
                         "input axis (sparse_dim=0)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    thr, src = routing.decode_m_max(**_route_ctx(w, x.dtype))
    if x2.shape[0] <= thr:
        _KERNEL_COUNTS[("nmg_linear", f"gemv[{src}]")] += 1
        y = nmg_gemv(w, x2.T, out_dtype=x.dtype, transpose_out=True)
        return y.reshape(*lead, -1)
    _KERNEL_COUNTS[("nmg_linear", f"spmm[{src}]")] += 1
    y = nmg_spmm(w, x2.T, out_dtype=x.dtype, transpose_out=True)
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# static route prediction
# ---------------------------------------------------------------------------


def _predict_linear(w: GroupedNMTensor, M: int, dtype, where: str) -> list:
    """Counter keys :func:`nmg_linear` records for one call."""
    thr, src = routing.decode_m_max(**_route_ctx(w, dtype))
    if M <= thr:
        return [("nmg_linear", f"gemv[{src}]"), ("nmg_gemv", where)]
    keys = [("nmg_linear", f"spmm[{src}]"), ("nmg_spmm", where)]
    if where == "cuda":
        _, key = _spmm_config(w, dtype)
        if key is not None:
            keys.append(key)
    return keys


def predict_route(op: str, a=None, *, M: int, dtype, ws=None,
                  device="cuda") -> list:
    """The ``kernel_counters`` keys one call of ``op`` records, predicted
    without running it: the same lookups the router makes, in the same
    order, under the active table.  ``op``: ``"nmg_linear"`` /
    ``"nmg_matmul"`` (a projection of ``M`` rows), ``"mm_gated"`` (the
    gated-MLP entry, which may fuse) or ``"mm_fused_qkv"`` (projection
    group ``ws``).  ``device`` says where the operands lie: ``"cuda"``
    keys (and the SpMM config's key) on the card, ``"plain"`` ones on the
    CPU.  A key a call records more than once appears once per record."""
    where = "plain" if torch.device(device).type == "cpu" else "cuda"

    if op in ("nmg_linear", "nmg_matmul"):
        keys = _predict_linear(a, M, dtype, where)
        if op == "nmg_matmul":
            thr, src = routing.decode_m_max(**_route_ctx(a, dtype))
            path = "gemv" if M <= thr else "spmm"
            keys = [("nmg_matmul", f"{path}[{src}]")] + [
                k for k in keys if k[0] != "nmg_linear"]
        return keys

    if op == "mm_gated":
        if not isinstance(a, GroupedNMTensor):
            return []
        ctx = _route_ctx(a, dtype)
        if not _ffn_eligible(a) or not _decode_m(M, ctx):
            return _predict_linear(a, M, dtype, where)
        fuse, src = routing.fused_ffn(**ctx)
        if fuse:
            return [("nmg_ffn", f"fused[{src}]"), ("nmg_ffn", where)]
        return [("nmg_ffn", f"sequential[{src}]")] + _predict_linear(
            a, M, dtype, where)

    if op == "mm_fused_qkv":
        ws = tuple(ws if ws is not None else a)
        per_projection = [k for w in ws
                          for k in _predict_linear(w, M, dtype, where)]
        if not fusable_qkv(ws):
            return per_projection
        ctx = _fused_ctx(ws, dtype)
        if not _decode_m(M, ctx):
            return per_projection
        fuse, src = routing.fused_qkv(**ctx)
        if fuse:
            return [("nmg_qkv", f"fused[{src}]"), ("nmg_qkv", where)]
        return [("nmg_qkv", f"sequential[{src}]")] + per_projection

    raise ValueError(f"predict_route: unknown op {op!r}")


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
