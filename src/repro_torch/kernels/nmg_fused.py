"""Decode megakernels: the fused QKV and fused gated-FFN launches (port
of ``repro/kernels/nmg_fused.py``).

QKV: ``wq``/``wk``/``wv`` share the contraction axis and, when sparsified
together, the (n, m, g, gr) format, so one GEMV launch can compute all
three.  The reference concatenates the storage and launches its GEMV body
once; the CUDA launch here instead takes the three (val, cols, out)
segments as they are (``blockIdx.y`` picks the segment), so no decode step
copies the QKV weights.  Each row's summation order depends on the row
alone, so the fused launch is bitwise equal to three single launches.

Gated FFN: the gated MLP packs ``w1`` and the gate into one [D, 2F]
weight.  :func:`nmg_ffn` launches ``csrc/nmg_ffn.cu``, which computes
each u row (< F) and its partner v row at +F in the GEMV's own order (the
body :func:`~repro_torch.kernels.nmg_gemv.row_plan` gives the GEMV at the
same gr, M, K and dtype), then
in its epilogue casts both to ``out_dtype`` and writes ``act(u) * v``:
the op order of the sequential path (projection with the decode epilogue,
split, act, multiply), so fused and sequential agree bitwise for silu.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as nnf

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import _dtensor, _trace
from repro_torch.kernels.nmg_gemv import MAX_M, _DTYPE_CODE, _pad_rows, \
    check_operands, chunk_geometry, gemv_launch, meta_out, nmg_gemv_plain, \
    product_flops, row_plan

__all__ = ["act_fn", "fusable_qkv", "fusable_ffn", "fused_segments",
           "nmg_qkv", "nmg_qkv_plain", "nmg_ffn", "nmg_ffn_plain"]

#: activation codes of the C interface of ``csrc/nmg_ffn.cu``
_ACT_CODE = {"silu": 0, "gelu": 1}


def act_fn(name: str):
    """The model stack's activation by name: silu, or gelu with its tanh
    approximation (the fused epilogue replays it)."""
    if name == "silu":
        return nnf.silu
    return lambda t: nnf.gelu(t, approximate="tanh")


def fusable_qkv(ws: Sequence) -> bool:
    """Static eligibility for the fused launch: all grouped n:m:g, same
    format, same contraction extent and stored dtype, sparse along the
    input axis, rows padded to gr."""
    if not ws or not all(isinstance(w, GroupedNMTensor) for w in ws):
        return False
    w0 = ws[0]
    for w in ws:
        if (w.n, w.m, w.g, w.gr) != (w0.n, w0.m, w0.g, w0.gr):
            return False
        if w.sparse_dim % 2 != 0:
            return False
        if w.dense_shape[0] != w0.dense_shape[0]:
            return False
        if w.val.shape[1:] != w0.val.shape[1:] or w.val.dtype != w0.val.dtype:
            return False
        if w.blk_idx.shape[1:] != w0.blk_idx.shape[1:]:
            return False
        if w.val.shape[0] != w.blk_idx.shape[0] * w.gr:
            return False
    return True


def fusable_ffn(w, F: int) -> bool:
    """Static eligibility of a packed [D, 2F] gated-MLP weight for the
    fused FFN launch: grouped n:m:g, sparse along the input axis, exactly
    2F unpadded rows, and the u/v halves splitting on a fiber-group
    boundary (F divisible by gr)."""
    if not isinstance(w, GroupedNMTensor) or w.sparse_dim % 2 != 0:
        return False
    if w.canonical_rows() != 2 * F or F <= 0:
        return False
    return w.val.shape[-3] == 2 * F and F % w.gr == 0


def fused_segments(ws: Sequence) -> list:
    """Per projection (row offset in the row-concatenated padded operand,
    canonical row count)."""
    segs, off = [], 0
    for w in ws:
        segs.append((off, w.canonical_rows()))
        off += w.val.shape[0]
    return segs


def nmg_qkv_plain(ws: Sequence, b: torch.Tensor, *, out_dtype=None,
                  transpose_out: bool = False, config=None) -> tuple:
    """Plain version (``repro/kernels/ops.py:nmg_qkv_xla``): one gather +
    one einsum over the row-concatenated plan, sliced per projection
    (``config``, the kernel's, changes nothing here)."""
    w0 = ws[0]
    gr = w0.gr
    val = torch.cat([w.val for w in ws])
    cols = torch.cat([w.gather_plan().cols for w in ws])
    R_pad, nblocks, n = val.shape
    Gr = cols.shape[0]
    M = b.shape[1]
    b_p = _pad_rows(b, nblocks * w0.m)
    xg = b_p[cols.reshape(-1).long()].reshape(Gr, nblocks * n, M)
    val_g = val.reshape(Gr, gr, nblocks * n)
    spec = "grk,gkm->mgr" if transpose_out else "grk,gkm->grm"
    out = torch.einsum(spec, val_g.float(), xg.float())
    out = out.reshape(M, R_pad) if transpose_out else out.reshape(R_pad, M)
    if out_dtype is not None:
        out = out.to(out_dtype)
    segs = fused_segments(ws)
    if transpose_out:
        return tuple(out[:, off:off + R] for off, R in segs)
    return tuple(out[off:off + R] for off, R in segs)


def nmg_qkv(ws: Sequence, b: torch.Tensor, *, out_dtype=None,
            transpose_out: bool = False, config=None) -> tuple:
    """Every weight of ``ws`` against one decode-shaped B[K, M] in one
    launch: the CUDA GEMV kernel over up to three segments for CUDA
    tensors, the plain version for CPU tensors.  ``config`` is
    :func:`~repro_torch.kernels.nmg_gemv.row_plan`'s.  DTensor operands
    cross ``kernels/_dtensor.py``'s boundary."""
    if _dtensor.any_dtensor(ws, b):
        bl, wl, loc = _dtensor.localize("nmg_qkv", b, (1,), tuple(ws))
        outs = nmg_qkv(wl, bl, out_dtype=out_dtype,
                       transpose_out=transpose_out, config=config)
        return tuple(loc.wrap(o, {1: int(not transpose_out)}) for o in outs)
    if _trace.RECORDER is not None:
        operands = [t for w in ws for t in (w.val, w.gather_plan().cols)]
        return _trace.as_node(
            "nmg_qkv", (*operands, b), nmg_qkv, ws, b,
            flops=product_flops(ws, b), out_dtype=out_dtype,
            transpose_out=transpose_out, config=config)
    if b.device.type == "meta":
        return tuple(meta_out(w.canonical_rows(), b, out_dtype,
                              transpose_out) for w in ws)
    if b.device.type == "cpu":
        return nmg_qkv_plain(ws, b, out_dtype=out_dtype,
                             transpose_out=transpose_out)
    if not fusable_qkv(ws):
        raise ValueError("operands not fusable; route per projection")
    outs = gemv_launch(list(ws), b, out_dtype=out_dtype,
                       transpose_out=transpose_out, config=config)
    nmg_qkv.launches += 1
    return outs


nmg_qkv.launches = 0


def nmg_ffn_plain(w: GroupedNMTensor, b: torch.Tensor, *, act: str = "silu",
                  out_dtype=None, transpose_out: bool = False, config=None
                  ) -> torch.Tensor:
    """Plain version (``repro/kernels/ops.py:nmg_ffn_xla``): the sequential
    ops themselves — GEMV with the ``out_dtype`` epilogue, split, act,
    multiply.  Returns [F, M], or [M, F] with ``transpose_out``
    (``config``, the kernel's, changes nothing here)."""
    hh = nmg_gemv_plain(w, b, out_dtype=out_dtype, transpose_out=True)
    u, v = hh.chunk(2, dim=-1)
    out = act_fn(act)(u) * v                                  # [M, F]
    return out if transpose_out else out.T


def nmg_ffn(w: GroupedNMTensor, b: torch.Tensor, *, act: str = "silu",
            out_dtype=None, transpose_out: bool = False,
            config=None) -> torch.Tensor:
    """``act(u) * v`` of the packed gated weight against a decode-shaped
    B[D, M] in one launch: the CUDA kernel when the operands lie on the
    card, the plain version when both lie on the CPU.  A weight that
    :func:`fusable_ffn` rejects raises.  ``config`` is
    :func:`~repro_torch.kernels.nmg_gemv.row_plan`'s (the GEMV's at the
    same K, format, gr and dtype).  DTensor operands cross
    ``kernels/_dtensor.py``'s boundary."""
    if _dtensor.any_dtensor(w, b):
        bl, (wl,), loc = _dtensor.localize("nmg_ffn", b, (1,), (w,))
        return loc.wrap(nmg_ffn(wl, bl, act=act, out_dtype=out_dtype,
                                transpose_out=transpose_out, config=config),
                        {1: int(not transpose_out)})
    if _trace.RECORDER is not None:
        return _trace.as_node(
            "nmg_ffn", (w.val, w.gather_plan().cols, b), nmg_ffn, w, b,
            flops=product_flops([w], b), act=act, out_dtype=out_dtype,
            transpose_out=transpose_out, config=config)
    if b.device.type == "meta":
        return meta_out(w.canonical_rows() // 2, b, out_dtype, transpose_out)
    if b.device.type == "cpu" and w.val.device.type == "cpu":
        return nmg_ffn_plain(w, b, act=act, out_dtype=out_dtype,
                             transpose_out=transpose_out)
    from repro_torch.kernels import _build

    check_operands([w], b, max_m=MAX_M)
    F = w.canonical_rows() // 2
    if not fusable_ffn(w, F):
        raise ValueError("packed weight not fusable (rows padded, odd, or "
                         "F not a multiple of gr); route sequentially")
    if act not in _ACT_CODE:
        raise ValueError(f"activation {act!r} not taken by the FFN kernel")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, b.dtype):
        raise ValueError(f"output dtype {out_dtype} not taken for "
                         f"{b.dtype} inputs")
    K, M = b.shape
    KN = w.val.shape[1] * w.val.shape[2]
    out = torch.empty((M, F) if transpose_out else (F, M),
                      dtype=out_dtype, device=b.device)
    plan = row_plan(w.gr, M, KN, b.dtype, config)
    fn = _build.load("nmg_ffn").nmg_ffn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(*plan.args(), _DTYPE_CODE[b.dtype],
             int(out_dtype == torch.float32), _ACT_CODE[act],
             w.val.data_ptr(), w.gather_plan().cols.data_ptr(),
             out.data_ptr(), F, b.data_ptr(), b.stride(0), b.stride(1), K,
             KN, M, w.gr, *chunk_geometry(w), int(transpose_out),
             torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmg_ffn launch failed: error {err}")
    nmg_ffn.launches += 1
    return out


nmg_ffn.launches = 0
