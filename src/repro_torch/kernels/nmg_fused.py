"""Decode megakernel: the fused QKV launch (port of the QKV half of
``repro/kernels/nmg_fused.py``).

``wq``/``wk``/``wv`` share the contraction axis and, when sparsified
together, the (n, m, g, gr) format, so one GEMV launch can compute all
three.  The reference concatenates the storage and launches its GEMV body
once; the CUDA launch here instead takes the three (val, cols, out)
segments as they are (``blockIdx.y`` picks the segment), so no decode step
copies the QKV weights.  Each row's summation order depends on the row
alone, so the fused launch is bitwise equal to three single launches.

The fused gated-FFN kernel (``_ffn_kernel``) is not ported yet: it only
fires for gated-MLP configs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels.nmg_gemv import _pad_rows, gemv_launch

__all__ = ["fusable_qkv", "fused_segments", "nmg_qkv", "nmg_qkv_plain"]


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


def fused_segments(ws: Sequence) -> list:
    """Per projection (row offset in the row-concatenated padded operand,
    canonical row count)."""
    segs, off = [], 0
    for w in ws:
        segs.append((off, w.canonical_rows()))
        off += w.val.shape[0]
    return segs


def nmg_qkv_plain(ws: Sequence, b: torch.Tensor, *, out_dtype=None,
                  transpose_out: bool = False) -> tuple:
    """Plain version (``repro/kernels/ops.py:nmg_qkv_xla``): one gather +
    one einsum over the row-concatenated plan, sliced per projection."""
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
            transpose_out: bool = False) -> tuple:
    """Every weight of ``ws`` against one decode-shaped B[K, M] in one
    launch: the CUDA GEMV kernel over up to three segments for CUDA
    tensors, the plain version for CPU tensors."""
    if b.device.type == "cpu":
        return nmg_qkv_plain(ws, b, out_dtype=out_dtype,
                             transpose_out=transpose_out)
    if not fusable_qkv(ws):
        raise ValueError("operands not fusable; route per projection")
    outs = gemv_launch(list(ws), b, out_dtype=out_dtype,
                       transpose_out=transpose_out)
    nmg_qkv.launches += 1
    return outs


nmg_qkv.launches = 0
