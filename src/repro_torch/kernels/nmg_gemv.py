"""Decode-shaped n:m:g GEMV: ``C[R, M] = A_canonical[R, K] @ B[K, M]``
with M <= 16 (port of ``repro/kernels/nmg_gemv.py``).

:func:`nmg_gemv` launches the hand-written CUDA kernel
(``csrc/nmg_gemv.cu``) for CUDA tensors and takes the plain PyTorch version
:func:`nmg_gemv_plain` (the gather + einsum of
``repro/kernels/ops.py:nmg_gemv_xla``) only for tensors on the CPU.  There
is no fallback: a kernel that fails to build or launch raises.

f32 accumulation, one cast to ``out_dtype`` (default f32) in the epilogue;
``transpose_out=True`` writes [M, R] directly, the orientation
``nmg_linear`` wants.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.layouts import GroupedNMTensor

__all__ = ["nmg_gemv", "nmg_gemv_plain", "gemv_launch", "MAX_M"]

#: widest right operand the kernel takes (its register tile)
MAX_M = 16
#: output rows per CUDA block; gr must be a multiple
_ROWS_PER_BLOCK = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pad_rows(b: torch.Tensor, K_pad: int) -> torch.Tensor:
    return F.pad(b, (0, 0, 0, K_pad - b.shape[0])) if K_pad > b.shape[0] \
        else b


def nmg_gemv_plain(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
                   transpose_out: bool = False) -> torch.Tensor:
    """Plain version: one gather of the planned B rows + one f32 einsum."""
    gr = a.gr
    R_pad, nblocks, n = a.val.shape
    cols = a.gather_plan().cols                      # [Gr, nblocks*n]
    Gr = cols.shape[0]
    K, M = b.shape
    b_p = _pad_rows(b, nblocks * a.m)
    xg = b_p[cols.reshape(-1).long()].reshape(Gr, nblocks * n, M)
    val_g = a.val.reshape(Gr, gr, nblocks * n)
    R = a.canonical_rows()
    spec = "grk,gkm->mgr" if transpose_out else "grk,gkm->grm"
    out = torch.einsum(spec, val_g.float(), xg.float())
    out = out.reshape(M, R_pad)[:, :R] if transpose_out \
        else out.reshape(R_pad, M)[:R]
    return out if out_dtype is None else out.to(out_dtype)


def check_operands(ws, b: torch.Tensor, *, max_m=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if b.device.type != "cuda":
        raise ValueError(f"kernel operand B lies on {b.device}, not CUDA")
    if b.ndim != 2 or b.dtype not in _DTYPE_CODE:
        raise ValueError(f"B must be 2-D float32/bfloat16, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if max_m is not None and not 1 <= b.shape[1] <= max_m:
        raise ValueError(f"GEMV takes 1..{max_m} columns, got {b.shape[1]}")
    for w in ws:
        if not isinstance(w, GroupedNMTensor) or w.stacked:
            raise ValueError("kernel weights must be one layer of a "
                             "GroupedNMTensor")
        cols = w.gather_plan().cols
        if w.val.device != b.device or cols.device != b.device:
            raise ValueError("weight and B lie on different devices")
        if w.val.dtype != b.dtype:
            raise ValueError(f"val dtype {w.val.dtype} != B dtype {b.dtype}")
        if not (w.val.is_contiguous() and cols.is_contiguous()):
            raise ValueError("val and plan.cols must be contiguous")
        if cols.dtype != torch.int32:
            raise ValueError(f"plan.cols must be int32, got {cols.dtype}")
        K = w.dense_shape[w.sparse_dim % 2]
        if K != b.shape[0]:
            raise ValueError(f"B has {b.shape[0]} rows, weight K is {K}")
        if w.gr % _ROWS_PER_BLOCK:
            raise ValueError(f"gr={w.gr} is not a multiple of "
                             f"{_ROWS_PER_BLOCK}")


def gemv_launch(ws, b: torch.Tensor, *, out_dtype=None,
                transpose_out: bool = False) -> tuple:
    """One CUDA launch over up to three weights sharing B (one segment
    each); returns one output per weight.  Callers count the launch."""
    from repro_torch.kernels import _build

    check_operands(ws, b, max_m=MAX_M)
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"the GEMV kernel takes 1..3 segments, got {len(ws)}")
    w0 = ws[0]
    KN = w0.val.shape[1] * w0.val.shape[2]
    for w in ws:
        if (w.n, w.m, w.g, w.gr) != (w0.n, w0.m, w0.g, w0.gr) or \
                w.val.shape[1:] != w0.val.shape[1:]:
            raise ValueError("fused segments must share format and K")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, b.dtype):
        raise ValueError(f"output dtype {out_dtype} not taken for "
                         f"{b.dtype} inputs")
    K, M = b.shape
    outs, segs = [], []
    for w in ws:
        R = w.canonical_rows()
        o = torch.empty((M, R) if transpose_out else (R, M),
                        dtype=out_dtype, device=b.device)
        outs.append(o)
        segs.append((w.val.data_ptr(), w.gather_plan().cols.data_ptr(),
                     o.data_ptr(), R, w.val.shape[0]))
    while len(segs) < 3:
        segs.append((None, None, None, 0, 0))
    lib = _build.load("nmg_gemv")
    fn = lib.nmg_gemv_launch
    if fn.argtypes is None:
        seg_t = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        fn.argtypes = ([ctypes.c_int] * 3 + seg_t * 3
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    flat = [v for s in segs for v in s]
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = fn(_DTYPE_CODE[b.dtype], int(out_dtype == torch.float32), len(ws),
             *flat, b.data_ptr(), b.stride(0), b.stride(1), K, KN, M, w0.gr,
             int(transpose_out), stream)
    if err != 0:
        raise RuntimeError(f"nmg_gemv launch failed: error {err}")
    return tuple(outs)


def nmg_gemv(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False) -> torch.Tensor:
    """C = A_canonical @ B for narrow B: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if b.device.type == "cpu":
        return nmg_gemv_plain(a, b, out_dtype=out_dtype,
                              transpose_out=transpose_out)
    (out,) = gemv_launch([a], b, out_dtype=out_dtype,
                         transpose_out=transpose_out)
    nmg_gemv.launches += 1
    return out


nmg_gemv.launches = 0
