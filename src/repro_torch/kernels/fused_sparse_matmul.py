"""Dense matmul with a fused scalar-threshold epilogue (port of
``repro/kernels/fused_sparse_matmul.py``): the paper's inline streaming
sparsifier (§3.3), ``y = A @ B`` in f32, then ``mask = |y| >= t`` and
``val = y * mask``, without writing the dense y.

:func:`matmul_threshold` runs the hand-written CUDA kernel
(``csrc/matmul_threshold.cu``) for CUDA tensors and the plain PyTorch
version :func:`matmul_threshold_plain` only for tensors on the CPU, inside
the :class:`MatmulThreshold` autograd function.  bf16 operands take the
kernel's tensor-core body, whose 16-byte copies need 16-byte aligned rows:
an operand without them (a transposed view, K = 70) is handed over as a
padded copy, made here and counted in the call's time.  f32 operands take
the CUDA-core body, which reads any strides.  Its backward is the
reference's cotangent through ``repro/kernels/ref.py:matmul_threshold_ref``:
``gm = g * mask`` in f32, ``da = gm @ B^T`` and ``db = A^T @ gm``, each
cast to its operand's dtype.  The JAX package has no backward kernel
either; the two backward products are plain matmuls outside any kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _dtensor, _trace

__all__ = ["matmul_threshold", "matmul_threshold_plain", "MatmulThreshold"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def matmul_threshold_plain(a: torch.Tensor, b: torch.Tensor,
                           threshold: float) -> tuple:
    """Plain version: (val f32 [M, N], bool mask [M, N]) through the dense
    f32 product; differentiable by autograd as written.  The threshold is
    compared as an f32 value, as the kernel and the reference (a weakly
    typed scalar against f32) compare it."""
    y = torch.matmul(a.float(), b.float())
    mask = y.abs() >= torch.tensor(threshold, dtype=torch.float32,
                                   device=y.device)
    return y * mask, mask


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are contiguous, 16-byte aligned and a
    multiple of 8 elements apart (what the bf16 kernel's 16-byte copies
    take), else a copy whose row pitch is padded up to a multiple of 8.
    The kernel never reads the padding (its ragged edges read as zero)."""
    R, C = x.shape
    if x.stride(1) == 1 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    pitch = -(-C // 8) * 8
    buf = torch.empty((R, pitch), dtype=x.dtype, device=x.device)
    buf[:, :C].copy_(x)
    return buf[:, :C]


def _launch(a: torch.Tensor, b: torch.Tensor, threshold: float) -> tuple:
    from repro_torch.kernels import _build

    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_threshold operands lie on {a.device} and "
                         f"{b.device}, not one CUDA device")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_threshold takes A [M, K] and B [K, N], "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"matmul_threshold takes float32/bfloat16 operands "
                         f"of one dtype, got {a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    if a.dtype == torch.bfloat16:   # the tensor-core body's 16-byte copies
        a, b = _rows_aligned(a), _rows_aligned(b)
    val = torch.empty((M, N), dtype=torch.float32, device=a.device)
    mask = torch.empty((M, N), dtype=torch.bool, device=a.device)
    fn = _build.load("matmul_threshold").matmul_threshold_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), a.stride(0),
             a.stride(1), b.stride(0), b.stride(1), val.data_ptr(),
             mask.data_ptr(), M, N, K, threshold,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_threshold launch failed: error {err}")
    matmul_threshold.launches += 1
    return val, mask


class MatmulThreshold(torch.autograd.Function):
    """``(val, mask)`` of the fused matmul-threshold, with the reference's
    cotangents for ``a`` and ``b`` (``mask`` is not differentiable)."""

    @staticmethod
    def forward(ctx, a, b, threshold):
        if a.device.type == "meta":
            val = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                              device=a.device)
            mask = torch.empty(val.shape, dtype=torch.bool, device=a.device)
        elif a.device.type == "cpu" and b.device.type == "cpu":
            with torch.no_grad():
                val, mask = matmul_threshold_plain(a, b, threshold)
        else:
            val, mask = _launch(a, b, threshold)
        ctx.save_for_backward(a, b, mask)
        ctx.mark_non_differentiable(mask)
        return val, mask

    @staticmethod
    def backward(ctx, g_val, g_mask):
        a, b, mask = ctx.saved_tensors
        gm = g_val.float() * mask
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (gm @ b.float().T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = (a.float().T @ gm).to(b.dtype)
        return da, db, None


def matmul_threshold(a: torch.Tensor, b: torch.Tensor,
                     threshold: float) -> tuple:
    """(val f32 [M, N], bool mask [M, N]) of ``A @ B`` thresholded at
    ``|y| >= threshold``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in ``a`` and ``b``.  DTensor
    operands cross ``kernels/_dtensor.py``'s boundary (A's rows stay
    sharded; B is made whole, its gradient summed over the row
    shards)."""
    if _dtensor.any_dtensor(a, b):
        al, (bl,), loc = _dtensor.localize("matmul_threshold", a, (0,), (b,))
        val, mask = matmul_threshold(al, bl, threshold)
        return loc.wrap(val, {0: 0}), loc.wrap(mask, {0: 0})
    if _trace.RECORDER is not None:
        return _trace.as_node("matmul_threshold", (a, b), matmul_threshold,
                              a, b, threshold,
                              flops=2 * a.shape[0] * a.shape[1] * b.shape[1])
    return MatmulThreshold.apply(a, b, float(threshold))


matmul_threshold.launches = 0
