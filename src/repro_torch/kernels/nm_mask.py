"""Per-m-block top-n keep mask along the last axis (port of
``repro/kernels/nm_mask.py``): the first pass of the paper's n:m blocking
sparsifier, run at every n:m build and GMP pattern recompute.

:func:`nm_mask` launches the hand-written CUDA kernel
(``csrc/nm_mask.cu``) for CUDA tensors and takes the plain PyTorch version
:func:`nm_mask_plain` only for tensors on the CPU.  Both apply the
reference Pallas kernel's rank rule, so both equal it bit for bit:

- element i of a block is kept iff
  ``#{j : a_j > a_i or (a_j == a_i and j < i)} < n``, the lowest index
  winning ties as in ``lax.top_k``;
- ``a = |x|`` with a magnitude below the smallest normal f32 (also bf16's
  smallest normal) flushed to 0, as the reference computes on the TPU and
  in its CPU runs (both of its routes in bf16, its Pallas route in f32);
- a NaN is never counted against another element and ranks 0 itself, so
  it is kept whenever n > 0 (a block may keep more than n), as in the
  Pallas kernel (``lax.top_k`` would rank it highest);
- a ragged last block reads its missing entries as zeros at the higher
  indices.

``torch.topk`` promises no tie order and is not used.  The kernel picks
one of three bodies from the shape alone (:func:`nm_mask_plan`): ``vector``
for m in {2, 4, 8, 16, 32} on whole, 16-byte aligned rows, ``staged`` for
any other m up to 64 (f32: 32), ``long`` above.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _trace

__all__ = ["nm_mask", "nm_mask_plain", "nm_mask_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = ("vector", "staged", "long")
#: the smallest normal magnitude of f32, and of bf16 too: below it |x| ranks
#: as 0
_MIN_NORMAL = torch.finfo(torch.float32).tiny


def nm_mask_plain(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Plain version: bool keep mask of ``x``'s shape, by the O(m^2) rank
    comparison over zero-padded m-blocks of the last axis."""
    K = x.shape[-1]
    xp = F.pad(x, (0, (-K) % m))
    a = xp.abs()
    a = a.masked_fill(a < _MIN_NORMAL, 0).reshape(*xp.shape[:-1], -1, m)
    ai, aj = a[..., :, None], a[..., None, :]
    idx = torch.arange(m, device=x.device)
    earlier = idx[None, :] < idx[:, None]                 # [i, j]: j < i
    beats = (aj > ai) | ((aj == ai) & earlier)
    keep = beats.sum(dim=-1) < n
    return keep.reshape(*xp.shape[:-1], -1)[..., :K]


def _operand(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x as the kernel reads it, [R, K] with contiguous rows."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"nm_mask takes float32/bfloat16, got {x.dtype}")
    if not (m >= 1 and 0 <= n <= m):
        raise ValueError(f"nm_mask takes 0 <= n <= m, m >= 1, got {n}:{m}")
    return x.reshape(-1, x.shape[-1]).contiguous()


def _fn(name: str, argtypes):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("nm_mask"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def nm_mask_plan(x: torch.Tensor, n: int, m: int) -> dict:
    """The body, grid, threads a block, dynamic shared memory a block and
    (staged body) sorting-network slots that :func:`nm_mask` launches for
    this CUDA tensor (chosen by dtype, m, ``K % m`` and alignment), without
    launching."""
    x2 = _operand(x, n, m)
    fn = _fn("nm_mask_plan", [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
    plan = (ctypes.c_int * 5)()
    if fn(_DTYPE_CODE[x.dtype], x2.data_ptr(), x2.shape[0], x2.shape[1], n,
          m, ctypes.addressof(plan)) != 0:
        raise ValueError(f"nm_mask takes no {n}:{m} on {tuple(x.shape)}")
    return {"body": _BODIES[plan[0]], "grid": plan[1], "threads": plan[2],
            "smem_bytes": plan[3], "slots": plan[4]}


def _launch(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    x2 = _operand(x, n, m)
    out = torch.empty(x2.shape, dtype=torch.bool, device=x.device)
    fn = _fn("nm_mask_launch", [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(_DTYPE_CODE[x.dtype], x2.data_ptr(), out.data_ptr(),
             x2.shape[0], x2.shape[1], n, m,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nm_mask launch failed: error {err}")
    nm_mask.launches += 1
    return out.reshape(x.shape)


def nm_mask(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Bool keep mask of per-m-block top-n along the last axis: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _trace.RECORDER is not None:
        return _trace.as_node("nm_mask", (x,), nm_mask, x, n, m)
    if x.device.type == "cpu":
        return nm_mask_plain(x, n, m)
    if x.device.type != "cuda":
        raise ValueError(f"nm_mask operand lies on {x.device}")
    return _launch(x, n, m)


nm_mask.launches = 0
