"""Per-m-block top-n keep mask along the last axis (port of
``repro/kernels/nm_mask.py``): the first pass of the paper's n:m blocking
sparsifier, run at every n:m build and GMP pattern recompute.

:func:`nm_mask` launches the hand-written CUDA kernel
(``csrc/nm_mask.cu``) for CUDA tensors and takes the plain PyTorch version
:func:`nm_mask_plain` only for tensors on the CPU.  Both apply the
reference kernel's rank rule — element i of a block is kept iff
``#{j : |x_j| > |x_i| or (|x_j| == |x_i| and j < i)} < n`` — which is
``lax.top_k``'s lowest-index tie-break, so both equal the reference bit
for bit.  ``torch.topk`` promises no tie order and is not used.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["nm_mask", "nm_mask_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def nm_mask_plain(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Plain version: bool keep mask of ``x``'s shape, by the O(m^2) rank
    comparison over zero-padded m-blocks of the last axis."""
    K = x.shape[-1]
    xp = F.pad(x, (0, (-K) % m))
    a = xp.abs().reshape(*xp.shape[:-1], -1, m)
    ai, aj = a[..., :, None], a[..., None, :]
    idx = torch.arange(m, device=x.device)
    earlier = idx[None, :] < idx[:, None]                 # [i, j]: j < i
    beats = (aj > ai) | ((aj == ai) & earlier)
    keep = beats.sum(dim=-1) < n
    return keep.reshape(*xp.shape[:-1], -1)[..., :K]


def _launch(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    from repro_torch.kernels import _build

    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"nm_mask takes float32/bfloat16, got {x.dtype}")
    if not (m >= 1 and 0 <= n <= m):
        raise ValueError(f"nm_mask takes 0 <= n <= m, m >= 1, got {n}:{m}")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    out = torch.empty(x2.shape, dtype=torch.bool, device=x.device)
    fn = _build.load("nm_mask").nm_mask_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(_DTYPE_CODE[x.dtype], x2.data_ptr(), out.data_ptr(),
             x2.shape[0], K, n, m,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nm_mask launch failed: error {err}")
    nm_mask.launches += 1
    return out.reshape(x.shape)


def nm_mask(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Bool keep mask of per-m-block top-n along the last axis: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return nm_mask_plain(x, n, m)
    if x.device.type != "cuda":
        raise ValueError(f"nm_mask operand lies on {x.device}")
    return _launch(x, n, m)


nm_mask.launches = 0
