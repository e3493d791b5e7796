"""Dense <-> n:m:g conversion and the mask constructors (port of
``repro/core/nmg.py``): greedy conversion only, plus ``unstructured_mask``
(magnitude top-k); the per-block top-n mask is the ``nm_mask`` kernel's
(``kernels/nm_mask.py``).

The greedy assignment is the paper's CPU algorithm: process the
(block, pattern) scores from highest to lowest and first-fit assign, which
equals iterated global argmax — vectorized as C*g steps over a
[B, C*g, C] score tensor, as the reference does.  On random inputs near
ties can flip under another summation order, so parity with the reference
is exact on inputs whose score sums are exact (small integers) and is
judged by preserved energy otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.layouts import (
    GroupedNMTensor,
    build_spmm_plan,
    pad_to_multiple,
    pattern_onehots,
)

__all__ = ["dense_to_grouped_nm", "grouped_nm_to_dense", "energy",
           "unstructured_mask"]


def energy(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Paper §6.1: ||X_hat||_1 / ||X||_1."""
    num = x_hat.abs().float().sum()
    den = x.abs().float().sum()
    return num / torch.clamp(den, min=torch.finfo(torch.float32).tiny)


def unstructured_mask(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Global magnitude top-k mask (scalar fraction sparsifier), in
    ``x.dtype``.  ``k`` comes from the reference's f32 expression
    ``round(f32(size) * (1 - f32(sparsity)))`` clipped to [1, size] (numpy
    rounds half to even, as the reference does), and the mask keeps
    ``|x| >= k-th largest |x|``: a value threshold, so the order among
    ties cannot change it."""
    flat = x.abs().reshape(-1)
    size = flat.numel()
    k = int(np.clip(np.round(
        np.float32(size) * (np.float32(1.0) - np.float32(sparsity))), 1, size))
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return (x.abs() >= thresh).to(x.dtype)


def _greedy_assign(scores: torch.Tensor, g: int) -> torch.Tensor:
    """scores [B, CG, C] -> perm [B, CG] int32: chunk position p (pattern
    p // g) -> the local block index placed there."""
    B, CG, C = scores.shape
    sc = scores.clone()
    bidx = torch.arange(B, device=scores.device)
    perm = torch.full((B, CG), -1, dtype=torch.int32, device=scores.device)
    cap = torch.full((B, C), g, dtype=torch.int64, device=scores.device)
    neg = float("-inf")
    for _ in range(CG):
        best = torch.argmax(sc.reshape(B, CG * C), dim=1)
        b, p = best // C, best % C
        slot = p * g + (g - cap[bidx, p])
        perm[bidx, slot] = b.to(torch.int32)
        cap[bidx, p] -= 1
        sc[bidx, b, :] = neg                                  # block taken
        full = cap[bidx, p] == 0
        pat_col = sc[bidx, :, p]                              # [B, CG]
        sc[bidx, :, p] = torch.where(full[:, None],
                                     torch.full_like(pat_col, neg), pat_col)
    return perm


def dense_to_grouped_nm(x: torch.Tensor, n: int, m: int, g: int,
                        gr: int = 1, sparse_dim: int = -1,
                        method: str = "greedy") -> GroupedNMTensor:
    """Convert dense 2-D ``x`` to n:m:g; ``sparse_dim`` is the axis that
    carries the n:m structure, ``gr`` rows share one chunk permutation."""
    if method != "greedy":
        raise NotImplementedError(
            f"n:m:g conversion method {method!r} is not ported yet")
    assert x.ndim == 2, "n:m:g conversion operates on matrices"
    sd = sparse_dim % 2
    orig_shape = tuple(x.shape)
    xc = x.T if sd == 0 else x                  # canonical [R, K(sparse)]
    C = math.comb(m, n)
    CG = C * g
    xp = pad_to_multiple(pad_to_multiple(xc, gr, 0), m * CG, 1).contiguous()
    R_pad, K_pad = xp.shape
    Gr, nchunks = R_pad // gr, K_pad // (m * CG)
    pat_onehot = torch.as_tensor(np.array(pattern_onehots(n, m)),
                                 dtype=xp.dtype, device=xp.device)

    mags = xp.abs().reshape(Gr, gr, nchunks, CG, m).sum(dim=1)
    scores = torch.einsum("bkm,pm->bkp", mags.reshape(Gr * nchunks, CG, m),
                          pat_onehot)
    perm = _greedy_assign(scores, g).reshape(Gr, nchunks, CG)
    chunk_base = (torch.arange(nchunks, dtype=torch.int32,
                               device=xp.device) * CG)[None, :, None]
    blk_idx = (perm + chunk_base).to(torch.int32)

    plan = build_spmm_plan(blk_idx, n, m, g)
    cols_rows = torch.repeat_interleave(plan.cols, gr, dim=0).long()
    val = torch.gather(xp, 1, cols_rows).reshape(R_pad, nchunks * CG, n)
    return GroupedNMTensor(val=val.contiguous(), blk_idx=blk_idx, n=n, m=m,
                           g=g, gr=gr, dense_shape=orig_shape, sparse_dim=sd,
                           plan=plan)


def grouped_nm_to_dense(t: GroupedNMTensor) -> torch.Tensor:
    """n:m:g -> dense: one pass reordering by the stored index."""
    return t.to_dense()
