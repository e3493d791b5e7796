"""Dense <-> n:m:g conversion and the mask constructors (port of
``repro/core/nmg.py``, paper §5.2).

Conversion methods, as in the reference:

- ``greedy``: the paper's CPU algorithm: process the (block, pattern)
  scores from highest to lowest and first-fit assign, which equals
  iterated global argmax, vectorized as C*g steps over a [B, C*g, C]
  score tensor;
- ``swap``: the paper's GPU algorithm, seeded with ``greedy``: apply the
  best improving pairwise swap of each chunk while one improves (at most
  128 rounds, one host read a round);
- ``exact``: brute force over every permutation on the host (an oracle for
  tests, C*g <= 8).

On random inputs near ties can flip under another summation order, so
parity with the reference is exact on inputs whose score sums are exact
(small integers) and is judged by preserved energy otherwise.

The masks: ``unstructured_mask`` (magnitude top-k), ``nm_mask`` (the
per-block top-n of the ``nm_mask`` kernel, ``kernels/ops.py``: its rule
is the reference Pallas kernel's, which the reference's ``lax.top_k``
spelling here shares except on NaN and f32 subnormals), ``blocked_mask``
(whole blocks by L1) and ``grouped_nm_mask`` (what an n:m:g conversion
keeps).
"""

from __future__ import annotations

import dataclasses
import itertools
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
           "nm_mask", "unstructured_mask", "blocked_mask", "grouped_nm_mask"]


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


def nm_mask(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Per-block top-n mask along the last axis, in ``x.dtype``: the
    ``nm_mask`` kernel on a CUDA tensor, its plain version on the CPU."""
    from repro_torch.kernels import ops as kops

    return kops.nm_mask(x, n, m).to(x.dtype)


def blocked_mask(x: torch.Tensor, block: int, sparsity: float
                 ) -> torch.Tensor:
    """Block-wise fraction mask, in ``x.dtype``: drop whole blocks of
    ``block`` consecutive elements (last axis) with the smallest L1; the
    kept count is Python's ``round`` of the reference, and the mask keeps
    every block at or above the kept count's smallest score."""
    k = x.shape[-1]
    xp = pad_to_multiple(x, block, axis=-1)
    sums = xp.abs().reshape(*xp.shape[:-1], -1, block).sum(dim=-1)
    scores = sums.reshape(-1)
    keep = max(1, int(round(scores.shape[0] * (1.0 - sparsity))))
    thresh = torch.topk(scores, keep, sorted=False).values.min()
    bmask = (sums >= thresh).to(x.dtype)
    mask = torch.repeat_interleave(bmask, block, dim=-1)
    return mask.reshape(*xp.shape[:-1], -1)[..., :k]


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


def _swap_refine(scores: torch.Tensor, perm: torch.Tensor, g: int,
                 max_iters: int = 128) -> torch.Tensor:
    """The paper's GPU algorithm: each round applies the best improving
    pairwise swap of chunk positions per chunk (gain above 1e-12), until no
    chunk improves or ``max_iters`` rounds ran."""
    B, CG, C = scores.shape
    dev = scores.device
    bidx = torch.arange(B, device=dev)
    pos = torch.arange(CG, device=dev)
    spos = torch.repeat_interleave(scores, g, dim=2)        # [B, CG, CG]
    eye = torch.eye(CG, dtype=torch.bool, device=dev)
    perm = perm.long().clone()
    for _ in range(max_iters):
        cur = spos[bidx[:, None], perm, pos[None]]            # [B, CG]
        # cross[b, i, j] = spos[b, perm[b, j], i]
        cross = spos[bidx[:, None, None], perm[:, None, :],
                     pos[None, :, None]]
        delta = (cross + cross.transpose(1, 2)
                 - cur[:, :, None] - cur[:, None, :])
        delta = delta.masked_fill(eye[None], float("-inf"))
        flat = delta.reshape(B, CG * CG)
        best = torch.argmax(flat, dim=1)
        do = flat[bidx, best] > 1e-12
        if not bool(do.any()):
            break
        i, j = best // CG, best % CG
        pi, pj = perm[bidx, i], perm[bidx, j]
        perm[bidx, i] = torch.where(do, pj, pi)
        perm[bidx, j] = torch.where(do, pi, pj)
    return perm.to(torch.int32)


def _exact_assign(scores: np.ndarray, g: int) -> np.ndarray:
    """Brute-force optimal assignment on the host (oracle; CG <= 8)."""
    B, CG, C = scores.shape
    best = np.zeros((B, CG), np.int32)
    for b in range(B):
        best_cost, best_perm = -np.inf, None
        for p in itertools.permutations(range(CG)):
            cost = sum(scores[b, blk, pos // g] for pos, blk in enumerate(p))
            if cost > best_cost:
                best_cost, best_perm = cost, p
        best[b] = np.array(best_perm, np.int32)
    return best


def dense_to_grouped_nm(x: torch.Tensor, n: int, m: int, g: int,
                        gr: int = 1, sparse_dim: int = -1,
                        method: str = "greedy") -> GroupedNMTensor:
    """Convert dense 2-D ``x`` to n:m:g; ``sparse_dim`` is the axis that
    carries the n:m structure, ``gr`` rows share one chunk permutation.
    A ``meta`` tensor gives the layout's storage at its shapes and runs no
    search (the counterpart of the reference's ``jax.eval_shape``)."""
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
    if xp.device.type == "meta":
        # shapes alone (the dry-run): the layout's storage, no search
        perm = torch.empty(scores.shape[:2], dtype=torch.int32,
                           device=xp.device)
    elif method == "greedy":
        perm = _greedy_assign(scores, g)
    elif method == "swap":
        perm = _swap_refine(scores, _greedy_assign(scores, g), g)
    elif method == "exact":
        perm = torch.as_tensor(_exact_assign(
            scores.detach().float().cpu().numpy(), g), device=xp.device)
    else:
        raise ValueError(f"unknown n:m:g conversion method {method!r}")
    perm = perm.reshape(Gr, nchunks, CG)
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


def grouped_nm_mask(x: torch.Tensor, n: int, m: int, g: int, gr: int = 1,
                    sparse_dim: int = -1, method: str = "greedy"
                    ) -> torch.Tensor:
    """Mask of the entries an n:m:g conversion keeps, in ``x.dtype`` (the
    masked-dense n:m:g of masked training)."""
    t = dense_to_grouped_nm(x, n, m, g, gr=gr, sparse_dim=sparse_dim,
                            method=method)
    ones = dataclasses.replace(t, val=torch.ones_like(t.val))
    return ones.to_dense().to(x.dtype)
