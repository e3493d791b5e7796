"""A frozen copy of the greedy n:m:g pruning (the STen paper, section
5.2), giving the mask of the entries a conversion keeps.

A weight [K, N] is sparse along K.  Its transpose [N, K] is cut into
groups of ``gr`` rows and chunks of ``m * C(m, n) * g`` columns; each
chunk holds ``C(m, n) * g`` blocks of ``m`` columns, and every n-of-m
pattern is given to exactly ``g`` blocks of a chunk, the same for the
group's rows.  The score of (block, pattern) is the sum over the group's
rows of |x| at the pattern's offsets; the greedy assignment takes the
highest remaining score again and again (first-fit, ties to the lowest
index).  The operations, their order and their dtype are the program's,
so on the same device and inputs the mask is the same bit for bit.
Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def _revolving_door(m: int, n: int) -> list:
    if n == 0:
        return [()]
    if n == m:
        return [tuple(range(m))]
    first = _revolving_door(m - 1, n)
    second = [c + (m - 1,) for c in reversed(_revolving_door(m - 1, n - 1))]
    return first + second


def pattern_onehots(n: int, m: int) -> torch.Tensor:
    """[C(m, n), m] f32, the patterns in revolving-door order."""
    pats = [sorted(c) for c in _revolving_door(m, n)]
    oh = torch.zeros(len(pats), m)
    for i, p in enumerate(pats):
        oh[i, p] = 1.0
    return oh


def _pad(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _greedy(scores: torch.Tensor, g: int) -> torch.Tensor:
    """scores [B, CG, C] -> perm [B, CG]: chunk position -> block."""
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
        sc[bidx, b, :] = neg
        full = cap[bidx, p] == 0
        col = sc[bidx, :, p]
        sc[bidx, :, p] = torch.where(full[:, None], torch.full_like(col, neg),
                                     col)
    return perm


def nmg_mask(w: torch.Tensor, n: int, m: int, g: int, gr: int
             ) -> torch.Tensor:
    """Bool mask [K, N] of what the n:m:g conversion of ``w`` [K, N]
    (sparse along K) keeps."""
    K, N = w.shape
    xc = w.T
    C = math.comb(m, n)
    CG = C * g
    xp = _pad(_pad(xc, gr, 0), m * CG, 1).contiguous()
    R_pad, K_pad = xp.shape
    Gr, nchunks = R_pad // gr, K_pad // (m * CG)
    onehot = pattern_onehots(n, m).to(device=xp.device, dtype=xp.dtype)
    mags = xp.abs().reshape(Gr, gr, nchunks, CG, m).sum(dim=1)
    scores = torch.einsum("bkm,pm->bkp", mags.reshape(Gr * nchunks, CG, m),
                          onehot)
    perm = _greedy(scores, g).long()                         # [B, CG]
    # the pattern of each block: position p carries pattern p // g
    pat = torch.empty_like(perm)
    pos_pat = (torch.arange(CG, device=xp.device) // g).expand_as(perm)
    pat.scatter_(1, perm, pos_pat)
    keep = onehot.bool()[pat]                                # [B, CG, m]
    keep = keep.reshape(Gr, 1, nchunks * CG * m).expand(Gr, gr, K_pad)
    return keep.reshape(R_pad, K_pad)[:N, :K].T.contiguous()
