"""Sparsity layouts (port of part of ``repro/core/layouts.py``).

What the serving and training paths need: the revolving-door pattern
tables, the precomputed gather plan (:class:`SpmmPlan`),
:class:`GroupedNMTensor`, the masked-dense :class:`FixedMaskTensor` of
masked training and the trivial :class:`DenseTensor`.  Integer tables are
built with numpy exactly as the reference builds them, so they equal it
element for element.  ``NMTensor`` and the CSR/COO layouts are not
ported yet.

Layers are scan-stacked in the reference: a stacked ``GroupedNMTensor``
carries a leading ``[L]`` axis on ``val`` / ``blk_idx`` / ``plan.cols``
while ``dense_shape`` stays the per-layer shape.  :meth:`GroupedNMTensor.layer`
slices one layer back out (a view, no copy).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SparsityLayout",
    "DenseTensor",
    "FixedMaskTensor",
    "GroupedNMTensor",
    "SpmmPlan",
    "build_spmm_plan",
    "nm_patterns",
    "pos_pattern_offsets",
    "pattern_onehots",
    "pad_to_multiple",
]


def pad_to_multiple(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` to the next multiple of ``mult``."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _revolving_door(m: int, n: int) -> list:
    """n-subsets of range(m) in revolving-door Gray order."""
    if n == 0:
        return [()]
    if n == m:
        return [tuple(range(m))]
    first = _revolving_door(m - 1, n)
    second = [c + (m - 1,) for c in reversed(_revolving_door(m - 1, n - 1))]
    return first + second


@functools.lru_cache(maxsize=None)
def nm_patterns(n: int, m: int) -> np.ndarray:
    """All C(m, n) nonzero patterns in revolving-door order: read-only
    int32 [C(m,n), n] of sorted in-block offsets."""
    arr = np.array([sorted(c) for c in _revolving_door(m, n)], dtype=np.int32)
    arr.setflags(write=False)
    return arr


@functools.lru_cache(maxsize=None)
def pos_pattern_offsets(n: int, m: int, g: int) -> np.ndarray:
    """In-block offsets per chunk position (read-only int32 [C*g, n]):
    position p carries pattern ``p // g``."""
    arr = np.repeat(nm_patterns(n, m), g, axis=0)
    arr.setflags(write=False)
    return arr


@functools.lru_cache(maxsize=None)
def pattern_onehots(n: int, m: int) -> np.ndarray:
    """One-hot pattern table (read-only f32 [C, m])."""
    C = math.comb(m, n)
    pats = nm_patterns(n, m)
    oh = np.zeros((C, m), np.float32)
    oh[np.repeat(np.arange(C), n), pats.reshape(-1)] = 1.0
    oh.setflags(write=False)
    return oh


class SparsityLayout:
    """Base of the port's layouts: dispatch keys on the layout class."""


@dataclasses.dataclass
class DenseTensor(SparsityLayout):
    """Trivial layout: a dense tensor."""

    data: torch.Tensor

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> torch.Tensor:
        return self.data


@dataclasses.dataclass
class SpmmPlan:
    """Precomputed kernel gather plan, derived from ``blk_idx``.

    cols        [..., Gr, nblocks*n] int32: the original K row of B that
                every stored value multiplies (``blk_idx * m + offset``).
    pat_onehot  [C*g, m] int8 one-hot of each chunk position's offsets.
    """

    cols: torch.Tensor
    pat_onehot: torch.Tensor


def build_spmm_plan(blk_idx: torch.Tensor, n: int, m: int, g: int) -> SpmmPlan:
    """Derive the gather plan from a ``blk_idx`` table [..., Gr, nc, CG]."""
    *lead, Gr, nchunks, CG = blk_idx.shape
    pos = torch.as_tensor(np.array(pos_pattern_offsets(n, m, g)),
                          device=blk_idx.device)                 # [CG, n]
    cols = blk_idx[..., None].to(torch.int32) * m + pos           # [..,nc,CG,n]
    onehot = torch.as_tensor(
        np.repeat(pattern_onehots(n, m), g, axis=0).astype(np.int8),
        device=blk_idx.device)
    return SpmmPlan(cols=cols.reshape(*lead, Gr, nchunks * CG * n)
                    .to(torch.int32).contiguous(),
                    pat_onehot=onehot)


@dataclasses.dataclass
class FixedMaskTensor(SparsityLayout):
    """Dense values + boolean mask: the paper's masked-training layout
    (§5.3).  ``val`` is the trainable tensor; the gradient reaching it
    through :meth:`to_dense` is the masked cotangent, as in the reference.
    ``origin`` records the sparsifier that made the mask, so a pattern
    recompute runs its native algorithm (``SameFormatSparsifier``).  A
    scan-stacked leaf carries a leading [L] axis on ``val`` and ``mask``.
    """

    val: torch.Tensor
    mask: torch.Tensor   # bool, same shape as val
    origin: object = None

    @property
    def shape(self):
        return tuple(self.val.shape)

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self):
        return self.val.device

    def to_dense(self) -> torch.Tensor:
        return self.val * self.mask.to(self.val.dtype)

    @classmethod
    def from_dense(cls, x: torch.Tensor) -> "FixedMaskTensor":
        return cls(x, x != 0)

    def unbind(self, dim: int = 0) -> list:
        """Every layer of a stacked tensor, as views; autograd carries the
        per-layer gradients back into ``val`` with one stack."""
        return [FixedMaskTensor(v, m, self.origin)
                for v, m in zip(self.val.unbind(dim), self.mask.unbind(dim))]

    @classmethod
    def stack(cls, parts) -> "FixedMaskTensor":
        """Stack per-layer tensors on a leading [L] axis."""
        return cls(torch.stack([p.val for p in parts]),
                   torch.stack([p.mask for p in parts]), parts[0].origin)

    def to(self, device=None, dtype=None) -> "FixedMaskTensor":
        """Move to ``device`` and/or cast ``val`` to ``dtype``."""
        return FixedMaskTensor(self.val.to(device=device, dtype=dtype),
                               self.mask.to(device), self.origin)


@dataclasses.dataclass
class GroupedNMTensor(SparsityLayout):
    """Grouped n:m (``n:m:g``) sparsity (paper §5), canonical view [R, K]
    with the sparse dim K.  ``gr`` consecutive rows share one chunk
    permutation.

    Storage (K padded to a multiple of m*C(m,n)*g, R to a multiple of gr):
      val      [R_pad, nblocks, n]           compressed values
      blk_idx  [R_pad // gr, nchunks, C*g]   original m-block per position
    plus an optional leading [L] axis on both for scan-stacked weights.
    """

    val: torch.Tensor
    blk_idx: torch.Tensor
    n: int
    m: int
    g: int
    gr: int
    dense_shape: tuple   # original per-layer (pre-transpose, pre-pad) shape
    sparse_dim: int
    plan: Optional[SpmmPlan] = None
    #: per-layer views of a stacked tensor, built once by :meth:`layer`
    #: (the model slices every layer on every decode step)
    _layers: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def shape(self):
        return tuple(self.dense_shape)

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self):
        return self.val.device

    @property
    def stacked(self) -> bool:
        return self.val.ndim == 4

    def canonical_rows(self) -> int:
        """R: the canonical (output) row count before padding."""
        return self.dense_shape[1 - (self.sparse_dim % 2)]

    def gather_plan(self) -> SpmmPlan:
        if self.plan is not None:
            return self.plan
        return build_spmm_plan(self.blk_idx, self.n, self.m, self.g)

    def layer(self, i: int) -> "GroupedNMTensor":
        """Layer ``i`` of a stacked tensor (views, no copy, made once)."""
        assert self.stacked, "layer() on an unstacked GroupedNMTensor"
        one = self._layers.get(i)
        if one is None:
            plan = None if self.plan is None else SpmmPlan(
                self.plan.cols[i], self.plan.pat_onehot)
            one = self._layers[i] = dataclasses.replace(
                self, val=self.val[i], blk_idx=self.blk_idx[i], plan=plan)
        return one

    @classmethod
    def stack(cls, parts) -> "GroupedNMTensor":
        """Stack per-layer tensors on a leading [L] axis (the reference's
        re-stack in ``SparsityBuilder.sparsify_params``)."""
        p0 = parts[0]
        plan = None
        if all(p.plan is not None for p in parts):
            plan = SpmmPlan(torch.stack([p.plan.cols for p in parts]),
                            p0.plan.pat_onehot)
        return dataclasses.replace(
            p0, val=torch.stack([p.val for p in parts]),
            blk_idx=torch.stack([p.blk_idx for p in parts]), plan=plan)

    def to(self, device=None, dtype=None) -> "GroupedNMTensor":
        """Move to ``device`` and/or cast the stored values to ``dtype``
        (index tables keep int32)."""
        plan = None if self.plan is None else SpmmPlan(
            self.plan.cols.to(device), self.plan.pat_onehot.to(device))
        return dataclasses.replace(
            self, val=self.val.to(device=device, dtype=dtype),
            blk_idx=self.blk_idx.to(device), plan=plan)

    def to_dense(self) -> torch.Tensor:
        """Dense per-layer matrix in ``dense_shape``."""
        assert not self.stacked, "to_dense() of one layer: use .layer(i)"
        sd = self.sparse_dim % 2
        r, k = self.dense_shape[1 - sd], self.dense_shape[sd]
        R_pad, nblocks, n = self.val.shape
        cols = self.gather_plan().cols                        # [Gr, nb*n]
        cols_rows = torch.repeat_interleave(cols, self.gr, dim=0).long()
        out = torch.zeros((R_pad, nblocks * self.m), dtype=self.val.dtype,
                          device=self.val.device)
        out.scatter_add_(1, cols_rows, self.val.reshape(R_pad, -1))
        out = out[:r, :k]
        return out.T.contiguous() if sd == 0 else out
