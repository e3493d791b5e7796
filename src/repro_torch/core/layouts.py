"""Sparsity layouts (port of ``repro/core/layouts.py``, paper §3.1).

A layout is a plain class over tensors: ``to_dense`` is built from
differentiable torch ops for every layout, so autograd carries gradients
to the stored values (``val`` / ``data``).  :func:`register_layout` records
a class in the registry that :func:`all_layouts` lists; it is the
extension point of the paper's §3.1 example.

Unstructured formats (CSR/COO) are capacity padded as in the reference:
``nnz_cap`` is the stored length, the tail holds zeros, and an entry past
the capacity lands in a scratch slot that is cut off, never clamped into
the data.  The default capacity is a host int (one sync): build them
eagerly, never inside a captured graph.  Structured formats (n:m, n:m:g)
are shape-static.  Integer tables are built with numpy exactly as the
reference builds them, so they equal it element for element.

Layers are scan-stacked in the reference: a stacked layout carries a
leading ``[L]`` axis on its tensors while ``dense_shape`` stays the
per-layer shape.  ``unbind`` / ``layer`` slice one layer back out (views,
no copy) and ``stack`` re-stacks per-layer layouts.
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
    "CsrTensor",
    "CooTensor",
    "FixedMaskTensor",
    "NMTensor",
    "GroupedNMTensor",
    "SpmmPlan",
    "build_spmm_plan",
    "register_layout",
    "all_layouts",
    "nm_patterns",
    "pos_pattern_offsets",
    "pattern_onehots",
    "pad_to_multiple",
]

_LAYOUT_REGISTRY: dict = {}


def register_layout(cls):
    """Class decorator: register ``cls`` as a sparsity layout.  The class
    must define ``to_dense``."""
    if not hasattr(cls, "to_dense"):
        raise TypeError(f"layout {cls.__name__} must define to_dense()")
    _LAYOUT_REGISTRY[cls.__name__] = cls
    return cls


def all_layouts() -> dict:
    return dict(_LAYOUT_REGISTRY)


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
    """Base of the layouts: dispatch keys on the layout class.  Required:
    ``to_dense()``, ``shape``, ``dtype``; optional ``density()``."""

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def _as_tensor(x) -> torch.Tensor:
    return x.to_dense() if isinstance(x, SparsityLayout) else \
        torch.as_tensor(x)


def _default_cap(total: torch.Tensor) -> int:
    """The reference's default capacity: the true count rounded up to a
    multiple of 8, at least 8 (a host int: one sync)."""
    return max(8, int(math.ceil(int(total) / 8.0)) * 8)


@register_layout
@dataclasses.dataclass
class DenseTensor(SparsityLayout):
    """Trivial layout: a dense tensor, so dispatch treats dense and sparse
    operands alike."""

    data: torch.Tensor

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def to_dense(self) -> torch.Tensor:
        return self.data

    def density(self) -> float:
        return 1.0

    def unbind(self, dim: int = 0) -> list:
        return [DenseTensor(d) for d in self.data.unbind(dim)]

    @classmethod
    def stack(cls, parts) -> "DenseTensor":
        return cls(torch.stack([p.data for p in parts]))


@register_layout
@dataclasses.dataclass
class CsrTensor(SparsityLayout):
    """Compressed Sparse Row with a static nonzero capacity, 2-D only.
    ``data`` / ``indices`` have length ``nnz_cap``; padding slots carry
    value 0 and column 0 and lie past ``indptr[-1]``."""

    data: torch.Tensor      # [nnz_cap]
    indices: torch.Tensor   # [nnz_cap] int32 column ids
    indptr: torch.Tensor    # [rows + 1] int32
    dense_shape: tuple

    @property
    def shape(self):
        return tuple(self.dense_shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz_cap(self) -> int:
        return self.data.shape[0]

    def row_ids(self) -> tuple:
        """(row of every stored slot, valid slot mask)."""
        positions = torch.arange(self.nnz_cap, dtype=self.indptr.dtype,
                                 device=self.indptr.device)
        row_ids = torch.searchsorted(self.indptr, positions, right=True) - 1
        return (row_ids.clamp(0, self.dense_shape[0] - 1).long(),
                positions < self.indptr[-1])

    def to_dense(self) -> torch.Tensor:
        rows, cols = self.dense_shape
        row_ids, valid = self.row_ids()
        flat_idx = row_ids * cols + self.indices.long()
        vals = torch.where(valid, self.data, torch.zeros_like(self.data))
        out = torch.zeros(rows * cols, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_add(0, flat_idx, vals).reshape(rows, cols)

    def density(self) -> float:
        return int(self.indptr[-1]) / max(1, self.size)

    @classmethod
    def from_dense(cls, x, nnz_cap: Optional[int] = None) -> "CsrTensor":
        """Exact (lossless) dense -> CSR, nonzeros of each row in column
        order.  ``nnz_cap`` defaults to the true nnz rounded up to a
        multiple of 8 (a host sync)."""
        x = _as_tensor(x)
        assert x.ndim == 2, "CsrTensor is 2-D"
        rows, cols = x.shape
        mask = x != 0
        nnz_per_row = mask.sum(dim=1, dtype=torch.int32)
        indptr = torch.cat([nnz_per_row.new_zeros(1),
                            torch.cumsum(nnz_per_row, 0, dtype=torch.int32)])
        if nnz_cap is None:
            nnz_cap = _default_cap(indptr[-1])
        # a stable sort puts each row's nonzeros first, in column order
        order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
        flat_vals = torch.gather(x, 1, order).reshape(-1)
        flat_cols = order.reshape(-1).to(torch.int32)
        flat_keep = torch.gather(mask, 1, order).reshape(-1)
        dest = torch.cumsum(flat_keep, 0) - 1
        # dropped or beyond-capacity -> the scratch slot (never clamped)
        dest = torch.where(flat_keep & (dest < nnz_cap), dest,
                           torch.full_like(dest, nnz_cap))
        data = x.new_zeros(nnz_cap + 1).scatter(0, dest, flat_vals)[:-1]
        indices = flat_cols.new_zeros(nnz_cap + 1).scatter(
            0, dest, flat_cols)[:-1]
        return cls(data, indices, indptr, (rows, cols))


@register_layout
@dataclasses.dataclass
class CooTensor(SparsityLayout):
    """Coordinate format with a static capacity; N-dimensional.  Padding
    slots carry value 0 at the origin."""

    data: torch.Tensor     # [nnz_cap]
    coords: torch.Tensor   # [ndim, nnz_cap] int32
    dense_shape: tuple

    @property
    def shape(self):
        return tuple(self.dense_shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz_cap(self) -> int:
        return self.data.shape[0]

    def flat_index(self) -> torch.Tensor:
        """Row-major flat position of every stored slot (int64)."""
        strides = [int(np.prod(self.dense_shape[i + 1:]))
                   for i in range(len(self.dense_shape))]
        st = torch.tensor(strides, dtype=torch.int64,
                          device=self.coords.device)
        return (self.coords.long() * st[:, None]).sum(0)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(int(np.prod(self.dense_shape)),
                          dtype=self.data.dtype, device=self.data.device)
        return out.index_add(0, self.flat_index(), self.data).reshape(
            self.dense_shape)

    def density(self) -> float:
        return int((self.data != 0).sum()) / max(1, self.size)

    @classmethod
    def from_dense(cls, x, nnz_cap: Optional[int] = None) -> "CooTensor":
        x = _as_tensor(x)
        flat = x.reshape(-1)
        mask = flat != 0
        if nnz_cap is None:
            nnz_cap = _default_cap(mask.sum())
        dest = torch.cumsum(mask, 0) - 1
        dest = torch.where(mask & (dest < nnz_cap), dest,
                           torch.full_like(dest, nnz_cap))
        data = flat.new_zeros(nnz_cap + 1).scatter(0, dest, flat)[:-1]
        pos = torch.arange(flat.shape[0], dtype=torch.int64, device=x.device)
        rem = pos.new_zeros(nnz_cap + 1).scatter(0, dest, pos)[:-1]
        coords = []
        for dim in reversed(x.shape):
            coords.append(rem % dim)
            rem = rem // dim
        return cls(data, torch.stack(coords[::-1]).to(torch.int32),
                   tuple(x.shape))


@register_layout
@dataclasses.dataclass
class NMTensor(SparsityLayout):
    """Plain n:m sparsity along the last axis: each block of m elements
    stores exactly n values, at sorted in-block offsets ``idx``.  A
    stacked tensor carries a leading [L] axis on ``val`` / ``idx`` with the
    per-layer ``dense_shape``."""

    val: torch.Tensor   # [..., nblocks, n]
    idx: torch.Tensor   # [..., nblocks, n] int32 in-block offsets (sorted)
    n: int
    m: int
    dense_shape: tuple

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
        return self.val.ndim == len(self.dense_shape) + 2

    def density(self) -> float:
        return self.n / self.m

    def to_dense(self) -> torch.Tensor:
        k = self.dense_shape[-1]
        nblocks = self.val.shape[-2]
        base = torch.arange(nblocks, dtype=torch.int64,
                            device=self.val.device) * self.m
        cols = (base[:, None] + self.idx.long()).flatten(-2)
        out = self.val.new_zeros((*self.val.shape[:-2], nblocks * self.m))
        out = out.scatter_add(-1, cols, self.val.flatten(-2))
        return out[..., :k]

    @classmethod
    def from_dense(cls, x, n: int, m: int) -> "NMTensor":
        """Per-block top-n by magnitude (the per-block fraction
        sparsifier), selected by the ``nm_mask`` kernel's rule: the lowest
        index wins ties, magnitudes below the smallest normal f32 rank as
        0.  A block that keeps more than n (a NaN is always kept) stores
        the first n it keeps."""
        from repro_torch.kernels import ops as kops

        x = _as_tensor(x)
        xp = pad_to_multiple(x, m, axis=-1)
        blocks = xp.reshape(*xp.shape[:-1], -1, m)
        keep = kops.nm_mask(xp, n, m).reshape(blocks.shape)
        # the i-th kept entry of a block goes to slot i, entries past the
        # n-th kept one (and dropped ones) to a scratch slot cut off after.
        # The running count of kept entries is a product with an
        # upper-triangular ones matrix (exact: 0/1 terms, sums <= m), as a
        # scan along a short last axis runs row by row
        tri = torch.ones(m, m, device=x.device).triu()
        rank = (keep.float() @ tri).long() - 1
        dest = torch.where(keep & (rank < n), rank, n)
        offs = torch.arange(m, dtype=torch.int32, device=x.device)
        idx = torch.zeros((*blocks.shape[:-1], n + 1), dtype=torch.int32,
                          device=x.device).scatter_(
            -1, dest, offs.expand(blocks.shape).contiguous())[..., :n]
        idx = idx.contiguous()
        val = torch.gather(blocks, -1, idx.long())
        return cls(val, idx, n, m, tuple(x.shape))

    def unbind(self, dim: int = 0) -> list:
        """Every layer of a stacked tensor (or every slice of the leading
        axis of an unstacked one), as views."""
        shape = self.dense_shape if self.stacked else self.dense_shape[1:]
        return [NMTensor(v, i, self.n, self.m, shape)
                for v, i in zip(self.val.unbind(dim), self.idx.unbind(dim))]

    @classmethod
    def stack(cls, parts) -> "NMTensor":
        p0 = parts[0]
        return cls(torch.stack([p.val for p in parts]),
                   torch.stack([p.idx for p in parts]), p0.n, p0.m,
                   p0.dense_shape)

    def to(self, device=None, dtype=None) -> "NMTensor":
        return NMTensor(self.val.to(device=device, dtype=dtype),
                        self.idx.to(device), self.n, self.m,
                        self.dense_shape)


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


@register_layout
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

    def density(self) -> float:
        return float(self.mask.float().mean())

    @classmethod
    def from_dense(cls, x) -> "FixedMaskTensor":
        x = _as_tensor(x)
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


@register_layout
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

    @property
    def num_patterns(self) -> int:
        return math.comb(self.m, self.n)

    def density(self) -> float:
        return self.n / self.m

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

    @classmethod
    def from_dense(cls, x, n: int, m: int, g: int, gr: int = 1,
                   sparse_dim: int = -1, method: str = "greedy"
                   ) -> "GroupedNMTensor":
        from repro_torch.core import nmg

        return nmg.dense_to_grouped_nm(_as_tensor(x), n=n, m=m, g=g, gr=gr,
                                       sparse_dim=sparse_dim, method=method)
