"""Sparsifiers (port of ``repro/core/sparsifiers.py``, paper §3.3 and
Table 1).  A sparsifier decides which values of an operator's output to
keep; ``kind`` is its Table 1 class and ``passes`` the passes over the
tensor it needs:

  * streaming      1 pass, O(1) memory   (keep-all, random fraction,
                   scalar threshold): candidates for inlining into
                   operators (the fused ``matmul_threshold`` kernel);
  * blocking       2 passes, O(b) memory (per-block fraction = n:m,
                   grouped n:m);
  * materializing  2 passes, O(nnz)      (scalar fraction = magnitude,
                   block-wise fraction).

Every sparsifier exposes its semantic core as ``mask(x, generator=None)``
(a ``torch.Generator`` where the reference takes a ``jax.random`` key).
Layout-specific implementations are registered under ``(sparsifier
class, input layout, output layout)``
(:func:`register_sparsifier_implementation`); an unregistered combination
masks in dense space and converts, as in the reference.

The n:m mask runs the ``nm_mask`` kernel (``kernels/ops.py``), which
equals the reference's Pallas kernel bit for bit, and its ``lax.top_k``
selection wherever the two reference routes agree (they differ on NaN,
and on f32 subnormals).  ``RandomFractionSparsifier`` draws from
``torch.rand``: its masks have the reference's distribution, not its bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core import nmg
from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, GroupedNMTensor, NMTensor, SparsityLayout, \
    pad_to_multiple

__all__ = [
    "Sparsifier",
    "KeepAll",
    "RandomFractionSparsifier",
    "ScalarThresholdSparsifier",
    "NMSparsifier",
    "GroupedNMSparsifier",
    "ScalarFractionSparsifier",
    "BlockwiseFractionSparsifier",
    "SameFormatSparsifier",
    "register_sparsifier_implementation",
    "apply_sparsifier",
    "lookup_sparsifier_impl",
]

STREAMING = "streaming"
BLOCKING = "blocking"
MATERIALIZING = "materializing"


def _dense(x) -> torch.Tensor:
    return x.to_dense() if isinstance(x, SparsityLayout) else x


class Sparsifier:
    """Base class: ``mask(x, generator=None)`` is the semantic core;
    calling a sparsifier masks a dense tensor."""

    kind = STREAMING
    passes = 1

    def mask(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x, generator=None):
        """Default action: dense in, masked dense out."""
        x = _dense(x)
        return x * self.mask(x, generator).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class KeepAll(Sparsifier):
    """Keeps every produced value (the identity inline sparsifier)."""

    kind = STREAMING
    passes = 1

    def mask(self, x, generator=None):
        return torch.ones_like(x, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class RandomFractionSparsifier(Sparsifier):
    """Drop values with probability ``fraction`` (dropout-style), drawn
    from ``generator`` (a fresh generator seeded 0 on ``x``'s device when
    None, as the reference falls back to ``PRNGKey(0)``)."""

    fraction: float = 0.5
    kind = STREAMING
    passes = 1

    def mask(self, x, generator=None):
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        return torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.fraction


@dataclasses.dataclass(frozen=True)
class ScalarThresholdSparsifier(Sparsifier):
    """Keep |x| >= threshold (streaming; fused into ``matmul_threshold``
    when it is a matmul's inline sparsifier)."""

    threshold: float = 0.0
    kind = STREAMING
    passes = 1

    def mask(self, x, generator=None):
        return x.abs() >= self.threshold


@dataclasses.dataclass(frozen=True)
class NMSparsifier(Sparsifier):
    """Per-block fraction: keep the top-n of each m-block along the last
    axis (plain n:m sparsity), through the ``nm_mask`` kernel.  Its rule is
    the reference Pallas kernel's: magnitudes below the smallest normal
    f32 rank as 0, a NaN is kept (when n > 0) and never counted against
    the others, and the lowest index wins ties."""

    n: int = 2
    m: int = 4
    kind = BLOCKING
    passes = 2

    def mask(self, x, generator=None):
        from repro_torch.kernels import ops as kops

        return kops.nm_mask(x, self.n, self.m)


@dataclasses.dataclass(frozen=True)
class GroupedNMSparsifier(Sparsifier):
    """The paper's n:m:g sparsifier (§5.2); ``gr`` is the row-sharing
    width, ``sparse_dim`` 0 for weights stored [K, N].  Its mask is what
    the conversion keeps, per layer on a stacked [L, ...] leaf."""

    n: int = 2
    m: int = 4
    g: int = 16
    gr: int = 1
    method: str = "greedy"
    sparse_dim: int = -1
    kind = BLOCKING
    passes = 2

    def mask(self, x, generator=None):
        def one(xx):
            return nmg.grouped_nm_mask(
                xx, self.n, self.m, self.g, gr=self.gr,
                sparse_dim=self.sparse_dim, method=self.method).bool()

        if x.ndim == 3:
            return torch.stack([one(xx) for xx in x.unbind(0)])
        return one(x)


@dataclasses.dataclass(frozen=True)
class ScalarFractionSparsifier(Sparsifier):
    """Magnitude pruning: keep the top (1 - fraction) of values by |x|
    over the whole tensor."""

    fraction: float = 0.5
    kind = MATERIALIZING
    passes = 2

    def mask(self, x, generator=None):
        return nmg.unstructured_mask(x, self.fraction).bool()


@dataclasses.dataclass(frozen=True)
class BlockwiseFractionSparsifier(Sparsifier):
    """Block-wise fraction: drop whole blocks of ``block`` elements (last
    axis) with the smallest combined magnitude."""

    fraction: float = 0.5
    block: int = 4
    kind = MATERIALIZING
    passes = 2

    def mask(self, x, generator=None):
        return nmg.blocked_mask(x, self.block, self.fraction).bool()


@dataclasses.dataclass(frozen=True)
class SameFormatSparsifier(Sparsifier):
    """Re-sparsify a new dense value into the format of a reference sparse
    tensor (applied after optimizer updates).  ``fixed_pattern`` reuses
    the reference's pattern; otherwise the layout's native sparsifier
    recomputes it (a ``FixedMaskTensor`` by its origin, or by magnitude
    rank at the reference's density)."""

    fixed_pattern: bool = True
    kind = BLOCKING
    passes = 1

    def resparsify(self, ref, new_dense):
        new_dense = _dense(new_dense)
        if isinstance(ref, FixedMaskTensor):
            if self.fixed_pattern:
                return FixedMaskTensor(new_dense * ref.mask, ref.mask,
                                       ref.origin)
            if ref.origin is not None:
                mask = ref.origin.mask(new_dense)
                return FixedMaskTensor(new_dense * mask, mask, ref.origin)
            # generic: the reference's density by magnitude rank, ties to
            # the lowest index (a stable sort, as jnp.argsort)
            k = ref.mask.sum()
            flat = new_dense.abs().reshape(-1)
            order = torch.argsort(-flat, stable=True)
            ranks = torch.empty_like(order)
            ranks[order] = torch.arange(order.numel(), device=order.device)
            mask = (ranks < k).reshape(new_dense.shape)
            return FixedMaskTensor(new_dense * mask, mask, ref.origin)
        if isinstance(ref, GroupedNMTensor):
            if ref.stacked:
                return GroupedNMTensor.stack([
                    self.resparsify(ref.layer(i), d)
                    for i, d in enumerate(new_dense.unbind(0))])
            if self.fixed_pattern:
                return _regather_grouped_nm(ref, new_dense)
            return nmg.dense_to_grouped_nm(
                new_dense, n=ref.n, m=ref.m, g=ref.g, gr=ref.gr,
                sparse_dim=ref.sparse_dim)
        if isinstance(ref, NMTensor):
            if self.fixed_pattern:
                return _regather_nm(ref, new_dense)
            out = NMTensor.from_dense(new_dense, ref.n, ref.m)
            return NMTensor(out.val, out.idx, ref.n, ref.m, ref.dense_shape)
        if isinstance(ref, CsrTensor):
            if self.fixed_pattern:
                row_ids, valid = ref.row_ids()
                data = new_dense[row_ids, ref.indices.long()]
                data = torch.where(valid, data, torch.zeros_like(data))
                return CsrTensor(data.to(ref.dtype), ref.indices,
                                 ref.indptr, ref.dense_shape)
            return CsrTensor.from_dense(new_dense, nnz_cap=ref.nnz_cap)
        if isinstance(ref, CooTensor):
            if self.fixed_pattern:
                data = new_dense.reshape(-1)[ref.flat_index()]
                # padding slots (origin coordinate, stored zero) stay zero
                pad = (ref.coords.sum(0) == 0) & (ref.data == 0)
                data = torch.where(pad, torch.zeros_like(data), data)
                return CooTensor(data.to(ref.dtype), ref.coords,
                                 ref.dense_shape)
            return CooTensor.from_dense(new_dense, nnz_cap=ref.nnz_cap)
        if isinstance(ref, DenseTensor):
            return DenseTensor(new_dense)
        raise TypeError(f"SameFormatSparsifier: unsupported ref {type(ref)}")


def _regather_nm(ref: NMTensor, dense: torch.Tensor) -> NMTensor:
    """Fixed pattern: re-read the values at the stored offsets (any
    leading axes, a stacked tensor's included)."""
    xp = pad_to_multiple(dense, ref.m, axis=-1)
    blocks = xp.reshape(*xp.shape[:-1], -1, ref.m)
    val = torch.gather(blocks, -1, ref.idx.long())
    return NMTensor(val, ref.idx, ref.n, ref.m, ref.dense_shape)


def _regather_grouped_nm(ref: GroupedNMTensor, dense: torch.Tensor
                         ) -> GroupedNMTensor:
    """Fixed pattern: keep ``blk_idx`` and the gather plan, re-read the
    values from ``dense``."""
    sd = ref.sparse_dim % 2
    xc = dense.T if sd == 0 else dense
    CG = math.comb(ref.m, ref.n) * ref.g
    xp = pad_to_multiple(pad_to_multiple(xc, ref.gr, 0), ref.m * CG, 1)
    plan = ref.gather_plan()
    cols_rows = torch.repeat_interleave(plan.cols, ref.gr, dim=0).long()
    val = torch.gather(xp, 1, cols_rows).reshape(ref.val.shape)
    return dataclasses.replace(ref, val=val, plan=plan)


# ---------------------------------------------------------------------------
# the implementation registry (paper §3.3 / §4.3)
# ---------------------------------------------------------------------------

_SPARSIFIER_IMPLS: dict = {}


def register_sparsifier_implementation(sparsifier: type, inp: type,
                                       out: type):
    """Decorator: ``fn(sparsifier, tensor, generator=None)`` makes an
    ``out`` layout from an ``inp`` one."""

    def deco(fn: Callable):
        keyt = (sparsifier, inp, out)
        if keyt in _SPARSIFIER_IMPLS:
            raise ValueError(f"duplicate sparsifier impl for {keyt}")
        _SPARSIFIER_IMPLS[keyt] = fn
        return fn

    return deco


def lookup_sparsifier_impl(sparsifier, inp_cls, out_cls):
    return _SPARSIFIER_IMPLS.get((type(sparsifier), inp_cls, out_cls))


def apply_sparsifier(sparsifier: Sparsifier, x, out_layout=DenseTensor,
                     generator: Optional[torch.Generator] = None):
    """Apply ``sparsifier`` to ``x``, producing ``out_layout``:

    1. the registered (sparsifier, layout of x, out_layout) implementation;
    2. the registered (sparsifier, DenseTensor, out_layout) one on the
       densified x;
    3. else mask in dense space and convert the masked tensor."""
    inp_cls = type(x) if isinstance(x, SparsityLayout) else DenseTensor
    impl = lookup_sparsifier_impl(sparsifier, inp_cls, out_layout)
    if impl is not None:
        return impl(sparsifier, x, generator=generator)
    if inp_cls is not DenseTensor:
        impl = lookup_sparsifier_impl(sparsifier, DenseTensor, out_layout)
        if impl is not None:
            return impl(sparsifier, DenseTensor(x.to_dense()),
                        generator=generator)
    dense = _dense(x)
    if isinstance(sparsifier, KeepAll):
        masked, mask = dense, torch.ones_like(dense, dtype=torch.bool)
    else:
        mask = sparsifier.mask(dense, generator)
        masked = dense * mask.to(dense.dtype)
    return _dense_to_layout(masked, mask, out_layout, sparsifier)


def _dense_to_layout(masked, mask, out_layout, sparsifier):
    if out_layout in (DenseTensor, torch.Tensor, None):
        return DenseTensor(masked)
    if out_layout is FixedMaskTensor:
        return FixedMaskTensor(masked, mask.bool(), origin=sparsifier)
    if out_layout is CsrTensor:
        return CsrTensor.from_dense(masked)
    if out_layout is CooTensor:
        return CooTensor.from_dense(masked)
    if out_layout is NMTensor:
        return NMTensor.from_dense(masked, getattr(sparsifier, "n", 2),
                                   getattr(sparsifier, "m", 4))
    if out_layout is GroupedNMTensor:
        return nmg.dense_to_grouped_nm(
            masked, n=getattr(sparsifier, "n", 2),
            m=getattr(sparsifier, "m", 4), g=getattr(sparsifier, "g", 16),
            gr=getattr(sparsifier, "gr", 1))
    raise TypeError(f"no conversion path to layout {out_layout}")


# -- native implementations for the structured formats ---------------------


@register_sparsifier_implementation(NMSparsifier, DenseTensor, NMTensor)
def _dense_to_nm(sp: NMSparsifier, x, generator=None):
    return NMTensor.from_dense(_dense(x), sp.n, sp.m)


@register_sparsifier_implementation(GroupedNMSparsifier, DenseTensor,
                                    GroupedNMTensor)
def _dense_to_grouped_nm_impl(sp: GroupedNMSparsifier, x, generator=None):
    return nmg.dense_to_grouped_nm(
        _dense(x), n=sp.n, m=sp.m, g=sp.g, gr=sp.gr,
        sparse_dim=sp.sparse_dim, method=sp.method)


@register_sparsifier_implementation(GroupedNMSparsifier, DenseTensor,
                                    FixedMaskTensor)
def _dense_to_fixed_mask_grouped_nm(sp: GroupedNMSparsifier, x,
                                    generator=None):
    """Masked-dense n:m:g, the training-time representation (§5.3)."""
    dense = _dense(x)
    mask = nmg.grouped_nm_mask(dense, sp.n, sp.m, sp.g, gr=sp.gr,
                               sparse_dim=sp.sparse_dim, method=sp.method)
    return FixedMaskTensor(dense * mask, mask.bool(), origin=sp)
