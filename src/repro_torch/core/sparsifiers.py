"""Sparsifiers (port of part of ``repro/core/sparsifiers.py``): the
Table 1 classes that the serving conversion and masked training use —
keep-all, scalar threshold, n:m (per-block fraction), n:m:g and scalar
fraction (magnitude) — and ``SameFormatSparsifier`` for
``FixedMaskTensor`` references.  The random, block-wise and n:m:g-mask
sparsifiers, the registry and the NMTensor/CSR/COO branches are not
ported yet.

Every sparsifier exposes its semantic core as ``mask(x)``.  The n:m mask
runs the ``nm_mask`` kernel (``kernels/ops.py``), which equals the
reference's Pallas kernel bit for bit, and its ``lax.top_k`` selection
wherever the two reference routes agree (they differ on NaN, and on f32
subnormals).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import nmg
from repro_torch.core.layouts import DenseTensor, FixedMaskTensor, \
    GroupedNMTensor, SparsityLayout

__all__ = ["Sparsifier", "KeepAll", "ScalarThresholdSparsifier",
           "NMSparsifier", "GroupedNMSparsifier", "ScalarFractionSparsifier",
           "SameFormatSparsifier", "apply_sparsifier"]


def _dense(x) -> torch.Tensor:
    return x.to_dense() if isinstance(x, SparsityLayout) else x


class Sparsifier:
    """Base class: ``mask(x)`` is the semantic core; calling a sparsifier
    masks a dense tensor."""

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__}.mask is not ported yet")

    def __call__(self, x):
        """Default action: dense in, masked dense out."""
        x = _dense(x)
        return x * self.mask(x).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class KeepAll(Sparsifier):
    """Keeps every produced value (the identity inline sparsifier)."""

    def mask(self, x):
        return torch.ones_like(x, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class ScalarThresholdSparsifier(Sparsifier):
    """Keep |x| >= threshold (streaming; fused into ``matmul_threshold``
    when it is a matmul's inline sparsifier)."""

    threshold: float = 0.0

    def mask(self, x):
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

    def mask(self, x):
        from repro_torch.kernels import ops as kops

        return kops.nm_mask(x, self.n, self.m)


@dataclasses.dataclass(frozen=True)
class GroupedNMSparsifier(Sparsifier):
    """The paper's n:m:g sparsifier (§5.2); ``gr`` is the row-sharing
    width, ``sparse_dim`` 0 for weights stored [K, N].  Converts to
    :class:`GroupedNMTensor` only (its masked-dense form is not ported)."""

    n: int = 2
    m: int = 4
    g: int = 16
    gr: int = 1
    method: str = "greedy"
    sparse_dim: int = -1


@dataclasses.dataclass(frozen=True)
class ScalarFractionSparsifier(Sparsifier):
    """Magnitude pruning: keep the top (1 - fraction) of values by |x|
    over the whole tensor."""

    fraction: float = 0.5

    def mask(self, x):
        return nmg.unstructured_mask(x, self.fraction).bool()


@dataclasses.dataclass(frozen=True)
class SameFormatSparsifier(Sparsifier):
    """Re-sparsify a new dense value into the format of a reference sparse
    tensor (applied after optimizer updates).  ``fixed_pattern`` reuses
    the reference's pattern; otherwise it is recomputed by the layout's
    origin sparsifier, or by magnitude rank at the reference's density."""

    fixed_pattern: bool = True

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
        raise NotImplementedError(
            f"SameFormatSparsifier for {type(ref).__name__} is not ported "
            f"yet")


def apply_sparsifier(sparsifier: Sparsifier, x, out_layout: type = DenseTensor):
    """Apply ``sparsifier`` to ``x`` producing ``out_layout``: the n:m:g
    conversion for (GroupedNMSparsifier, GroupedNMTensor), else the
    reference's generic path — mask in dense space, then the masked dense
    tensor (``DenseTensor``) or ``FixedMaskTensor(masked, mask, origin)``."""
    dense = _dense(x)
    if isinstance(sparsifier, GroupedNMSparsifier):
        if out_layout is not GroupedNMTensor:
            raise NotImplementedError(
                "GroupedNMSparsifier converts to GroupedNMTensor only")
        return nmg.dense_to_grouped_nm(
            dense, n=sparsifier.n, m=sparsifier.m, g=sparsifier.g,
            gr=sparsifier.gr, sparse_dim=sparsifier.sparse_dim,
            method=sparsifier.method)
    mask = sparsifier.mask(dense)
    masked = dense * mask.to(dense.dtype)
    if out_layout in (DenseTensor, None):
        return DenseTensor(masked)
    if out_layout is FixedMaskTensor:
        return FixedMaskTensor(masked, mask, origin=sparsifier)
    raise NotImplementedError(
        f"no ported conversion to {getattr(out_layout, '__name__', out_layout)}")
