"""Sparse-aware parameter updates (port of
``repro/optim/sparse_update.py``): after the dense-math optimizer update,
every ``FixedMaskTensor`` leaf is re-sparsified to its own format — the
fixed pattern on most steps, a recomputed pattern when the GMP schedule
says so (paper Fig 9: 'fixed' versus 'new' sparsification).  Gradient
formats (``sparsify_grads``) and the n:m:g / n:m / CSR / COO leaves are
not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import nmg
from repro_torch.core.layouts import DenseTensor, FixedMaskTensor, \
    SparsityLayout
from repro_torch.core.sparsifiers import SameFormatSparsifier, \
    ScalarFractionSparsifier
from repro_torch.optim.optimizers import tree_map

__all__ = ["resparsify_params", "sparse_aware_update"]


def resparsify_params(params, *, recompute_pattern: bool = False,
                      target_sparsity=None):
    """SameFormatSparsifier over every sparse leaf.  With
    ``recompute_pattern`` and ``target_sparsity``, a leaf whose origin is a
    ``ScalarFractionSparsifier`` (or unrecorded) is re-pruned by global
    magnitude at that sparsity; every other origin (n:m, ...) runs its
    native recompute.  A recompute reads the raw ``val`` (pruned weights
    keep their updates and may re-enter the mask)."""
    sp = SameFormatSparsifier(fixed_pattern=not recompute_pattern)

    def visit(leaf):
        if isinstance(leaf, FixedMaskTensor):
            if not recompute_pattern:
                return sp.resparsify(leaf, leaf.to_dense())
            if target_sparsity is not None and (
                    leaf.origin is None
                    or isinstance(leaf.origin, ScalarFractionSparsifier)):
                mask = nmg.unstructured_mask(leaf.val, target_sparsity).bool()
                return FixedMaskTensor(leaf.val * mask, mask, leaf.origin)
            return sp.resparsify(leaf, leaf.val)
        if isinstance(leaf, SparsityLayout) \
                and not isinstance(leaf, DenseTensor):
            raise NotImplementedError(
                f"re-sparsifying {type(leaf).__name__} leaves is not ported "
                f"yet")
        return leaf

    with torch.no_grad():
        return tree_map(visit, params)


def sparse_aware_update(update_fn, grads, state, params):
    """``update_fn(grads, state, params)`` followed by fixed-pattern
    re-sparsification; pattern recomputes are the caller's, through
    :func:`resparsify_params` (``launch/train.py:retarget_sparsity``)."""
    new_params, new_state, metrics = update_fn(grads, state, params)
    return resparsify_params(new_params), new_state, metrics
