"""Sparse-aware parameter updates (port of
``repro/optim/sparse_update.py``): after the dense-math optimizer update,
every ``FixedMaskTensor`` leaf is re-sparsified to its own format — the
fixed pattern on most steps, a recomputed pattern when the GMP schedule
says so (paper Fig 9: 'fixed' versus 'new' sparsification).  Gradient
formats (``sparsify_grads``) and the n:m:g / n:m / CSR / COO leaves are
not ported yet.

Two spellings of one policy: :func:`resparsify_params` returns new
leaves, :func:`resparsify_params_` writes the leaves' own ``val`` and
``mask`` (the training step, whose CUDA graph replays on that storage,
and the eager pattern recomputes between its replays).  They give the
same values bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import nmg
from repro_torch.core.layouts import DenseTensor, FixedMaskTensor, \
    SparsityLayout
from repro_torch.core.sparsifiers import SameFormatSparsifier, \
    ScalarFractionSparsifier
from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["resparsify_params", "resparsify_params_", "sparse_aware_update"]


def _check_ported(leaf) -> None:
    if isinstance(leaf, SparsityLayout) and not isinstance(
            leaf, (DenseTensor, FixedMaskTensor)):
        raise NotImplementedError(
            f"re-sparsifying {type(leaf).__name__} leaves is not ported yet")


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
        _check_ported(leaf)
        return leaf

    with torch.no_grad():
        return tree_map(visit, params)


def resparsify_params_(params, *, recompute_pattern: bool = False,
                       target_sparsity=None):
    """:func:`resparsify_params` in place: every ``FixedMaskTensor``
    leaf keeps its ``val`` and ``mask`` tensors and gets the new values
    written into them; returns ``params``.  The fixed pattern is ``val *=
    mask`` (``val * mask * mask`` of the returning form, the same bits);
    a recompute computes the new leaf as the returning form does and
    copies it in."""
    with torch.no_grad():
        for leaf in tree_leaves(params):
            if not isinstance(leaf, FixedMaskTensor):
                _check_ported(leaf)
            elif not recompute_pattern:
                leaf.val.mul_(leaf.mask)
            else:
                new = resparsify_params(leaf, recompute_pattern=True,
                                        target_sparsity=target_sparsity)
                leaf.mask.copy_(new.mask)
                leaf.val.copy_(new.val)
    return params


def sparse_aware_update(update_fn, grads, state, params):
    """``update_fn(grads, state, params)`` followed by fixed-pattern
    re-sparsification in place (``adamw_update`` writes in place too);
    pattern recomputes are the caller's (``launch/train.py:
    retarget_sparsity``)."""
    new_params, new_state, metrics = update_fn(grads, state, params)
    return resparsify_params_(new_params), new_state, metrics
