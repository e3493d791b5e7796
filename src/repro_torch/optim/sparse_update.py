"""Sparse-aware parameter updates (port of
``repro/optim/sparse_update.py``): the gradients are sparsified by the
builder's gradient formats (``sparsify_grads``), the optimizer updates in
dense math, and every sparse leaf is re-sparsified to its own format —
the fixed pattern on most steps, a recomputed pattern when the GMP
schedule says so (paper Fig 9: 'fixed' versus 'new' sparsification).
``FixedMaskTensor``, ``NMTensor`` and ``GroupedNMTensor`` leaves are
re-sparsified (a stacked one per layer); a ``DenseTensor`` needs nothing
and CSR/COO leaves pass through, as in the reference.

Two spellings of one policy: :func:`resparsify_params` returns new
leaves, :func:`resparsify_params_` writes the leaves' own tensors (the
training step, whose CUDA graph replays on that storage, and the eager
pattern recomputes between its replays).  They give the same values bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nmg
from repro_torch.core.autograd import sparsify_grads
from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor, \
    NMTensor
from repro_torch.core.sparsifiers import SameFormatSparsifier, \
    ScalarFractionSparsifier
from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["resparsify_params", "resparsify_params_", "sparse_aware_update"]


def resparsify_params(params, *, recompute_pattern: bool = False,
                      target_sparsity=None):
    """SameFormatSparsifier over every sparse leaf.  With
    ``recompute_pattern`` and ``target_sparsity``, a ``FixedMaskTensor``
    whose origin is a ``ScalarFractionSparsifier`` (or unrecorded) is
    re-pruned by global magnitude at that sparsity; every other origin
    (n:m, ...) runs its native recompute.  A FixedMask recompute reads the
    raw ``val`` (pruned weights keep their updates and may re-enter the
    mask); an n:m or n:m:g leaf is recomputed from its stored values."""
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
        if isinstance(leaf, GroupedNMTensor) and leaf.stacked:
            return sp.resparsify(leaf, torch.stack([
                leaf.layer(i).to_dense() for i in range(leaf.val.shape[0])]))
        if isinstance(leaf, (NMTensor, GroupedNMTensor)):
            return sp.resparsify(leaf, leaf.to_dense())
        return leaf

    with torch.no_grad():
        return tree_map(visit, params)


def resparsify_params_(params, *, recompute_pattern: bool = False,
                       target_sparsity=None):
    """:func:`resparsify_params` in place: every sparse leaf keeps its
    tensors and gets the new values written into them; returns
    ``params``.  The fixed pattern is ``val *= mask`` for a
    ``FixedMaskTensor`` (``val * mask * mask`` of the returning form, the
    same bits); otherwise the new leaf is computed as the returning form
    does and copied in (an n:m / n:m:g re-gather zeroes the slots that
    pad K)."""
    with torch.no_grad():
        for leaf in tree_leaves(params):
            if isinstance(leaf, FixedMaskTensor):
                if not recompute_pattern:
                    leaf.val.mul_(leaf.mask)
                    continue
                new = resparsify_params(leaf, recompute_pattern=True,
                                        target_sparsity=target_sparsity)
                leaf.mask.copy_(new.mask)
                leaf.val.copy_(new.val)
            elif isinstance(leaf, NMTensor):
                new = resparsify_params(leaf,
                                        recompute_pattern=recompute_pattern)
                leaf.idx.copy_(new.idx)
                leaf.val.copy_(new.val)
            elif isinstance(leaf, GroupedNMTensor):
                new = resparsify_params(leaf,
                                        recompute_pattern=recompute_pattern)
                leaf.blk_idx.copy_(new.blk_idx)
                leaf.val.copy_(new.val)
                if leaf.plan is not None:
                    leaf.plan.cols.copy_(new.gather_plan().cols)
    return params


def sparse_aware_update(update_fn, grads, state, params, *,
                        grad_formats: Optional[dict] = None):
    """The gradients sparsified by ``grad_formats`` (the builder's
    ``grad_formats()``, paper §3.4 ``set_weight_grad``), then
    ``update_fn(grads, state, params)`` followed by fixed-pattern
    re-sparsification in place (``adamw_update`` writes in place too);
    pattern recomputes are the caller's (``launch/train.py:
    retarget_sparsity``)."""
    if grad_formats:
        grads = sparsify_grads(grads, grad_formats)
    new_params, new_state, metrics = update_fn(grads, state, params)
    return resparsify_params_(new_params), new_state, metrics
