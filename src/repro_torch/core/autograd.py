"""Gradient plumbing for sparse layouts (port of
``repro/core/autograd.py``, paper §4.5 and §3.4's gradient formats).

Every layout's ``to_dense`` is built from differentiable torch ops, so
autograd carries a loss's gradient to the stored values (``val`` /
``data``) with no extension.  The port's gradient trees
(``launch/train.py:loss_and_grads``) hold one tensor per trainable leaf:
the gradient of its value tensor.  Independent gradient formats (a
weight whose gradient has its own sparsity, ``set_weight_grad``) are
applied where the gradient becomes a value, just before the optimizer
reads it: :func:`sparsify_grads`.

:func:`masked_grad` and :func:`straight_through` are the two conventions
for the gradient of pruned weights in masked training.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional

import torch

from repro_torch.core.builder import path_name
from repro_torch.core.dispatch import OutFormat
from repro_torch.core.layouts import FixedMaskTensor, SparsityLayout
from repro_torch.core.sparsifiers import KeepAll, apply_sparsifier

__all__ = ["grad_values", "with_values", "dense_grad_of", "sparsify_grads",
           "masked_grad", "straight_through"]


def _value_attr(layout) -> Optional[str]:
    for name in ("val", "data"):
        if isinstance(getattr(layout, name, None), torch.Tensor):
            return name
    return None


def grad_values(grad_leaf):
    """The value-carrying tensor of a gradient leaf (a layout's ``val`` or
    ``data``, or the tensor itself)."""
    if isinstance(grad_leaf, SparsityLayout):
        attr = _value_attr(grad_leaf)
        return None if attr is None else getattr(grad_leaf, attr)
    return grad_leaf


def with_values(layout, values: torch.Tensor):
    """``layout`` with its value tensor (``val`` / ``data``) replaced by
    ``values``; every other field (masks, index tables) shared.  A plain
    tensor is replaced by ``values`` itself."""
    if not isinstance(layout, SparsityLayout):
        return values
    return dataclasses.replace(layout, **{_value_attr(layout): values})


def dense_grad_of(primal, grad_leaf):
    """The dense-space gradient of ``primal`` from the gradient of its
    stored values (scattered to the primal's kept positions)."""
    if not isinstance(primal, SparsityLayout):
        return grad_leaf
    vals = grad_values(grad_leaf)
    if isinstance(primal, FixedMaskTensor):
        return vals * primal.mask.to(vals.dtype)
    return with_values(primal, vals).to_dense()


def _sparsified(g, fmt: OutFormat, generator):
    if isinstance(g, FixedMaskTensor) and g.mask is None:
        dense = g.val        # a cotangent whose val is the dense gradient
    elif isinstance(g, SparsityLayout):
        dense = g.to_dense()
    else:
        dense = g
    out = apply_sparsifier(fmt.external, dense, fmt.out_layout,
                           generator=generator)
    masked = out.to_dense() if isinstance(out, SparsityLayout) else out
    if isinstance(g, FixedMaskTensor):
        return FixedMaskTensor(masked, g.mask, g.origin)
    return masked


def sparsify_grads(grads, grad_formats: dict, generator=None):
    """Apply per-weight gradient output formats (``set_weight_grad``):
    every gradient whose name matches a pattern is re-sparsified with the
    format's external sparsifier.  A tensor stays a tensor (masked dense);
    a ``FixedMaskTensor`` gradient keeps its mask and origin."""
    if not grad_formats:
        return grads

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        if tree is None:
            return None
        name = path_name(path)
        for pattern, fmt in grad_formats.items():
            if fnmatch.fnmatch(name, pattern):
                if fmt is None or isinstance(fmt.external, KeepAll):
                    return tree
                return _sparsified(tree, fmt, generator)
        return tree

    return visit(grads, ())


def masked_grad(grad: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convention A: pruned weights receive no gradient."""
    return grad * mask.to(grad.dtype)


def straight_through(grad: torch.Tensor) -> torch.Tensor:
    """Convention B (straight-through): gradients reach pruned weights
    too, so they may re-enter the mask when it is recomputed."""
    return grad
