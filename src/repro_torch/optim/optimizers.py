"""AdamW over params trees that may hold ``FixedMaskTensor`` leaves (port
of ``repro/optim/optimizers.py``).

Functions over nested dicts, run under ``torch.no_grad()``.  Moments are
f32 and mirror each trainable leaf: a floating tensor, or a layout's
value tensor (a ``FixedMaskTensor``'s or ``NMTensor``'s ``val``, a
``DenseTensor``'s ``data``; never a mask or an index table), as the
reference's moments mirror every inexact leaf; other leaves carry no
moments and pass through.  A gradients tree has the params tree's dicts
with one tensor (or None) per leaf — for a layout, the gradient of its
value tensor.

This is the reference's update, not ``torch.optim.AdamW``: decay is added
to the Adam direction before the learning rate (``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)``) in f32, only for tensors of at least
``decay_min_ndim`` dimensions, and the result is cast back to the
parameter's dtype with no master copy.

Deliberate difference from the reference (beside ROADMAP C2's): the
update writes the moments, the step counter and every trainable tensor
(a ``FixedMaskTensor``'s ``val``) **in place** and returns the same
objects, the port's counterpart of the reference's donated buffers.  A
captured training step (``launch/graphs.py``) replays on that storage,
so the step counter is a 0-dim int32 tensor on the parameters' device and
the bias corrections are computed there from it, never from a host int.
A caller that needs the initial params after an update clones them first.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.autograd import grad_values
from repro_torch.core.layouts import SparsityLayout

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "trainable", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # weight decay applies only to >=2-D tensors (not norms/biases/masks)
    decay_min_ndim: int = 2


def trainable(leaf):
    """The tensor an optimizer updates for ``leaf``, or None."""
    if isinstance(leaf, SparsityLayout):
        leaf = grad_values(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
        return leaf
    return None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (layouts are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> dict:
    """f32 zero moments for every trainable leaf (each laid out as its
    leaf: a DTensor's moments carry its placements, ZeRO-3's mirror of
    the params); the step counter a 0-dim int32 zero on the parameters'
    device."""
    def zeros(p):
        t = trainable(p)
        return None if t is None else torch.zeros_like(
            t, dtype=torch.float32, memory_format=torch.contiguous_format)

    devices = [t.device for t in map(trainable, tree_leaves(params))
               if t is not None]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=devices[0] if devices else "cpu")}


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global f32 norm); returns
    (clipped grads, norm).  Leaf sums are added in tree order."""
    leaves = [g for g in tree_leaves(grads) if g is not None]
    with torch.no_grad():
        gnorm, scale = _clip_scale(leaves, max_norm)
        clipped = tree_map(
            lambda g: None if g is None else g * scale.to(g.dtype), grads)
    return clipped, gnorm


def _clip_scale(leaves, max_norm: float) -> tuple:
    """(f32 global norm, clip scale) of gradient tensors, the leaf sums
    added in list order."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return gnorm, scale


def adamw_update(grads, state, params, cfg: AdamWConfig,
                 lr_scale: float | torch.Tensor = 1.0):
    """One AdamW step over every trainable leaf at once, in place; returns
    (params, state, {"gnorm"}) — the objects it was given.
    ``lr_scale`` (a float, or a 0-dim device tensor that a captured step
    reads at every replay) multiplies ``cfg.lr``.  Re-sparsification of
    layout leaves is the caller's (``optim/sparse_update.py``).

    Multi-tensor arithmetic (``torch._foreach_*``) in the per-leaf order
    of operations, one rounding each (no fused ``addcmul``/``addcdiv``),
    so every element equals the per-leaf expression's given the same
    gradient norm."""
    with torch.no_grad():
        quads = []
        tree_map(lambda p, g, mu, nu: quads.append((trainable(p), g, mu, nu)),
                 params, grads, state["mu"], state["nu"])
        quads = [q for q in quads if all(x is not None for x in q)]
        ts = [x[0] for x in quads]
        gnorm, scale = _clip_scale([x[1] for x in quads], cfg.grad_clip)
        gfs = [(g * scale.to(g.dtype)).float() for _, g, _, _ in quads]
        mus = [x[2] for x in quads]
        nus = [x[3] for x in quads]
        step = state["step"]
        step.add_(1)
        stepf = step.float()
        b1c = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32,
                                         device=step.device), stepf)
        b2c = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32,
                                         device=step.device), stepf)
        lr = cfg.lr * lr_scale
        # mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g**2
        torch._foreach_mul_(mus, cfg.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gfs, 1 - cfg.b1))
        sq = torch._foreach_mul(gfs, gfs)
        torch._foreach_mul_(sq, 1 - cfg.b2)
        torch._foreach_mul_(nus, cfg.b2)
        torch._foreach_add_(nus, sq)
        del sq, gfs
        # delta = (mu / b1c) / (sqrt(nu / b2c) + eps) [+ wd * p]
        den = torch._foreach_div(nus, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(mus, b1c)
        torch._foreach_div_(delta, den)
        del den
        tfs = [t.float() for t in ts]
        decay = [i for i, t in enumerate(ts) if t.ndim >= cfg.decay_min_ndim]
        if cfg.weight_decay and decay:
            torch._foreach_add_(
                [delta[i] for i in decay],
                torch._foreach_mul([tfs[i] for i in decay],
                                   cfg.weight_decay))
        # p = (p - lr * delta), cast back to the parameter's dtype
        torch._foreach_mul_(delta, lr)
        new = torch._foreach_sub(tfs, delta)
        if any(type(t) is not torch.Tensor for t in ts):
            # DTensor has no _foreach_copy_: one copy_ a leaf, same bits
            for t, n in zip(ts, new):
                t.copy_(n)
        else:
            torch._foreach_copy_(ts, new)
    return params, state, {"gnorm": gnorm}
