"""AdamW over params trees that may hold ``FixedMaskTensor`` leaves (port
of ``repro/optim/optimizers.py``).

Functions over nested dicts, run under ``torch.no_grad()``, returning new
trees as the reference does.  Moments are f32 and mirror each trainable
leaf: a floating tensor, or a ``FixedMaskTensor``'s ``val`` (never its
mask); other leaves carry no moments and pass through.  A gradients tree
has the params tree's dicts with one tensor (or None) per leaf — for a
``FixedMaskTensor``, the gradient of its ``val``.

This is the reference's update, not ``torch.optim.AdamW``: decay is added
to the Adam direction before the learning rate (``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)``) in f32, only for tensors of at least
``decay_min_ndim`` dimensions, and the result is cast back to the
parameter's dtype with no master copy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.layouts import FixedMaskTensor

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
    if isinstance(leaf, FixedMaskTensor):
        return leaf.val
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
    """f32 zero moments for every trainable leaf; step 0."""
    def zeros(p):
        t = trainable(p)
        return None if t is None else torch.zeros(
            t.shape, dtype=torch.float32, device=t.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global f32 norm); returns
    (clipped grads, norm).  Leaf sums are added in tree order."""
    leaves = [g for g in tree_leaves(grads) if g is not None]
    with torch.no_grad():
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        clipped = tree_map(
            lambda g: None if g is None else g * scale.to(g.dtype), grads)
    return clipped, gnorm


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """Returns (updated params, new state, {"gnorm"}).  Re-sparsification
    of layout leaves is the caller's (``optim/sparse_update.py``)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    stepf = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), stepf)

    def upd(p, g, mu, nu):
        t = trainable(p)
        if g is None or mu is None or t is None:
            return p, mu, nu
        gf = g.float()
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * gf
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * gf.square()
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        if cfg.weight_decay and t.ndim >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * t.float()
        t2 = (t.float() - cfg.lr * delta).to(t.dtype)
        if isinstance(p, FixedMaskTensor):
            t2 = FixedMaskTensor(t2, p.mask, p.origin)
        return t2, mu2, nu2

    with torch.no_grad():
        out = tree_map(lambda p, g, mu, nu: upd(p, g, mu, nu), params,
                       grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}, \
        {"gnorm": gnorm}
