"""The training comparison's reference: the first steps of masked AdamW
under a gradual-magnitude-pruning schedule, in plain PyTorch and f32
with TF32 off, from the seed's weights and batches.

Frozen copies of the schedule (Zhu and Gupta's cubic ramp, evaluated in
f32; a pattern recompute every ``recompute_every`` steps from
``begin_step`` and at ``end_step``), of global magnitude pruning (keep
``|x| >= `` the k-th largest, k = round(size * (1 - sparsity))), and of
the update: clip by the global norm, AdamW with decay added to the Adam
direction for tensors of two or more dimensions, the masked weights set
to zero again after the update.  A masked weight is ``val * mask`` in the
forward, so its gradient is masked.

Returns per step the loss, per leaf the norm of the first clipped
gradient, and per leaf the norm of the change of the parameters over
the steps (recompute included).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.reference import decoder

LAYER_KEYS = {"attn.wq": "wq", "attn.wk": "wk", "attn.wv": "wv",
              "attn.wo": "wo", "mlp.wi": "wi", "mlp.wo": "wo2",
              "ln1": "ln1", "ln2": "ln2"}


def gmp_sparsity(g: dict, step: int) -> float:
    if step <= g["begin_step"]:
        return 0.0
    if step >= g["end_step"]:
        return g["target_sparsity"]
    span = np.float32(max(1, g["end_step"] - g["begin_step"]))
    frac = (np.float32(step) - np.float32(g["begin_step"])) / span
    om = np.float32(1.0) - frac
    tgt = np.float32(g["target_sparsity"])
    return float(tgt * (np.float32(1.0) - om * om * om))


def recompute_at(g: dict, step: int) -> bool:
    if step < g["begin_step"] or step > g["end_step"]:
        return False
    if step == g["end_step"]:
        return True
    return (step - g["begin_step"]) % max(1, g["recompute_every"]) == 0


def magnitude_mask(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    flat = x.abs().reshape(-1)
    k = int(np.clip(np.round(np.float32(flat.numel())
                             * (np.float32(1.0) - np.float32(sparsity))),
                    1, flat.numel()))
    return x.abs() >= torch.topk(flat, k, sorted=False).values.min()


def loss_of(cfg: dict, p: dict, masks: dict, batch: dict, mm) -> torch.Tensor:
    def eff(leaf):
        return p[leaf] * masks[leaf] if leaf in masks else p[leaf]

    x = decoder.embed(cfg, p["embedding"], batch["tokens"])
    for layer in range(cfg["n_layers"]):
        w = {k: eff(leaf)[layer] for leaf, k in LAYER_KEYS.items()}
        x = decoder.layer(cfg, w, x, mm=mm)
    logits = decoder.logits(x, p["final_norm"], p["lm_head"], mm=mm)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long())


def run(cfg: dict, tcfg: dict, seed: int, batches: list, device,
        mm=decoder.plain_mm) -> dict:
    """``batches``: the steps' {"tokens", "labels"} [B, S] on ``device``,
    from step ``tcfg["step0"]`` on."""
    decoder.no_tf32()
    dt = getattr(torch, cfg["dtype"])
    p = {k: weights.draw_leaf(torch, cfg, seed, k, device, dt).float()
         for k in weights.LEAVES}
    p0 = {k: v.clone() for k, v in p.items()}
    opt, gmp = tcfg["adamw"], tcfg["gmp"]
    masks: dict = {}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        step = tcfg["step0"] + i
        if recompute_at(gmp, step):
            s = gmp_sparsity(gmp, step)
            for leaf in tcfg["masked"]:
                masks[leaf] = magnitude_mask(p[leaf], s).float()
                p[leaf] = p[leaf] * masks[leaf]
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_of(cfg, leaves, masks, batch, mm)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(opt["grad_clip"] / gnorm.clamp(min=1e-9),
                                max=1.0)
            g = {k: v * scale for k, v in grads.items()}
            if first_grad is None:
                first_grad = {k: float(v.norm()) for k, v in g.items()}
            b1c = 1.0 - opt["b1"] ** (i + 1)
            b2c = 1.0 - opt["b2"] ** (i + 1)
            for k in names:
                mu[k] = opt["b1"] * mu[k] + (1 - opt["b1"]) * g[k]
                nu[k] = opt["b2"] * nu[k] + (1 - opt["b2"]) * g[k] * g[k]
                delta = (mu[k] / b1c) / (torch.sqrt(nu[k] / b2c) + opt["eps"])
                if p[k].ndim >= 2:
                    delta = delta + opt["weight_decay"] * p[k]
                p[k] = p[k] - opt["lr"] * delta
                if k in masks:
                    p[k] = p[k] * masks[k]
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": {k: float((p[k] - p0[k]).norm()) for k in p}}

