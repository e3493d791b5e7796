"""Masked sparse training (port of ``repro/launch/train.py``): GMP
schedules drive the target sparsity, weights are ``FixedMaskTensor``s
re-sparsified by ``SameFormatSparsifier`` after each AdamW update, with
pattern recomputes on the schedule's cadence (paper Figs 8-9).

    python -m repro_torch.launch.train --arch bert-base-sten --steps 20 \\
        --sparsity 0.75 --gmp iterative            # on the card
    python -m repro_torch.launch.train --arch bert-base-sten --smoke \\
        --steps 6 --sparsity 0.5 --gmp iterative --device cpu

The loop is the reference's host loop (``--host-loop``), eager: before
step ``s`` it retargets the pattern when ``recompute_at(s)``, then runs
one forward, backward and update; the reference pins its ``lax.scan``
fast path bitwise to that loop.  With ``ModelConfig.mlp_inline_threshold``
the MLP up-projection runs the fused ``matmul_threshold`` kernel, and an
``NMSparsifier`` origin builds and recomputes its masks with the
``nm_mask`` kernel (the library API; the CLI prunes by magnitude).
Checkpoints (``--ckpt-dir``/``--resume``), ``--tuning-table``, ``--check``
and ``--trace`` are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.core.sparsifiers import ScalarFractionSparsifier
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_lm, loss_fn
from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init, \
    adamw_update, resparsify_params, sparse_aware_update
from repro_torch.optim.optimizers import trainable, tree_map

__all__ = ["build_sparse_params", "retarget_sparsity", "loss_and_grads",
           "make_train_step", "train_loop", "parse_args", "run", "main"]


def build_sparse_params(params, sparsity: float, targets=("mlp", "attn.wo")):
    """Sparsify matching weights to ``FixedMaskTensor`` by magnitude
    pruning (per layer for stacked leaves)."""
    sb = SparsityBuilder()
    for t in targets:
        sb.set_weight(f"*{t}*", ScalarFractionSparsifier(sparsity),
                      FixedMaskTensor)
    return sb.sparsify_params(params)


def retarget_sparsity(params, sparsity: float):
    """Recompute every pattern: magnitude-pruned leaves at the new global
    ``sparsity`` (over the whole stacked leaf), every other origin by its
    native sparsifier."""
    return resparsify_params(params, recompute_pattern=True,
                             target_sparsity=float(sparsity))


def _batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params, cfg, batch):
    """(loss, aux, grads): one forward and backward.  ``grads`` mirrors
    ``params`` with one tensor per trainable leaf (a ``FixedMaskTensor``'s
    is the gradient of its ``val``, masked by the product) and None
    elsewhere."""
    leaves = []

    def with_grad(p):
        t = trainable(p)
        if t is None:
            return p
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return FixedMaskTensor(t, p.mask, p.origin) \
            if isinstance(p, FixedMaskTensor) else t

    loss, aux = loss_fn(tree_map(with_grad, params), cfg, batch)
    it = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda p: None if trainable(p) is None else next(it),
                     params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg, opt_cfg: AdamWConfig):
    """One step: forward and backward, AdamW, fixed-pattern
    re-sparsification.  Returns ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "gnorm"})``."""

    def train_step(params, opt_state, batch):
        loss, _, grads = loss_and_grads(params, cfg, batch)
        new_p, new_s, m = sparse_aware_update(
            lambda g, s, p: adamw_update(g, s, p, opt_cfg), grads,
            opt_state, params)
        return new_p, new_s, {"loss": loss, "gnorm": m["gnorm"]}

    return train_step


def _log_line(step, loss, gnorm, dt):
    print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
          f"({dt:.2f}s/step)", flush=True)


def train_loop(params, opt_state, train_step, data, *, start: int,
               stop: int, device, gmp=None, log_every: int = 10) -> dict:
    """Steps [start, stop) of the host loop.  Returns {"params",
    "opt_state", "losses", "gnorms", "step_s", "recomputes"}; a step's
    time ends when its loss reaches the host."""
    losses, gnorms, step_s, recomputes = [], [], [], []
    for step in range(start, stop):
        t0 = time.perf_counter()
        batch = _batch_on(data.batch_at(step), device)
        if gmp is not None and gmp.recompute_at(step):
            params = retarget_sparsity(params, gmp.sparsity_at(step))
            recomputes.append(step)
        params, opt_state, m = train_step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        step_s.append(time.perf_counter() - t0)
        if step % log_every == 0 or step == stop - 1:
            _log_line(step, losses[-1], gnorms[-1], step_s[-1])
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "gnorms": gnorms, "step_s": step_s, "recomputes": recomputes}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="bert-base-sten")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--gmp", choices=["one_shot", "iterative", "layer_wise"],
                    default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    args.log_every = max(1, args.log_every)
    return args


def run(args) -> dict:
    """Build the model, its masks and the schedule from ``args`` and
    train; returns :func:`train_loop`'s result plus "cfg" and "gmp"."""
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_lm(cfg, seed=args.seed, device=dev)
    gmp = None
    if args.gmp or args.sparsity > 0:
        mode = args.gmp or "one_shot"
        gmp = GMPSchedule(
            mode=mode, target_sparsity=args.sparsity or 0.5,
            begin_step=0 if mode == "one_shot" else args.steps // 10,
            end_step=int(args.steps * 0.8),
            recompute_every=max(1, args.steps // 20),
            num_layers=cfg.n_layers)
        params = build_sparse_params(params, gmp.sparsity_at(0))
    opt_cfg = AdamWConfig(lr=args.lr)
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    out = train_loop(params, adamw_init(params), make_train_step(cfg, opt_cfg),
                     data, start=0, stop=args.steps, device=dev, gmp=gmp,
                     log_every=args.log_every)
    return {**out, "cfg": cfg, "gmp": gmp}


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    out = run(args)
    final = f"; final loss {out['losses'][-1]:.4f}" if out["losses"] else ""
    print(f"done: {args.steps} steps in {time.perf_counter() - t0:.1f}s"
          f"{final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
