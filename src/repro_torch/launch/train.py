"""Masked sparse training (port of ``repro/launch/train.py``): GMP
schedules drive the target sparsity, weights are ``FixedMaskTensor``s
re-sparsified by ``SameFormatSparsifier`` after each AdamW update, with
pattern recomputes on the schedule's cadence (paper Figs 8-9).

    python -m repro_torch.launch.train --arch bert-base-sten --steps 20 \\
        --sparsity 0.75 --gmp iterative            # on the card
    python -m repro_torch.launch.train --arch bert-base-sten --smoke \\
        --steps 6 --sparsity 0.5 --gmp iterative --device cpu \\
        --ckpt-dir DIR --ckpt-every 3 [--resume] [--host-loop]

Two loops over one step (forward, backward, clip, AdamW and the
fixed-pattern re-sparsification, all writing the params and the optimizer
state in place):

- the default, :func:`fast_loop` over :func:`make_multi_step`: the step
  is captured once as a CUDA graph (``launch/graphs.py:TrainGraph``) and
  replayed for every step of a chunk of up to ``--log-every`` steps; the
  chunk's batches go to the card in one copy, the GMP recompute runs
  eagerly and in place between two replays when the schedule says so (a
  host decision that needs no sync), and the losses and gradient norms
  reach the host once a chunk;
- ``--host-loop``, :func:`train_loop`: the same step run eagerly, one
  host sync per step (the reference's equivalence oracle).

The two give the same bits.  With ``ModelConfig.mlp_inline_threshold``
the MLP up-projection runs the fused ``matmul_threshold`` kernel (inside
the captured step), and an ``NMSparsifier`` origin builds and recomputes
its masks with the ``nm_mask`` kernel (the library API; the CLI prunes by
magnitude).  Checkpoints (``--ckpt-dir``, ``--ckpt-every``, ``--resume``)
are the reference's format; SIGTERM saves the steps completed and exits
1.  ``--tuning-table PATH`` routes through a table of ``python -m
repro_torch.tune``.  ``--trace PATH`` turns the ``repro_torch.obs`` flight
recorder on and writes a Chrome/Perfetto trace to PATH at the end:
``train_chunk`` spans (``train_step`` in the host loop), ``gmp_recompute``
events, and on the log cadence each mask's sparsity
(:func:`sparsity_telemetry`: registry gauges and ``sparsity`` events,
read only while the recorder is on, so a run without it syncs nothing
more).  ``--check`` runs the static checker's train entry
(``repro_torch.check.preflight``, after the tuning table is loaded) first
and exits 1 on an ERROR.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.autograd import with_values
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import FixedMaskTensor, SparsityLayout
from repro_torch.core.sparsifiers import ScalarFractionSparsifier
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import StragglerWatchdog
from repro_torch.launch.graphs import TrainGraph
from repro_torch.models import init_lm, loss_fn
from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY
from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init, \
    adamw_update, resparsify_params_, sparse_aware_update
from repro_torch.optim.optimizers import trainable, tree_map
from repro_torch.tune import load_table_cli
from repro_torch.tune.table import device_kind

__all__ = ["build_sparse_params", "retarget_sparsity", "loss_and_grads",
           "make_train_step", "make_multi_step", "stack_batches",
           "train_loop", "fast_loop", "ckpt_tree", "sparsity_telemetry",
           "parse_args", "run", "main"]


def build_sparse_params(params, sparsity: float, targets=("mlp", "attn.wo")):
    """Sparsify matching weights to ``FixedMaskTensor`` by magnitude
    pruning (per layer for stacked leaves)."""
    sb = SparsityBuilder()
    for t in targets:
        sb.set_weight(f"*{t}*", ScalarFractionSparsifier(sparsity),
                      FixedMaskTensor)
    return sb.sparsify_params(params)


def retarget_sparsity(params, sparsity: float):
    """Recompute every pattern in place: magnitude-pruned leaves at the
    new global ``sparsity`` (over the whole stacked leaf), every other
    origin by its native sparsifier.  The leaves keep their tensors (what
    a captured step reads); returns ``params``."""
    return resparsify_params_(params, recompute_pattern=True,
                              target_sparsity=float(sparsity))


def _batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params, cfg, batch, **loss_kw):
    """(loss, aux, grads): one forward and backward (``loss_kw`` to
    ``loss_fn``: ``remat``, ``aux_weight``).  ``grads`` mirrors
    ``params`` with one tensor per trainable leaf (a layout's is the
    gradient of its value tensor: a ``FixedMaskTensor``'s ``val``, masked
    by the product) and None elsewhere."""
    leaves = []

    def with_grad(p):
        t = trainable(p)
        if t is None:
            return p
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return with_values(p, t)

    loss, aux = loss_fn(tree_map(with_grad, params), cfg, batch, **loss_kw)
    # a leaf the loss does not reach (a pure SSM layer's ln2) gets zeros,
    # as the reference's jax.grad gives it
    it = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True))
    grads = tree_map(lambda p: None if trainable(p) is None else next(it),
                     params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg, opt_cfg: AdamWConfig):
    """One step: forward and backward, AdamW, fixed-pattern
    re-sparsification, all in place.  Returns ``train_step(params,
    opt_state, batch) -> (params, opt_state, {"loss", "gnorm"})``, the
    trees it was given, updated."""

    def train_step(params, opt_state, batch):
        loss, _, grads = loss_and_grads(params, cfg, batch)
        params, opt_state, m = sparse_aware_update(
            lambda g, s, p: adamw_update(g, s, p, opt_cfg), grads,
            opt_state, params)
        return params, opt_state, {"loss": loss, "gnorm": m["gnorm"]}

    return train_step


class MultiStep:
    """``multi_step(params, opt_state, batches, step0, stop) -> (params,
    opt_state, {"loss", "gnorm"})``: the steps ``step0 .. step0 + n - 1``
    for ``batches`` of [n, ...] tensors (host or device, n at most
    ``n_inner``), the loss and gradient norm of each in a device [n]
    tensor.  Before step ``s`` it recomputes the patterns in place when
    ``gmp.recompute_at(s)`` and ``s < stop``, as the host loop does.  The
    reference recomputes at the end of step ``s - 1`` inside its scan and
    leaves the run's first step to its caller; here the decision is the
    host's, before the replay, so the first step of a run needs nothing
    from the caller, and no step ``stop`` is ever prepared.

    The first call builds a :class:`TrainGraph` on the trees it is given
    and every later call replays it; a call with other trees (a restored
    checkpoint) builds a new one."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, gmp, n_inner: int):
        self.step_fn = make_train_step(cfg, opt_cfg)
        self.gmp = gmp
        self.n_inner = n_inner
        self.graph = None

    def recomputes(self, step0: int, n: int, stop: int) -> list:
        """The steps of [step0, step0 + n) that recompute the patterns."""
        gmp = self.gmp
        return [] if gmp is None else [
            s for s in range(step0, step0 + n)
            if gmp.recompute_at(s) and s < stop]

    def __call__(self, params, opt_state, batches: dict, step0: int,
                 stop: int):
        n = len(next(iter(batches.values())))
        if n > self.n_inner:
            raise ValueError(f"{n} steps in a chunk of at most "
                             f"{self.n_inner}")
        dev = opt_state["step"].device
        batches = {k: torch.as_tensor(v).to(dev) for k, v in batches.items()}
        if self.graph is None or not self.graph.holds(params, opt_state):
            self.graph = None        # frees the old graph's pool first
            self.graph = TrainGraph(
                self.step_fn, params, opt_state,
                {k: v[0] for k, v in batches.items()})
        todo = set(self.recomputes(step0, n, stop))
        out = torch.empty((2, n), dtype=torch.float32, device=dev)
        for i in range(n):
            s = step0 + i
            if s in todo:
                retarget_sparsity(params, self.gmp.sparsity_at(s))
            out[:, i].copy_(self.graph.run({k: v[i]
                                            for k, v in batches.items()}))
        return params, opt_state, {"loss": out[0], "gnorm": out[1]}


def make_multi_step(cfg, opt_cfg: AdamWConfig, gmp,
                    n_inner: int) -> MultiStep:
    """The device-resident trainer: up to ``n_inner`` steps a call (see
    :class:`MultiStep`), one CUDA graph of the step for every chunk length
    on the card, the same steps eagerly on the CPU."""
    return MultiStep(cfg, opt_cfg, gmp, n_inner)


def stack_batches(data, lo: int, hi: int) -> dict:
    """The index-addressed batches of steps [lo, hi), stacked on the host
    as [hi - lo, ...] tensors."""
    per_step = [data.batch_at(s) for s in range(lo, hi)]
    return {k: torch.from_numpy(np.stack([np.asarray(b[k])
                                          for b in per_step]))
            for k in per_step[0]}


def _log_line(step, loss, gnorm, dt):
    print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
          f"({dt:.2f}s/step)", flush=True)


def sparsity_telemetry(params, step: int) -> None:
    """Per-layer sparsity on the log cadence (the reference's
    ``_sparsity_telemetry``), only while the flight recorder is on: it
    reads every mask's mean to the host.  Each ``FixedMaskTensor`` leaf
    becomes a registry gauge and one ``sparsity`` event on the train
    track; a leaf stacked across layers reports per-layer means."""
    if not obs.enabled():
        return

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):     # the reference's leaf order
                walk(tree[k], path + [k])
        elif isinstance(tree, FixedMaskTensor):
            name = "/".join(path)
            mask = tree.mask
            if mask.ndim >= 3:  # stacked layers: per-layer mean
                per_layer = (1.0 - mask.reshape(mask.shape[0], -1).float()
                             .mean(dim=1)).cpu().numpy()
                for i, v in enumerate(per_layer):
                    REGISTRY.gauge(f"train_sparsity/{name}/layer{i}").set(
                        float(v))
                obs.event("sparsity", "train", step=step, weight=name,
                          mean=round(float(per_layer.mean()), 4),
                          per_layer=[round(float(v), 4) for v in per_layer])
            else:
                v = 1.0 - float(mask.float().mean())
                REGISTRY.gauge(f"train_sparsity/{name}").set(v)
                obs.event("sparsity", "train", step=step, weight=name,
                          sparsity=round(v, 4))

    walk(params, [])


def ckpt_tree(params, opt_state) -> dict:
    """``{"params", "opt"}`` in the reference's checkpoint structure: the
    moments of a layout leaf as a one-tuple (the reference's moment
    mirrors the layout with its inexact leaf alone, e.g.
    ``FixedMaskTensor(moment, None)``, whose one leaf is named ``.0``:
    every layout's value tensor is its first child)."""
    def like(p, m):
        return (m,) if isinstance(p, SparsityLayout) else m

    return {"params": params, "opt": {
        "mu": tree_map(like, params, opt_state["mu"]),
        "nu": tree_map(like, params, opt_state["nu"]),
        "step": opt_state["step"]}}


def _from_ckpt_tree(tree) -> tuple:
    """(params, opt_state) of a :func:`ckpt_tree` structure."""
    def unwrap(m):
        return m[0] if isinstance(m, tuple) else m

    opt = tree["opt"]
    return tree["params"], {"mu": tree_map(unwrap, opt["mu"]),
                            "nu": tree_map(unwrap, opt["nu"]),
                            "step": opt["step"]}


def _result(params, opt_state, step, interrupted, **lists) -> dict:
    return {"params": params, "opt_state": opt_state, "step": step,
            "interrupted": bool(interrupted), **lists}


def train_loop(params, opt_state, train_step, data, *, start: int,
               stop: int, device, gmp=None, log_every: int = 10, mgr=None,
               ckpt_every: int = 50, interrupted=(), watchdog=None) -> dict:
    """Steps [start, stop) of the host loop, eager, one host sync a step.
    Saves a checkpoint (async) after every ``ckpt_every``-th step and
    stops after the step in which ``interrupted`` became true.  Returns
    {"params", "opt_state", "step" (steps completed), "interrupted",
    "losses", "gnorms", "step_s", "recomputes"}; a step's time ends when
    its loss reaches the host."""
    losses, gnorms, step_s, recomputes = [], [], [], []
    step = start
    while step < stop:
        t0 = time.perf_counter()
        batch = _batch_on(data.batch_at(step), device)
        if gmp is not None and gmp.recompute_at(step):
            obs.event("gmp_recompute", "train", step=step,
                      target=gmp.sparsity_at(step), in_graph=False)
            retarget_sparsity(params, gmp.sparsity_at(step))
            recomputes.append(step)
        with obs.span("train_step", "train", step=step):
            params, opt_state, m = train_step(params, opt_state, batch)
            losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        step_s.append(time.perf_counter() - t0)
        if watchdog is not None:
            watchdog.observe(0, step_s[-1])
        if step % log_every == 0 or step == stop - 1:
            sparsity_telemetry(params, step)
            _log_line(step, losses[-1], gnorms[-1], step_s[-1])
        step += 1
        if mgr is not None and step % ckpt_every == 0:
            mgr.save(step, ckpt_tree(params, opt_state))
        if interrupted:
            break
    return _result(params, opt_state, step, interrupted, losses=losses,
                   gnorms=gnorms, step_s=step_s, recomputes=recomputes)


def fast_loop(params, opt_state, multi_step: MultiStep, data, *,
              start: int, stop: int, log_every: int = 10, mgr=None,
              ckpt_every: int = 50, interrupted=(), watchdog=None) -> dict:
    """Steps [start, stop) in chunks of ``multi_step``: a chunk ends at
    ``min(stop, next checkpoint, step + log_every)``, and its losses and
    gradient norms reach the host once, at its end.  Checkpoints and
    interruption as in :func:`train_loop`, at chunk ends.  Returns what
    :func:`train_loop` returns; ``step_s`` holds each step's share of its
    chunk's wall time."""
    losses, gnorms, step_s, recomputes = [], [], [], []
    step = start
    while step < stop:
        next_ckpt = (step // ckpt_every + 1) * ckpt_every \
            if mgr is not None else stop
        end = min(stop, next_ckpt, step + log_every)
        n = end - step
        t0 = time.perf_counter()
        with obs.span("train_chunk", "train", step0=step, steps=n):
            params, opt_state, m = multi_step(
                params, opt_state, stack_batches(data, step, end), step,
                stop)
            # the chunk's one host sync
            host = torch.stack((m["loss"], m["gnorm"])).cpu().numpy()
        dt = (time.perf_counter() - t0) / n
        chunk_recomputes = multi_step.recomputes(step, n, stop)
        if obs.enabled():
            # the recomputes the chunk ran between its replays
            for s in chunk_recomputes:
                obs.event("gmp_recompute", "train", step=s,
                          target=multi_step.gmp.sparsity_at(s),
                          in_graph=False)
        sparsity_telemetry(params, end)
        recomputes += chunk_recomputes
        losses += host[0].tolist()
        gnorms += host[1].tolist()
        step_s += [dt] * n
        if watchdog is not None:
            watchdog.observe(0, dt)
        for s in range(step, end):
            if s % log_every == 0 or s == stop - 1:
                _log_line(s, losses[s - start], gnorms[s - start], dt)
        step = end
        if mgr is not None and step % ckpt_every == 0:
            mgr.save(step, ckpt_tree(params, opt_state))
        if interrupted:
            break
    return _result(params, opt_state, step, interrupted, losses=losses,
                   gnorms=gnorms, step_s=step_s, recomputes=recomputes)


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
    ap.add_argument("--host-loop", action="store_true",
                    help="per-step host-driven loop (eager, one host sync "
                         "a step) instead of the replayed CUDA graph")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--tuning-table", default=None, metavar="PATH",
                    help="load a tuning table (written by `python -m "
                         "repro_torch.tune`) so kernel routing uses its "
                         "measured decisions; $REPRO_TUNE_TABLE otherwise")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the repro_torch.obs flight recorder and "
                         "write a Chrome/Perfetto trace (train chunks, GMP "
                         "recomputes, per-layer sparsity, kernel routes) "
                         "to PATH at the end")
    ap.add_argument("--check", action="store_true",
                    help="run the repro_torch.check static verifier over "
                         "the train entry before the first step; abort on "
                         "ERROR diagnostics")
    args = ap.parse_args(argv)
    # the fast path chunks by --log-every: a non-positive value would spin
    # on zero-step chunks
    args.log_every = max(1, args.log_every)
    args.ckpt_every = max(1, args.ckpt_every)
    return args


def run(args) -> dict:
    """Build the model, its masks and the schedule from ``args``, restore
    the newest checkpoint with ``--resume``, train to ``--steps`` and make
    the final (or, after SIGTERM, the interrupted) blocking checkpoint.
    Returns the loop's result plus "rc" (0, or 1 after SIGTERM),
    "start_step", "cfg", "gmp" and "trainer" (the :class:`MultiStep`, or
    None for the host loop); with ``--check`` failing, ``{"rc": 1}``
    alone, before anything is built."""
    dev = resolve_device(args.device)
    # --tuning-table or $REPRO_TUNE_TABLE, before any model is built
    load_table_cli(args.tuning_table, device=device_kind(dev))
    if args.check:
        # after the table load on purpose: R6 must judge the routed
        # configs of the table the run is about to train under
        from repro_torch.check import preflight

        rc = preflight(("train",), arch=args.arch, device=dev)
        if rc:
            print("repro_torch.check: train preflight failed — not training")
            return {"rc": rc}
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
    opt_state = adamw_init(params)
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and args.resume:
        got, tree, _ = mgr.restore_latest(ckpt_tree(params, opt_state))
        if got is not None:
            start = got
            params, opt_state = _from_ckpt_tree(tree)
            print(f"resumed from step {start}")

    interrupted = []
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:        # signal handlers can only be set there
        prev = signal.signal(signal.SIGTERM,
                             lambda *a: interrupted.append(1))
    loop_kw = dict(start=start, stop=args.steps, log_every=args.log_every,
                   mgr=mgr, ckpt_every=args.ckpt_every,
                   interrupted=interrupted,
                   watchdog=StragglerWatchdog(n_hosts=1))
    multi = None
    if args.trace:
        obs.enable()
    try:
        if args.host_loop:
            out = train_loop(params, opt_state,
                             make_train_step(cfg, opt_cfg), data,
                             device=dev, gmp=gmp, **loop_kw)
        else:
            multi = make_multi_step(cfg, opt_cfg, gmp, args.log_every)
            out = fast_loop(params, opt_state, multi, data, **loop_kw)
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
        if args.trace:
            obs.disable()      # the records stay readable for the dump
    rc = 0
    if out["interrupted"]:
        print("SIGTERM: checkpointing and exiting")
        rc = 1
    if mgr is not None:
        mgr.save(out["step"] if rc else args.steps,
                 ckpt_tree(out["params"], out["opt_state"]), blocking=True)
    if args.trace:
        obs.dump(args.trace, registry_snapshot=REGISTRY.snapshot())
        print(f"wrote trace to {args.trace}")
    return {**out, "rc": rc, "start_step": start, "cfg": cfg, "gmp": gmp,
            "trainer": multi}


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    out = run(args)
    if out["rc"] == 0:
        final = f"; final loss {out['losses'][-1]:.4f}" \
            if out["losses"] else ""
        print(f"done: {args.steps - out['start_step']} steps in "
              f"{time.perf_counter() - t0:.1f}s{final}")
    return out["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
