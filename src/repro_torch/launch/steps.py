"""Step functions (train / prefill / decode) and their sharding assembly
(port of ``repro/launch/steps.py``) over DTensor.

Each step runs its body under ``use_rules(mesh, rules)``, so every
``logical_constraint`` of the model resolves against the mesh, and under
``torch.distributed.tensor.experimental.implicit_replication()``: the
plain tensors a step makes or holds beside its DTensors (the AdamW step
counter and its bias corrections, positions, masks built by ``arange``)
count as replicated on every rank, which each rank's copy of them is.
That is the port's choice of scalar replication (ROADMAP C2), in place of
making every scalar a replicated DTensor.

Params are distributed by ``dist/sharding.py:distribute_params`` (the
reference's ``jax.device_put`` over ``tree_shardings``); the moments that
``adamw_init`` makes of DTensor params carry their placements (ZeRO-3,
``opt_specs``); a decode cache is distributed by :func:`cache_specs`
(batch over the data axes, sequence over "model") and written by the rank
that owns each row (``models/transformer.py:_owner_put_``).

DTensor API relied on (torch 2.11 and 2.13): ``distribute_tensor(...,
src_data_rank=None)``, ``DTensor.{redistribute, full_tensor,
placements}``, ``implicit_replication``.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.core.layouts import FixedMaskTensor, SparsityLayout
from repro_torch.dist.sharding import P, ShardingRules, batch_spec, \
    divisible as _divisible, is_dtensor, mesh_axes, placements_of, use_rules
from repro_torch.launch.train import loss_and_grads
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import _seq_leaf_kinds, _write_leaf, \
    decode_step, forward, init_cache, logits_of, map_cache
from repro_torch.optim import AdamWConfig, adamw_update, resparsify_params, \
    resparsify_params_
from repro_torch.optim.optimizers import trainable, tree_leaves, tree_map

__all__ = ["StepConfig", "make_train_step", "make_prefill_step",
           "make_decode_step", "cache_specs", "opt_specs", "batch_specs",
           "shard_batch", "shard_cache"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    remat: str = "full"            # none | full
    aux_weight: float = 0.01
    kv_cache_dtype: Optional[str] = None  # e.g. "int8" (hillclimb knob)
    grad_formats: Optional[dict] = None
    recompute_pattern: bool = False


@contextmanager
def _sharded(mesh, rules: ShardingRules):
    from torch.distributed.tensor.experimental import implicit_replication

    with use_rules(mesh, rules), implicit_replication():
        yield


def _scalar(x):
    """A replicated 0-dim metric as a plain tensor."""
    return x.full_tensor() if is_dtensor(x) else x


def _recompute_(params) -> None:
    """Every ``FixedMaskTensor``'s pattern recomputed in place by its
    origin's rule over the whole leaf (a magnitude recompute's threshold
    is global, ROADMAP C6): over ``full_tensor()`` of a sharded leaf, the
    new mask and values written back into each rank's shard."""
    from torch.distributed.tensor import distribute_tensor

    with torch.no_grad():
        for leaf in tree_leaves(params):
            if not isinstance(leaf, FixedMaskTensor):
                continue
            if not is_dtensor(leaf.val):
                resparsify_params_(leaf, recompute_pattern=True)
                continue
            whole = FixedMaskTensor(leaf.val.full_tensor(),
                                    leaf.mask.full_tensor(), leaf.origin)
            new = resparsify_params(whole, recompute_pattern=True)
            for dst, src in ((leaf.mask, new.mask), (leaf.val, new.val)):
                dst.copy_(distribute_tensor(src, dst.device_mesh,
                                            dst.placements,
                                            src_data_rank=None))


def _sparsify_grads(grads, grad_formats: dict):
    """The builder's gradient formats over whole gradients: a format's
    sparsifier ranks over the whole tensor (a magnitude fraction's
    threshold is global), so a sharded gradient is gathered first and
    each rank keeps its shard of the result."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.autograd import sparsify_grads

    whole = tree_map(lambda g: g.full_tensor() if is_dtensor(g) else g,
                     grads)
    return tree_map(lambda o, g: distribute_tensor(
        o, g.device_mesh, g.placements, src_data_rank=None)
        if is_dtensor(g) else o, sparsify_grads(whole, grad_formats), grads)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, step_cfg: StepConfig,
                    mesh, rules: ShardingRules):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the port's own step (``launch/train.py``: forward and
    backward, ``adamw_update``, fixed-pattern re-sparsification, all in
    place) over distributed params, ZeRO-3 moments and a batch-sharded
    batch.  Each gradient is laid out as its param before the update.
    The builder's ``grad_formats`` sparsify the gradients first (over
    whole gradients); with ``recompute_pattern`` every pattern is
    recomputed after the update.  Metrics: loss, ce, moe_aux, gnorm —
    plain 0-dim tensors."""

    def train_step(params, opt_state, batch):
        with _sharded(mesh, rules):
            loss, aux, grads = loss_and_grads(
                params, cfg, batch, remat=step_cfg.remat,
                aux_weight=step_cfg.aux_weight)
            grads = tree_map(_like_param, grads, params)
            if step_cfg.grad_formats:
                grads = _sparsify_grads(grads, step_cfg.grad_formats)
            params, opt_state, m = adamw_update(grads, opt_state, params,
                                                opt)
            if step_cfg.recompute_pattern:
                _recompute_(params)
            else:
                resparsify_params_(params)
        metrics = {"loss": _scalar(loss), "ce": _scalar(aux["ce"]),
                   "moe_aux": _scalar(aux["moe_aux"]),
                   "gnorm": _scalar(m["gnorm"])}
        return params, opt_state, metrics

    return train_step


def _like_param(g, p):
    """The gradient ``g`` laid out as the trainable tensor of ``p``."""
    t = trainable(p)
    if g is None or not is_dtensor(t) or not is_dtensor(g):
        return g
    if tuple(g.placements) == tuple(t.placements):
        return g
    return g.redistribute(t.device_mesh, t.placements)


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig, mesh,
                      rules: ShardingRules, cache_len: int):
    """The prefill step ``(params, batch) -> (last-position logits [B, V],
    decode cache)``: the parallel forward collecting every layer's cache
    contribution, written into a fresh ``cache_len`` cache laid out by
    :func:`cache_specs` (each rank writes the rows it owns).  ``batch``:
    ``tokens`` [B, S], optional ``enc_embeds`` / ``prefix_embeds``."""
    if step_cfg.kv_cache_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=step_cfg.kv_cache_dtype)

    def prefill_step(params, batch):
        tokens, enc = batch["tokens"], batch.get("enc_embeds")
        with _sharded(mesh, rules):
            hidden, contribs = forward(
                params, cfg, tokens, prefix_embeds=batch.get("prefix_embeds"),
                enc_embeds=enc, collect_cache=True)
            logits = logits_of(params, cfg, hidden[:, -1:])[:, 0]
            enc_len = enc.shape[1] if cfg.n_enc_layers > 0 else 0
            dev = (tokens.to_local() if is_dtensor(tokens) else tokens).device
            cache = shard_cache(init_cache(cfg, tokens.shape[0], cache_len,
                                           enc_len=enc_len, device=dev),
                                mesh, rules)
            map_cache(_write_leaf, cache, contribs,
                      _seq_leaf_kinds(cfg, enc_len))
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig, mesh,
                     rules: ShardingRules):
    """The one-token decode step ``(params, cache, token, pos) -> (logits
    [B, V], cache)``; the cache (from the prefill step, laid out by
    :func:`cache_specs`) is updated in place, each rank writing the rows
    it owns."""
    if step_cfg.kv_cache_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=step_cfg.kv_cache_dtype)

    def decode(params, cache, token, pos):
        with _sharded(mesh, rules):
            logits, cache = decode_step(params, cfg, token, cache, pos)
        return logits, cache

    return decode


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------


def opt_specs(p_specs):
    """Optimizer-state specs mirror the param specs (ZeRO-3); the step
    counter is replicated.  The port's moments mirror each trainable
    tensor (a ``FixedMaskTensor``'s ``val``), so a layout's entry is its
    value child's spec; leaves without moments are None."""
    def moment(s):
        if isinstance(s, SparsityLayout):     # the value child's spec
            s = next((getattr(s, a) for a in ("val", "data")
                      if isinstance(getattr(s, a, None), P)), None)
        return s if isinstance(s, P) else None

    return {"mu": tree_map(moment, p_specs), "nu": tree_map(moment, p_specs),
            "step": P()}


def cache_specs(cache_shapes, mesh, rules: ShardingRules):
    """Decode-cache specs: batch over the data-parallel axes, the sequence
    over the tensor-parallel ("heads") axes when divisible — a
    sequence-sharded KV cache.  SSM state leaves (no sequence axis) shard
    their widest trailing divisible dim over "heads"."""
    avail = mesh_axes(mesh)
    dp = rules.resolve("batch", avail)
    tp = rules.resolve("heads", avail)

    def visit(path, leaf):
        dims = [None] * leaf.ndim
        name = "/".join(path)
        if leaf.ndim >= 3:
            if _divisible(leaf.shape[1], mesh, dp):
                dims[1] = dp
            if "conv" in name or "ssm" in name:
                for ax in range(leaf.ndim - 1, 1, -1):
                    if _divisible(leaf.shape[ax], mesh, tp):
                        dims[ax] = tp
                        break
            elif _divisible(leaf.shape[2], mesh, tp):
                dims[2] = tp  # sequence axis
        return P(*dims)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return visit(path, tree)

    return walk(cache_shapes)


def batch_specs(specs: dict, mesh, rules: ShardingRules):
    """Input-batch specs: dim 0 of every entry over the data-parallel
    axes when divisible."""
    return {k: batch_spec(v, rules, mesh) for k, v in specs.items()}


def shard_batch(batch: dict, mesh, rules: ShardingRules) -> dict:
    """Every entry of ``batch`` (the same on every rank) distributed by
    :func:`batch_specs` (each rank keeps its slice; no communication)."""
    from torch.distributed.tensor import distribute_tensor

    specs = batch_specs(batch, mesh, rules)
    return {k: distribute_tensor(v, mesh, placements_of(specs[k], mesh),
                                 src_data_rank=None)
            for k, v in batch.items()}


def shard_cache(cache, mesh, rules: ShardingRules):
    """A decode cache (the same on every rank, zeros from ``init_cache``)
    distributed by :func:`cache_specs`."""
    from torch.distributed.tensor import distribute_tensor

    specs = cache_specs(cache, mesh, rules)
    return map_cache(lambda t, s: distribute_tensor(
        t, mesh, placements_of(s, mesh), src_data_rank=None), cache, specs)
