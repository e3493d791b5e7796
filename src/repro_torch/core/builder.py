"""SparsityBuilder: sparsifying an existing model (port of
``repro/core/builder.py``, paper §3.4, §4.1).

Weights: params are nested dicts; a leaf's name is its ``a.b.c``-joined
key path and rules match it with fnmatch globs.  A rule's output format
defaults to ``FixedMaskTensor`` (masked training), for every sparsifier.
A stacked [L, ...] leaf is sparsified per layer (the paper's local
pruning) and re-stacked.

Intermediates: the model calls ``tag("mlp.act", x)`` at its taggable
sites.  A :class:`SparsityPlan` made active (a context manager on a
thread-local) decides whether a site sparsifies, with which (inline,
tmp, external, out) format; with no plan active ``tag`` returns its input
object itself.  :func:`trace_intermediates` lists the sites a function
reaches (name, shape, dtype), each once in first-seen order: the
reference traces one ``lax.scan`` body where the port loops over layers.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import threading
from typing import Callable, Optional

import torch

from repro_torch.core.dispatch import OutFormat
from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, SparsityLayout
from repro_torch.core.sparsifiers import KeepAll, Sparsifier, \
    apply_sparsifier

__all__ = ["SparsityBuilder", "SparsityPlan", "WeightRule", "IntermRule",
           "tag", "tag_layout", "trace_intermediates", "path_name",
           "flatten_with_names"]

_ACTIVE = threading.local()


def path_name(path) -> str:
    """Join a key path into an 'a.b.c' name."""
    return ".".join(str(p) for p in path)


def flatten_with_names(tree, path=()) -> list:
    """[(name, leaf), ...] of a params tree (layouts are leaves)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flatten_with_names(v, path + (k,))]
    return [(path_name(path), tree)]


@dataclasses.dataclass
class WeightRule:
    pattern: str
    initial_sparsifier: Sparsifier
    out_format: type
    grad_fmt: Optional[OutFormat] = None


@dataclasses.dataclass
class IntermRule:
    pattern: str
    fmt: OutFormat
    grad_fmt: Optional[OutFormat] = None


@dataclasses.dataclass
class SparsityPlan:
    """The plan ``tag`` consults; active inside ``with plan:``."""

    weight_rules: list
    interm_rules: list
    recording: Optional[list] = None   # set by trace_intermediates

    def interm_rule_for(self, name: str) -> Optional[IntermRule]:
        for r in self.interm_rules:
            if fnmatch.fnmatch(name, r.pattern):
                return r
        return None

    def weight_rule_for(self, name: str) -> Optional[WeightRule]:
        for r in self.weight_rules:
            if fnmatch.fnmatch(name, r.pattern):
                return r
        return None

    def __enter__(self):
        _ACTIVE.plan = self
        return self

    def __exit__(self, *exc):
        _ACTIVE.plan = None


def _active() -> Optional[SparsityPlan]:
    return getattr(_ACTIVE, "plan", None)


def _record(plan: SparsityPlan, name: str, x: torch.Tensor) -> None:
    site = (name, tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if site not in plan.recording:
        plan.recording.append(site)


def tag(name: str, x: torch.Tensor, generator=None):
    """Named intermediate site: the identity (``x`` itself) unless a plan
    is active with a rule matching ``name``; then the rule's inline and
    external sparsifiers run and the masked dense value comes back, so
    the surrounding dense model code keeps working."""
    plan = _active()
    if plan is None:
        return x
    if plan.recording is not None:
        _record(plan, name, x)
        return x
    rule = plan.interm_rule_for(name)
    if rule is None:
        return x
    fmt = rule.fmt
    y = x
    if not isinstance(fmt.inline, KeepAll):
        y = fmt.inline(y, generator)
    if not isinstance(fmt.external, KeepAll):
        out = apply_sparsifier(fmt.external, y, fmt.out_layout,
                               generator=generator)
        y = out.to_dense() if isinstance(out, SparsityLayout) else out
    return y


def tag_layout(name: str, x: torch.Tensor, generator=None):
    """Like :func:`tag`, but returns the layout instance (for callers that
    continue with sten ops)."""
    plan = _active()
    if plan is None or plan.recording is not None:
        return tag(name, x, generator)
    rule = plan.interm_rule_for(name)
    if rule is None:
        return x
    fmt = rule.fmt
    y = x if isinstance(fmt.inline, KeepAll) else fmt.inline(x, generator)
    return apply_sparsifier(fmt.external, y, fmt.out_layout,
                            generator=generator)


def trace_intermediates(fn: Callable, *args, **kwargs) -> list:
    """The taggable sites ``fn(*args, **kwargs)`` reaches: [(name, shape,
    dtype name), ...], each once, in first-seen order.  Runs ``fn`` under
    ``torch.no_grad`` (on the inputs' device)."""
    plan = SparsityPlan([], [], recording=[])
    with plan, torch.no_grad():
        fn(*args, **kwargs)
    return list(plan.recording)


def _stack(parts):
    """Re-stack per-layer layouts (or tensors) on a leading [L] axis."""
    p0 = parts[0]
    if isinstance(p0, torch.Tensor):
        return torch.stack(parts)
    if isinstance(p0, (CsrTensor, CooTensor)):
        raise TypeError(f"{type(p0).__name__} is not stacked: a [L, ...] "
                        f"leaf takes a fixed-size layout")
    return type(p0).stack(parts)


class SparsityBuilder:
    """Paper §3.4 API: mark weights and intermediates sparse, then build
    the sparse model.

    >>> sb = SparsityBuilder()
    >>> sb.set_weight("*mlp.wi", GroupedNMSparsifier(1, 4, 16, sparse_dim=0))
    >>> sb.set_interm("mlp.act", NMSparsifier(2, 4))
    >>> sparse_params, sparse_apply = sb.get_sparse_model(params, apply_fn)
    """

    def __init__(self):
        self._weights: list = []
        self._interms: list = []

    # -- weights ------------------------------------------------------------
    def set_weight(self, name: str, initial_sparsifier: Sparsifier,
                   out_format: Optional[type] = None,
                   grad_fmt: Optional[OutFormat] = None):
        self._weights.append(WeightRule(
            name, initial_sparsifier, out_format or FixedMaskTensor,
            grad_fmt))
        return self

    def set_weight_grad(self, name: str, fmt: OutFormat):
        for r in self._weights:
            if r.pattern == name:
                r.grad_fmt = fmt
                return self
        self._weights.append(WeightRule(name, KeepAll(), DenseTensor, fmt))
        return self

    # -- intermediates ------------------------------------------------------
    def set_interm(self, name: str, inline_sparsifier: Sparsifier = KeepAll(),
                   tmp_format: type = DenseTensor,
                   external_sparsifier: Sparsifier = KeepAll(),
                   out_format: type = DenseTensor,
                   grad_fmt: Optional[OutFormat] = None):
        self._interms.append(IntermRule(
            name, OutFormat(inline_sparsifier, tmp_format,
                            external_sparsifier, out_format), grad_fmt))
        return self

    def set_interm_grad(self, name: str, fmt: OutFormat):
        self._interms.append(IntermRule(name, OutFormat(), fmt))
        return self

    # -- build --------------------------------------------------------------
    def plan(self) -> SparsityPlan:
        return SparsityPlan(list(self._weights), list(self._interms))

    def sparsify_params(self, params, generator=None):
        """Replace matching leaves by sparse layouts; a stacked [L, ...]
        leaf per layer, re-stacked."""
        plan = self.plan()

        def visit(tree, path):
            if isinstance(tree, dict):
                return {k: visit(v, path + (k,)) for k, v in tree.items()}
            rule = plan.weight_rule_for(path_name(path))
            if rule is None or not isinstance(tree, torch.Tensor):
                return tree
            if tree.ndim == 3:
                return _stack([
                    apply_sparsifier(rule.initial_sparsifier, t,
                                     rule.out_format, generator=generator)
                    for t in tree.unbind(0)])
            return apply_sparsifier(rule.initial_sparsifier, tree,
                                    rule.out_format, generator=generator)

        return visit(params, ())

    def get_sparse_model(self, params, apply_fn: Callable, generator=None):
        """(sparse params, ``sparse_apply``): the weights converted, and
        ``apply_fn`` run with the plan active so the tags fire."""
        sparse_params = self.sparsify_params(params, generator=generator)
        plan = self.plan()

        def sparse_apply(p, *args, **kwargs):
            with plan:
                return apply_fn(p, *args, **kwargs)

        return sparse_params, sparse_apply

    # -- introspection ------------------------------------------------------
    def grad_formats(self) -> dict:
        return {r.pattern: r.grad_fmt for r in self._weights
                if r.grad_fmt is not None}
