"""Logical-axis sharding rules for sparse and dense param trees (port of
``repro/dist/sharding.py``) over ``torch.distributed.tensor`` (DTensor).

Model code names *logical* axes ("batch", "seq", "heads", "ff", "expert",
"vocab", "embed"); this module maps them onto *mesh* axes ("pod", "data",
"model"), with the reference's rules, names and divisibility checks:

  * :class:`ShardingRules` — the logical -> mesh assignment, with
    :meth:`ShardingRules.resolve` keeping only the axes a mesh has;
  * :func:`use_rules` / :func:`active_rules` — the active (mesh, rules)
    pair, so :func:`logical_constraint` inside model code finds it;
  * :func:`param_specs` / :func:`batch_spec` — a params tree to a tree of
    :class:`P` specs (tuples of per-dim axes, as the reference's
    ``PartitionSpec`` are, so the two compare entry by entry);
    :func:`tree_shardings` — specs to DTensor placements on a mesh;
    :func:`distribute_params` — the counterpart of ``jax.device_put(params,
    shardings)``.  A :class:`FixedMaskTensor`'s ``val`` and ``mask`` get the
    *same* spec and placements; every other layout (n:m:g, CSR, COO)
    replicates every child.

DTensor stands where GSPMD stands in the reference: a spec becomes
placements (``Shard(i)`` on each mesh dim whose axis the spec puts on
tensor dim ``i``, ``Replicate()`` elsewhere), ``with_sharding_constraint``
becomes ``DTensor.redistribute``, and sharded math equals unsharded math.
A spec entry of several axes (("pod", "data")) shards one tensor dim over
those mesh dims in mesh order, which is the reference's order for every
rule here.

A *mesh* is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the axis names, or, for the spec functions alone
(which allocate nothing), a mapping {axis name: size} in mesh order: the
counterpart of ``jax.sharding.AbstractMesh``.

DTensor API relied on (present in torch 2.11 and 2.13):
``torch.distributed.tensor.{DTensor, Shard, Replicate, Partial,
distribute_tensor}``, ``DTensor.{from_local, to_local, redistribute,
full_tensor, placements, device_mesh}``, ``DeviceMesh.{mesh_dim_names,
size, get_group, get_local_rank}``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor, \
    SparsityLayout, SpmmPlan

__all__ = [
    "Axes",
    "P",
    "ShardingRules",
    "use_rules",
    "active_rules",
    "divisible",
    "mesh_axes",
    "logical_constraint",
    "param_specs",
    "batch_spec",
    "tree_shardings",
    "placements_of",
    "distribute_params",
    "is_dtensor",
    "local_range",
    "local_shard",
    "from_local",
]

#: a logical-axis assignment: no sharding, one mesh axis, or several
Axes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names (``tuple(P(...))`` equals the
    reference's ``tuple(PartitionSpec(...))``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis assignment (a copy of the reference's).

    Fields may be ``None`` (replicate), a mesh-axis name, a tuple of names,
    or a comma-separated string (``"data,model"``).  Defaults: data
    parallelism over ("pod", "data"), tensor and expert parallelism over
    "model"."""

    batch: Axes = ("pod", "data")     # token/batch dims of activations
    seq: Axes = None                  # sequence dim (None: no seq-parallel)
    embed: Axes = None                # d_model dim of weights
    heads: Axes = "model"             # attention-head (projection out) dims
    ff: Axes = "model"                # MLP hidden dims
    vocab: Axes = "model"             # vocabulary dims (embedding / lm_head)
    expert: Axes = "model"            # MoE expert dim (expert parallelism)

    def resolve(self, logical: str, avail: Any) -> Axes:
        """``logical``'s mesh axes present in ``avail``: ``None``, one name
        or a tuple of names; unknown logical names resolve to ``None``."""
        spec = getattr(self, logical, None)
        if spec is None:
            return None
        if isinstance(spec, str):
            spec = tuple(s.strip() for s in spec.split(",") if s.strip())
        axes = tuple(a for a in spec if a in avail)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]


# ---------------------------------------------------------------------------
# active-rules context (thread-local)
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextmanager
def use_rules(mesh, rules: ShardingRules):
    """Install ``(mesh, rules)`` as the active sharding context while the
    body runs (the step functions enter it around the model)."""
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = (mesh, rules)
    try:
        yield (mesh, rules)
    finally:
        _ACTIVE.ctx = prev


def active_rules() -> Optional[Tuple[Any, ShardingRules]]:
    """The (mesh, rules) installed by :func:`use_rules`, or ``None``."""
    return getattr(_ACTIVE, "ctx", None)


# ---------------------------------------------------------------------------
# meshes and spec construction
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an abstract mesh (a
    mapping), in mesh order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh for sharding rules needs mesh_dim_names")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _axes_size(sizes: dict, axes: Axes) -> int:
    k = 1
    for a in _flat_axes(axes):
        k *= sizes[a]
    return k


def divisible(total: int, mesh, axes: Axes) -> bool:
    """True when ``total`` divides evenly over the (resolved) mesh axes
    ``axes`` (``None`` trivially divides)."""
    return total % _axes_size(mesh_axes(mesh), axes) == 0


def _flat_axes(dim: Axes) -> Tuple[str, ...]:
    if dim is None:
        return ()
    return dim if isinstance(dim, tuple) else (dim,)


class _SpecBuilder:
    """A spec for one leaf: each dim's axes divide it, and no mesh axis is
    used on two dims of one leaf."""

    def __init__(self, shape, rules: ShardingRules, sizes: dict):
        self.shape = tuple(shape)
        self.rules = rules
        self.sizes = sizes
        self.dims: list = [None] * len(self.shape)

    def put(self, from_end: int, logical: str):
        """Assign ``logical``'s axes to the ``from_end``-th dim from the
        last (1 == last dim), so a stacked [L, ...] leaf and an unstacked
        one share one rule table."""
        i = len(self.shape) - from_end
        if i < 0 or self.dims[i] is not None:
            return
        ax = self.rules.resolve(logical, self.sizes)
        if ax is None:
            return
        used = {a for d in self.dims for a in _flat_axes(d)}
        if any(a in used for a in _flat_axes(ax)):
            return
        if self.shape[i] % _axes_size(self.sizes, ax) != 0:
            return
        self.dims[i] = ax

    def spec(self) -> P:
        return P(*self.dims)


def _dense_leaf_spec(parts, shape, rules: ShardingRules, sizes: dict) -> P:
    """The reference's path-pattern spec of one dense leaf (dims counted
    from the end)."""
    b = _SpecBuilder(shape, rules, sizes)
    name = parts[-1] if parts else ""
    in_moe = "moe" in parts
    in_attn = "attn" in parts or "xattn" in parts
    if name == "embedding":
        b.put(2, "vocab")
        b.put(1, "embed")
    elif name == "lm_head":
        b.put(1, "vocab")
        b.put(2, "embed")
    elif in_moe:
        if name == "wi":          # [E, D, F']
            b.put(3, "expert")
            b.put(1, "ff")
        elif name == "wo":        # [E, F, D]
            b.put(3, "expert")
            b.put(2, "ff")
        elif name == "res_wi":    # [D, F']
            b.put(1, "ff")
        elif name == "res_wo":    # [F, D]
            b.put(2, "ff")
        # the router stays replicated: every rank routes every token
    elif in_attn:
        if name in ("wq", "wk", "wv", "wuq", "wuk", "wuv", "bq", "bk", "bv"):
            b.put(1, "heads")     # projection-out (heads*hd) dim
        elif name == "wo":        # [H*hd, D]
            b.put(2, "heads")
    elif name == "wi" and "mlp" in parts:
        b.put(1, "ff")            # [D, F']
    elif name == "wo" and "mlp" in parts:
        b.put(2, "ff")            # [F, D]
    # norms, biases, ssm params: replicated
    return b.spec()


def _map_layout(fn, leaf):
    """``leaf`` rebuilt with ``fn`` applied to each of its tensor children
    (a ``GroupedNMTensor``'s plan too); other fields kept."""
    if isinstance(leaf, FixedMaskTensor):
        return FixedMaskTensor(fn(leaf.val), fn(leaf.mask), leaf.origin)
    if isinstance(leaf, GroupedNMTensor):
        plan = None if leaf.plan is None else SpmmPlan(
            fn(leaf.plan.cols), fn(leaf.plan.pat_onehot))
        return dataclasses.replace(leaf, val=fn(leaf.val),
                                   blk_idx=fn(leaf.blk_idx), plan=plan)
    if dataclasses.is_dataclass(leaf):
        return dataclasses.replace(leaf, **{
            f.name: fn(getattr(leaf, f.name))
            for f in dataclasses.fields(leaf) if f.init
            and isinstance(getattr(leaf, f.name), torch.Tensor)})
    raise TypeError(f"no children to map in {type(leaf).__name__}")


def _walk(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(list(path), tree)


def param_specs(params, rules: ShardingRules, mesh):
    """A params tree (tensors, layouts, or anything with ``.shape``) to a
    tree of :class:`P` specs of the same structure.  A
    :class:`FixedMaskTensor` keeps its dense shape, so the dense rule fires
    once and the same spec goes to ``val`` and ``mask`` (a layout node of
    specs); any other layout gets ``P()`` for every child."""
    sizes = mesh_axes(mesh)

    def visit(parts, leaf):
        if isinstance(leaf, FixedMaskTensor):
            spec = _dense_leaf_spec(parts, leaf.shape, rules, sizes)
            return FixedMaskTensor(spec, spec, leaf.origin)
        if isinstance(leaf, SparsityLayout):
            return _map_layout(lambda _: P(), leaf)
        if leaf is None or not hasattr(leaf, "shape"):
            return None
        return _dense_leaf_spec(parts, leaf.shape, rules, sizes)

    return _walk(visit, params)


def batch_spec(x, rules: ShardingRules, mesh) -> P:
    """Spec of one batch array: dim 0 over the data-parallel axes when
    divisible, everything else replicated."""
    sizes = mesh_axes(mesh)
    shape = tuple(getattr(x, "shape", ()))
    dims = [None] * len(shape)
    dp = rules.resolve("batch", sizes)
    if shape and dp is not None and shape[0] % _axes_size(sizes, dp) == 0:
        dims[0] = dp
    return P(*dims)


def placements_of(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim whose axis ``spec`` puts on tensor dim ``i``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: i for i, d in enumerate(spec) for a in _flat_axes(d)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axes(mesh))


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, SparsityLayout):
        return _map_layout(lambda s: fn(s) if isinstance(s, P) else s, specs)
    return specs


def tree_shardings(specs, mesh):
    """A tree of :class:`P` specs to the same tree of placement tuples on
    ``mesh`` (non-spec leaves pass through)."""
    return _map_specs(lambda s: placements_of(s, mesh), specs)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor where
    ``torch.distributed`` is absent)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_range(x, dim: int) -> tuple:
    """(offset, size) of this rank's slice of dim ``dim`` of the DTensor
    ``x`` (mesh dims that shard ``dim`` nest in mesh order, DTensor's
    default; sizes divide evenly, as the rules make them)."""
    size, off = x.shape[dim], 0
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and pl.dim == dim:
            size //= x.device_mesh.size(i)
            off += x.device_mesh.get_local_rank(i) * size
    return off, size


def from_local(t: torch.Tensor, mesh, placements, shape):
    """This rank's ``t`` as its shard of a contiguous DTensor of global
    ``shape`` under ``placements`` (no check, no communication)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_shard(t, mesh, placements, grad_placements=None) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements`` on ``mesh``: a
    DTensor redistributed there and made local; a plain tensor, the same
    on every rank, taken as replicated first (its shard is a slice, no
    communication).  ``grad_placements``: how the local gradient lies
    (``Partial`` on a mesh dim whose ranks each compute part of it), by
    default as ``placements``."""
    if not is_dtensor(t):
        from torch.distributed.tensor import DTensor, Replicate

        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, tuple(placements)).to_local(
        grad_placements=grad_placements)


def _distribute(t, placements, mesh):
    from torch.distributed.tensor import distribute_tensor

    if not isinstance(t, torch.Tensor):
        return t
    if is_dtensor(t):
        return t.redistribute(mesh, placements)
    # a copy, as device_put makes one: a replicated shard would otherwise
    # alias the caller's tensor, which the in-place steps then write
    return distribute_tensor(t.detach().clone(), mesh, placements)


def distribute_params(params, mesh, rules: ShardingRules, specs=None):
    """The params tree as DTensors on ``mesh`` under ``rules`` (the
    counterpart of ``jax.device_put(params, tree_shardings(specs, mesh))``):
    every tensor, a layout's children too, distributed with the placements
    of its spec (``specs``, :func:`param_specs` by default).  A
    ``FixedMaskTensor``'s ``val`` and ``mask`` get the same placements;
    other layouts replicate.  Every rank must pass the same params; the
    result holds copies, never the caller's tensors."""
    specs = param_specs(params, rules, mesh) if specs is None else specs

    def put(leaf, spec):
        if isinstance(leaf, dict):
            return {k: put(leaf[k], spec[k]) for k in leaf}
        if isinstance(leaf, FixedMaskTensor):
            return FixedMaskTensor(
                _distribute(leaf.val, placements_of(spec.val, mesh), mesh),
                _distribute(leaf.mask, placements_of(spec.mask, mesh), mesh),
                leaf.origin)
        if isinstance(leaf, SparsityLayout):
            rep = placements_of(P(), mesh)
            return _map_layout(lambda t: _distribute(t, rep, mesh), leaf)
        if isinstance(leaf, torch.Tensor):
            return _distribute(leaf, placements_of(spec, mesh), mesh)
        return leaf

    return put(params, specs)


# ---------------------------------------------------------------------------
# in-model constraints
# ---------------------------------------------------------------------------


def logical_constraint(x, logical_axes):
    """``with_sharding_constraint`` by logical-axis names: a DTensor ``x``
    is redistributed to the placements the active rules resolve
    ``logical_axes`` (one logical name or ``None`` per dim) to.  With no
    rules active, or on a plain tensor (one-card paths), it is the
    identity.  A dim that does not divide its axes, or whose axes an
    earlier dim took, stays replicated; when no dim resolves to an axis,
    ``x`` is returned as it is, as in the reference."""
    ctx = active_rules()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    sizes = mesh_axes(mesh)
    dims: list = [None] * x.ndim
    used: set = set()
    for i, name in enumerate(logical_axes):
        if name is None:
            continue
        ax = rules.resolve(name, sizes)
        if ax is None or any(a in used for a in _flat_axes(ax)):
            continue
        if x.shape[i] % _axes_size(sizes, ax) != 0:
            continue
        dims[i] = ax
        used.update(_flat_axes(ax))
    if not used:      # the reference constrains nothing then
        return x
    want = placements_of(P(*dims), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
