"""The DTensor boundary of the kernel wrappers.

A kernel launches through ``ctypes`` on raw pointers, which a DTensor does
not have.  Every wrapper of ``kernels/ops.py:KERNEL_WRAPPERS`` given a
DTensor operand hands it to :func:`localize`, calls itself on the local
tensors (so the kernel launches on the card, and the plain version runs
only because a local tensor lies on the CPU), and wraps the result with
:meth:`Local.wrap`:

- **local**: where the activation is sharded only along dims the kernel
  treats row by row (rows of ``x``: the columns of the wrappers' B) and
  every weight is replicated (an n:m:g weight always is, under the
  reference's rules), the kernel runs on ``to_local()`` and the result
  carries the row shards;
- **gathered**: where a kernel's blocks would cross a sharded dim (the
  contraction dim, ``nm_mask``'s m-blocks over a sharded last axis), or
  an operand is ``Partial`` or a sharded weight, that operand is gathered
  first (a redistribute to ``Replicate`` on those mesh dims), the
  kernel launches once, and a result shaped as
  the activation is re-sharded to its placements.

``kernel_counters`` counts each boundary call as ``(kernel,
"dtensor_local")`` or ``(kernel, "dtensor_gathered")``.  A replicated
weight that takes gradients (``matmul_threshold``'s B) leaves the
boundary with ``Partial`` gradient placements on the mesh dims that
shard the rows, so the backward sums its per-rank parts.

DTensor API relied on (torch 2.11 and 2.13): ``DTensor.{from_local,
to_local(grad_placements=), redistribute, full_tensor, placements,
device_mesh}``, ``Shard``, ``Replicate``, ``Partial``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.layouts import SparsityLayout

__all__ = ["any_dtensor", "localize", "Local"]


def _is_dt(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from repro_torch.dist.sharding import is_dtensor

    return is_dtensor(x)


def _children(w) -> list:
    if isinstance(w, SparsityLayout) and dataclasses.is_dataclass(w):
        out = [getattr(w, f.name) for f in dataclasses.fields(w)]
        plan = getattr(w, "plan", None)
        if plan is not None:
            out += [plan.cols, plan.pat_onehot]
        return out
    if isinstance(w, SparsityLayout):
        return list(vars(w).values())
    return [w]


def any_dtensor(*operands) -> bool:
    """Whether any operand (a tensor, a layout, or a sequence of them) is
    or holds a DTensor.  A layout is judged by its value tensor (``val``
    or ``data``): ``dist/sharding.py:distribute_params`` distributes
    every child of a layout together.  A few attribute reads for plain
    operands, the wrappers' every call."""
    for op in operands:
        items = op if isinstance(op, (list, tuple)) else (op,)
        for it in items:
            if isinstance(it, SparsityLayout):
                it = getattr(it, "val", None) if hasattr(it, "val") \
                    else getattr(it, "data", None)
            if _is_dt(it):
                return True
    return False


def _count(kernel: str, how: str) -> None:
    from repro_torch.kernels import ops

    ops._KERNEL_COUNTS[(kernel, f"dtensor_{how}")] += 1


def _local_weight(w, grad_partial):
    """A weight (tensor or layout) with every DTensor child made local:
    a replicated one by ``to_local`` (gradient placements
    ``grad_partial``), any other gathered whole.  Returns (weight,
    gathered?)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import _map_layout

    gathered = False

    def loc(t):
        nonlocal gathered
        if not _is_dt(t):
            return t
        if not all(p.is_replicate() for p in t.placements):
            gathered = True
            t = t.redistribute(t.device_mesh,
                               (Replicate(),) * t.device_mesh.ndim)
        return t.to_local(grad_placements=grad_partial)

    if isinstance(w, SparsityLayout):
        return _map_layout(loc, w), gathered
    return loc(w), gathered


@dataclasses.dataclass
class Local:
    """What :func:`localize` kept of the activation: its mesh, the
    placements the local tensor carries, its global shape and, when it
    was gathered, the placements it came with."""

    mesh: object
    kept: tuple
    shape: tuple
    original: tuple
    gathered: bool

    def wrap(self, out: torch.Tensor, dims: dict) -> torch.Tensor:
        """``out`` (this rank's result) as a DTensor: each kept row shard
        of activation dim ``d`` becomes a shard of result dim
        ``dims[d]``; everything else is replicated.  A result shaped as
        the activation (``dims`` the identity on every dim) is re-sharded
        to the activation's own placements when it was gathered."""
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.dist.sharding import from_local

        if out is None or self.mesh is None:
            return out
        place = tuple(Shard(dims[p.dim]) if p.is_shard() else Replicate()
                      for p in self.kept)
        shape = list(out.shape)
        for d_in, d_out in dims.items():
            shape[d_out] = self.shape[d_in]
        res = from_local(out, self.mesh, place, shape)
        same = len(dims) == out.ndim == len(self.shape) and all(
            dims.get(d) == d for d in range(out.ndim))
        if self.gathered and same and place != self.original:
            res = res.redistribute(self.mesh, self.original)
        return res


def localize(kernel: str, x, rows, weights=()):
    """The local operands of one boundary call: ``x`` (the activation, a
    DTensor or a plain tensor) with only its row-dim shards (``rows``,
    dims of ``x``) kept, and each of ``weights`` made local.  Counts the
    call (``dtensor_local`` / ``dtensor_gathered``).  Returns (local x,
    [local weights], :class:`Local`)."""
    from torch.distributed.tensor import Partial, Replicate

    gathered = False
    if _is_dt(x):
        mesh, original = x.device_mesh, tuple(x.placements)
        kept = tuple(p if (p.is_shard() and p.dim in rows) else Replicate()
                     for p in original)
        if kept != original:
            gathered = True
            x = x.redistribute(mesh, kept)
        shape = tuple(x.shape)
        x_loc = x.to_local()
        grad_partial = tuple(Partial() if p.is_shard() else Replicate()
                             for p in kept)
    else:
        mesh = next((c.device_mesh for w in weights for c in _children(w)
                     if _is_dt(c)), None)
        kept = original = () if mesh is None else tuple(
            Replicate() for _ in range(mesh.ndim))
        shape, x_loc, grad_partial = tuple(x.shape), x, kept
    locs = []
    for w in weights:
        wl, g = _local_weight(w, grad_partial or None)
        locs.append(wl)
        gathered = gathered or g
    _count(kernel, "gathered" if gathered else "local")
    return x_loc, locs, Local(mesh, kept, shape, original, gathered)
