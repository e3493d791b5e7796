"""Sparse-gradient collectives (port of ``repro/dist/collectives.py``) over
``torch.distributed``.

The paper's distributed masked-sparse training exchanges gradients the
portable way: densify, all-reduce the dense buffer, re-sparsify
(:func:`densify_allreduce_resparsify`).  A :class:`FixedMaskTensor`'s
pattern is fixed across steps and the same on every data-parallel rank,
so the exchange needs only the value buffer
(:func:`fixed_mask_value_allreduce`).

Every reduction is a *mean* over the ranks of one named mesh axis: a sum
over that axis's process group (``mesh.get_group(axis)``), divided by its
size.  A deliberate difference: the reference's single controller passes
each replica's full contribution as one replicated array; here each rank
passes its own tensor (a plain tensor, its own contribution), and every
rank of the axis gets the mean back.

Collective API relied on (torch 2.11 and 2.13):
``torch.distributed._functional_collectives.{all_reduce, wait_tensor}``
and ``DeviceMesh.get_group``.
"""

from __future__ import annotations

import torch

from repro_torch.core.layouts import FixedMaskTensor

__all__ = [
    "allreduce_mean",
    "densify_allreduce_resparsify",
    "fixed_mask_value_allreduce",
]


def allreduce_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of every rank's ``x`` over the mesh axis ``axis`` (a new
    tensor; ``x`` is not written)."""
    import torch.distributed._functional_collectives as funcol

    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    total = funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
    return total / n


def densify_allreduce_resparsify(g: FixedMaskTensor, mesh,
                                 axis: str) -> FixedMaskTensor:
    """The paper's exchange: ``to_dense``, all-reduce, re-mask.  Correct
    for any masks, including ranks whose masks disagree."""
    dense = allreduce_mean(g.to_dense(), mesh, axis)
    mask = g.mask
    return FixedMaskTensor(dense * mask.to(dense.dtype), mask, g.origin)


def fixed_mask_value_allreduce(g: FixedMaskTensor, mesh,
                               axis: str) -> FixedMaskTensor:
    """All-reduce the values only, under a mask every rank shares (true
    between pattern recomputes).  Masked-out value slots may hold
    anything, but ``to_dense`` masks them, so the result's dense form
    equals :func:`densify_allreduce_resparsify`'s when the masks agree."""
    return FixedMaskTensor(allreduce_mean(g.val, mesh, axis), g.mask,
                           g.origin)
