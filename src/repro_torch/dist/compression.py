"""Top-k gradient compression with error feedback (port of
``repro/dist/compression.py``).

:func:`ef_step` keeps the ``k_fraction`` largest-magnitude entries of the
gradient plus its residual and banks the complement in the residual, so
nothing is lost over time; :func:`compressed_allreduce` scatters each
rank's (values, indices) payload into a dense buffer and mean-reduces it
over a mesh axis (each rank passes its own payload:
``dist/collectives.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.collectives import allreduce_mean

__all__ = ["ef_step", "compressed_allreduce"]


def ef_step(grad: torch.Tensor, memory: torch.Tensor, *,
            k_fraction: float):
    """One error-feedback step: ``acc = grad + memory``, its k largest
    magnitudes as a ``(values [k], flat_indices [k] int32)`` payload and
    the new residual, ``acc`` with those entries zeroed:
    ``scatter(values, indices) + new_memory == grad + memory``.

    The order is ``lax.top_k``'s: larger first, the lower index first on
    a tie, which a stable descending sort gives (``torch.topk`` promises
    no order among ties).  Returns ``((values, indices), new_memory)``."""
    acc = (grad + memory).reshape(-1)
    k = max(1, min(acc.shape[0], int(acc.shape[0] * k_fraction)))
    idx = torch.sort(acc.abs(), stable=True, descending=True).indices[:k]
    vals = acc[idx]
    new_memory = acc.clone()
    new_memory[idx] = 0
    return (vals, idx.to(torch.int32)), new_memory.reshape(grad.shape)


def compressed_allreduce(vals: torch.Tensor, idx: torch.Tensor, shape,
                         mesh, axis: str) -> torch.Tensor:
    """The mean over ``axis``'s ranks of each rank's top-k payload
    scattered into a dense array of ``shape``."""
    size = int(math.prod(shape))
    dense = torch.zeros((size,), dtype=vals.dtype, device=vals.device)
    dense.index_add_(0, idx.long(), vals)
    return allreduce_mean(dense, mesh, axis).reshape(shape)
