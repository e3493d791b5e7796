"""Sparsifiers (minimal port of ``repro/core/sparsifiers.py``): only the
paper's n:m:g sparsifier, which the serving conversion uses.  The other
Table 1 classes are not ported yet."""

from __future__ import annotations

import dataclasses

from repro_torch.core import nmg
from repro_torch.core.layouts import DenseTensor, GroupedNMTensor

__all__ = ["GroupedNMSparsifier", "apply_sparsifier"]


@dataclasses.dataclass(frozen=True)
class GroupedNMSparsifier:
    """The paper's n:m:g sparsifier (§5.2); ``gr`` is the row-sharing
    width, ``sparse_dim`` 0 for weights stored [K, N]."""

    n: int = 2
    m: int = 4
    g: int = 16
    gr: int = 1
    method: str = "greedy"
    sparse_dim: int = -1


def apply_sparsifier(sparsifier, x, out_layout: type = GroupedNMTensor):
    """Apply ``sparsifier`` to dense ``x`` producing ``out_layout`` — the
    one registered (sparsifier, dense, layout) implementation ported."""
    if not isinstance(sparsifier, GroupedNMSparsifier) \
            or out_layout is not GroupedNMTensor:
        raise NotImplementedError(
            f"no ported sparsifier implementation for "
            f"({type(sparsifier).__name__}, {getattr(out_layout, '__name__', out_layout)})")
    dense = x.to_dense() if isinstance(x, DenseTensor) else x
    return nmg.dense_to_grouped_nm(
        dense, n=sparsifier.n, m=sparsifier.m, g=sparsifier.g,
        gr=sparsifier.gr, sparse_dim=sparsifier.sparse_dim,
        method=sparsifier.method)
