"""Densify-then-matmul oracles for the ported n:m:g kernels (port of
``repro/kernels/ref.py``).  The training kernels' oracles would be their
plain versions under another name (``kernels/nm_mask.py:nm_mask_plain``,
``kernels/fused_sparse_matmul.py:matmul_threshold_plain``), so the
tests hold those against the JAX package's ``kernels/ref.py`` instead."""

from __future__ import annotations

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels.nmg_fused import act_fn

__all__ = ["nmg_spmm_ref", "nmg_qkv_ref", "nmg_ffn_ref"]


def nmg_spmm_ref(a: GroupedNMTensor, b: torch.Tensor) -> torch.Tensor:
    """C = A_canonical @ B in f32 through the dense matrix."""
    dense = a.to_dense()
    if a.sparse_dim % 2 == 0:  # canonical view is the transpose
        dense = dense.T
    return dense.float() @ b.float()


def nmg_qkv_ref(ws, b: torch.Tensor) -> tuple:
    """Fused-QKV oracle: one :func:`nmg_spmm_ref` per projection."""
    return tuple(nmg_spmm_ref(w, b) for w in ws)


def nmg_ffn_ref(w: GroupedNMTensor, b: torch.Tensor, *, act: str = "silu"
                ) -> torch.Tensor:
    """Fused gated-FFN oracle: project the packed [D, 2F] weight with
    :func:`nmg_spmm_ref`, split into the u/gate halves along the output
    rows, apply the activation, multiply.  [F, M] f32."""
    u, v = nmg_spmm_ref(w, b).chunk(2, dim=0)
    return act_fn(act)(u) * v
