"""Built-in sparse operator implementations registered with the
dispatcher (port of ``repro/core/ops.py``, paper §4.4), in the
reference's registration order: CSR/COO products and the keep-all COO
add, the masked-dense products of masked training, the n:m:g ``matmul`` /
``linear`` onto the shape-routed kernels, the plain n:m ``matmul``, and
the fused inline-threshold matmul onto the ``matmul_threshold`` kernel.
Every other op reaches the dense fallback with a warning.

The reference computes the CSR, COO, n:m and masked-dense products with
XLA outside any Pallas kernel; here they are plain torch ops, all
differentiable in the stored values.  On CUDA the CSR/COO products add
with ``index_add``, whose order is not fixed: equal to a dense product
within rounding, not bitwise.  ``gelu`` is the tanh approximation, as
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

# the module (the package re-exports a function named ``dispatch``)
disp = importlib.import_module("repro_torch.core.dispatch")
from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, GroupedNMTensor, NMTensor, SparsityLayout
from repro_torch.core.sparsifiers import ScalarThresholdSparsifier

__all__ = ["matmul", "add", "linear", "relu", "gelu", "sum_"]


def _dense(x) -> torch.Tensor:
    return x.to_dense() if isinstance(x, SparsityLayout) else x


def _dense_linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


disp.register_dense_reference("matmul", torch.matmul)
disp.register_dense_reference("add", torch.add)
disp.register_dense_reference("relu", torch.relu)
disp.register_dense_reference("gelu", _gelu)
disp.register_dense_reference("sum", torch.sum)
disp.register_dense_reference("linear", _dense_linear)


# -- CSR / COO --------------------------------------------------------------


@disp.register_op_impl("matmul", inp=(CsrTensor, DenseTensor),
                       out=DenseTensor)
def _csr_dense_mm(a: CsrTensor, b):
    """CSR[M, K] @ dense[K, N]: gather the rows of B, segment-sum per row."""
    b = _dense(b)
    row_ids, valid = a.row_ids()
    vals = torch.where(valid, a.data, torch.zeros_like(a.data))
    contrib = vals[:, None] * b[a.indices.long()]
    out = contrib.new_zeros((a.shape[0], b.shape[1]))
    return out.index_add(0, row_ids, contrib)


@disp.register_op_impl("matmul", inp=(DenseTensor, CsrTensor),
                       out=DenseTensor)
def _dense_csr_mm(a, b: CsrTensor):
    """dense[M, K] @ CSR[K, N]: out[:, c] += a[:, r] * v for every stored
    (r, c, v)."""
    a = _dense(a)
    row_ids, valid = b.row_ids()
    vals = torch.where(valid, b.data, torch.zeros_like(b.data))
    gathered = a[:, row_ids] * vals[None, :]              # [M, nnz_cap]
    out = gathered.new_zeros((a.shape[0], b.shape[1]))
    return out.index_add(1, b.indices.long(), gathered)


@disp.register_op_impl("add", inp=(CooTensor, CooTensor), out=CooTensor)
def _coo_add(a: CooTensor, b: CooTensor):
    """Keep-all sparse add: the union of the nonzeros, by concatenating
    the stored entries (paper §3.3)."""
    assert a.shape == b.shape
    return CooTensor(torch.cat([a.data, b.data]),
                     torch.cat([a.coords, b.coords], dim=1), a.shape)


# -- masked dense (the training workhorse) ----------------------------------


@disp.register_op_impl("matmul", inp=(DenseTensor, FixedMaskTensor),
                       out=DenseTensor)
def _dense_masked_mm(a, w: FixedMaskTensor):
    return torch.matmul(_dense(a), w.to_dense())


@disp.register_op_impl("matmul", inp=(FixedMaskTensor, DenseTensor),
                       out=DenseTensor)
def _masked_dense_mm(a: FixedMaskTensor, b):
    return torch.matmul(a.to_dense(), _dense(b))


@disp.register_op_impl("linear", inp=(DenseTensor, FixedMaskTensor),
                       out=DenseTensor)
def _linear_masked(x, w: FixedMaskTensor, b=None):
    return _dense_linear(_dense(x), w.to_dense(), b)


# -- n:m:g (the serving fast path) ------------------------------------------


@disp.register_op_impl("matmul", inp=(GroupedNMTensor, DenseTensor),
                       out=DenseTensor)
def _nmg_dense_mm(a: GroupedNMTensor, b):
    """Shape-routed: a narrow B takes the GEMV kernel, a wide one the
    SpMM kernel (``kernels/ops.py:nmg_matmul``); f32 out."""
    from repro_torch.kernels import ops as kops

    if a.sparse_dim % 2 != 1:
        raise NotImplementedError(
            "GroupedNM matmul needs sparse_dim=1 on the left operand; "
            "store the weight transposed or use 'linear'.")
    return kops.nmg_matmul(a, _dense(b))


@disp.register_op_impl("linear", inp=(DenseTensor, GroupedNMTensor),
                       out=DenseTensor)
def _linear_nmg(x, w: GroupedNMTensor, b=None):
    from repro_torch.kernels import ops as kops

    if w.sparse_dim % 2 != 0:
        raise NotImplementedError(
            "n:m:g linear expects the weight sparse along its input axis "
            "(sparse_dim=0) with groups along the output axis.")
    y = kops.nmg_linear(_dense(x), w)
    return y if b is None else y + b


@disp.register_op_impl("matmul", inp=(NMTensor, DenseTensor),
                       out=DenseTensor)
def _nm_dense_mm(a: NMTensor, b):
    """Plain n:m (last axis sparse) @ dense: gather the rows of B each
    stored value multiplies; f32 sum."""
    b = _dense(b)
    M, K = a.shape
    nblocks = a.val.shape[-2]
    base = torch.arange(nblocks, device=b.device) * a.m
    cols = (base[:, None] + a.idx.long()).reshape(M, -1)    # [M, nb*n]
    b_p = F.pad(b, (0, 0, 0, nblocks * a.m - K))
    gathered = b_p[cols.reshape(-1)].reshape(M, -1, b.shape[1])
    return torch.einsum("mk,mkn->mn", a.val.reshape(M, -1).float(),
                        gathered.float())


# -- fused inline sparsifier (paper §3.3 streaming fusion) ------------------


@disp.register_op_impl("matmul", inp=(DenseTensor, DenseTensor),
                       out=FixedMaskTensor, inline=ScalarThresholdSparsifier)
def _fused_matmul_threshold(sparsifier, a, b):
    from repro_torch.kernels import ops as kops

    val, mask = kops.matmul_threshold(_dense(a), _dense(b),
                                      float(sparsifier.threshold))
    return FixedMaskTensor(val, mask)


_fused_matmul_threshold._sten_fused = True


# -- the functional API (sten.* ops) ----------------------------------------


def matmul(a, b, **kw):
    return disp.dispatch("matmul", a, b, **kw)


def add(a, b, **kw):
    return disp.dispatch("add", a, b, **kw)


def linear(x, w, b=None, **kw):
    # the bias passes as a keyword so the 2-operand signature matches
    return disp.dispatch("linear", x, w, b=b, **kw)


def relu(x, **kw):
    return disp.dispatch("relu", x, **kw)


def gelu(x, **kw):
    return disp.dispatch("gelu", x, **kw)


def sum_(x, **kw):
    return disp.dispatch("sum", x, **kw)
