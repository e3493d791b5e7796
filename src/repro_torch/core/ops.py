"""Built-in sparse operator implementations registered with the
dispatcher (port of part of ``repro/core/ops.py``): the masked-dense
products of masked training, the n:m:g ``linear`` onto the shape-routed
kernels, and the fused inline-threshold matmul onto the
``matmul_threshold`` kernel.  The CSR/COO/NMTensor implementations and
the elementwise ops are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import dispatch as disp
from repro_torch.core.layouts import DenseTensor, FixedMaskTensor, \
    GroupedNMTensor, SparsityLayout
from repro_torch.core.sparsifiers import ScalarThresholdSparsifier

__all__ = ["matmul", "linear"]


def _dense(x) -> torch.Tensor:
    return x.to_dense() if isinstance(x, SparsityLayout) else x


def _dense_linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


disp.register_dense_reference("matmul", torch.matmul)
disp.register_dense_reference("linear", _dense_linear)


# -- masked dense (the training workhorse): plain products on the masked
# weight, which the reference also computes outside any kernel ------------


@disp.register_op_impl("matmul", inp=(DenseTensor, FixedMaskTensor))
def _dense_masked_mm(a, w: FixedMaskTensor):
    return torch.matmul(_dense(a), w.to_dense())


@disp.register_op_impl("matmul", inp=(FixedMaskTensor, DenseTensor))
def _masked_dense_mm(a: FixedMaskTensor, b):
    return torch.matmul(a.to_dense(), _dense(b))


@disp.register_op_impl("linear", inp=(DenseTensor, FixedMaskTensor))
def _linear_masked(x, w: FixedMaskTensor, b=None):
    return _dense_linear(_dense(x), w.to_dense(), b)


# -- n:m:g (the serving fast path) ------------------------------------------


@disp.register_op_impl("linear", inp=(DenseTensor, GroupedNMTensor))
def _linear_nmg(x, w: GroupedNMTensor, b=None):
    from repro_torch.kernels import ops as kops

    y = kops.nmg_linear(_dense(x), w)
    return y if b is None else y + b


# -- fused inline sparsifier (paper §3.3 streaming fusion) -----------------


@disp.register_op_impl("matmul", inp=(DenseTensor, DenseTensor),
                       inline=ScalarThresholdSparsifier)
def _fused_matmul_threshold(sparsifier, a, b):
    from repro_torch.kernels import ops as kops

    val, mask = kops.matmul_threshold(_dense(a), _dense(b),
                                      float(sparsifier.threshold))
    return FixedMaskTensor(val, mask)


_fused_matmul_threshold._sten_fused = True


def matmul(a, b, **kw):
    return disp.dispatch("matmul", a, b, **kw)


def linear(x, w, b=None, **kw):
    # the bias passes as a keyword so the 2-operand signature matches
    return disp.dispatch("linear", x, w, b=b, **kw)
