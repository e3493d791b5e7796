"""Lossless layout conversions (port of ``repro/core/convert.py``, paper
§4.4).  The dispatcher converts an operand only when no value can be lost:
every layout densifies exactly; dense converts losslessly to CSR, COO and
FixedMask; the structured formats (n:m, n:m:g) convert losslessly *from*
but never *to*, since their sparsifier drops values.
"""

from __future__ import annotations

import torch

from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, GroupedNMTensor, NMTensor, SparsityLayout

__all__ = ["convert", "lossless_targets", "as_layout", "conversion_log",
           "reset_conversion_log"]

#: every conversion that ran (short cuts excluded), as (source layout
#: name, target layout name, dense shape)
_CONVERSION_LOG: list = []


def conversion_log() -> list:
    return list(_CONVERSION_LOG)


def reset_conversion_log() -> None:
    _CONVERSION_LOG.clear()


def as_layout(x) -> SparsityLayout:
    return x if isinstance(x, SparsityLayout) else \
        DenseTensor(torch.as_tensor(x))


#: layouts reachable losslessly from each layout (besides itself)
_LOSSLESS: dict = {
    DenseTensor: (CsrTensor, CooTensor, FixedMaskTensor),
    CsrTensor: (DenseTensor, CooTensor, FixedMaskTensor),
    CooTensor: (DenseTensor, CsrTensor, FixedMaskTensor),
    FixedMaskTensor: (DenseTensor, CsrTensor, CooTensor),
    NMTensor: (DenseTensor, FixedMaskTensor, CsrTensor, CooTensor),
    GroupedNMTensor: (DenseTensor, FixedMaskTensor, CsrTensor, CooTensor),
}


def lossless_targets(layout_cls: type) -> tuple:
    return (layout_cls,) + _LOSSLESS.get(layout_cls, (DenseTensor,))


def convert(x, target: type):
    """Losslessly convert ``x`` to the layout class ``target``; raises
    TypeError where the conversion would drop values."""
    x = as_layout(x)
    if isinstance(x, target):
        return x
    if target not in lossless_targets(type(x)):
        raise TypeError(
            f"no lossless conversion {type(x).__name__} -> {target.__name__}")
    dense = x.to_dense()
    _CONVERSION_LOG.append(
        (type(x).__name__, target.__name__, tuple(map(int, dense.shape))))
    if target is DenseTensor:
        return DenseTensor(dense)
    if target is FixedMaskTensor:
        return FixedMaskTensor(dense, dense != 0)
    if target is CsrTensor:
        return CsrTensor.from_dense(dense)
    if target is CooTensor:
        return CooTensor.from_dense(dense)
    raise TypeError(f"unhandled conversion target {target}")
