"""Carry params from the JAX package into the port, through numpy.

The caller hands over the JAX params as a nested dict of numpy arrays
(``np.asarray`` of each leaf); a layout leaf arrives as a dict of its
fields, told apart by its keys:

- ``{val, blk_idx, cols, n, m, g, gr, dense_shape, sparse_dim}``:
  ``GroupedNMTensor``;
- ``{val, mask, origin}``: ``FixedMaskTensor``;
- ``{val, idx, n, m, dense_shape}``: ``NMTensor``;
- ``{data, indices, indptr, dense_shape}``: ``CsrTensor``;
- ``{data, coords, dense_shape}``: ``CooTensor``;
- ``{data}``: ``DenseTensor``.
  The
port's kernels and model then run on exactly the storage the reference
converted, so parity tests do not depend on near-ties in the greedy
conversion.  bf16 arrays cross without ``ml_dtypes``: their bits are
reinterpreted as int16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sparsifiers
from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, GroupedNMTensor, NMTensor, SpmmPlan, pattern_onehots
from repro_torch.device import resolve_device

__all__ = ["tensor_from_numpy", "params_from_numpy", "sparsifier_from_dict",
           "SPARSE_KEYS"]

SPARSE_KEYS = ("val", "blk_idx", "cols", "n", "m", "g", "gr", "dense_shape",
               "sparse_dim")


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A torch copy of ``arr`` on ``device``; bf16 keeps its bits."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(arr)   # copies read-only / strided arrays
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def _sparse(d: dict, dev) -> GroupedNMTensor:
    n, m, g = int(d["n"]), int(d["m"]), int(d["g"])
    onehot = torch.as_tensor(
        np.repeat(pattern_onehots(n, m), g, axis=0).astype(np.int8),
        device=dev)
    return GroupedNMTensor(
        val=tensor_from_numpy(d["val"], dev),
        blk_idx=tensor_from_numpy(d["blk_idx"], dev).to(torch.int32),
        n=n, m=m, g=g, gr=int(d["gr"]),
        dense_shape=tuple(int(s) for s in d["dense_shape"]),
        sparse_dim=int(d["sparse_dim"]),
        plan=SpmmPlan(cols=tensor_from_numpy(d["cols"], dev)
                      .to(torch.int32).contiguous(), pat_onehot=onehot))


def sparsifier_from_dict(d):
    """The port's sparsifier named by ``d["type"]`` with the other keys as
    its fields (None stays None)."""
    if d is None:
        return None
    fields = {k: v for k, v in d.items() if k != "type"}
    return getattr(sparsifiers, d["type"])(**fields)


def _shape(d: dict) -> tuple:
    return tuple(int(s) for s in d["dense_shape"])


def _int32(arr, dev) -> torch.Tensor:
    return tensor_from_numpy(arr, dev).to(torch.int32)


def _layout(d: dict, dev):
    """The layout a leaf dict names (by its keys), or None."""
    keys = set(d)
    if {"val", "blk_idx"} <= keys:
        return _sparse(d, dev)
    if {"val", "mask"} <= keys:
        return FixedMaskTensor(
            tensor_from_numpy(d["val"], dev),
            tensor_from_numpy(d["mask"], dev).bool(),
            sparsifier_from_dict(d.get("origin")))
    if {"val", "idx"} <= keys:
        return NMTensor(tensor_from_numpy(d["val"], dev),
                        _int32(d["idx"], dev), int(d["n"]), int(d["m"]),
                        _shape(d))
    if {"data", "indptr"} <= keys:
        return CsrTensor(tensor_from_numpy(d["data"], dev),
                         _int32(d["indices"], dev), _int32(d["indptr"], dev),
                         _shape(d))
    if {"data", "coords"} <= keys:
        return CooTensor(tensor_from_numpy(d["data"], dev),
                         _int32(d["coords"], dev), _shape(d))
    if keys == {"data"}:
        return DenseTensor(tensor_from_numpy(d["data"], dev))
    return None


def params_from_numpy(tree, device="cuda"):
    """The port's params from the reference's (numpy) params tree."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        leaf = _layout(tree, dev)
        if leaf is not None:
            return leaf
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)
