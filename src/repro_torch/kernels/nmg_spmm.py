"""Prefill-shaped n:m:g SpMM: ``C[R, N] = A_canonical[R, K] @ B[K, N]`` in
f32 (port of ``repro/kernels/nmg_spmm.py``).

:func:`nmg_spmm` launches the hand-written CUDA kernel
(``csrc/nmg_spmm.cu``) for CUDA tensors and takes the plain PyTorch version
:func:`nmg_spmm_plain` (the blocked gather + einsum of
``repro/kernels/ops.py:nmg_spmm_xla``) only for tensors on the CPU.  The
reference's two Pallas schedules (streamed and grid) compute the same
function; one CUDA kernel replaces both.

f32 accumulation; as :func:`~repro_torch.kernels.nmg_gemv.nmg_gemv` does,
``out_dtype`` casts the f32 sum once (round to nearest even, as
``.to(dtype)``) and ``transpose_out=True`` writes [N, R], the orientation
``nmg_linear``'s prefill wants.  The default stays f32 [R, N].

Any gr.  The SpMM kernel's blocks own 64 rows (128 where gr allows) that
share one fiber group's plan, so it takes gr a multiple of 64.  Weights
of any other gr (the reference takes every gr; its own docstring calls
gr=1 "still correct") go through the decode GEMV kernel instead, run over
16-column chunks of B as a third grid dimension in one launch, writing
the same f32 [R, N] or cast [N, R] output.  That route was chosen over
giving each 16-row tile of the tensor-core body its own group's gather
because it serves every gr with code that already exists and is held to
the reference: its ``tc`` body (bf16, gr a multiple of 16, as at the
gr16 of the CPU parity models) gathers each group's B once per 16-column
chunk and runs the same ``mma.sync`` products, and its ``general`` body
takes the rest.  The price is one B gather per chunk where the SpMM
body stages B windows for up to 64 columns at once.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import _dtensor, _trace
from repro_torch.kernels.nmg_gemv import _DTYPE_CODE, _pad_rows, \
    check_operands, gemv_launch, meta_out, product_flops
from repro_torch.tune import routing

__all__ = ["nmg_spmm", "nmg_spmm_plain", "spmm_split_choices"]

#: output rows per block of the SpMM kernel; other gr take the GEMV route
_ROWS_PER_BLOCK = 64
#: stored K values per slab of the bf16 (tensor-core) and f32 bodies
_SLAB = {torch.bfloat16: 64, torch.float32: 32}


def spmm_split_choices(KN: int, dtype, most: int = 16) -> list:
    """The K split counts (up to ``most``) the SpMM takes for ``KN`` stored
    values a row in ``dtype``: splits of equal slab counts, none empty
    (``csrc/nmg_spmm.cu:requested_splits``)."""
    nslab = math.ceil(KN / _SLAB[dtype])
    return [z for z in range(1, min(most, nslab) + 1)
            if math.ceil(nslab / math.ceil(nslab / z)) == z]


def _gather_block(b_p, cols, val_g):
    """One activation-stationary block: gather the planned B rows for a
    slab of fiber groups and contract in one f32 einsum.
    cols [G, nb*n], val_g [G, gr, nb*n] -> [G, gr, N] f32."""
    bg = b_p[cols.reshape(-1).long()].reshape(*cols.shape, b_p.shape[1])
    return torch.einsum("grk,gkn->grn", val_g.float(), bg.float())


def nmg_spmm_plain(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
                   transpose_out: bool = False,
                   block_elems: Optional[int] = None,
                   splits: Optional[int] = None) -> torch.Tensor:
    """Plain version: blocked gather + einsum over the column plan, each
    block's gathered operand capped at ``block_elems`` elements (default:
    the routing lookup's ``spmm_block_elems``).  The cap schedules the
    blocks and changes no bit of the result.  ``splits`` is the kernel's,
    taken so the plain version can stand in for it, and changes nothing
    here."""
    if block_elems is None:
        block_elems, _ = routing.spmm_block_elems()
    gr = a.gr
    R_pad, nblocks, n = a.val.shape
    cols = a.gather_plan().cols
    Gr = cols.shape[0]
    K, N = b.shape
    b_p = _pad_rows(b, nblocks * a.m)
    val_g = a.val.reshape(Gr, gr, nblocks * n)
    gb = max(1, min(Gr, block_elems // max(1, nblocks * n * N)))
    out = torch.cat([_gather_block(b_p, cols[i:i + gb], val_g[i:i + gb])
                     for i in range(0, Gr, gb)])
    out = out.reshape(R_pad, N)[:a.canonical_rows()]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.T.contiguous() if transpose_out else out


def nmg_spmm(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False,
             splits: Optional[int] = None) -> torch.Tensor:
    """C = A_canonical @ B: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; f32 [R, N] unless ``out_dtype`` /
    ``transpose_out``.  ``splits`` (a tuning table's ``spmm_cuda``
    entry) is the kernel's K split count, None for the shape's own; one
    the kernel cannot take raises, as does any on the GEMV route of gr
    not a multiple of 64.  DTensor operands cross
    ``kernels/_dtensor.py``'s boundary (B's columns are the rows it keeps
    sharded)."""
    if _dtensor.any_dtensor(a, b):
        bl, (al,), loc = _dtensor.localize("nmg_spmm", b, (1,), (a,))
        return loc.wrap(nmg_spmm(al, bl, out_dtype=out_dtype,
                                 transpose_out=transpose_out, splits=splits),
                        {1: int(not transpose_out)})
    if _trace.RECORDER is not None:
        return _trace.as_node(
            "nmg_spmm", (a.val, a.gather_plan().cols, b), nmg_spmm, a, b,
            flops=product_flops([a], b), out_dtype=out_dtype,
            transpose_out=transpose_out, splits=splits)
    if b.device.type == "meta":
        return meta_out(a.canonical_rows(), b, out_dtype, transpose_out)
    if b.device.type == "cpu":
        return nmg_spmm_plain(a, b, out_dtype=out_dtype,
                              transpose_out=transpose_out)
    from repro_torch.kernels import _build

    if a.gr % _ROWS_PER_BLOCK:
        if splits is not None:
            raise ValueError(f"gr={a.gr} takes the GEMV route, which has no "
                             f"K split to set")
        (out,) = gemv_launch([a], b, out_dtype=out_dtype,
                             transpose_out=transpose_out, max_m=None)
        nmg_spmm.launches += 1
        return out
    check_operands([a], b)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, b.dtype):
        raise ValueError(f"output dtype {out_dtype} not taken for "
                         f"{b.dtype} inputs")
    K, N = b.shape
    R = a.canonical_rows()
    R_pad = a.val.shape[0]
    KN = a.val.shape[1] * a.val.shape[2]
    lib = _build.load("nmg_spmm")
    fn, splits_fn = lib.nmg_spmm_launch, lib.nmg_spmm_splits
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        splits_fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p]
                              + [ctypes.c_longlong] * 2 + [ctypes.c_int])
        splits_fn.restype = ctypes.c_int
    code = _DTYPE_CODE[b.dtype]
    out = torch.empty((N, R) if transpose_out else (R, N), dtype=out_dtype,
                      device=b.device)
    want = 0 if splits is None else int(splits)
    if want and want not in spmm_split_choices(KN, b.dtype, most=want):
        raise ValueError(f"the SpMM cannot cut K ({KN} stored values a row) "
                         f"into {want} splits")
    # K-split partials for shapes whose output tiles cannot fill the card
    splits = splits_fn(code, R_pad, N, KN, a.gr, b.data_ptr(), b.stride(0),
                       b.stride(1), want)
    # chunk geometry: cs stored values of a row cover cx rows of B
    cg = math.comb(a.m, a.n) * a.g
    ws = torch.empty((splits, R, N), dtype=torch.float32,
                     device=b.device) if splits > 1 else None
    err = fn(code, a.val.data_ptr(), a.gather_plan().cols.data_ptr(),
             b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
             None if ws is None else ws.data_ptr(), R, R_pad, K, KN, N, a.gr,
             a.n * cg, a.m * cg, int(out_dtype != torch.float32),
             int(transpose_out), want,
             torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmg_spmm launch failed: error {err}")
    nmg_spmm.launches += 1
    return out


nmg_spmm.launches = 0
