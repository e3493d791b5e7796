"""Decode-shaped n:m:g GEMV: ``C[R, M] = A_canonical[R, K] @ B[K, M]``
with M <= 16, or any M 16 columns at a time when a tuning table moves
the crossover past 16 (port of ``repro/kernels/nmg_gemv.py``).

:func:`nmg_gemv` launches the hand-written CUDA kernel
(``csrc/nmg_gemv.cu``) for CUDA tensors and takes the plain PyTorch version
:func:`nmg_gemv_plain` (the gather + einsum of
``repro/kernels/ops.py:nmg_gemv_xla``) only for tensors on the CPU.  There
is no fallback: a kernel that fails to build or launch raises.

f32 accumulation, one cast to ``out_dtype`` (default f32) in the epilogue;
``transpose_out=True`` writes [M, R] directly, the orientation
``nmg_linear`` wants.

The kernel has three bodies (``csrc/nmg_rows.cuh``); :func:`row_plan`
picks one from (gr, M, KN, dtype) alone, so the GEMV, the fused QKV launch
and the fused FFN (``nmg_fused.py``) run the same body at the same gr,
which keeps their bitwise contracts at every gr:

  ``tc``       bf16 with gr a multiple of 16 (the serving format): a block
               per 16/32/64-row tile of one fiber group and K part, the
               group's B gathered once into shared memory, ``val``
               streamed by 16-byte ``cp.async``, ``mma.sync`` products,
               the K parts of a tile one thread-block cluster;
  ``rows``     f32 with gr a multiple of 4: four rows of one group a block;
  ``general``  any other gr: each row reads its own group's plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import _trace

__all__ = ["nmg_gemv", "nmg_gemv_plain", "gemv_launch", "MAX_M",
           "RowPlan", "row_plan", "tc_parts_choices", "chunk_geometry"]

#: widest right operand the kernel takes (its register tile)
MAX_M = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: body codes of the C interfaces of ``csrc/nmg_gemv.cu`` / ``nmg_ffn.cu``
_BODY_CODE = {"rows": 0, "general": 1, "tc": 2}
#: stored values per slab of the ``tc`` body, and its cluster limit
_SLAB = 64
_MAX_PARTS = 8


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """A decode body and its shape: ``rows`` output rows per block (per
    row set), ``nt8`` n8 tiles of B columns, ``per`` slabs of 64 stored
    values per K part and ``parts`` K parts (the blocks of one cluster);
    the last three only for ``tc``."""

    body: str
    rows: int
    nt8: int = 0
    per: int = 0
    parts: int = 1

    def grid(self, R_pad: int, nseg: int = 1, N: int = 1) -> tuple:
        """The launch grid for ``R_pad`` rows (the longest segment), ``nseg``
        segments and ``N`` columns of B (taken 16 at a time)."""
        return (math.ceil(R_pad / self.rows) * self.parts, nseg,
                math.ceil(N / MAX_M))

    def args(self) -> tuple:
        return (_BODY_CODE[self.body], self.rows, self.nt8, self.per,
                self.parts)


def row_plan(gr: int, M: int, KN: int, dtype, config=None) -> RowPlan:
    """The decode body for weights of row group ``gr`` with ``KN`` stored
    values a row, against ``M`` columns of B (more than 16 are taken 16 at
    a time), in ``dtype``.  A function of these four alone, never of the
    row count: the GEMV, the fused QKV launch and the FFN get the same
    body, and so the same per-row summation order, at the same shape,
    which keeps their bitwise contracts at every gr.

    bf16 at gr a multiple of 16 takes ``tc``: 64-, 32- or 16-row tiles
    (the largest that divides gr, so a tile never spans two groups), one
    or two n8 tiles for M, and K cut into up to eight parts (one cluster)
    of about two slabs each, so that even bert-base-sten's few fiber
    groups put blocks on most SMs and a part's ring and gathered B stay
    small enough for several blocks an SM; f32 at gr a multiple of 4
    takes ``rows``; any other gr takes ``general``.

    ``config`` (a tuning table's ``gemv_cuda`` entry, ``{rows, parts}``)
    replaces the ``tc`` body's tile rows and K parts; it is keyed by
    (K, format, gr, dtype), never by R, so the contracts above hold under
    any table.  The ``rows`` and ``general`` bodies take only their own
    ``{rows: 4, parts: 1}``.  A config the kernel cannot take raises."""
    if gr < 1 or M < 1 or KN < 1:
        raise ValueError(f"no decode body for gr={gr}, M={M}, KN={KN}")
    if dtype == torch.bfloat16 and gr % 16 == 0:
        nslab = math.ceil(KN / _SLAB)
        rows = next(r for r in (64, 32, 16) if gr % r == 0)
        per = math.ceil(nslab / min(_MAX_PARTS, math.ceil(nslab / 2)))
        if config is not None:
            rows, parts = int(config["rows"]), int(config["parts"])
            if rows not in (16, 32, 64) or gr % rows:
                raise ValueError(f"tc body takes 16, 32 or 64 rows dividing "
                                 f"gr={gr}, not {rows}")
            if parts not in tc_parts_choices(KN):
                raise ValueError(f"tc body cannot cut {nslab} slabs into "
                                 f"{parts} parts")
            per = math.ceil(nslab / parts)
        return RowPlan("tc", rows, nt8=1 if min(M, MAX_M) <= 8 else 2,
                       per=per, parts=math.ceil(nslab / per))
    body = "rows" if dtype == torch.float32 and gr % 4 == 0 else "general"
    if config is not None and (int(config["rows"]), int(config["parts"])) \
            != (4, 1):
        raise ValueError(f"the {body} body takes only rows=4, parts=1, "
                         f"not {config}")
    return RowPlan(body, 4)


def tc_parts_choices(KN: int) -> list:
    """The K part counts the ``tc`` body takes for ``KN`` stored values a
    row: 1 to 8 parts of equal slab counts, none empty."""
    nslab = math.ceil(KN / _SLAB)
    return [p for p in range(1, min(_MAX_PARTS, nslab) + 1)
            if math.ceil(nslab / math.ceil(nslab / p)) == p]


def chunk_geometry(w: GroupedNMTensor) -> tuple:
    """(cs, cx): a chunk's cs stored values of a row cover cx consecutive
    rows of B (the K axis), for every chunk and fiber group."""
    cg = math.comb(w.m, w.n) * w.g
    return w.n * cg, w.m * cg


def _pad_rows(b: torch.Tensor, K_pad: int) -> torch.Tensor:
    return F.pad(b, (0, 0, 0, K_pad - b.shape[0])) if K_pad > b.shape[0] \
        else b


def nmg_gemv_plain(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
                   transpose_out: bool = False, config=None,
                   max_m=None) -> torch.Tensor:
    """Plain version: one gather of the planned B rows + one f32 einsum,
    any width.  ``config`` and ``max_m`` are the kernel's, taken so the
    plain version can stand in for it, and change nothing here."""
    gr = a.gr
    R_pad, nblocks, n = a.val.shape
    cols = a.gather_plan().cols                      # [Gr, nblocks*n]
    Gr = cols.shape[0]
    K, M = b.shape
    b_p = _pad_rows(b, nblocks * a.m)
    xg = b_p[cols.reshape(-1).long()].reshape(Gr, nblocks * n, M)
    val_g = a.val.reshape(Gr, gr, nblocks * n)
    R = a.canonical_rows()
    spec = "grk,gkm->mgr" if transpose_out else "grk,gkm->grm"
    out = torch.einsum(spec, val_g.float(), xg.float())
    out = out.reshape(M, R_pad)[:, :R] if transpose_out \
        else out.reshape(R_pad, M)[:R]
    return out if out_dtype is None else out.to(out_dtype)


def check_operands(ws, b: torch.Tensor, *, max_m=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if b.device.type != "cuda":
        raise ValueError(f"kernel operand B lies on {b.device}, not CUDA")
    if b.ndim != 2 or b.dtype not in _DTYPE_CODE:
        raise ValueError(f"B must be 2-D float32/bfloat16, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if max_m is not None and not 1 <= b.shape[1] <= max_m:
        raise ValueError(f"GEMV takes 1..{max_m} columns, got {b.shape[1]}")
    for w in ws:
        if not isinstance(w, GroupedNMTensor) or w.stacked:
            raise ValueError("kernel weights must be one layer of a "
                             "GroupedNMTensor")
        cols = w.gather_plan().cols
        if w.val.device != b.device or cols.device != b.device:
            raise ValueError("weight and B lie on different devices")
        if w.val.dtype != b.dtype:
            raise ValueError(f"val dtype {w.val.dtype} != B dtype {b.dtype}")
        if not (w.val.is_contiguous() and cols.is_contiguous()):
            raise ValueError("val and plan.cols must be contiguous")
        if cols.dtype != torch.int32:
            raise ValueError(f"plan.cols must be int32, got {cols.dtype}")
        K = w.dense_shape[w.sparse_dim % 2]
        if K != b.shape[0]:
            raise ValueError(f"B has {b.shape[0]} rows, weight K is {K}")


def gemv_launch(ws, b: torch.Tensor, *, out_dtype=None,
                transpose_out: bool = False, max_m=MAX_M,
                config=None) -> tuple:
    """One CUDA launch over up to three weights sharing B (one segment
    each); returns one output per weight.  B's columns are taken 16 at a
    time, so ``max_m=None`` lets the SpMM route, and a routed GEMV past
    16 columns, take any width through the same bodies.  ``config`` is
    :func:`row_plan`'s.  Callers count the launch."""
    from repro_torch.kernels import _build

    check_operands(ws, b, max_m=max_m)
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"the GEMV kernel takes 1..3 segments, got {len(ws)}")
    w0 = ws[0]
    KN = w0.val.shape[1] * w0.val.shape[2]
    for w in ws:
        if (w.n, w.m, w.g, w.gr) != (w0.n, w0.m, w0.g, w0.gr) or \
                w.val.shape[1:] != w0.val.shape[1:]:
            raise ValueError("fused segments must share format and K")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, b.dtype):
        raise ValueError(f"output dtype {out_dtype} not taken for "
                         f"{b.dtype} inputs")
    K, M = b.shape
    plan = row_plan(w0.gr, M, KN, b.dtype, config)
    outs, segs = [], []
    for w in ws:
        R = w.canonical_rows()
        o = torch.empty((M, R) if transpose_out else (R, M),
                        dtype=out_dtype, device=b.device)
        outs.append(o)
        segs.append((w.val.data_ptr(), w.gather_plan().cols.data_ptr(),
                     o.data_ptr(), R, w.val.shape[0]))
    while len(segs) < 3:
        segs.append((None, None, None, 0, 0))
    lib = _build.load("nmg_gemv")
    fn = lib.nmg_gemv_launch
    if fn.argtypes is None:
        seg_t = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        fn.argtypes = ([ctypes.c_int] * 8 + seg_t * 3
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    flat = [v for s in segs for v in s]
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = fn(*plan.args(), _DTYPE_CODE[b.dtype],
             int(out_dtype == torch.float32), len(ws),
             *flat, b.data_ptr(), b.stride(0), b.stride(1), K, KN, M, w0.gr,
             *chunk_geometry(w0), int(transpose_out), stream)
    if err != 0:
        raise RuntimeError(f"nmg_gemv launch failed: error {err}")
    return tuple(outs)


def nmg_gemv(a: GroupedNMTensor, b: torch.Tensor, *, out_dtype=None,
             transpose_out: bool = False, config=None,
             max_m=MAX_M) -> torch.Tensor:
    """C = A_canonical @ B for narrow B: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``config`` is :func:`row_plan`'s;
    ``max_m=None`` takes any width (16 columns at a time)."""
    if _trace.RECORDER is not None:
        return _trace.as_node(
            "nmg_gemv", (a.val, a.gather_plan().cols, b), nmg_gemv, a, b,
            out_dtype=out_dtype, transpose_out=transpose_out, config=config,
            max_m=max_m)
    if b.device.type == "cpu":
        return nmg_gemv_plain(a, b, out_dtype=out_dtype,
                              transpose_out=transpose_out)
    (out,) = gemv_launch([a], b, out_dtype=out_dtype,
                         transpose_out=transpose_out, max_m=max_m,
                         config=config)
    nmg_gemv.launches += 1
    return out


nmg_gemv.launches = 0
