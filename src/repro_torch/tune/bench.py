"""Timing harness and tuners: the measurements behind the tuning table
(port of ``repro/tune/bench.py``).

One timing function (:func:`time_us`) and one width sweep
(:func:`sweep_m`) serve the ``python -m repro_torch.tune`` CLI and the
serving warmup hook (:func:`autotune_for_serving`).  On CUDA tensors
:func:`time_us` reports device time from CUDA events, as
``chip_smoke.py:time_ms`` does: the L2 is flushed and the device kept
busy (a short spin) before each timed launch, so the events bracket the
kernel and not the host's launch cost, which a replayed CUDA graph does
not pay.  On the CPU it keeps the reference's wall-clock loop.

Every tuner mutates a :class:`~repro_torch.tune.table.TuningTable` in
place and returns what it measured; persistence and activation are the
caller's.  The tuners put the launch counters back when they finish
(``kernels/ops.py:counter_snapshot`` / ``restore_counters``), so sweeps
never show in a run's launch accounting.  Probe weights come from a
seeded ``torch.Generator`` on the device they are timed on.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import time
from typing import Iterable, Optional, Sequence

import torch

from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.device import resolve_device
from repro_torch.tune import routing
from repro_torch.tune.table import TuningTable, bucket, shape_key

__all__ = [
    "time_us",
    "sweep_m",
    "measured_crossover",
    "tune_decode_threshold",
    "tune_spmm_block",
    "tune_gemv_cuda",
    "tune_spmm_cuda",
    "tune_fused_qkv",
    "tune_fused_ffn",
    "tune_conversion_costs",
    "autotune_for_serving",
]

#: device spin before each timed launch: ~0.25 ms at the H100's ~1.98 GHz
#: boost clock, longer than the host needs to enqueue one routed call
_SPIN_CYCLES = 500_000
#: a write of this size evicts the H100's 50 MB L2
_FLUSH_BYTES = 64 << 20
_FLUSH: dict = {}

#: a candidate config replaces the kernel's own only when it is faster by
#: more than this fraction (timing noise must not flip configs)
_TOL = 0.05


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, (torch.Tensor, GroupedNMTensor)):
            return a.device
    return torch.device("cpu")


def time_us(fn, *args, reps: int = 5, inner: int = 5,
            device=None) -> float:
    """Median time of one call of ``fn(*args)`` in us.  On a CUDA device
    (``device``, else the first tensor among ``args``): device time of
    ``reps * inner`` single launches from CUDA events, each after an L2
    flush and a device spin.  On the CPU: the median over ``reps`` of the
    wall time of ``inner`` back-to-back calls.  A first untimed call
    absorbs builds and allocator growth."""
    dev = torch.device(device) if device is not None else _device_of(args)
    fn(*args)
    if dev.type != "cuda":
        best = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            best.append((time.perf_counter() - t0) / inner)
        best.sort()
        return best[len(best) // 2] * 1e6
    with torch.cuda.device(dev):
        flush = _FLUSH.get(dev)
        if flush is None:
            flush = _FLUSH[dev] = torch.empty(_FLUSH_BYTES, dtype=torch.uint8,
                                              device=dev)
        n = reps * inner
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for s, e in zip(starts, ends):
            flush.zero_()
            torch.cuda._sleep(_SPIN_CYCLES)
            s.record()
            fn(*args)
            e.record()
        torch.cuda.synchronize(dev)
        return statistics.median(
            s.elapsed_time(e) for s, e in zip(starts, ends)) * 1e3


@contextlib.contextmanager
def _counters_kept():
    """Run a sweep without leaving its calls in the launch counters."""
    from repro_torch.kernels import ops as kops

    snap = kops.counter_snapshot()
    try:
        yield
    finally:
        kops.restore_counters(snap)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _activation(K: int, M: int, dtype, device, seed: int) -> torch.Tensor:
    """B = x.T of a token-major x [M, K], the operand the router sees."""
    x = torch.randn(M, K, generator=_gen(device, seed), device=device)
    return x.to(dtype).T


def sweep_m(t: GroupedNMTensor, ms: Sequence[int], *, seed: int = 0,
            reps: int = 5, dtype=torch.float32,
            gate: Optional[str] = None) -> list[dict]:
    """Time the GEMV and SpMM paths for right operands [K, M] over the
    widths ``ms``; returns one ``{"path", "M", "us"}`` per (path, M).  (The
    reference also times a dense path, for its fig6 benchmark, which the
    port has not ported.)

    What is timed is what the router chooses between in ``nmg_linear``:
    the routed ``nmg_gemv`` and ``nmg_spmm`` entry points (with the active
    table's kernel configs), each writing [M, R] in ``dtype``, on
    B = x.T.

    With ``gate`` (the activation of a packed gated-MLP weight) each path
    is what the model runs for that weight on its side of the crossover:
    the GEMV side the fused FFN launch where the router would fuse (up to
    16 columns, under the ``fused_ffn`` lookup) and else the GEMV followed
    by the gate, the SpMM side the SpMM followed by the gate."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.nmg_fused import act_fn

    dt = dtype
    ctx = kops._route_ctx(t, dt)

    def gated(y):
        if gate is None:
            return y
        u, v = y.chunk(2, dim=-1)
        return act_fn(gate)(u) * v

    def gemv(a, b):
        if gate is not None and b.shape[1] <= kops.MAX_M and \
                kops._ffn_eligible(a) and routing.fused_ffn(**ctx)[0]:
            return kops.nmg_ffn(a, b, act=gate, out_dtype=dt,
                                transpose_out=True)
        return gated(kops.nmg_gemv(a, b, out_dtype=dt, transpose_out=True))

    paths = [
        ("gemv", gemv),
        ("spmm", lambda a, b: gated(kops.nmg_spmm(a, b, out_dtype=dt,
                                                  transpose_out=True))),
    ]
    records = []
    with _counters_kept():
        for m in ms:
            b = _activation(ctx["K"], m, dt, t.val.device, seed + m)
            for name, fn in paths:
                records.append({"path": name, "M": int(m),
                                "us": time_us(fn, t, b, reps=reps)})
    return records


def measured_crossover(records: Iterable[dict], *, tol: float = 0.05) -> int:
    """The widest M (scanning the sweep upward) at which the GEMV is still
    no slower than the SpMM, within ``tol``: the measured ``decode_m_max``.
    0 means the GEMV never won.  One losing M does not end the scan; two
    in a row, or a loss closing the sweep, do."""
    gemv = {r["M"]: r["us"] for r in records if r["path"] == "gemv"}
    spmm = {r["M"]: r["us"] for r in records if r["path"] == "spmm"}
    crossover = 0
    losses = 0
    for m in sorted(gemv.keys() & spmm.keys()):
        if gemv[m] <= spmm[m] * (1.0 + tol):
            crossover = m
            losses = 0
        else:
            losses += 1
            if losses >= 2:
                break
    return crossover


# ---------------------------------------------------------------------------
# tuners: measure -> table entry
# ---------------------------------------------------------------------------


def _probe_tensor(K: int, R: int, fmt: tuple, gr: int, dtype=torch.float32,
                  device="cuda", seed: int = 0) -> GroupedNMTensor:
    """Random probe weight [K, R] sparse along K (the serving orientation,
    which the fused launches require) in the dtype under test: the
    stored-value dtype sets the bytes a kernel moves.  On the card unless
    ``device`` says otherwise (raises without one)."""
    from repro_torch.core.nmg import dense_to_grouped_nm

    device = resolve_device(device)
    n, m, g = fmt
    w = torch.randn(K, R, generator=_gen(device, seed), device=device)
    return dense_to_grouped_nm(w.to(dtype), n, m, g, gr=gr, sparse_dim=0)


def tune_decode_threshold(table: TuningTable, *, K: int, R: int, fmt: tuple,
                          gr: int, dtype=torch.float32,
                          ms: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
                          reps: int = 5, t=None, seed: int = 0,
                          device=None, gate: Optional[str] = None) -> int:
    """Measure the GEMV/SpMM crossover for one (shape bucket, format) and
    record it as the bucket's ``decode_m_max``; each swept width's
    best-path time also lands in the bucket's
    ``matmul_latency/.../M{bucket}`` entry (best over the widths sharing a
    bucket).  ``t`` replaces the probe weight; ``device`` defaults to the
    card when there is one; ``gate`` sweeps a packed gated-MLP weight with
    its gate (:func:`sweep_m`), so its entries time the gated op."""
    if t is None:
        dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
        t = _probe_tensor(K, R, fmt, gr, dtype, dev, seed)
    records = sweep_m(t, ms, seed=seed, reps=reps, dtype=dtype, gate=gate)
    crossover = measured_crossover(records)
    table.put(shape_key("decode_m_max", K=K, R=R, fmt=fmt, gr=gr,
                        dtype=dtype), crossover)
    best_by_bucket: dict = {}
    for r in records:
        b = bucket(int(r["M"]))
        best_by_bucket[b] = min(best_by_bucket.get(b, float("inf")), r["us"])
    lat_key = shape_key("matmul_latency", K=K, R=R, fmt=fmt, gr=gr,
                        dtype=dtype)
    for b, us in best_by_bucket.items():
        table.put(f"{lat_key}/M{b}", us)
    return crossover


def tune_spmm_block(table: TuningTable, *, K: int = 4096, R: int = 4096,
                    N: int = 256, fmt: tuple = (1, 4, 8), gr: int = 64,
                    candidates: Sequence[int] = (1 << 18, 1 << 20, 1 << 22,
                                                 1 << 24),
                    reps: int = 5, device="cpu") -> int:
    """Sweep the plain SpMM's gathered-block cap and record the fastest as
    the device-wide ``spmm_block_elems``.  The probe's per-group gather
    ((K/m) * n * N = 2^18 elements at the defaults) times its R/gr = 64
    fiber groups makes each candidate a different blocking.  The plain
    SpMM serves the CPU only (on the card the SpMM is the CUDA kernel,
    which has no block cap), so this tuner defaults to the CPU, unlike
    the others, and the CLI runs it only there."""
    from repro_torch.kernels.nmg_spmm import nmg_spmm_plain

    t = _probe_tensor(K, R, fmt, gr, torch.float32, device, seed=1)
    b = torch.randn(K, N, generator=_gen(device, 2), device=device)
    best, best_us = None, float("inf")
    for cand in candidates:
        us = time_us(lambda a, bb, c=int(cand): nmg_spmm_plain(
            a, bb, block_elems=c), t, b, reps=reps)
        if us < best_us:
            best, best_us = int(cand), us
    table.put("spmm_block_elems", best)
    return best


def _pick(timed: list, default) -> tuple:
    """(config, us) of the fastest candidate, the kernel's own ``default``
    kept unless another beats it by more than ``_TOL``."""
    best, best_us = min(timed, key=lambda c: c[1])
    own = next(us for cfg, us in timed if cfg == default)
    return (best, best_us) if best_us < own * (1.0 - _TOL) else (default, own)


def tune_gemv_cuda(table: TuningTable, *, K: int = 1024, R: int = 1024,
                   M: int = 8, fmt: tuple = (1, 4, 8), gr: int = 64,
                   dtype=torch.bfloat16, rows: Sequence[int] = (16, 32, 64),
                   reps: int = 3, device="cuda",
                   ops: Optional[Sequence[tuple]] = None) -> dict:
    """Sweep the decode body's ``{rows, parts}`` (every tile height in
    ``rows`` that divides gr, every K part count the body takes) at width
    ``M`` and record the fastest as the bucket's ``gemv_cuda`` entry.
    The key has no R, so every decode launch at this K, format, gr and
    dtype reads it: ``ops`` lists those launches, ``("gemv", R)``,
    ``("qkv", (Rq, Rk, Rv))`` (the fused QKV launch) or ``("ffn", 2F)``
    (the fused gated FFN), default ``(("gemv", R),)``, and the config
    with the least summed time over them wins.  The body's own plan stays
    unless a candidate beats it by more than 5%.  The ``rows`` and
    ``general`` bodies have one config, ``{rows: 4, parts: 1}``.  Needs
    the card (the kernels' launches)."""
    from repro_torch.kernels import nmg_fused
    from repro_torch.kernels import nmg_gemv as gemv

    if torch.device(device).type != "cuda":
        raise ValueError("tune_gemv_cuda times the CUDA kernel: pass a "
                         "CUDA device")
    b = _activation(K, M, dtype, device, seed=4)
    launches = []
    for i, (kind, width) in enumerate(ops or (("gemv", R),)):
        ws = tuple(_probe_tensor(K, r, fmt, gr, dtype, device,
                                 seed=3 + 10 * i + j)
                   for j, r in enumerate(
                       width if kind == "qkv" else (width,)))
        if kind == "qkv":
            launches.append(lambda c, ws=ws: nmg_fused.nmg_qkv(
                ws, b, out_dtype=dtype, transpose_out=True, config=c))
        elif kind == "ffn":
            launches.append(lambda c, w=ws[0]: nmg_fused.nmg_ffn(
                w, b, out_dtype=dtype, transpose_out=True, config=c))
        else:
            launches.append(lambda c, w=ws[0]: gemv.nmg_gemv(
                w, b, out_dtype=dtype, transpose_out=True, config=c))
    KN = ws[0].val.shape[1] * ws[0].val.shape[2]   # one K: one KN
    own = gemv.row_plan(gr, M, KN, dtype)
    default = {"rows": own.rows, "parts": own.parts}
    cands = [default]
    if own.body == "tc":
        cands += [{"rows": r, "parts": p} for r in rows if gr % r == 0
                  for p in gemv.tc_parts_choices(KN)
                  if {"rows": r, "parts": p} != default]
    timed = []
    with _counters_kept():
        for cfg in cands:
            timed.append((cfg, sum(time_us(fn, cfg, reps=reps,
                                           device=device)
                                   for fn in launches)))
    best, _ = _pick(timed, default)
    table.put(routing.gemv_cuda_key(K=K, fmt=fmt, gr=gr, dtype=dtype), best)
    return best


def tune_spmm_cuda(table: TuningTable, *, K: int = 1024, R: int = 1024,
                   Ns: Sequence[int] = (256,), fmt: tuple = (1, 4, 8),
                   gr: int = 64, dtype=torch.bfloat16, most: int = 8,
                   reps: int = 3, device="cuda") -> dict:
    """Sweep the SpMM's K split (its own, and 1 to ``most`` splits the
    kernel takes) over the widths ``Ns`` and record the one with the least
    summed time as the bucket's ``spmm_cuda`` entry (``{"splits": None}``
    keeps the kernel's own, which depends on N).  The own split stays
    unless a candidate beats it by more than 5%.  Needs the card and gr a
    multiple of 64 (other gr take the GEMV route, with no split)."""
    from repro_torch.kernels import nmg_spmm as spmm

    if torch.device(device).type != "cuda" or gr % 64:
        raise ValueError("tune_spmm_cuda times the CUDA SpMM body: pass a "
                         "CUDA device and gr a multiple of 64")
    t = _probe_tensor(K, R, fmt, gr, dtype, device, seed=5)
    bs = [_activation(K, N, dtype, device, seed=6 + N) for N in Ns]
    KN = t.val.shape[1] * t.val.shape[2]
    cands = [None] + spmm.spmm_split_choices(KN, dtype, most=most)
    timed = []
    with _counters_kept():
        for z in cands:
            timed.append(({"splits": z}, sum(time_us(
                lambda a, bb, z=z: spmm.nmg_spmm(
                    a, bb, out_dtype=dtype, transpose_out=True, splits=z),
                t, b, reps=reps) for b in bs)))
    best, _ = _pick(timed, {"splits": None})
    table.put(shape_key("spmm_cuda", K=K, R=R, fmt=fmt, gr=gr, dtype=dtype),
              best)
    return best


def _interleaved_best(fns: dict, arg, reps: int, inner: int) -> dict:
    """Best-of-three rounds of each timing, interleaved: a decision that
    hinges on a few us of launch cost must not fall to one noisy round."""
    got = {k: float("inf") for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            got[k] = min(got[k], time_us(fn, arg, reps=reps, inner=inner))
    return got


def tune_fused_qkv(table: TuningTable, *, K: int = 256,
                   Rs: Sequence[int] = (256, 256, 256),
                   fmt: tuple = (1, 4, 8), gr: int = 64, M: int = 4,
                   dtype=torch.float32, reps: int = 3, device=None) -> bool:
    """Time the fused QKV launch against the per-projection GEMV at a
    decode width and record the winner as the bucket's ``fused_qkv``
    (keyed by the group's summed rows, as the router's fused context)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.nmg_fused import fusable_qkv

    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    ws = tuple(_probe_tensor(K, R, fmt, gr, dtype, dev, seed=7 + i)
               for i, R in enumerate(Rs))
    if not fusable_qkv(ws):
        raise ValueError(f"no fused QKV launch for K={K}, Rs={Rs}, gr={gr}")
    b = _activation(K, M, dtype, dev, seed=9)
    with _counters_kept():
        got = _interleaved_best({
            "fused": lambda bb: kops.nmg_qkv(ws, bb, out_dtype=dtype,
                                             transpose_out=True),
            "sequential": lambda bb: tuple(
                kops.nmg_gemv(w, bb, out_dtype=dtype, transpose_out=True)
                for w in ws)}, b, reps, 20)
    win = bool(got["fused"] <= got["sequential"])
    table.put(shape_key("fused_qkv", K=K, R=sum(int(r) for r in Rs), fmt=fmt,
                        gr=gr, dtype=dtype), win)
    return win


def tune_fused_ffn(table: TuningTable, *, K: int = 256, F: int = 512,
                   fmt: tuple = (1, 4, 8), gr: int = 64, M: int = 4,
                   act: str = "silu", dtype=torch.float32, reps: int = 3,
                   device=None) -> bool:
    """Time the fused gated-FFN launch (packed [K, 2F] weight) against the
    sequential projection, split, act and multiply at a decode width and
    record the winner as the bucket's ``fused_ffn``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.nmg_fused import act_fn

    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    w = _probe_tensor(K, 2 * F, fmt, gr, dtype, dev, seed=10)
    if not kops._ffn_eligible(w):
        raise ValueError(f"no fused FFN launch for K={K}, F={F}, gr={gr}")
    b = _activation(K, M, dtype, dev, seed=11)

    def sequential(bb):
        u, v = kops.nmg_gemv(w, bb, out_dtype=dtype,
                             transpose_out=True).chunk(2, dim=-1)
        return act_fn(act)(u) * v

    with _counters_kept():
        got = _interleaved_best({
            "fused": lambda bb: kops.nmg_ffn(w, bb, act=act, out_dtype=dtype,
                                             transpose_out=True),
            "sequential": sequential}, b, reps, 20)
    win = bool(got["fused"] <= got["sequential"])
    table.put(shape_key("fused_ffn", K=K, R=2 * F, fmt=fmt, gr=gr,
                        dtype=dtype), win)
    return win


def tune_conversion_costs(table: TuningTable, *, side: int = 256,
                          reps: int = 3, device="cuda") -> dict:
    """Measure the lossless conversions among the interchange layouts
    (Dense, Csr, Coo, FixedMask) on ``device`` (the card unless told
    otherwise; raises without one) and record them as
    ``convert_cost/<src>-><dst>`` (us); the dispatcher's tie-breaker reads
    them through :func:`repro_torch.tune.routing.conversion_cost`."""
    conv = importlib.import_module("repro_torch.core.convert")
    from repro_torch.core.layouts import CooTensor, CsrTensor, \
        DenseTensor, FixedMaskTensor

    device = resolve_device(device)
    g = _gen(device, 12)
    x = torch.randn(side, side, generator=g, device=device)
    x = x * (torch.rand(side, side, generator=g, device=device) < 0.25)
    insts = {DenseTensor: conv.as_layout(x)}
    for cls in (CsrTensor, CooTensor, FixedMaskTensor):
        insts[cls] = conv.convert(insts[DenseTensor], cls)
    measured = {}
    with _counters_kept():
        for src_cls, inst in insts.items():
            for dst_cls in conv.lossless_targets(src_cls):
                if dst_cls is src_cls or dst_cls not in insts:
                    continue
                us = time_us(lambda i=inst, d=dst_cls: conv.convert(i, d),
                             reps=reps, inner=3, device=device)
                k = f"convert_cost/{src_cls.__name__}->{dst_cls.__name__}"
                table.put(k, us)
                measured[k] = us
    return measured


# ---------------------------------------------------------------------------
# serving warmup hook: tune the engine's actual shapes
# ---------------------------------------------------------------------------


def _one_layer(w: GroupedNMTensor) -> GroupedNMTensor:
    return w.layer(0) if w.stacked else w


def _walk(tree):
    """Every dict of ``tree`` (params are nested dicts)."""
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _walk(v)


def autotune_for_serving(params, *, max_slots: int, prompt_lens: Sequence[int],
                         dtype=None, reps: int = 3,
                         table: Optional[TuningTable] = None,
                         activate: bool = True, gated_act=None) -> TuningTable:
    """Tune the routing for the n:m:g weights an engine will serve.

    For the distinct shapes and formats among ``params``'
    :class:`GroupedNMTensor` leaves (one layer of a stacked leaf), each on
    a seeded probe of its shape, in this order: on the card the decode
    body's config at ``max_slots`` (one per R-free key, over every output
    width that reads it); each attention group's (``wq``, ``wk``, ``wv``)
    ``fused_qkv`` decision and, with ``gated_act`` (the model's gated-MLP
    activation), each packed ``wi``'s ``fused_ffn``, both at
    ``max_slots``; then each shape's GEMV/SpMM crossover over the widths
    the engine produces (``max_slots`` rows a decode step, one
    ``prompt_len`` block an admission) and the powers of two around them
    (the packed ``wi`` with its gate, so the fused FFN it would lose is
    weighed), and on the card, for gr a multiple of 64, the SpMM's K
    split over the prompt lengths past that crossover.  Entries land in
    ``table`` (default: the active table, or a new one), which is active
    while it fills (each sweep times the configs chosen before it) and
    stays active with ``activate``, so the programs the engine builds next
    route through it."""
    if table is None:
        table = routing.active_table() or TuningTable.for_device()
    before = routing.active_table()
    routing.set_active_table(table)
    try:
        _autotune(table, params, max_slots, prompt_lens, dtype, reps,
                  gated_act)
    finally:
        routing.set_active_table(table if activate else before)
    return table


def _autotune(table, params, max_slots, prompt_lens, dtype, reps, gated_act):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.nmg_fused import fusable_qkv

    def ctx_of(w):
        return kops._route_ctx(w, dtype if dtype is not None
                               else w.val.dtype)

    ms = sorted({1, 2, 4, 8, 16, 32, int(max_slots),
                 *(int(p) for p in prompt_lens)})
    # (decode_m_max key, gate) -> (weight, ctx); fused QKV key -> (ws, ctx);
    # gemv_cuda key -> (ctx, device, [decode launches that read it])
    weights, groups, launches = {}, {}, {}

    def launch(ctx, device, op):
        ops = launches.setdefault(routing.gemv_cuda_key(**ctx),
                                  (ctx, device, []))[2]
        if op not in ops:
            ops.append(op)
    for d in _walk(params):
        qkv = ()
        if all(isinstance(d.get(k), GroupedNMTensor)
               for k in ("wq", "wk", "wv")):
            ws = tuple(_one_layer(d[k]) for k in ("wq", "wk", "wv"))
            if fusable_qkv(ws):
                qkv = ("wq", "wk", "wv")
                ctx = kops._fused_ctx(ws, ctx_of(ws[0])["dtype"])
                groups.setdefault(shape_key("fused_qkv", **ctx), (ws, ctx))
                launch(ctx, ws[0].val.device,
                       ("qkv", tuple(w.canonical_rows() for w in ws)))
        for name, leaf in d.items():
            if not isinstance(leaf, GroupedNMTensor):
                continue
            w = _one_layer(leaf)
            ctx = ctx_of(w)
            # the packed gated weight is timed with its gate
            gate = gated_act if gated_act is not None and name == "wi" \
                and kops._ffn_eligible(w) else None
            weights.setdefault((shape_key("decode_m_max", **ctx), gate),
                               (w, ctx))
            if name not in qkv:
                launch(ctx, w.val.device, ("ffn" if gate else "gemv",
                                           ctx["R"]))

    # 1. the decode bodies' configs: one per R-free key, timed over every
    #    decode launch that reads it
    for ctx, dev, ops in launches.values():
        if dev.type == "cuda":
            tune_gemv_cuda(table, K=ctx["K"], M=int(max_slots),
                           fmt=ctx["fmt"], gr=ctx["gr"], dtype=ctx["dtype"],
                           reps=reps, device=dev, ops=ops)
    # 2. the fused decisions at the decode width
    for (_, gate), (w, ctx) in weights.items():
        if gate is not None:
            tune_fused_ffn(table, K=ctx["K"], F=ctx["R"] // 2, fmt=ctx["fmt"],
                           gr=ctx["gr"], M=int(max_slots), act=gate,
                           dtype=ctx["dtype"], reps=reps,
                           device=w.val.device)
    for ws, ctx in groups.values():
        tune_fused_qkv(table, K=ctx["K"], Rs=[w.canonical_rows() for w in ws],
                       fmt=ctx["fmt"], gr=ctx["gr"], M=int(max_slots),
                       dtype=ctx["dtype"], reps=reps, device=ws[0].val.device)
    # 3. the crossovers, then the SpMM's split over the prompts past them
    split_keys = set()
    for (_, gate), (w, ctx) in weights.items():
        dev = w.val.device
        thr = tune_decode_threshold(table, ms=ms, reps=reps, device=dev,
                                    gate=gate, **ctx)
        wide = sorted({int(p) for p in prompt_lens if int(p) > thr})
        key = shape_key("spmm_cuda", **ctx)
        if dev.type == "cuda" and ctx["gr"] % 64 == 0 and wide and \
                key not in split_keys:
            split_keys.add(key)
            tune_spmm_cuda(table, Ns=wide, reps=reps, device=dev, **ctx)

