"""Routing layer: table lookups with shipped defaults (port of
``repro/tune/routing.py``).

This module owns the shipped defaults and answers every routing question
the port's router (``kernels/ops.py``) and dispatcher ask:

* :func:`decode_m_max` — the GEMV/SpMM crossover width ``nmg_matmul`` /
  ``nmg_linear`` route on,
* :func:`spmm_block_elems` — the gathered-operand cap of one block of the
  plain SpMM (``kernels/nmg_spmm.py:nmg_spmm_plain``),
* :func:`gemv_cuda_config` — the decode ``tc`` body's ``{rows, parts}``
  (``kernels/nmg_gemv.py:RowPlan``): output rows a block and K parts (the
  blocks of one thread-block cluster),
* :func:`spmm_cuda_config` — the SpMM's ``{splits}``, its K-split count,
* :func:`fused_qkv` / :func:`fused_ffn` — whether eligible decode groups
  fuse into one launch,
* :func:`matmul_latency_us` — the measured best-path latency at a width,
* :func:`conversion_cost` — measured lossless-conversion costs for the
  dispatcher's tie-breaker (``core/dispatch.py``).

The reference's Pallas configs (``tm`` / ``target_depth`` of the GEMV;
``tn`` / ``target_depth`` / ``stream`` of the SpMM) have no counterpart:
the CUDA kernels have one schedule and one summation order each, and
their knobs are the two configs above.  ``gemv_cuda`` is keyed without
R (``gemv_cuda/K{b}/{n}:{m}:{g}/gr{gr}/{dtype}``), where the reference
keys its GEMV config by the fused group's summed R: the GEMV, the fused
QKV launch and the FFN then read one entry, so they run one body and
keep their bitwise contracts under any table.

Each lookup returns ``(value, source)``, ``source`` being ``"table"`` for
a hit in the active :class:`~repro_torch.tune.table.TuningTable` and
``"default"`` otherwise.  With no active table every answer is the
shipped default, which is what the port routed on before tables.

The reference reads its lookups when JAX traces a program.  The port
reads them at every call, and a CUDA graph (``serve/graphs.py``) freezes
the route and config that were active when it was captured: activate a
table before the engine's programs are built (``serve/engine.py:
warmup_engine(tune=True)`` tunes first, then warms); a table activated
later changes nothing that was captured.
"""

from __future__ import annotations

import collections
import importlib
import os
import sys
import warnings
from typing import Optional

from repro_torch.tune.table import TuningTable, bucket, dtype_name, \
    shape_key

__all__ = [
    "DEFAULT_DECODE_M_MAX",
    "DEFAULT_SPMM_BLOCK_ELEMS",
    "DEFAULT_GEMV_CUDA",
    "DEFAULT_SPMM_CUDA",
    "DEFAULT_FUSED_QKV",
    "DEFAULT_FUSED_FFN",
    "ENV_TABLE",
    "active_table",
    "set_active_table",
    "clear_active_table",
    "load_table",
    "load_table_cli",
    "table_load_events",
    "decode_m_max",
    "spmm_block_elems",
    "gemv_cuda_key",
    "gemv_cuda_config",
    "spmm_cuda_config",
    "fused_qkv",
    "fused_ffn",
    "conversion_cost",
    "matmul_latency_us",
]

#: widest right operand still considered decode-shaped when no table is
#: active (slot batches are single-token, so M == number of serving slots)
DEFAULT_DECODE_M_MAX = 16

#: cap on the gathered-operand size (elements) of one plain SpMM block
DEFAULT_SPMM_BLOCK_ELEMS = 1 << 22

#: the decode bodies' own plan (``kernels/nmg_gemv.py:row_plan``)
DEFAULT_GEMV_CUDA = None

#: the SpMM's own K split (``csrc/nmg_spmm.cu:tc_shape`` / ``f32_splits``)
DEFAULT_SPMM_CUDA = None

#: the decode QKV projections fuse into one launch when eligible
DEFAULT_FUSED_QKV = True

#: the decode gated-MLP pair (projection, split, act, gate) fuses into one
#: launch when eligible
DEFAULT_FUSED_FFN = True

#: environment variable naming a table file for :func:`load_table_cli`
ENV_TABLE = "REPRO_TUNE_TABLE"

_ACTIVE: Optional[TuningTable] = None


def active_table() -> Optional[TuningTable]:
    return _ACTIVE


def set_active_table(table: Optional[TuningTable]) -> None:
    """Install ``table`` as the process-wide routing source (None restores
    the shipped defaults), and wire the dispatcher's conversion-cost
    tie-breaker to it (unwired on None)."""
    global _ACTIVE
    _ACTIVE = table
    # the module object: the core package re-exports a function named
    # ``dispatch`` that shadows the submodule
    disp = importlib.import_module("repro_torch.core.dispatch")
    disp.set_conversion_cost_model(
        conversion_cost if table is not None else None)


def clear_active_table() -> None:
    set_active_table(None)


# ("table", "loaded" | "load_failed") -> count; never reset, so a corrupt
# table swallowed in this process stays visible
_LOAD_EVENTS: collections.Counter = collections.Counter()


def table_load_events() -> dict:
    """{("table", "loaded" | "load_failed"): count} for this process."""
    return dict(_LOAD_EVENTS)


def load_table(path: str, *, device: Optional[str] = None
               ) -> Optional[TuningTable]:
    """Load ``path``'s section for device kind ``device`` (default: the
    running device's) and make it active.  A corrupt, truncated or
    schema-mismatched file warns (``RuntimeWarning``), records a
    ``("table", "load_failed")`` event, leaves the active table as it was
    and returns None."""
    try:
        table = TuningTable.load(path, device=device)
    except (OSError, ValueError) as e:
        _LOAD_EVENTS[("table", "load_failed")] += 1
        warnings.warn(
            f"tuning table {path!r} failed to load ({e}) — routing falls "
            f"back to shipped defaults", RuntimeWarning, stacklevel=2)
        return None
    _LOAD_EVENTS[("table", "loaded")] += 1
    set_active_table(table)
    return table


def load_table_cli(path: Optional[str], *, verbose: bool = True,
                   device: Optional[str] = None) -> Optional[TuningTable]:
    """The CLIs' loader: an explicit ``path`` wins (a load failure
    raises), else ``$REPRO_TUNE_TABLE`` (a missing or unreadable file
    warns on stderr and falls back to the defaults).  A loaded table is
    announced.  Returns None when neither names a readable table."""
    if path:
        table = load_table(path, device=device)
        if table is None:
            raise ValueError(
                f"tuning table {path!r} failed to load (see warning above)")
        src = path
    else:
        env = os.environ.get(ENV_TABLE)
        if not env:
            return None
        if not os.path.exists(env):
            print(f"tuning: ${ENV_TABLE}={env} does not exist — "
                  f"using shipped defaults", file=sys.stderr)
            return None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            table = load_table(env, device=device)
        if table is None:
            msg = str(caught[-1].message) if caught else "load failed"
            print(f"tuning: ${ENV_TABLE}={env} is unreadable ({msg}) — "
                  f"using shipped defaults", file=sys.stderr)
            return None
        src = f"${ENV_TABLE}={env}"
    if verbose:
        print(f"tuning: loaded {len(table)} entries for {table.device} "
              f"from {src}")
    return table


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def _lookup(key: str, default):
    if _ACTIVE is not None:
        hit = _ACTIVE.get(key)
        if hit is not None:
            return hit, "table"
    return default, "default"


def _bucketed(kind: str, default, key=None, **ctx):
    """Exact-bucket hit (``key``, default ``shape_key(kind, **ctx)``),
    else the device-wide ``kind`` entry, else ``default``.  The key is
    built only when a table is active: the router asks at every call."""
    if _ACTIVE is None:
        return default, "default"
    val, src = _lookup(key or shape_key(kind, **ctx), None)
    if val is None:
        val, src = _lookup(kind, default)
    return val, src


def decode_m_max(*, K: int, R: int, fmt: tuple, gr: int, dtype
                 ) -> tuple[int, str]:
    """Widest right operand routed to the GEMV for this shape bucket."""
    val, src = _bucketed("decode_m_max", DEFAULT_DECODE_M_MAX, K=K, R=R,
                         fmt=fmt, gr=gr, dtype=dtype)
    return int(val), src


def spmm_block_elems() -> tuple[int, str]:
    """Gathered-operand element cap per plain SpMM block (device-wide)."""
    val, src = _lookup("spmm_block_elems", DEFAULT_SPMM_BLOCK_ELEMS)
    return int(val), src


def gemv_cuda_key(*, K: int, fmt: tuple, gr: int, dtype, R: int = 0) -> str:
    """The R-free key of the decode bodies' config (``R`` is taken and
    ignored, so a router context can be passed whole)."""
    n, m, g = fmt
    return f"gemv_cuda/K{bucket(K)}/{n}:{m}:{g}/gr{gr}/{dtype_name(dtype)}"


def gemv_cuda_config(*, K: int, R: int = 0, fmt: tuple, gr: int, dtype
                     ) -> tuple[Optional[dict], str]:
    """The decode ``tc`` body's ``{rows, parts}`` for this K bucket, or
    None for ``row_plan``'s own choice.  Bucket hit, else the device-wide
    ``gemv_cuda`` entry, else None."""
    if _ACTIVE is None:
        return DEFAULT_GEMV_CUDA, "default"
    val, src = _bucketed("gemv_cuda", DEFAULT_GEMV_CUDA, key=gemv_cuda_key(
        K=K, fmt=fmt, gr=gr, dtype=dtype))
    return (None if val is None else dict(val)), src


def spmm_cuda_config(*, K: int, R: int, fmt: tuple, gr: int, dtype
                     ) -> tuple[Optional[dict], str]:
    """The SpMM's ``{splits}`` for this shape bucket, or None for the
    kernel's own split.  Bucket hit, else the device-wide ``spmm_cuda``
    entry, else None."""
    val, src = _bucketed("spmm_cuda", DEFAULT_SPMM_CUDA, K=K, R=R,
                         fmt=fmt, gr=gr, dtype=dtype)
    return (None if val is None else dict(val)), src


def fused_qkv(*, K: int, R: int, fmt: tuple, gr: int, dtype
              ) -> tuple[bool, str]:
    """Whether eligible attention projections fuse into one launch for
    this bucket (``R`` the summed rows of the group)."""
    val, src = _bucketed("fused_qkv", DEFAULT_FUSED_QKV, K=K, R=R,
                         fmt=fmt, gr=gr, dtype=dtype)
    return bool(val), src


def fused_ffn(*, K: int, R: int, fmt: tuple, gr: int, dtype
              ) -> tuple[bool, str]:
    """Whether an eligible packed gated-MLP weight fuses into one launch
    for this bucket."""
    val, src = _bucketed("fused_ffn", DEFAULT_FUSED_FFN, K=K, R=R,
                         fmt=fmt, gr=gr, dtype=dtype)
    return bool(val), src


def matmul_latency_us(*, K: int, R: int, fmt: tuple, gr: int, dtype,
                      M: int) -> tuple[Optional[float], str]:
    """Measured best-path latency (us) of one routed sparse matmul at
    width ``M`` for this bucket, or None when the active table has none.
    Written by ``tune/bench.py:tune_decode_threshold``; its consumer, the
    reference's ``serve/slo.py:LatencyModel``, is not ported yet."""
    key = (shape_key("matmul_latency", K=K, R=R, fmt=fmt, gr=gr,
                     dtype=dtype) + f"/M{bucket(M)}")
    val, src = _lookup(key, None)
    return (None if val is None else float(val)), src


def conversion_cost(src_cls: type, dst_cls: type) -> Optional[float]:
    """Measured cost (us) of a lossless ``src -> dst`` conversion, or None
    when the active table has none; the dispatcher breaks ties among
    equally long conversion routes with it."""
    if _ACTIVE is None or src_cls is dst_cls:
        return None
    return _ACTIVE.get(f"convert_cost/{src_cls.__name__}->{dst_cls.__name__}")
