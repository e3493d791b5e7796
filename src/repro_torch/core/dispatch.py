"""Operator registry and sparse dispatch (port of
``repro/core/dispatch.py``, paper §3.2, §4.4, Figs 3-4).

Implementations register under ``(op, input-layout signature, inline
sparsifier class)``.  ``dispatch`` looks up, in order:

1. the exact implementation for the signature and inline sparsifier; a
   *fused* one (``_sten_fused``) receives the sparsifier as its first
   argument;
2. an implementation reached by lossless conversions of the operands
   (``convert.lossless_targets``): the fewest conversions win; a tie goes
   to registration order unless every tied candidate's conversions are
   measured by the installed cost model (``set_conversion_cost_model``),
   and then to the cheapest;
3. with an inline sparsifier but no fused implementation, 1 and 2 without
   it, followed by the sparsifier (``_with_post_sparsifier``);
4. the dense fallback: densify, call the registered dense reference, and
   warn once per signature with :class:`SparseFallbackWarning`.

All-dense arguments take the dense reference directly.  Sparse operators
(operator + output format, paper §3.3) are built by
:func:`sparsified_op` from an :class:`OutFormat`.  :func:`predict_route`
gives the route without calling anything.  The port runs eagerly, so the
counters count calls (the reference counts traces); the cost model is
not yet wired to a tuning table.
"""

from __future__ import annotations

import dataclasses
import importlib
import warnings
from typing import Callable, Optional, Sequence

# the module (the package re-exports a function named ``convert``)
conv = importlib.import_module("repro_torch.core.convert")
from repro_torch.core.layouts import DenseTensor, SparsityLayout
from repro_torch.core.sparsifiers import KeepAll, Sparsifier, \
    apply_sparsifier
from repro_torch.obs.registry import REGISTRY

__all__ = [
    "SparseFallbackWarning",
    "register_op_impl",
    "register_patched_op",
    "register_dense_reference",
    "dispatch",
    "sparsified_op",
    "OutFormat",
    "sparse_op_table",
    "dispatch_counters",
    "reset_dispatch_counters",
    "predict_route",
    "set_conversion_cost_model",
    "conversion_cost_model",
]


class SparseFallbackWarning(UserWarning):
    """No sparse implementation exists: the dense fallback ran."""


#: (op name, input layouts, inline sparsifier class or None) -> impl
_OP_IMPLS: dict = {}
#: op name -> dense reference (the fallback)
_DENSE_OPS: dict = {}
#: (outcome, op, layout names) -> calls; outcome "impl" | "dense_fallback"
#: | "cost_model_override" (a tie the cost model decided against
#: registration order).  A ``repro_torch.obs`` registry family, as the
#: reference's: Counter semantics, the counts in the registry's snapshot,
#: and with the flight recorder on each count a ``dispatch`` event.
_DISPATCH_COUNTS = REGISTRY.family(
    "dispatch", help="dispatch outcomes: (outcome, op, layout signature)",
    trace_as="dispatch", track="kernel")
#: (op, layout names) whose fallback warning already fired
_WARNED_FALLBACKS: set = set()
#: (source class, target class) -> cost or None; breaks conversion ties
_CONVERSION_COST: Optional[Callable] = None


def dispatch_counters() -> dict:
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counters() -> None:
    _DISPATCH_COUNTS.clear()
    _WARNED_FALLBACKS.clear()


def _count(outcome: str, op_name: str, sig: tuple) -> None:
    _DISPATCH_COUNTS[(outcome, op_name, tuple(c.__name__ for c in sig))] += 1


def set_conversion_cost_model(fn: Optional[Callable]) -> None:
    """Install (or clear, with None) the conversion-cost tie-breaker
    ``fn(source class, target class) -> cost or None``."""
    global _CONVERSION_COST
    _CONVERSION_COST = fn


def conversion_cost_model():
    return _CONVERSION_COST


def _canonical_name(op) -> str:
    if isinstance(op, str):
        return op
    name = getattr(op, "__name__", None)
    return repr(op) if name is None else name


def register_dense_reference(op_name: str, fn: Callable) -> None:
    _DENSE_OPS[op_name] = fn


def register_op_impl(op, inp: Sequence[type], out: Optional[type] = None,
                     inline: Optional[type] = None):
    """Decorator: register a sparse implementation of ``op`` (a name, or a
    callable that then doubles as the op's dense reference) for the input
    layouts ``inp``, producing ``out``, fusing the inline sparsifier class
    ``inline``."""
    op_name = _canonical_name(op)
    if callable(op) and op_name not in _DENSE_OPS:
        register_dense_reference(op_name, op)

    def deco(fn):
        key = (op_name, tuple(inp), inline)
        if key in _OP_IMPLS:
            raise ValueError(f"duplicate op impl {key}")
        _OP_IMPLS[key] = fn
        fn._sten_out_layout = out
        return fn

    return deco


def register_patched_op(fn: Callable, op_name: Optional[str] = None):
    """Paper §4.4 patching API: a wrapper of ``fn`` that goes through the
    dispatcher when any argument is a sparse layout."""
    name = op_name or _canonical_name(fn)
    _DENSE_OPS.setdefault(name, fn)

    def wrapped(*args, **kwargs):
        if any(isinstance(a, SparsityLayout) for a in args):
            return dispatch(name, *args, **kwargs)
        return fn(*args, **kwargs)

    wrapped.__name__ = name
    return wrapped


def sparse_op_table() -> dict:
    """The registered sparse-op table."""
    return dict(_OP_IMPLS)


def _signature(args) -> tuple:
    return tuple(type(a) if isinstance(a, SparsityLayout) else DenseTensor
                 for a in args)


def _find_impl(op_name: str, sig: tuple, inline: Optional[type]):
    """Exact, then conversion-reached lookup: (impl, target signature or
    None when no conversion is needed), or (None, None)."""
    key = (op_name, sig, inline)
    if key in _OP_IMPLS:
        return _OP_IMPLS[key], None
    candidates = []
    for (name, s, inl), impl in _OP_IMPLS.items():
        if name != op_name or inl is not inline or len(s) != len(sig):
            continue
        nconv, cost, ok = 0, 0.0, True
        for have, want in zip(sig, s):
            if have is want:
                continue
            if want not in conv.lossless_targets(have):
                ok = False
                break
            nconv += 1
            c = None if _CONVERSION_COST is None \
                else _CONVERSION_COST(have, want)
            cost = None if c is None or cost is None else cost + float(c)
        if ok:
            candidates.append((nconv, cost, s, impl))
    if not candidates:
        return None, None
    best_n = min(t[0] for t in candidates)
    pool = [t for t in candidates if t[0] == best_n]
    chosen = pool[0]
    # measured costs decide a tie only when every tied candidate is fully
    # measured; otherwise registration order stands
    if len(pool) > 1 and all(t[1] is not None for t in pool):
        chosen = min(pool, key=lambda t: t[1])
        if chosen[3] is not pool[0][3]:
            _count("cost_model_override", op_name, sig)
    return chosen[3], chosen[2]


def _with_post_sparsifier(impl, sparsifier):
    def wrapped(*args, **kwargs):
        out = impl(*args, **kwargs)
        if sparsifier is not None and not isinstance(sparsifier, KeepAll):
            out = sparsifier(out)
        return out

    wrapped._sten_out_layout = getattr(impl, "_sten_out_layout", None)
    return wrapped


def _apply_inline(out, inline):
    return out if inline is None or isinstance(inline, KeepAll) \
        else inline(out)


def dispatch(op, *args, inline: Optional[Sparsifier] = None,
             dense_fn: Optional[Callable] = None, **kwargs):
    """Run ``op`` (a name or a callable) on (possibly sparse) ``args``;
    returns what the implementation returns (a dense tensor or a layout).
    ``dense_fn`` overrides the dense fallback."""
    op_name = _canonical_name(op)
    fallback = dense_fn or _DENSE_OPS.get(op_name) or (
        op if callable(op) else None)
    if not any(isinstance(a, SparsityLayout) for a in args) \
            and fallback is not None:
        return _apply_inline(fallback(*args, **kwargs), inline)
    sig = _signature(args)
    inline_cls = type(inline) if inline is not None else None
    impl, target_sig = _find_impl(op_name, sig, inline_cls)
    if impl is None and inline_cls is not None:
        impl, target_sig = _find_impl(op_name, sig, None)
        if impl is not None:
            impl = _with_post_sparsifier(impl, inline)
    if impl is not None:
        _count("impl", op_name, sig)
        if target_sig is not None:
            args = tuple(a if isinstance(a, t) else conv.convert(a, t)
                         for a, t in zip(args, target_sig))
        if inline_cls is not None and getattr(impl, "_sten_fused", False):
            return impl(inline, *args, **kwargs)
        return impl(*args, **kwargs)
    if fallback is None:
        raise NotImplementedError(
            f"no sparse implementation nor dense fallback for op "
            f"{op_name!r} with signature {[c.__name__ for c in sig]}")
    if any(isinstance(a, SparsityLayout) and not isinstance(a, DenseTensor)
           for a in args):
        # a DenseTensor densifies for free: warn only for a sparse layout
        _count("dense_fallback", op_name, sig)
        names = tuple(c.__name__ for c in sig)
        if (op_name, names) not in _WARNED_FALLBACKS:
            _WARNED_FALLBACKS.add((op_name, names))
            warnings.warn(f"sten: falling back to dense implementation of "
                          f"{op_name!r} for signature {list(names)}",
                          SparseFallbackWarning, stacklevel=2)
    dense = tuple(a.to_dense() if isinstance(a, SparsityLayout) else a
                  for a in args)
    return _apply_inline(fallback(*dense, **kwargs), inline)


def predict_route(op, sig, *, inline: Optional[type] = None) -> dict:
    """How :func:`dispatch` would route ``op`` over a signature of layout
    classes (instances reduce to their classes), without calling anything
    and leaving the counters untouched::

        {"outcome": "impl" | "dense_fallback", "op": name,
         "sig": (layout names...), "target_sig": (names...) | None,
         "conversions": ((from, to), ...), "warns": bool}
    """
    op_name = _canonical_name(op)
    sig = tuple(s if isinstance(s, type) else type(conv.as_layout(s))
                for s in sig)
    saved = _DISPATCH_COUNTS.copy()
    try:
        impl, target_sig = _find_impl(op_name, sig, inline)
        if impl is None and inline is not None:
            impl, target_sig = _find_impl(op_name, sig, None)
    finally:
        _DISPATCH_COUNTS.clear()
        _DISPATCH_COUNTS.update(saved)
    names = tuple(c.__name__ for c in sig)
    if impl is not None:
        return {"outcome": "impl", "op": op_name, "sig": names,
                "target_sig": tuple(c.__name__ for c in target_sig)
                if target_sig else None,
                "conversions": tuple(
                    (h.__name__, w.__name__)
                    for h, w in zip(sig, target_sig or sig) if h is not w),
                "warns": False}
    warns = any(issubclass(c, SparsityLayout) and c is not DenseTensor
                for c in sig)
    return {"outcome": "dense_fallback", "op": op_name, "sig": names,
            "target_sig": None, "conversions": (), "warns": warns}


# ---------------------------------------------------------------------------
# sparse operators: operator + output format (paper §3.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OutFormat:
    """Output format 4-tuple (paper §3.3): the inline sparsifier applied
    inside the operator, materialized in ``tmp_layout``, then the external
    sparsifier makes ``out_layout``."""

    inline: Sparsifier = KeepAll()
    tmp_layout: type = DenseTensor
    external: Sparsifier = KeepAll()
    out_layout: type = DenseTensor

    @classmethod
    def coerce(cls, fmt):
        return fmt if isinstance(fmt, OutFormat) else cls(*fmt)


def sparsified_op(orig_op, out_fmt, grad_out_fmt=None,
                  dense_fn: Optional[Callable] = None):
    """A sparse operator from ``orig_op`` and its output format (an
    :class:`OutFormat` or 4-tuple; the first of a list): the returned
    callable dispatches (fusing the inline sparsifier where an
    implementation does), materializes the temporary layout, applies the
    external sparsifier and returns the output layout.  ``grad_out_fmt``
    is recorded on it; gradients are sparsified where they become values
    (``core/autograd.py:sparsify_grads``)."""
    fmt = OutFormat.coerce(
        out_fmt[0] if isinstance(out_fmt, (list, tuple)) and out_fmt
        and isinstance(out_fmt[0], (OutFormat, tuple)) else out_fmt)

    def op(*args, generator=None, **kwargs):
        tmp = dispatch(orig_op, *args, inline=fmt.inline, dense_fn=dense_fn,
                       **kwargs)
        if not isinstance(tmp, SparsityLayout):
            tmp = conv.as_layout(tmp)
        if fmt.tmp_layout is not None and not isinstance(tmp,
                                                         fmt.tmp_layout):
            tmp = conv.convert(tmp, fmt.tmp_layout)
        if isinstance(fmt.external, KeepAll) and isinstance(tmp,
                                                            fmt.out_layout):
            return tmp
        return apply_sparsifier(fmt.external, tmp, fmt.out_layout,
                                generator=generator)

    op.grad_out_fmt = grad_out_fmt
    op.out_fmt = fmt
    op.__name__ = f"sparse_{_canonical_name(orig_op)}"
    return op
