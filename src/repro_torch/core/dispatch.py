"""Operator registry and sparse dispatch (minimal port of
``repro/core/dispatch.py``, paper §3.2, §4.4).

Implementations register under ``(op, input-layout signature, inline
sparsifier class)``.  ``dispatch`` looks up, in order:

1. the exact implementation for the signature and inline sparsifier; a
   *fused* one (``_sten_fused``) receives the sparsifier as its first
   argument;
2. with an inline sparsifier but no fused implementation, the plain
   implementation followed by the sparsifier (``_with_post_sparsifier``);
3. the dense fallback: densify, call the registered dense reference, and
   warn once per signature with :class:`SparseFallbackWarning`.

All-dense arguments take the dense reference directly, as in the
reference.  The reference's lossless-conversion search with its measured
cost model, and ``predict_route``, are not ported yet.  The port runs
eagerly, so the counters count calls (the reference counts traces).
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, Optional, Sequence

from repro_torch.core.layouts import DenseTensor, SparsityLayout
from repro_torch.core.sparsifiers import KeepAll

__all__ = ["SparseFallbackWarning", "register_op_impl",
           "register_dense_reference", "dispatch", "dispatch_counters",
           "reset_dispatch_counters"]


class SparseFallbackWarning(UserWarning):
    """No sparse implementation exists: the dense fallback ran."""


_OP_IMPLS: dict = {}
_DENSE_OPS: dict = {}
#: (outcome, op, layout names) -> calls; outcome "impl" | "dense_fallback"
_DISPATCH_COUNTS: collections.Counter = collections.Counter()
_WARNED_FALLBACKS: set = set()


def dispatch_counters() -> dict:
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counters() -> None:
    _DISPATCH_COUNTS.clear()
    _WARNED_FALLBACKS.clear()


def register_dense_reference(op_name: str, fn: Callable) -> None:
    _DENSE_OPS[op_name] = fn


def register_op_impl(op_name: str, inp: Sequence[type],
                     inline: Optional[type] = None):
    """Decorator: register a sparse implementation of ``op_name`` for the
    input layouts ``inp``, fusing the inline sparsifier class ``inline``."""

    def deco(fn):
        key = (op_name, tuple(inp), inline)
        if key in _OP_IMPLS:
            raise ValueError(f"duplicate op impl {key}")
        _OP_IMPLS[key] = fn
        return fn

    return deco


def _signature(args) -> tuple:
    return tuple(type(a) if isinstance(a, SparsityLayout) else DenseTensor
                 for a in args)


def _with_post_sparsifier(impl, sparsifier):
    def wrapped(*args, **kwargs):
        return sparsifier(impl(*args, **kwargs))

    return wrapped


def _apply_inline(out, inline):
    return out if inline is None or isinstance(inline, KeepAll) \
        else inline(out)


def dispatch(op_name: str, *args, inline=None, **kwargs):
    """Run ``op_name`` on (possibly sparse) ``args``; returns what the
    implementation returns (a dense tensor or a layout)."""
    if not any(isinstance(a, SparsityLayout) for a in args):
        return _apply_inline(_DENSE_OPS[op_name](*args, **kwargs), inline)
    sig = _signature(args)
    names = tuple(c.__name__ for c in sig)
    inline_cls = type(inline) if inline is not None else None
    impl = _OP_IMPLS.get((op_name, sig, inline_cls))
    if impl is None and inline_cls is not None:
        impl = _OP_IMPLS.get((op_name, sig, None))
        if impl is not None and not isinstance(inline, KeepAll):
            impl = _with_post_sparsifier(impl, inline)
    if impl is not None:
        _DISPATCH_COUNTS[("impl", op_name, names)] += 1
        if inline_cls is not None and getattr(impl, "_sten_fused", False):
            return impl(inline, *args, **kwargs)
        return impl(*args, **kwargs)
    if any(not isinstance(a, DenseTensor) and isinstance(a, SparsityLayout)
           for a in args):
        _DISPATCH_COUNTS[("dense_fallback", op_name, names)] += 1
        if (op_name, names) not in _WARNED_FALLBACKS:
            _WARNED_FALLBACKS.add((op_name, names))
            warnings.warn(f"sten: falling back to dense implementation of "
                          f"{op_name!r} for signature {list(names)}",
                          SparseFallbackWarning, stacklevel=2)
    dense = tuple(a.to_dense() if isinstance(a, SparsityLayout) else a
                  for a in args)
    return _apply_inline(_DENSE_OPS[op_name](*dense, **kwargs), inline)
