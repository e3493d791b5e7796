"""Nan-safe statistics/formatting helpers (the port's copy of
``repro/statutil.py``).

Conventions: an empty sample is ``nan``, never an exception; ``nan``
renders as ``--``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["pct", "fmt"]


def pct(xs, q: float) -> float:
    """Percentile ``q`` of ``xs`` as a float; ``nan`` for an empty sample."""
    a = np.asarray(list(xs) if not hasattr(xs, "__len__") else xs,
                   np.float64)
    return float(np.percentile(a, q)) if a.size else float("nan")


def fmt(x: float, scale: float = 1.0, digits: int = 1) -> str:
    """Render a metric for a text report; ``nan`` prints as ``--``."""
    return "--" if math.isnan(x) else f"{x * scale:.{digits}f}"
