"""Routing defaults (port of the shipped defaults of
``repro/tune/routing.py:72-90``).  No tuning tables are ported yet, so the
routers read these constants directly."""

from __future__ import annotations

__all__ = ["DEFAULT_DECODE_M_MAX", "DEFAULT_SPMM_BLOCK_ELEMS",
           "DEFAULT_FUSED_QKV", "DEFAULT_FUSED_FFN"]

#: widest right operand still considered decode-shaped (slot batches are
#: single-token, so M == number of serving slots)
DEFAULT_DECODE_M_MAX = 16

#: cap on the gathered-operand size (elements) of one plain spmm block
DEFAULT_SPMM_BLOCK_ELEMS = 1 << 22

#: the decode QKV projections fuse into one launch when eligible
DEFAULT_FUSED_QKV = True

#: the decode gated-MLP pair (projection, split, act, gate) fuses into one
#: launch when eligible
DEFAULT_FUSED_FFN = True
