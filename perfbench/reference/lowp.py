"""The control of the serving comparison: the reference with every
weight product taken in fp8 (e4m3), the step below the configuration's
bfloat16 that a later change might take.  Weights are scaled per output
column and activations per row to the format's range (448), rounded to
e4m3 and multiplied in f32; attention, norms and the rest stay as the
reference has them.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 under a scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N], both rounded to e4m3 first."""
    return fake_fp8(x, -1) @ fake_fp8(w, 0)


def fp8_mm_ste(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`fp8_mm` in the forward, the f32 product's gradient in the
    backward (straight-through), for the training control."""
    qx = x + (fake_fp8(x, -1) - x).detach()
    qw = w + (fake_fp8(w, 0) - w).detach()
    return qx @ qw
