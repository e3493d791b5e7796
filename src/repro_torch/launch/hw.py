"""The device model: per-device constants keyed by the tuning table's
device kind (port of the table in ``repro/launch/hlo_analysis.py``;
the rest of that module analyses TPU HLO and has no counterpart here).

Keys are ``tune/table.py:device_kind()`` spellings.  The H100 entry holds
the published figures of the H100 SXM; its shared-memory and register
figures are what ``torch.cuda.get_device_properties`` reports on the card
(``chip_smoke.py`` phase (m) holds them equal).  The ``torch-cpu:cpu``
entry models the H100's budgets, so a check run on the CPU judges a
routed config against the card it would run on, as the reference's
``cpu:cpu`` entry models the v5e's.  The static checker reads the
budgets (``check/static_pass.py``, rules R6 and R7) and
``chip_smoke.py`` the rates of its bounds.
"""

from __future__ import annotations

__all__ = ["HW_BY_KIND", "DEFAULT_HW_KIND", "H100", "hw_for_device"]

#: NVIDIA H100 SXM (80 GB HBM3), published figures
H100 = {
    "peak_flops_bf16": 989e12,        # FLOP/s, dense bf16 tensor cores
    "peak_flops_f32": 67e12,          # FLOP/s, f32 outside the tensor cores
    "hbm_bw": 3.35e12,                # B/s, device memory
    "nvlink_bw": 900e9,               # B/s, NVLink, all links together
    "smem_per_block_bytes": 232_448,  # shared memory a block (opt-in)
    "smem_per_sm_bytes": 233_472,     # shared memory an SM
    "regs_per_sm": 65_536,            # 32-bit registers an SM
}

HW_BY_KIND = {
    "torch-cuda:nvidia_h100_80gb_hbm3": H100,
    "torch-cpu:cpu": dict(H100),      # the CPU models the card's budgets
}

DEFAULT_HW_KIND = "torch-cuda:nvidia_h100_80gb_hbm3"


def hw_for_device(kind: str | None = None):
    """-> (constants, matched).  A kind with no entry (or None) gets the
    H100's constants with ``matched=False``, which the checker reports
    as rule R7 rather than guessing other numbers."""
    if kind in HW_BY_KIND:
        return HW_BY_KIND[kind], True
    return HW_BY_KIND[DEFAULT_HW_KIND], False
