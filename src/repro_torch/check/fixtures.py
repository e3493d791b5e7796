"""Seeded regression fixtures: for every rule, one program that triggers
it and one that is clean (port of ``repro/check/fixtures.py``).

These are the checker's own test vectors: ``tests/test_torch_check.py``
asserts the registry and this table stay in lockstep, that each trigger
fails (nonzero exit under ``--strict``) with the rule ids and severities
of the reference's fixtures, and that each clean program passes.  Every
fixture builds on the CPU (the default) and on the card
(``chip_smoke.py`` phase (m), where R4's trigger is also captured and
fails its capture).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from repro_torch.check.program import build_program
from repro_torch.core.layouts import CsrTensor, FixedMaskTensor, \
    GroupedNMTensor
from repro_torch.tune.routing import active_table, set_active_table
from repro_torch.tune.table import TuningTable, device_kind

__all__ = ["FIXTURES", "fixture_programs", "R6_SHAPE", "R6_CONFIG"]

_N, _M, _G, _GR = 1, 4, 8, 4
F32, BF16 = torch.float32, torch.bfloat16


def _weight(K: int = 64, R: int = 64, *, gr: int = _GR, dtype=F32,
            device="cpu") -> GroupedNMTensor:
    x = np.random.default_rng(0).standard_normal((K, R), dtype=np.float32)
    return GroupedNMTensor.from_dense(
        torch.as_tensor(x, dtype=dtype, device=device), _N, _M, _G, gr=gr,
        sparse_dim=0)


def _x(rows: int = 4, K: int = 64, *, dtype=F32, device="cpu"):
    return torch.ones((rows, K), dtype=dtype, device=device)


# -- R1: silent densify ------------------------------------------------------


def _r1_trigger(device="cpu"):
    w = _weight(device=device)

    def f(x):
        return x @ w.to_dense()      # densified projection: the bug

    return build_program("fixture/r1:trigger", f, (_x(device=device),),
                         model_dtype=F32, decode_path=True,
                         sparse_weights={"w": w}, hlo=True, decode_m=4)


def _r1_clean(device="cpu"):
    from repro_torch.models.common import mm
    w = _weight(device=device)

    def f(x):
        return mm(x, w)              # routed through the sparse kernels

    return build_program("fixture/r1:clean", f, (_x(device=device),),
                         model_dtype=F32, decode_path=True,
                         sparse_weights={"w": w}, hlo=True, decode_m=4)


# -- R2: conversion churn ----------------------------------------------------


def _csr(device):
    d = torch.where(torch.arange(64, device=device).reshape(8, 8) % 3 == 0,
                    1.0, 0.0)
    return CsrTensor.from_dense(d)


def _r2_trigger(device="cpu"):
    conv = importlib.import_module("repro_torch.core.convert")
    c = _csr(device)

    def f(x):
        a = conv.convert(c, FixedMaskTensor)
        b = conv.convert(c, FixedMaskTensor)   # the same conversion, again
        return x + a.to_dense() + b.to_dense()

    return build_program("fixture/r2:trigger", f,
                         (torch.ones((8, 8), device=device),),
                         model_dtype=F32)


def _r2_clean(device="cpu"):
    conv = importlib.import_module("repro_torch.core.convert")
    c = _csr(device)

    def f(x):
        a = conv.convert(c, FixedMaskTensor)   # converted once, reused
        ad = a.to_dense()
        return x + ad + ad

    return build_program("fixture/r2:clean", f,
                         (torch.ones((8, 8), device=device),),
                         model_dtype=F32)


# -- R3: dtype promotion on the decode path ---------------------------------


def _r3_trigger(device="cpu"):
    def f(x):
        return x.float() * 2.0     # elementwise math widened

    return build_program("fixture/r3:trigger", f,
                         (torch.ones((4, 8), dtype=BF16, device=device),),
                         model_dtype=BF16, decode_path=True)


def _r3_clean(device="cpu"):
    y = torch.ones((8, 4), device=device)

    def f(x):
        # widening that feeds only the matmul accumulation is the kernels'
        # own f32-accumulator contract: allowed
        return (x.float() @ y).to(BF16)

    return build_program("fixture/r3:clean", f,
                         (torch.ones((4, 8), dtype=BF16, device=device),),
                         model_dtype=BF16, decode_path=True)


# -- R4: host sync inside a loop program -------------------------------------


def _r4_trigger(device="cpu"):
    def f(x):
        for _ in range(2):          # an unrolled two-step loop
            x = x * 2.0
            if x.sum().item() > 1e30:     # a host read every step
                x = x * 0.0
        return x

    return build_program("fixture/r4:trigger", f,
                         (torch.ones((4,), device=device),),
                         model_dtype=F32, decode_path=True, loop=True,
                         hlo=True)


def _r4_clean(device="cpu"):
    def f(x):
        for _ in range(2):
            x = x * 2.0
            x = torch.where(x.sum() > 1e30, x * 0.0, x)   # stays on device
        return x

    return build_program("fixture/r4:clean", f,
                         (torch.ones((4,), device=device),),
                         model_dtype=F32, decode_path=True, loop=True,
                         hlo=True)


# -- R5: a Python scalar input (recompile hazard) ----------------------------


def _r5_trigger(device="cpu"):
    def f(x):
        return torch.full((4,), 1.0, device=device) + x

    # a Python float: a captured program would freeze its value
    return build_program("fixture/r5:trigger", f, (1.0,), model_dtype=F32)


def _r5_clean(device="cpu"):
    def f(x):
        return torch.full((4,), 1.0, device=device) + x

    return build_program("fixture/r5:clean", f,
                         (torch.tensor(1.0, device=device),),
                         model_dtype=F32)


# -- R6: shared-memory overrun from a bad tuned config -----------------------

#: the R6 fixtures' weight [K, R] (bf16 1:4:8, gr 64) and decode width: K
#: long enough that one K part of the decode ``tc`` body (its ring,
#: gathered B, staged window and plan entries) passes the H100's 232,448
#: B a block, which row_plan's own choice (8 parts) stays far under
R6_SHAPE = (8192, 64, 16)
#: the table entry that ``row_plan`` accepts and the card cannot take
R6_CONFIG = {"rows": 64, "parts": 1}


def _r6_program(name, device):
    K, R, M = R6_SHAPE
    w = _weight(K, R, gr=64, dtype=BF16, device=device)

    def f(x):
        # the estimate reads the routed config, not this run: a program
        # that launched the overrunning config would fail before any
        # rule could judge it
        return x * 2.0

    return build_program(name, f, (_x(M, K, dtype=BF16, device=device),),
                         model_dtype=BF16, decode_path=True,
                         sparse_weights={"w": w}, decode_m=M)


def _r6_trigger(device="cpu"):
    # estimates are made at build time, while this table is active
    prev = active_table()
    set_active_table(TuningTable(device=device_kind(device),
                                 entries={"gemv_cuda": dict(R6_CONFIG)}))
    try:
        return _r6_program("fixture/r6:trigger", device)
    finally:
        set_active_table(prev)


def _r6_clean(device="cpu"):
    return _r6_program("fixture/r6:clean", device)


# -- R7: unmodelled device kind ---------------------------------------------


def _r7_program(name, kind, device):
    def f(x):
        return x * 2.0

    return build_program(name, f, (_x(device=device),), model_dtype=F32,
                         device_kind=kind)


def _r7_trigger(device="cpu"):
    return _r7_program("fixture/r7:trigger", "torch-cuda:nvidia_h99",
                       device)


def _r7_clean(device="cpu"):
    return _r7_program("fixture/r7:clean", None, device)


FIXTURES = {
    "R1": {"trigger": _r1_trigger, "clean": _r1_clean},
    "R2": {"trigger": _r2_trigger, "clean": _r2_clean},
    "R3": {"trigger": _r3_trigger, "clean": _r3_clean},
    "R4": {"trigger": _r4_trigger, "clean": _r4_clean},
    "R5": {"trigger": _r5_trigger, "clean": _r5_clean},
    "R6": {"trigger": _r6_trigger, "clean": _r6_clean},
    "R7": {"trigger": _r7_trigger, "clean": _r7_clean},
}


def fixture_programs(rule_id: str, kind: str, device="cpu"):
    """Build the ``kind`` ('trigger' | 'clean') fixture for ``rule_id`` on
    ``device``."""
    return FIXTURES[rule_id][kind](device)
