"""Rule registry: R1-R6 (plus R7, the device-model warning) as typed
:class:`Rule` records binding an id, severity, description and the
detector functions of the graph, capture and run-evidence passes (port of
``repro/check/rules.py``: the same ids, names and severities).

Every rule registered here must have a triggering and a clean fixture in
``repro_torch.check.fixtures``; ``tests/test_torch_check.py`` enforces
that, so a new rule cannot land untested.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.check import capture_pass, graph_pass, static_pass
from repro_torch.check.diagnostics import Diagnostic, Severity

__all__ = ["Rule", "all_rules", "run_rules", "register_rule"]


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    name: str
    severity: Severity
    description: str
    detectors: tuple     # each: CheckedProgram -> list[Diagnostic]


_RULES: dict[str, Rule] = {}


def register_rule(rule_id: str, name: str, severity: Severity,
                  description: str, detectors: Sequence[Callable]) -> Rule:
    if rule_id in _RULES:
        raise ValueError(f"duplicate rule {rule_id}")
    rule = Rule(rule_id, name, severity, description, tuple(detectors))
    _RULES[rule_id] = rule
    return rule


def all_rules() -> dict[str, Rule]:
    return dict(_RULES)


def run_rules(program, rules: Sequence[str] | None = None
              ) -> list[Diagnostic]:
    """Run every registered rule (or the named subset) over one program."""
    out: list[Diagnostic] = []
    for rid in sorted(rules or _RULES):
        for detect in _RULES[rid].detectors:
            out.extend(detect(program))
    return out


register_rule(
    "R1", "silent-densify", Severity.ERROR,
    "A GroupedNM/FixedMask operand reaches a dense aten.mm / addmm / bmm "
    "/ matmul without an explicit densify site: dispatcher fallback "
    "counters, and scatter-to-matmul reachability in the traced ATen "
    "graph (where each kernel is one node).",
    (static_pass.static_r1, graph_pass.graph_r1),
)
register_rule(
    "R2", "conversion-churn", Severity.WARNING,
    "The same weight is converted between layouts more than once per "
    "run of a program.",
    (static_pass.static_r2,),
)
register_rule(
    "R3", "dtype-promotion", Severity.ERROR,
    "A cast (aten._to_copy) on the decode path widens past the model "
    "dtype outside matmul/reduction accumulation, breaking the bitwise "
    "decode contract.",
    (graph_pass.graph_r3,),
)
register_rule(
    "R4", "host-sync-in-loop", Severity.ERROR,
    "A host sync (aten._local_scalar_dense, aten.nonzero, a copy to the "
    "CPU) lives inside a loop program (the decode chunk, the trainer's "
    "step): one host round-trip per step, and no CUDA graph capture.",
    (graph_pass.graph_r4, capture_pass.capture_r4),
)
register_rule(
    "R5", "recompile-hazard", Severity.WARNING,
    "A Python scalar program input: a captured CUDA graph freezes its "
    "value, so every new value costs a new capture.",
    (graph_pass.graph_r5,),
)
register_rule(
    # the reference's name; on the card the memory is shared memory
    "R6", "vmem-overrun", Severity.ERROR,
    "The routed CUDA config (the decode tc body's rows/parts, the SpMM's "
    "K split) needs more shared memory (or registers) a block than the "
    "device gives, or the kernel refuses it.",
    (static_pass.static_r6,),
)
register_rule(
    "R7", "unmodelled-device", Severity.WARNING,
    "The running device kind has no HW_BY_KIND entry in launch/hw.py; "
    "budgets and roofline terms are modelled against the H100's "
    "constants.",
    (static_pass.static_r7,),
)
