"""Typed diagnostics model for the static sparse-program verifier (a copy
of ``repro/check/diagnostics.py``).

A :class:`Diagnostic` is one finding: which rule fired, how severe it is,
which entry program it came from, the offending op/instruction, and a fix
hint.  A :class:`Report` aggregates them across programs, handles
suppression (``--ignore R2`` / ``--ignore R2:train*``), renders the
human-readable listing, serializes to JSON (``--json``), and converts to
a shell exit code (errors always fail; warnings fail under ``--strict``).
"""

from __future__ import annotations

import dataclasses
import enum
import fnmatch
from typing import Iterable, Optional

__all__ = ["Severity", "Diagnostic", "Report"]


class Severity(enum.IntEnum):
    """Ordered so max() over diagnostics picks the worst finding."""

    WARNING = 1
    ERROR = 2

    @property
    def label(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of one rule against one checked program."""

    rule: str                      # "R1".."R7", "DIFF"
    severity: Severity
    entry: str                     # program name, e.g. "serve:decode"
    message: str                   # what is wrong
    op: Optional[str] = None       # ATen op / kernel / counter key
    location: Optional[str] = None  # e.g. "graph:loop-body", "capture"
    fix: Optional[str] = None      # how to make the rule pass

    def render(self) -> str:
        where = f" [{self.location}]" if self.location else ""
        opp = f" ({self.op})" if self.op else ""
        hint = f"\n    fix: {self.fix}" if self.fix else ""
        return (f"{self.severity.label}[{self.rule}] {self.entry}{where}: "
                f"{self.message}{opp}{hint}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["severity"] = self.severity.label
        return d


def _suppressed(diag: Diagnostic, ignore: Iterable[str]) -> bool:
    """``ignore`` tokens are ``RULE`` (suppress everywhere) or
    ``RULE:entry-glob`` (suppress where the entry name matches the glob;
    a bare substring also matches)."""
    for token in ignore:
        rule, _, pat = token.partition(":")
        if rule != diag.rule:
            continue
        if not pat or fnmatch.fnmatch(diag.entry, pat) or pat in diag.entry:
            return True
    return False


class Report:
    """Aggregated diagnostics across every checked program."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: list[Diagnostic] = list(diagnostics)
        self.programs: list[str] = []      # every program that was checked

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def filtered(self, ignore: Iterable[str]) -> "Report":
        out = Report(d for d in self.diagnostics
                     if not _suppressed(d, ignore))
        out.programs = list(self.programs)
        return out

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity < Severity.ERROR]

    def exit_code(self, strict: bool = False) -> int:
        if self.errors:
            return 1
        if strict and self.warnings:
            return 1
        return 0

    def to_json(self) -> dict:
        return {
            "programs": list(self.programs),
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        lines = [d.render() for d in sorted(
            self.diagnostics, key=lambda d: (-d.severity, d.rule, d.entry)
        )]
        return "\n".join(lines)

    def summary(self) -> str:
        return (f"{len(self.programs)} program(s) checked: "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
