"""Capture detectors: the compiled-level half of R4 (port of
``repro/check/hlo_pass.py``).

The reference lowers and compiles each program and reads the HLO; the
port compiles nothing, and its counterpart of the compiled program is the
program captured as a CUDA graph (``build_program(hlo=True)`` on the
card), which is what the engine and the graph trainer replay.  A capture
that fails because the program syncs with the host is R4's compiled-level
finding, named by the op the capture raised in.  R1 and R3 have no
compiled-level counterpart here: what the graph pass sees of a program
is what runs, since no compiler rewrites it after the trace.
"""

from __future__ import annotations

from repro_torch.check.diagnostics import Diagnostic, Severity
from repro_torch.check.program import SYNC_OPS

__all__ = ["capture_r4"]

#: a copy that fails under capture is a copy to the host
_COPIES = frozenset({"aten._to_copy", "aten.copy_"})


def capture_r4(program) -> list:
    """A loop program whose capture failed at a host sync."""
    cap = program.capture
    if not program.loop or cap is None or cap["captured"] \
            or cap["op"] not in SYNC_OPS | _COPIES:
        return []
    return [Diagnostic(
        rule="R4", severity=Severity.ERROR, entry=program.name,
        message=f"the loop program cannot be captured as a CUDA graph: the "
                f"capture failed at a host sync ({cap['error']})",
        op=cap["op"], location="capture",
        fix="keep the value on the device, or read it once per chunk "
            "outside the program",
    )]
