"""Each kernel call as one node of a traced program.

``check/program.py`` traces a program by recording every ATen op it
dispatches.  A kernel launch goes through ``ctypes`` and dispatches
nothing, and a plain version on the CPU dispatches ops that are not the
kernel, so while a recorder is set (``RECORDER``), every kernel wrapper of
``kernels/ops.py:KERNEL_WRAPPERS`` hands its call to :func:`as_node`: the
call runs as it would untraced, with recording paused, and is recorded as
one node named after the kernel, from its operand tensors to its outputs.
Outside a trace ``RECORDER`` is None and the wrappers run as they did,
for the price of one attribute read.
"""

from __future__ import annotations

__all__ = ["RECORDER", "as_node"]

#: the active recorder (``check/program.py:Recorder``) or None
RECORDER = None


def as_node(name: str, operands, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the recorder unset and paused (so the
    wrapper ``fn`` takes its untraced path and none of its ops is
    recorded), then one node ``name`` from the tensors ``operands`` to
    what it returned."""
    global RECORDER
    rec, RECORDER = RECORDER, None
    try:
        with rec.paused():
            out = fn(*args, **kwargs)
    finally:
        RECORDER = rec
    rec.kernel(name, operands, out)
    return out
