"""Build events of the serving programs (port of
``repro/serve/tracecount.py``; the reference keeps its counts on the
``repro.obs`` registry, which is not ported, so this is a plain dict).

The reference calls ``note_trace(name)`` inside the raw bodies of its
jitted serve programs, so it counts compilations: one per new (param
structure, shape) variant, never a run.  The port's counterpart of a
compilation is the build of a program object in ``serve/graphs.py``: a
CUDA graph capture, or, where capture is off (the CPU, ``graphs=False``),
the program's first eager run.  The names are the reference's:
``slot_prefill`` (one per admission program, i.e. per distinct prompt
length), ``decode`` and ``decode_chunk``.  Flat counts across a second
pass over the same traffic prove that serving builds nothing new.
"""

from __future__ import annotations

import collections

__all__ = ["note_trace", "trace_events", "reset_trace_events"]

_TRACE_EVENTS: collections.Counter = collections.Counter()


def note_trace(name: str) -> None:
    """Record one build of the named serve program."""
    _TRACE_EVENTS[name] += 1


def trace_events() -> dict:
    """{program name: times built} for this process."""
    return dict(_TRACE_EVENTS)


def reset_trace_events() -> None:
    _TRACE_EVENTS.clear()
