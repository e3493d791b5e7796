"""Build events of the serving programs (port of
``repro/serve/tracecount.py``; the store is a ``repro_torch.obs``
registry family, as the reference's is).

The reference calls ``note_trace(name)`` inside the raw bodies of its
jitted serve programs, so it counts compilations: one per new (param
structure, shape) variant, never a run.  The port's counterpart of a
compilation is the build of a program object in ``serve/graphs.py``: a
CUDA graph capture, or, where capture is off (the CPU, ``graphs=False``),
the program's first eager run.  The names are the reference's:
``slot_prefill`` (one per admission program, i.e. per distinct prompt
length), ``decode`` and ``decode_chunk``, and the paged programs'.  Flat
counts across a second pass over the same traffic (or across tier
switches after ``ServeEngine.warm_tiers``) prove that serving builds
nothing new.  With the flight recorder on, each build is a
``program_build`` event on the engine track.
"""

from __future__ import annotations

from repro_torch.obs.registry import REGISTRY

__all__ = ["note_trace", "trace_events", "reset_trace_events"]

_TRACE_EVENTS = REGISTRY.family(
    "serve_program_builds",
    help="builds of serve programs (a capture, or a first eager run), by "
         "program name; flat counts prove build-free serving",
    trace_as="program_build", track="engine")


def note_trace(name: str) -> None:
    """Record one build of the named serve program."""
    _TRACE_EVENTS[name] += 1


def trace_events() -> dict:
    """{program name: times built} for this process."""
    return dict(_TRACE_EVENTS)


def reset_trace_events() -> None:
    _TRACE_EVENTS.clear()
