"""Typed error family for the serving engine (port of
``repro/serve/errors.py``).

Every failure the engine can hand back to a caller is a
:class:`ServeError` subclass, so callers can catch the family with one
``except`` while still distinguishing the cases that matter:

* :class:`PromptTooLongError` — the request can never fit the engine's
  KV capacity (raised at ``submit()`` time; a trace fed through
  ``ServeEngine.run`` converts it into a ``finish_reason="rejected"``
  output instead, so one bad request cannot kill a serve loop),
* :class:`DeadlineExceededError` — the request's ``deadline_s`` expired
  (queued requests past their deadline finish as ``"timeout"`` without
  ever occupying a slot),
* :class:`EngineOverloadError` — admission control turned the request
  away: the bounded queue was full at ``submit()`` time, or the SLO
  control loop shed it (``finish_reason="shed"``).

:class:`InjectedFaultError` is deliberately *not* a :class:`ServeError`:
it models a transient infrastructure fault (``serve/faults.py``) that the
engine retries with capped exponential backoff — it is never a request
outcome.
"""

from __future__ import annotations

__all__ = [
    "ServeError",
    "PromptTooLongError",
    "DeadlineExceededError",
    "EngineOverloadError",
    "InjectedFaultError",
    "raise_for_output",
]


class ServeError(RuntimeError):
    """Base of every request-level serving failure."""


class PromptTooLongError(ServeError, ValueError):
    """A prompt (plus at least one generated token) exceeds the cache's
    per-slot capacity.

    Subclasses ``ValueError`` for compatibility with the pre-typed-family
    spelling (it used to be a bare ``ValueError`` subclass in
    ``serve/cache.py``)."""


class DeadlineExceededError(ServeError):
    """A request's ``deadline_s`` expired before it finished; queued
    requests past their deadline finish as ``"timeout"`` without ever
    occupying a slot."""


class EngineOverloadError(ServeError):
    """The engine turned a request away to protect its SLO: the bounded
    queue was full at ``submit()`` time, or the degradation ladder shed
    the request (``finish_reason="shed"``)."""


class InjectedFaultError(RuntimeError):
    """A transient fault injected by ``serve/faults.py`` around the decode
    step.  The engine retries these with capped exponential backoff; they
    never surface as request outcomes."""


#: terminal ``finish_reason`` -> exception class for callers that want
#: exceptions rather than outcome strings
_REASON_ERRORS = {
    "rejected": PromptTooLongError,
    "timeout": DeadlineExceededError,
    "shed": EngineOverloadError,
}


def raise_for_output(output) -> None:
    """Raise the typed error matching a failed
    :class:`~repro_torch.serve.queue.RequestOutput`; no-op for served requests
    (``finish_reason`` ``"length"``/``"stop"``)."""
    cls = _REASON_ERRORS.get(output.finish_reason)
    if cls is not None:
        raise cls(
            f"request {output.uid} finished as {output.finish_reason!r} "
            f"after {output.finish_time - output.arrival_time:.3f}s"
        )
