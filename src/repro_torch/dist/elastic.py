"""Elasticity primitives of the training loop (port of
``repro/dist/elastic.py``):

  * :class:`StragglerWatchdog` — per-host step-time tracking that flags
    hosts running persistently slower than the others, the trigger for
    evicting a sick host and re-meshing;
  * :func:`plan_remesh` — the largest ``(data, model)`` mesh shape on the
    surviving chips that keeps the model-parallel degree (the shape that
    ``launch/mesh.py:make_host_mesh`` then builds).

Plain Python, run by the controller between steps.
"""

from __future__ import annotations

import statistics
from collections import deque
from typing import Deque, List

__all__ = ["StragglerWatchdog", "plan_remesh"]


def plan_remesh(n_chips: int, model_parallel: int):
    """Largest ``(data, model)`` mesh shape on ``n_chips`` surviving chips.

    Keeps ``model_parallel`` fixed (param shards must stay whole) and
    floors the data-parallel degree; chips beyond ``data * model`` idle
    until the fleet heals.  Raises ``ValueError`` when fewer chips survive
    than one model-parallel group needs.
    """
    if n_chips < model_parallel:
        raise ValueError(
            f"cannot remesh: {n_chips} chips < model_parallel="
            f"{model_parallel} (one full model shard group is required)"
        )
    return (n_chips // model_parallel, model_parallel)


class StragglerWatchdog:
    """Flags hosts whose recent step times exceed the others' median.

    ``observe(host, seconds)`` records one step; :meth:`stragglers` returns
    the hosts whose median over the last ``window`` observations is more
    than ``ratio`` times the median of the other warmed-up hosts —
    persistent slowness, not one-step jitter.  A host counts once it has
    ``min_steps`` observations (cold-start steps would otherwise trip it).
    """

    def __init__(self, n_hosts: int, *, min_steps: int = 5,
                 ratio: float = 2.0, window: int = 20):
        self.n_hosts = n_hosts
        self.min_steps = min_steps
        self.ratio = ratio
        self.window = window
        self._times: List[Deque[float]] = [
            deque(maxlen=window) for _ in range(n_hosts)]
        self._seen: List[int] = [0] * n_hosts

    def observe(self, host: int, seconds: float) -> None:
        """Record one step duration for ``host``."""
        self._times[host].append(float(seconds))
        self._seen[host] += 1

    def stragglers(self) -> List[int]:
        """Hosts currently flagged as persistently slow (sorted).  Each
        warmed-up host is compared with the median of the *other*
        warmed-up hosts (with itself in the reference, a straggler among
        two hosts could never be flagged)."""
        warm = [h for h in range(self.n_hosts)
                if self._seen[h] >= self.min_steps]
        if len(warm) < 2:
            return []
        meds = {h: statistics.median(self._times[h]) for h in warm}
        out = []
        for h in warm:
            ref = statistics.median([meds[o] for o in warm if o != h])
            if meds[h] > self.ratio * ref:
                out.append(h)
        return out
