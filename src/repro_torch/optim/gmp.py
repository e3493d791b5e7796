"""Magnitude-pruning schedules (port of ``repro/optim/gmp.py``):
one-shot, iterative (gradual magnitude pruning, Zhu & Gupta) and
layer-wise.

The ramp is evaluated in float32 with the reference's exact operation
sequence, so the levels (and hence the top-k counts of
``unstructured_mask``) equal the reference's at every step.  The
reference's traced twins exist for its ``lax.scan`` trainer; the port's
loop is eager and has one spelling.  The ramp is not monotone at every
(target, span): the reference is not either, and the port matches its
values rather than asserting monotonicity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GMPSchedule", "gmp_sparsity"]


@dataclasses.dataclass(frozen=True)
class GMPSchedule:
    mode: str = "iterative"     # one_shot | iterative | layer_wise
    target_sparsity: float = 0.5
    begin_step: int = 0
    end_step: int = 1000
    recompute_every: int = 100  # pattern-recompute cadence during the ramp
    num_layers: int = 12        # layer_wise: layers pruned one at a time

    def sparsity_at(self, step: int) -> float:
        return gmp_sparsity(self, step)

    def recompute_at(self, step: int) -> bool:
        if self.mode == "one_shot":
            return step == self.begin_step
        if step < self.begin_step or step > self.end_step:
            return False
        # the ramp ends exactly at end_step: a final recompute fires there
        # even when the span is not a multiple of the cadence
        if step == self.end_step:
            return True
        return (step - self.begin_step) % max(1, self.recompute_every) == 0

    def layers_pruned_at(self, step: int) -> int:
        """layer_wise: how many leading layers are sparse at ``step``."""
        if self.mode != "layer_wise":
            return self.num_layers
        if step >= self.end_step:
            return self.num_layers
        span = max(1, (self.end_step - self.begin_step) // self.num_layers)
        return min(self.num_layers,
                   max(0, (step - self.begin_step) // span + 1))


def gmp_sparsity(s: GMPSchedule, step: int) -> float:
    """Cubic ramp for iterative (and layer-wise), a step function for
    one-shot; f32 arithmetic as in the reference."""
    if s.mode == "one_shot":
        return s.target_sparsity if step >= s.begin_step else 0.0
    if step <= s.begin_step:
        return 0.0
    if step >= s.end_step:
        return s.target_sparsity
    span = np.float32(max(1, s.end_step - s.begin_step))
    frac = (np.float32(step) - np.float32(s.begin_step)) / span
    om = np.float32(1.0) - frac
    tgt = np.float32(s.target_sparsity)
    return float(tgt * (np.float32(1.0) - om * om * om))
