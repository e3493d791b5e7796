"""Fault-tolerance primitives of the training loop (port of part of
``repro/dist``): the straggler watchdog."""

from repro_torch.dist.elastic import StragglerWatchdog

__all__ = ["StragglerWatchdog"]
