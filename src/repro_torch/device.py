"""Device selection for the port's public entry points.

Entry points default to ``device="cuda"``.  Without a card they raise
instead of running on the CPU: a run that silently drops to the CPU would
report CPU numbers under a GPU label.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no CUDA device is available."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain versions on the CPU"
        )
    return d
