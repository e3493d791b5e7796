"""PyTorch/CUDA port of the STen reproduction (``repro``).

The package mirrors ``repro``'s module names (``core/layouts.py`` <->
``repro/core/layouts.py`` and so on) and imports ``torch`` and numpy only:
never JAX and nothing of ``repro``.  Every TPU (Pallas) kernel on the
ported path is a hand-written Hopper kernel under ``csrc/``, with a plain
PyTorch version beside it in the same module; the wrapper takes the plain
version only for tensors that lie on the CPU.

Public entry points default to ``device="cuda"`` and raise when CUDA is
absent unless the caller passes ``device="cpu"`` (see :mod:`.device`).
"""

__all__ = []
