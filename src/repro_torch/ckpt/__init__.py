"""Checkpoints (port of ``repro/ckpt``): atomic npz + manifest writes,
integrity hashes, an async rotating manager."""

from repro_torch.ckpt.checkpoint import CheckpointManager, load_pytree, \
    save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
