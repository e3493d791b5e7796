"""Architecture registry of the port: ``get_config`` / ``get_smoke`` by
name, and the dry-run's cell grid (``configs/registry.py``)."""

from repro_torch.configs.registry import ARCHS, SHAPES, ShapeSpec, \
    _MODULES, get_arch, get_smoke, input_specs, runnable_cells, skip_reason
from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_arch", "get_config",
           "get_smoke", "input_specs", "runnable_cells", "skip_reason"]


def get_config(name: str) -> ModelConfig:
    """``name``'s published config; ``NotImplementedError`` naming the
    ported architectures for any other name."""
    if name not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet "
            f"(ported: {', '.join(_MODULES)})")
    return _MODULES[name].CONFIG
