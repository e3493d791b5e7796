"""Atomic JSON writes (the port's copy of ``repro/ioutil.py``): serialize
to a pid-unique temp file beside the destination, then ``os.replace`` it
into place, so a reader never sees a torn file."""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["atomic_write_json"]


def atomic_write_json(path: str, obj: Any, *, indent: int = 2,
                      sort_keys: bool = False) -> None:
    """Atomically serialize ``obj`` as JSON to ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, sort_keys=sort_keys)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
