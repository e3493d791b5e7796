"""Persistent tuning table: measured kernel-routing decisions, keyed by
device kind and shape bucket (port of ``repro/tune/table.py``).

The table is a flat ``{key: value}`` JSON cache.  Keys are strings built
by :func:`shape_key` from a decision kind plus the power-of-two shape
bucket and format the decision applies to, letter for letter the
reference's, e.g.::

    decode_m_max/K1024/R1024/1:4:8/gr64/bfloat16  -> 24
    gemv_cuda/K1024/1:4:8/gr64/bfloat16           -> {"rows": 64, "parts": 4}
    spmm_cuda/K1024/R1024/1:4:8/gr64/bfloat16     -> {"splits": 2}
    convert_cost/CsrTensor->DenseTensor           -> 13.7   (us)

Values are decisions (thresholds, block sizes, kernel configs, measured
conversion costs), never kernels: a table changes only which registered
path or config runs.

A table file carries one section per device kind.  The port's kinds are
``torch-cuda:<name>`` and ``torch-cpu:cpu``, which never collide with
the reference's ``cpu:cpu`` / ``tpu:...``, so one file holds both
packages' sections and a save by either keeps the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from repro_torch.ioutil import atomic_write_json

__all__ = [
    "SCHEMA_VERSION",
    "TuningTable",
    "bucket",
    "device_kind",
    "dtype_name",
    "shape_key",
]

SCHEMA_VERSION = 1


def device_kind(device=None) -> str:
    """The device identity table sections are keyed by:
    ``torch-cuda:nvidia_h100_80gb_hbm3`` on a card (the device name lower
    cased, ``_`` for spaces), ``torch-cpu:cpu`` on the CPU.  ``device``
    defaults to the card when one is available."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"torch-{dev.type}:{dev.type}"
    name = torch.cuda.get_device_name(dev).lower().replace(" ", "_")
    return f"torch-cuda:{name}"


def bucket(x: int) -> int:
    """Shape bucket: the next power of two >= x (minimum 1)."""
    x = max(1, int(x))
    return 1 << (x - 1).bit_length()


def dtype_name(dtype) -> str:
    """The reference's dtype spelling (``float32``, ``bfloat16``) of a
    torch dtype, a numpy / JAX dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return getattr(dtype, "name", None) or str(dtype)


def shape_key(kind: str, *, K: int, R: int, fmt: tuple, gr: int,
              dtype) -> str:
    """The table key for decision ``kind`` at a (bucketed) shape: ``K``
    the contraction extent, ``R`` the output extent, ``fmt`` (n, m, g),
    ``gr`` the row-sharing width, ``dtype`` the activation dtype."""
    n, m, g = fmt
    return (f"{kind}/K{bucket(K)}/R{bucket(R)}/{n}:{m}:{g}/gr{gr}/"
            f"{dtype_name(dtype)}")


@dataclasses.dataclass
class TuningTable:
    """In-memory view of one device section of the JSON cache."""

    device: str
    entries: dict[str, Any] = dataclasses.field(default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default: Any = None) -> Any:
        return self.entries.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self.entries[key] = value

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    @classmethod
    def for_device(cls, device: Optional[str] = None) -> "TuningTable":
        """An empty table for device kind ``device`` (default: the
        running device's, :func:`device_kind`)."""
        return cls(device=device or device_kind())

    @classmethod
    def load(cls, path: str, *, device: Optional[str] = None
             ) -> "TuningTable":
        """Load the section for device kind ``device`` (default: the
        running device's).  A file without that section gives an empty
        table, so every lookup falls back to the shipped defaults."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"tuning table {path!r} has schema {doc.get('schema')!r}; "
                f"this build reads schema {SCHEMA_VERSION} "
                f"(regenerate with `python -m repro_torch.tune`)"
            )
        device = device or device_kind()
        section = doc.get("devices", {}).get(device, {})
        return cls(device=device,
                   entries=dict(section.get("entries", {})),
                   meta=dict(section.get("meta", {})))

    def save(self, path: str) -> None:
        """Write this device's section into ``path``, keeping the sections
        of other devices (read-modify-write; the write is atomic, the
        read-modify-write last-writer-wins)."""
        doc = {"schema": SCHEMA_VERSION, "devices": {}}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    old = json.load(f)
                if old.get("schema") == SCHEMA_VERSION:
                    doc["devices"].update(old.get("devices", {}))
            except (OSError, ValueError):
                pass  # unreadable cache: rewrite it
        doc["devices"][self.device] = {
            "meta": self.meta,
            "entries": self.entries,
        }
        atomic_write_json(path, doc, sort_keys=True)

    def merge(self, other: "TuningTable") -> None:
        """Adopt ``other``'s entries (other wins on conflicts)."""
        self.entries.update(other.entries)
        self.meta.update(other.meta)
