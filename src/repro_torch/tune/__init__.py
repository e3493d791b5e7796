"""``repro_torch.tune``: kernel-routing tuning for the card (port of
``repro/tune``).

* :mod:`repro_torch.tune.table` — the persistent :class:`TuningTable`
  (JSON, keyed by device kind and power-of-two shape bucket, the
  reference's keys),
* :mod:`repro_torch.tune.routing` — lookups with shipped defaults that
  equal the port's routing without a table (read by ``kernels/ops.py``
  and ``core/dispatch.py``),
* :mod:`repro_torch.tune.bench` — the timing harness and tuners
  (device time from CUDA events on the card), including
  :func:`~repro_torch.tune.bench.autotune_for_serving`, the engine warmup
  hook,
* ``python -m repro_torch.tune`` — the offline CLI that sweeps the grid
  and writes the table.

``bench`` imports the kernel modules, so it is not imported here:
``kernels/ops.py`` imports ``repro_torch.tune.routing`` without a cycle.
"""

from repro_torch.tune.routing import (
    DEFAULT_DECODE_M_MAX,
    DEFAULT_GEMV_CUDA,
    DEFAULT_SPMM_BLOCK_ELEMS,
    DEFAULT_SPMM_CUDA,
    active_table,
    clear_active_table,
    load_table,
    load_table_cli,
    set_active_table,
)
from repro_torch.tune.table import TuningTable, bucket, device_kind, \
    shape_key

__all__ = [
    "DEFAULT_DECODE_M_MAX",
    "DEFAULT_GEMV_CUDA",
    "DEFAULT_SPMM_BLOCK_ELEMS",
    "DEFAULT_SPMM_CUDA",
    "TuningTable",
    "active_table",
    "bucket",
    "clear_active_table",
    "device_kind",
    "load_table",
    "load_table_cli",
    "set_active_table",
    "shape_key",
]
