"""Per-device FLOPs, bytes and collective bytes of one step, counted on
the ``meta`` device, and the three roofline terms (the port's counterpart
of the rest of ``repro/launch/hlo_analysis.py``; its device table is
``launch/hw.py``).

The reference lowers and compiles a step and parses the partitioned HLO.
The port has no compiled program to parse: :func:`analyze_program` runs
the step once on meta tensors (shapes, no storage, nothing launched)
under :class:`CostRecorder`, the checker's recorder
(``check/program.py:Recorder``) with a price on every op it sees:

  * **DTensor ops at their local shapes.**  The recorder declines an op
    on DTensors (``NotImplemented``), so DTensor runs first and the
    recorder sees what it runs on each rank: the local ops at the shard's
    shapes and the collectives its redistributes issue.  Every count is
    per device, as the reference's partitioned HLO is.  The ops DTensor's
    sharding propagation runs on fake tensors (once per new op, at the
    global shapes, for the output's metadata) are not charged.
  * **FLOPs** are matmul work alone, as the reference counts ``dot``s
    alone: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the fused
    attention ops by ``torch.utils.flop_counter``'s registered formulas,
    and each kernel node (``kernels/_trace.py``, every wrapper's meta
    route) by its wrapper's count, 2·M·R·K·n/m for the n:m:g products
    and 2m operations an element for ``nm_mask``.
  * **Bytes** are the eager port's traffic: every op reads its operands
    and writes its result once; views and metadata ops charge nothing;
    an in-place indexed write (``index_put_``, ``index_copy_``,
    ``scatter_``, ...) charges the slice it writes, not its destination
    (the reference's ``dynamic-update-slice`` rule); a gather
    (``index_select``, ``index``, ``embedding``, ...) charges the rows it
    moves, not its table; a kernel node its operands (an n:m:g layout's
    stored values and gather plan, the activation) and its output.
  * **Collective bytes** are the operand bytes of every functional or
    c10d collective the step issues, by the reference's kinds.

Deliberate differences from the reference (ROADMAP C2): nothing is
compiled, so the bytes are the eager port's per-op traffic, not
post-fusion HBM traffic; there is no raw XLA cost and no loop trip count
(the port's programs have no loop primitive: a layer loop runs its
layers one by one, and each is counted); the single collective rate is
NVLink's, which makes the collective term a lower bound on a mesh that
spans hosts, as the reference's single ICI rate was.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict

import torch

from repro_torch.check.program import Recorder, _tensors
from repro_torch.kernels import _trace
from repro_torch.launch.hw import DEFAULT_HW_KIND, hw_for_device

__all__ = ["COLLECTIVES", "CostRecorder", "RooflineTerms",
           "analyze_program", "roofline_terms"]

#: the reference's collective kinds (its HLO op names)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast",
               "ragged-all-to-all")

#: name fragments of collective ops -> kind (first match wins)
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("broadcast", "collective-broadcast"),
            ("send", "collective-permute"), ("recv", "collective-permute"),
            ("permute", "collective-permute"))
#: c10d ops whose operand is their second argument (the first is output)
_C10D_INPUT_SECOND = frozenset({"allgather_", "_allgather_base_",
                                "reduce_scatter_", "_reduce_scatter_base_",
                                "alltoall_", "alltoall_base_"})
#: collective plumbing that moves nothing
_COLLECTIVE_NOOPS = frozenset({"wait_tensor", "_wrap_tensor_autograd",
                               "barrier", "monitored_barrier"})
#: ops that allocate, read metadata or view without an alias annotation
#: (``_unsafe_view``), and move no bytes
_NOBYTE = frozenset({"_unsafe_view", "_reshape_alias",
                     "empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided", "lift_fresh", "lift_fresh_copy",
                     "detach", "alias", "_local_scalar_dense", "sym_size",
                     "sym_stride", "sym_numel", "is_same_size",
                     "set_", "resize_", "promote_types"})
#: gathers: charged the rows they move (read and written) and the indices
_GATHERS = frozenset({"index_select", "index", "gather", "embedding",
                      "take", "take_along_dim"})
#: in-place indexed writes: charged the slice they write, read and written
_INDEXED_WRITES = frozenset({"index_put_", "_index_put_impl_",
                             "index_copy_", "index_add_", "index_fill_",
                             "scatter_", "scatter_add_", "scatter_reduce_",
                             "masked_scatter_"})


def _matmul_formulas() -> dict:
    from torch.utils.flop_counter import flop_registry

    return {p: f for p, f in flop_registry.items()
            if "mm" in str(p).split(".")[-1]
            or "attention" in str(p) and "flex" not in str(p)}


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _collective_kind(name: str):
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


class CostRecorder(Recorder):
    """The checker's recorder, pricing each op it sees (module docstring):
    ``flops``, ``bytes``, ``collectives`` {kind: bytes} with ``count``,
    and ``kernels`` {kernel name: nodes}.  ATen ops are priced and not
    written into the graph; each kernel call is priced and recorded as
    its node."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_count = 0
        self.kernels: Counter = Counter()
        self._matmul = _matmul_formulas()

    def kernel(self, name: str, operands, out, flops: float = 0.0) -> None:
        self.flops += flops
        self.bytes += _nbytes(operands) + _nbytes(out)
        self.kernels[name] += 1
        super().kernel(name, operands, out, flops=flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs first: local shapes
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs each new op once on fake
        # tensors at its global shapes, to learn its output's: no work
        if not self._paused and not any(issubclass(t, FakeTensor)
                                        for t in types):
            self._price(func, args, kwargs, out)
        return out

    def _price(self, func, args, kwargs, out) -> None:
        """Charge one ATen op (the module docstring's rules)."""
        ns, _, name = func._schema.name.partition("::")
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            if name in _COLLECTIVE_NOOPS:
                return
            kind = _collective_kind(name)
            if kind is not None:
                operand = args[1] if name in _C10D_INPUT_SECOND else args[0]
                self.collectives[kind] += _nbytes(operand)
                self.collective_count += 1
            return
        packet = func.overloadpacket
        if packet in self._matmul:
            self.flops += self._matmul[packet](*args, **kwargs, out_val=out)
        if name in _NOBYTE or _is_view(func):
            return
        if name in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs))
                   if not t.is_floating_point()]
            self.bytes += 2 * _nbytes(out) + _nbytes(idx)
            return
        if name in _INDEXED_WRITES:
            src = _tensors((args[1:], kwargs))     # indices and values
            vals = [t for t in src if t.is_floating_point()
                    or t.dtype == args[0].dtype]
            self.bytes += _nbytes(src) + _nbytes(vals)
            return
        if name == "copy_":                         # writes, reads src
            self.bytes += _nbytes(args[1]) + _nbytes(out)
            return
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)


def analyze_program(fn: Callable, *args) -> Dict:
    """Run ``fn(*args)`` once (on meta tensors: a plain or DTensor step)
    under a :class:`CostRecorder`; per device, ``{"flops", "bytes",
    "collectives": {kind: bytes, "total", "count"}, "kernels": {name:
    count}}``."""
    rec = CostRecorder()
    prev, _trace.RECORDER = _trace.RECORDER, rec
    try:
        with rec:
            fn(*args)
    finally:
        _trace.RECORDER = prev
    coll = dict(rec.collectives)
    coll["total"] = sum(rec.collectives.values())
    coll["count"] = rec.collective_count
    return {"flops": float(rec.flops), "bytes": float(rec.bytes),
            "collectives": coll, "kernels": dict(rec.kernels)}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float,
                   device_kind: str | None = None) -> RooflineTerms:
    """The three terms against one device's rates (``launch/hw.py``, the
    H100 by default): FLOPs over bf16 tensor-core peak, bytes over HBM
    bandwidth, collective bytes over NVLink's."""
    hw = hw_for_device(DEFAULT_HW_KIND if device_kind is None
                       else device_kind)[0]
    return RooflineTerms(
        compute_s=flops_per_dev / hw["peak_flops_bf16"],
        memory_s=bytes_per_dev / hw["hbm_bw"],
        collective_s=coll_bytes_per_dev / hw["nvlink_bw"],
    )
