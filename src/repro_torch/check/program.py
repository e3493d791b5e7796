"""CheckedProgram: one traced (and, on the card, captured) entry program
plus the evidence the rules inspect (port of ``repro/check/program.py``).

``build_program`` runs ``fn(*example_args)`` once, on the device its
arguments lie on, under a :class:`Recorder`: a ``TorchDispatchMode`` that
writes every ATen op the program dispatches into a :class:`Graph`, the
port's counterpart of the reference's jaxpr.  The kernels launch through
``ctypes`` and dispatch nothing, so while the recorder is set each kernel
wrapper records itself as one node named after its kernel
(``kernels/_trace.py``), on the card and on the CPU (where the wrapper
runs its plain version, whose ops are not recorded) alike.  The program
is run rather than symbolically traced because the rules must see what a
host read does (``.item()`` cannot be traced symbolically), and because a
kernel needs real pointers.

Around the trace ``build_program`` snapshots the dispatcher's counters,
the conversion log and the kernel counters, so each program carries the
dispatch decisions of its own run (deltas, not process totals).  The R6
estimates of the routed kernel configs are made at build time, under the
tuning table active then: the port reads its routing at every call and a
CUDA graph freezes what was active at its capture.

``hlo=True`` is the reference's compiled program; the port's counterpart
is the program captured as a CUDA graph, which is what the engine
replays.  On the card the program is captured once, on the stream it was
traced on, and the capture's outcome recorded (the op a failed capture
raised in, ``check/capture_pass.py``); on the CPU it is not run, and the
program records that.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor, \
    SparsityLayout
from repro_torch.kernels import _trace

__all__ = ["CheckedProgram", "Graph", "Node", "Recorder", "SYNC_OPS",
           "build_program", "collect_sparse_weights", "trace"]

#: ops that read a tensor's values on the host (a copy to the CPU is the
#: third kind of sync: :meth:`Node.host_sync`)
SYNC_OPS = frozenset({"aten._local_scalar_dense", "aten.nonzero"})


@dataclasses.dataclass
class Node:
    """One op of a traced program: an ATen op (``"aten.mm"``), a kernel
    (its name, ``"nmg_gemv"``), a program input or a constant tensor."""

    index: int
    op: str
    kind: str                  # "aten" | "kernel" | "input" | "constant"
    inputs: tuple = ()         # indices of the nodes whose values it reads
    shapes: tuple = ()         # of its tensor outputs
    dtypes: tuple = ()
    devices: tuple = ()        # of its tensor outputs
    in_devices: tuple = ()     # of the tensors it reads
    name: str = ""             # an input's path
    from_input: bool = False   # its value depends on a program input
    flops: float = 0.0         # a kernel's operations (its wrapper's count)

    @property
    def shape(self) -> tuple:
        return self.shapes[0] if self.shapes else ()

    @property
    def host_sync(self) -> bool:
        """Whether the host waits for the device here: a host read of a
        tensor on the device or of a value computed from the program's
        inputs (on the CPU, where the inputs stand in for the card's; a
        read of a constant made on the host is no sync), or a copy from
        the device to the CPU."""
        if self.op in SYNC_OPS:
            return self.from_input or any(d != "cpu" for d in
                                          self.in_devices)
        return (self.kind == "aten" and "cpu" in self.devices
                and any(d != "cpu" for d in self.in_devices))


@dataclasses.dataclass
class Graph:
    """The ops of one run of a program, in the order they ran."""

    nodes: list = dataclasses.field(default_factory=list)
    scalar_inputs: list = dataclasses.field(default_factory=list)

    def consumers(self) -> dict:
        """{node index: [nodes that read it]}."""
        out: dict = {}
        for node in self.nodes:
            for i in node.inputs:
                out.setdefault(i, []).append(node)
        return out

    def kernels(self) -> list:
        return [n for n in self.nodes if n.kind == "kernel"]


def _op_name(func) -> str:
    """``"aten.mm"`` for ``aten::mm``'s overloads."""
    return func._schema.name.replace("::", ".")


def _tensors(obj) -> list:
    """Every tensor in nested tuples / lists / dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    return []


def _walk(obj, path: str, out: list, *, structure: bool = False) -> None:
    """(path, tensor or Python scalar) of every program input in
    ``obj``: tensors anywhere, including a layout's own (and its plan's);
    Python scalars outside a layout (a layout's ints are its structure,
    not inputs)."""
    if isinstance(obj, torch.Tensor):
        out.append((path, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, f"{path}.{k}", out, structure=structure)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _walk(v, f"{path}.{i}", out, structure=structure)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for k, v in vars(obj).items():
            _walk(v, f"{path}.{k}", out, structure=True)
    elif isinstance(obj, (bool, int, float)) and not structure:
        out.append((path, obj))


class Recorder(TorchDispatchMode):
    """Writes every ATen op dispatched while it is active into
    :attr:`graph`.  A tensor's producer is looked up by the identity of
    its Python object; every tensor seen is kept alive until the trace
    ends, so no identity is reused."""

    def __init__(self):
        super().__init__()
        self.graph = Graph()
        self._of: dict = {}
        self._keep: list = []
        self._paused = False

    def _add(self, op, kind, inputs=(), outs=(), in_devices=(), name="",
             flops=0.0):
        outs = [t for t in outs if isinstance(t, torch.Tensor)]
        nodes = self.graph.nodes
        node = Node(len(nodes), op, kind, tuple(inputs),
                    tuple(tuple(t.shape) for t in outs),
                    tuple(t.dtype for t in outs),
                    tuple(t.device.type for t in outs), tuple(in_devices),
                    name, kind == "input"
                    or any(nodes[i].from_input for i in inputs), flops)
        nodes.append(node)
        for t in outs:
            self._of[id(t)] = node.index
            self._keep.append(t)
        return node

    def value(self, t: torch.Tensor) -> int:
        """The node that produced ``t``: a constant node on first sight of
        a tensor that is neither an input nor the output of a recorded
        op."""
        i = self._of.get(id(t))
        if i is None:
            i = self._add("constant", "constant", outs=(t,)).index
        return i

    def add_inputs(self, args) -> None:
        found: list = []
        _walk(args, "args", found)
        for path, v in found:
            if isinstance(v, torch.Tensor):
                if id(v) not in self._of:
                    self._add("input", "input", outs=(v,), name=path)
            else:
                self.graph.scalar_inputs.append((path, type(v).__name__))

    @contextlib.contextmanager
    def paused(self):
        prev, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = prev

    def kernel(self, name: str, operands, out, flops: float = 0.0) -> None:
        """One node for one kernel call, from ``operands`` to ``out``,
        with the kernel's ``flops``."""
        ins = [self.value(t) for t in operands]
        self._add(name, "kernel", ins, _tensors(out),
                  [t.device.type for t in operands], flops=flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            ins = _tensors((args, kwargs))
            self._add(_op_name(func), "aten",
                      [self.value(t) for t in ins], _tensors(out),
                      [t.device.type for t in ins])
        return out


def trace(fn: Callable, args: tuple) -> Graph:
    """Run ``fn(*args)`` once under a :class:`Recorder`; returns its
    graph."""
    rec = Recorder()
    rec.add_inputs(args)
    prev, _trace.RECORDER = _trace.RECORDER, rec
    try:
        with rec:
            fn(*args)
    finally:
        _trace.RECORDER = prev
    return rec.graph


class _Watch(TorchDispatchMode):
    """The op a failed capture raised in (else the last op dispatched)."""

    def __init__(self):
        super().__init__()
        self.last = self.failed = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = _op_name(func)
        try:
            return func(*args, **(kwargs or {}))
        except Exception:
            self.failed = self.failed or self.last
            raise


def capture(fn: Callable, args: tuple, stream) -> dict:
    """Capture ``fn(*args)`` as a CUDA graph on ``stream`` (which has run
    it once) and drop the graph: ``{"captured": bool, "op": the op a
    failed capture raised in, "error": its message}``.  The launch
    counters are put back (capture executes nothing)."""
    kops = importlib.import_module("repro_torch.kernels.ops")
    before = kops.counter_snapshot()
    cur = torch.cuda.current_stream(stream.device)
    watch = _Watch()
    graph = torch.cuda.CUDAGraph()
    try:
        with watch, torch.cuda.graph(graph, stream=stream):
            fn(*args)
        return {"captured": True, "op": None, "error": None}
    except RuntimeError as e:
        first = e
        while first.__context__ is not None:
            first = first.__context__
        return {"captured": False, "op": watch.failed or watch.last,
                "error": str(first).strip().splitlines()[0]}
    finally:
        kops.restore_counters(before)
        # a failed capture_end leaves the capture stream current
        torch.cuda.set_stream(cur)
        del graph


@dataclasses.dataclass
class CheckedProgram:
    """Everything the rules need to know about one entry program."""

    name: str
    model_dtype: Any                    # torch dtype the program's math is in
    decode_path: bool                   # R3 (dtype) applies to this program
    loop: bool = False                  # R4 (host sync) applies to it
    graph: Optional[Graph] = None
    capture: Optional[dict] = None      # hlo=True: the capture's outcome
    sparse_weights: dict = dataclasses.field(default_factory=dict)
    fallbacks: dict = dataclasses.field(default_factory=dict)   # dispatch delta
    conversions: list = dataclasses.field(default_factory=list)  # convert delta
    routes: dict = dataclasses.field(default_factory=dict)      # kernel delta
    smem_estimates: list = dataclasses.field(default_factory=list)
    device_kind: str = ""


def collect_sparse_weights(tree, path: str = "args") -> dict:
    """{path: layout} for every n:m:g and fixed-mask leaf of a tree of
    dicts, lists and tuples."""
    if isinstance(tree, (GroupedNMTensor, FixedMaskTensor)):
        return {path: tree}
    if isinstance(tree, SparsityLayout):
        return {}
    out: dict = {}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (tuple, list)) else ()
    for k, v in items:
        out.update(collect_sparse_weights(v, f"{path}.{k}"))
    return out


def _device_of(args) -> torch.device:
    found: list = []
    _walk(args, "args", found)
    for _, v in found:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def build_program(name: str, fn: Callable, example_args: tuple, *,
                  model_dtype, decode_path: bool = False,
                  loop: bool = False, sparse_weights: Optional[dict] = None,
                  hlo: bool = False, decode_m: Optional[int] = None,
                  prefill_n: Optional[int] = None, gated_mlp: bool = False,
                  device_kind: Optional[str] = None) -> CheckedProgram:
    """Run ``fn(*example_args)`` once under the recorder into a
    :class:`CheckedProgram`.

    ``loop`` marks a program the runtime replays with no host sync
    between runs (the decode chunk, the trainer's step), the scope of R4.
    ``decode_m`` / ``prefill_n`` are the activation widths the R6
    estimator sizes the routed decode and SpMM configs at (omit either to
    skip that estimate); ``gated_mlp`` sizes a gated MLP's packed ``wi``
    as the fused FFN's.  ``hlo=True`` also captures the program as a CUDA
    graph on the card (the CLI's default)."""
    disp = importlib.import_module("repro_torch.core.dispatch")
    conv = importlib.import_module("repro_torch.core.convert")
    kops = importlib.import_module("repro_torch.kernels.ops")
    from repro_torch.tune.table import device_kind as _device_kind

    if sparse_weights is None:
        sparse_weights = collect_sparse_weights(example_args)
    device = _device_of(example_args)
    kind = device_kind or _device_kind(device)

    disp_before = disp.dispatch_counters()
    kern_before = kops.kernel_counters()
    conv_before = len(conv.conversion_log())

    stream = None
    if hlo and device.type == "cuda":
        # traced on the stream it is captured on: the trace is the eager
        # run a capture needs first (libraries loaded, workspaces made)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        graph = trace(fn, example_args)

    fallbacks = {
        k: v - disp_before.get(k, 0)
        for k, v in disp.dispatch_counters().items()
        if v > disp_before.get(k, 0)
    }
    routes = {
        k: v - kern_before.get(k, 0)
        for k, v in kops.kernel_counters().items()
        if v > kern_before.get(k, 0)
    }
    conversions = conv.conversion_log()[conv_before:]
    estimates = _smem_estimates(sparse_weights, model_dtype, kind,
                                decode_m=decode_m, prefill_n=prefill_n,
                                gated_mlp=gated_mlp)

    cap = None
    if hlo:
        if stream is None:
            cap = {"captured": False, "op": None,
                   "error": f"not run: the program lies on {device.type}"}
        else:
            torch.cuda.current_stream(device).wait_stream(stream)
            cap = capture(fn, example_args, stream)

    return CheckedProgram(
        name=name, model_dtype=model_dtype, decode_path=decode_path,
        loop=loop, graph=graph, capture=cap,
        sparse_weights=dict(sparse_weights), fallbacks=fallbacks,
        conversions=conversions, routes=routes, smem_estimates=estimates,
        device_kind=kind,
    )


def _smem_estimates(sparse_weights: dict, model_dtype, device_kind: str, *,
                    decode_m: Optional[int], prefill_n: Optional[int],
                    gated_mlp: bool) -> list:
    """Shared-memory estimates of the routed kernel configs per n:m:g
    weight, resolved now, under the tuning table active while the
    program ran."""
    from repro_torch.check.static_pass import gemv_smem, spmm_smem

    ests = []
    for path, w in sparse_weights.items():
        if not isinstance(w, GroupedNMTensor):
            continue
        if decode_m is not None:
            ffn = gated_mlp and path.endswith("mlp.wi")
            ests.append(gemv_smem(w, model_dtype, decode_m, device_kind,
                                  weight=path, ffn=ffn))
        if prefill_n is not None:
            ests.append(spmm_smem(w, model_dtype, prefill_n, device_kind,
                                  weight=path))
    return ests
