"""Graph detectors: the trace-level halves of R1, R3, R4 and R5 (port of
``repro/check/jaxpr_pass.py``).

They read the ATen-level :class:`~repro_torch.check.program.Graph` of one
run of a program, in which every kernel call is one node named after its
kernel.  The port's programs have no loop primitive: a decode chunk's
steps are unrolled in Python and the trainer replays its step, so R4
applies to a whole program that the runtime replays with no host sync
between runs (``CheckedProgram.loop``), the counterpart of the
reference's scan body.
"""

from __future__ import annotations

from repro_torch.check.diagnostics import Diagnostic, Severity

__all__ = ["graph_r1", "graph_r3", "graph_r4", "graph_r5"]

#: what a densified weight is built with: ``to_dense`` of an n:m:g
#: layout is a ``scatter_add_`` into zeros
_SCATTER_OPS = frozenset({
    "aten.scatter", "aten.scatter_", "aten.scatter_add",
    "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_put", "aten.index_put_", "aten._unsafe_index_put",
    "aten._index_put_impl_", "aten.masked_scatter", "aten.masked_scatter_",
})
#: dense contractions a densified weight must not reach
_DENSE_MATMULS = frozenset({"aten.mm", "aten.addmm", "aten.bmm",
                            "aten.matmul"})
#: consumers allowed to read a widened value without tripping R3: matmul
#: accumulation and reductions legitimately widen; elementwise math in the
#: wide dtype is the bug
_PROMOTE_SINKS = frozenset({
    "aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.matmul",
    "aten.mv", "aten.dot", "aten.sum", "aten.mean", "aten.amax",
    "aten.amin", "aten.max", "aten.min", "aten.prod",
})
#: casts: what ``.to(dtype)`` / ``.float()`` dispatch
_CASTS = frozenset({"aten._to_copy", "aten.to"})
#: padding slack when matching a scatter output against a sparse weight's
#: dense shape (layouts pad R to the row group and K to the chunk grid)
_PAD_SLACK = 256


def _shape_matches_weight(shape, weights: dict):
    """Does a 2D scatter output look like a (padded) densified sparse
    weight?  Returns the matching weight path or None."""
    if len(shape) != 2:
        return None
    d0, d1 = int(shape[0]), int(shape[1])
    for path, w in weights.items():
        dense = getattr(w, "dense_shape", None) or getattr(w, "shape", None)
        if dense is None or len(dense) != 2:
            continue
        a, b = int(dense[0]), int(dense[1])
        for x, y in ((a, b), (b, a)):
            if x <= d0 <= x + _PAD_SLACK and y <= d1 <= y + _PAD_SLACK:
                return path
    return None


def graph_r1(program) -> list:
    """Silent densify: a scatter whose output is shaped like a densified
    sparse weight, with a dense matmul reachable downstream — i.e.
    ``x @ w.to_dense()`` smuggled past the sparse kernels."""
    if program.graph is None or not program.sparse_weights:
        return []
    tainted: dict = {}
    diags = []
    for node in program.graph.nodes:
        if node.op in _SCATTER_OPS:
            path = _shape_matches_weight(node.shape, program.sparse_weights)
            if path is not None:
                tainted[node.index] = path
                if node.op.endswith("_") and node.inputs:
                    tainted[node.inputs[0]] = path   # written in place
                continue
        hit = next((tainted[i] for i in node.inputs if i in tainted), None)
        if hit is None:
            continue
        if node.op in _DENSE_MATMULS:
            diags.append(Diagnostic(
                rule="R1", severity=Severity.ERROR, entry=program.name,
                message=f"sparse weight {hit!r} is densified (scatter) and "
                        f"then contracted by a dense {node.op} — the "
                        f"sparse kernels are silently bypassed",
                op=node.op, location="graph",
                fix="route the contraction through the registered sparse "
                    "op (models.common.mm / kernels.ops.nmg_linear) "
                    "instead of w.to_dense() @ x",
            ))
            continue
        tainted[node.index] = hit
    return diags


def _is_wider_float(dtype, model) -> bool:
    return dtype.is_floating_point and dtype.itemsize > model.itemsize


def graph_r3(program) -> list:
    """Dtype promotion past the model dtype on the decode path, outside
    the allowed accumulation sinks."""
    if program.graph is None or not program.decode_path:
        return []
    model = program.model_dtype
    consumers = program.graph.consumers()
    diags = []
    for node in program.graph.nodes:
        if node.op not in _CASTS or not node.dtypes:
            continue
        if not _is_wider_float(node.dtypes[0], model):
            continue
        sinks = sorted({c.op for c in consumers.get(node.index, [])})
        if sinks and all(s in _PROMOTE_SINKS for s in sinks):
            continue    # f32 accumulation: the kernel contract itself
        out_name = str(node.dtypes[0]).removeprefix("torch.")
        model_name = str(model).removeprefix("torch.")
        diags.append(Diagnostic(
            rule="R3", severity=Severity.ERROR, entry=program.name,
            message=f"decode-path value promoted to {out_name} past the "
                    f"model dtype {model_name} and consumed by "
                    f"{sinks or 'the program output'} — breaks the bitwise "
                    f"decode contract",
            op=node.op, location="graph",
            fix=f"keep elementwise math in {model_name}; widen only inside "
                f"matmul/reduction accumulation",
        ))
    return diags


def graph_r4(program) -> list:
    """Host sync inside a loop program: every step of the decode chunk (or
    every replayed training step) would wait for the host, and the CUDA
    graph the runtime replays cannot be captured."""
    if program.graph is None or not program.loop:
        return []
    diags = []
    for node in program.graph.nodes:
        if node.host_sync:
            diags.append(Diagnostic(
                rule="R4", severity=Severity.ERROR, entry=program.name,
                message="host sync inside a loop program — one host "
                        "round-trip per step defeats the device-resident "
                        "decode/train loop and its CUDA graph",
                op=node.op, location="graph:loop-body",
                fix="keep the value on the device (torch.where, masks) or "
                    "read it once per chunk, outside the program",
            ))
    return diags


def graph_r5(program) -> list:
    """Recompile hazard: a program input that is a Python scalar.  A CUDA
    graph bakes its value in, so every new value costs a new capture —
    the counterpart of a weak-typed input fragmenting the jit cache."""
    if program.graph is None:
        return []
    return [Diagnostic(
        rule="R5", severity=Severity.WARNING, entry=program.name,
        message=f"input {path} is a Python {kind} — a captured program "
                f"freezes its value, so each new value needs a new capture",
        op="input", location="graph:signature",
        fix="pass a 0-dim tensor on the program's device instead of a "
            "Python scalar",
    ) for path, kind in program.graph.scalar_inputs]
