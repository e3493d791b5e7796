"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``).

Runs every (architecture x input-shape) cell's step once against a
production mesh, 16x16 single-pod or 2x16x16 multi-pod, on a fake process
group of 256 or 512 ranks (backend ``"fake"``: rank 0 of a world whose
collectives move nothing), with params, moments, cache and batch on the
``meta`` device (shapes and dtypes, nothing allocated or drawn), and
records per cell a JSON of the per-device FLOPs, bytes and collective
bytes (``launch/cost_analysis.py``), the three roofline terms at the
H100's rates and MODEL_FLOPS.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k \\
        [--multi-pod] [--out experiments/dryrun] [--opt <name>=<val> ...] \\
        [--device cuda|cpu]
    python -m repro_torch.launch.dryrun --all [--multi-pod]

``--device`` names the mesh's device type (``cuda`` by default; ``cpu``
runs it on a host with no card).  Either way nothing runs on a device:
the step runs on meta tensors, and the kernel wrappers take their meta
route (they launch nothing and count ``(kernel, "meta")``).

The record keeps the reference's keys where they have a meaning.  Keys
with no counterpart: ``trace_s`` (the step's one run on meta) replaces
``lower_s`` and ``compile_s``; ``flops_per_dev_xla_raw``,
``bytes_per_dev_xla_raw``, ``num_whiles``, ``max_trip`` and
``hlo_bytes_len`` are left out (nothing is compiled, and the port's
programs have no loop primitive: ``check/graph_pass.py``).
``memory_analysis`` holds the arguments' and outputs' bytes per device,
from the local shards, and ``peak``: the most bytes one rank holds at
once while the step runs eagerly, its arguments included, as
``torch.distributed._tools.mem_tracker.MemTracker`` tracks the meta
storages (:func:`trace_step`).  ``peak`` is null, with ``peak_note``
saying why, where the tracker fails or cannot follow a DTensor program:
a tracker that does not record the fake mode at its entry (before torch
2.13) tracks the ops DTensor's sharding propagation runs on fake tensors
and misses the frees of the step's local tensors (under the card's
torch 2.11 it read 874 GB a rank for qwen1.5-4b ``decode_32k``, which
2.13's reads as 15.3 GB).  Deliberate differences (ROADMAP C2): the step is traced on meta and
compiled nowhere; bytes are the eager port's per-op traffic, not
post-fusion HBM traffic; the collective term uses one NVLink rate,
a lower bound on a 256-rank mesh, which spans 32 nodes of 8 H100s.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_arch, input_specs
from repro_torch.configs.registry import runnable_cells, skip_reason
from repro_torch.core.layouts import GroupedNMTensor, SparsityLayout
from repro_torch.dist.sharding import ShardingRules, distribute_params, \
    is_dtensor
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.cost_analysis import analyze_program, roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import init_cache, init_lm
from repro_torch.optim import AdamWConfig, adamw_init

__all__ = ["count_params", "model_flops", "build_step", "build_cell",
           "run_cell", "trace_step", "fake_world", "sparsify", "main"]


def _leaves(tree):
    """Every tensor of a params tree: dict values, list and tuple items,
    a layout's tensors (its plan's too), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _layouts(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _layouts(v)
    elif isinstance(tree, SparsityLayout):
        yield tree


def count_params(shapes_tree) -> int:
    """Elements of every leaf, the reference's count: a stacked n:m:g
    layout's pattern table counts once a layer, as the reference's
    vmap-stacked plan holds a copy a layer (the port keeps one)."""
    total = sum(int(math.prod(t.shape)) for t in _leaves(shapes_tree))
    for w in _layouts(shapes_tree):
        if isinstance(w, GroupedNMTensor) and w.stacked and w.plan:
            total += (w.val.shape[0] - 1) * w.plan.pat_onehot.numel()
    return total


def _local_bytes(tree) -> int:
    """Bytes of a tree's tensors on one device (a DTensor's local shard)."""
    total = 0
    for t in _leaves(tree):
        if is_dtensor(t):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def model_flops(cfg: ModelConfig, shape, n_params: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), with N = active
    params for MoE (experts scaled by top_k / num_experts)."""
    # embedding params excluded from N (standard convention)
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = n_params - emb
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        # expert weights exactly: wi [E, D, (2)F] + wo [E, F, D] per layer
        f = cfg.moe.d_expert
        per_layer = e * (cfg.d_model * (2 * f if cfg.gated_mlp else f)
                         + f * cfg.d_model)
        expert_p = cfg.n_layers * per_layer
        n_active = n - expert_p + expert_p * (k / e)
    else:
        n_active = n
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0)
    for the body, destroyed after it; one of that size already set is
    used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is set; the mesh needs {world_size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cfg_with_opts(cfg: ModelConfig, opts: dict) -> ModelConfig:
    """The model-execution overrides (hillclimb knobs) of ``opts``."""
    cfg_over = {}
    for k in ("attn_chunk_q", "attn_chunk_k"):
        if k in opts:
            cfg_over[k] = int(opts[k])
    if "attn_dtype" in opts:
        cfg_over["attn_dtype"] = opts["attn_dtype"]
    if "attn_chunk" in opts:
        cfg_over["attn_chunk_q"] = cfg_over["attn_chunk_k"] = \
            int(opts["attn_chunk"])
    if "dtype" in opts:
        cfg_over["dtype"] = opts["dtype"]
    if "kv_cache_dtype" in opts:
        cfg_over["kv_cache_dtype"] = opts["kv_cache_dtype"]
    if cfg.moe is not None and ("moe_combine" in opts or "moe_impl" in opts):
        moe_over = {}
        if "moe_combine" in opts:
            moe_over["combine"] = opts["moe_combine"]
        if "moe_impl" in opts:
            moe_over["impl"] = opts["moe_impl"]
        cfg_over["moe"] = dataclasses.replace(cfg.moe, **moe_over)
    if cfg.ssm is not None and ("ssm_chunk" in opts or "ssm_dtype" in opts):
        ssm_over = {}
        if "ssm_chunk" in opts:
            ssm_over["chunk"] = int(opts["ssm_chunk"])
        if "ssm_dtype" in opts:
            ssm_over["acc_dtype"] = opts["ssm_dtype"]
        cfg_over["ssm"] = dataclasses.replace(cfg.ssm, **ssm_over)
    return cfg.scaled(**cfg_over) if cfg_over else cfg


def sparsify(params, opts: dict):
    """The paper's technique in the traced program, as the reference's
    dry-run puts it there: ``sparse=masked`` gives ``FixedMaskTensor``
    n:m:g weights (masked sparse training), ``sparse=nmg``
    ``GroupedNMTensor`` compressed weights, on ``*mlp.w*``,
    ``*attn.wq`` and ``*attn.wo``; ``nm`` (n:m:g, 2:4:16 by default)
    and ``gr`` (8) set the format.  On meta params nothing is searched."""
    from repro_torch.core.builder import SparsityBuilder
    from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor
    from repro_torch.core.sparsifiers import GroupedNMSparsifier

    mode = opts["sparse"]
    if mode not in ("masked", "nmg"):
        raise ValueError(f"sparse={mode!r}: masked or nmg")
    n_, m_, g_ = (int(v) for v in opts.get("nm", "2:4:16").split(":"))
    sp = GroupedNMSparsifier(n_, m_, g_, gr=int(opts.get("gr", 8)),
                             sparse_dim=0)
    layout = FixedMaskTensor if mode == "masked" else GroupedNMTensor
    sb = SparsityBuilder()
    sb.set_weight("*mlp.w*", sp, layout)
    sb.set_weight("*attn.wq", sp, layout)
    sb.set_weight("*attn.wo", sp, layout)
    return sb.sparsify_params(params)


def build_step(cfg: ModelConfig, shape, mesh, opts: dict):
    """(step fn, args, meta params) of ``cfg``'s step for ``shape`` (a
    ``ShapeSpec``) on ``mesh``: params (sparsified by ``opts``), moments,
    cache and batch on meta, distributed by the rules of ``opts``."""
    rules = ShardingRules(**{k: v for k, v in opts.items()
                             if k in ShardingRules.__dataclass_fields__})
    step_cfg = steps_mod.StepConfig(
        remat=opts.get("remat", "full"),
        kv_cache_dtype=opts.get("kv_cache_dtype"),
    )

    p_shapes = init_lm(cfg, device="meta")
    if opts.get("sparse"):
        p_shapes = sparsify(p_shapes, opts)
    params = distribute_params(p_shapes, mesh, rules)
    batch = steps_mod.shard_batch(input_specs(cfg, shape), mesh, rules)

    if shape.kind == "train":
        fn = steps_mod.make_train_step(cfg, AdamWConfig(), step_cfg, mesh,
                                       rules)
        args = (params, adamw_init(params), batch)
    elif shape.kind == "prefill":
        fn = steps_mod.make_prefill_step(cfg, step_cfg, mesh, rules,
                                         cache_len=shape.seq_len)
        args = (params, batch)
    else:  # decode
        enc_len = 1500 if cfg.n_enc_layers > 0 else 0
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           enc_len=enc_len, device="meta")
        fn = steps_mod.make_decode_step(cfg, step_cfg, mesh, rules)
        args = (params, steps_mod.shard_cache(cache, mesh, rules),
                batch["token"], torch.zeros((), dtype=torch.int32,
                                            device="meta"))
    return fn, args, p_shapes


def build_cell(arch: str, shape_name: str, multi_pod: bool, opts: dict,
               device: str = "cuda"):
    """(cfg, shape, mesh, step fn, args, meta params) of one cell on its
    production mesh (a process group of the mesh's size must be set:
    :func:`fake_world`)."""
    cfg = _cfg_with_opts(get_arch(arch), opts)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    fn, args, p_shapes = build_step(cfg, shape, mesh, opts)
    return cfg, shape, mesh, fn, args, p_shapes


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             opts: dict, tag: str = "baseline", device: str = "cuda"
             ) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "opts": {k: str(v) for k, v in opts.items()}, "ok": False}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["skipped"] = reason
        _write(rec, out_dir)
        return rec
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            cfg, shape, mesh, fn, args, p_shapes = build_cell(
                arch, shape_name, multi_pod, opts, device)
            t1 = time.time()
            cost, out, peak, note = trace_step(fn, args)
            t_trace = time.time() - t1
            arg_b, out_b = _local_bytes(args), _local_bytes(out)
        coll = cost["collectives"]
        n_chips = math.prod(mesh.mesh.shape)
        n_params = count_params(p_shapes)
        flops_dev, bytes_dev = cost["flops"], cost["bytes"]
        terms = roofline_terms(flops_dev, bytes_dev, float(coll["total"]))
        mf = model_flops(cfg, shape, n_params)
        rec.update({
            "ok": True,
            "trace_s": round(t_trace, 2),
            "chips": n_chips,
            "n_params": n_params,
            "flops_per_dev": flops_dev,
            "bytes_per_dev": bytes_dev,
            "collective_bytes_per_dev": coll,
            "kernels": cost["kernels"],
            "memory_analysis": {"argument_size": arg_b,
                                "output_size": out_b, "peak": peak,
                                **({"peak_note": note} if note else {})},
            "roofline": {
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
            },
            "model_flops_total": mf,
            "model_flops_per_dev": mf / n_chips,
            "useful_flops_ratio": (mf / n_chips) / max(flops_dev, 1.0),
        })
    except Exception as e:  # record the failure: these are faults to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def trace_step(fn, args) -> tuple:
    """(cost, outputs, peak bytes or None, note) of one run of ``fn(*args)``
    under :func:`analyze_program`, inside a ``MemTracker`` that tracks
    ``args`` (module docstring); without the tracker's peak where it
    fails or cannot follow a DTensor program."""
    box = {}

    def run(*a):
        box["out"] = fn(*a)

    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        mt = MemTracker()
        mt.track_external(*_leaves(args))
        with mt:
            follows = hasattr(mt, "_fake_mode_on_entry")
            if follows:
                cost = analyze_program(run, *args)
    except Exception as e:  # the tracker's fault: count without it
        note = f"MemTracker failed: {type(e).__name__}: {e}"[:300]
        return analyze_program(run, *args), box["out"], None, note
    if not follows:
        return analyze_program(run, *args), box["out"], None, (
            "this torch's MemTracker cannot follow a DTensor program "
            "(it records no fake mode at entry)")
    peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    return cost, box["out"], int(peak), None


def _write(rec, out_dir):
    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    if rec.get("tag") and rec["tag"] != "baseline":
        name += f"_{rec['tag']}"
    (p / (name.replace("/", "-") + ".json")).write_text(
        json.dumps(rec, indent=1, default=str)
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--opt", action="append", default=[],
                    help="hillclimb option name=value (e.g. remat=none)")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu on a host "
                         "with no card); the step itself runs on meta")
    args = ap.parse_args(argv)

    opts = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        opts[k] = None if v == "None" else v

    if args.all:
        for arch, shape, reason in runnable_cells():
            rec = run_cell(arch, shape, args.multi_pod, args.out, opts,
                           args.tag, args.device)
            status = ("SKIP: " + reason) if reason else \
                ("ok" if rec.get("ok") else "FAIL: " + rec.get("error", "?"))
            print(f"{arch:22s} {shape:12s} {rec['mesh']:8s} "
                  f"{rec.get('wall_s', 0.0):8.2f}s {status}", flush=True)
    else:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.out, opts,
                       args.tag, args.device)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}, indent=1, default=str))
        if not rec.get("ok") and not rec.get("skipped"):
            print(rec.get("traceback", ""))
            raise SystemExit(1)


if __name__ == "__main__":
    main()
