"""Rank bodies of the distributed parity tests (``tests/test_torch_dist_*``).

``repro_torch.launch.mesh.run_ranks`` spawns gloo ranks on the CPU and
runs one of these functions in each; a function imports torch and the
port only (a spawned rank re-imports this module, not the test module
and its JAX), builds its meshes over the ranks, runs the sharded code
and returns plain tensors.  Whatever needs every rank (``full_tensor``
is a collective) runs on every rank; rank 0 returns the results, the
others None.
"""

import dataclasses

import torch


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _leaves(tree):
    """(path, tensor) of every tensor of a params tree, a layout's
    children as ``path.child``."""
    from repro_torch.core.layouts import SparsityLayout

    if isinstance(tree, dict):
        return [(f"{k}.{p}" if p else k, t) for k, v in tree.items()
                for p, t in _leaves(v)]
    if isinstance(tree, SparsityLayout):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)]
    return [("", tree)] if isinstance(tree, torch.Tensor) else []


def collectives(rank, world, payload):
    """The collectives over "data" of an (8, 1) mesh and over "model" of a
    (2, 4) mesh, each rank passing its own contribution."""
    torch.set_num_threads(1)
    from repro_torch.core.layouts import FixedMaskTensor
    from repro_torch.dist import allreduce_mean, compressed_allreduce, \
        densify_allreduce_resparsify, ef_step, fixed_mask_value_allreduce
    from repro_torch.launch.mesh import make_host_mesh

    flat = make_host_mesh(world, 1, device="cpu")
    grid = make_host_mesh(2, world // 2, device="cpu")
    x = payload["x"][rank]
    g = FixedMaskTensor(payload["vals"][rank], payload["mask"])
    (vals, idx), mem = ef_step(payload["grad"], payload["memory"],
                               k_fraction=payload["k_fraction"])
    out = {
        "mean_data": allreduce_mean(x, flat, "data"),
        "mean_model": allreduce_mean(x, grid, "model"),
        "x_in": x,
        "fast": fixed_mask_value_allreduce(g, flat, "data").to_dense(),
        "dense": densify_allreduce_resparsify(g, flat, "data").to_dense(),
        "compressed": compressed_allreduce(vals, idx, payload["grad"].shape,
                                           flat, "data"),
        "memory": mem,
    }
    return out


def train(rank, world, payload):
    """Two sharded train steps on a (2, 4) mesh for each case of
    ``payload["cases"]``: {name: (params, StepConfig fields)}; returns
    each step's metrics and the params after the last step, whole."""
    torch.set_num_threads(1)
    from repro_torch.dist import ShardingRules, distribute_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, make_train_step, \
        shard_batch
    from repro_torch.optim import AdamWConfig, adamw_init

    mesh = make_host_mesh(2, 4, device="cpu")
    rules = ShardingRules()
    cfg = payload["cfg"]
    res = {}
    for name, (params, step_kw) in payload["cases"].items():
        dp = distribute_params(params, mesh, rules)
        state = adamw_init(dp)
        step = make_train_step(cfg, AdamWConfig(), StepConfig(**step_kw),
                               mesh, rules)
        metrics = []
        for batch in payload["batches"]:
            dp, state, m = step(dp, state, shard_batch(batch, mesh, rules))
            metrics.append({k: float(v) for k, v in m.items()})
        res[name] = {"metrics": metrics,
                     "params": {p: _full(t) for p, t in _leaves(dp)},
                     "mu": {p: _full(t) for p, t in _leaves(state["mu"])},
                     "placements": {p: tuple(repr(x) for x in t.placements)
                                    for p, t in _leaves(dp)}}
    return res if rank == 0 else None


def serve_and_moe(rank, world, payload):
    """On four ranks: the sharded prefill and decode steps at (2, 2) over
    n:m:g params, then ``apply_moe_shmap`` at (1, 4) and (2, 2)."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import ShardingRules, distribute_params, use_rules
    from repro_torch.dist.sharding import P, placements_of
    from repro_torch.kernels.ops import kernel_counters, \
        reset_kernel_counters
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, make_decode_step, \
        make_prefill_step, shard_batch
    from repro_torch.models.moe import apply_moe_shmap

    rules = ShardingRules()
    out = {}
    mesh = make_host_mesh(2, 2, device="cpu")
    cfg, params = payload["cfg"], payload["params"]
    dp = distribute_params(params, mesh, rules)
    sc = StepConfig(remat="none")
    prefill = make_prefill_step(cfg, sc, mesh, rules, payload["cache_len"])
    decode = make_decode_step(cfg, sc, mesh, rules)
    reset_kernel_counters()
    logits, cache = prefill(dp, shard_batch({"tokens": payload["tokens"]},
                                            mesh, rules))
    out["prefill_counts"] = kernel_counters()
    logits = _full(logits)
    out["logits"], out["tokens"] = [logits], []
    pos = payload["tokens"].shape[1]
    tok = logits.argmax(-1)[:, None].int()
    reset_kernel_counters()
    for i in range(payload["steps"]):
        out["tokens"].append(tok)
        logits, cache = decode(dp, cache, shard_batch({"t": tok}, mesh,
                                                      rules)["t"], pos + i)
        logits = _full(logits)
        out["logits"].append(logits)
        tok = logits.argmax(-1)[:, None].int()
    out["decode_counts"] = kernel_counters()
    out["cache_placements"] = {k: tuple(repr(x) for x in v.placements)
                               for k, v in cache.items()}

    out["wrappers"] = _wrappers(payload["wrapper_inputs"])

    mcfg, lp, x = payload["moe_cfg"], payload["moe_params"], payload["x"]
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape, device="cpu")
        mp = distribute_params({"layers": {"moe": lp}}, mesh,
                               rules)["layers"]["moe"]
        xd = distribute_tensor(x, mesh, placements_of(P("data"), mesh),
                               src_data_rank=None)
        xd.requires_grad_(True)
        wi = mp["wi"].detach().requires_grad_(True)
        with use_rules(mesh, rules), implicit_replication():
            y, aux = apply_moe_shmap(dict(mp, wi=wi), xd, mcfg)
            # at (2, 2) the aux loss is the shards' mean, not the
            # unsharded one: the outputs' gradients alone are compared
            (y.sum() + (aux if shape == (1, 4) else 0)).backward()
        out[f"moe{shape}"] = (_full(y).detach(), float(_full(aux)),
                              _full(xd.grad), _full(wi.grad))
    return out if rank == 0 else None


def _wrappers(inp):
    """Each kernel wrapper on DTensor operands at (2, 2): rows sharded
    (the local route) and a contraction or m-axis sharded (gathered);
    returns {case: (result whole, placements, counters)}."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import ShardingRules, distribute_params
    from repro_torch.kernels import fused_sparse_matmul, nm_mask, \
        nmg_fused, nmg_gemv, nmg_spmm
    from repro_torch.kernels.ops import kernel_counters, \
        reset_kernel_counters
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 2, device="cpu")
    rep = (Replicate(), Replicate())
    w = distribute_params({"w": inp["w"]}, mesh, ShardingRules())["w"]
    wg = distribute_params({"w": inp["wg"]}, mesh, ShardingRules())["w"]
    cols = distribute_tensor(inp["b"], mesh, (Shard(1), Replicate()),
                             src_data_rank=None)
    kdim = distribute_tensor(inp["b"], mesh, (Replicate(), Shard(0)),
                             src_data_rank=None)
    x = distribute_tensor(inp["x"], mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    x_last = distribute_tensor(inp["x"], mesh, (Shard(0), Shard(1)),
                               src_data_rank=None)
    a = distribute_tensor(inp["a"], mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    bt = distribute_tensor(inp["bt"], mesh, rep, src_data_rank=None)
    cases = {
        "nmg_gemv/local": lambda: nmg_gemv.nmg_gemv(w, cols),
        "nmg_gemv/gathered": lambda: nmg_gemv.nmg_gemv(w, kdim),
        "nmg_spmm/local": lambda: nmg_spmm.nmg_spmm(w, cols,
                                                    transpose_out=True),
        "nmg_qkv/local": lambda: nmg_fused.nmg_qkv([w, w], cols)[1],
        "nmg_ffn/local": lambda: nmg_fused.nmg_ffn(wg, cols),
        "nm_mask/local": lambda: nm_mask.nm_mask(x, 2, 4),
        "nm_mask/gathered": lambda: nm_mask.nm_mask(x_last, 2, 4),
        "matmul_threshold/local": lambda:
            fused_sparse_matmul.matmul_threshold(a, bt, 0.5)[0],
    }
    res = {}
    for name, fn in cases.items():
        reset_kernel_counters()
        y = fn()
        res[name] = (_full(y), tuple(repr(p) for p in y.placements),
                     kernel_counters())
    # the gradient of a replicated B through row-sharded A sums the ranks
    a2 = a.detach().requires_grad_(True)
    b2 = bt.detach().requires_grad_(True)
    val, _ = fused_sparse_matmul.matmul_threshold(a2, b2, 0.5)
    val.sum().backward()
    res["matmul_threshold/grads"] = (_full(a2.grad), _full(b2.grad))
    return res


def families(rank, world, payload):
    """On four ranks at (2, 2), for each case of ``payload["cases"]``
    {name: (cfg, params, kind)}: ``"train"`` one sharded train step
    (remat "none") on ``payload["batch"]`` (its metrics, and the params
    after it, whole); ``"serve"`` the sharded prefill of
    ``payload["tokens"]`` and ``payload["steps"]`` greedy decode steps
    (the logits of each, whole)."""
    torch.set_num_threads(1)
    from repro_torch.dist import ShardingRules, distribute_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, make_decode_step, \
        make_prefill_step, make_train_step, shard_batch
    from repro_torch.optim import AdamWConfig, adamw_init

    mesh = make_host_mesh(2, 2, device="cpu")
    rules = ShardingRules()
    sc = StepConfig(remat="none")
    res = {}
    for name, (cfg, params, kind) in payload["cases"].items():
        dp = distribute_params(params, mesh, rules)
        if kind == "train":
            batch = dict(payload["batch"])
            if cfg.n_enc_layers > 0:
                batch["enc_embeds"] = payload["frames"]
            step = make_train_step(cfg, AdamWConfig(), sc, mesh, rules)
            dp, _, m = step(dp, adamw_init(dp), shard_batch(batch, mesh,
                                                            rules))
            res[name] = {"metrics": {k: float(v) for k, v in m.items()},
                         "params": {p: _full(t) for p, t in _leaves(dp)}}
            continue
        prefill = make_prefill_step(cfg, sc, mesh, rules,
                                    payload["cache_len"])
        decode = make_decode_step(cfg, sc, mesh, rules)
        logits, cache = prefill(dp, shard_batch(
            {"tokens": payload["tokens"]}, mesh, rules))
        out = [_full(logits)]
        pos = payload["tokens"].shape[1]
        for i in range(payload["steps"]):
            tok = out[-1].argmax(-1)[:, None].int()
            logits, cache = decode(dp, cache, shard_batch(
                {"t": tok}, mesh, rules)["t"], pos + i)
            out.append(_full(logits))
        res[name] = {"logits": out}
    return res if rank == 0 else None
