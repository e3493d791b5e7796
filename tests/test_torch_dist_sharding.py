"""The port's sharding rules (``repro_torch.dist.sharding``,
``launch/steps.py:cache_specs``) and meshes (``launch/mesh.py``) against
the reference's.

Spec trees are compared entry by entry: the reference's ``param_specs``
over ``jax.eval_shape(init_lm)`` on a ``jax.sharding.AbstractMesh``, the
port's over its own SMOKE params on the matching abstract mesh (a
mapping {axis: size}); every ported family on meshes (1, 1), (2, 4),
(8, 1), (1, 8) and the multi-pod (2, 16, 16), and the layout cases (a
``FixedMaskTensor``'s value and mask co-sharded, n:m:g replicated).  The
production meshes are built on a fake process group.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.dist import sharding as js
from repro.launch import steps as jsteps
from repro.launch.train import build_sparse_params as j_build_sparse
from repro.models import init_cache as j_init_cache, init_lm as j_init_lm
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor
from repro_torch.dist import sharding as ts
from repro_torch.launch import steps as tsteps
from repro_torch.models import init_lm
from tests._torch_compat import params_to_numpy, smoke_setup

ARCHS = ["bert-base-sten", "qwen1.5-4b", "starcoder2-15b", "gemma2-9b",
         "paligemma-3b", "minicpm3-4b", "moonshot-v1-16b-a3b",
         "arctic-480b", "mamba2-370m", "hymba-1.5b", "whisper-large-v3"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (jax.sharding.AbstractMesh(shape, axes), dict(zip(axes, shape)))


def _spec_items(tree, path=""):
    """{path: spec tuple} of a spec tree of either package; a layout node's
    children as ``path.child``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_items(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (FixedMaskTensor, GroupedNMTensor)) or \
            dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, tuple) and not isinstance(v, type(None)) and \
                    f.name not in ("dense_shape",):
                out[f"{path}.{f.name}"] = tuple(v)
        return out
    return {path: None if tree is None else tuple(tree)}


def _j_specs(arch, jmesh):
    cfg = j_smoke(arch)
    shapes = jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), cfg))
    return js.param_specs(shapes, js.ShardingRules(), jmesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    """Every leaf of every ported family's SMOKE params gets the
    reference's spec on every mesh."""
    jmesh, tmesh = _meshes(mesh)
    want = _spec_items(_j_specs(arch, jmesh))
    got = _spec_items(ts.param_specs(init_lm(get_smoke(arch), device="cpu"),
                                     ts.ShardingRules(), tmesh))
    assert got == want
    if mesh != "1x1":
        assert any(v for v in got.values()), "nothing sharded"


@pytest.fixture(scope="module")
def layouts():
    """bert SMOKE with masked-sparse (FixedMask) params and qwen SMOKE
    with n:m:g 1:4:8 gr16 params, in both packages."""
    _, _, jp, _ = smoke_setup(False, "bert-base-sten")
    jmask = j_build_sparse(jp, 0.5)
    tmask = bridge.params_from_numpy(params_to_numpy(jmask), device="cpu")
    _, _, jnmg, tnmg = smoke_setup(True, "qwen1.5-4b")
    return {"fixed_mask": (jmask, tmask), "nmg": (jnmg, tnmg)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["fixed_mask", "nmg"])
def test_layout_specs_equal_the_reference(layouts, case, mesh):
    """A ``FixedMaskTensor``'s value and mask get one spec (the dense
    rule's), an n:m:g leaf replicates every child; both as the reference
    gives them."""
    jmesh, tmesh = _meshes(mesh)
    jp, tp = layouts[case]
    jspecs = js.param_specs(jp, js.ShardingRules(), jmesh)
    tspecs = ts.param_specs(tp, ts.ShardingRules(), tmesh)
    got, want = _spec_items(tspecs), _spec_items(jspecs)
    kind = FixedMaskTensor if case == "fixed_mask" else GroupedNMTensor
    nodes = [v for v in _walk(tspecs) if isinstance(v, kind)]
    assert nodes
    for node in nodes:
        if case == "fixed_mask":
            assert node.val == node.mask
        else:
            assert node.val == () and node.blk_idx == ()
    for k, v in want.items():
        assert got[k] == v, k


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_the_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    for shape in [(), (1,), (2, 8), (3, 5), (4, 16), (8, 4, 6), (16, 2),
                  (32, 7), (512, 3), (1024, 1)]:
        x = np.zeros(shape, np.int32)
        assert tuple(ts.batch_spec(x, ts.ShardingRules(), tmesh)) == tuple(
            js.batch_spec(x, js.ShardingRules(), jmesh)), shape


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh):
    """``cache_specs`` over the reference's decode cache shapes (B = 16,
    S = 64; an enc-dec model's with 32 frames) equals the reference's."""
    jmesh, tmesh = _meshes(mesh)
    cfg = j_smoke(arch)
    shapes = jax.eval_shape(lambda: j_init_cache(
        cfg, 16, 64, enc_len=32 if cfg.n_enc_layers else 0))
    want = _spec_items(jsteps.cache_specs(shapes, jmesh, js.ShardingRules()))
    got = _spec_items(tsteps.cache_specs(_meta(shapes), tmesh,
                                         ts.ShardingRules()))
    assert got == want


def test_opt_specs_mirror_the_moments(layouts):
    """ZeRO-3: the moments' specs are the trainable tensors' (a
    ``FixedMaskTensor``'s value spec), the step counter replicated; the
    reference's spec for every dense leaf."""
    jmesh, tmesh = _meshes("2x4")
    jp, tp = layouts["fixed_mask"]
    tspecs = ts.param_specs(tp, ts.ShardingRules(), tmesh)
    o = tsteps.opt_specs(tspecs)
    jo = jsteps.opt_specs(js.param_specs(jp, js.ShardingRules(), jmesh))
    assert tuple(o["step"]) == tuple(jo["step"]) == ()
    for k in ("mu", "nu"):
        for path, spec in _spec_items(o[k]).items():
            node = tspecs
            for part in path.strip("/").split("/"):
                node = node[part]
            want = node.val if isinstance(node, FixedMaskTensor) else node
            assert spec == tuple(want), path


def test_rules_resolve_and_placements():
    """``resolve`` keeps the axes a mesh has (the comma form too), and a
    spec's placements shard each mesh dim where the spec puts its axis."""
    from torch.distributed.tensor import Replicate, Shard

    for field in ("batch", "seq", "heads", "vocab"):
        for avail in ({"data", "model"}, {"pod", "data", "model"},
                      {"model"}):
            for rules in (ts.ShardingRules(),
                          ts.ShardingRules(heads="data,model"),
                          ts.ShardingRules(batch=None, seq="model")):
                jr = js.ShardingRules(**dataclasses.asdict(rules))
                assert rules.resolve(field, avail) == jr.resolve(field, avail)
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert ts.placements_of(ts.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert ts.placements_of(ts.P(), mesh) == (Replicate(),) * 3
    specs = {"a": ts.P(None, "model"), "b": None}
    assert ts.tree_shardings(specs, {"data": 2, "model": 4}) == {
        "a": (Replicate(), Shard(1)), "b": None}


def test_logical_constraint_is_the_identity_on_one_card():
    """On a plain tensor, with or without rules active, and with no
    rules on anything, the constraint returns its input itself."""
    x = torch.randn(4, 8, 16)
    assert ts.logical_constraint(x, ("batch", "seq", None)) is x
    with ts.use_rules({"data": 2, "model": 4}, ts.ShardingRules()):
        assert ts.active_rules()[1] == ts.ShardingRules()
        assert ts.logical_constraint(x, ("batch", "seq", None)) is x
    assert ts.active_rules() is None


def test_production_meshes_on_a_fake_process_group():
    """Both production meshes build on a fake process group of their
    size, with the reference's shapes and axis names; any other world
    size is a ``ValueError`` naming it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(ValueError, match="world size is 0"):
        make_production_mesh(device="cpu")
    for world, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            want = ((2, 16, 16), ("pod", "data", "model")) if multi else \
                ((16, 16), ("data", "model"))
            assert (tuple(mesh.mesh.shape), mesh.mesh_dim_names) == want
            assert ts.mesh_axes(mesh) == dict(zip(want[1], want[0]))
            with pytest.raises(ValueError, match=f"world size is {world}"):
                make_production_mesh(multi_pod=not multi, device="cpu")
            with pytest.raises(ValueError, match=f"world size is {world}"):
                make_host_mesh(2, 2, device="cpu")
            # the specs of a full-size config on the 256/512-rank mesh
            from repro_torch.configs import get_config
            cfg = get_config("qwen1.5-4b")
            shapes = {"embedding": torch.empty(cfg.vocab, cfg.d_model,
                                               device="meta")}
            spec = ts.param_specs(shapes, ts.ShardingRules(), mesh)
            assert tuple(spec["embedding"]) == ("model", None)
        finally:
            dist.destroy_process_group()


def test_host_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh(1, 1)
