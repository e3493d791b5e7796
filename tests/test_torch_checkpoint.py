"""The port's checkpoints (``repro_torch/ckpt``) and the trainer's
checkpoint, resume and SIGTERM paths, on the CPU: the reference's six
checkpoint behaviours (``tests/test_checkpoint.py``); the manifest's
leaf index (names, shapes, dtypes, hashes) equal to the reference's for
the same bridged params and optimizer state; checkpoints of either
package restored by the other; and ``python -m repro_torch.launch.train``
resumed from step 3 of 6 bit for bit equal to the run it resumes, through
the graph trainer and through ``--host-loop``; every sparse layout
(``DenseTensor``, ``CsrTensor``, ``CooTensor``, ``NMTensor``,
``GroupedNMTensor`` with and without its plan) written by either package
and restored by the other, and a model with n:m:g and n:m leaves resumed
bit for bit.  Every comparison is exact: the same bytes go through the
same formats."""

import dataclasses
import json
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_pytree as jax_load
from repro.ckpt import save_pytree as jax_save
from repro.configs import get_smoke as jax_smoke
from repro.core import layouts as jl
from repro.core.layouts import FixedMaskTensor as JaxFixedMask
from repro.launch.train import build_sparse_params as jax_build
from repro.models import init_lm as jax_init_lm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_smoke
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor, \
    NMTensor
from repro_torch.core.sparsifiers import GroupedNMSparsifier, NMSparsifier, \
    ScalarFractionSparsifier
from repro_torch.launch import train as ttrain
from repro_torch.launch.graphs import state_tensors
from repro_torch.models import init_lm
from repro_torch.optim import AdamWConfig, adamw_init

from tests._torch_compat import jax_dense_to_grouped_nm, params_to_numpy


def _tree():
    g = torch.Generator().manual_seed(0)
    val = torch.randn(8, 8, generator=g)
    return {"dense": torch.randn(8, 16, generator=g),
            "bf16": torch.randn(4, 4, generator=g).to(torch.bfloat16),
            "sparse": FixedMaskTensor(val * (val > 0), val > 0,
                                      ScalarFractionSparsifier(0.5)),
            "pair": (torch.arange(3, dtype=torch.int32), None),
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, FixedMaskTensor):
        return [tree.val, tree.mask]
    return [] if tree is None else [tree]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck", meta={"step": 7})
    t2, meta = load_pytree(t, tmp_path / "ck")
    assert meta["step"] == 7
    _assert_tree_equal(t, t2)
    assert isinstance(t2["sparse"], FixedMaskTensor)
    assert t2["sparse"].origin == t["sparse"].origin
    assert t2["pair"][1] is None and t2["bf16"].dtype == torch.bfloat16
    man = json.loads((tmp_path / "ck" / "MANIFEST.json").read_text())
    assert [e["name"] for e in man["index"]] == [
        "bf16", "dense", "pair.0", "sparse.0", "sparse.1", "step"]
    assert [e["dtype"] for e in man["index"]] == [
        "bfloat16", "float32", "int32", "float32", "bool", "int32"]


def test_corruption_detected(tmp_path):
    t = {"w": torch.arange(16.0)}
    save_pytree(t, tmp_path / "ck")
    man = json.loads((tmp_path / "ck" / "MANIFEST.json").read_text())
    man["index"][0]["sha"] = "deadbeefdeadbeef"
    (tmp_path / "ck" / "MANIFEST.json").write_text(json.dumps(man))
    with pytest.raises(IOError):
        load_pytree(t, tmp_path / "ck")


def test_structure_mismatch_detected(tmp_path):
    save_pytree({"w": torch.ones(4)}, tmp_path / "ck")
    with pytest.raises(ValueError):
        load_pytree({"w": torch.ones(4), "extra": torch.ones(2)},
                    tmp_path / "ck")
    with pytest.raises(ValueError):
        load_pytree({"w": torch.ones(5)}, tmp_path / "ck")


def test_manager_rotation_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30):
        mgr.save(step, {"w": torch.full((4,), float(step))}, blocking=True)
    assert mgr.latest_step() == 30
    assert len(list(tmp_path.glob("step_*"))) == 2   # rotation kept two
    step, got, meta = mgr.restore_latest({"w": torch.zeros(4)})
    assert step == 30 and meta["step"] == 30
    assert torch.equal(got["w"], torch.full((4,), 30.0))
    assert CheckpointManager(tmp_path / "empty").restore_latest(
        {"w": torch.zeros(4)}) == (None, None, None)


def test_restore_template_shape_only(tmp_path):
    """A fresh job restores from ``meta`` tensors (shape and dtype only)
    onto the device it names."""
    t = {"w": torch.randn(4, 4), "m": torch.rand(4) > 0.5}
    save_pytree(t, tmp_path / "ck")
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in t.items()}
    t2, _ = load_pytree(template, tmp_path / "ck")
    _assert_tree_equal(t, t2)
    assert t2["w"].device.type == "cpu"


def test_atomic_commit_no_partial(tmp_path):
    """A finished save leaves no temporary directory and a MANIFEST in
    every step directory; an async save's host copy does not see later
    in-place updates."""
    mgr = CheckpointManager(tmp_path)
    w = torch.ones(8)
    mgr.save(1, {"w": w})
    w.add_(1.0)                       # the trainer updates in place
    mgr.wait()
    for d in tmp_path.glob("step_*"):
        assert (d / "MANIFEST.json").exists() and not d.name.endswith(".tmp")
    assert (tmp_path / "LATEST").read_text() == "1"
    assert torch.equal(mgr.restore_latest({"w": w})[1]["w"], torch.ones(8))


def _bridged():
    """The reference's bf16 SMOKE params, magnitude-pruned, with their
    AdamW state, and the port's bridged twins."""
    cfg = jax_smoke("bert-base-sten")
    jp = jax_build(jax.jit(jax_init_lm, static_argnums=1)(
        jax.random.PRNGKey(0), cfg), 0.5)
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    return jp, tp


def test_manifest_index_equals_reference(tmp_path):
    """The same params and AdamW state through both packages' writers:
    leaf names, keys, shapes, dtypes, hashes and the tree hash equal."""
    jp, tp = _bridged()
    want = jax_save({"params": jp, "opt": jax_adamw_init(jp)},
                    tmp_path / "jax")
    got = save_pytree(ttrain.ckpt_tree(tp, adamw_init(tp)), tmp_path / "pt")
    assert any(e["dtype"] == "bfloat16" for e in want["index"])
    assert any(e["dtype"] == "bool" for e in want["index"])
    assert got["index"] == want["index"]
    assert got["tree_hash"] == want["tree_hash"]
    assert got["num_leaves"] == want["num_leaves"]


def test_checkpoints_cross_restore(tmp_path):
    """Params the reference wrote, restored by the port to equal tensors
    (FixedMask leaves rebuilt with the template's origin), and the port's
    checkpoint restored by the reference."""
    jp, tp = _bridged()
    jax_save(jp, tmp_path / "jax")
    got, _ = load_pytree(tp, tmp_path / "jax")
    _assert_tree_equal(got, tp)
    assert got["layers"]["mlp"]["wi"].origin == tp["layers"]["mlp"]["wi"].origin
    save_pytree(tp, tmp_path / "pt")
    back, _ = jax_load(jp, tmp_path / "pt")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert isinstance(back["layers"]["mlp"]["wi"], JaxFixedMask)


def _cli(ckpt_dir, *extra):
    return ["--arch", "bert-base-sten", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "16", "--sparsity", "0.5", "--gmp",
            "iterative", "--log-every", "2", "--ckpt-every", "3",
            "--ckpt-dir", str(ckpt_dir), "--device", "cpu", *extra]


def _state(out):
    return state_tensors(out["params"], out["opt_state"])


@pytest.mark.parametrize("loop", [[], ["--host-loop"]],
                         ids=["graph", "host_loop"])
def test_cli_resume_equals_uninterrupted(tmp_path, loop):
    """Six steps with a checkpoint every 3; then a second run resumed
    from that run's step-3 checkpoint: its losses for steps 3..5 and its
    final params, masks, moments and step counter bit for bit equal."""
    full = ttrain.run(ttrain.parse_args(_cli(tmp_path / "a", *loop)))
    assert full["rc"] == 0 and full["start_step"] == 0
    assert CheckpointManager(tmp_path / "a").latest_step() == 6
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    (tmp_path / "b" / "LATEST").write_text("3")
    res = ttrain.run(ttrain.parse_args(_cli(tmp_path / "b", "--resume",
                                            *loop)))
    assert res["rc"] == 0 and res["start_step"] == 3
    assert res["losses"] == full["losses"][3:]
    assert res["gnorms"] == full["gnorms"][3:]
    assert res["recomputes"] == [s for s in full["recomputes"] if s >= 3]
    for a, b in zip(_state(res), _state(full)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(res["opt_state"]["step"]) == 6
    # the final checkpoints hold the same bytes
    ia, ib = (json.loads((tmp_path / d / "step_00000006" / "MANIFEST.json")
                         .read_text())["index"] for d in "ab")
    assert ia == ib


@pytest.mark.parametrize("loop,saved", [([], 2), (["--host-loop"], 2)],
                         ids=["graph", "host_loop"])
def test_sigterm_saves_steps_completed(tmp_path, monkeypatch, loop, saved):
    """SIGTERM while step 1 is fetched: the run finishes the chunk (of 2
    steps) or the step it is in, saves a blocking checkpoint at the steps
    completed, returns 1 and puts the previous SIGTERM handler back; the
    run resumed from there ends bit for bit where an uninterrupted run
    ends."""
    batch_at = ttrain.SyntheticLMPipeline.batch_at

    def terminating(self, step, *a):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)
        return batch_at(self, step, *a)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(ttrain.SyntheticLMPipeline, "batch_at", terminating)
    assert ttrain.main(_cli(tmp_path / "a", *loop)) == 1
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) is before
    assert CheckpointManager(tmp_path / "a").latest_step() == saved
    res = ttrain.run(ttrain.parse_args(_cli(tmp_path / "a", "--resume",
                                            *loop)))
    assert res["start_step"] == saved and res["rc"] == 0
    full = ttrain.run(ttrain.parse_args(_cli(tmp_path / "b", *loop)))
    assert res["losses"] == full["losses"][saved:]
    for a, b in zip(_state(res), _state(full)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# every sparse layout, both ways (the reference flattens each as a pytree)
# ---------------------------------------------------------------------------

LAYOUTS = ["dense", "csr", "coo", "nm", "gnm", "gnm_no_plan"]
#: each layout's static fields, which ride in the template
STATIC = {"DenseTensor": (), "CsrTensor": ("dense_shape",),
          "CooTensor": ("dense_shape",), "NMTensor": ("n", "m", "dense_shape"),
          "GroupedNMTensor": ("n", "m", "g", "gr", "dense_shape",
                              "sparse_dim")}


def _layout_pair(kind):
    """One seeded [32, 48] matrix (about half zeros) in the reference's
    layout ``kind``, and its bridged port twin."""
    x = np.random.default_rng(3).standard_normal((32, 48)).astype(np.float32)
    x[np.abs(x) < 0.7] = 0
    jx = jnp.asarray(x)
    if kind == "dense":
        j = jl.DenseTensor(jx)
    elif kind == "csr":
        j = jl.CsrTensor.from_dense(jx)
    elif kind == "coo":
        j = jl.CooTensor.from_dense(jx)
    elif kind == "nm":
        j = jl.NMTensor.from_dense(jx, 2, 4)
    else:
        j = jax_dense_to_grouped_nm(jx, n=1, m=4, g=2, gr=8, sparse_dim=0)
    t = bridge.params_from_numpy({"w": params_to_numpy(j)}, device="cpu")["w"]
    if kind == "gnm_no_plan":
        j, t = (dataclasses.replace(j, plan=None),
                dataclasses.replace(t, plan=None))
    return j, t


def _static(layout) -> dict:
    return {f: getattr(layout, f) for f in STATIC[type(layout).__name__]}


@pytest.mark.parametrize("kind", LAYOUTS)
def test_layout_manifest_equals_reference(tmp_path, kind):
    """The same layout through both writers: leaf names (``w.0``,
    ``w.2.1``, ...), shapes, dtypes and hashes equal; no ``w.2`` leaves
    without a plan."""
    j, t = _layout_pair(kind)
    want = jax_save({"w": j}, tmp_path / "jax")
    got = save_pytree({"w": t}, tmp_path / "pt")
    names = [e["name"] for e in want["index"]]
    assert [e["name"] for e in got["index"]] == names
    assert got["index"] == want["index"]
    assert got["tree_hash"] == want["tree_hash"]
    assert any(n.startswith("w.2.") for n in names) == (kind == "gnm")


@pytest.mark.parametrize("kind", LAYOUTS)
def test_layout_written_by_reference_restores_in_port(tmp_path, kind):
    j, t = _layout_pair(kind)
    jax_save({"w": j}, tmp_path / "jax")
    got, _ = load_pytree({"w": t}, tmp_path / "jax")
    got = got["w"]
    assert type(got) is type(t) and type(got).__name__ == type(j).__name__
    assert _static(got) == _static(j)
    if isinstance(got, GroupedNMTensor):
        assert (got.plan is None) == (j.plan is None) and got._layers == {}
    flat_j = jax.tree_util.tree_leaves(j)
    flat_t = [leaf for _, leaf in _flatten(got)]
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert str(a.numpy().dtype) == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(j.to_dense()))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_layout_written_by_port_restores_in_reference(tmp_path, kind):
    j, t = _layout_pair(kind)
    save_pytree({"w": t}, tmp_path / "pt")
    back, _ = jax_load({"w": j}, tmp_path / "pt")
    back = back["w"]
    assert type(back) is type(j)
    assert _static(back) == _static(t)
    flat_b = jax.tree_util.tree_leaves(back)
    flat_t = [leaf for _, leaf in _flatten(t)]
    assert len(flat_b) == len(flat_t)
    for a, b in zip(flat_b, flat_t):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_model_with_nmg_and_nm_leaves_resumes_bitwise(tmp_path):
    """bert-base-sten SMOKE (f32) with n:m:g 1:4:8 gr16 ``mlp.wi`` /
    ``mlp.wo`` and 2:4 NMTensor ``attn.wo``: one step, a checkpoint of
    params and AdamW state, a second step; the tree restored from the
    checkpoint and stepped once equals the unbroken run bit for bit."""
    cfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype="float32")
    sb = SparsityBuilder()
    sp = GroupedNMSparsifier(1, 4, 8, 16, sparse_dim=0)
    sb.set_weight("*mlp.wi", sp, GroupedNMTensor)
    sb.set_weight("*mlp.wo", sp, GroupedNMTensor)
    sb.set_weight("*attn.wo", NMSparsifier(2, 4), NMTensor)
    params = sb.sparsify_params(init_lm(cfg, seed=0, device="cpu"))
    opt = adamw_init(params)
    step = ttrain.make_train_step(cfg, AdamWConfig())
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                   dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    params, opt, _ = step(params, opt, batches[0])
    man = save_pytree(ttrain.ckpt_tree(params, opt), tmp_path / "ck")
    names = [e["name"] for e in man["index"]]
    for leaf in ("params.layers.mlp.wi.2.0", "params.layers.attn.wo.1",
                 "opt.mu.layers.mlp.wi.0", "opt.nu.layers.attn.wo.0"):
        assert leaf in names
    restored, _ = load_pytree(ttrain.ckpt_tree(params, opt), tmp_path / "ck")
    p2, o2 = ttrain._from_ckpt_tree(restored)
    assert isinstance(p2["layers"]["mlp"]["wi"], GroupedNMTensor)
    assert isinstance(p2["layers"]["attn"]["wo"], NMTensor)
    params, opt, m1 = step(params, opt, batches[1])
    p2, o2, m2 = step(p2, o2, batches[1])
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(_flatten(ttrain.ckpt_tree(params, opt)),
                    _flatten(ttrain.ckpt_tree(p2, o2))):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]
