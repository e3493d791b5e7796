"""The port's checkpoints (``repro_torch/ckpt``) and the trainer's
checkpoint, resume and SIGTERM paths, on the CPU: the reference's six
checkpoint behaviours (``tests/test_checkpoint.py``); the manifest's
leaf index (names, shapes, dtypes, hashes) equal to the reference's for
the same bridged params and optimizer state; checkpoints of either
package restored by the other; and ``python -m repro_torch.launch.train``
resumed from step 3 of 6 bit for bit equal to the run it resumes, through
the graph trainer and through ``--host-loop``.  Every comparison is exact:
the same bytes go through the same formats."""

import json
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import load_pytree as jax_load
from repro.ckpt import save_pytree as jax_save
from repro.configs import get_smoke as jax_smoke
from repro.core.layouts import FixedMaskTensor as JaxFixedMask
from repro.launch.train import build_sparse_params as jax_build
from repro.models import init_lm as jax_init_lm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.core.sparsifiers import ScalarFractionSparsifier
from repro_torch.launch import train as ttrain
from repro_torch.launch.graphs import state_tensors
from repro_torch.optim import adamw_init

from tests._torch_compat import params_to_numpy


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
