"""The port's sharded steps (``launch/steps.py``), the DTensor boundary of
the kernel wrappers (``kernels/_dtensor.py``), the expert-parallel MoE
and the ``scatter`` combine (``models/moe.py``), and remat, against the
unsharded port and the reference.

The reference's own sharded step is no oracle (its 8-device tests are
red, ROADMAP C5), so a sharded step is held to the port's unsharded step
(itself held to the reference by the other ``test_torch_*`` files) and,
where the reference runs unsharded, to the reference: its ``loss_fn``
and its single-device ``apply_moe``.  Multi-rank runs are gloo ranks on
the CPU, one spawn for each world size (``tests/_torch_dist_ranks.py``).
Bounds, all f32: a sharded step sums its contraction and norm partials
in another order than one process does, so the loss, gnorm and the AdamW
moments (which carry the gradients) are held at rtol 1e-5 (the moments
at atol 1e-8), masks and tokens exactly, and the params at rtol 1e-5
with atol lr / 16: AdamW's step ``lr * m / sqrt(v)`` passes a rounding
difference in a small ``m`` or ``v`` on as a fraction of lr (one weight
of 8192 in bert SMOKE's ``wq`` moves 3.9e-6 = 0.013 lr apart after two
steps, its moments within 2e-10).  The MoE at the MoE tests' rtol/atol
1e-4; remat bitwise.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.train import build_sparse_params as j_build_sparse
from repro.models import loss_fn as j_loss_fn
from repro.models import moe as j_moe
from repro_torch import bridge
from repro_torch.kernels import fused_sparse_matmul, nm_mask, nmg_fused, \
    nmg_gemv, nmg_spmm
from repro_torch.core import OutFormat
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.core.sparsifiers import ScalarFractionSparsifier
from repro_torch.launch.train import loss_and_grads, make_train_step
from repro_torch.models import decode_step, forward, moe, prefill
from repro_torch.models.transformer import layer_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    resparsify_params_, sparse_aware_update
from tests._torch_compat import params_to_numpy, smoke_setup

TRAIN_STEPS = 2
RTOL = 1e-5
PARAM_ATOL = AdamWConfig().lr / 16
MOE_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT, CACHE_LEN, DECODE_STEPS = 24, 32, 6


def _need_gloo():
    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend")


def _batches(vocab):
    rng = np.random.default_rng(11)
    return [{k: torch.from_numpy(rng.integers(0, vocab, (4, 8)))
             for k in ("tokens", "labels")} for _ in range(TRAIN_STEPS)]


#: the gradient format of the "grad_formats" case: attn.wo's gradient
#: pruned to its largest half by magnitude
GRAD_FORMATS = {"*attn.wo": OutFormat(external=ScalarFractionSparsifier(0.5))}


def _plain_step(cfg, step_kw):
    """The unsharded step for the sharded one of ``StepConfig(**step_kw)``:
    ``launch/train.py``'s step; with gradient formats
    ``sparse_aware_update(grad_formats=)``; with ``recompute_pattern``
    the update followed by one recompute from the raw values in place of
    the fixed pattern (the reference's ``sparse_aware_update(
    recompute_pattern=True)``)."""
    if step_kw.get("grad_formats"):
        def step(p, state, batch):
            loss, _, grads = loss_and_grads(p, cfg, batch)
            p, state, m = sparse_aware_update(
                lambda g, s, q: adamw_update(g, s, q, AdamWConfig()), grads,
                state, p, grad_formats=step_kw["grad_formats"])
            return p, state, {"loss": loss, "gnorm": m["gnorm"]}
    elif step_kw.get("recompute_pattern"):
        def step(p, state, batch):
            loss, _, grads = loss_and_grads(p, cfg, batch)
            p, state, m = adamw_update(grads, state, p, AdamWConfig())
            resparsify_params_(p, recompute_pattern=True)
            return p, state, {"loss": loss, "gnorm": m["gnorm"]}
    else:
        step = make_train_step(cfg, AdamWConfig())
    return step


def _random_masks(params):
    """``params`` with ``mlp.wi``, ``mlp.wo`` and ``attn.wo`` as
    FixedMask leaves of seeded random half masks over their unpruned
    values, magnitude-pruned origins: a pattern recompute re-prunes them
    by magnitude and moves the masks."""
    rng = np.random.default_rng(8)
    out = copy.deepcopy(params)
    for group, name in (("mlp", "wi"), ("mlp", "wo"), ("attn", "wo")):
        v = out["layers"][group][name]
        mask = torch.from_numpy(rng.random(tuple(v.shape)) < 0.5)
        out["layers"][group][name] = FixedMaskTensor(
            v, mask, ScalarFractionSparsifier(0.5))
    return out


@pytest.fixture(scope="module")
def train_run():
    """bert SMOKE (f32): dense at remat "none", masked-sparse (the
    reference's 50% magnitude masks) at remat "full", masked-sparse with
    a pattern recompute after each step, and dense with a gradient format
    on ``attn.wo``: two sharded steps on eight ranks at (2, 4), and the
    same two steps unsharded."""
    _need_gloo()
    from repro_torch.launch.mesh import run_ranks
    from tests import _torch_dist_ranks

    jcfg, tcfg, jp, tp = smoke_setup(False, "bert-base-sten")
    jsparse = j_build_sparse(jp, 0.5)
    tsparse = bridge.params_from_numpy(params_to_numpy(jsparse),
                                       device="cpu")
    cases = {"dense": (tp, {"remat": "none"}),
             "sparse": (tsparse, {"remat": "full"}),
             "recompute": (_random_masks(tp), {"remat": "none",
                                               "recompute_pattern": True}),
             "grad_formats": (tp, {"remat": "none",
                                   "grad_formats": GRAD_FORMATS})}
    batches = _batches(tcfg.vocab)
    sharded = run_ranks(_torch_dist_ranks.train, 8,
                        {"cfg": tcfg, "batches": batches, "cases": cases})[0]
    plain = {}
    for name, (params, step_kw) in cases.items():
        p = copy.deepcopy(params)
        state = adamw_init(p)
        step = _plain_step(tcfg, step_kw)
        metrics = []
        for b in batches:
            p, state, m = step(p, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        plain[name] = {"metrics": metrics,
                       "start": dict(_torch_dist_ranks._leaves(params)),
                       "params": dict(_torch_dist_ranks._leaves(p)),
                       "mu": dict(_torch_dist_ranks._leaves(state["mu"]))}
    refs = {"dense": jp, "sparse": jsparse, "grad_formats": jp}
    return jcfg, refs, batches, sharded, plain


CASES = ["dense", "sparse", "recompute", "grad_formats"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_metrics_equal_unsharded(train_run, case):
    _, _, _, sharded, plain = train_run
    for got, want in zip(sharded[case]["metrics"], plain[case]["metrics"]):
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_params_and_masks_equal_unsharded(train_run, case):
    """After two steps every moment and param equals the unsharded
    step's within the bounds, and every mask exactly."""
    _, _, _, sharded, plain = train_run
    for k, t in plain[case]["mu"].items():
        np.testing.assert_allclose(sharded[case]["mu"][k].numpy(), t.numpy(),
                                   rtol=RTOL, atol=1e-8, err_msg=k)
    got, want = sharded[case]["params"], plain[case]["params"]
    assert got.keys() == want.keys()
    for k, t in want.items():
        if t.dtype == torch.bool:
            assert torch.equal(got[k], t), k
        else:
            np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
    if case in ("sparse", "recompute"):
        assert any(k.endswith("mask") for k in got)
    if case == "recompute":    # the recompute moved some mask
        start = plain[case]["start"]
        assert any(not torch.equal(t, start[k]) for k, t in want.items()
                   if t.dtype == torch.bool)


@pytest.mark.parametrize("case", ["dense", "sparse", "grad_formats"])
def test_sharded_train_loss_equals_the_reference_loss_fn(train_run, case):
    """The first step's loss is the reference's unsharded ``loss_fn`` of
    the same params and batch."""
    jcfg, refs, batches, sharded, _ = train_run
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batches[0].items()}
    want, _ = j_loss_fn(refs[case], jcfg, jb, remat="none")
    np.testing.assert_allclose(sharded[case]["metrics"][0]["loss"],
                               float(want), rtol=RTOL)


def test_sharded_params_follow_the_rules(train_run):
    """Params stay where the rules put them at (2, 4): the embedding's
    vocab over "model", the MLP's ff over "model", norms replicated, and
    a mask on its value's placements."""
    _, _, _, sharded, _ = train_run
    dense, sparse = (sharded[c]["placements"] for c in ("dense", "sparse"))
    assert dense["embedding"] == ("Replicate()", "Shard(dim=0)")
    assert dense["layers.mlp.wi"] == ("Replicate()", "Shard(dim=2)")
    assert dense["layers.mlp.wo"] == ("Replicate()", "Shard(dim=1)")
    assert dense["final_norm"] == ("Replicate()", "Replicate()")
    assert sparse["layers.mlp.wi.mask"] == sparse["layers.mlp.wi.val"] == \
        dense["layers.mlp.wi"]


def _wrapper_inputs(tq):
    rng = np.random.default_rng(5)
    lay = layer_params(tq["layers"], 0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    return {"w": lay["attn"]["wq"], "wg": lay["mlp"]["wi"],
            "b": f32(lay["attn"]["wq"].dense_shape[0], 8), "x": f32(8, 32),
            "a": f32(8, 64), "bt": f32(64, 16)}


@pytest.fixture(scope="module")
def serve_run():
    """qwen SMOKE with n:m:g 1:4:8 gr16 weights (attention too): the
    sharded prefill of [2, 24] prompts and six decode steps at (2, 2);
    each kernel wrapper on DTensor operands; moonshot SMOKE's first MoE
    layer through ``apply_moe_shmap`` at (1, 4) and (2, 2).  Four ranks."""
    _need_gloo()
    from repro_torch.launch.mesh import run_ranks
    from tests import _torch_dist_ranks

    _, qcfg, _, qp = smoke_setup(True, "qwen1.5-4b")
    jmcfg, mcfg, jm, mp = smoke_setup(False, "moonshot-v1-16b-a3b")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, qcfg.vocab, (2, PROMPT)))
    x = torch.from_numpy(rng.standard_normal((4, 8, mcfg.d_model)).astype(
        np.float32))
    payload = {"cfg": qcfg, "params": qp, "tokens": tokens,
               "cache_len": CACHE_LEN, "steps": DECODE_STEPS,
               "wrapper_inputs": _wrapper_inputs(qp),
               "moe_cfg": dataclasses.replace(
                   mcfg, moe=dataclasses.replace(mcfg.moe, impl="shmap")),
               "moe_params": layer_params(mp["layers"], 0)["moe"], "x": x}
    res = run_ranks(_torch_dist_ranks.serve_and_moe, 4, payload)[0]
    return payload, res, (jmcfg, jm, mcfg)


def test_sharded_prefill_and_decode_tokens_equal_unsharded(serve_run):
    """Greedy tokens of the sharded prefill and decode steps equal the
    unsharded ``prefill`` / ``decode_step``'s, and their logits agree."""
    payload, res, _ = serve_run
    cfg, params = payload["cfg"], payload["params"]
    logits, cache = prefill(params, cfg, payload["tokens"], CACHE_LEN)
    want_logits, want_tokens = [logits], []
    tok = logits.argmax(-1)[:, None].int()
    for i in range(DECODE_STEPS):
        want_tokens.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache, PROMPT + i)
        want_logits.append(logits)
        tok = logits.argmax(-1)[:, None].int()
    for got, want in zip(res["tokens"], want_tokens):
        assert torch.equal(got, want)
    for got, want in zip(res["logits"], want_logits):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sharded_steps_launch_every_decode_kernel_at_the_boundary(serve_run):
    """The sharded prefill runs the SpMM (24 local rows), the decode
    steps the GEMV, the fused QKV and the fused FFN, each through the
    DTensor boundary on its local rows; the cache is sharded by batch
    over "data" and by sequence over "model"."""
    _, res, _ = serve_run
    pre, dec = res["prefill_counts"], res["decode_counts"]
    assert pre.get(("nmg_spmm", "dtensor_local"), 0) > 0
    for kernel in ("nmg_gemv", "nmg_qkv", "nmg_ffn"):
        assert sum(n for (k, route), n in dec.items()
                   if k == kernel and route.startswith("dtensor_")) > 0, \
            kernel
    assert res["cache_placements"]["k"] == ("Shard(dim=1)", "Shard(dim=2)")


def test_every_kernel_wrapper_takes_a_dtensor(serve_run):
    """Each wrapper of ``KERNEL_WRAPPERS`` on DTensor operands equals its
    plain version on the whole tensors, counted as local where only rows
    are sharded and as gathered where the contraction dim or the m-axis
    is; the gradients through ``matmul_threshold`` equal the unsharded
    ones (B's summed over the row shards)."""
    payload, res, _ = serve_run
    inp, out = payload["wrapper_inputs"], res["wrappers"]
    w, wg, b = inp["w"], inp["wg"], inp["b"]
    want = {
        "nmg_gemv/local": nmg_gemv.nmg_gemv_plain(w, b),
        "nmg_gemv/gathered": nmg_gemv.nmg_gemv_plain(w, b),
        "nmg_spmm/local": nmg_spmm.nmg_spmm_plain(w, b, transpose_out=True),
        "nmg_qkv/local": nmg_gemv.nmg_gemv_plain(w, b),
        "nmg_ffn/local": nmg_fused.nmg_ffn_plain(wg, b),
        "nm_mask/local": nm_mask.nm_mask_plain(inp["x"], 2, 4),
        "nm_mask/gathered": nm_mask.nm_mask_plain(inp["x"], 2, 4),
        "matmul_threshold/local": fused_sparse_matmul.matmul_threshold_plain(
            inp["a"], inp["bt"], 0.5)[0],
    }
    from repro_torch.kernels.ops import KERNEL_WRAPPERS
    assert {k.split("/")[0] for k in want} == set(KERNEL_WRAPPERS)
    for name, ref in want.items():
        got, placements, counts = out[name]
        kernel, how = name.split("/")
        assert counts == {(kernel, f"dtensor_{how}"): 1}, (name, counts)
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert out["nm_mask/gathered"][1] == ("Shard(dim=0)", "Shard(dim=1)")
    a = inp["a"].clone().requires_grad_(True)
    bt = inp["bt"].clone().requires_grad_(True)
    fused_sparse_matmul.matmul_threshold(a, bt, 0.5)[0].sum().backward()
    ga, gb = out["matmul_threshold/grads"]
    np.testing.assert_allclose(ga.numpy(), a.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), bt.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", ["(1, 4)", "(2, 2)"])
def test_apply_moe_shmap_equals_the_reference_apply_moe(serve_run, shape):
    """Expert parallelism over "model" (and data parallelism over "data")
    gives the reference's single-device ``apply_moe`` output.  No slot is
    dropped here (checked): the expert-parallel body sizes its capacity
    from its local tokens, as the reference's does.  The gradients of x
    and ``wi`` equal the unsharded ones; at (1, 4) the aux loss and its
    gradients too (at (2, 2) the aux loss is the mean of the two shards',
    the reference's ``pmean``, and only the outputs' gradients are
    compared)."""
    payload, res, (jcfg, jm, tcfg) = serve_run
    x = payload["x"]
    with moe.route_log() as log:
        moe.apply_moe(payload["moe_params"], x, tcfg)
    assert log.calls[0]["keep"].all()
    jlp = {k: v[0] for k, v in jm["layers"]["moe"].items()}
    want, waux = j_moe.apply_moe(jlp, jnp.asarray(x.numpy()), jcfg)
    y, aux, gx, gwi = res[f"moe{shape}"]
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **MOE_TOL)
    one_shard = shape == "(1, 4)"
    if one_shard:      # one data shard routes every token
        np.testing.assert_allclose(aux, float(waux), rtol=1e-5)
    # gradients flow through the expert-parallel body (its reductions
    # are DTensor redistributes): those of the unsharded apply_moe
    xt = x.clone().requires_grad_(True)
    lp = dict(payload["moe_params"])
    lp["wi"] = lp["wi"].clone().requires_grad_(True)
    yt, at = moe.apply_moe(lp, xt, tcfg)
    (yt.sum() + (at if one_shard else 0)).backward()
    np.testing.assert_allclose(gx.numpy(), xt.grad.numpy(), **MOE_TOL)
    np.testing.assert_allclose(gwi.numpy(), lp["wi"].grad.numpy(),
                               **MOE_TOL)


@pytest.mark.parametrize("arch,capacity_factor", [
    ("moonshot-v1-16b-a3b", 1.25), ("moonshot-v1-16b-a3b", 0.5),
    ("arctic-480b", 1.25)])
def test_scatter_combine_equals_the_reference(arch, capacity_factor):
    """On one device the ``scatter`` combine equals the reference's
    ``scatter`` (the sink row drops the slots past capacity, as its
    ``mode="drop"`` does), and the gather combine within rounding."""
    jcfg, tcfg, jp, tp = smoke_setup(False, arch)
    kw = dict(combine="scatter", capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **kw))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **kw))
    assert tcfg.check_ported() is tcfg
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    lp = layer_params(tp["layers"], 1)["moe"]
    jlp = {k: v[1] for k, v in jp["layers"]["moe"].items()}
    with moe.route_log() as log:
        y, aux = moe.apply_moe(lp, torch.from_numpy(x), tcfg)
    if capacity_factor < 1:
        assert not log.calls[0]["keep"].all()
    want, waux = j_moe.apply_moe(jlp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    gather = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, combine="gather"))
    np.testing.assert_allclose(
        y.numpy(), moe.apply_moe(lp, torch.from_numpy(x), gather)[0].numpy(),
        rtol=1e-5, atol=1e-6)


def test_shmap_without_a_mesh_is_apply_moe():
    """Without active rules ``impl="shmap"`` is ``apply_moe``, bitwise, as
    the reference falls back to its pjit path."""
    _, tcfg, _, tp = smoke_setup(False, "moonshot-v1-16b-a3b")
    shmap = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl="shmap"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 9)))
    a = forward(tp, shmap, toks, with_aux=True)
    b = forward(tp, tcfg, toks, with_aux=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["bert-base-sten", "gemma2-9b",
                                  "moonshot-v1-16b-a3b", "whisper-large-v3",
                                  "hymba-1.5b"])
def test_remat_full_is_bitwise_none(arch):
    """``remat="full"`` (each layer body, a pair's two layers, the
    encoder's layers, recomputed in the backward) gives the loss, its aux
    terms and every gradient of ``remat="none"`` bit for bit."""
    _, cfg, _, params = smoke_setup(False, arch)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)))
             for k in ("tokens", "labels")}
    if cfg.n_enc_layers:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32))
    l0, a0, g0 = loss_and_grads(params, cfg, batch, remat="none")
    l1, a1, g1 = loss_and_grads(params, cfg, batch, remat="full")
    assert torch.equal(l0, l1)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)
    from tests._torch_dist_ranks import _leaves
    for (k, x), (_, y) in zip(_leaves(g0), _leaves(g1)):
        assert torch.equal(x, y), k


def test_remat_takes_none_or_full():
    _, cfg, _, params = smoke_setup(False, "bert-base-sten")
    toks = torch.zeros((1, 4), dtype=torch.long)
    assert torch.equal(forward(params, cfg, toks, remat="full"),
                       forward(params, cfg, toks))
    with pytest.raises(ValueError, match="remat"):
        forward(params, cfg, toks, remat="dots")
