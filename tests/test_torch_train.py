"""The port's masked-training path against the JAX package's, on the same
numpy inputs: masks and sparsifiers, the builder, SameFormat
re-sparsification, GMP schedules, AdamW, the data pipeline, the loss with
the inline threshold, and whole training steps on the bert-base-sten
SMOKE config in f32 (the reference's params carried over by the bridge).

Tolerances, each with its reason:
- masks, GMP levels, data batches and SparsityBuilder's values: exact (the
  same comparisons on the same values, f32 ramps evaluated in the same
  order, numpy code copied);
- AdamW on one tree: 1e-6 (f32 elementwise arithmetic; ``pow`` and
  ``sqrt`` may round one ulp apart between XLA and PyTorch);
- loss and gradients: 1e-5 relative (f32 sums in another order);
- training steps: per-step losses within 1e-4 relative.  Final values
  within ``rtol = 1e-4`` plus ``atol = 3 * lr * steps``: Adam's
  ``m_hat / sqrt(v_hat)`` is bounded by about 1.2 at these betas and
  turns the sign flip of a near-zero gradient (an f32 summation-order
  difference) into a step of about ``lr`` the other way, once per step at
  most.  Final masks equal except where the two runs' values straddle the
  pruning threshold, counted and asserted to be at most 0.5% of a leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import nmg as jnmg
from repro.core import sparsifiers as jsp
from repro.core.builder import SparsityBuilder as JaxBuilder
from repro.core.layouts import FixedMaskTensor as JaxFixedMask
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMPipeline as JaxPipeline
from repro.launch import train as jtrain
from repro.models import init_lm as jax_init_lm
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import GMPSchedule as JaxGMP
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import value_and_grad_sparse
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import nmg as tnmg
from repro_torch.core import sparsifiers as tsp
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init, \
    adamw_update

from tests._torch_compat import params_to_numpy, sparsifier_to_dict

LR = 3e-4
STEPS = 6


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_kernel_counters()


def _both(x: np.ndarray, dtype=jnp.float32):
    xj = jnp.asarray(x, dtype)
    return xj, bridge.tensor_from_numpy(np.asarray(xj), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _fixed_leaves(tree, path=()):
    """{path: FixedMask leaf} of a params tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_fixed_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (JaxFixedMask, FixedMaskTensor)):
        return {".".join(path): tree}
    return {}


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.75, 0.9])
@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_unstructured_mask_equals_reference(dtype, shape, sparsity):
    xj, xt = _both(np.random.default_rng(0).standard_normal(shape), dtype)
    got = tnmg.unstructured_mask(xt, sparsity)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(
        _np(got), np.asarray(jnmg.unstructured_mask(xj, sparsity),
                             np.float32))


SPARSIFIERS = [("scalar_fraction", "ScalarFractionSparsifier", (0.6,)),
               ("nm_2_4", "NMSparsifier", (2, 4)),
               ("nm_1_4", "NMSparsifier", (1, 4)),
               ("keep_all", "KeepAll", ()),
               ("threshold", "ScalarThresholdSparsifier", (0.5,))]


@pytest.mark.parametrize("name,cls,args", SPARSIFIERS,
                         ids=[s[0] for s in SPARSIFIERS])
def test_sparsifier_masks_equal_reference(name, cls, args):
    """Each ported sparsifier's mask and masked output equal the
    reference's, on a stacked bf16 leaf with ties."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32, 24))
    x[0, :4] = 0.25          # ties
    xj, xt = _both(x, jnp.bfloat16)
    got = getattr(tsp, cls)(*args)
    want = getattr(jsp, cls)(*args)
    np.testing.assert_array_equal(got.mask(xt).numpy(),
                                  np.asarray(want.mask(xj)))
    np.testing.assert_array_equal(_np(got(xt)),
                                  np.asarray(want(xj), np.float32))


def _jax_dense_params(cfg):
    return jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_smoke("bert-base-sten"), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype="float32",
                               **kw)
    return jcfg, tcfg


def _nm_builders():
    jb, tb = JaxBuilder(), SparsityBuilder()
    for pat in ("*mlp.wo*", "*attn.wo*"):
        jb.set_weight(pat, jsp.NMSparsifier(2, 4), JaxFixedMask)
        tb.set_weight(pat, tsp.NMSparsifier(2, 4), FixedMaskTensor)
    return jb, tb


def _assert_fixed_equal(jtree, ttree):
    jl, tl = _fixed_leaves(jtree), _fixed_leaves(ttree)
    assert jl.keys() == tl.keys() and jl
    for k in jl:
        np.testing.assert_array_equal(tl[k].mask.numpy(),
                                      np.asarray(jl[k].mask))
        np.testing.assert_array_equal(_np(tl[k].val), np.asarray(jl[k].val))
        assert sparsifier_to_dict(jl[k].origin) == (
            None if tl[k].origin is None else
            {"type": type(tl[k].origin).__name__,
             **dataclasses.asdict(tl[k].origin)})


@pytest.mark.parametrize("how", ["scalar_fraction", "nm_2_4"])
def test_builder_matches_reference(how):
    """Per-layer sparsification of the stacked SMOKE leaves, to
    FixedMaskTensor with its origin: equal masks and values."""
    jcfg, _ = _cfgs()
    jp = _jax_dense_params(jcfg)
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    if how == "scalar_fraction":
        jout = jtrain.build_sparse_params(jp, 0.5)
        tout = ttrain.build_sparse_params(tp, 0.5)
    else:
        jb, tb = _nm_builders()
        jout, tout = jb.sparsify_params(jp), tb.sparsify_params(tp)
        # 2 stacked leaves x 2 layers, one nm_mask call per layer
        assert tops.kernel_counters()[("nm_mask", "plain")] == 4
    _assert_fixed_equal(jout, tout)


RESPARSIFY = ["fixed", "native_nm", "native_fraction", "generic",
              "retarget"]


@pytest.mark.parametrize("mode", RESPARSIFY)
def test_same_format_resparsify_matches_reference(mode):
    """SameFormatSparsifier on FixedMask references: the fixed pattern,
    the origin's native recompute (n:m and magnitude), the generic
    rank recompute (no origin, ties to the lowest index), and the GMP
    retarget of a magnitude origin at a new level (global over the
    stacked leaf)."""
    rng = np.random.default_rng(2)
    old = rng.standard_normal((2, 16, 24))
    new = rng.standard_normal((2, 16, 24))
    new[1, :3] = 0.5                     # ties for the rank recompute
    origin = {"native_nm": ("NMSparsifier", (2, 4))}.get(
        mode, ("ScalarFractionSparsifier", (0.5,)))
    jo, to = (getattr(jsp, origin[0])(*origin[1]),
              getattr(tsp, origin[0])(*origin[1]))
    oj, ot = _both(old)
    nj, nt = _both(new)
    jm = jo.mask(oj)
    jref_t = JaxFixedMask(oj * jm, jm, None if mode == "generic" else jo)
    tref_t = bridge.params_from_numpy(params_to_numpy(jref_t), device="cpu")
    assert isinstance(tref_t, FixedMaskTensor)
    if mode == "retarget":
        from repro.optim.sparse_update import resparsify_params as jres
        from repro_torch.optim import resparsify_params as tres

        want = jres({"w": JaxFixedMask(nj, jref_t.mask, jo)},
                    recompute_pattern=True, target_sparsity=0.8)["w"]
        got = tres({"w": FixedMaskTensor(nt, tref_t.mask, to)},
                   recompute_pattern=True, target_sparsity=0.8)["w"]
    else:
        fixed = mode == "fixed"
        want = jsp.SameFormatSparsifier(fixed).resparsify(jref_t, nj)
        got = tsp.SameFormatSparsifier(fixed).resparsify(tref_t, nt)
    _assert_fixed_equal({"w": want}, {"w": got})


SCHEDULES = {
    "one_shot": dict(mode="one_shot", target_sparsity=0.7, begin_step=5),
    "iterative": dict(mode="iterative", target_sparsity=0.6, begin_step=2,
                      end_step=14, recompute_every=5, num_layers=2),
    "layer_wise": dict(mode="layer_wise", target_sparsity=0.8,
                       begin_step=10, end_step=300, recompute_every=20,
                       num_layers=12),
    # the reference's ramp is not monotone here (ROADMAP C2): the port
    # matches its values and asserts nothing about monotonicity
    "iterative_non_monotone": dict(mode="iterative", target_sparsity=0.3617,
                                   begin_step=0, end_step=323,
                                   recompute_every=1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_gmp_schedule_equals_reference(name):
    kw = SCHEDULES[name]
    got, want = GMPSchedule(**kw), JaxGMP(**kw)
    for s in range(401):
        assert got.sparsity_at(s) == want.sparsity_at(s), s
        assert got.recompute_at(s) == want.recompute_at(s), s
        assert got.layers_pruned_at(s) == want.layers_pruned_at(s), s


def test_adamw_update_equals_reference():
    """Two AdamW updates (clipping active, decay on >= 2-D leaves only) on
    a tree with a stacked FixedMaskTensor leaf, its mask untouched."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 8, 6)).astype(np.float32)
    mask = rng.random((2, 8, 6)) < 0.5
    leaves = {"b": rng.standard_normal(6), "e": rng.standard_normal((10, 4))}
    jp = {"w": JaxFixedMask(jnp.asarray(w * mask), jnp.asarray(mask),
                            jsp.ScalarFractionSparsifier(0.5)),
          **{k: jnp.asarray(v, jnp.float32) for k, v in leaves.items()}}
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    cfg_kw = dict(lr=1e-2, grad_clip=0.5)
    jcfg, tcfg = JaxAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for step in range(2):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("w", w.shape), ("b", (6,)), ("e", (10, 4)))}
        jg = {"w": JaxFixedMask(jnp.asarray(g["w"]), None, jp["w"].origin),
              "b": jnp.asarray(g["b"]), "e": jnp.asarray(g["e"])}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jp, js, jm = jax_adamw_update(jg, js, jp, jcfg)
        tp, ts, tm = adamw_update(tg, ts, tp, tcfg)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-6)
        assert ts["step"] == int(js["step"]) == step + 1
        np.testing.assert_allclose(_np(tp["w"].val), np.asarray(jp["w"].val),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(tp["w"].mask, torch.from_numpy(mask))
        for k in ("b", "e"):
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(_np(ts["mu"][k]),
                                       np.asarray(js["mu"][k]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts["nu"]["w"]),
                                   np.asarray(js["nu"]["w"].val),
                                   rtol=1e-6, atol=1e-9)


def test_batch_at_equals_reference():
    kw = dict(vocab=512, seq_len=32, global_batch=4, seed=3)
    got, want = SyntheticLMPipeline(DataConfig(**kw)), \
        JaxPipeline(JaxDataConfig(**kw))
    for step in (0, 1, 2, 7, 100):
        b, w = got.batch_at(step), want.batch_at(step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == w[k].dtype
            np.testing.assert_array_equal(b[k], w[k])


def test_bridge_round_trips_fixed_mask_leaves():
    """A JAX FixedMaskTensor crosses as {val, mask, origin} and comes back
    as the port's twin, origin rebuilt as the port's sparsifier."""
    rng = np.random.default_rng(4)
    val = jnp.asarray(rng.standard_normal((3, 5, 8)), jnp.bfloat16)
    for origin in (jsp.NMSparsifier(2, 4), jsp.ScalarFractionSparsifier(0.3),
                   None):
        jt = JaxFixedMask(val, val > 0, origin)
        tt = bridge.params_from_numpy(params_to_numpy({"w": jt}),
                                      device="cpu")["w"]
        assert isinstance(tt, FixedMaskTensor)
        assert tt.val.dtype == torch.bfloat16 and tt.mask.dtype == torch.bool
        np.testing.assert_array_equal(_np(tt.val),
                                      np.asarray(val, np.float32))
        np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(val > 0))
        assert sparsifier_to_dict(origin) == (
            None if tt.origin is None else
            {"type": type(tt.origin).__name__,
             **dataclasses.asdict(tt.origin)})
        np.testing.assert_array_equal(_np(tt.to_dense()),
                                      np.asarray(jt.to_dense(), np.float32))
        one = tt.unbind()[1]
        assert torch.equal(one.val, tt.val[1]) and one.origin == tt.origin


def _batch(cfg, step=0):
    return SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=3)).batch_at(step)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


@pytest.mark.parametrize("threshold", [None, 0.05])
def test_loss_and_grads_equal_reference(threshold):
    """loss_fn and every parameter's gradient on the SMOKE config, with
    and without the MLP's inline threshold (which runs the fused
    matmul_threshold path in both packages), within 1e-5 relative."""
    jcfg, tcfg = _cfgs(mlp_inline_threshold=threshold)
    jp = _jax_dense_params(jcfg)
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    batch = _batch(tcfg)
    (jl, jaux), jg = value_and_grad_sparse(
        lambda p: jax_loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              remat="none"), has_aux=True)(jp)
    tl, taux, tg = ttrain.loss_and_grads(
        tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(taux["moe_aux"]) == 0.0
    want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got[path] = t

    walk(tg, ())
    assert len(got) == len(want)
    for path, g in want.items():
        key = tuple(p.key for p in path)
        assert _rel(_np(got[key]), np.asarray(g)) <= 1e-5, key
    n_mt = tops.kernel_counters().get(("matmul_threshold", "plain"), 0)
    assert n_mt == (tcfg.n_layers if threshold is not None else 0)


def _run_reference(jcfg, jp, gmp, data):
    step_fn = jtrain.make_train_step(jcfg, JaxAdamWConfig(lr=LR))
    js = jax_adamw_init(jp)
    losses = []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
        if gmp.recompute_at(s):
            jp = jtrain.retarget_sparsity(jp, gmp.sparsity_at(s))
        jp, js, m = step_fn(jp, js, batch)
        losses.append(float(m["loss"]))
    return jp, losses


@pytest.mark.parametrize("how", ["scalar_fraction", "nm_inline"])
def test_training_steps_equal_reference(how):
    """Six steps of the host loop from the same initial params: GMP
    iterative to 0.5 with a recompute before steps 0..4 (what
    ``--sparsity 0.5 --gmp iterative --steps 6`` schedules).
    ``scalar_fraction``: the CLI's magnitude-pruned FixedMask leaves on
    ``mlp`` and ``attn.wo``.  ``nm_inline``: NMSparsifier(2, 4) leaves on
    ``mlp.wo`` / ``attn.wo`` (nm_mask at build and at every recompute)
    and the inline threshold 0.05 on the dense ``mlp.wi``
    (matmul_threshold in every forward)."""
    threshold = 0.05 if how == "nm_inline" else None
    jcfg, tcfg = _cfgs(mlp_inline_threshold=threshold)
    sched = dict(mode="iterative", target_sparsity=0.5, begin_step=0,
                 end_step=4, recompute_every=1, num_layers=2)
    jp = _jax_dense_params(jcfg)
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    jgmp, tgmp = JaxGMP(**sched), GMPSchedule(**sched)
    if how == "scalar_fraction":
        jp = jtrain.build_sparse_params(jp, jgmp.sparsity_at(0))
        tp = ttrain.build_sparse_params(tp, tgmp.sparsity_at(0))
    else:
        jb, tb = _nm_builders()
        jp, tp = jb.sparsify_params(jp), tb.sparsify_params(tp)
    _assert_fixed_equal(jp, tp)
    dkw = dict(vocab=tcfg.vocab, seq_len=32, global_batch=2, seed=3)
    jp, jl = _run_reference(jcfg, jp, jgmp, JaxPipeline(JaxDataConfig(**dkw)))
    out = ttrain.train_loop(tp, adamw_init(tp), ttrain.make_train_step(
        tcfg, AdamWConfig(lr=LR)), SyntheticLMPipeline(DataConfig(**dkw)),
        start=0, stop=STEPS, device="cpu", gmp=tgmp, log_every=STEPS)
    assert out["recomputes"] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(out["losses"], jl, rtol=1e-4)
    counts = tops.kernel_counters()
    if how == "nm_inline":
        # build: 2 leaves x 2 layers; each recompute: 2 stacked leaves
        assert counts[("nm_mask", "plain")] == 4 + 2 * 5
        assert counts[("matmul_threshold", "plain")] == tcfg.n_layers * STEPS
    else:
        assert ("nm_mask", "plain") not in counts
    jfix, tfix = _fixed_leaves(jp), _fixed_leaves(out["params"])
    assert jfix.keys() == tfix.keys()
    for k in jfix:
        m_t, m_j = tfix[k].mask.numpy(), np.asarray(jfix[k].mask)
        flipped = int((m_t != m_j).sum())
        assert flipped <= m_j.size // 200, (k, flipped)
        same = m_t == m_j
        _assert_trained_equal(_np(tfix[k].val)[same],
                              np.asarray(jfix[k].val)[same], k)
    jd = dict(jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=lambda x: isinstance(x, JaxFixedMask))[0])
    for path, leaf in jd.items():
        if isinstance(leaf, JaxFixedMask):
            continue
        t = out["params"]
        for p in path:
            t = t[p.key]
        _assert_trained_equal(_np(t), np.asarray(leaf), path)


def _assert_trained_equal(got, want, key):
    """Final weights after ``STEPS`` updates from the same start.  Both
    packages sum in f32 in different orders, which moves an update by
    about 1e-4 * LR (at most 6e-3 * LR on these inputs), so every entry
    must lie within 1e-2 * LR of the reference.  Adam's ``m / sqrt(v)``
    turns a sign flip of a near-zero gradient into +-LR per step, so one
    entry in a thousand may differ by up to 2 * LR * STEPS.  A skipped,
    wrong or sign-flipped update moves nearly every entry by about LR."""
    err = np.abs(got - want)
    off = int((err > 1e-2 * LR).sum())
    assert off <= want.size // 1000, (key, off, float(err.max()))
    assert float(err.max()) <= 2 * LR * STEPS, key


def test_cli_trains_the_smoke_config_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train ... --device cpu``: the
    default masked path (magnitude FixedMask leaves, iterative GMP)
    trains with finite losses and reaches the target sparsity."""
    args = ttrain.parse_args(["--arch", "bert-base-sten", "--smoke",
                              "--steps", "6", "--batch", "2", "--seq", "16",
                              "--sparsity", "0.5", "--gmp", "iterative",
                              "--device", "cpu"])
    out = ttrain.run(args)
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    for leaf in _fixed_leaves(out["params"]).values():
        kept = float(leaf.mask.float().mean())
        assert kept == pytest.approx(0.5, abs=0.01)
    assert ttrain.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                        "8", "--device", "cpu"]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
