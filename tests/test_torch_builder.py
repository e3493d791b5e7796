"""The port's SparsityBuilder, intermediate tags and gradient formats
against the JAX package's, on the same numpy inputs: weight rules
(exact, glob, stacked), ``get_sparse_model`` with an intermediate plan,
``trace_intermediates`` on a small function and on the model's forward,
prefill and decode, and the bert-base-sten SMOKE model (f32) under the
plan

    set_weight("*mlp.wo", NMSparsifier(2, 4), NMTensor)
    set_weight("*mlp.wi", GroupedNMSparsifier(1, 4, 16, sparse_dim=0))
    set_interm("mlp.act", NMSparsifier(2, 4))
    set_weight_grad("*attn.wo", OutFormat(external=...))

— the built layouts, dispatch routes and conversions, the loss, and three
training steps through ``sparse_aware_update(grad_formats=...)``.

Tolerances, each with its reason:
- layouts built from the same weights: n:m offsets and values exact (the
  ``nm_mask`` rule equals ``lax.top_k`` on f32 values without NaN or
  subnormals); n:m:g masks equal except where two blocks' score sums tie
  within f32 rounding (counted: at most 0.5% of a leaf);
- routes, conversion pairs, traced sites and warnings: exact;
- losses and activations: 1e-4 relative (f32 sums in another order);
- three training steps: per-step losses within 1e-4 relative, final
  values as ``tests/test_torch_train.py`` bounds them (every entry within
  1e-2 * lr but one in a thousand, none beyond 2 * lr * steps: Adam turns
  the sign flip of a near-zero gradient into a step of about lr).
"""

import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sten as jsten
from repro.configs import get_smoke as jax_smoke
from repro.core import layouts as jl
from repro.core import sparsifiers as jsp
from repro.core.builder import tag as jax_tag
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_lm as jax_init_lm
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models.common import mm as jax_mm
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import value_and_grad_sparse
from repro.optim.sparse_update import sparse_aware_update as jax_sau
from repro_torch import bridge, sten
from repro_torch.configs import get_smoke
from repro_torch.core import layouts as tl
from repro_torch.core import sparsifiers as tsp
from repro_torch.core.builder import tag
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import decode_step, forward, init_cache, loss_fn, \
    prefill
from repro_torch.models.common import mm
from repro_torch.models.transformer import layer_list
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.sparse_update import sparse_aware_update

from tests._torch_compat import params_to_numpy

# the modules (each package re-exports functions named after them)
tconv = importlib.import_module("repro_torch.core.convert")
tdisp = importlib.import_module("repro_torch.core.dispatch")
jconv = importlib.import_module("repro.core.convert")
jdisp = importlib.import_module("repro.core.dispatch")
LR = 3e-4
STEPS = 3


@pytest.fixture(autouse=True)
def _reset_port_state():
    tops.reset_kernel_counters()
    tdisp.reset_dispatch_counters()
    tconv.reset_conversion_log()


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _tiny(seed=0):
    """A two-layer net's params, as numpy."""
    rng = np.random.default_rng(seed)
    return {"net": {"w1": rng.standard_normal((16, 32)).astype(np.float32),
                    "w2": rng.standard_normal((32, 8)).astype(np.float32),
                    "bias": np.zeros(8, np.float32)}}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def tiny_apply(params, x):
    h = mm(x, params["net"]["w1"])
    h = tag("net.gelu", torch.nn.functional.gelu(h, approximate="tanh"))
    return mm(h, params["net"]["w2"]) + params["net"]["bias"]


def jax_tiny_apply(params, x):
    h = jax_mm(x, params["net"]["w1"])
    h = jax_tag("net.gelu", jax.nn.gelu(h))
    return jax_mm(h, params["net"]["w2"]) + params["net"]["bias"]


@pytest.mark.parametrize("pattern", ["net.w1", "net.w*", "*w2"])
def test_set_weight_exact_and_glob(pattern):
    p = _tiny()
    got = sten.SparsityBuilder().set_weight(
        pattern, tsp.ScalarFractionSparsifier(0.5)).sparsify_params(
        _torch_tree(p))
    want = jsten.SparsityBuilder().set_weight(
        pattern, jsp.ScalarFractionSparsifier(0.5)).sparsify_params(
        _jax_tree(p))
    for k in ("w1", "w2", "bias"):
        g, w = got["net"][k], want["net"][k]
        assert isinstance(g, tl.FixedMaskTensor) == isinstance(
            w, jl.FixedMaskTensor), k
        if isinstance(g, tl.FixedMaskTensor):
            np.testing.assert_array_equal(_np(g.mask), np.asarray(w.mask))


def test_get_sparse_model_sparsifies_the_intermediate():
    """A FixedMask weight and the inline threshold at ``net.gelu``: the
    reference's output, and the threshold really dropped activations."""
    p = _tiny(1)
    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    sb = sten.SparsityBuilder()
    sb.set_weight("net.w1", tsp.ScalarFractionSparsifier(0.9))
    sb.set_interm("net.gelu",
                  inline_sparsifier=tsp.ScalarThresholdSparsifier(0.5))
    jsb = jsten.SparsityBuilder()
    jsb.set_weight("net.w1", jsp.ScalarFractionSparsifier(0.9))
    jsb.set_interm("net.gelu",
                   inline_sparsifier=jsp.ScalarThresholdSparsifier(0.5))
    sp, apply = sb.get_sparse_model(_torch_tree(p), tiny_apply)
    jspp, japply = jsb.get_sparse_model(_jax_tree(p), jax_tiny_apply)
    y = apply(sp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), np.asarray(japply(jspp, jnp.asarray(
        x))), rtol=1e-4, atol=1e-5)
    assert not torch.equal(y, tiny_apply(sp, torch.from_numpy(x)))
    h = torch.nn.functional.gelu(torch.from_numpy(x) @ sp["net"]["w1"]
                                 .to_dense(), approximate="tanh")
    want = (h * (h.abs() >= 0.5)) @ sp["net"]["w2"] + sp["net"]["bias"]
    np.testing.assert_allclose(_np(y), _np(want), rtol=1e-5, atol=1e-6)


def test_tag_is_identity_without_plan():
    x = torch.randn(4, 4)
    assert tag("anything", x) is x
    with sten.SparsityBuilder().plan():        # a plan with no rule
        assert tag("anything", x) is x


def test_tag_layout_returns_the_layout():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 8)).astype(np.float32))
    sb = sten.SparsityBuilder().set_interm(
        "a", external_sparsifier=tsp.NMSparsifier(2, 4),
        out_format=tl.NMTensor)
    from repro_torch.core.builder import tag_layout

    with sb.plan():
        out = tag_layout("a", x)
        dense = tag("a", x)
    assert isinstance(out, tl.NMTensor)
    assert torch.equal(out.to_dense(), dense)
    assert tag_layout("a", x) is x


def test_trace_intermediates_small_function():
    p = _tiny()
    got = sten.trace_intermediates(tiny_apply, _torch_tree(p),
                                   torch.zeros(4, 16))
    want = jsten.trace_intermediates(jax_tiny_apply, _jax_tree(p),
                                     jnp.zeros((4, 16)))
    assert got == want == [("net.gelu", (4, 32), "float32")]


def _smoke(dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke("bert-base-sten"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype=dtype)
    jp = jax.jit(jax_init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(params_to_numpy(jp),
                                                    device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["forward", "prefill", "decode"])
def test_trace_intermediates_of_the_model(entry, dtype):
    """The model's taggable sites, each once in first-seen order, with
    the reference's shapes and dtype names: ``attn.out`` in the forward
    and prefill only (the reference's decode layer has none)."""
    jcfg, tcfg, jp, tp = _smoke(dtype)
    tok = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 8),
                                            dtype=np.int32)
    if entry == "forward":
        got = sten.trace_intermediates(forward, tp, tcfg,
                                       torch.from_numpy(tok))
        want = jsten.trace_intermediates(
            lambda p, t: jax_forward(p, jcfg, t), jp, jnp.asarray(tok))
    elif entry == "prefill":
        got = sten.trace_intermediates(prefill, tp, tcfg,
                                       torch.from_numpy(tok), 16)
        want = jsten.trace_intermediates(
            lambda p, t: jax_prefill(p, jcfg, t, 16), jp, jnp.asarray(tok))
    else:
        cache = init_cache(tcfg, 2, 16, device="cpu")
        got = sten.trace_intermediates(
            decode_step, tp, tcfg, torch.from_numpy(tok[:, :1]), cache,
            torch.tensor(3))
        want = jsten.trace_intermediates(
            lambda p, t: jax_decode_step(p, jcfg, t, jax_init_cache(
                jcfg, 2, 16), jnp.int32(3)), jp, jnp.asarray(tok[:, :1]))
    assert got == want
    names = [s[0] for s in got]
    assert names == (["mlp.act", "mlp.out"] if entry == "decode"
                     else ["attn.out", "mlp.act", "mlp.out"])


def test_grad_formats_collected():
    fmt = sten.OutFormat(tsp.KeepAll(), tl.FixedMaskTensor,
                         tsp.ScalarFractionSparsifier(0.5),
                         tl.FixedMaskTensor)
    sb = sten.SparsityBuilder()
    sb.set_weight("net.w1", tsp.ScalarFractionSparsifier(0.5),
                  tl.FixedMaskTensor, grad_fmt=fmt)
    sb.set_weight_grad("net.w2", fmt)
    assert sb.grad_formats() == {"net.w1": fmt, "net.w2": fmt}
    # a gradient format alone makes a keep-all DenseTensor rule, as in the
    # reference
    p = sb.sparsify_params(_torch_tree(_tiny()))
    jsb = jsten.SparsityBuilder().set_weight_grad("net.w2", None)
    jp = jsb.sparsify_params(_jax_tree(_tiny()))
    assert isinstance(p["net"]["w2"], tl.DenseTensor)
    assert type(jp["net"]["w2"]).__name__ == "DenseTensor"
    sb.set_interm_grad("net.gelu", fmt)
    assert sb.plan().interm_rule_for("net.gelu").grad_fmt == fmt


@pytest.mark.parametrize("layout", ["GroupedNMTensor", "NMTensor",
                                    "FixedMaskTensor"])
def test_stacked_weight_sparsification(layout):
    """A stacked [L, K, N] weight is sparsified per layer and re-stacked;
    the model's ``layer_list`` slices the layers back out, equal to the
    reference's per-layer slices."""
    w = np.random.default_rng(5).integers(-9, 10, (3, 16, 32)).astype(
        np.float32)
    sp_t = {"GroupedNMTensor": tsp.GroupedNMSparsifier(2, 4, 2,
                                                       sparse_dim=0),
            "NMTensor": tsp.NMSparsifier(2, 4),
            "FixedMaskTensor": tsp.NMSparsifier(2, 4)}[layout]
    sp_j = {"GroupedNMTensor": jsp.GroupedNMSparsifier(2, 4, 2,
                                                       sparse_dim=0),
            "NMTensor": jsp.NMSparsifier(2, 4),
            "FixedMaskTensor": jsp.NMSparsifier(2, 4)}[layout]
    t = sten.SparsityBuilder().set_weight(
        "w", sp_t, getattr(tl, layout)).sparsify_params(
        {"w": torch.from_numpy(w)})["w"]
    j = jsten.SparsityBuilder().set_weight(
        "w", sp_j, getattr(jl, layout)).sparsify_params(
        {"w": jnp.asarray(w)})["w"]
    assert isinstance(t, getattr(tl, layout))
    for i, ti in enumerate(layer_list({"w": t})):
        ji = jax.tree_util.tree_map(lambda leaf: leaf[i], j)
        np.testing.assert_array_equal(_np(ti["w"].to_dense()),
                                      np.asarray(ji.to_dense()))


def test_csr_leaves_are_not_stacked():
    sb = sten.SparsityBuilder().set_weight(
        "w", tsp.ScalarFractionSparsifier(0.5), tl.CsrTensor)
    with pytest.raises(TypeError, match="not stacked"):
        sb.sparsify_params({"w": torch.ones(2, 4, 4)})


# ---------------------------------------------------------------------------
# the smoke model under the plan
# ---------------------------------------------------------------------------


def _plans(grad_on_masked: bool):
    """(port builder, reference builder) of the plan.  With
    ``grad_on_masked`` ``attn.wo`` also gets a magnitude FixedMask rule
    (the reference's ``sparsify_grads`` returns a bare array for a
    DenseTensor cotangent, which its optimizer rejects, so its training
    takes gradient formats on layouts that keep their structure)."""
    out = []
    for s, lay in ((sten, tl), (jsten, jl)):
        sb = s.SparsityBuilder()
        sb.set_weight("*mlp.wo", s.NMSparsifier(2, 4), lay.NMTensor)
        sb.set_weight("*mlp.wi", s.GroupedNMSparsifier(1, 4, 16,
                                                       sparse_dim=0))
        sb.set_interm("mlp.act", s.NMSparsifier(2, 4))
        if grad_on_masked:
            sb.set_weight("*attn.wo", s.ScalarFractionSparsifier(0.5))
        sb.set_weight_grad("*attn.wo", s.OutFormat(
            external=s.ScalarFractionSparsifier(
                0.75 if grad_on_masked else 0.5)))
        out.append(sb)
    return out


def _batch(vocab, seed=6):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (2, 16), dtype=np.int32)
            for k in ("tokens", "labels")}


def _route_keys(counts) -> set:
    return {(o, op, sig) for (o, op, sig) in counts}


def test_smoke_plan_builds_the_reference_layouts():
    """Each package builds the plan from the same weights: ``mlp.wo`` the
    reference's stacked NMTensor (offsets and values), ``mlp.wi`` its
    n:m:g FixedMask (masks equal up to near-tied score sums, counted),
    ``attn.wo`` a DenseTensor; the port runs ``nm_mask`` once a layer."""
    jcfg, tcfg, jp, tp = _smoke()
    sb, jsb = _plans(False)
    t, j = sb.sparsify_params(tp), jsb.sparsify_params(jp)
    tw, jw = t["layers"]["mlp"]["wo"], j["layers"]["mlp"]["wo"]
    assert isinstance(tw, tl.NMTensor) and tw.stacked
    assert tw.dense_shape == tuple(jw.dense_shape)
    np.testing.assert_array_equal(_np(tw.idx), np.asarray(jw.idx))
    np.testing.assert_array_equal(_np(tw.val), np.asarray(jw.val))
    ti, ji = t["layers"]["mlp"]["wi"], j["layers"]["mlp"]["wi"]
    assert isinstance(ti, tl.FixedMaskTensor)
    assert isinstance(ti.origin, tsp.GroupedNMSparsifier)
    flipped = int((_np(ti.mask) != np.asarray(ji.mask)).sum())
    assert flipped <= ti.mask.numel() // 200, flipped
    assert isinstance(t["layers"]["attn"]["wo"], tl.DenseTensor)
    assert tops.kernel_counters()[("nm_mask", "plain")] == tcfg.n_layers


def test_smoke_plan_routes_and_loss_equal_reference():
    """The forward under the plan, on the reference's built params: the
    same dispatch routes (``linear`` (Dense, NM) through NM -> FixedMask,
    (Dense, Dense) through Dense -> FixedMask), the same conversion pairs,
    ``predict_route``'s answer, no fallback warning, the loss within
    1e-4, and one ``nm_mask`` launch a layer for ``mlp.act``."""
    jcfg, tcfg, jp, _ = _smoke()
    sb, jsb = _plans(False)
    jsp_, japply = jsb.get_sparse_model(
        jp, lambda p, b: jax_loss_fn(p, jcfg, b, remat="none"))
    tsp_ = bridge.params_from_numpy(params_to_numpy(jsp_), device="cpu")
    _, tapply = sb.get_sparse_model({}, lambda p, b: loss_fn(p, tcfg, b))
    assert isinstance(tsp_["layers"]["mlp"]["wo"], tl.NMTensor)
    batch = _batch(tcfg.vocab)
    jdisp.reset_dispatch_counters()
    jconv.reset_conversion_log()
    with warnings.catch_warnings():
        warnings.simplefilter("error", jdisp.SparseFallbackWarning)
        warnings.simplefilter("error", tdisp.SparseFallbackWarning)
        jl_, _ = japply(jsp_, {k: jnp.asarray(v) for k, v in batch.items()})
        tl_, _ = tapply(tsp_, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert float(tl_) == pytest.approx(float(jl_), rel=1e-4)
    assert _route_keys(tdisp.dispatch_counters()) == _route_keys(
        jdisp.dispatch_counters()) == {
        ("impl", "linear", ("DenseTensor", "NMTensor")),
        ("impl", "linear", ("DenseTensor", "FixedMaskTensor")),
        ("impl", "linear", ("DenseTensor", "DenseTensor"))}
    pairs = {c[:2] for c in tconv.conversion_log()}
    assert pairs == {c[:2] for c in jconv.conversion_log()} == {
        ("NMTensor", "FixedMaskTensor"), ("DenseTensor", "FixedMaskTensor")}
    assert tdisp.predict_route("linear", (tl.DenseTensor, tl.NMTensor)) == \
        jdisp.predict_route("linear", (jl.DenseTensor, jl.NMTensor))
    assert tops.kernel_counters()[("nm_mask", "plain")] == tcfg.n_layers


def test_smoke_plan_training_steps_equal_reference():
    """Three steps of ``sparse_aware_update(grad_formats=...)`` under the
    plan from the reference's built params: per-step losses, the NMTensor
    and FixedMask values after the steps (masks and offsets unchanged),
    and the gradient format's pruning of ``attn.wo``'s gradient."""
    jcfg, tcfg, jp, _ = _smoke()
    sb, jsb = _plans(True)
    jparams, japply = jsb.get_sparse_model(
        jp, lambda p, b: jax_loss_fn(p, jcfg, b, remat="none"))
    tparams = bridge.params_from_numpy(params_to_numpy(jparams),
                                       device="cpu")
    plan = sb.plan()
    jstate, tstate = jax_adamw_init(jparams), adamw_init(tparams)
    masks = {k: tparams["layers"][a][k2].mask.clone() for k, (a, k2) in
             {"wi": ("mlp", "wi"), "attn": ("attn", "wo")}.items()}
    idx = tparams["layers"]["mlp"]["wo"].idx.clone()
    jl_, tl_ = [], []
    for s in range(STEPS):
        batch = _batch(tcfg.vocab, seed=10 + s)
        (lj, _), gj = value_and_grad_sparse(
            lambda p: japply(p, {k: jnp.asarray(v)
                                 for k, v in batch.items()}),
            has_aux=True)(jparams)
        jparams, jstate, _ = jax_sau(
            lambda g, st, p: jax_adamw_update(g, st, p,
                                              JaxAdamWConfig(lr=LR)),
            gj, jstate, jparams, grad_formats=jsb.grad_formats())
        with plan:
            lt, _, gt = ttrain.loss_and_grads(
                tparams, tcfg, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        if s == 0:
            pruned = sten.sparsify_grads(gt, sb.grad_formats())
            g0 = pruned["layers"]["attn"]["wo"]
            assert float((g0 != 0).float().mean()) <= 0.25 + 1e-3
            assert torch.equal(pruned["layers"]["mlp"]["wi"],
                               gt["layers"]["mlp"]["wi"])
        tparams, tstate, _ = sparse_aware_update(
            lambda g, st, p: adamw_update(g, st, p, AdamWConfig(lr=LR)),
            gt, tstate, tparams, grad_formats=sb.grad_formats())
        jl_.append(float(lj))
        tl_.append(float(lt))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4)
    lay = tparams["layers"]
    assert torch.equal(lay["mlp"]["wi"].mask, masks["wi"])
    assert torch.equal(lay["attn"]["wo"].mask, masks["attn"])
    assert torch.equal(lay["mlp"]["wo"].idx, idx)
    for got, want in ((lay["mlp"]["wo"].val, jparams["layers"]["mlp"]["wo"]
                       .val),
                      (lay["mlp"]["wi"].val, jparams["layers"]["mlp"]["wi"]
                       .val),
                      (lay["attn"]["wo"].val, jparams["layers"]["attn"]["wo"]
                       .val),
                      (lay["attn"]["wq"], jparams["layers"]["attn"]["wq"])):
        err = np.abs(_np(got) - np.asarray(want))
        assert int((err > 1e-2 * LR).sum()) <= err.size // 1000
        assert float(err.max()) <= 2 * LR * STEPS


def test_quickstart_model_step_equals_reference():
    """``examples/quickstart.py``'s step 5 through both packages: every
    ``mlp.w*`` weight of the SMOKE model as a masked-dense n:m:g
    FixedMaskTensor (the builder's default layout here), two leaves, and
    the sparse model's loss on the same batch within 1e-4 (the port runs
    on the reference's sparsified params)."""
    jcfg, tcfg, jp, tp = _smoke()
    jsb = jsten.SparsityBuilder().set_weight(
        "*mlp.w*", jsten.GroupedNMSparsifier(1, 4, 16, sparse_dim=0),
        jl.FixedMaskTensor)
    sb = sten.SparsityBuilder().set_weight(
        "*mlp.w*", sten.GroupedNMSparsifier(1, 4, 16, sparse_dim=0))
    jsparse, tsparse = jsb.sparsify_params(jp), sb.sparsify_params(tp)
    n_t = sum(isinstance(leaf, tl.FixedMaskTensor)
              for _, leaf in sten.flatten_with_names(tsparse))
    n_j = sum(isinstance(leaf, jl.FixedMaskTensor)
              for leaf in jax.tree_util.tree_leaves(
                  jsparse, is_leaf=lambda z: isinstance(z, jl.FixedMaskTensor)))
    assert n_t == n_j == 2
    batch = _batch(tcfg.vocab, seed=7)
    want, _ = jax_loss_fn(jsparse, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                          remat="none")
    got, _ = loss_fn(bridge.params_from_numpy(params_to_numpy(jsparse),
                                              device="cpu"), tcfg,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-4)
