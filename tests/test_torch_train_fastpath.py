"""The port's device-resident trainer (``launch/train.py:make_multi_step``
over ``launch/graphs.py:TrainGraph``, run eagerly into its static
buffers on the CPU) against the reference's ``make_multi_step`` and
against the port's own host loop, on the bert-base-sten SMOKE config in
f32 (2 layers, the reference's params carried over by the bridge); and
the pieces it is built from: the multi-tensor AdamW with its device step
counter and ``lr_scale``, the in-place re-sparsification, stacked and
sharded batches, the straggler watchdog.

Schedule: GMP iterative to 0.5 from step 0 to 7, a recompute every 2
steps (before steps 0, 2, 4, 6; the one at 7 = stop never runs), over 7
steps in chunks of 3: a recompute inside a chunk (2, 4), at a chunk's
start (6) and at ``stop``.

Tolerances, each with its reason:
- against the reference: ``tests/test_torch_train.py``'s training-step
  rules (losses within 1e-4 relative, final masks equal except at most
  0.5% of a leaf where values straddle the threshold,
  ``_assert_trained_equal`` on the rest): the same f32 arithmetic summed
  in other orders;
- against the port's host loop, and the multi-tensor AdamW against the
  per-leaf expression it replaced: bitwise (the same operations in the
  same order on the same device);
- batches, masks and the watchdog's flags: exact (the same code on the
  same values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMPipeline as JaxPipeline
from repro.dist.elastic import StragglerWatchdog as JaxWatchdog
from repro.launch import train as jtrain
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import GMPSchedule as JaxGMP
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch import bridge
from repro_torch.core.layouts import FixedMaskTensor
from repro_torch.core.sparsifiers import NMSparsifier, \
    ScalarFractionSparsifier
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.dist import StragglerWatchdog
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.launch.graphs import state_tensors
from repro_torch.optim import AdamWConfig, GMPSchedule, adamw_init, \
    adamw_update, resparsify_params, resparsify_params_
from repro_torch.optim.optimizers import tree_map

from tests._torch_compat import params_to_numpy
from tests.test_torch_train import LR, _assert_fixed_equal, \
    _assert_trained_equal, _cfgs, _fixed_leaves, _jax_dense_params, \
    _nm_builders, _np

STEPS = 7
CHUNK = 3
SCHED = dict(mode="iterative", target_sparsity=0.5, begin_step=0,
             end_step=STEPS, recompute_every=2, num_layers=2)
DKW = dict(seq_len=32, global_batch=2, seed=3)


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_kernel_counters()


def _setup(how):
    """(jax cfg, port cfg, jax params, port params) at the start: the
    CLI's magnitude-pruned leaves, or NMSparsifier(2, 4) leaves with the
    inline threshold 0.05 on ``mlp.wi``."""
    threshold = 0.05 if how == "nm_inline" else None
    jcfg, tcfg = _cfgs(mlp_inline_threshold=threshold)
    jp = _jax_dense_params(jcfg)
    tp = bridge.params_from_numpy(params_to_numpy(jp), device="cpu")
    if how == "scalar_fraction":
        s0 = GMPSchedule(**SCHED).sparsity_at(0)
        jp = jtrain.build_sparse_params(jp, s0)
        tp = ttrain.build_sparse_params(tp, s0)
    else:
        jb, tb = _nm_builders()
        jp, tp = jb.sparsify_params(jp), tb.sparsify_params(tp)
    _assert_fixed_equal(jp, tp)
    return jcfg, tcfg, jp, tp


def _data(cfg):
    return SyntheticLMPipeline(DataConfig(vocab=cfg.vocab, **DKW))


def _run_fast(tcfg, tp, gmp, steps=STEPS, chunk=CHUNK):
    """The port's make_multi_step in chunks of ``chunk``: (params, state,
    losses, gnorms, recomputes)."""
    multi = ttrain.make_multi_step(tcfg, AdamWConfig(lr=LR), gmp, chunk)
    state, data = adamw_init(tp), _data(tcfg)
    losses, gnorms, recomputes = [], [], []
    for lo in range(0, steps, chunk):
        hi = min(steps, lo + chunk)
        tp, state, m = multi(tp, state, ttrain.stack_batches(data, lo, hi),
                             lo, steps)
        losses += m["loss"].tolist()
        gnorms += m["gnorm"].tolist()
        recomputes += multi.recomputes(lo, hi - lo, steps)
    assert multi.graph is not None and not multi.graph.info["captured"]
    return tp, state, losses, gnorms, recomputes


def _run_host(tcfg, tp, gmp, steps=STEPS):
    return ttrain.train_loop(
        tp, adamw_init(tp), ttrain.make_train_step(tcfg, AdamWConfig(lr=LR)),
        _data(tcfg), start=0, stop=steps, device="cpu", gmp=gmp,
        log_every=steps)


def _run_reference(jcfg, jp, gmp):
    """The reference's make_multi_step in the same chunks, with its
    caller's retarget before the run's first step."""
    data = JaxPipeline(JaxDataConfig(vocab=jcfg.vocab, **DKW))
    js = jax_adamw_init(jp)
    if gmp.recompute_at(0):
        jp = jtrain.retarget_sparsity(jp, gmp.sparsity_at(0))
    losses = []
    for lo in range(0, STEPS, CHUNK):
        hi = min(STEPS, lo + CHUNK)
        multi = jtrain.make_multi_step(jcfg, JaxAdamWConfig(lr=LR), gmp,
                                       hi - lo)
        jp, js, m = multi(jp, js, jtrain.stack_batches(data, lo, hi),
                          jnp.int32(lo), jnp.int32(STEPS))
        losses += np.asarray(m["loss"]).tolist()
    return jp, losses


@pytest.mark.parametrize("how", ["scalar_fraction", "nm_inline"])
def test_multi_step_equals_reference(how):
    """Seven steps in chunks of 3 through both packages' device-resident
    trainers from the same params: losses, masks and final values."""
    jcfg, tcfg, jp, tp = _setup(how)
    tp, _, losses, _, recomputes = _run_fast(tcfg, tp,
                                             GMPSchedule(**SCHED))
    jp, jl = _run_reference(jcfg, jp, JaxGMP(**SCHED))
    assert recomputes == [0, 2, 4, 6]
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    counts = tops.kernel_counters()
    if how == "nm_inline":
        # build: 2 leaves x 2 layers; each recompute: 2 stacked leaves
        assert counts[("nm_mask", "plain")] == 4 + 2 * 4
        assert counts[("matmul_threshold", "plain")] == tcfg.n_layers * STEPS
    jfix, tfix = _fixed_leaves(jp), _fixed_leaves(tp)
    assert jfix.keys() == tfix.keys()
    for k in jfix:
        m_t, m_j = tfix[k].mask.numpy(), np.asarray(jfix[k].mask)
        assert int((m_t != m_j).sum()) <= m_j.size // 200, k
        same = m_t == m_j
        _assert_trained_equal(_np(tfix[k].val)[same],
                              np.asarray(jfix[k].val)[same], k)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jp, is_leaf=lambda x: isinstance(x, type(jfix[k])))[0]:
        if isinstance(leaf, type(jfix[k])):
            continue
        t = tp
        for p in path:
            t = t[p.key]
        _assert_trained_equal(_np(t), np.asarray(leaf), path)


def _assert_state_equal(a, b):
    ta, tb = state_tensors(*a), state_tensors(*b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _clone(tree):
    return tree_map(lambda p: FixedMaskTensor(p.val.clone(), p.mask.clone(),
                                              p.origin)
                    if isinstance(p, FixedMaskTensor) else p.clone(), tree)


@pytest.mark.parametrize("how", ["scalar_fraction", "nm_inline"])
def test_fast_path_bitwise_equals_host_loop(how):
    """The same seven steps through make_multi_step and through the host
    loop: losses, gradient norms, params, masks, moments and the step
    counter bit for bit, and the same recomputes."""
    _, tcfg, _, tp = _setup(how)
    gmp = GMPSchedule(**SCHED)
    start = _clone(tp)
    tops.reset_kernel_counters()          # the build's launches
    fp, fs, fl, fg, frec = _run_fast(tcfg, tp, gmp)
    fast_counts = tops.kernel_counters()
    tops.reset_kernel_counters()
    host = _run_host(tcfg, start, gmp)
    assert tops.kernel_counters() == fast_counts
    assert fl == host["losses"] and fg == host["gnorms"]
    assert frec == host["recomputes"] == [0, 2, 4, 6]
    _assert_state_equal((fp, fs), (host["params"], host["opt_state"]))
    assert int(fs["step"]) == STEPS


def test_no_recompute_past_stop():
    """A run that ends on a cadence step (recompute_at(12)) never
    recomputes for the step after its last: the fast path's recomputes
    and masks equal the host loop's, at the level of the last recompute
    that ran (step 7), not step 12's."""
    _, tcfg, _, tp = _setup("scalar_fraction")
    gmp = GMPSchedule(mode="iterative", target_sparsity=0.6, begin_step=2,
                      end_step=20, recompute_every=5, num_layers=2)
    steps = 12
    assert gmp.recompute_at(steps)
    start = _clone(tp)
    fp, fs, fl, _, frec = _run_fast(tcfg, tp, gmp, steps=steps, chunk=steps)
    host = _run_host(tcfg, start, gmp, steps=steps)
    assert frec == host["recomputes"] == [2, 7]
    assert fl == host["losses"]
    _assert_state_equal((fp, fs), (host["params"], host["opt_state"]))
    kept = 1 - gmp.sparsity_at(7)
    for leaf in _fixed_leaves(fp).values():
        assert float(leaf.mask.float().mean()) == pytest.approx(kept,
                                                                abs=2e-3)


def test_stack_batches_equals_reference():
    kw = dict(vocab=512, seq_len=16, global_batch=4, seed=5)
    got = ttrain.stack_batches(SyntheticLMPipeline(DataConfig(**kw)), 3, 7)
    want = jtrain.stack_batches(JaxPipeline(JaxDataConfig(**kw)), 3, 7)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.int32 and got[k].shape == (4, 4, 16)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("shards,shard,zipf_a", [(2, 1, 1.2), (4, 3, 1.5),
                                                 (1, 0, 2.0)])
def test_sharded_prefetching_batches_equal_reference(shards, shard, zipf_a):
    """batch_at of a shard, the prefetching iterator from a start step,
    and a reshard, each equal to the reference's."""
    kw = dict(vocab=300, seq_len=12, global_batch=8, seed=2,
              num_shards=shards, shard_id=shard, zipf_a=zipf_a, prefetch=2)
    got = SyntheticLMPipeline(DataConfig(**kw), start_step=4)
    want = JaxPipeline(JaxDataConfig(**kw), start_step=4)
    for step in (0, 9):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got.batch_at(step)[k],
                                          want.batch_at(step)[k])
    it_got, it_want = iter(got), iter(want)
    for _ in range(3):
        b, w = next(it_got), next(it_want)
        for k in ("tokens", "labels"):
            assert b[k].shape == (8 // shards, 12)
            np.testing.assert_array_equal(b[k], w[k])
    it_got.close()
    it_want.close()
    assert got.step == want.step == 7
    got2, want2 = got.reshard(2, 0), want.reshard(2, 0)
    assert got2.step == 7
    np.testing.assert_array_equal(got2.batch_at(7)["tokens"],
                                  want2.batch_at(7)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLMPipeline(DataConfig(global_batch=6, num_shards=4))


def _per_leaf_adamw(grads, state, params, cfg):
    """The per-leaf AdamW the multi-tensor update replaced (host step
    counter, returning new tensors), kept as the bitwise reference."""
    leaves = [g for g in jax.tree_util.tree_leaves(grads)]
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state["step"] + 1
    stepf = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), stepf)
    out = {}
    for k, p in params.items():
        t = p.val if isinstance(p, FixedMaskTensor) else p
        gf = (grads[k] * scale.to(grads[k].dtype)).float()
        mu2 = cfg.b1 * state["mu"][k] + (1 - cfg.b1) * gf
        nu2 = cfg.b2 * state["nu"][k] + (1 - cfg.b2) * gf.square()
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        if cfg.weight_decay and t.ndim >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * t.float()
        out[k] = ((t.float() - cfg.lr * delta).to(t.dtype), mu2, nu2)
    return out, step, gnorm


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_multi_tensor_bitwise_equals_per_leaf(clip):
    """Three updates of a tree of f32 and bf16 leaves (a stacked
    FixedMaskTensor, a norm without decay): every parameter and moment
    bit for bit the per-leaf expression's, written in place (the same
    tensors), the step counter a device int32 tensor."""
    rng = np.random.default_rng(7)

    def t(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    mask = torch.from_numpy(rng.random((2, 8, 6)) < 0.5)
    params = {"w": FixedMaskTensor(t((2, 8, 6)) * mask, mask,
                                   ScalarFractionSparsifier(0.5)),
              "e": t((10, 4), torch.bfloat16), "n": t((6,))}
    cfg = AdamWConfig(lr=1e-2, grad_clip=clip)
    state = adamw_init(params)
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    ref = {"mu": {k: v.clone() for k, v in state["mu"].items()},
           "nu": {k: v.clone() for k, v in state["nu"].items()}, "step": 0}
    ref_p = {k: (p.val if isinstance(p, FixedMaskTensor) else p).clone()
             for k, p in params.items()}
    tensors = state_tensors(params, state)
    for _ in range(3):
        grads = {"w": t((2, 8, 6)), "e": t((10, 4), torch.bfloat16),
                 "n": t((6,))}
        refp = {k: FixedMaskTensor(ref_p[k], mask) if k == "w" else ref_p[k]
                for k in ref_p}
        want, ref["step"], want_gnorm = _per_leaf_adamw(grads, ref, refp,
                                                        cfg)
        p2, s2, m = adamw_update(grads, state, params, cfg)
        assert p2 is params and s2 is state
        assert torch.equal(m["gnorm"], want_gnorm)
        for k, (wp, wmu, wnu) in want.items():
            got = params[k].val if k == "w" else params[k]
            assert got.dtype == wp.dtype and torch.equal(got, wp), k
            assert torch.equal(state["mu"][k], wmu), k
            assert torch.equal(state["nu"][k], wnu), k
            ref_p[k], ref["mu"][k], ref["nu"][k] = wp, wmu, wnu
        assert int(state["step"]) == ref["step"]
    assert all(a is b for a, b in zip(tensors, state_tensors(params, state)))


def test_adamw_lr_scale_equals_reference():
    """``lr_scale`` as a float and as a device tensor (what a captured
    step reads at each replay), against the reference's, within 1e-6."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    cfg = dict(lr=1e-2, grad_clip=10.0)
    jp, js = {"w": jnp.asarray(w)}, None
    js = jax_adamw_init(jp)
    jp, _, _ = jax_adamw_update({"w": jnp.asarray(g)}, js, jp,
                                JaxAdamWConfig(**cfg), lr_scale=0.25)
    for scale in (0.25, torch.tensor(0.25)):
        tp = {"w": torch.from_numpy(w.copy())}
        adamw_update({"w": torch.from_numpy(g)}, adamw_init(tp), tp,
                     AdamWConfig(**cfg), lr_scale=scale)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["fixed", "magnitude", "nm"])
def test_resparsify_in_place_equals_returning(mode):
    """The in-place re-sparsification writes the values and masks the
    returning form makes, bit for bit, into the leaves' own tensors."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 8, generator=g)
    origin = NMSparsifier(2, 4) if mode == "nm" \
        else ScalarFractionSparsifier(0.5)
    mask = origin.mask(x).bool()
    leaf = FixedMaskTensor(x + 0.3 * torch.randn(x.shape, generator=g),
                           mask.clone(), origin)   # raw val off the pattern
    params = {"w": leaf, "b": torch.randn(8, generator=g)}
    kw = {} if mode == "fixed" else dict(recompute_pattern=True,
                                         target_sparsity=0.7)
    want = resparsify_params(params, **kw)
    val, m = leaf.val, leaf.mask
    got = resparsify_params_(params, **kw)
    assert got is params and params["w"].val is val and params["w"].mask is m
    assert torch.equal(val, want["w"].val) and torch.equal(m, want["w"].mask)
    assert torch.equal(params["b"], want["b"])
    if mode != "fixed":
        assert not torch.equal(m, mask)


def test_straggler_watchdog_equals_reference():
    """The same step times, the same flags, at every step."""
    rng = np.random.default_rng(0)
    got, want = StragglerWatchdog(3, min_steps=3, window=5), \
        JaxWatchdog(3, min_steps=3, window=5)
    for step in range(12):
        for host in range(3):
            dt = float(rng.uniform(0.9, 1.1)) * (3.0 if host == 2
                                                 and step > 4 else 1.0)
            got.observe(host, dt)
            want.observe(host, dt)
        assert got.stragglers() == want.stragglers()
    assert got.stragglers() == [2]
