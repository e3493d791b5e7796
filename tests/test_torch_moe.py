"""The port's mixture of experts (``models/moe.py``: moonshot-v1-16b-a3b,
64 experts top-6; arctic-480b, top-2 with a dense residual MLP) against
the JAX package's, at their SMOKE configs in f32 (4 experts, top-2), the
reference's params carried over by the bridge, dense and n:m:g 1:4:8 gr16
with ``attn=True`` (which converts no expert weight):

- ``apply_moe``: output and auxiliary loss; the experts taken and the
  slots kept, exactly, against the reference's ``jax.lax.top_k`` and its
  capacity rule; the tie case (a zero router: every probability equal,
  experts 0..k-1 for every token, later tokens over capacity) and a low
  ``capacity_factor``, in a layer, a forward and a decode step with
  more slots than the capacity;
- ``forward`` hidden states and summed auxiliary loss, ``loss_fn`` with
  ``aux_weight`` and its gradients;
- slot-mode prefill then decode steps, the engine's programs (decode
  chunk, admission), ``serve_programs`` and whole ``ServeEngine`` runs:
  logits, greedy tokens and cache leaves;
- the param tree, the bridge of the ``moe`` subtree, the configs,
  ``check_ported``'s boundary, ``sparsify_for_serving``, ``route_log``'s
  record and pin, and the serve CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, forward as j_forward, \
    init_cache as j_init_cache, loss_fn as j_loss_fn, \
    prefill_into_slot as j_prefill_into_slot
from repro.models import moe as j_moe
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve.cache import _jit_slot_prefill as j_slot_prefill
from repro.serve.engine import _jit_decode_chunk as j_decode_chunk, \
    serve_programs as j_serve_programs
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch
from repro_torch.launch import train as ttrain
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    loss_fn, prefill_into_slot
from repro_torch.models import moe
from repro_torch.models.common import MoEConfig
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve import Request, ServeEngine, sparsify_for_serving
from repro_torch.serve.cache import _slot_prefill_fn
from repro_torch.serve.engine import _decode_chunk_fn, serve_programs
from repro_torch.serve.graphs import DecodeGraph, PrefillGraph

from tests._torch_compat import params_to_numpy, smoke_setup
from tests.test_torch_families import _assert_cache_close, _jnp_tree, \
    _seeded_cache, _shapes, _torch

# f32 in both packages; outputs differ by summation order only (the
# tolerance of tests/test_torch_families.py)
TOL = dict(rtol=1e-4, atol=1e-4)
MOONSHOT, ARCTIC = "moonshot-v1-16b-a3b", "arctic-480b"
ARCHES = [MOONSHOT, ARCTIC]
SPARSE = pytest.mark.parametrize("sparse", [False, True],
                                 ids=["dense", "nmg"])
ARCH = pytest.mark.parametrize("arch", ARCHES)
SLOTS, S_CACHE = 2, 28
MOE_LEAVES = {MOONSHOT: ("router", "wi", "wo"),
              ARCTIC: ("res_wi", "res_wo", "router", "wi", "wo")}


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _setup(arch, sparse=False, zero_router=False, **moe_kw):
    """``smoke_setup`` of ``arch`` with the MoE config changed by
    ``moe_kw`` in both packages, and with ``zero_router`` every router
    zero in both (every probability equal)."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    if moe_kw:
        jcfg, tcfg = _with_moe(jcfg, **moe_kw), _with_moe(tcfg, **moe_kw)
    if zero_router:
        jm = dict(jp["layers"]["moe"], router=jnp.zeros_like(
            jp["layers"]["moe"]["router"]))
        jp = {**jp, "layers": {**jp["layers"], "moe": jm}}
        tm = dict(tp["layers"]["moe"], router=torch.zeros_like(
            tp["layers"]["moe"]["router"]))
        tp = {**tp, "layers": {**tp["layers"], "moe": tm}}
    return jcfg, tcfg, jp, tp


def _layer(tree, i):
    return {k: (v[i] if hasattr(v, "shape") else v) for k, v in tree.items()}


def _ref_routes(p, x, cfg):
    """The reference's ``apply_moe`` run eagerly, with the expert choice
    its ``jax.lax.top_k`` made: (out, aux, eidx [T, k])."""
    taken = []
    top_k = jax.lax.top_k

    def recording(a, k):
        vals, idx = top_k(a, k)
        taken.append(np.asarray(idx))
        return vals, idx

    jax.lax.top_k = recording
    try:
        out, aux = j_moe.apply_moe(p, jnp.asarray(x), cfg)
    finally:
        jax.lax.top_k = top_k
    assert len(taken) == 1
    return np.asarray(out), float(aux), taken[0]


def _kept(eidx, cap):
    """The reference's capacity rule, written out in numpy: slot (t, j)
    is kept when fewer than ``cap`` slots of earlier tokens took its
    expert."""
    seen, keep = {}, np.zeros(eidx.shape, bool)
    for t in range(eidx.shape[0]):
        for j, e in enumerate(eidx[t]):
            keep[t, j] = seen.get(e, 0) < cap
        for e in eidx[t]:
            seen[e] = seen.get(e, 0) + 1
    return keep


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(2, 16), (1, 1), (3, 5)])
@ARCH
def test_apply_moe_matches_reference(arch, B, S):
    """Output, auxiliary loss, the experts taken and the slots kept, per
    layer, on seeded inputs of several token counts."""
    jcfg, tcfg, jp, tp = _setup(arch)
    for i in range(tcfg.n_layers):
        x = _x(tcfg, B, S, 10 * i + B)
        want, waux, weidx = _ref_routes(_layer(jp["layers"]["moe"], i), x,
                                        jcfg)
        with moe.route_log() as log:
            got, aux = moe.apply_moe(_layer(tp["layers"]["moe"], i),
                                     torch.from_numpy(x), tcfg)
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(float(aux), waux, rtol=1e-5)
        (call,) = log.calls
        np.testing.assert_array_equal(call["eidx"].numpy(), weidx)
        np.testing.assert_array_equal(
            call["keep"].numpy(),
            _kept(weidx, moe.capacity(B * S, tcfg.moe)))


@ARCH
def test_zero_router_ties_take_the_lowest_experts(arch):
    """Every probability equal: the reference takes experts 0..k-1 for
    every token (``jax.lax.top_k`` puts the lower index first), so those
    experts overflow the capacity and the later tokens' slots drop.  The
    port takes the same experts and drops the same slots."""
    jcfg, tcfg, jp, tp = _setup(arch, zero_router=True)
    k = tcfg.moe.top_k
    x = _x(tcfg, 2, 16, 3)
    want, waux, weidx = _ref_routes(_layer(jp["layers"]["moe"], 0), x, jcfg)
    np.testing.assert_array_equal(weidx, np.tile(np.arange(k), (32, 1)))
    with moe.route_log() as log:
        got, aux = moe.apply_moe(_layer(tp["layers"]["moe"], 0),
                                 torch.from_numpy(x), tcfg)
    (call,) = log.calls
    np.testing.assert_array_equal(call["eidx"].numpy(), weidx)
    cap = moe.capacity(32, tcfg.moe)
    assert cap < 32
    keep = call["keep"].numpy()
    np.testing.assert_array_equal(
        keep, np.broadcast_to(np.arange(32)[:, None] < cap, (32, k)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), waux, rtol=1e-5)
    # a dropped token gets nothing from the experts: moonshot's output
    # there is 0 (arctic's is its dense residual alone)
    if arch == MOONSHOT:
        tail = got.reshape(32, -1)[cap:]
        assert torch.equal(tail, torch.zeros_like(tail))


@pytest.mark.parametrize("cf", [0.05, 0.5])
@ARCH
def test_low_capacity_factor_drops_the_reference_s_slots(arch, cf):
    """A low ``capacity_factor`` (``tests/test_moe.py`` uses 0.05): most
    slots drop, and the port drops exactly the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=cf)
    x = _x(tcfg, 2, 32, 7)
    want, waux, weidx = _ref_routes(_layer(jp["layers"]["moe"], 1), x, jcfg)
    with moe.route_log() as log:
        got, aux = moe.apply_moe(_layer(tp["layers"]["moe"], 1),
                                 torch.from_numpy(x), tcfg)
    keep = log.calls[0]["keep"].numpy()
    np.testing.assert_array_equal(log.calls[0]["eidx"].numpy(), weidx)
    np.testing.assert_array_equal(keep, _kept(weidx, moe.capacity(
        64, tcfg.moe)))
    assert not keep.all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), waux, rtol=1e-5)


@pytest.mark.parametrize("T", [1, 4, 8, 13, 32, 64, 100, 257])
@pytest.mark.parametrize("cf", [0.05, 1.25, 2.0])
def test_capacity_is_the_reference_s(T, cf):
    """``capacity`` against the reference's expression, at moonshot's 64
    experts top-6 and the SMOKE's 4 top-2."""
    for mc in (get_config(MOONSHOT).moe, get_smoke(MOONSHOT).moe):
        mc = dataclasses.replace(mc, capacity_factor=cf)
        cap = max(1, int(T * mc.top_k / mc.num_experts * cf))
        assert moe.capacity(T, mc) == -(-cap // 8) * 8
        assert moe.capacity(T, mc) % 8 == 0


def test_route_log_pins_a_recorded_choice():
    """Recorded routes pinned into a second run give the first run's
    output exactly; pinned a shuffled copy (experts relabelled), the
    output moves; the gates are the run's own probabilities of the
    pinned experts."""
    _, cfg, _, tp = _setup(MOONSHOT)
    p = _layer(tp["layers"]["moe"], 0)
    x = torch.from_numpy(_x(cfg, 2, 8, 5))
    with moe.route_log() as rec:
        want, _ = moe.apply_moe(p, x, cfg)
    with moe.route_log(pin=rec.routes) as pinned:
        got, _ = moe.apply_moe(p, x, cfg)
    assert torch.equal(got, want)
    assert torch.equal(pinned.calls[0]["eidx"], rec.calls[0]["eidx"])
    perm = torch.tensor([1, 2, 3, 0])
    with moe.route_log(pin=[perm[r] for r in rec.routes]):
        moved, _ = moe.apply_moe(p, x, cfg)
    assert (moved - want).abs().max() > 1e-3
    with moe.route_log(pin=[]), pytest.raises(IndexError):
        moe.apply_moe(p, x, cfg)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@SPARSE
@ARCH
def test_forward_hidden_and_aux_match_reference(arch, sparse):
    """``forward`` over 2 x 16 tokens: hidden states, and with
    ``with_aux`` the layers' summed auxiliary loss (the reference's scan
    carry); with ``collect_cache`` too."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    toks = _toks(jcfg, (2, 16), 5)
    want, waux = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    got = forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got2, aux = forward(tp, tcfg, torch.from_numpy(toks), with_aux=True)
    assert torch.equal(got2, got)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    assert float(aux) > 0.5 * tcfg.n_layers
    hidden, cache, aux3 = forward(tp, tcfg, torch.from_numpy(toks),
                                  collect_cache=True, with_aux=True)
    assert torch.equal(hidden, got) and torch.equal(aux3, aux)
    assert sorted(cache) == ["k", "v"]


@pytest.mark.parametrize("cf", [0.05, 1.25])
@ARCH
def test_forward_with_drops_matches_reference(arch, cf):
    """The whole stack at the default and a dropping capacity factor."""
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=cf)
    toks = _toks(jcfg, (2, 24), 6)
    want, waux = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    with moe.route_log() as log:
        got, aux = forward(tp, tcfg, torch.from_numpy(toks), with_aux=True)
    assert len(log.calls) == tcfg.n_layers
    if cf < 1:
        assert not all(bool(c["keep"].all()) for c in log.calls)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("aux_weight", [0.01, 0.5])
@ARCH
def test_loss_fn_with_aux_weight_matches_reference(arch, aux_weight):
    """``loss_fn(aux_weight=)``: ce + aux_weight · moe_aux, each part
    against the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = {"tokens": _toks(jcfg, (2, 12), 11),
             "labels": _toks(jcfg, (2, 12), 12)}
    batch["labels"][0, :3] = -1
    wl, wparts = j_loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                           remat="none", aux_weight=aux_weight)
    gl, parts = loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                        aux_weight=aux_weight)
    for key in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(parts[key]), float(wparts[key]),
                                   rtol=1e-5)
    assert float(parts["moe_aux"]) > 0
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    torch.testing.assert_close(gl, parts["ce"] + aux_weight
                               * parts["moe_aux"])


@ARCH
def test_loss_gradients_match_reference(arch):
    """Every parameter's gradient of ``loss_fn`` (the auxiliary loss
    included: the router's gradient comes from the gates and from it)
    against ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = {"tokens": _toks(jcfg, (2, 12), 13),
             "labels": _toks(jcfg, (2, 12), 14)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b, remat="none"), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, aux, tg = ttrain.loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux["moe_aux"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got[path] = t.numpy()

    walk(tg, ())
    assert sorted(got) == sorted(want)
    assert ("layers", "moe", "router") in got
    for key, g in want.items():
        scale = max(1e-30, np.abs(g).max())
        assert np.abs(got[key] - g).max() <= 1e-4 * scale, key


def _assert_counts(sparse, counts, what):
    if not sparse:
        assert not any(k[0].startswith("nmg") for k in counts), what
        return
    # attention only: no expert weight is converted, so no fused FFN
    assert counts[("nmg_linear", "gemv[default]")] > 0, what
    assert counts[("nmg_qkv", "fused[default]")] > 0, what
    assert not any(k[0] == "nmg_ffn" for k in counts), what


@SPARSE
@ARCH
def test_slot_prefill_and_decode_match_reference(arch, sparse):
    """A 12-token prompt into slot 1 of a 2-slot cache, then 8 decode
    steps of both slots (slot 0 empty, at position 0; the idle slot
    routes too): logits, greedy tokens and every cache leaf."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    toks = _toks(jcfg, (1, 12), 1)
    jl, jc = jax.jit(lambda p, t, c: j_prefill_into_slot(
        p, jcfg, t, c, 1))(jp, jnp.asarray(toks),
                           j_init_cache(jcfg, SLOTS, S_CACHE))
    tc = init_cache(tcfg, SLOTS, S_CACHE, device="cpu")
    tops.reset_kernel_counters()
    tl, _ = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), tc, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    tok = np.array([[0], [int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for i in range(8):
        pos = np.array([i, 12 + i], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, _ = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None].astype(np.int32)
    _assert_cache_close(tc, jc)
    _assert_counts(sparse, tops.kernel_counters(), arch)


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["routed", "ties"])
@ARCH
def test_decode_step_with_more_slots_than_capacity(arch, zero_router):
    """A decode step of 16 slots at capacity factor 0.05 (capacity 8 per
    expert for 32 slots over 4 experts; with the zero router all 16
    tokens take experts 0 and 1, and the last 8 of each drop): logits and
    cache against the reference's decode step, the drops asserted."""
    jcfg, tcfg, jp, tp = _setup(arch, zero_router=zero_router,
                                capacity_factor=0.05)
    B = 16
    assert moe.capacity(B, tcfg.moe) == 8
    cache = np.random.default_rng(4).standard_normal(
        (tcfg.n_layers, B, 20, tcfg.n_kv_heads, tcfg.hd)).astype(np.float32)
    tok = _toks(jcfg, (B, 1), 8)
    pos = np.random.default_rng(9).integers(0, 19, B).astype(np.int32)
    jl, jc = jax.jit(j_decode, static_argnums=(1,))(
        jp, jcfg, jnp.asarray(tok), {"k": jnp.asarray(cache),
                                     "v": jnp.asarray(-cache)},
        jnp.asarray(pos))
    tc = {"k": torch.from_numpy(cache.copy()),
          "v": torch.from_numpy(-cache)}
    with moe.route_log() as log:
        tl, _ = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(pos))
    dropped = [int((~c["keep"]).sum()) for c in log.calls]
    assert sum(dropped) > 0, dropped
    if zero_router:
        assert dropped == [16] * tcfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)


@SPARSE
@ARCH
def test_decode_chunk_program_matches_reference(arch, sparse):
    """The engine's 8-step chunk program (a ``DecodeGraph``, eager on the
    CPU) on a seeded cache, slots at positions 12, 3 and 19: tokens equal
    the reference's jitted chunk, every leaf allclose, written in
    place."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    cache = _seeded_cache(tcfg, 3)
    tok = np.array([7, 11, 13], np.int32)
    pos = np.array([12, 3, 19], np.int32)
    want, jc = j_decode_chunk(jcfg, 8)(jp, jnp.asarray(tok[:, None]),
                                       _jnp_tree(cache), jnp.asarray(pos))
    tc = _torch(cache)
    ptrs = [t.data_ptr() for t in cache_leaves(tc)]
    got = DecodeGraph(_decode_chunk_fn(tcfg, 8), tp, tc, SLOTS + 1).run(
        tok, pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_cache_close(tc, jc)
    assert [t.data_ptr() for t in cache_leaves(tc)] == ptrs


@pytest.mark.parametrize("S,offset", [(9, 0), (20, 4)])
@SPARSE
@ARCH
def test_admission_program_equals_reference(arch, sparse, S, offset):
    """The admission program (a ``PrefillGraph``, eager on the CPU; its
    capacity from the prompt length) into slot 2 at a write offset,
    against the reference's jitted slot prefill: logits and every leaf."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    cache = _seeded_cache(tcfg, 4)
    toks = _toks(jcfg, (1, S), S)
    want, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(toks), _jnp_tree(cache),
                                    jnp.int32(2), jnp.int32(offset))
    tc = _torch(cache)
    got = PrefillGraph(_slot_prefill_fn(tcfg), tp, tc, S).run(toks, 2,
                                                              offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tc, jc)


@SPARSE
@ARCH
def test_serve_programs_match_reference(arch, sparse):
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    kw = dict(max_slots=2, max_seq_len=28, decode_chunk=3, prompt_len=16)
    want = j_serve_programs(jp, jcfg, **kw)
    got = serve_programs(tp, tcfg, **kw)
    assert sorted(got) == sorted(want)
    for name, (fn, args) in got.items():
        w_out, w_cache = jax.jit(want[name][0])(*want[name][1])
        out = fn(*args)
        if name == "prefill":
            out, cache = out
        else:
            cache = args[2]
        if name == "decode_chunk":
            np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(w_out), **TOL)
        _assert_cache_close(cache, w_cache)


@pytest.mark.parametrize("cf", [1.25, 0.05])
@SPARSE
@ARCH
def test_engine_token_streams_equal_reference(arch, sparse, cf):
    """Four requests (prompts 20, 6, 20, 6; 6 new tokens) through two
    slots of 28 rows, chunked greedy decode, at the default and a
    dropping capacity factor: the reference engine's token streams, and
    the n:m:g routes counted (attention only)."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse, capacity_factor=cf)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 20, 6)]
    kw = dict(max_slots=2, max_seq_len=28, decode_chunk=4)
    want = JEngine(jp, jcfg, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    tops.reset_kernel_counters()
    got = ServeEngine(tp, tcfg, device="cpu", **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    assert [o.tokens for o in got] == [o.tokens for o in want]
    assert all(len(o.tokens) == 6 for o in got)
    _assert_counts(sparse, tops.kernel_counters(), arch)


# ---------------------------------------------------------------------------
# params, bridge, configs
# ---------------------------------------------------------------------------


@ARCH
def test_param_tree_equals_reference(arch):
    """``init_lm`` draws ``moe`` in place of ``mlp``: the reference's
    keys and shapes, the router in f32, the rest in the model's dtype."""
    jcfg, tcfg, jp, _ = smoke_setup(False, arch)
    mine = init_lm(get_smoke(arch), seed=0, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    m = mine["layers"]["moe"]
    assert "mlp" not in mine["layers"]
    assert sorted(m) == sorted(MOE_LEAVES[arch])
    assert m["router"].dtype == torch.float32
    assert m["wi"].dtype == m["wo"].dtype == torch.bfloat16
    mc = tcfg.moe
    assert m["wi"].shape == (tcfg.n_layers, mc.num_experts, tcfg.d_model,
                             2 * mc.d_expert)


@ARCH
def test_init_lm_draws_per_layer_deterministically(arch):
    cfg = get_smoke(arch)
    a, b, c = (init_lm(cfg, seed=s, device="cpu") for s in (4, 4, 5))
    for x, y, z in zip(*(cache_leaves(t["layers"]["moe"])
                         for t in (a, b, c))):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert not torch.equal(x[0], x[1])


@SPARSE
@ARCH
def test_bridge_carries_the_moe_subtree(arch, sparse):
    """The reference's ``moe`` subtree crosses the bridge leaf for leaf,
    bitwise, in its dtypes (router f32 [D, E], ``wi`` [E, D, 2F], ``wo``
    [E, F, D], arctic's ``res_wi`` / ``res_wo``), also in bf16 and beside
    n:m:g attention."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    jm, tm = jp["layers"]["moe"], tp["layers"]["moe"]
    assert sorted(tm) == sorted(MOE_LEAVES[arch])
    for name in MOE_LEAVES[arch]:
        assert isinstance(tm[name], torch.Tensor), name
        np.testing.assert_array_equal(tm[name].numpy(), np.asarray(jm[name]))
    from repro.models import init_lm as j_init_lm

    jb = jax.jit(j_init_lm, static_argnums=1)(jax.random.PRNGKey(1),
                                              dataclasses.replace(
                                                  jcfg, dtype="bfloat16"))
    tb = bridge.params_from_numpy(params_to_numpy(jb), device="cpu")
    for name in MOE_LEAVES[arch]:
        t, j = tb["layers"]["moe"][name], jb["layers"]["moe"][name]
        assert t.dtype == (torch.float32 if name == "router"
                           else torch.bfloat16)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


@ARCH
def test_init_moe_scale_against_the_reference_s(arch):
    """Each MoE leaf's init std against the reference's ``init_lm``'s,
    within sampling error (5%).  The reference's ``dense_init`` takes a
    leaf's first axis as its fan-in: D for the router and ``res_wi``, Fr
    for ``res_wo``, and E for the expert leaves ``wi`` and ``wo``, which
    the port draws with their own fan-in, D and F (a deliberate
    difference, ``models/moe.py:init_moe``)."""
    from repro.configs import get_smoke as j_smoke
    from repro.models import init_lm as j_init_lm

    cfg = get_smoke(arch)
    jm = jax.jit(j_init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                              j_smoke(arch))["layers"]["moe"]
    tm = init_lm(cfg, seed=0, device="cpu")["layers"]["moe"]
    D, mc = cfg.d_model, cfg.moe
    Fr = mc.dense_residual_ff
    ref_fan_in = {"router": D, "wi": mc.num_experts, "wo": mc.num_experts,
                  "res_wi": D, "res_wo": Fr}
    fan_in = {"router": D, "wi": D, "wo": mc.d_expert, "res_wi": D,
              "res_wo": Fr}
    assert sorted(tm) == sorted(jm) == sorted(MOE_LEAVES[arch])
    for name in MOE_LEAVES[arch]:
        want = float(np.asarray(jm[name], np.float32).std())
        got = tm[name].float().std().item()
        # the truncated normal's std is 0.88 of its scale
        assert abs(want * ref_fan_in[name] ** 0.5 - 0.88) < 0.05, (name, want)
        ratio = (ref_fan_in[name] / fan_in[name]) ** 0.5
        assert abs(got / (want * ratio) - 1) < 0.05, (name, got, want)


@ARCH
def test_configs_are_the_reference_s(arch):
    """CONFIG and SMOKE equal the reference's field for field (the
    ``MoEConfig`` too), and the port admits both."""
    from repro.configs import get_arch as j_config, get_smoke as j_smoke

    for mine, ref in ((get_config(arch), j_config(arch)),
                      (get_smoke(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert isinstance(mine.moe, MoEConfig)
        assert mine.check_ported() is mine


def test_moe_config_is_the_reference_s():
    from repro.models.common import MoEConfig as JMoEConfig

    assert dataclasses.asdict(MoEConfig()) == dataclasses.asdict(
        JMoEConfig())


@pytest.mark.parametrize("change,ok", [
    (dict(combine="gather"), True),
    (dict(combine="replicated"), True),
    (dict(combine="scatter"), False),
    (dict(impl="shmap"), False),
])
def test_check_ported_moe_boundary(change, ok):
    """The one-device implementation with the gather or replicated
    combine is ported; ``impl="shmap"`` and ``combine="scatter"`` are
    expert-parallel strategies and are refused, each by name."""
    cfg = _with_moe(get_smoke(MOONSHOT), **change)
    if ok:
        assert cfg.check_ported() is cfg
        return
    what = "shmap" if "impl" in change else "scatter"
    with pytest.raises(NotImplementedError, match=what):
        cfg.check_ported()


def test_replicated_combine_equals_gather():
    jcfg, tcfg, jp, tp = _setup(ARCTIC, combine="replicated")
    toks = _toks(jcfg, (2, 10), 3)
    want, _ = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    got = forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gather = forward(tp, _with_moe(tcfg, combine="gather"),
                     torch.from_numpy(toks))
    assert torch.equal(got, gather)


@ARCH
def test_sparsify_for_serving_converts_no_expert_weight(arch):
    """``attn=True``: the attention projections convert; the globs
    ``*mlp.wi`` / ``*mlp.wo`` match no ``moe.*`` leaf, so every expert,
    router and dense-residual weight stays dense (and is the same
    tensor: the n:m:g copy shares it)."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = init_lm(cfg, seed=1, device="cpu")
    sp = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    for name in ("wq", "wk", "wv", "wo"):
        assert isinstance(sp["layers"]["attn"][name], GroupedNMTensor)
    for name, t in sp["layers"]["moe"].items():
        assert t is params["layers"]["moe"][name], name
    assert sp["embedding"] is params["embedding"]


@ARCH
def test_serve_cli_runs_the_moe_architectures(arch, capsys):
    assert launch.main(["--arch", arch, "--smoke", "--engine", "--sparse",
                        "--nm", "1:4:8", "--device", "cpu", "--requests",
                        "3", "--prompt-len", "20", "--gen-len", "4"]) == 0
    assert "served 3 requests" in capsys.readouterr().out
