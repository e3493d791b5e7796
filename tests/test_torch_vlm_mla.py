"""The port's paligemma-3b (a prefix of precomputed patch embeddings under a
prefix-LM mask, MQA kv = 1, gated gelu MLP, tied head) and minicpm3-4b
(MLA: latent projections, decoupled RoPE key, the absorbed decode over the
compressed ``{"ckv", "kr"}`` cache) against the JAX package's, at their
SMOKE configs in f32, dense and n:m:g 1:4:8 gr16 with ``attn=True``, the
reference's params carried over by the bridge:

- slot-mode prefill (paligemma behind ``vision_prefix`` prefix rows) then
  8 decode steps: logits, greedy tokens and every cache leaf;
- ``forward`` hidden states with and without ``prefix_embeds``, and with
  ``embeds=``; ``loss_fn`` with a prefix (and minicpm3's), its gradient
  against ``jax.grad`` of the reference's;
- the param tree (MLA's nine leaves), the bridge, ``sparsify_for_serving``
  (MLA's ``attn.wo`` and nothing else of MLA);
- the engine's programs over the ``{"ckv", "kr"}`` cache: the decode
  chunk, admission with a write offset, ``reset`` / ``compact``,
  ``serve_programs``, and a whole ``ServeEngine`` run;
- the absorbed decode against the port's own un-absorbed forward, and the
  clamp of a write past the cache end (ROADMAP C2);
- ``init_lm``'s per-layer draw, the configs, the serve CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, forward as j_forward, \
    init_cache as j_init_cache, logits_of as j_logits_of, \
    loss_fn as j_loss_fn, prefill_into_slot as j_prefill_into_slot
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve.cache import _jit_slot_prefill as j_slot_prefill, \
    gather_slots as j_gather_slots, reset_slot as j_reset_slot
from repro.serve.engine import _jit_decode_chunk as j_decode_chunk, \
    serve_programs as j_serve_programs
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch
from repro_torch.launch import train as ttrain
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    logits_of, prefill, prefill_into_slot
from repro_torch.models.common import MLAConfig, MoEConfig
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve import Request, ServeEngine, sparsify_for_serving
from repro_torch.serve.cache import SlotKVCache, _slot_prefill_fn
from repro_torch.serve.engine import _decode_chunk_fn, serve_programs
from repro_torch.serve.graphs import DecodeGraph, PrefillGraph

from tests._torch_compat import smoke_setup
from tests.test_torch_families import _assert_cache_close, _jnp_tree, \
    _seeded_cache, _shapes, _sorted_leaves, _torch

# f32 in both packages; outputs differ by summation order only (the
# tolerance of tests/test_torch_families.py)
TOL = dict(rtol=1e-4, atol=1e-4)
VLM, MLA = "paligemma-3b", "minicpm3-4b"
ARCHES = [VLM, MLA]
SPARSE = pytest.mark.parametrize("sparse", [False, True],
                                 ids=["dense", "nmg"])
ARCH = pytest.mark.parametrize("arch", ARCHES)
SLOTS, S_CACHE = 2, 40
MLA_LEAVES = ("wdq", "wuq", "wdkv", "wuk", "wuv", "wkr", "wo", "q_norm",
              "kv_norm")


def _prefix(cfg, seed=0, B=1):
    """Seeded patch embeddings [B, vision_prefix, d_model] (standard
    normal, numpy f32), or None for a model without a prefix."""
    if not cfg.vision_prefix:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _assert_counts(cfg, sparse, counts, what):
    if not sparse:
        assert not any(k[0].startswith("nmg") for k in counts), what
        return
    assert counts[("nmg_linear", "gemv[default]")] > 0, what
    assert counts[("nmg_ffn", "fused[default]")] > 0, what
    # MLA has no q/k/v projections to fuse: its wq-like leaves stay dense
    assert (("nmg_qkv", "fused[default]") in counts) == \
        (cfg.attn_type == "gqa"), what


@SPARSE
@ARCH
def test_slot_prefill_and_decode_match_reference(arch, sparse):
    """A 12-token prompt (paligemma: behind its 8 prefix rows) into slot 1
    of a 2-slot cache, then 8 decode steps of both slots (slot 0 empty, at
    position 0; slot 1 from P + S): logits, greedy tokens and every cache
    leaf, MLA's ``ckv`` / ``kr`` included."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    toks, pe = _toks(jcfg, (1, 12), 1), _prefix(jcfg)
    P = jcfg.vision_prefix
    jl, jc = jax.jit(lambda p, t, c, e: j_prefill_into_slot(
        p, jcfg, t, c, 1, prefix_embeds=e))(
        jp, jnp.asarray(toks), j_init_cache(jcfg, SLOTS, S_CACHE), _j(pe))
    tc = init_cache(tcfg, SLOTS, S_CACHE, device="cpu")
    assert sorted(tc) == (["ckv", "kr"] if arch == MLA else ["k", "v"])
    tops.reset_kernel_counters()
    tl, _ = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), tc, 1,
                              prefix_embeds=_t(pe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    tok = np.array([[0], [int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for i in range(8):
        pos = np.array([i, P + 12 + i], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, _ = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None].astype(np.int32)
    _assert_cache_close(tc, jc)
    _assert_counts(tcfg, sparse, tops.kernel_counters(), arch)


@pytest.mark.parametrize("with_prefix", [False, True],
                         ids=["tokens", "prefix"])
@SPARSE
@ARCH
def test_forward_hidden_matches_reference(arch, sparse, with_prefix):
    """Hidden states and logits of ``forward`` over 2 x 16 tokens, with
    and without a prefix (P + 16 rows; minicpm3 has no vision prefix, so
    its prefix case puts 8 rows in front of its MLA layers, which neither
    package masks as a prefix)."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    toks = _toks(jcfg, (2, 16), 5)
    pe = None
    if with_prefix:
        pe = np.random.default_rng(6).standard_normal(
            (2, jcfg.vision_prefix or 8, jcfg.d_model)).astype(np.float32)
    want, _ = j_forward(jp, jcfg, jnp.asarray(toks), prefix_embeds=_j(pe),
                        remat="none")
    got = forward(tp, tcfg, torch.from_numpy(toks), prefix_embeds=_t(pe))
    rows = 16 + (0 if pe is None else pe.shape[1])
    assert got.shape == (2, rows, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        logits_of(tp, tcfg, got).numpy(),
        np.asarray(j_logits_of(jp, jcfg, want)), **TOL)


@ARCH
def test_forward_embeds_matches_reference(arch):
    """``embeds=`` [B, S, D] are taken as they are, in place of the
    scaled token embeddings, with and without a prefix in front."""
    jcfg, tcfg, jp, tp = smoke_setup(False, arch)
    emb = np.random.default_rng(7).standard_normal(
        (2, 10, jcfg.d_model)).astype(np.float32)
    for pe in (None, _prefix(jcfg, 8, B=2)):
        want, _ = j_forward(jp, jcfg, embeds=jnp.asarray(emb),
                            prefix_embeds=_j(pe), remat="none")
        got = forward(tp, tcfg, embeds=torch.from_numpy(emb),
                      prefix_embeds=_t(pe))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefix_mask_is_bidirectional_over_the_prefix():
    """paligemma SMOKE: the prefix attends both ways.  The prefix-LM
    forward differs from the same embeddings fed causally (``embeds=``
    with the text scaled as ``_embed`` scales it) in the prefix rows and,
    through them, in the text rows."""
    _, cfg, _, tp = smoke_setup(False, VLM)
    toks = torch.from_numpy(_toks(cfg, (1, 12), 9))
    pe = torch.from_numpy(_prefix(cfg, 9))
    prefix_lm = forward(tp, cfg, toks, prefix_embeds=pe)
    text = tp["embedding"][toks] * cfg.d_model ** 0.5
    causal = forward(tp, cfg, embeds=torch.cat([pe, text], dim=1))
    P = cfg.vision_prefix
    assert prefix_lm.shape == causal.shape == (1, P + 12, cfg.d_model)
    for rows in (slice(0, P), slice(P, None)):
        assert (prefix_lm[:, rows] - causal[:, rows]).abs().max() > 1e-2


@pytest.mark.parametrize("arch,with_prefix", [(VLM, True), (VLM, False),
                                              (MLA, False)],
                         ids=["vlm_prefix", "vlm_tokens", "mla"])
def test_loss_and_grads_match_reference(arch, with_prefix):
    """``loss_fn`` (paligemma with ``batch["prefix_embeds"]``: the prefix
    rows are dropped before the head) and every parameter's gradient
    from autograd, against ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, jp, tp = smoke_setup(False, arch)
    rng = np.random.default_rng(11)
    batch = {"tokens": _toks(jcfg, (2, 12), 11),
             "labels": _toks(jcfg, (2, 12), 12)}
    batch["labels"][0, :3] = -1
    if with_prefix:
        batch["prefix_embeds"] = rng.standard_normal(
            (2, jcfg.vision_prefix, jcfg.d_model)).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b, remat="none"), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, aux, tg = ttrain.loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux["moe_aux"]) == 0.0
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
    for key, g in want.items():
        scale = max(1e-30, np.abs(g).max())
        assert np.abs(got[key] - g).max() <= 1e-4 * scale, key


@ARCH
def test_param_tree_equals_reference(arch):
    """``init_lm``'s tree has the reference's keys and shapes: MLA's nine
    attention leaves (no wq/wk/wv), paligemma's MQA projections and no
    ``lm_head`` (tied)."""
    jcfg, tcfg, jp, _ = smoke_setup(False, arch)
    mine = init_lm(tcfg, seed=0, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    a, L, D = mine["layers"]["attn"], tcfg.n_layers, tcfg.d_model
    if arch == MLA:
        m, H = tcfg.mla, tcfg.n_heads
        assert sorted(a) == sorted(MLA_LEAVES)
        assert a["wuq"].shape == (L, m.q_lora_rank, H * (
            m.qk_nope_head_dim + m.qk_rope_head_dim))
        assert a["wkr"].shape == (L, D, m.qk_rope_head_dim)
        assert a["wo"].shape == (L, H * m.v_head_dim, D)
        for name in ("q_norm", "kv_norm"):
            assert torch.equal(a[name], torch.ones_like(a[name]))
        assert "lm_head" in mine
    else:
        assert a["wk"].shape == a["wv"].shape == (L, D, tcfg.hd)
        assert "lm_head" not in mine


@SPARSE
def test_bridge_carries_the_mla_leaves(sparse):
    """The reference's MLA layer tree crosses the bridge leaf for leaf
    (dense, and with ``attn.wo`` converted)."""
    _, _, jp, tp = smoke_setup(sparse, MLA)
    ja, ta = jp["layers"]["attn"], tp["layers"]["attn"]
    assert sorted(ta) == sorted(MLA_LEAVES)
    for name in MLA_LEAVES:
        if sparse and name == "wo":
            assert isinstance(ta[name], GroupedNMTensor)
            np.testing.assert_array_equal(ta[name].val.numpy(),
                                          np.asarray(ja[name].val))
            continue
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]))


@ARCH
def test_sparsify_for_serving_converts_the_reference_s_leaves(arch):
    """``attn=True``: paligemma's wq/wk/wv/wo and MLP; of an MLA layer
    only ``attn.wo`` (the reference's globs), its latent projections and
    norms dense.  Each n:m:g leaf densifies to a pruning of its weight."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = init_lm(cfg, seed=1, device="cpu")
    sp = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    attn = ("wq", "wk", "wv", "wo") if arch == VLM else ("wo",)
    for part, names in (("attn", attn), ("mlp", ("wi", "wo"))):
        for name in names:
            w = sp["layers"][part][name]
            assert isinstance(w, GroupedNMTensor), (part, name)
            dense = torch.stack([w.layer(i).to_dense()
                                 for i in range(w.val.shape[0])])
            kept = dense != 0
            ref = params["layers"][part][name]
            assert torch.equal(dense[kept], ref[kept])
            assert kept.float().mean() <= 0.25 + 1e-6
    if arch == MLA:
        for name in MLA_LEAVES[:-3] + MLA_LEAVES[-2:]:
            assert isinstance(sp["layers"]["attn"][name], torch.Tensor), name
    assert isinstance(sp["embedding"], torch.Tensor)


@SPARSE
@ARCH
def test_decode_chunk_program_matches_reference(arch, sparse):
    """The engine's 8-step chunk program (a ``DecodeGraph``, eager on the
    CPU) on a seeded cache (MLA: ``{"ckv", "kr"}``), slots at positions
    12, 3 and 19: tokens equal the reference's jitted chunk, every leaf
    allclose and written in place."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
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


@pytest.mark.parametrize("S,offset", [(9, 0), (6, 10)])
@SPARSE
@ARCH
def test_admission_program_equals_reference(arch, sparse, S, offset):
    """The admission program (a ``PrefillGraph``, eager on the CPU) on a
    seeded cache into slot 2 at a write offset, against the reference's
    jitted slot prefill: logits and every leaf."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    cache = _seeded_cache(tcfg, 4)
    toks = _toks(jcfg, (1, S), S)
    want, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(toks), _jnp_tree(cache),
                                    jnp.int32(2), jnp.int32(offset))
    tc = _torch(cache)
    got = PrefillGraph(_slot_prefill_fn(tcfg), tp, tc, S).run(toks, 2,
                                                              offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("op", ["reset", "compact"])
def test_reset_and_compact_walk_the_latent_cache(op):
    _, cfg, _, _ = smoke_setup(False, MLA)
    cache = _seeded_cache(cfg, 8)
    kv = SlotKVCache(cfg, SLOTS + 1, 28, device="cpu")
    assert sorted(kv.data) == ["ckv", "kr"]
    for name, t in kv.data.items():
        t.copy_(torch.from_numpy(cache[name]))
    ptrs = [t.data_ptr() for t in cache_leaves(kv.data)]
    if op == "reset":
        kv.reset(1)
        want = j_reset_slot(_jnp_tree(cache), jnp.int32(1))
    else:
        kv.compact([2, 0, 1])
        want = j_gather_slots(_jnp_tree(cache),
                              jnp.asarray([2, 0, 1], jnp.int32))
    assert [t.data_ptr() for t in cache_leaves(kv.data)] == ptrs
    for a, b in zip(_sorted_leaves(kv.data),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@SPARSE
@ARCH
def test_serve_programs_match_reference(arch, sparse):
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
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


@SPARSE
@ARCH
def test_engine_token_streams_equal_reference(arch, sparse):
    """Four requests (prompts 20, 6, 20, 6; 6 new tokens) through two
    slots of 28 rows, chunked greedy decode: the same token streams as the
    reference engine, and the n:m:g kernels' routes counted (no fused QKV
    at MLA)."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
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
    _assert_counts(tcfg, sparse, tops.kernel_counters(), arch)


@SPARSE
@ARCH
def test_decode_after_prefix_admission_equals_full_forward(arch, sparse):
    """The slot rule's invariant, in the port alone: a prompt admitted
    (paligemma: behind its prefix) then 4 tokens decoded, each step's
    logits against the last row of one ``forward`` over everything fed so
    far.  At minicpm3 this holds the absorbed decode over the compressed
    cache to the un-absorbed attention of the prefill."""
    _, cfg, _, tp = smoke_setup(sparse, arch)
    toks = torch.from_numpy(_toks(cfg, (1, 10), 13))
    pe = _t(_prefix(cfg, 13))
    P = cfg.vision_prefix
    cache = init_cache(cfg, 1, 32, device="cpu")
    logits, _ = prefill_into_slot(tp, cfg, toks, cache, 0, prefix_embeds=pe)
    fed = toks
    for i in range(4):
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        fed = torch.cat([fed, nxt], dim=1)
        logits, _ = decode_step(tp, cfg, nxt, cache,
                                torch.tensor([P + 10 + i]))
        full = logits_of(tp, cfg, forward(tp, cfg, fed, prefix_embeds=pe)
                         [:, -1:])[:, 0]
        torch.testing.assert_close(logits, full, **TOL)


def test_classic_prefill_with_prefix_matches_reference():
    """The classic prefill (``cache_len``) behind a prefix: logits and the
    P + S cache rows, against the reference's."""
    jcfg, tcfg, jp, tp = smoke_setup(False, VLM)
    from repro.models import prefill as j_prefill

    toks, pe = _toks(jcfg, (1, 12), 14), _prefix(jcfg, 14)
    jl, jc = jax.jit(lambda p, t, e: j_prefill(p, jcfg, t, 32,
                                               prefix_embeds=e))(
        jp, jnp.asarray(toks), jnp.asarray(pe))
    tl, tc = prefill(tp, tcfg, torch.from_numpy(toks), 32,
                     prefix_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)


def test_mla_decode_write_past_the_end_is_clamped():
    """ROADMAP C2 at the latent cache: a decode write at position S of an
    S-row leaf lands on row S - 1 (the reference drops it); only a slot
    that already finished writes there.  Rows before it are untouched."""
    _, cfg, _, tp = smoke_setup(False, MLA)
    cache = _torch(_seeded_cache(cfg, 15, rows=8))
    before = {k: v.clone() for k, v in cache.items()}
    decode_step(tp, cfg, torch.tensor([[3], [5], [7]], dtype=torch.int32),
                cache, torch.tensor([8, 2, 9]))
    for name in ("ckv", "kr"):
        c, b = cache[name], before[name]
        assert not torch.equal(c[:, 0, 7], b[:, 0, 7])
        assert torch.equal(c[:, 0, :7], b[:, 0, :7])
        assert torch.equal(c[:, 2, :7], b[:, 2, :7])
        assert not torch.equal(c[:, 1, 2], b[:, 1, 2])


@ARCH
def test_init_lm_draws_per_layer_deterministically(arch):
    """Every leaf has its config's shape and dtype, each stacked layer is
    drawn anew, and the same seed gives the same values, another seed
    others."""
    cfg = get_smoke(arch)
    a, b, c = (init_lm(cfg, seed=s, device="cpu") for s in (4, 4, 5))
    la, lb, lc = (cache_leaves(t) for t in (a, b, c))
    assert len(la) == len(lb) == len(lc)
    assert _shapes(a) == _shapes(smoke_setup(False, arch)[2])
    for x, y, z in zip(la, lb, lc):
        assert x.dtype == cfg.tdtype and torch.equal(x, y)
        if x.ndim == 3:
            assert not torch.equal(x, z)
            assert not torch.equal(x[0], x[1])


@ARCH
def test_configs_are_the_reference_s(arch):
    """CONFIG and SMOKE equal the reference's field for field (MLA's
    ``MLAConfig`` too), and the port runs both."""
    from repro.configs import get_arch as j_config, get_smoke as j_smoke

    for mine, ref in ((get_config(arch), j_config(arch)),
                      (get_smoke(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.check_ported() is mine
    if arch == MLA:
        assert isinstance(get_config(arch).mla, MLAConfig)


@pytest.mark.parametrize("change,what", [
    (dict(attn_type="hybrid"), "attn_type"),
    (dict(attn_type="mla", mla=None), "MLAConfig"),
    (dict(n_enc_layers=2), "enc-dec"),
    # int8 KV is ported (tests/test_torch_kvcache.py); an unknown name not
    (dict(kv_cache_dtype="int4"), "kv_cache_dtype"),
    (dict(moe=object()), "moe"),
    (dict(ssm=object()), "ssm"),
    # the reference's MoE strategies are ported (shmap, scatter:
    # tests/test_torch_moe.py); a name it lacks is refused
    (dict(moe=MoEConfig(impl="shmap_all_to_all")), "shmap"),
    (dict(moe=MoEConfig(combine="scatter_add")), "scatter"),
])
def test_check_ported_still_refuses_the_other_families(change, what):
    """Families and strategies the port does not run: an untyped ``moe``
    (not a ``MoEConfig``) and a MoE ``impl`` or ``combine`` the reference
    does not have (every one it has is ported)."""
    cfg = dataclasses.replace(get_smoke(MLA), **change)
    with pytest.raises(NotImplementedError, match=what):
        cfg.check_ported()


def _projections(cfg, params):
    """(op, weight or q/k/v group) of each routed projection of one layer
    of n:m:g ``attn=True`` params: MLA routes only ``attn.wo`` of its
    attention."""
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    one = {k: v.layer(0) for k, v in attn.items()
           if isinstance(v, GroupedNMTensor)}
    out = [("nmg_linear", one.pop("wo"))]
    if cfg.attn_type == "gqa":
        out.append(("mm_fused_qkv", tuple(one.pop(k)
                                          for k in ("wq", "wk", "wv"))))
    assert not one, sorted(one)
    return out + [("mm_gated", mlp["wi"].layer(0)),
                  ("nmg_linear", mlp["wo"].layer(0))]


@ARCH
def test_tune_walk_and_predict_route_over_the_model(arch):
    """``autotune_for_serving`` over the n:m:g params tunes one
    crossover per converted shape (MLA: ``attn.wo`` and the MLP only), the
    fused QKV decision only where there is a q/k/v group (paligemma's MQA
    segments), and the fused FFN's; under the table it fills,
    ``predict_route`` of each projection times the layers equals the
    counters of one decode step and of one admission."""
    from repro_torch.tune import routing
    from repro_torch.tune.bench import autotune_for_serving
    from repro_torch.tune.table import shape_key

    _, cfg, _, tp = smoke_setup(True, arch)
    projs = _projections(cfg, tp)
    try:
        tab = autotune_for_serving(tp, max_slots=SLOTS, prompt_lens=[20],
                                   reps=1, gated_act=cfg.act)
        ws = [w for op, w in projs if op != "mm_fused_qkv"] + [
            w for op, g in projs if op == "mm_fused_qkv" for w in g]
        assert {k for k in tab.entries if k.startswith("decode_m_max/")} \
            == {shape_key("decode_m_max", **tops._route_ctx(
                w, torch.float32)) for w in ws}
        assert any(k.startswith("fused_qkv/") for k in tab.entries) == \
            (arch == VLM)
        assert any(k.startswith("fused_ffn/") for k in tab.entries)
        for M, run in ((SLOTS, lambda: decode_step(
                tp, cfg, torch.zeros((SLOTS, 1), dtype=torch.int32),
                init_cache(cfg, SLOTS, 24, device="cpu"),
                torch.tensor([3, 5]))),
                (20, lambda: prefill(tp, cfg, torch.from_numpy(
                    _toks(cfg, (1, 20), 2)), 24))):
            want = {}
            for op, w in projs:
                group = op == "mm_fused_qkv"
                for key in tops.predict_route(
                        op, None if group else w, ws=w if group else None,
                        M=M, dtype=torch.float32, device="cpu"):
                    want[key] = want.get(key, 0) + cfg.n_layers
            tops.reset_kernel_counters()
            run()
            assert dict(tops.kernel_counters()) == want, M
    finally:
        routing.clear_active_table()


@ARCH
def test_serve_cli_runs_the_new_architectures(arch, capsys):
    assert launch.main(["--arch", arch, "--smoke", "--engine", "--sparse",
                        "--nm", "1:4:8", "--device", "cpu", "--requests",
                        "3", "--prompt-len", "20", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
