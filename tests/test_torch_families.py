"""The port's starcoder2-15b (non-gated gelu MLP, GQA kv=4) and gemma2-9b
(local/global layer pairs, a ring cache of ``local_window`` rows in the
local layers, attention and logit softcaps, post-norms, gated gelu MLP,
tied head) against the JAX package's, at their SMOKE configs in f32,
dense and n:m:g 1:4:8 gr16 with ``attn=True``, the reference's params
carried over by the bridge:

- slot-mode prefill (prompts 16 and 20; at gemma2's window of 16 a
  20-token prompt wraps the ring at admission) then 8 decode steps:
  logits, greedy tokens and every nested cache leaf;
- ``forward`` hidden states, the pair tree, ``sparsify_for_serving`` on
  ``layers.local.*`` / ``layers.global.*``, the bridge;
- the engine's programs on a pair cache: the decode chunk across the
  ring's wrap, admission with a write offset, ``reset`` / ``compact``,
  ``serve_programs``, and a whole ``ServeEngine`` run;
- the reference's classic-prefill ring fault (ROADMAP C10): its classic
  mode puts a ring's tail at row 0, so for 20 % 16 != 0 the next decode
  step is far from its own full forward, while its slot mode and both of
  the port's modes agree with it;
- ``init_lm``'s per-layer draw: every leaf's shape and dtype, and the same
  values from the same seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, forward as j_forward, \
    init_cache as j_init_cache, logits_of as j_logits_of, \
    prefill as j_prefill
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve.cache import _jit_slot_prefill as j_slot_prefill, \
    gather_slots as j_gather_slots, reset_slot as j_reset_slot
from repro.serve.engine import _jit_decode_chunk as j_decode_chunk, \
    serve_programs as j_serve_programs
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    logits_of, prefill, prefill_into_slot
from repro_torch.models.transformer import cache_leaves, map_cache
from repro_torch.serve import Request, ServeEngine, sparsify_for_serving
from repro_torch.serve.cache import SlotKVCache, _slot_prefill_fn
from repro_torch.serve.engine import _decode_chunk_fn, serve_programs
from repro_torch.serve.graphs import DecodeGraph, PrefillGraph

from tests._torch_compat import smoke_setup

# f32 in both packages; outputs differ by summation order only (the
# tolerance of tests/test_torch_model.py)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHES = ["starcoder2-15b", "gemma2-9b"]
SPARSE = pytest.mark.parametrize("sparse", [False, True],
                                 ids=["dense", "nmg"])
ARCH = pytest.mark.parametrize("arch", ARCHES)
SLOTS, S_CACHE = 2, 32


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _sorted_leaves(tree):
    """A tree's leaves in ``jax.tree_util.tree_leaves`` order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _assert_cache_close(got, want):
    """Every leaf of the port's cache tree allclose to the reference's
    (same nesting)."""
    g, w = _sorted_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _assert_counts(cfg, sparse, counts, what):
    fused_ffn = ("nmg_ffn", "fused[default]") in counts
    if not sparse:
        assert not any(k[0].startswith("nmg") for k in counts), what
        return
    assert counts[("nmg_qkv", "fused[default]")] > 0, what
    assert counts[("nmg_linear", "gemv[default]")] > 0, what
    # gemma2's packed gated wi takes the fused FFN launch at decode;
    # starcoder2's plain wi the GEMV
    assert fused_ffn == cfg.gated_mlp, what


@pytest.mark.parametrize("S", [16, 20])
@SPARSE
@ARCH
def test_slot_prefill_and_decode_match_reference(arch, sparse, S):
    """A prompt into slot 1 of a 2-slot cache, then 8 decode steps of both
    slots (slot 0 empty, at position 0): logits, greedy tokens and every
    cache leaf.  At gemma2 the local leaves hold 16 rows, so the 20-token
    prompt wraps the ring at admission and every prompt wraps it while it
    decodes."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (1, S),
                                             dtype=np.int32)
    jl, jc = j_slot_prefill(jcfg)(
        jp, jnp.asarray(toks), j_init_cache(jcfg, SLOTS, S_CACHE),
        jnp.int32(1), jnp.int32(0))
    tc = init_cache(tcfg, SLOTS, S_CACHE, device="cpu")
    if arch == "gemma2-9b":
        assert tc["local"]["k"].shape[2] == tcfg.local_window == 16
        assert tc["global"]["k"].shape[2] == S_CACHE
    tops.reset_kernel_counters()
    tl, _ = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), tc, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    tok = np.array([[0], [int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for i in range(8):
        pos = np.array([i, S + i], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, _ = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None].astype(np.int32)
    _assert_cache_close(tc, jc)
    _assert_counts(tcfg, sparse, tops.kernel_counters(), (arch, S))


@SPARSE
@ARCH
def test_forward_hidden_matches_reference(arch, sparse):
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    want, _ = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    got = forward(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 24, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        logits_of(tp, tcfg, got).numpy(),
        np.asarray(j_logits_of(jp, jcfg, want)), **TOL)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@ARCH
def test_param_tree_equals_reference(arch):
    """The port's ``init_lm`` tree has the reference's keys and shapes:
    gemma2's pair layout with post-norms and no ``lm_head`` (tied)."""
    jcfg, tcfg, jp, _ = smoke_setup(False, arch)
    mine = init_lm(tcfg, seed=0, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    if arch == "gemma2-9b":
        L2 = tcfg.n_layers // 2
        assert sorted(mine["layers"]) == ["global", "local"]
        assert "lm_head" not in mine
        for g in ("local", "global"):
            lp = mine["layers"][g]
            assert lp["post_ln1"].shape == lp["post_ln2"].shape \
                == (L2, tcfg.d_model)
            assert lp["mlp"]["wi"].shape == (L2, tcfg.d_model,
                                             2 * tcfg.d_ff)


@SPARSE
def test_bridge_carries_the_pair_tree(sparse):
    """The reference's gemma2 pair tree, dense and n:m:g, crosses the
    bridge leaf for leaf."""
    _, _, jp, tp = smoke_setup(sparse, "gemma2-9b")
    for g in ("local", "global"):
        jl, tl = jp["layers"][g], tp["layers"][g]
        for name in ("ln1", "ln2", "post_ln1", "post_ln2"):
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))
        for path in (("attn", "wq"), ("attn", "wo"), ("mlp", "wi"),
                     ("mlp", "wo")):
            jw, tw = jl[path[0]][path[1]], tl[path[0]][path[1]]
            if not sparse:
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
                continue
            assert isinstance(tw, GroupedNMTensor)
            assert tw.dense_shape == tuple(jw.dense_shape)
            np.testing.assert_array_equal(tw.val.numpy(),
                                          np.asarray(jw.val))
            np.testing.assert_array_equal(tw.blk_idx.numpy(),
                                          np.asarray(jw.blk_idx))


@ARCH
def test_sparsify_for_serving_converts_every_group(arch):
    """The serving globs (``*mlp.wi``, ``*attn.wq``, ...) match the pair
    layout's ``layers.local.*`` and ``layers.global.*``; the norms and the
    embedding stay dense, and each n:m:g leaf densifies to a pruning of
    its dense weight."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = init_lm(cfg, seed=1, device="cpu")
    sp = sparsify_for_serving(params, 1, 4, 8, gr=16, attn=True)
    groups = ("local", "global") if arch == "gemma2-9b" else (None,)
    for g in groups:
        lp = sp["layers"] if g is None else sp["layers"][g]
        dp = params["layers"] if g is None else params["layers"][g]
        for part, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                           ("attn", "wo"), ("mlp", "wi"), ("mlp", "wo")):
            w = lp[part][name]
            assert isinstance(w, GroupedNMTensor), (g, part, name)
            dense = torch.stack([w.layer(i).to_dense()
                                 for i in range(w.val.shape[0])])
            kept = dense != 0
            assert torch.equal(dense[kept], dp[part][name][kept])
            assert kept.float().mean() <= 0.25 + 1e-6
        assert isinstance(lp["ln1"], torch.Tensor)
    assert isinstance(sp["embedding"], torch.Tensor)


def _seeded_cache(cfg, seed, rows=28):
    """A seeded nested cache of ``SLOTS + 1`` slots (every row nonzero, so
    rows a write misses are compared too), numpy."""
    rng = np.random.default_rng(seed)
    like = init_cache(cfg, SLOTS + 1, rows, device="cpu")
    return map_cache(lambda t: rng.standard_normal(tuple(t.shape))
                     .astype(np.float32), like)


def _torch(cache):
    return map_cache(lambda a: torch.from_numpy(a.copy()), cache)


@SPARSE
def test_decode_chunk_program_wraps_the_ring(sparse):
    """The engine's 8-step chunk program (a ``DecodeGraph``, eager on the
    CPU) on a seeded pair cache, slots at positions 12, 3 and 19: slot 0
    crosses the 16-row ring's end inside the chunk.  Tokens equal the
    reference's jitted chunk; every cache leaf allclose."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, "gemma2-9b")
    cache = _seeded_cache(tcfg, 3)
    tok = np.array([7, 11, 13], np.int32)
    pos = np.array([12, 3, 19], np.int32)
    want, jc = j_decode_chunk(jcfg, 8)(jp, jnp.asarray(tok[:, None]),
                                       _jnp_tree(cache), jnp.asarray(pos))
    tc = _torch(cache)
    ptrs = [t.data_ptr() for t in cache_leaves(tc)]
    g = DecodeGraph(_decode_chunk_fn(tcfg, 8), tp, tc, SLOTS + 1)
    got = g.run(tok, pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_cache_close(tc, jc)
    assert [t.data_ptr() for t in cache_leaves(tc)] == ptrs


@pytest.mark.parametrize("S,offset", [(20, 0), (9, 10), (6, 20)],
                         ids=["wrap_at_admission", "wrap_by_offset",
                              "wrap_global"])
@SPARSE
def test_admission_program_equals_reference(sparse, S, offset):
    """The admission program (a ``PrefillGraph``, eager on the CPU) on a
    seeded pair cache into slot 2 at a write offset, against the
    reference's jitted slot prefill: logits and every leaf (the rows the
    prompt missed stay as they were)."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse, "gemma2-9b")
    cache = _seeded_cache(tcfg, 4)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (1, S),
                                             dtype=np.int32)
    want, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(toks), _jnp_tree(cache),
                                    jnp.int32(2), jnp.int32(offset))
    tc = _torch(cache)
    got = PrefillGraph(_slot_prefill_fn(tcfg), tp, tc, S).run(toks, 2,
                                                              offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("op", ["reset", "compact"])
def test_reset_and_compact_walk_the_pair_cache(op):
    _, cfg, _, _ = smoke_setup(False, "gemma2-9b")
    cache = _seeded_cache(cfg, 8)
    kv = SlotKVCache(cfg, SLOTS + 1, 28, device="cpu")
    map_cache(lambda d, s: d.copy_(torch.from_numpy(s)), kv.data, cache)
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
def test_serve_programs_on_the_pair_layout(sparse):
    jcfg, tcfg, jp, tp = smoke_setup(sparse, "gemma2-9b")
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
    reference engine.  At gemma2 the local rings hold 16 rows."""
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


def test_ring_prefill_fault_of_the_reference():
    """ROADMAP C10.  gemma2 SMOKE (window 16), a 20-token prompt into a
    32-row cache, then one decode step, against the last logits of the
    reference's own forward over the 21 tokens: the reference's classic
    prefill is off by more than 1 (it puts the ring's tail at row 0, the
    decode step reads row p % 16); its slot mode and both of the port's
    modes agree within TOL."""
    jcfg, tcfg, jp, tp = smoke_setup(False, "gemma2-9b")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (1, 21),
                                              dtype=np.int32)
    prompt, nxt = toks[:, :20], toks[:, 20:]
    hidden, _ = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    full = np.asarray(j_logits_of(jp, jcfg, hidden[:, -1:])[:, 0])
    j_dec = jax.jit(j_decode, static_argnums=(1,))

    _, jc = jax.jit(j_prefill, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(prompt), 32)
    classic, _ = j_dec(jp, jcfg, jnp.asarray(nxt), jc, jnp.int32(20))
    assert np.abs(np.asarray(classic) - full).max() > 1.0

    _, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(prompt),
                                 j_init_cache(jcfg, 1, 32), jnp.int32(0),
                                 jnp.int32(0))
    slot, _ = j_dec(jp, jcfg, jnp.asarray(nxt), jc, jnp.int32(20))
    np.testing.assert_allclose(np.asarray(slot), full, **TOL)

    _, tc = prefill(tp, tcfg, torch.from_numpy(prompt), cache_len=32)
    got, _ = decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                         torch.tensor(20))
    np.testing.assert_allclose(got.numpy(), full, **TOL)
    tc = init_cache(tcfg, 1, 32, device="cpu")
    prefill_into_slot(tp, tcfg, torch.from_numpy(prompt), tc, 0)
    got, _ = decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                         torch.tensor(20))
    np.testing.assert_allclose(got.numpy(), full, **TOL)


@pytest.mark.parametrize("arch", ARCHES + ["bert-base-sten", "qwen1.5-4b"])
def test_init_lm_draws_per_layer_deterministically(arch):
    """Every leaf has its config's shape and dtype, each stacked layer is
    drawn anew (no two layers equal), and the same seed gives the same
    values, another seed others."""
    cfg = get_smoke(arch)
    a = init_lm(cfg, seed=4, device="cpu")
    b = init_lm(cfg, seed=4, device="cpu")
    c = init_lm(cfg, seed=5, device="cpu")
    la, lb, lc = (cache_leaves(t) for t in (a, b, c))
    assert len(la) == len(lb) == len(lc)
    assert _shapes(a) == _shapes(smoke_setup(False, arch)[2])
    for x, y, z in zip(la, lb, lc):
        assert x.dtype == cfg.tdtype and torch.equal(x, y)
        if x.ndim == 3:
            assert not torch.equal(x, z)
            assert not torch.equal(x[0], x[1])
    wi = (a["layers"]["local"] if cfg.layer_pattern == "alt_local_global"
          else a["layers"])["mlp"]["wi"].float()
    # per-layer fan-in scale: std 1/sqrt(d_model) times the truncated
    # normal's 0.88, within sampling error
    std = wi.std().item() * cfg.d_model ** 0.5
    assert 0.8 < std < 0.96 and wi.abs().max() <= 2 / cfg.d_model ** 0.5


@ARCH
def test_configs_are_the_reference_s(arch):
    """CONFIG and SMOKE equal the reference's field for field, and the
    port runs both."""
    from repro.configs import get_arch as j_config, get_smoke as j_smoke

    for mine, ref in ((get_config(arch), j_config(arch)),
                      (get_smoke(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.check_ported() is mine


@ARCH
def test_serve_cli_runs_the_new_architectures(arch, capsys):
    assert launch.main(["--arch", arch, "--smoke", "--engine", "--sparse",
                        "--nm", "1:4:8", "--device", "cpu", "--requests",
                        "3", "--prompt-len", "20", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out

