"""The port's enc-dec path (whisper-large-v3: an encoder of non-causal
layers over precomputed frame embeddings, cross-attention behind its own
norm in every decoder layer, the cross K/V cache leaves ``xk`` / ``xv``)
against the JAX package's, at its SMOKE config in f32 with 16 frames,
dense and n:m:g 1:4:8 gr16 ``attn=True`` (which converts the encoder's
projections and the decoder's ``xattn.*`` too), the reference's params
carried over by the bridge:

- the configs, the param tree, the 16 converted leaves and the bridge;
- ``forward(enc_embeds=)`` hidden states and ``loss_fn``;
- classic ``prefill(cache_len=, enc_embeds=)`` then 8 decode steps, and
  ``prefill_into_slot(enc_embeds=)`` into a seeded ``SlotKVCache(
  enc_len=)`` at slot 1 with a write offset then 8 decode steps: logits
  and every cache leaf (the cross K/V are written whole, the offset does
  not touch them);
- the engine's decode chunk program over a seeded cache with cross K/V,
  ``reset`` / ``compact`` on them;
- the refusals: no frames, a frame-length mismatch, ``write_prefill``,
  ``ServeEngine`` and the serve CLI, ``check_ported`` beside other
  families; and the reference's cacheless decode, which drops
  cross-attention silently where the port raises (ROADMAP C12).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import GroupedNMTensor as JGroupedNM
from repro.models import decode_step as j_decode, forward as j_forward, \
    logits_of as j_logits_of, loss_fn as j_loss_fn, prefill as j_prefill, \
    prefill_into_slot as j_prefill_into_slot
from repro.serve.cache import gather_slots as j_gather_slots, \
    reset_slot as j_reset_slot
from repro.serve.engine import _jit_decode_chunk as j_decode_chunk
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.launch import serve as launch
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    logits_of, loss_fn, prefill, prefill_into_slot
from repro_torch.models.common import MLAConfig, MoEConfig, SSMConfig
from repro_torch.models.transformer import _seq_leaf_kinds, cache_leaves, \
    map_cache
from repro_torch.serve import ServeEngine, SlotKVCache, sparsify_for_serving
from repro_torch.serve.engine import _decode_chunk_fn
from repro_torch.serve.graphs import DecodeGraph

from tests._torch_compat import smoke_setup
from tests.test_torch_families import _assert_cache_close, _jnp_tree, \
    _shapes, _sorted_leaves

# f32 in both packages; outputs differ by summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"
ENC = 16
SPARSE = pytest.mark.parametrize("sparse", [False, True],
                                 ids=["dense", "nmg"])
#: the 16 leaf kinds ``sparsify_for_serving(attn=True)`` converts, named
#: as the reference names them
CONVERTED = sorted(f"{stack}.{part}.{w}"
                   for stack, parts in (("enc_layers", ("attn",)),
                                        ("layers", ("attn", "xattn")))
                   for part in parts for w in ("wq", "wk", "wv", "wo")) \
    + sorted(f"{stack}.mlp.{w}" for stack in ("enc_layers", "layers")
             for w in ("wi", "wo"))


def _setup(sparse):
    return smoke_setup(sparse, ARCH)


def _frames(B, seed, F=ENC):
    return np.random.default_rng(seed).standard_normal(
        (B, F, get_smoke(ARCH).d_model)).astype(np.float32)


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(
        0, get_smoke(ARCH).vocab, shape, dtype=np.int32)


def _paths(tree, cls, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, cls, f"{prefix}{k}.")]
    return [prefix[:-1]] if isinstance(tree, cls) else []


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """The reference's functions under one jit each (the config static)."""
    fns = {
        "forward": lambda p, c, t, e: j_forward(p, c, t, enc_embeds=e,
                                                remat="none")[0],
        "loss": lambda p, c, b: j_loss_fn(p, c, b, remat="none")[0],
        "prefill": lambda p, c, t, e, n: j_prefill(p, c, t, cache_len=n,
                                                   enc_embeds=e),
        "slot_prefill": lambda p, c, t, cache, s, o, e: j_prefill_into_slot(
            p, c, t, cache, s, write_offset=o, enc_embeds=e),
        "decode": j_decode,
    }
    static = {"prefill": (1, 4)}.get(name, (1,))
    return jax.jit(fns[name], static_argnums=static)


# ---------------------------------------------------------------------------
# configs, params, conversion
# ---------------------------------------------------------------------------


def test_configs_are_the_reference_s():
    """CONFIG, SMOKE, ENC_LEN and FAMILY equal the reference's, and the
    port runs both configs."""
    from repro.configs import get_arch as j_config, get_smoke as j_smoke
    from repro.configs import whisper_large_v3 as jw
    from repro_torch.configs import whisper_large_v3 as tw

    for mine, ref in ((get_config(ARCH), j_config(ARCH)),
                      (get_smoke(ARCH), j_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.check_ported() is mine
    assert (tw.ENC_LEN, tw.FAMILY) == (jw.ENC_LEN, jw.FAMILY) == (1500,
                                                                   "audio")


def test_param_tree_equals_reference():
    """The port's ``init_lm`` tree has the reference's keys, shapes and
    dtypes: ``enc_layers`` (no ``xattn``) and ``enc_norm`` beside the
    decoder's ``layers``, which hold ``xattn`` and ``lnx``."""
    _, tcfg, jp, _ = _setup(False)
    mine = init_lm(tcfg, seed=0, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    assert "xattn" in mine["layers"] and "lnx" in mine["layers"]
    assert "xattn" not in mine["enc_layers"]
    assert mine["enc_norm"].shape == (tcfg.d_model,)
    assert all(t.dtype == torch.float32 for t in cache_leaves(mine))
    # the encoder's layers are drawn anew, not a copy of the decoder's
    assert not torch.equal(mine["enc_layers"]["attn"]["wq"],
                           mine["layers"]["attn"]["wq"])


def test_sparsify_for_serving_converts_the_reference_s_leaves():
    """``attn=True`` converts the same 16 leaf kinds as the reference's
    (``*attn.wq`` matches ``layers.xattn.wq`` under fnmatch); the norms
    and the embedding stay dense."""
    _, tcfg, jp_sparse, _ = _setup(True)
    mine = sparsify_for_serving(init_lm(tcfg, seed=1, device="cpu"), 1, 4,
                                8, gr=16, attn=True)
    got = sorted(_paths(mine, GroupedNMTensor))
    assert got == sorted(_paths(jp_sparse, JGroupedNM)) == sorted(CONVERTED)
    assert len(got) == 16
    assert isinstance(mine["layers"]["lnx"], torch.Tensor)


@SPARSE
def test_bridge_carries_the_enc_dec_tree(sparse):
    """The reference's tree, dense and n:m:g, crosses the bridge leaf for
    leaf, bitwise: each n:m:g leaf's values and block indices, each dense
    leaf whole."""
    _, _, jp, tp = _setup(sparse)
    carried = 0

    def walk(j, t):
        nonlocal carried
        if isinstance(j, dict):
            assert sorted(j) == sorted(t)
            for k in j:
                walk(j[k], t[k])
        elif isinstance(j, JGroupedNM):
            assert isinstance(t, GroupedNMTensor)
            assert t.dense_shape == tuple(j.dense_shape)
            np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
            np.testing.assert_array_equal(t.blk_idx.numpy(),
                                          np.asarray(j.blk_idx))
            carried += 1
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    walk(jp, tp)
    assert carried == (16 if sparse else 0)


# ---------------------------------------------------------------------------
# forward, loss, prefill and decode against the reference
# ---------------------------------------------------------------------------


@SPARSE
def test_forward_and_loss_match_reference(sparse):
    """Hidden states and logits of ``forward(enc_embeds=)``, and
    ``loss_fn`` with the frames in the batch (labels with a masked
    position)."""
    jcfg, tcfg, jp, tp = _setup(sparse)
    toks, frames = _toks((2, 12), 5), _frames(2, 6)
    want = _jitted("forward")(jp, jcfg, jnp.asarray(toks),
                              jnp.asarray(frames))
    got = forward(tp, tcfg, torch.from_numpy(toks),
                  enc_embeds=torch.from_numpy(frames))
    assert got.shape == (2, 12, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        logits_of(tp, tcfg, got).numpy(),
        np.asarray(j_logits_of(jp, jcfg, want)), **TOL)
    labels = _toks((2, 12), 7)
    labels[0, 3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "enc_embeds": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "enc_embeds": torch.from_numpy(frames)}
    loss, parts = loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(loss.item(),
                               float(_jitted("loss")(jp, jcfg, jb)), **TOL)
    assert parts["moe_aux"].item() == 0.0


def _decode_against_reference(jcfg, tcfg, jp, tp, jc, tc, tok, pos,
                              steps=8):
    """``steps`` greedy decode steps of both packages from ``tok`` [B, 1]
    at positions ``pos`` [B]: logits and tokens each step; returns the
    reference's cache."""
    for _ in range(steps):
        jl, jc = _jitted("decode")(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.asarray(pos))
        tl, _ = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok, pos = want[:, None].astype(np.int32), pos + 1
    return jc


@SPARSE
def test_classic_prefill_and_decode_match_reference(sparse):
    """Classic prefill of a batch of 2 (12 tokens each, its own frames)
    into a fresh 24-row cache, then 8 decode steps: logits, tokens and
    every cache leaf, ``xk`` / ``xv`` [L, 2, 16, KV, hd] included."""
    jcfg, tcfg, jp, tp = _setup(sparse)
    toks, frames = _toks((2, 12), 8), _frames(2, 9)
    jl, jc = _jitted("prefill")(jp, jcfg, jnp.asarray(toks),
                                jnp.asarray(frames), 24)
    tl, tc = prefill(tp, tcfg, torch.from_numpy(toks), cache_len=24,
                     enc_embeds=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == ["k", "v", "xk", "xv"]
    assert tc["xk"].shape == (tcfg.n_layers, 2, ENC, tcfg.n_kv_heads,
                              tcfg.hd)
    _assert_cache_close(tc, jc)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jc = _decode_against_reference(jcfg, tcfg, jp, tp, jc, tc, tok,
                                   np.array([12, 12], np.int32))
    _assert_cache_close(tc, jc)


def _seeded_cache(cfg, slots, rows, seed):
    """A seeded cache with cross K/V (every row nonzero, so rows a write
    misses are compared too), numpy."""
    rng = np.random.default_rng(seed)
    like = init_cache(cfg, slots, rows, enc_len=ENC, device="cpu")
    return map_cache(lambda t: rng.standard_normal(tuple(t.shape))
                     .astype(np.float32), like)


@SPARSE
def test_slot_prefill_and_decode_match_reference(sparse):
    """A 10-token request and its frames into slot 1 of a seeded
    3-slot ``SlotKVCache(enc_len=16)`` at write offset 6, then 8 decode
    steps of every slot: logits, tokens and every leaf against the
    reference's ``prefill_into_slot(enc_embeds=)``.  The slot's ``xk`` /
    ``xv`` equal a classic prefill's of the same request (written whole:
    the offset does not touch them); the other slots' keep their seeded
    values."""
    jcfg, tcfg, jp, tp = _setup(sparse)
    seeded = _seeded_cache(tcfg, 3, 28, 11)
    kv = SlotKVCache(tcfg, 3, 28, enc_len=ENC, device="cpu")
    map_cache(lambda d, s: d.copy_(torch.from_numpy(s)), kv.data, seeded)
    ptrs = [t.data_ptr() for t in cache_leaves(kv.data)]
    toks, frames = _toks((1, 10), 12), _frames(1, 13)
    jl, jc = _jitted("slot_prefill")(
        jp, jcfg, jnp.asarray(toks), _jnp_tree(seeded), jnp.int32(1),
        jnp.int32(6), jnp.asarray(frames))
    tl, _ = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), kv.data, 1,
                              write_offset=6,
                              enc_embeds=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(kv.data, jc)
    assert [t.data_ptr() for t in cache_leaves(kv.data)] == ptrs
    _, classic = prefill(tp, tcfg, torch.from_numpy(toks), cache_len=10,
                         enc_embeds=torch.from_numpy(frames))
    for name in ("xk", "xv"):
        assert torch.equal(kv.data[name][:, 1], classic[name][:, 0])
        for s in (0, 2):
            np.testing.assert_array_equal(kv.data[name][:, s].numpy(),
                                          seeded[name][:, s])
    tok = np.array([[3], [int(np.argmax(np.asarray(jl)[0]))], [5]],
                   np.int32)
    jc = _decode_against_reference(jcfg, tcfg, jp, tp, jc, kv.data, tok,
                                   np.array([4, 16, 9], np.int32))
    _assert_cache_close(kv.data, jc)


@SPARSE
def test_decode_chunk_program_reads_cross_kv(sparse):
    """The engine's 4-step chunk program (a ``DecodeGraph``, eager on the
    CPU) over a seeded cache with cross K/V, slots at positions 5, 12 and
    20: tokens equal the reference's jitted chunk, every leaf allclose;
    the storage is the same and ``xk`` / ``xv`` are only read."""
    jcfg, tcfg, jp, tp = _setup(sparse)
    cache = _seeded_cache(tcfg, 3, 28, 14)
    tok = np.array([7, 11, 13], np.int32)
    pos = np.array([5, 12, 20], np.int32)
    want, jc = j_decode_chunk(jcfg, 4)(jp, jnp.asarray(tok[:, None]),
                                       _jnp_tree(cache), jnp.asarray(pos))
    tc = map_cache(lambda a: torch.from_numpy(a.copy()), cache)
    ptrs = [t.data_ptr() for t in cache_leaves(tc)]
    got = DecodeGraph(_decode_chunk_fn(tcfg, 4), tp, tc, 3).run(tok, pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_cache_close(tc, jc)
    assert [t.data_ptr() for t in cache_leaves(tc)] == ptrs
    for name in ("xk", "xv"):
        np.testing.assert_array_equal(tc[name].numpy(), cache[name])


@pytest.mark.parametrize("op", ["reset", "compact"])
def test_reset_and_compact_walk_cross_kv(op):
    """``reset`` zeroes and ``compact`` permutes the slot axis (axis 1)
    of every leaf, ``xk`` / ``xv`` included, in place, bitwise as the
    reference's ``reset_slot`` / ``gather_slots``."""
    _, cfg, _, _ = _setup(False)
    cache = _seeded_cache(cfg, 3, 20, 15)
    kv = SlotKVCache(cfg, 3, 20, enc_len=ENC, device="cpu")
    map_cache(lambda d, s: d.copy_(torch.from_numpy(s)), kv.data, cache)
    ptrs = [t.data_ptr() for t in cache_leaves(kv.data)]
    if op == "reset":
        kv.reset(1)
        want = j_reset_slot(_jnp_tree(cache), jnp.int32(1))
        assert not kv.data["xk"][:, 1].any()
    else:
        kv.compact([2, 0, 1])
        want = j_gather_slots(_jnp_tree(cache),
                              jnp.asarray([2, 0, 1], jnp.int32))
        np.testing.assert_array_equal(kv.data["xv"][:, 0].numpy(),
                                      cache["xv"][:, 2])
    assert [t.data_ptr() for t in cache_leaves(kv.data)] == ptrs
    w = jax.tree_util.tree_leaves(want)
    assert len(w) == 4
    for a, b in zip(_sorted_leaves(kv.data), w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_seq_leaf_kinds_key_on_enc_len():
    """The kinds tree is keyed by (config, enc_len): with frames the cross
    K/V are state leaves, without them there are none."""
    cfg = get_smoke(ARCH)
    assert _seq_leaf_kinds(cfg, ENC) == {"k": True, "v": True, "xk": False,
                                         "xv": False}
    assert _seq_leaf_kinds(cfg) == {"k": True, "v": True}


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


def _refuse(case):
    _, cfg, _, params = _setup(False)
    toks = torch.from_numpy(_toks((1, 6), 20))
    frames = torch.from_numpy(_frames(1, 21))
    if case == "forward_without_frames":
        forward(params, cfg, toks)
    elif case == "loss_without_frames":
        loss_fn(params, cfg, {"tokens": toks, "labels": toks})
    elif case == "prefill_without_frames":
        prefill(params, cfg, toks, cache_len=8)
    elif case == "slot_prefill_without_frames":
        prefill_into_slot(params, cfg, toks, init_cache(
            cfg, 2, 8, enc_len=ENC, device="cpu"), 0)
    elif case == "frame_length_mismatch":
        prefill_into_slot(params, cfg, toks, init_cache(
            cfg, 2, 8, enc_len=ENC, device="cpu"), 0,
            enc_embeds=torch.from_numpy(_frames(1, 21, F=12)))
    elif case == "slot_cache_without_cross_kv":
        prefill_into_slot(params, cfg, toks,
                          init_cache(cfg, 2, 8, device="cpu"), 0,
                          enc_embeds=frames)
    elif case == "write_prefill":
        SlotKVCache(cfg, 2, 8, enc_len=ENC, device="cpu").write_prefill(
            params, toks.numpy(), 0)
    elif case == "engine":
        ServeEngine(params, cfg, device="cpu")


@pytest.mark.parametrize("case,match", [
    ("forward_without_frames", "enc_embeds"),
    ("loss_without_frames", "enc_embeds"),
    ("prefill_without_frames", "enc_embeds"),
    ("slot_prefill_without_frames", "enc_embeds"),
    ("frame_length_mismatch", "length 12 .* enc_len 16"),
    ("slot_cache_without_cross_kv", "length 16 .* enc_len 0"),
    ("write_prefill", r"prefill_into_slot\(enc_embeds=\)"),
    ("engine", "enc-dec model and the engine takes no encoder inputs"),
])
def test_enc_dec_refusals(case, match):
    with pytest.raises(ValueError, match=match):
        _refuse(case)


def test_serve_cli_refuses_enc_dec(capsys):
    """``--arch whisper-large-v3`` exits non-zero, before any params are
    built, with the engine's message."""
    with pytest.raises(SystemExit) as exc:
        launch.main(["--arch", ARCH, "--smoke", "--engine", "--device",
                     "cpu"])
    assert exc.value.code != 0
    assert "engine takes no encoder inputs" in capsys.readouterr().err


@pytest.mark.parametrize("change,what", [
    # int8 KV is ported (tests/test_torch_kvcache.py); an unknown name not
    (dict(kv_cache_dtype="int4"), "kv_cache_dtype"),
    (dict(moe=MoEConfig(impl="shmap")), "shmap"),
    (dict(moe=MoEConfig(combine="scatter")), "scatter"),
    (dict(moe=MoEConfig()), "enc-dec with a MoE"),
    (dict(attn_type="mla", mla=MLAConfig()), "enc-dec with attn_type 'mla'"),
    (dict(attn_type="none", ssm=SSMConfig()),
     "enc-dec with attn_type 'none'"),
    (dict(attn_type="hybrid", ssm=SSMConfig(), layer_pattern="local",
          local_window=16), "enc-dec with attn_type 'hybrid'"),
    (dict(layer_pattern="alt_local_global", local_window=16),
     "enc-dec with layer_pattern 'alt_local_global'"),
    (dict(vision_prefix=4), "enc-dec with a vision prefix"),
], ids=["int8_kv", "shmap", "scatter", "moe", "mla", "ssm", "hybrid",
        "pairs", "prefix"])
def test_check_ported_boundary_at_whisper(change, what):
    """whisper's shape (GQA, global layers) is ported; every other enc-dec
    combination is refused by a name that says ``enc-dec``, and a KV
    cache dtype the port does not store (the ``int8_kv`` case: int8
    itself is ported) and the expert-parallel MoE strategies stay
    refused."""
    cfg = dataclasses.replace(get_smoke(ARCH), **change)
    with pytest.raises(NotImplementedError, match=what):
        cfg.check_ported()


def test_cacheless_cross_attention_fault_of_the_reference():
    """ROADMAP C12.  The reference's ``decode_step`` over a cache built
    without ``enc_len`` runs with no error and drops cross-attention
    (``"xk" in cache``): its logits differ from the same step over the
    cache with cross K/V by more than 0.1.  The port raises."""
    jcfg, tcfg, jp, tp = _setup(False)
    toks, frames = _toks((1, 10), 22), _frames(1, 23)
    jl, jc = _jitted("prefill")(jp, jcfg, jnp.asarray(toks),
                                jnp.asarray(frames), 16)
    tok_np = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    tok = jnp.asarray(tok_np)
    cacheless = {k: v for k, v in jc.items() if k not in ("xk", "xv")}
    with_x, _ = _jitted("decode")(jp, jcfg, tok, jc, jnp.int32(10))
    without, _ = jax.jit(j_decode, static_argnums=(1,))(
        jp, jcfg, tok, cacheless, jnp.int32(10))
    assert np.abs(np.asarray(with_x) - np.asarray(without)).max() > 0.1
    _, tc = prefill(tp, tcfg, torch.from_numpy(toks), cache_len=16,
                    enc_embeds=torch.from_numpy(frames))
    got, _ = decode_step(tp, tcfg, torch.from_numpy(tok_np), tc,
                         torch.tensor(10))
    np.testing.assert_allclose(got.numpy(), np.asarray(with_x), **TOL)
    with pytest.raises(ValueError, match="without cross K/V"):
        decode_step(tp, tcfg, torch.from_numpy(tok_np),
                    {k: v for k, v in tc.items() if k not in ("xk", "xv")},
                    torch.tensor(10))
