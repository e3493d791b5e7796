"""The port's SSM path (``models/ssm.py``: mamba2-370m, every layer a
Mamba2 SSD mixer; hymba-1.5b, sliding-window GQA and the mixer side by
side in every layer, all layers local) against the JAX package's, at
their SMOKE configs in f32 (chunk 16), the reference's params carried
over by the bridge.  n:m:g 1:4:8 gr16: mamba2 through the reference's own
``SparsityBuilder`` on ``*ssm.in_proj`` / ``*ssm.out_proj`` (the serving
globs match no leaf of it), hymba through ``sparsify_for_serving(attn=
True)``:

- ``apply_ssm`` with its state and ``decode_ssm`` at S = 16, 20 and 40
  (one chunk, a padded chunk, three chunks), an ``in_proj`` whose rows
  pad to gr 64 among them;
- ``forward`` hidden states and logits;
- slot prefill then 8 decode steps: logits, tokens and every cache leaf
  (the ``ssm_state`` leaves too), hymba over a full-length cache longer
  than its window (the non-ring path, attending over the window) and over
  one no longer than it (a ring);
- the engine's programs on seeded caches (the decode chunk, admission
  with a write offset, which places K/V rows and leaves the state
  leaves whole), ``reset`` / ``compact``, ``serve_programs``, whole
  ``ServeEngine`` runs and the serve CLI;
- the param tree, the configs, ``check_ported``'s boundary, and the
  reference's short-prompt conv-state fault (ROADMAP C11), which the port
  refuses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.builder import SparsityBuilder as JBuilder
from repro.core.layouts import GroupedNMTensor as JGroupedNM
from repro.core.sparsifiers import GroupedNMSparsifier as JGroupedNMSp
from repro.models import decode_step as j_decode, forward as j_forward, \
    init_cache as j_init_cache, init_lm as j_init_lm, \
    logits_of as j_logits_of, prefill as j_prefill
from repro.models import ssm as j_ssm
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve.cache import _jit_slot_prefill as j_slot_prefill, \
    gather_slots as j_gather_slots, reset_slot as j_reset_slot
from repro.serve.engine import _jit_decode_chunk as j_decode_chunk, \
    serve_programs as j_serve_programs
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.builder import SparsityBuilder
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.core.sparsifiers import GroupedNMSparsifier
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch
from repro_torch.models import decode_step, forward, init_cache, init_lm, \
    logits_of, prefill, prefill_into_slot
from repro_torch.models import ssm
from repro_torch.models.common import SSMConfig
from repro_torch.models.transformer import _seq_leaf_kinds, cache_leaves, \
    layer_params, map_cache
from repro_torch.serve import Request, ServeEngine, sparsify_for_serving
from repro_torch.serve.cache import SlotKVCache, _slot_prefill_fn
from repro_torch.serve.engine import _decode_chunk_fn, serve_programs
from repro_torch.serve.graphs import DecodeGraph, PrefillGraph

from tests._torch_compat import params_to_numpy, smoke_setup
from tests.test_torch_families import _assert_cache_close, _jnp_tree, \
    _shapes, _sorted_leaves, _torch

# f32 in both packages; outputs differ by summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA, HYMBA = "mamba2-370m", "hymba-1.5b"
ARCHES = [MAMBA, HYMBA]
ARCH = pytest.mark.parametrize("arch", ARCHES)
SPARSE = pytest.mark.parametrize("sparse", [False, True],
                                 ids=["dense", "nmg"])
SLOTS = 2
#: mamba2 at 32 rows; hymba at 32 rows (longer than its window of 16: a
#: full-length local cache, attended over the window) and at 16 (a ring)
CACHES = pytest.mark.parametrize("arch,S_cache", [
    (MAMBA, 32), (HYMBA, 32), (HYMBA, 16)],
    ids=["mamba2", "hymba_window", "hymba_ring"])


@functools.lru_cache(maxsize=None)
def _setup(arch, sparse=False, gr=16):
    """(jax cfg, port cfg, jax params, port params) at f32 SMOKE; n:m:g
    for mamba2 through the reference's ``SparsityBuilder`` on the SSM
    projections (with group rows ``gr``), for hymba ``smoke_setup``'s
    ``sparsify_for_serving(attn=True)``."""
    if arch == HYMBA or not sparse:
        return smoke_setup(sparse, arch)
    jcfg, tcfg, jp, _ = smoke_setup(False, arch)
    sb = JBuilder()
    sp = JGroupedNMSp(1, 4, 8, gr, sparse_dim=0)
    sb.set_weight("*ssm.in_proj", sp, JGroupedNM)
    sb.set_weight("*ssm.out_proj", sp, JGroupedNM)
    jp = jax.jit(sb.sparsify_params)(jp)
    return jcfg, tcfg, jp, bridge.params_from_numpy(params_to_numpy(jp),
                                                    device="cpu")


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _assert_counts(arch, sparse, counts, what):
    """Dense runs launch no n:m:g kernel; n:m:g runs route their
    projections through the GEMV (decode) and, at hymba, the fused QKV
    and the fused FFN (its packed gated ``mlp.wi``)."""
    if not sparse:
        assert not any(k[0].startswith("nmg") for k in counts), what
        return
    assert counts[("nmg_linear", "gemv[default]")] > 0, what
    fused = (("nmg_qkv", "fused[default]") in counts,
             ("nmg_ffn", "fused[default]") in counts)
    assert fused == ((True, True) if arch == HYMBA else (False, False)), \
        (what, counts)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

#: (arch, n:m:g, group rows): mamba2 dense and n:m:g (gr16; gr64 pads
#: in_proj's 304 rows to 320), hymba's mixer dense
MIXERS = pytest.mark.parametrize("arch,sparse,gr", [
    (MAMBA, False, 16), (MAMBA, True, 16), (MAMBA, True, 64),
    (HYMBA, False, 16)], ids=["mamba2", "mamba2_nmg", "mamba2_nmg_gr64",
                              "hymba"])


def _layer0(jp, tp):
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["ssm"])
    return jl, layer_params(tp["layers"], 0)["ssm"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("S", [16, 20, 40], ids=["one_chunk",
                                                  "padded_chunk",
                                                  "three_chunks"])
@MIXERS
def test_apply_ssm_matches_reference(arch, sparse, gr, S):
    """Layer 0's mixer over x [2, S, D]: output and the decode state it
    hands over (``conv`` the last W - 1 pre-conv inputs, ``ssm`` [B, H, P,
    N]); padded steps leave the state as it is."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse, gr)
    jl, tl = _layer0(jp, tp)
    if sparse:
        assert isinstance(tl["in_proj"], GroupedNMTensor)
        assert tl["in_proj"].val.shape[0] % gr == 0
    x = _x(tcfg, 2, S, S)
    want, wst = jax.jit(lambda p, x: j_ssm.apply_ssm(
        p, x, jcfg, return_state=True))(jl, jnp.asarray(x))
    got, st = ssm.apply_ssm(tl, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(st) == sorted(wst) == ["conv", "ssm"]
    for k in st:
        assert tuple(st[k].shape) == wst[k].shape
        np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]), **TOL)
    got2, none = ssm.apply_ssm(tl, torch.from_numpy(x), tcfg)
    assert none is None and torch.equal(got2, got)


@MIXERS
def test_decode_ssm_matches_reference(arch, sparse, gr):
    """The recurrence from the state a 20-token prefill hands over, 4
    steps: each output and the state after it."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse, gr)
    jl, tl = _layer0(jp, tp)
    x = _x(tcfg, 2, 24, 7)
    _, wst = j_ssm.apply_ssm(jl, jnp.asarray(x[:, :20]), jcfg,
                             return_state=True)
    _, st = ssm.apply_ssm(tl, torch.from_numpy(x[:, :20]), tcfg,
                          return_state=True)
    j_dec = jax.jit(lambda p, x, s: j_ssm.decode_ssm(p, x, jcfg, s))
    for i in range(20, 24):
        want, wst = j_dec(jl, jnp.asarray(x[:, i:i + 1]), wst)
        got, st = ssm.decode_ssm(tl, torch.from_numpy(x[:, i:i + 1]), tcfg,
                                 st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]),
                                       **TOL)


def test_decode_continues_the_prefill():
    """The port alone: a prefill of S tokens then decode steps give the
    outputs of one prefill over all of them (the state handed over is the
    state the scan carries)."""
    _, tcfg, _, tp = _setup(MAMBA)
    tl = layer_params(tp["layers"], 0)["ssm"]
    x = torch.from_numpy(_x(tcfg, 2, 24, 9))
    full, _ = ssm.apply_ssm(tl, x, tcfg)
    _, st = ssm.apply_ssm(tl, x[:, :17], tcfg, return_state=True)
    for i in range(17, 24):
        y, st = ssm.decode_ssm(tl, x[:, i:i + 1], tcfg, st)
        torch.testing.assert_close(y[:, 0], full[:, i], **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [20, 40], ids=["padded_chunk", "three_chunks"])
@SPARSE
@ARCH
def test_forward_hidden_matches_reference(arch, sparse, S):
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    toks = _toks(jcfg, (2, S), 5)
    want, _ = j_forward(jp, jcfg, jnp.asarray(toks), remat="none")
    got = forward(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        logits_of(tp, tcfg, got).numpy(),
        np.asarray(j_logits_of(jp, jcfg, want)), **TOL)


@pytest.mark.parametrize("S", [4, 20], ids=["short", "padded_chunk"])
@SPARSE
@CACHES
def test_slot_prefill_and_decode_match_reference(arch, S_cache, sparse, S):
    """A prompt into slot 1 of a 2-slot cache, then 8 decode steps of both
    slots (slot 0 empty, at position 0): logits, greedy tokens and every
    cache leaf, ``ssm_state``'s ``conv`` and ``ssm`` among them.  hymba's
    32-row cache is longer than its window of 16 (writes at the position,
    attention over the last 16 rows); its 16-row cache is a ring (the
    20-token prompt wraps it at admission)."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
    toks = _toks(jcfg, (1, S), S)
    jl, jc = j_slot_prefill(jcfg)(
        jp, jnp.asarray(toks), j_init_cache(jcfg, SLOTS, S_cache),
        jnp.int32(1), jnp.int32(0))
    tc = init_cache(tcfg, SLOTS, S_cache, device="cpu")
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
    _assert_counts(arch, sparse, tops.kernel_counters(), (arch, S))


def test_local_decode_attends_over_the_window_only():
    """hymba at a full-length 40-row cache (window 16): 30 decode steps
    from a 4-token prompt against the reference, and a control: the same
    steps with the window taken off (every row attended) move the last
    logits past TOL, so the window is what the parity holds."""
    jcfg, tcfg, jp, tp = _setup(HYMBA)
    toks = _toks(jcfg, (1, 4), 11)
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    _, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(toks),
                                 j_init_cache(jcfg, 1, 40), jnp.int32(0),
                                 jnp.int32(0))
    caches = {}
    for name, c in (("port", tcfg),
                    ("no_window", dataclasses.replace(tcfg,
                                                      local_window=10 ** 6))):
        caches[name] = init_cache(c, 1, 40, device="cpu")
        prefill_into_slot(tp, tcfg, torch.from_numpy(toks), caches[name], 0)
    assert caches["port"]["k"].shape[2] == 40
    tok = np.array([[3]], np.int32)
    for i in range(30):
        pos = np.array([4 + i], np.int32)
        jl, jc = j_dec(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, _ = decode_step(tp, tcfg, torch.from_numpy(tok),
                             caches["port"], torch.from_numpy(pos))
        bad, _ = decode_step(tp, dataclasses.replace(tcfg,
                                                     local_window=10 ** 6),
                             torch.from_numpy(tok), caches["no_window"],
                             torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    assert np.abs(bad.numpy() - np.asarray(jl)).max() > 1e-2


def _seeded_cache(cfg, seed, rows=28):
    """A seeded cache of ``SLOTS + 1`` slots (every row and state entry
    nonzero, so what a write misses is compared too), numpy."""
    rng = np.random.default_rng(seed)
    like = init_cache(cfg, SLOTS + 1, rows, device="cpu")
    return map_cache(lambda t: rng.standard_normal(tuple(t.shape))
                     .astype(np.float32), like)


@SPARSE
@ARCH
def test_decode_chunk_program_equals_reference(arch, sparse):
    """The engine's 8-step chunk program (a ``DecodeGraph``, eager on the
    CPU) on a seeded cache, slots at positions 12, 3 and 19 (hymba's 28
    rows: slot 2 attends over its window only): tokens equal the
    reference's jitted chunk, every leaf (state leaves too) allclose and
    written in place."""
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


@pytest.mark.parametrize("offset", [0, 5])
@ARCH
def test_admission_program_equals_reference(arch, offset):
    """The admission program (a ``PrefillGraph``, eager on the CPU) of a
    12-token prompt into slot 2 of a seeded cache at a write offset,
    against the reference's jitted slot prefill: logits and every leaf.
    The state leaves are overwritten whole whatever the offset; K/V rows
    land from the offset, the others stay as they were."""
    jcfg, tcfg, jp, tp = _setup(arch)
    cache = _seeded_cache(tcfg, 4)
    toks = _toks(jcfg, (1, 12), 12)
    want, jc = j_slot_prefill(jcfg)(jp, jnp.asarray(toks), _jnp_tree(cache),
                                    jnp.int32(2), jnp.int32(offset))
    tc = _torch(cache)
    got = PrefillGraph(_slot_prefill_fn(tcfg), tp, tc, 12).run(toks, 2,
                                                               offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tc, jc)


@ARCH
def test_state_leaf_write_ignores_write_offset(arch):
    """The port alone: the same prompt admitted at offsets 0 and 7 leaves
    the same state leaves in its slot (and the other slots untouched),
    while K/V rows move by the offset."""
    _, tcfg, _, tp = _setup(arch)
    toks = torch.from_numpy(_toks(tcfg, (1, 12), 1))
    caches = []
    for off in (0, 7):
        c = _torch(_seeded_cache(tcfg, 6))
        prefill_into_slot(tp, tcfg, toks, c, torch.tensor(1),
                          write_offset=torch.tensor(off))
        caches.append(c)
    seed = _torch(_seeded_cache(tcfg, 6))
    for name in ("conv", "ssm"):
        a, b = (c["ssm_state"][name] for c in caches)
        assert torch.equal(a, b)
        assert torch.equal(a[:, [0, 2]], seed["ssm_state"][name][:, [0, 2]])
        assert not torch.equal(a[:, 1], seed["ssm_state"][name][:, 1])
    if arch == HYMBA:
        a, b = (c["k"][:, 1] for c in caches)
        assert torch.equal(a[:, :12], b[:, 7:19])


def test_seq_leaf_kinds_tell_state_leaves_apart():
    assert _seq_leaf_kinds(get_smoke(HYMBA)) == {
        "k": True, "v": True, "ssm_state": {"conv": False, "ssm": False}}
    assert _seq_leaf_kinds(get_smoke(MAMBA)) == {
        "ssm_state": {"conv": False, "ssm": False}}
    gemma = _seq_leaf_kinds(get_smoke("gemma2-9b"))
    assert gemma == {g: {"k": True, "v": True} for g in ("local", "global")}


@pytest.mark.parametrize("op", ["reset", "compact"])
@ARCH
def test_reset_and_compact_walk_the_state_leaves(arch, op):
    """``reset`` zeroes slot 1 of every leaf, ``compact`` permutes the
    slot axis (axis 1) of every leaf, ``conv`` and ``ssm`` included, in
    place, as the reference's ``reset_slot`` / ``gather_slots``."""
    _, cfg, _, _ = _setup(arch)
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
    st = kv.data["ssm_state"]
    if op == "reset":
        assert not st["conv"][:, 1].any() and not st["ssm"][:, 1].any()
    else:
        np.testing.assert_array_equal(st["ssm"][:, 0].numpy(),
                                      cache["ssm_state"]["ssm"][:, 2])
    for a, b in zip(_sorted_leaves(kv.data),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@ARCH
def test_serve_programs_equal_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
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
    reference engine (each admission overwrites its slot's state)."""
    jcfg, tcfg, jp, tp = _setup(arch, sparse)
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
    _assert_counts(arch, sparse, tops.kernel_counters(), arch)


def test_short_prompt_conv_state_fault_of_the_reference():
    """ROADMAP C11.  mamba2 SMOKE (conv width 4), a 2-token prompt then
    one decode step, against the last logits of the reference's own
    forward over the 3 tokens: the reference's classic prefill is off by
    more than 0.1 (it writes the 2-row conv tail at rows 0-1 of the
    3-row state, and decode reads the window right-aligned); its slot
    mode refuses the prompt (an assertion), and so do both of the port's
    modes, by a ValueError that names the rule.  At 3 tokens every mode
    agrees with the forward."""
    jcfg, tcfg, jp, tp = _setup(MAMBA)
    toks = _toks(jcfg, (1, 4), 10)
    j_dec = jax.jit(j_decode, static_argnums=(1,))
    for S in (2, 3):
        hidden, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, :S + 1]),
                              remat="none")
        full = np.asarray(j_logits_of(jp, jcfg, hidden[:, -1:])[:, 0])
        _, jc = jax.jit(j_prefill, static_argnums=(1, 3))(
            jp, jcfg, jnp.asarray(toks[:, :S]), 8)
        classic, _ = j_dec(jp, jcfg, jnp.asarray(toks[:, S:S + 1]), jc,
                           jnp.int32(S))
        err = np.abs(np.asarray(classic) - full).max()
        if S == 2:
            assert err > 0.1
            with pytest.raises(AssertionError):
                j_slot_prefill(jcfg)(jp, jnp.asarray(toks[:, :S]),
                                     j_init_cache(jcfg, 1, 8), jnp.int32(0),
                                     jnp.int32(0))
            with pytest.raises(ValueError, match="conv_width - 1"):
                prefill(tp, tcfg, torch.from_numpy(toks[:, :S]),
                        cache_len=8)
            with pytest.raises(ValueError, match="C11"):
                prefill_into_slot(tp, tcfg, torch.from_numpy(toks[:, :S]),
                                  init_cache(tcfg, 1, 8, device="cpu"), 0)
            continue
        assert err < 1e-4
        for mode in ("classic", "slot"):
            if mode == "classic":
                _, tc = prefill(tp, tcfg, torch.from_numpy(toks[:, :S]),
                                cache_len=8)
            else:
                tc = init_cache(tcfg, 1, 8, device="cpu")
                prefill_into_slot(tp, tcfg, torch.from_numpy(toks[:, :S]),
                                  tc, 0)
            got, _ = decode_step(tp, tcfg, torch.from_numpy(toks[:, S:]),
                                 tc, torch.tensor(S))
            np.testing.assert_allclose(got.numpy(), full, **TOL)


# ---------------------------------------------------------------------------
# params, configs, conversion, CLI
# ---------------------------------------------------------------------------


@ARCH
def test_param_tree_equals_reference(arch):
    """The port's ``init_lm`` tree has the reference's keys, shapes and
    dtypes: mamba2's layers ``{ln1, ln2, ssm}`` (no attention, no MLP),
    hymba's ``{ln1, ln2, attn, ssm, mlp}``; the mixer's ``a_log``,
    ``d_skip`` and ``dt_bias`` in f32."""
    cfg = get_smoke(arch)
    jcfg, _, _, _ = smoke_setup(False, arch)
    jp = jax.eval_shape(lambda: j_init_lm(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype=cfg.dtype)))
    mine = init_lm(cfg, seed=0, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    dt = jax.tree_util.tree_map(lambda a: str(a.dtype), jp)
    assert map_cache(lambda t: str(t.dtype).replace("torch.", ""),
                     mine) == dt
    want = {MAMBA: ["ln1", "ln2", "ssm"],
            HYMBA: ["attn", "ln1", "ln2", "mlp", "ssm"]}[arch]
    assert sorted(mine["layers"]) == want
    s = mine["layers"]["ssm"]
    assert (s["a_log"] == 0).all() and (s["d_skip"] == 1).all()
    assert (s["norm_w"] == 1).all() and not s["conv_b"].any()
    # std 0.5 truncated at +-2 sigma
    assert s["conv_w"].abs().max() <= 1.0 and 0.4 < s["conv_w"].float(
        ).std() < 0.5


@ARCH
def test_init_cache_layout_equals_reference(arch):
    """``init_cache``'s tree, shapes and dtypes are the reference's:
    hymba's K/V full length (all layers local, no ring leaf), the state
    leaves ``conv`` in the model dtype and ``ssm`` in f32."""
    cfg = get_smoke(arch)
    jcfg = dataclasses.replace(smoke_setup(False, arch)[0], dtype=cfg.dtype)
    want = jax.eval_shape(lambda: j_init_cache(jcfg, 3, 40))
    got = init_cache(cfg, 3, 40, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert map_cache(lambda t: str(t.dtype).replace("torch.", ""), got) \
        == jax.tree_util.tree_map(lambda a: str(a.dtype), want)
    assert got["ssm_state"]["ssm"].dtype == torch.float32
    if arch == HYMBA:
        assert got["k"].shape[2] == 40 > cfg.local_window


@ARCH
def test_configs_are_the_reference_s(arch):
    """CONFIG and SMOKE equal the reference's field for field (the typed
    ``SSMConfig`` included), and the port runs both."""
    from repro.configs import get_arch as j_config, get_smoke as j_smoke
    from repro.models.common import SSMConfig as JSSMConfig

    for mine, ref in ((get_config(arch), j_config(arch)),
                      (get_smoke(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert isinstance(mine.ssm, SSMConfig)
        assert mine.check_ported() is mine
    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(JSSMConfig())
    s, D = get_config(arch).ssm, get_config(arch).d_model
    assert (s.d_inner(D), s.num_heads(D)) == (
        JSSMConfig(**dataclasses.asdict(s)).d_inner(D),
        JSSMConfig(**dataclasses.asdict(s)).num_heads(D))


@pytest.mark.parametrize("change,what", [
    (dict(n_enc_layers=2), "enc-dec"),
    # int8 KV is ported (tests/test_torch_kvcache.py); an unknown name not
    (dict(kv_cache_dtype="int4"), "kv_cache_dtype"),
    (dict(ssm=None), "SSMConfig"),
    (dict(ssm=object()), "ssm"),
    (dict(local_window=None), "local_window"),
    (dict(attn_type="rnn"), "attn_type"),
])
def test_check_ported_boundary_at_hymba(change, what):
    """hymba (hybrid, all-local) is ported; an enc-dec variant or one with
    a KV cache dtype the port does not store (int8 is ported),
    a hybrid without a typed ``SSMConfig`` and an all-local pattern
    without its window are refused by name."""
    cfg = dataclasses.replace(get_smoke(HYMBA), **change)
    with pytest.raises(NotImplementedError, match=what):
        cfg.check_ported()


def test_whisper_is_ported_as_the_reference_s():
    """The next family after the SSMs, enc-dec: whisper's config is the
    reference's field for field, and the port runs it."""
    from repro.configs import get_arch as j_config

    cfg = get_config("whisper-large-v3")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_config("whisper-large-v3"))
    assert (cfg.n_enc_layers, cfg.attn_type, cfg.ssm) == (32, "gqa", None)
    assert cfg.check_ported() is cfg


def test_sparsify_for_serving_on_ssm_models():
    """The serving globs convert hymba's attention and MLP and none of its
    mixer, and nothing of mamba2 (its n:m:g path converts the mixer's
    projections through a ``SparsityBuilder`` plan of its own)."""
    _, mcfg, _, _ = _setup(MAMBA)
    mp = init_lm(mcfg, seed=1, device="cpu")
    ms = sparsify_for_serving(mp, 1, 4, 8, gr=16, attn=True)
    assert not any(isinstance(t, GroupedNMTensor)
                   for t in cache_leaves(ms))
    hp = init_lm(get_smoke(HYMBA), seed=1, device="cpu")
    hs = sparsify_for_serving(hp, 1, 4, 8, gr=16, attn=True)
    lay = hs["layers"]
    for part, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                       ("attn", "wo"), ("mlp", "wi"), ("mlp", "wo")):
        assert isinstance(lay[part][name], GroupedNMTensor), (part, name)
    assert all(isinstance(t, torch.Tensor) for t in lay["ssm"].values())
    sb = SparsityBuilder()
    sp = GroupedNMSparsifier(1, 4, 8, 64, sparse_dim=0)
    sb.set_weight("*ssm.in_proj", sp, GroupedNMTensor)
    sb.set_weight("*ssm.out_proj", sp, GroupedNMTensor)
    conv = sb.sparsify_params(mp)["layers"]["ssm"]
    w = conv["in_proj"]
    assert isinstance(w, GroupedNMTensor) and w.dense_shape == (64, 304)
    assert w.val.shape[1] == 320          # 304 rows padded to gr 64
    assert isinstance(conv["out_proj"], GroupedNMTensor)


@ARCH
def test_serve_cli_runs_the_ssm_architectures(arch, capsys):
    assert launch.main(["--arch", arch, "--smoke", "--engine", "--sparse",
                        "--nm", "1:4:8", "--device", "cpu", "--requests",
                        "3", "--prompt-len", "20", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
