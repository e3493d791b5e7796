"""The port's int8 KV cache (``models/transformer.py``: ``KV_QUANT_SCALE``,
``_cache_dt``, ``_q_cache``, ``_dq_cache``, ``_to_cache_dtype``; the
``q_cache`` / ``dq_cache`` hooks of ``attention.decode_mla``) and
``init_cache(local_window_cache=False)`` against the JAX package's:

- the quantizer's codes bitwise the reference's under ``jax.jit``, in f32
  and bf16, on seeded normals, exact half steps ``(k + 0.5) / 24`` and
  values past +-127/24; the dequantized codes bitwise;
- ROADMAP C13: the reference's eager codes (a true division by the
  scale) differ from its jitted ones (XLA's product by 24) on such inputs;
- int8 decode teacher-forced at qwen1.5-4b and minicpm3-4b SMOKE against
  the reference's jitted int8 prefill and decode: cache codes within one
  code (where they differ, the reference's ``x * 24`` lies within 1e-3
  of a half step), logits within 1e-3 of its int8 decode and within its
  own 0.05 of its full forward (``tests/test_decode_consistency.py``);
- each cache leaf's dtype the reference's at gemma2, hymba and whisper
  SMOKE, and slot prefill of an int8 cache bitwise the classic prefill;
- ``check_ported`` admitting int8 and the float names, refusing others;
- gemma2's full-length local leaves (``local_window_cache=False``):
  slot prefill past the window and decode against the reference's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, forward as j_forward, \
    init_cache as j_init_cache, logits_of as j_logits_of, \
    prefill as j_prefill, prefill_into_slot as j_prefill_into_slot
from repro.models import transformer as jt
from repro_torch.configs import get_smoke
from repro_torch.models import decode_step, init_cache, prefill, \
    prefill_into_slot
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import cache_leaves

from tests._torch_compat import smoke_setup

TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype="float32", **kw):
    jcfg, tcfg, jp, tp = smoke_setup(False, arch)
    return (dataclasses.replace(jcfg, dtype=dtype, **kw),
            dataclasses.replace(tcfg, dtype=dtype, **kw), jp, tp)


def _inputs(n=200_000, seed=0):
    """Seeded normals x 3, every half step (k + 0.5) / 24 over the code
    range and past it, and values past +-127/24 (clamped)."""
    rng = np.random.default_rng(seed)
    half = (np.arange(-135, 135) + 0.5) / 24
    past = np.array([127 / 24, -127 / 24, 127.5 / 24, -127.5 / 24, 6.0,
                     -6.0, 10.0, -10.0, 1e4, -1e4])
    return np.concatenate([rng.standard_normal(n) * 3, half, past]
                          ).astype(np.float32)


def _q_jit(jcfg):
    return jax.jit(lambda x: jt._q_cache(x, jcfg))


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantizer_codes_equal_jitted_reference(dtype):
    """``_q_cache`` and ``_to_cache_dtype`` give the reference's jitted
    codes bitwise (its serving programs are all jitted); ``_dq_cache``
    reads every code back bitwise as the reference's does, rounded in the
    model dtype; a float cache stores by a plain cast and reads back
    without one."""
    jcfg, tcfg, _, _ = _cfgs("qwen1.5-4b", dtype, kv_cache_dtype="int8")
    jdt, tdt = DTYPES[dtype]
    x = _inputs()
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    want = np.asarray(_q_jit(jcfg)(xj))
    got = tt._q_cache(xt, tcfg)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    to_want = np.asarray(jax.jit(
        lambda a: jt._to_cache_dtype(a, jnp.int8))(xj))
    np.testing.assert_array_equal(
        tt._to_cache_dtype(xt, torch.int8).numpy(), to_want)
    assert want.min() == -127 and want.max() == 127
    codes = np.arange(-127, 128, dtype=np.int8)
    dq_want = np.asarray(jax.jit(lambda c: jt._dq_cache(c, jcfg))(
        jnp.asarray(codes)).astype(jnp.float32))
    dq = tt._dq_cache(torch.from_numpy(codes), tcfg)
    assert dq.dtype == tdt
    np.testing.assert_array_equal(dq.float().numpy(), dq_want)
    assert tt._dq_scale(tdt) == float(
        jnp.asarray(jt.KV_QUANT_SCALE, jdt).astype(jnp.float32))
    # a float cache: a plain cast in, nothing on the way out
    fcfg = dataclasses.replace(tcfg, kv_cache_dtype="float16")
    assert tt._q_cache(xt, fcfg).dtype == torch.float16
    assert tt._dq_cache(xt, fcfg) is xt


def test_reference_eager_codes_differ_from_jitted():
    """ROADMAP C13: the reference's ``_q_cache`` divides by
    ``KV_QUANT_SCALE``; run eagerly that is a true division, under
    ``jax.jit`` XLA computes ``x * 24``.  On these inputs the two give
    other codes somewhere (all at half steps), so the reference's classic
    prefill (eager) and its serving programs (jitted) disagree; the port
    computes ``x * 24`` everywhere, the jitted codes."""
    jcfg, tcfg, _, _ = _cfgs("qwen1.5-4b", kv_cache_dtype="int8")
    x = _inputs(n=2_000_000)
    xj = jnp.asarray(x)
    eager = np.asarray(jt._q_cache(xj, jcfg))
    jitted = np.asarray(_q_jit(jcfg)(xj))
    differ = np.flatnonzero(eager != jitted)
    assert differ.size > 0
    assert np.abs(eager[differ].astype(int) - jitted[differ]).max() == 1
    frac = (x[differ].astype(np.float64) * 24) % 1
    assert np.all(np.abs(frac - 0.5) < 1e-5), frac
    np.testing.assert_array_equal(
        tt._q_cache(torch.from_numpy(x), tcfg).numpy(), jitted)


# ---------------------------------------------------------------------------
# int8 decode against the reference
# ---------------------------------------------------------------------------

S_PRE, S_GEN, B = 16, 4, 2


def _record(into: list):
    """Patch the reference's ``_q_cache`` / ``_to_cache_dtype`` so a
    jitted program built while patched reports (at run time, in order)
    every tile it quantizes, in f32."""
    oq, ot = jt._q_cache, jt._to_cache_dtype

    def note(x):
        jax.debug.callback(lambda a: into.append(np.asarray(a, np.float32)),
                           x, ordered=True)

    def q(x, cfg):
        note(x)
        return oq(x, cfg)

    def to(x, dt):
        note(x)
        return ot(x, dt)

    jt._q_cache, jt._to_cache_dtype = q, to
    return oq, ot


@functools.lru_cache(maxsize=None)
def _reference_int8_run(arch):
    """The reference's int8 prefill (S_PRE tokens) and S_GEN teacher-forced
    decode steps, each jitted, with the f32 tiles it quantized laid out as
    its cache: (cache codes, pre-quantization values, step logits, the
    full forward's logits, tokens)."""
    jcfg, _, jp, _ = _cfgs(arch, kv_cache_dtype="int8")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, S_PRE + S_GEN), dtype=np.int32)
    rec: list = []
    saved = _record(rec)
    try:
        pre = jax.jit(lambda p, t: j_prefill(p, jcfg, t,
                                             cache_len=S_PRE + S_GEN))
        dec = jax.jit(lambda p, t, c, pos: j_decode(p, jcfg, t, c, pos))
        logits, cache = pre(jp, jnp.asarray(toks[:, :S_PRE]))
        steps = [np.asarray(logits)]
        for i in range(S_GEN):
            logits, cache = dec(jp, jnp.asarray(toks[:, S_PRE + i][:, None]),
                                cache, jnp.asarray(S_PRE + i))
            steps.append(np.asarray(logits))
        jax.effects_barrier()
    finally:
        jt._q_cache, jt._to_cache_dtype = saved
    names = sorted(cache)
    x = {k: np.zeros(cache[k].shape, np.float32) for k in names}
    # the prefill's tiles, one a leaf (sorted keys), then each step's: one
    # a leaf a layer, layer-major
    for k in names:
        x[k][:, :, :S_PRE] = rec.pop(0)
    L = jcfg.n_layers
    for i in range(S_GEN):
        for layer in range(L):
            for k in names:
                x[k][layer, :, S_PRE + i] = rec.pop(0).reshape(
                    x[k].shape[1:2] + x[k].shape[3:])
    assert not rec
    hidden, _ = j_forward(jp, dataclasses.replace(jcfg, kv_cache_dtype=None),
                          jnp.asarray(toks), remat="none")
    full = np.asarray(j_logits_of(jp, jcfg, hidden), np.float32)
    return ({k: np.asarray(cache[k]) for k in names}, x, steps, full, toks)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minicpm3-4b"])
def test_int8_decode_against_reference(arch):
    """Teacher-forced int8 decode (GQA K/V at qwen, MLA latents at
    minicpm3): the port's codes within one code of the reference's, a
    one-code difference only where the reference's ``x * 24`` lies within
    1e-3 of a half step (the two compute ``x`` in other orders); logits
    within 1e-3 of the reference's int8 steps and within the reference's
    own 0.05 of its full forward."""
    _, tcfg, _, tp = _cfgs(arch, kv_cache_dtype="int8")
    codes, x, steps, full, toks = _reference_int8_run(arch)
    tt_ = torch.from_numpy(toks)
    logits, cache = prefill(tp, tcfg, tt_[:, :S_PRE],
                            cache_len=S_PRE + S_GEN)
    got = [logits.numpy()]
    for i in range(S_GEN):
        logits, cache = decode_step(tp, tcfg, tt_[:, S_PRE + i][:, None],
                                    cache, torch.tensor(S_PRE + i))
        got.append(logits.numpy())
    assert sorted(cache) == sorted(codes)
    for k in codes:
        assert cache[k].dtype == torch.int8
        d = cache[k].numpy().astype(int) - codes[k]
        assert np.abs(d).max() <= 1, k
        frac = (x[k][d != 0].astype(np.float64) * 24) % 1
        assert np.all(np.abs(frac - 0.5) < 1e-3), (k, frac)
    for i, (g, w) in enumerate(zip(got, steps)):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3,
                                   err_msg=f"{arch} step {i}")
        np.testing.assert_allclose(g, full[:, S_PRE - 1 + i], rtol=0.05,
                                   atol=0.05, err_msg=f"{arch} step {i}")


# ---------------------------------------------------------------------------
# leaves, slot prefill, check_ported
# ---------------------------------------------------------------------------

ENC = 6


def _leaf_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _leaf_dtypes(v) for k, v in tree.items()}
    return str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ["gemma2-9b", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_int8_leaf_dtypes_and_slot_prefill(arch):
    """An int8 cache's leaves have the reference's dtypes (K/V int8; an
    SSM's state, whisper's cross K/V in their own dtypes), and slot
    prefill into an int8 cache is bitwise the classic prefill: both store
    through ``_to_cache_dtype``.  gemma2's prompt passes its window (the
    local ring wraps)."""
    jcfg, tcfg, _, tp = _cfgs(arch, kv_cache_dtype="int8")
    enc = ENC if tcfg.n_enc_layers else 0
    S_c = 24
    mine = init_cache(tcfg, 3, S_c, enc_len=enc, device="cpu")
    ref = jax.eval_shape(lambda: j_init_cache(jcfg, 3, S_c, enc_len=enc))
    assert _leaf_dtypes(mine) == _leaf_dtypes(ref)
    assert any(t.dtype == torch.int8 for t in cache_leaves(mine))
    rng = np.random.default_rng(9)
    S = tcfg.local_window + 4 if tcfg.local_window else 12
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (1, S),
                                         dtype=np.int32))
    kw = {}
    if enc:
        kw["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, enc, tcfg.d_model)).astype(np.float32))
    want_logits, classic = prefill(tp, tcfg, toks, cache_len=S_c, **kw)
    got_logits, _ = prefill_into_slot(tp, tcfg, toks, mine, 1, **kw)
    assert torch.equal(got_logits, want_logits)
    for a, b in zip(cache_leaves(mine), cache_leaves(classic)):
        assert a.dtype == b.dtype
        assert torch.equal(a[:, 1], b[:, 0])


@pytest.mark.parametrize("name", ["int8", "bfloat16", "float16",
                                  "float32"])
def test_check_ported_admits_int8_and_float_caches(name):
    """``check_ported`` admits ``kv_cache_dtype`` int8 and the float names
    torch has; the cache is stored in that dtype."""
    cfg = dataclasses.replace(get_smoke("qwen1.5-4b"), kv_cache_dtype=name)
    assert cfg.check_ported() is cfg
    c = init_cache(cfg, 1, 4, device="cpu")
    assert c["k"].dtype == c["v"].dtype == tt._cache_dt(cfg)
    assert str(tt._cache_dt(cfg)) == f"torch.{name}"


def test_check_ported_refuses_an_unknown_cache_dtype():
    cfg = dataclasses.replace(get_smoke("qwen1.5-4b"), kv_cache_dtype="int4")
    with pytest.raises(NotImplementedError, match="kv_cache_dtype 'int4'"):
        cfg.check_ported()


# ---------------------------------------------------------------------------
# full-length local leaves (the paged pool's)
# ---------------------------------------------------------------------------


def test_full_length_local_cache_equals_reference():
    """gemma2 SMOKE with ``local_window_cache=False``: every local leaf is
    full length (the reference's shapes), and slot prefill of a prompt
    past the window into slot 1, then three decode steps, give the
    reference's logits and cache (the local layers attend over the last
    ``local_window`` rows of a full-length leaf)."""
    jcfg, tcfg, jp, tp = _cfgs("gemma2-9b")
    S_c = 40
    mine = init_cache(tcfg, 2, S_c, local_window_cache=False, device="cpu")
    ref = j_init_cache(jcfg, 2, S_c, local_window_cache=False)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert {g: {k: tuple(v.shape) for k, v in mine[g].items()}
            for g in mine} == shapes
    assert mine["local"]["k"].shape[2] == S_c > tcfg.local_window
    assert init_cache(tcfg, 2, S_c, device="cpu")["local"]["k"].shape[2] \
        == tcfg.local_window
    rng = np.random.default_rng(3)
    S = tcfg.local_window + 7
    toks = rng.integers(0, tcfg.vocab, (1, S), dtype=np.int32)
    jl, ref = jax.jit(lambda p, t, c: j_prefill_into_slot(
        p, jcfg, t, c, 1))(jp, jnp.asarray(toks), ref)
    tl, _ = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), mine, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    dec = jax.jit(lambda p, t, c, pos: j_decode(p, jcfg, t, c, pos))
    pos = np.array([0, S], np.int32)
    tok = rng.integers(0, tcfg.vocab, (2, 3), dtype=np.int32)
    for i in range(3):
        jl, ref = dec(jp, jnp.asarray(tok[:, i:i + 1]), ref,
                      jnp.asarray(pos + i))
        tl, mine = decode_step(tp, tcfg, torch.from_numpy(tok[:, i:i + 1]),
                               mine, torch.from_numpy(pos + i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for g in mine:
        for k in mine[g]:
            np.testing.assert_allclose(mine[g][k].numpy(),
                                       np.asarray(ref[g][k]), **TOL)
