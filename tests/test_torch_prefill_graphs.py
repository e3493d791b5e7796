"""The engine's admission programs (``serve/graphs.py:PrefillGraph``, one
per prompt length, the port's counterpart of the reference's
``_jit_slot_prefill``) and the slot-mode surface around them, on the CPU,
where a program runs eagerly into the same static buffers it replays on
the card:

- ``prefill_into_slot`` with ``write_offset`` (0, 3, and a ring wrap past
  the cache end) against the reference's jitted slot prefill, slot and
  offset given as ints and as 0-dim tensors (logits and cache within
  1e-4, the serve parity tolerance);
- the static-buffer program bitwise equal to eager ``prefill_into_slot``
  over two admissions of different prompts of one length into different
  slots;
- ``reset`` / ``compact`` equal to the reference's ``reset_slot`` /
  ``gather_slots``, the cache's storage kept;
- ``serve_programs``: the reference's keys, each program equal to the
  reference's on its example arguments;
- the trace events: one ``slot_prefill`` per distinct prompt length, none
  added by a second pass, and none for a prompt that is too long.

Replay itself runs on the card: ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.cache import _jit_slot_prefill as j_slot_prefill, \
    gather_slots as j_gather_slots, reset_slot as j_reset_slot
from repro.serve.engine import serve_programs as j_serve_programs
from repro_torch.models import prefill_into_slot
from repro_torch.serve import Request, SamplingParams, ServeEngine, \
    warmup_engine
from repro_torch.serve.cache import PromptTooLongError, SlotKVCache, \
    _slot_prefill_fn
from repro_torch.serve.engine import serve_programs
from repro_torch.serve.graphs import PrefillGraph
from repro_torch.serve.tracecount import reset_trace_events, trace_events

from tests._torch_compat import smoke_setup

TOL = dict(rtol=1e-4, atol=1e-4)
# bert dense, bert n:m:g 1:4:8 gr16 attn=True, qwen (gated MLP, seeded
# QKV biases) dense and n:m:g
SETUPS = [("bert-base-sten", False, None), ("bert-base-sten", True, None),
          ("qwen1.5-4b", False, 3), ("qwen1.5-4b", True, 3)]
SETUP_IDS = ["bert-dense", "bert-nmg", "qwen-dense", "qwen-nmg"]
B, S_CACHE = 3, 24
# (prompt length, write offset): at 0, at 3, and a ring wrap (20 + 9 > 24)
PLACEMENTS = [(7, 0), (7, 3), (9, 20)]


def _cache(cfg, seed=11):
    """A seeded cache [L, B, S_CACHE, KV, hd] (every row nonzero, so rows
    a write misses are compared too)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, S_CACHE, cfg.n_kv_heads, cfg.hd)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _torch_cache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def _prompt(cfg, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("S,offset", PLACEMENTS,
                         ids=["off0", "off3", "ring_wrap"])
@pytest.mark.parametrize("arch,sparse,bias_seed", SETUPS, ids=SETUP_IDS)
def test_prefill_into_slot_write_offset_equals_reference(
        arch, sparse, bias_seed, S, offset, as_tensor):
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch, bias_seed)
    cache = _cache(tcfg)
    toks = _prompt(tcfg, S)
    slot = 1
    want, jc = j_slot_prefill(jcfg)(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.int32(slot), jnp.int32(offset))
    tc = _torch_cache(cache)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    where = (torch.tensor(slot, dtype=torch.int32),
             torch.tensor(offset, dtype=torch.int32)) if as_tensor \
        else (slot, offset)
    got, out = prefill_into_slot(tp, tcfg, torch.from_numpy(toks), tc,
                                 where[0], write_offset=where[1])
    assert out is tc and {k: v.data_ptr() for k, v in tc.items()} == ptrs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
        # the rows the prompt missed are the seeded ones, exactly
        rows = (offset + np.arange(S)) % S_CACHE
        keep = np.setdiff1d(np.arange(S_CACHE), rows)
        np.testing.assert_array_equal(tc[k].numpy()[:, slot, keep],
                                      cache[k][:, slot, keep])


@pytest.mark.parametrize("arch,sparse,bias_seed", SETUPS, ids=SETUP_IDS)
def test_prefill_program_equals_eager_over_two_admissions(arch, sparse,
                                                          bias_seed):
    """Two prompts of one length through one program (slot 2 at offset 0,
    then slot 0 at offset 3): logits and cache bitwise equal to eager
    ``prefill_into_slot`` on a copy of the same cache."""
    _, cfg, _, tp = smoke_setup(sparse, arch, bias_seed)
    cache = _cache(cfg, seed=5)
    mine, ref = _torch_cache(cache), _torch_cache(cache)
    S = 9
    g = PrefillGraph(_slot_prefill_fn(cfg), tp, mine, S)
    assert not g.capture_on             # the CPU runs the program eagerly
    for turn, (slot, off) in enumerate(((2, 0), (0, 3))):
        toks = _prompt(cfg, S, seed=turn)
        got = g.run(toks, slot, off)
        want, _ = prefill_into_slot(tp, cfg, torch.from_numpy(toks), ref,
                                    slot, write_offset=off)
        assert got.shape == (1, cfg.vocab) and torch.equal(got, want), turn
        for k in ("k", "v"):
            assert torch.equal(mine[k], ref[k]), (turn, k)
    assert g.out is got


@pytest.mark.parametrize("op", ["reset", "compact"])
def test_reset_and_compact_equal_reference_in_place(op):
    _, cfg, _, _ = smoke_setup(False)
    cache = _cache(cfg, seed=8)
    kv = SlotKVCache(cfg, B, S_CACHE, device="cpu")
    for k, v in kv.data.items():
        v.copy_(torch.from_numpy(cache[k]))
    ptrs = {k: v.data_ptr() for k, v in kv.data.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    if op == "reset":
        kv.reset(1)
        want = j_reset_slot(jc, jnp.int32(1))
    else:
        kv.compact([2, 0, 1])
        want = j_gather_slots(jc, jnp.asarray([2, 0, 1], jnp.int32))
    assert {k: v.data_ptr() for k, v in kv.data.items()} == ptrs
    for k in ("k", "v"):
        np.testing.assert_array_equal(kv.data[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch,sparse,bias_seed", SETUPS, ids=SETUP_IDS)
def test_serve_programs_equal_reference(arch, sparse, bias_seed):
    jcfg, tcfg, jp, tp = smoke_setup(sparse, arch, bias_seed)
    kw = dict(max_slots=2, max_seq_len=16, decode_chunk=3, prompt_len=5)
    want = j_serve_programs(jp, jcfg, **kw)
    got = serve_programs(tp, tcfg, **kw)
    assert sorted(got) == sorted(want) == ["decode", "decode_chunk",
                                           "prefill"]
    for name, (fn, args) in got.items():
        jfn, jargs = want[name]
        assert len(args) == len(jargs)
        w_out, w_cache = jax.jit(jfn)(*jargs)
        out = fn(*args)
        if name == "prefill":
            out, cache = out
        else:                   # the cache, updated in place
            cache = args[2]
        if name == "decode_chunk":
            np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(w_out), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(w_cache[k]), **TOL)


def test_trace_events_one_slot_prefill_per_prompt_length():
    """A trace with prompt lengths 5, 9, 5, 12, 9 and one sampled request:
    warm-up builds one admission program per length and both decode
    programs (the single-step one for the sampled request); the measured
    run and a second pass build nothing new."""
    _, cfg, _, tp = smoke_setup(True)
    rng = np.random.default_rng(4)
    lens = (5, 9, 5, 12, 9)

    def trace():
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n,
                                                   dtype=np.int32),
                        max_new_tokens=4,
                        sampling=SamplingParams(greedy=i != 1,
                                                temperature=0.8, seed=i))
                for i, n in enumerate(lens)]

    reset_trace_events()
    eng = ServeEngine(tp, cfg, max_slots=2, max_seq_len=28, decode_chunk=3,
                      device="cpu")
    assert warmup_engine(eng, trace()) is eng
    built = trace_events()
    assert built == {"slot_prefill": 3, "decode_chunk": 1, "decode": 1}
    assert sorted(eng.kv.prefill_graphs) == [5, 9, 12]
    assert eng._outputs == [] and eng.stats["decode_steps"] == 0
    first = eng.run(trace())
    assert [len(o.tokens) for o in first] == [4] * len(lens)
    assert trace_events() == built
    eng.run(trace())
    assert trace_events() == built
    assert all(g.info["captured"] is False
               for g in eng.kv.prefill_graphs.values())


def test_prompt_too_long_raises_before_any_program_is_built():
    _, cfg, _, tp = smoke_setup(False)
    reset_trace_events()
    kv = SlotKVCache(cfg, 2, 8, device="cpu")
    with pytest.raises(PromptTooLongError):
        kv.write_prefill(tp, np.zeros((1, 9), np.int32), 0)
    assert kv.prefill_graphs == {} and trace_events() == {}
    kv.write_prefill(tp, np.zeros((1, 8), np.int32), 1)
    assert trace_events() == {"slot_prefill": 1}
