"""The engine's decode programs (``serve/graphs.py``, the port's
counterpart of the reference's jitted ``_jit_decode`` and
``_jit_decode_chunk``) on the CPU, where a :class:`DecodeGraph` runs its
program eagerly into the same static buffers it replays on the card:

- the chunk and one-step programs against the reference's jitted ones
  from the same bridged cache, tokens and positions (tokens equal, logits
  and cache within 1e-4, the serve parity tolerance);
- over two chunks with an admission between them, the static-buffer
  program bitwise equal to the eager ``decode_chunk``;
- the KV cache's storage kept through an engine's whole life;
- the launch counters' snapshot/delta helper, which replay uses;
- capture preparation refusing an n:m:g weight without its plan.

Replay itself runs on the card: ``tests/test_torch_cuda.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import _jit_decode as j_decode, \
    _jit_decode_chunk as j_decode_chunk
from repro_torch.kernels import nmg_gemv, ops as tops
from repro_torch.models import prefill_into_slot
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.serve.engine import _decode_chunk_fn, _decode_fn, \
    decode_chunk
from repro_torch.serve.graphs import DecodeGraph, check_capturable

from tests._torch_compat import smoke_setup

TOL = dict(rtol=1e-4, atol=1e-4)
# bert dense, bert n:m:g 1:4:8 gr16 attn=True, qwen (gated MLP, seeded
# QKV biases) dense and n:m:g
SETUPS = [("bert-base-sten", False, None), ("bert-base-sten", True, None),
          ("qwen1.5-4b", False, 3), ("qwen1.5-4b", True, 3)]
SETUP_IDS = ["bert-dense", "bert-nmg", "qwen-dense", "qwen-nmg"]
B, S = 3, 24
POS = np.array([5, 17, 0], np.int32)   # slot 2 free: decodes at 0


def _setup(arch, sparse, bias_seed):
    return smoke_setup(sparse, arch, bias_seed)


def _inputs(cfg, seed=11):
    """A seeded cache [L, B, S, KV, hd] and last tokens [B]."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
    return cache, tok


def _torch_cache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


@pytest.mark.parametrize("program", ["chunk", "step"])
@pytest.mark.parametrize("arch,sparse,bias_seed", SETUPS, ids=SETUP_IDS)
def test_programs_equal_reference(arch, sparse, bias_seed, program):
    jcfg, tcfg, jp, tp = _setup(arch, sparse, bias_seed)
    cache, tok = _inputs(tcfg)
    jargs = (jp, jnp.asarray(tok[:, None]),
             {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(POS))
    tc = _torch_cache(cache)
    fn = _decode_chunk_fn(tcfg, 4) if program == "chunk" else \
        _decode_fn(tcfg)
    g = DecodeGraph(fn, tp, tc, B, capture=True)
    assert not g.capture_on            # the CPU runs the program eagerly
    got = g.run(tok, POS)
    if program == "chunk":
        want, jc = j_decode_chunk(jcfg, 4)(*jargs)
        assert got.shape == (4, B) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want, jc = j_decode(jcfg)(*jargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("arch,sparse,bias_seed", SETUPS[1::2],
                         ids=SETUP_IDS[1::2])
def test_static_buffers_equal_eager_over_admission(arch, sparse, bias_seed):
    """Chunk, admission (prefill into slot 2), chunk, one step: the
    static-buffer programs bitwise equal to the eager loop on a copy of
    the same cache."""
    _, cfg, _, tp = _setup(arch, sparse, bias_seed)
    cache, tok = _inputs(cfg, seed=5)
    mine, ref = _torch_cache(cache), _torch_cache(cache)
    chunk = DecodeGraph(_decode_chunk_fn(cfg, 3), tp, mine, B)
    step = DecodeGraph(_decode_fn(cfg), tp, mine, B)
    pos = POS.copy()
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 7)), dtype=torch.int32)
    for turn in range(2):
        got = chunk.run(tok, pos)
        want, _ = decode_chunk(tp, cfg, torch.as_tensor(tok[:, None]), ref,
                               torch.as_tensor(pos), 3)
        assert torch.equal(got, want)
        for k in ("k", "v"):
            assert torch.equal(mine[k], ref[k])
        tok, pos = got[-1].numpy().copy(), pos + 3
        if turn == 0:   # admit a request into the free slot in both caches
            for c in (mine, ref):
                prefill_into_slot(tp, cfg, prompt, c, 2)
            tok[2], pos[2] = 1, 7
    got = step.run(tok, pos)
    want = _decode_fn(cfg)(tp, torch.as_tensor(tok[:, None]), ref,
                           torch.as_tensor(pos))
    assert torch.equal(got, want)
    for k in ("k", "v"):
        assert torch.equal(mine[k], ref[k])


def test_cache_storage_kept_through_the_engine_life():
    """Admission, prefill, chunked and single decode, finish: the engine's
    programs hold its own cache, whose tensors are never reallocated."""
    _, cfg, _, tp = _setup("bert-base-sten", True, None)
    eng = ServeEngine(tp, cfg, max_slots=2, max_seq_len=28, decode_chunk=3,
                      device="cpu")
    assert eng._decode.cache is eng.kv.data
    assert eng._decode_chunk.cache is eng.kv.data
    ptrs = {k: v.data_ptr() for k, v in eng.kv.data.items()}
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n,
                                               dtype=np.int32),
                    max_new_tokens=5,
                    sampling=SamplingParams(greedy=i != 2, temperature=0.8,
                                            seed=i))
            for i, n in enumerate((20, 6, 9, 12))]
    for r in reqs:
        eng.submit(r)
    while len(eng.queue) or eng.num_active:
        eng.step()
        assert {k: v.data_ptr() for k, v in eng.kv.data.items()} == ptrs
    # both programs ran: the chunk while every slot was greedy, the step
    # while request 2 (sampled) held a slot
    assert eng._decode.out.shape == (2, cfg.vocab)
    assert eng._decode_chunk.out.shape == (3, 2)
    assert sorted(len(o.tokens) for o in eng._outputs) == [5] * 4


def test_engine_decode_programs_equal_with_and_without_graphs_on_cpu():
    _, cfg, _, tp = _setup("qwen1.5-4b", True, 3)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 6, 11)]

    def serve(graphs):
        return ServeEngine(tp, cfg, max_slots=2, max_seq_len=28,
                           decode_chunk=4, device="cpu", graphs=graphs).run(
            [Request(uid=i, prompt=p, max_new_tokens=7)
             for i, p in enumerate(prompts)])

    assert [o.tokens for o in serve(True)] == \
        [o.tokens for o in serve(False)]


def test_counter_delta_readds_one_run():
    """The counters after one run plus its re-added delta equal those of
    two eager runs: what a replay does."""
    _, cfg, _, tp = _setup("bert-base-sten", True, None)
    cache, tok = _inputs(cfg)

    def run_once():
        decode_chunk(tp, cfg, torch.as_tensor(tok[:, None]),
                     _torch_cache(cache), torch.as_tensor(POS), 2)

    tops.reset_kernel_counters()
    run_once()
    run_once()
    twice = tops.counter_snapshot()
    tops.reset_kernel_counters()
    before = tops.counter_snapshot()
    run_once()
    delta = tops.counter_delta(before, tops.counter_snapshot())
    assert delta["routes"][("nmg_qkv", "plain")] == 2 * cfg.n_layers
    tops.add_counters(delta)
    assert tops.counter_snapshot() == twice
    assert tops.kernel_counters() == twice["routes"]


def test_counter_helpers_cover_wrapper_launches():
    before = tops.counter_snapshot()
    assert set(before["launches"]) == set(tops.KERNEL_WRAPPERS)
    try:
        tops.add_counters({"routes": {("nmg_gemv", "cuda"): 3},
                           "launches": {"nmg_gemv": 3}})
        after = tops.counter_snapshot()
        assert nmg_gemv.nmg_gemv.launches == before["launches"]["nmg_gemv"] + 3
        assert tops.counter_delta(before, after) == {
            "routes": {("nmg_gemv", "cuda"): 3},
            "launches": {"nmg_gemv": 3}}
        tops.reset_kernel_counters()           # zeroes both accounts
        assert tops.counter_snapshot() == {
            "routes": {}, "launches": dict.fromkeys(tops.KERNEL_WRAPPERS, 0)}
    finally:
        tops.restore_counters(before)
    assert tops.counter_snapshot() == before


def test_capture_preparation_refuses_weight_without_plan():
    _, cfg, _, tp = _setup("bert-base-sten", True, None)
    check_capturable(tp)
    wi = tp["layers"]["mlp"]["wi"]
    bad = {**tp, "layers": {**tp["layers"], "mlp": {
        **tp["layers"]["mlp"], "wi": dataclasses.replace(wi, plan=None)}}}
    with pytest.raises(ValueError, match=r"layers\.mlp\.wi has no gather "
                                         r"plan"):
        check_capturable(bad)
