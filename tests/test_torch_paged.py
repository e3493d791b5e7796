"""The port's paged KV cache (``serve/cache.py:PagedKVCache``, the paged
programs of ``serve/engine.py``, ``serve/queue.py:PageAllocator`` and
``prefix_hashes``) against the JAX package's, in the idiom of
``tests/test_paged_cache.py`` and ``tests/test_serve_engine.py``:

- ``prefix_hashes`` byte for byte, and the allocator's invariants
  (property tests without an example database, seeded fallbacks) and
  its state under one operation sequence, the reference's;
- the paged engine on the reference's mixed trace at page sizes 4, 8 and
  16: tokens, ``stats``, the page table and the allocator exactly the
  reference's, pool rows within 1e-4 (the sink page aside);
- paged KV bitwise the port's own slot KV (bf16 and int8 caches), and
  the paged engine's tokens the slot engine's;
- the reference's scenarios against the port: admission order,
  copy-on-write, evicting a sharer, shared against unshared prefixes,
  compaction; the engine under page pressure (deferred admissions,
  preemptions, a rejected lone slot) equal to the reference's engine;
- the sink page: writes the reference drops change no real page;
- ``reset_freed_slots`` and the CLI's ``--paged`` flags."""

import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.serve import PageAllocator as JAllocator, Request as JRequest, \
    ServeEngine as JEngine, prefix_hashes as j_prefix_hashes
from repro_torch.launch import serve as launch
from repro_torch.serve import PageAllocator, PagedKVCache, \
    PromptTooLongError, Request, ServeEngine, SlotKVCache, prefix_hashes
from repro_torch.serve.engine import _decode_fn, _paged_decode_chunk_fn, \
    _paged_decode_fn
from repro_torch.serve.tracecount import reset_trace_events, trace_events

from tests._torch_compat import smoke_setup

TOL = dict(rtol=1e-4, atol=1e-4)


def _setup():
    return smoke_setup(False)


def make_prompt(length, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length,
                                                dtype=np.int32)


def run_tokens(engine, reqs):
    return [(o.uid, o.tokens, o.finish_reason) for o in engine.run(reqs)]


def _engine(params, cfg, **kw):
    return ServeEngine(params, cfg, device="cpu", **kw)


def seq_rows(tree, slot, n):
    """The first ``n`` rows of one slot of every sequence leaf [L, B, S,
    ...], and the slot's row of every state leaf."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in seq_rows(tree[k], slot, n)]
    return [tree[:, slot, :n] if tree.ndim >= 3 else tree[:, slot]]


def assert_rows_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# host bookkeeping: prefix hashes, the allocator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_prefix_hashes_equal_reference(page_size):
    """The blake2b chain gives the reference's digests and covered lengths,
    byte for byte, for prompts that end on and off a page boundary."""
    for n in (1, 3, 16, 21, 64):
        toks = make_prompt(n, seed=n)
        assert prefix_hashes(toks, page_size) == \
            j_prefix_hashes(toks, page_size)


def test_prefix_hash_chain_semantics():
    """Page j's digest commits to pages 0..j, so a prompt that diverges at
    page k shares digests for pages < k only; a partial tail's digest
    commits to the whole prompt."""
    a = np.arange(20, dtype=np.int32)
    b = a.copy()
    b[9] = 999
    ha, hb = prefix_hashes(a, 4), prefix_hashes(b, 4)
    assert [h for h, _ in ha[:2]] == [h for h, _ in hb[:2]]
    assert all(x != y for (x, _), (y, _) in zip(ha[2:], hb[2:]))
    assert [n for _, n in ha] == [4, 8, 12, 16, 20]
    ht = prefix_hashes(a[:18], 4)
    assert [n for _, n in ht] == [4, 8, 12, 16, 18]
    assert ht[-1][0] != ha[-1][0]


@settings(max_examples=50, deadline=None, database=None)
@given(st.integers(1, 16), st.lists(st.integers(0, 5), max_size=30))
def test_alloc_never_double_allocates(num_pages, sizes):
    al = PageAllocator(num_pages)
    live = set()
    for n in sizes:
        free_before = al.num_free
        got = al.alloc(n)
        if got is None:
            assert n > free_before and al.num_free == free_before
            continue
        assert len(got) == n and not (set(got) & live)
        live |= set(got)
        assert al.num_free + al.pages_in_use() == num_pages


@settings(max_examples=50, deadline=None, database=None)
@given(st.integers(1, 12), st.data())
def test_refcount_frees_exactly_at_zero(num_pages, data):
    al = PageAllocator(num_pages)
    model = {}
    for _ in range(40):
        op = data.draw(st.sampled_from(["alloc", "incref", "decref"]))
        if op == "alloc":
            got = al.alloc(1)
            if got is not None:
                model[got[0]] = 1
        elif op == "incref" and model:
            p = data.draw(st.sampled_from(sorted(model)))
            al.incref(p)
            model[p] += 1
        elif op == "decref" and model:
            p = data.draw(st.sampled_from(sorted(model)))
            model[p] -= 1
            freed = al.decref(p)
            assert freed == (model[p] == 0)
            if freed:
                del model[p]
        assert al.pages_in_use() == len(model)


def _random_ops(al, rng, model, n_ops=60):
    """The reference's seeded allocator walk, checking its invariants."""
    num_pages = al.num_pages
    for _ in range(n_ops):
        op = rng.choice(["alloc", "incref", "decref", "burst"])
        if op in ("alloc", "burst"):
            n = 1 if op == "alloc" else int(rng.integers(0, 6))
            free_before = al.num_free
            got = al.alloc(n)
            if got is None:
                assert n > free_before and al.num_free == free_before
            else:
                assert len(set(got)) == n and not (set(got) & set(model))
                for p in got:
                    model[p] = 1
        elif op == "incref" and model:
            p = int(rng.choice(sorted(model)))
            al.incref(p)
            model[p] += 1
        elif op == "decref" and model:
            p = int(rng.choice(sorted(model)))
            model[p] -= 1
            assert al.decref(p) == (model[p] == 0)
            if model[p] == 0:
                del model[p]
        assert al.pages_in_use() == len(model)
        assert al.num_free + al.pages_in_use() == num_pages


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_randomized_invariants(seed):
    """Seeded counterpart of the properties above (runs without
    hypothesis too): 20 pools, 60 operations each, then every page
    decref'd to free exactly at its last reference."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        num_pages = int(rng.integers(1, 16))
        al, model = PageAllocator(num_pages), {}
        _random_ops(al, rng, model)
        for p in sorted(model):
            for _ in range(model[p] - 1):
                assert not al.decref(p)
            assert al.decref(p)
        assert al.pages_in_use() == 0 and al.num_free == num_pages


def _allocator_state(al):
    return (al.refcount.tolist(), list(al._free), dict(al._by_hash),
            {p: sorted(h) for p, h in al._hashes_of.items()})


def test_allocator_state_equals_reference():
    """One seeded walk of allocations, references, prefix registrations
    and a compaction through both allocators: refcounts, free order and
    the prefix index equal after every step."""
    rng = np.random.default_rng(7)
    mine, ref = PageAllocator(12), JAllocator(12)
    for step in range(200):
        op = int(rng.integers(0, 5))
        live = [p for p in range(12) if ref.refcount[p] > 0]
        if op == 0:
            n = int(rng.integers(0, 4))
            assert mine.alloc(n) == ref.alloc(n)
        elif op == 1 and live:
            p = int(rng.choice(live))
            mine.incref(p)
            ref.incref(p)
        elif op == 2 and live:
            p = int(rng.choice(live))
            assert mine.decref(p) == ref.decref(p)
        elif op == 3 and live:
            d, p = bytes([step % 7]), int(rng.choice(live))
            mine.register_prefix(d, p)
            ref.register_prefix(d, p)
            assert mine.lookup_prefix(d) == ref.lookup_prefix(d)
        elif op == 4 and step % 50 == 0:
            plan = ref.compaction_perm()
            assert mine.compaction_perm() == plan
            mine.apply_compaction(plan)
            ref.apply_compaction(plan)
        assert _allocator_state(mine) == _allocator_state(ref)


def test_prefix_index_never_resurrects_freed_pages():
    al = PageAllocator(1)
    (p,) = al.alloc(1)
    al.register_prefix(b"digest-a", p)
    assert al.lookup_prefix(b"digest-a") == p
    assert al.decref(p)
    assert al.lookup_prefix(b"digest-a") is None
    (q,) = al.alloc(1)
    assert q == p and al.lookup_prefix(b"digest-a") is None


# ---------------------------------------------------------------------------
# the paged engine against the reference's
# ---------------------------------------------------------------------------


def _mixed_trace(cls, vocab, n=6, base_seed=0):
    """The reference's prompt-length mix: sub-page, page-aligned and
    multi-page prompts."""
    lens = [3, 8, 13, 16, 21, 5][:n]
    return [cls(uid=i, prompt=make_prompt(L, seed=base_seed + i,
                                          vocab=vocab),
                max_new_tokens=4 + i % 3)
            for i, L in enumerate(lens)]


STAT_KEYS = ("deferred_admissions", "preemptions", "rejected", "peak_active")


@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_paged_engine_equals_reference(page_size):
    """The mixed trace through both paged engines (3 slots, 32 rows,
    chunk 4): tokens, finish reasons, the scheduler's and the cache's
    stats, the page table, refcounts, free order and prefix index all
    exactly the reference's; the pool's pages within 1e-4 of the
    reference's (the port's sink page, one past them, aside).  The tokens
    are also the port's slot engine's."""
    jcfg, tcfg, jp, tp = _setup()
    kw = dict(max_slots=3, max_seq_len=32, decode_chunk=4, paged=True,
              page_size=page_size)
    jeng = JEngine(jp, jcfg, **kw)
    want = run_tokens(jeng, _mixed_trace(JRequest, jcfg.vocab))
    eng = _engine(tp, tcfg, **kw)
    got = run_tokens(eng, _mixed_trace(Request, tcfg.vocab))
    assert got == want
    assert got == run_tokens(
        _engine(tp, tcfg, max_slots=3, max_seq_len=32, decode_chunk=4),
        _mixed_trace(Request, tcfg.vocab))
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert eng.kv.stats == jeng.kv.stats
    np.testing.assert_array_equal(eng.kv.table, jeng.kv.table)
    assert _allocator_state(eng.kv.alloc) == _allocator_state(jeng.kv.alloc)
    npg = jeng.kv.num_pages
    for k in ("k", "v"):
        mine, ref = eng.kv.data[k], np.asarray(jeng.kv.data[k])
        assert mine.shape[1] == npg + 1 == ref.shape[1] + 1
        np.testing.assert_allclose(mine[:, :npg].numpy(), ref, **TOL)


def _pressure(case, cls, vocab):
    """(engine kwargs, slot-engine kwargs, requests) of the reference's
    page-pressure scenarios, and a lone slot that cannot grow."""
    if case == "defer":
        # 10 pages of 4 tokens: two ~4-page requests fit, the rest defer
        lens = ((10, 3, 5), (12, 100, 7), (11, 101, 7), (13, 102, 7))
        reqs = [cls(uid=u, prompt=make_prompt(n, seed=s, vocab=vocab),
                    max_new_tokens=m)
                for u, (n, s, m) in zip((0, 10, 11, 12), lens)]
        return (dict(max_slots=4, max_seq_len=20, page_size=4,
                     num_pages=10),
                dict(max_slots=4, max_seq_len=20), reqs)
    if case == "preempt":
        # 8 pages of 3 tokens: three 7-9 token prompts admit, their growth
        # does not fit -> the youngest is preempted mid-stream
        reqs = [cls(uid=i, prompt=make_prompt(7 + i, seed=200 + i,
                                              vocab=vocab),
                    max_new_tokens=9) for i in range(3)]
        return (dict(max_slots=3, max_seq_len=21, decode_chunk=4,
                     page_size=3, num_pages=8),
                dict(max_slots=3, max_seq_len=20, decode_chunk=4), reqs)
    # one slot, 2 pages of 4: an 8-token prompt fits, its first decode
    # write does not and there is nothing to preempt -> rejected
    reqs = [cls(uid=0, prompt=make_prompt(8, seed=300, vocab=vocab),
                max_new_tokens=3),
            cls(uid=1, prompt=make_prompt(3, seed=301, vocab=vocab),
                max_new_tokens=3)]
    return (dict(max_slots=1, max_seq_len=16, page_size=4, num_pages=2),
            None, reqs)


@pytest.mark.parametrize("case", ["defer", "preempt", "reject"])
def test_engine_under_page_pressure_equals_reference(case):
    """``tests/test_serve_engine.py``'s out-of-pages admission and
    mid-stream preemption, and a lone slot that cannot get one page:
    ``deferred_admissions``, ``preemptions``, ``rejected`` and every
    request's tokens equal the reference's engine; the pool drains; where
    a slot engine fits the trace, its tokens are the same."""
    jcfg, tcfg, jp, tp = _setup()
    jkw, _, jreqs = _pressure(case, JRequest, jcfg.vocab)
    kw, slot_kw, reqs = _pressure(case, Request, tcfg.vocab)
    common = dict(paged=True, prefix_sharing=False)
    jeng = JEngine(jp, jcfg, **jkw, **common)
    want = run_tokens(jeng, jreqs)
    eng = _engine(tp, tcfg, **kw, **common)
    got = run_tokens(eng, reqs)
    assert got == want
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    key = {"defer": "deferred_admissions", "preempt": "preemptions",
           "reject": "rejected"}[case]
    assert eng.stats[key] > 0
    assert eng.kv.alloc.pages_in_use() == 0
    if slot_kw is not None:
        slot = run_tokens(_engine(tp, tcfg, **slot_kw),
                          _pressure(case, Request, tcfg.vocab)[2])
        assert [t for _, t, _ in got] == [t for _, t, _ in slot]


# ---------------------------------------------------------------------------
# paged against the port's own slot cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_size,kv", [(4, None), (8, None), (8, "int8")],
                         ids=["ps4", "ps8", "ps8-int8"])
def test_paged_kv_bitwise_equals_slot(page_size, kv):
    """Both caches through two admissions and five decode steps at the same
    positions: logits bitwise, and the paged pool read back through its
    table (``logical_view``) bitwise the slot cache's valid rows, with an
    int8 cache too (codes bitwise)."""
    _, tcfg, _, tp = _setup()
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    S0, S1 = 11, 6
    p0 = make_prompt(S0, seed=1, vocab=cfg.vocab)[None]
    p1 = make_prompt(S1, seed=2, vocab=cfg.vocab)[None]
    sk = SlotKVCache(cfg, 2, 32, device="cpu")
    pk = PagedKVCache(cfg, 2, 32, page_size=page_size, device="cpu")
    lg_s0 = sk.write_prefill(tp, p0, 0).clone()
    lg_p0 = pk.admit(tp, p0, 0).clone()
    sk.write_prefill(tp, p1, 1)
    pk.admit(tp, p1, 1)
    assert torch.equal(lg_s0, lg_p0)
    dec_s = _decode_fn(cfg)
    dec_p = _paged_decode_fn(cfg, pk.page_size, pk.num_pages)
    tok = torch.full((2, 1), int(lg_s0[0].argmax()), dtype=torch.int32)
    tok_p = tok.clone()
    pos = torch.tensor([S0, S1], dtype=torch.int32)
    for _ in range(5):
        assert pk.ensure_writable_range(0, int(pos[0]), 1)
        assert pk.ensure_writable_range(1, int(pos[1]), 1)
        ls = dec_s(tp, tok, sk.data, pos)
        lp = dec_p(tp, tok_p, pk.data, pk.device_table(), pos)
        assert torch.equal(ls, lp)
        tok = ls.argmax(-1).to(torch.int32)[:, None]
        tok_p = lp.argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    view = pk.logical_view()
    if kv == "int8":
        assert view["k"].dtype == torch.int8
    for slot, valid in ((0, S0 + 5), (1, S1 + 5)):
        assert_rows_equal(seq_rows(sk.data, slot, valid),
                          seq_rows(view, slot, valid))


def test_paged_programs_trace_once_a_prompt_length():
    """The engine's paged programs are built once each (``paged_prefill``
    once a prompt length, ``paged_decode_chunk`` once), and a second pass
    over the same traffic builds nothing."""
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, max_slots=3, max_seq_len=32, decode_chunk=4,
                  paged=True, page_size=8)
    reset_trace_events()
    first = run_tokens(eng, _mixed_trace(Request, tcfg.vocab))
    assert trace_events() == {"paged_prefill": 6, "paged_decode_chunk": 1}
    assert run_tokens(eng, _mixed_trace(Request, tcfg.vocab)) == first
    assert trace_events() == {"paged_prefill": 6, "paged_decode_chunk": 1}


# ---------------------------------------------------------------------------
# the reference's paged scenarios, against the port
# ---------------------------------------------------------------------------


def test_admission_order_does_not_leak_between_slots():
    """Admitting B after A, releasing B and admitting it again into the
    freed pages leaves A's rows bitwise untouched."""
    _, cfg, _, tp = _setup()
    pk = PagedKVCache(cfg, 3, 32, page_size=4, device="cpu")
    pa = make_prompt(10, seed=3, vocab=cfg.vocab)[None]
    pb = make_prompt(7, seed=4, vocab=cfg.vocab)[None]
    pk.admit(tp, pa, 0)
    before = seq_rows(pk.logical_view(), 0, 10)
    pk.admit(tp, pb, 1)
    pk.release_slot(1)
    pk.admit(tp, pb, 2)
    assert_rows_equal(before, seq_rows(pk.logical_view(), 0, 10))


def test_shared_prefix_outputs_identical_to_unshared():
    """Requests with a common prompt prefix: sharing on gives exactly the
    sharing-off tokens while sharing pages."""
    _, cfg, _, tp = _setup()
    prefix = make_prompt(12, seed=30, vocab=cfg.vocab)

    def trace():
        return [Request(uid=i, prompt=np.concatenate(
            [prefix, make_prompt(3 + i, seed=60 + i, vocab=cfg.vocab)]),
            max_new_tokens=4) for i in range(4)]

    kw = dict(max_slots=4, max_seq_len=32, decode_chunk=4, paged=True,
              page_size=4)
    on = _engine(tp, cfg, **kw)
    off = _engine(tp, cfg, prefix_sharing=False, **kw)
    assert run_tokens(on, trace()) == run_tokens(off, trace())
    assert on.kv.stats["shared_tokens"] > 0
    assert off.kv.stats["shared_tokens"] == 0
    assert (on.kv.stats["peak_pages_in_use"]
            < off.kv.stats["peak_pages_in_use"])


def test_decode_write_into_shared_page_copies_on_write():
    """Two identical prompts share every page, the partial tail too; the
    second slot's first decode range copies the tail page (in place in the
    pool's storage) and leaves the sibling's rows bitwise untouched."""
    _, cfg, _, tp = _setup()
    prompt = make_prompt(10, seed=31, vocab=cfg.vocab)[None]
    pk = PagedKVCache(cfg, 2, 32, page_size=4, device="cpu")
    ptrs = [t.data_ptr() for t in (pk.data["k"], pk.data["v"])]
    pk.admit(tp, prompt, 0)
    pk.admit(tp, prompt, 1)
    tail = 10 // 4
    assert int(pk.table[0, tail]) == int(pk.table[1, tail])
    assert pk.alloc.refcount[int(pk.table[1, tail])] == 2
    before = seq_rows(pk.logical_view(), 0, 10)
    assert pk.ensure_writable_range(1, 10, 2)
    assert pk.stats["cow_copies"] == 1
    assert int(pk.table[0, tail]) != int(pk.table[1, tail])
    assert_rows_equal(before, seq_rows(pk.logical_view(), 0, 10))
    assert_rows_equal(before, seq_rows(pk.logical_view(), 1, 10))
    assert [t.data_ptr() for t in (pk.data["k"], pk.data["v"])] == ptrs


def test_evicting_one_sharer_keeps_the_others_pages():
    _, cfg, _, tp = _setup()
    prompt = make_prompt(9, seed=32, vocab=cfg.vocab)[None]
    pk = PagedKVCache(cfg, 2, 32, page_size=4, device="cpu")
    pk.admit(tp, prompt, 0)
    pk.admit(tp, prompt, 1)
    survivor = [p for _, p in pk.slot_pages(1)]
    before = seq_rows(pk.logical_view(), 1, 9)
    assert pk.release_slot(0) == []
    assert all(pk.alloc.refcount[p] == 1 for p in survivor)
    assert_rows_equal(before, seq_rows(pk.logical_view(), 1, 9))
    assert sorted(pk.release_slot(1)) == sorted(survivor)
    assert pk.alloc.pages_in_use() == 0


def test_compaction_preserves_live_page_contents():
    """Compacting a fragmented pool packs live pages to the front in the
    pool's own storage, every slot's rows stay bitwise, and the prefix
    index follows the move; ``release_slot(zero=True)`` zeroes exactly
    the pages it frees."""
    _, cfg, _, tp = _setup()
    pk = PagedKVCache(cfg, 4, 16, page_size=4, device="cpu")
    ptr = pk.data["k"].data_ptr()
    prompts = [make_prompt(6 + 3 * i, seed=70 + i, vocab=cfg.vocab)[None]
               for i in range(4)]
    for i, p in enumerate(prompts):
        pk.admit(tp, p, i)
    pk.release_slot(0)
    freed = pk.release_slot(2, zero=True)
    assert freed and not pk.data["k"][:, freed].any()
    lens = {1: prompts[1].shape[1], 3: prompts[3].shape[1]}
    before = {s: seq_rows(pk.logical_view(), s, n) for s, n in lens.items()}
    used = pk.alloc.pages_in_use()
    pk.compact()
    assert pk.data["k"].data_ptr() == ptr
    assert pk.alloc.pages_in_use() == used
    live = sorted(p for s in (1, 3) for _, p in pk.slot_pages(s))
    assert live == list(range(used))
    for s, n in lens.items():
        assert_rows_equal(before[s], seq_rows(pk.logical_view(), s, n))
    pk.admit(tp, prompts[1], 0)
    assert pk.stats["shared_tokens"] >= prompts[1].shape[1]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_reset_freed_slots_zeroes_what_a_request_leaves(paged):
    """``reset_freed_slots=True`` zeroes a finished request's cache (its
    slot row, or the pages its release frees) and changes no token.  A
    free slot still decodes a chunk from position 0, writing the chunk's
    first rows of the slot cache (masked until an admission overwrites
    them); the paged engine sends them to the sink page, which the
    zeroing clears too."""
    _, cfg, _, tp = _setup()
    kw = dict(max_slots=3, max_seq_len=32, decode_chunk=4)
    if paged:
        kw.update(paged=True, page_size=8)
    want = run_tokens(_engine(tp, cfg, **kw),
                      _mixed_trace(Request, cfg.vocab))
    eng = _engine(tp, cfg, reset_freed_slots=True, **kw)
    assert run_tokens(eng, _mixed_trace(Request, cfg.vocab)) == want
    for leaf in eng.kv.data.values():
        assert not (leaf if paged else leaf[:, :, kw["decode_chunk"]:]).any()


def test_sink_page_takes_the_writes_the_reference_drops():
    """A paged chunk for a slot already past its capacity, beside an
    unmapped (free) slot: every write goes to the sink page, one past the
    pool's pages, and no real page changes; the shared-prefix rows of an
    admission go there too."""
    _, cfg, _, tp = _setup()
    pk = PagedKVCache(cfg, 2, 8, page_size=4, device="cpu")
    pk.admit(tp, make_prompt(8, seed=5, vocab=cfg.vocab)[None], 0)
    npg = pk.num_pages
    real = {k: v[:, :npg].clone() for k, v in pk.data.items()}
    sink = {k: v[:, npg].clone() for k, v in pk.data.items()}
    chunk = _paged_decode_chunk_fn(cfg, pk.page_size, npg, 3)
    chunk(tp, torch.tensor([[3], [4]], dtype=torch.int32), pk.data,
          pk.device_table(), torch.tensor([8, 0], dtype=torch.int32))
    for k, v in pk.data.items():
        assert torch.equal(v[:, :npg], real[k])
        assert not torch.equal(v[:, npg], sink[k])
    # an admission whose first page is shared writes those rows to the
    # sink: only its own fresh tail page changes
    pk.release_slot(0)
    p = make_prompt(6, seed=6, vocab=cfg.vocab)[None]
    pk.admit(tp, p, 0)
    real = {k: v[:, :npg].clone() for k, v in pk.data.items()}
    q = p.copy()
    q[0, 4:] = (q[0, 4:] + 1) % cfg.vocab
    pk.admit(tp, q, 1)
    assert pk.stats["shared_tokens"] == 4
    assert int(pk.table[1, 0]) == int(pk.table[0, 0])
    fresh = int(pk.table[1, 1])
    for k, v in pk.data.items():
        keep = [i for i in range(npg) if i != fresh]
        assert torch.equal(v[:, keep], real[k][:, keep])


def test_paged_cache_refuses_what_the_reference_refuses():
    """A prompt past the logical capacity raises ``PromptTooLongError``
    (a ``ValueError``) in both caches; a page size that does not divide
    ``max_seq_len`` and an enc-dec model raise ``ValueError``."""
    _, cfg, _, tp = _setup()
    long = make_prompt(40, seed=80, vocab=cfg.vocab)[None]
    with pytest.raises(PromptTooLongError):
        SlotKVCache(cfg, 2, 32, device="cpu").write_prefill(tp, long, 0)
    with pytest.raises(PromptTooLongError):
        PagedKVCache(cfg, 2, 32, page_size=8, device="cpu").admit(tp, long,
                                                                  0)
    assert issubclass(PromptTooLongError, ValueError)
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagedKVCache(cfg, 2, 30, page_size=8, device="cpu")
    from repro_torch.configs import get_smoke

    with pytest.raises(ValueError, match="enc-dec"):
        PagedKVCache(get_smoke("whisper-large-v3"), 2, 32, device="cpu")


def test_serve_cli_paged(capsys):
    """``--paged`` serves through the paged cache and prints its KV
    stats; a page size that does not divide prompt-len + gen-len exits
    non-zero."""
    launch.main(["--arch", "bert-base-sten", "--smoke", "--engine",
                 "--device", "cpu", "--requests", "3", "--prompt-len", "12",
                 "--gen-len", "4", "--paged", "--page-size", "8",
                 "--no-warmup"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "(paged KV cache)" in out
    assert "paged KV: peak" in out
    with pytest.raises(SystemExit) as exc:
        launch.main(["--arch", "bert-base-sten", "--smoke", "--engine",
                     "--device", "cpu", "--paged", "--page-size", "5"])
    assert exc.value.code != 0
    assert "must divide" in capsys.readouterr().err
