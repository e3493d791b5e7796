"""The port's seeded fault injection (``repro_torch.serve.faults``) against
the reference's: the same ``FaultConfig`` gives the same schedules value
for value (spikes, error bursts, slow windows, for seeds 0-4 and past the
horizon), ``burst_arrivals`` the same arrival times; then the port's
counterparts of ``tests/test_faults.py``: bursts bounded and cleared by
the engine's retries, a burst past the retry cap propagating, and the
fault-storm property on the paged engine (every request terminal,
survivors bitwise the fault-free run at the same tier, no page left in
use, a same-seed rerun landing the same outcomes)."""

import dataclasses

import numpy as np
import pytest

from repro.serve import FaultConfig as JFaultConfig, \
    FaultInjector as JFaultInjector, burst_arrivals as j_burst_arrivals
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models import init_lm
from repro_torch.obs import trace as tobs
from repro_torch.obs.registry import REGISTRY as TREGISTRY
from repro_torch.serve import FaultConfig, FaultInjector, \
    InjectedFaultError, Request, SamplingParams, ServeEngine, \
    burst_arrivals, sparsify_for_serving

#: every fault kind; sleep is injected as a no-op, so the schedules fire
#: without slowing the suite (the reference's STORM)
STORM = dict(seed=2, horizon=256, spike_prob=0.2, spike_s=(0.001, 0.002),
             slow_windows=((2, 6, 3.0), (10, 14, 2.0)), error_prob=0.3,
             max_consecutive_errors=2, admission_delay_s=0.001)

NOSLEEP = dict(sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's counters and recorder, reset around each test (the
    conftest fixture resets the reference's)."""
    tops.reset_kernel_counters()
    TREGISTRY.reset()
    tobs.reset()
    yield
    tobs.reset()


@pytest.mark.parametrize("seed", range(5))
def test_schedules_equal_reference(seed):
    kw = dict(STORM, seed=seed, horizon=97)
    got = FaultInjector(FaultConfig(**kw), **NOSLEEP)
    want = JFaultInjector(JFaultConfig(**kw), **NOSLEEP)
    for step in range(2 * 97 + 5):        # past the horizon: modulo reuse
        assert got.spike_at(step) == want.spike_at(step)
        assert got.errors_at(step) == want.errors_at(step)
        assert got.slow_factor(step) == want.slow_factor(step)
    assert any(got.errors_at(s) for s in range(97))
    assert any(got.spike_at(s) for s in range(97))


@pytest.mark.parametrize("seed", range(5))
def test_burst_arrivals_equal_reference(seed):
    kw = dict(n_background=24, rate_hz=6.0, bursts=((1.0, 16), (2.5, 3)),
              seed=seed)
    got = burst_arrivals(**kw)
    assert got == j_burst_arrivals(**kw)
    assert got == sorted(got) and len(got) == 24 + 16 + 3


@pytest.mark.parametrize("seed", range(5))
def test_injected_sequence_equal_reference(seed):
    """The same engine-style retry loop over both injectors raises,
    spikes and slows at the same steps, and counts the same."""
    kw = dict(STORM, seed=seed)
    got = FaultInjector(FaultConfig(**kw), **NOSLEEP)
    want = JFaultInjector(JFaultConfig(**kw), **NOSLEEP)

    def drive(inj, exc):
        seen = []
        for step in range(40):
            raises = 0
            while True:
                try:
                    inj.pre_decode(step)
                    break
                except exc:
                    raises += 1
            inj.post_decode(step, 1e-3)
            inj.admission_delay()
            seen.append(raises)
        return seen, dict(inj.injected)

    from repro.serve import InjectedFaultError as JInjectedFaultError
    assert drive(got, InjectedFaultError) == drive(want,
                                                   JInjectedFaultError)


def test_error_burst_bounded_by_config():
    inj = FaultInjector(FaultConfig(**STORM), **NOSLEEP)
    for step in range(STORM["horizon"]):
        n = inj.errors_at(step)
        assert 0 <= n <= STORM["max_consecutive_errors"]
        raises = 0
        for _ in range(n + 2):              # the engine's retry loop
            try:
                inj.pre_decode(step)
                break
            except InjectedFaultError:
                raises += 1
        assert raises == n                  # the burst clears, then admits


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype="float32")
    return cfg, init_lm(cfg, seed=0, device="cpu")


def make_reqs(cfg, n, *, plen=8, gen=6, arrivals=None):
    rng = np.random.default_rng(1)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, plen,
                                               dtype=np.int32),
                    max_new_tokens=gen,
                    sampling=SamplingParams(greedy=True, seed=i),
                    arrival_time=0.0 if arrivals is None
                    else float(arrivals[i]),
                    priority=i % 3)
            for i in range(n)]


def test_transient_errors_retried_token_stream_unchanged(setup):
    cfg, params = setup
    reqs = make_reqs(cfg, 4)
    kw = dict(max_slots=2, max_seq_len=16, decode_chunk=4, device="cpu")
    want = {o.uid: o.tokens for o in ServeEngine(params, cfg, **kw).run(reqs)}
    eng = ServeEngine(params, cfg, faults=FaultInjector(
        FaultConfig(**STORM), **NOSLEEP), **kw)
    outs = eng.run(reqs)
    assert eng.stats["fault_retries"] > 0
    assert {o.uid: o.tokens for o in outs} == want


def test_error_burst_past_retry_cap_propagates(setup):
    cfg, params = setup
    outage = FaultConfig(seed=0, horizon=8, error_prob=1.0,
                         max_consecutive_errors=5, max_retries=2)
    eng = ServeEngine(params, cfg, max_slots=2, max_seq_len=16,
                      decode_chunk=4, device="cpu",
                      faults=FaultInjector(outage, **NOSLEEP))
    for r in make_reqs(cfg, 1):
        eng.submit(r)
    with pytest.raises(InjectedFaultError):
        while eng.step():
            pass


def test_fault_storm_every_request_terminal_survivors_bitwise(setup):
    """The reference's storm over the paged engine at a fixed n:m:g tier:
    every request terminal (two time out), every survivor's tokens
    bitwise the fault-free run's, no page left in use, and a same-seed
    rerun the same outcomes and injections (``slow_s`` scales with the
    measured step, so it is left out)."""
    cfg, params = setup
    sparse = sparsify_for_serving(params, 1, 4, 8, gr=64)
    arrivals = burst_arrivals(n_background=4, rate_hz=100.0,
                              bursts=((0.0, 6),), seed=2)
    reqs = make_reqs(cfg, len(arrivals), arrivals=arrivals)
    reqs[3] = dataclasses.replace(reqs[3], deadline_s=1e-6)
    reqs[7] = dataclasses.replace(reqs[7], deadline_s=1e-6)
    ekw = dict(max_slots=2, max_seq_len=16, decode_chunk=4, paged=True,
               page_size=4, num_pages=16, device="cpu")
    base = ServeEngine(sparse, cfg, **ekw)
    served_base = {o.uid: o.tokens for o in base.run(reqs)
                   if o.finish_reason in ("length", "stop")}
    assert base.kv.alloc.pages_in_use() == 0

    def storm():
        eng = ServeEngine(sparse, cfg, faults=FaultInjector(
            FaultConfig(**STORM), **NOSLEEP), **ekw)
        return eng, eng.run(reqs)

    eng, outs = storm()
    terminal = ("length", "stop", "rejected", "timeout", "shed")
    assert len(outs) == len(reqs)
    assert all(o.finish_reason in terminal for o in outs)
    assert eng.stats["timeout"] == 2 and eng.stats["fault_retries"] > 0
    served = {o.uid: o.tokens for o in outs
              if o.finish_reason in ("length", "stop")}
    assert served
    for uid, toks in served.items():
        assert toks == served_base[uid], f"uid {uid} diverged under storm"
    assert eng.kv.alloc.pages_in_use() == 0
    eng2, outs2 = storm()
    assert [(o.uid, o.finish_reason, o.tokens) for o in outs2] == \
        [(o.uid, o.finish_reason, o.tokens) for o in outs]
    assert {k: v for k, v in eng2.faults.injected.items()
            if k != "slow_s"} == {k: v for k, v in eng.faults.injected.items()
                                  if k != "slow_s"}
