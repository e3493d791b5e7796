"""The port's SLO control loop (``repro_torch.serve.slo``), its resident
sparsity tiers, typed serve errors and serve CLI against the reference's:

* ``TierSpec.parse`` over the reference's accepted and rejected specs;
* ``CadenceWatchdog`` and ``SLOController`` fed one seeded observation
  sequence in both packages: level, tier, admission budget, chunk, shed
  decision and reason equal at every step;
* ``LatencyModel``: ``table_step_s`` and the EWMA estimates within 1e-12
  on the same table entries (the same keys in both packages);
* the engine at SMOKE under manual ``set_tier``: each tier's tokens equal
  the reference engine's on params carried across by ``bridge.py``, and
  no program is built after ``warm_tiers`` (the reference's
  ``test_slo.py`` recompile-free property);
* the controller driving the engine on a ticking clock: escalation,
  a tier switch, tokens from two tiers, nothing built;
* shedding: the reference sheds requests before they arrive (ROADMAP
  C14, pinned), the port only arrived ones, serving the same tokens;
* the serve CLI: the reference's ``ap.error`` rules, ``--check`` refusing
  to serve under a table the checker rejects and passing a clean run,
  ``--arrival-gap``, ``--trace`` writing a trace that validates,
  ``run_oneshot``'s tokens equal to the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve_cli
from repro.serve import CadenceWatchdog as JWatchdog, \
    LatencyModel as JLatency, Request as JRequest, \
    SLOConfig as JSLOConfig, SLOController as JController, \
    ServeEngine as JEngine, TierSpec as JTierSpec, build_tiers as j_build
from repro.tune import routing as jrouting
from repro.tune.table import TuningTable as JTable, shape_key as j_key
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import trace as tobs
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.export import load_trace, validate_chrome_trace
from repro_torch.obs.registry import REGISTRY as TREGISTRY
from repro_torch.serve import CadenceWatchdog, DeadlineExceededError, \
    EngineOverloadError, InjectedFaultError, LatencyModel, \
    PromptTooLongError, Request, RequestOutput, SLOConfig, SLOController, \
    ServeEngine, ServeError, TierSpec, build_tiers, raise_for_output, \
    trace_events
from repro_torch.serve import cache as tcache
from repro_torch.tune import routing
from repro_torch.tune.table import TuningTable, shape_key

from tests._torch_compat import smoke_setup


@pytest.fixture(autouse=True)
def _port_state():
    """The port's counters, tuning table and recorder, reset around each
    test (the conftest fixture resets the reference's)."""
    tops.reset_kernel_counters()
    routing.clear_active_table()
    TREGISTRY.reset()
    tobs.reset()
    yield
    routing.clear_active_table()
    tobs.reset()


@pytest.fixture(scope="module")
def dense():
    return smoke_setup(False)


# ---------------------------------------------------------------------------
# tier specs, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "dense", "DENSE", " dense ", "2:4", "1:4:8", "1:4:8-gr64", "1:4:8-gr32",
    "2:8:16-gr16", " 1:4:8-gr64 ",
    "4:2", "0:4", "1:4:2", "junk", "1:2:3:4", "2:4-grx", ""])
def test_tier_spec_parse_equals_reference(spec):
    try:
        want = JTierSpec.parse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            TierSpec.parse(spec)
        return
    got = TierSpec.parse(spec)
    assert (got.name, got.fmt, got.gr, got.density) == \
        (want.name, want.fmt, want.gr, want.density)


def test_build_tiers_rejects_empty_and_duplicates(dense):
    _, _, _, tp = dense
    with pytest.raises(ValueError, match="at least one"):
        build_tiers(tp, [])
    with pytest.raises(ValueError, match="duplicate"):
        build_tiers(tp, ["dense", "dense"])


def test_error_family_shape_and_cache_reexport():
    assert issubclass(PromptTooLongError, ServeError)
    assert issubclass(PromptTooLongError, ValueError)
    assert issubclass(DeadlineExceededError, ServeError)
    assert issubclass(EngineOverloadError, ServeError)
    assert not issubclass(InjectedFaultError, ServeError)
    assert tcache.PromptTooLongError is PromptTooLongError


@pytest.mark.parametrize("reason,exc", [
    ("shed", EngineOverloadError), ("timeout", DeadlineExceededError),
    ("rejected", PromptTooLongError), ("length", None), ("stop", None)])
def test_raise_for_output(reason, exc):
    out = RequestOutput(uid=1, prompt_len=3, tokens=[], finish_reason=reason,
                        arrival_time=0.0, admitted_time=float("nan"),
                        finish_time=1.0, token_times=[])
    if exc is None:
        raise_for_output(out)
    else:
        with pytest.raises(exc):
            raise_for_output(out)


def test_submit_raises_typed_errors(dense):
    _, tcfg, _, tp = dense
    eng = ServeEngine(tp, tcfg, max_slots=2, max_seq_len=16, max_queue=1,
                      device="cpu")
    with pytest.raises(PromptTooLongError):
        eng.submit(Request(uid=0, prompt=np.ones(20, np.int32),
                           max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=np.ones(4, np.int32), max_new_tokens=4,
                       arrival_time=99.0))
    with pytest.raises(EngineOverloadError):
        eng.submit(Request(uid=2, prompt=np.ones(4, np.int32),
                           max_new_tokens=4, arrival_time=99.0))
    # run() turns the overload into a rejected output instead
    outs = eng.run([Request(uid=3, prompt=np.ones(4, np.int32),
                            max_new_tokens=2)], max_steps=1)
    assert [o.finish_reason for o in outs] == ["rejected"]


# ---------------------------------------------------------------------------
# watchdog and controller: step for step against the reference
# ---------------------------------------------------------------------------


def _observations(seed: int, n: int = 160):
    """A seeded trace of (decode seconds, steps, queue depth, free slots):
    healthy 10 ms steps with jitter, a slow window at x3, a queue that
    fills in a burst and drains."""
    rng = np.random.default_rng(seed)
    out = []
    depth = 0
    for i in range(n):
        steps = int(rng.choice([1, 4, 8]))
        per_tok = 0.010 * float(rng.lognormal(0.0, 0.1))
        if 40 <= i < 70:
            per_tok *= 3.0
        if i == 30:
            depth += 20
        depth = max(0, depth + int(rng.integers(-2, 3)))
        out.append((per_tok * steps, steps, depth, int(rng.integers(0, 5))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_watchdog_equals_reference(seed):
    kw = dict(window=4, n_windows=6, min_windows=3, ratio=2.0)
    got, want = CadenceWatchdog(**kw), JWatchdog(**kw)
    for dt, steps, _, _ in _observations(seed):
        for _ in range(steps):
            got.observe(dt / steps)
            want.observe(dt / steps)
        assert got.slow() == want.slow()
        r, w = got.recent(), want.recent()
        assert r == w or (r != r and w != w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tiers", [1, 3])
def test_controller_equals_reference_step_for_step(seed, tiers, dense):
    """Both controllers, each with its package's LatencyModel over the
    same dense SMOKE params, take the same observations and queue depths:
    every decision is equal at every step."""
    jcfg, tcfg, jp, tp = dense
    kw = dict(tpot_ms=14.0, escalate_dwell=2, deescalate_dwell=12,
              watchdog_window=4, watchdog_n_windows=6,
              watchdog_min_windows=3)
    got = SLOController(SLOConfig(**kw), n_tiers=tiers, max_slots=4,
                        latency=LatencyModel(tp, tcfg, max_slots=4))
    want = JController(JSLOConfig(**kw), n_tiers=tiers, max_slots=4,
                       latency=JLatency(jp, jcfg, max_slots=4))
    levels = set()
    for i, (dt, steps, depth, free) in enumerate(_observations(seed)):
        got.observe_decode(dt, steps)
        want.observe_decode(dt, steps)
        assert got.begin_step(float(i), depth) == \
            want.begin_step(float(i), depth)
        levels.add(got.level)
        assert (got.level, got.tier_index, got.last_reason) == \
            (want.level, want.tier_index, want.last_reason)
        assert got.admission_budget(free) == want.admission_budget(free)
        assert got.decode_chunk(8) == want.decode_chunk(8)
        assert got.should_shed(depth) == want.should_shed(depth)
        assert got.latency.tpot_s() == want.latency.tpot_s()
    assert dict(got.counters) == dict(want.counters)
    assert len(levels) > 2            # the sequence moved the ladder


# ---------------------------------------------------------------------------
# latency model
# ---------------------------------------------------------------------------


def test_latency_model_table_and_ewma_equal_reference(dense):
    """Tiers converted in each package (the FFN only): the same routed
    weights, table keys and multiplicities; seeded table entries give
    ``table_step_s`` within 1e-12, and the same observations the same
    EWMA estimates."""
    jcfg, tcfg, jp, tp = dense
    got = LatencyModel(build_tiers(tp, ["1:4:8-gr16"])[0].params, tcfg,
                       max_slots=4)
    want = JLatency(j_build(jp, ["1:4:8-gr16"])[0].params, jcfg,
                    max_slots=4)
    keys = [shape_key("matmul_latency", **c) for c, _ in got._weights]
    assert keys == [j_key("matmul_latency", **c) for c, _ in want._weights]
    assert [m for _, m in got._weights] == [m for _, m in want._weights]
    assert got.table_step_s(4) is None and want.table_step_s(4) is None
    rng = np.random.default_rng(5)
    table, jtable = TuningTable.for_device(), JTable.for_device()
    for key in keys:
        for M in (1, 4, 8, 16, 32):    # no M64: prefill_s(33) is unknown
            us = float(rng.uniform(5.0, 500.0))
            table.put(f"{key}/M{M}", us)
            jtable.put(f"{key}/M{M}", us)
    routing.set_active_table(table)
    jrouting.set_active_table(jtable)
    def close(a, b):
        return (a != a and b != b) or abs(a - b) <= 1e-12

    for M in (1, 3, 4, 8, 16, 17, 32):
        assert close(got.table_step_s(M), want.table_step_s(M))
    assert got.table_step_s(33) is None and want.table_step_s(33) is None
    assert close(got.tpot_s(), want.tpot_s())
    for i in range(30):
        dt, n = float(rng.uniform(0.005, 0.1)), int(rng.integers(1, 9))
        got.observe_step(dt, n)
        want.observe_step(dt, n)
        plen = int(rng.integers(4, 70))
        got.observe_prefill(plen, dt)
        want.observe_prefill(plen, dt)
        assert close(got.tpot_s(), want.tpot_s())
        for p in (4, 16, 33, 64, 100):
            assert close(got.prefill_s(p), want.prefill_s(p))
            assert close(got.request_s(p, 9), want.request_s(p, 9))


# ---------------------------------------------------------------------------
# the engine: tiers against the reference, nothing built after warm_tiers
# ---------------------------------------------------------------------------

TIERS = ["dense", "2:4", "1:4:8-gr16"]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_tier_engine_tokens_equal_reference_and_build_nothing(dense, paged):
    """Three batches under ``set_tier(0)``, ``(2)`` and ``(1)`` in both
    engines (no controller, so a manual tier holds): each batch's tokens
    equal the reference's, and after ``warm_tiers`` the port builds no
    program (its build counter stays flat)."""
    jcfg, tcfg, jp, tp = dense
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (8, 12) * 3]
    kw = dict(max_slots=2, max_seq_len=24, decode_chunk=4, tiers=TIERS)
    if paged:
        kw.update(paged=True, page_size=4)
    jeng, eng = JEngine(jp, jcfg, **kw), ServeEngine(tp, tcfg, device="cpu",
                                                     **kw)
    jeng.warm_tiers((8, 12))
    eng.warm_tiers((8, 12))
    built = dict(trace_events())
    programs = 2 * len(TIERS)           # per prompt length, per tier
    assert built == ({"paged_prefill": programs, "paged_decode": 3,
                      "paged_decode_chunk": 3} if paged else
                     {"slot_prefill": programs, "decode": 3,
                      "decode_chunk": 3})
    for t, lo in ((0, 0), (2, 2), (1, 4)):
        jeng.set_tier(t)
        eng.set_tier(t)
        want = jeng.run([JRequest(uid=i, prompt=prompts[i],
                                  max_new_tokens=6) for i in (lo, lo + 1)])
        got = eng.run([Request(uid=i, prompt=prompts[i], max_new_tokens=6)
                       for i in (lo, lo + 1)])
        assert [o.tokens for o in got] == [o.tokens for o in want], t
    assert trace_events() == built
    # set_tier(0) at tier 0 switches nothing
    assert eng.stats["tier_switches"] == jeng.stats["tier_switches"] == 2
    assert eng.tokens_by_tier == jeng.tokens_by_tier
    assert all(v == 12 for v in eng.tokens_by_tier.values())


def test_set_tier_without_tiers_raises(dense):
    _, tcfg, _, tp = dense
    with pytest.raises(ValueError, match="without tiers"):
        ServeEngine(tp, tcfg, max_slots=2, max_seq_len=16,
                    device="cpu").set_tier(1)


class _Tick:
    """A clock that advances 1 ms at every read: a host-paced decode call
    reads it a fixed number of times, so observed step times are
    deterministic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def test_controller_drives_tiers_on_a_ticking_clock(dense):
    """An SLO far below the clock's step time: the controller escalates
    past level 2, the engine switches tiers, and tokens come from more
    than one tier, with every request terminal and nothing built after
    ``warm_tiers``."""
    _, tcfg, _, tp = dense
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, tcfg.vocab, 8,
                                               dtype=np.int32),
                    max_new_tokens=10) for i in range(12)]
    eng = ServeEngine(tp, tcfg, max_slots=2, max_seq_len=24, decode_chunk=4,
                      tiers=TIERS, slo=SLOConfig(tpot_ms=0.01),
                      clock=_Tick(), device="cpu")
    eng.warm_tiers((8,))
    built = dict(trace_events())
    outs = eng.run(reqs)
    assert trace_events() == built
    assert len(outs) == 12
    assert all(o.finish_reason in ("length", "shed") for o in outs)
    assert eng.stats["tier_switches"] >= 1
    assert sum(v > 0 for v in eng.tokens_by_tier.values()) >= 2
    assert eng._controller.level >= 2
    met = eng.metrics(label="slo")
    assert met.tokens_by_tier == eng.tokens_by_tier


def _shed_trace(vocab, arrival: float):
    """One request due now and eight due at ``arrival``."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, 8, dtype=np.int32) for _ in range(9)]
    return list(zip(prompts, [0.0] + [arrival] * 8))


_SHED_KW = dict(max_slots=1, max_seq_len=24, decode_chunk=4)


def test_shed_before_arrival_fault_of_the_reference(dense):
    """ROADMAP C14, a fault of the reference's (the port does not share
    it: :func:`test_shed_only_arrived_requests`): under ``slo=`` its
    controller reads ``len(queue)`` and ``RequestQueue.shed`` drops the
    newest arrivals first, and both count requests whose
    ``arrival_time`` is still ahead, so a trace submitted whole sheds
    work before it arrives.  One request due now and eight due in 1000 s
    on a frozen clock (one slot: the queue past ``queue_high`` keeps
    every step hot): six future requests shed, each finished before its
    arrival."""
    jcfg, _, jp, _ = dense
    jeng = JEngine(jp, jcfg, slo=JSLOConfig(tpot_ms=50.0),
                   clock=lambda: 0.0, **_SHED_KW)
    want = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=12,
                              arrival_time=a)
                     for i, (p, a) in enumerate(
                         _shed_trace(jcfg.vocab, 1000.0))])
    shed = [o for o in want if o.finish_reason == "shed"]
    assert len(shed) == 6 == jeng.stats["shed"]
    assert all(o.uid > 0 and o.finish_time < o.arrival_time for o in shed)


def test_shed_only_arrived_requests(dense):
    """The port counts and sheds only requests that have arrived (ROADMAP
    C2).  The same trace with the eight due at 50 ms, on a clock that
    steps 1 ms at every read (under a frozen clock they would never
    arrive): nothing is shed while they are due, what is shed is shed
    after its arrival, and every request both engines serve (the
    reference's run of :func:`test_shed_before_arrival_fault_of_the_
    reference`) has the reference's tokens."""
    jcfg, tcfg, jp, tp = dense
    trace = _shed_trace(jcfg.vocab, 1000.0)
    jeng = JEngine(jp, jcfg, slo=JSLOConfig(tpot_ms=50.0),
                   clock=lambda: 0.0, **_SHED_KW)
    want = {o.uid: o for o in jeng.run([
        JRequest(uid=i, prompt=p, max_new_tokens=12, arrival_time=a)
        for i, (p, a) in enumerate(trace)])}
    eng = ServeEngine(tp, tcfg, slo=SLOConfig(tpot_ms=50.0), device="cpu",
                      clock=_Tick(), **_SHED_KW)
    got = eng.run([Request(uid=i, prompt=p, max_new_tokens=12,
                           arrival_time=0.0 if i == 0 else 0.05)
                   for i, (p, _) in enumerate(trace)])
    assert len(got) == 9
    shed = [o for o in got if o.finish_reason == "shed"]
    assert shed and eng.stats["shed"] == len(shed)
    assert all(o.finish_time >= o.arrival_time for o in shed)
    served = [o for o in got if o.finish_reason == "length"]
    assert len(served) + len(shed) == 9
    both = [o for o in served if want[o.uid].finish_reason == "length"]
    assert len(both) >= 2
    for o in both:
        assert o.tokens == want[o.uid].tokens


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--paged"], ["--slo-tpot-ms", "10"], ["--tiers", "dense"], ["--faults"],
    ["--engine", "--faults"], ["--tune"],
    ["--engine", "--tune", "--no-warmup"]])
def test_cli_refuses_what_the_reference_refuses(argv, capsys):
    for main in (jserve_cli.main, serve_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["--smoke"] + argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("error:") == 2


def test_cli_refuses_check(tmp_path, capsys):
    """``--check`` refuses to serve when the checker finds an ERROR: a
    table whose ``gemv_cuda`` entry the f32 decode body cannot take
    (R6), loaded before the check as the reference orders it."""
    path = str(tmp_path / "bad.json")
    TuningTable(device="torch-cpu:cpu",
                entries={"gemv_cuda": {"rows": 64, "parts": 1}}).save(path)
    rc = serve_cli.main(["--smoke", "--engine", "--check", "--device",
                         "cpu", "--tuning-table", path])
    assert rc == 1
    out = capsys.readouterr().out
    assert "error[R6]" in out and "not serving" in out
    assert "served" not in out.replace("not serving", "")


def test_cli_check_passes_and_serves(capsys):
    """A clean preflight (the serve entry at the check config) prints its
    summary and the run serves the trace, arrivals spaced by
    ``--arrival-gap``."""
    rc = serve_cli.main(["--arch", "bert-base-sten", "--smoke", "--engine",
                         "--check", "--arrival-gap", "0.01", "--device",
                         "cpu", "--requests", "4", "--gen-len", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "3 program(s) checked: 0 error(s), 0 warning(s)" in out
    assert "served 4 requests" in out


@pytest.mark.parametrize("gap", [0.0, 0.25])
def test_make_requests_arrival_gap(gap):
    """Request i arrives at i * gap, with the reference's prompt lengths
    (``_make_requests``: stepping down by 2 from ``prompt_len``)."""
    _, tcfg, _, _ = smoke_setup(False)
    reqs = serve_cli.make_requests(tcfg, 6, 12, 5, seed=0, arrival_gap=gap)
    assert [r.arrival_time for r in reqs] == [i * gap for i in range(6)]
    assert [r.prompt.size for r in reqs] == [12, 10, 8, 6, 12, 10]
    assert all(r.max_new_tokens == 5 for r in reqs)


def test_cli_slo_trace_validates(tmp_path, capsys):
    path = str(tmp_path / "serve_trace.json")
    rc = serve_cli.main(["--arch", "bert-base-sten", "--smoke", "--engine",
                         "--tiers", "dense,1:4:8-gr16", "--slo-tpot-ms",
                         "50", "--faults", "--trace", path, "--device",
                         "cpu", "--requests", "4", "--gen-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tier switches" in out and "WARNING" not in out
    doc = load_trace(path)
    assert validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"queued", "prefill", "finish"} <= names
    assert "engine_stats" in doc["metadata"]["registry"]
    assert obs_main(["validate", path]) == 0
    assert obs_main(["summarize", path]) == 0
    prom = str(tmp_path / "t.prom")
    assert obs_main(["convert", path, "--to", "prom", "--out", prom]) == 0
    assert "repro_kernel_routes" in open(prom).read()
    assert not tobs.enabled()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_run_oneshot_tokens_equal_reference(sparse):
    """``run_oneshot`` (prefill, then greedy ``decode_step``) on bridged
    SMOKE params: the reference's tokens."""
    jcfg, tcfg, jp, tp = smoke_setup(sparse)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 10),
                                                dtype=np.int32)
    want, _, _ = jserve_cli.run_oneshot(jp, jcfg, jnp.asarray(prompts), 7)
    got, t_pre, t_dec = serve_cli.run_oneshot(tp, tcfg,
                                              torch.as_tensor(prompts), 7)
    assert got.shape == (3, 7) and t_pre >= 0 and t_dec >= 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_oneshot_batch_runs(capsys):
    assert serve_cli.main(["--arch", "bert-base-sten", "--smoke", "--batch",
                           "4", "--gen-len", "5", "--device", "cpu"]) == 0
    assert "ms/token" in capsys.readouterr().out
