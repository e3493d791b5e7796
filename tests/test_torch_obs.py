"""The port's ``repro_torch.obs`` against the reference's ``repro.obs``:
the same calls give the same records (timestamps aside), and the
exporters (``to_jsonl``, ``phase_breakdown``, ``validate_chrome_trace``,
``to_chrome_trace``, ``prometheus_text``) give the same output on the
same records and snapshots.  Then the port's counterparts of
``tests/test_obs.py``: the ring buffer, spans, the registry's semantics,
tracing that changes no token and records each request's lifecycle, a
warm tiered engine that builds nothing with the recorder on, and the
trainer's ``--trace`` (``train_chunk`` / ``train_step`` spans,
``sparsity`` events, the same losses with the recorder on)."""

import dataclasses
import json

import numpy as np
import pytest

from repro.obs import trace as jobs
from repro.obs.export import phase_breakdown as j_phase, \
    prometheus_text as j_prom, to_chrome_trace as j_chrome, \
    to_jsonl as j_jsonl, validate_chrome_trace as j_validate
from repro.obs.registry import TelemetryRegistry as JRegistry
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import init_lm
from repro_torch.obs import trace as obs
from repro_torch.obs.export import load_trace, phase_breakdown, \
    prometheus_text, to_chrome_trace, to_jsonl, validate_chrome_trace
from repro_torch.obs.registry import REGISTRY, CounterFamily, \
    MirroredCounters, TelemetryRegistry, snapshot_diff
from repro_torch.serve import Request, ServeEngine, trace_events


@pytest.fixture(autouse=True)
def _port_state():
    """The port's counters and recorder, reset around each test (the
    conftest fixture resets the reference's)."""
    tops.reset_kernel_counters()
    REGISTRY.reset()
    obs.reset()
    yield
    obs.reset()


def _drive(mod, seed: int):
    """One seeded sequence of recorder calls on ``mod`` (either package's
    ``obs.trace``): events, nested spans, a span that raises, retroactive
    spans, request rows."""
    rng = np.random.default_rng(seed)
    mod.enable()
    for i in range(int(rng.integers(5, 15))):
        track = str(rng.choice(["engine", "controller", "faults",
                                f"req:{i % 3}"]))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            mod.event(f"e{i % 4}", track, step=i, v=float(i) / 3)
        elif kind == 1:
            with mod.span("outer", track, n=i):
                with mod.span("inner", track):
                    mod.event("mark", track)
        elif kind == 2:
            with pytest.raises(KeyError):
                with mod.span("boom", track, k=i):
                    raise KeyError(i)
        else:
            mod.complete("queued", 1.0 + i, 1.5 + i, track, uid=i)
    recs = mod.records()
    mod.reset()
    return recs


def _untimed(recs):
    return [(ph, name, track, attrs) for ph, name, track, _, _, attrs in recs]


@pytest.mark.parametrize("seed", range(4))
def test_records_and_exporters_equal_reference(seed):
    got, want = _drive(obs, seed), _drive(jobs, seed)
    assert _untimed(got) == _untimed(want)
    # the exporters on the same records (the port's, timestamps and all)
    assert to_jsonl(got) == j_jsonl(got)
    assert phase_breakdown(got) == j_phase(got)
    doc, jdoc = to_chrome_trace(got, dropped=3), j_chrome(got, dropped=3)
    assert doc["metadata"].pop("tool") == "repro_torch.obs"
    jdoc["metadata"].pop("tool")
    assert doc == jdoc
    assert validate_chrome_trace(doc) == j_validate(jdoc) == []


def test_validator_findings_equal_reference():
    bad = {"traceEvents": [
        {"ph": "X", "ts": 0, "pid": 1, "tid": 1, "name": "a", "dur": 10},
        {"ph": "X", "ts": 5, "pid": 1, "tid": 1, "name": "b", "dur": 10},
        {"ph": "X", "ts": 0, "pid": 1, "name": "c", "dur": -1},
        {"ph": "Q", "ts": 0, "pid": 1, "tid": 2, "name": "d"}]}
    got = validate_chrome_trace(bad)
    assert got == j_validate(bad) and len(got) >= 3
    assert validate_chrome_trace({}) == j_validate({})


def _fill(reg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    reg.counter("c", help="a counter").inc(int(rng.integers(1, 9)))
    reg.gauge("g").set(float(rng.uniform(0, 1)))
    h = reg.histogram("h")
    for v in rng.exponential(0.01, 20):
        h.observe(float(v))
    fam = reg.family("fam", trace_as=None)
    for _ in range(10):
        fam[(str(rng.choice(["nmg_gemv", "nmg_spmm"])),
             str(rng.choice(["cuda", "plain"])))] += 1
    MirroredCounters({"shed": 0, "timeout": 0}, reg.family("stats"))["shed"] \
        += 2
    return reg.snapshot()


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_and_snapshot_diff_equal_reference(seed):
    from repro.obs.registry import snapshot_diff as j_diff

    snap, jsnap = _fill(TelemetryRegistry(), seed), _fill(JRegistry(), seed)
    assert snap == jsnap
    assert prometheus_text(snap) == j_prom(jsnap)
    before, jbefore = TelemetryRegistry(), JRegistry()
    b0 = _fill(before, seed + 10)
    assert snapshot_diff(b0, snap) == j_diff(b0, jsnap)


# ---------------------------------------------------------------------------
# recorder and registry properties (the port's counterparts)
# ---------------------------------------------------------------------------


def test_disabled_mode_records_nothing():
    assert not obs.enabled()
    obs.event("x", "engine", k=1)
    with obs.span("s", "engine"):
        pass
    obs.complete("c", 0.0, 1.0)
    assert obs.records() == [] and obs.dropped() == 0
    assert obs.span("a") is obs.span("b")


def test_ring_buffer_bounded_overwrites_oldest():
    obs.enable(capacity=8)
    for i in range(20):
        obs.event(f"e{i}", "engine", i=i)
    recs = obs.records()
    assert len(recs) == 8 == obs.capacity()
    assert [r[1] for r in recs] == [f"e{i}" for i in range(12, 20)]
    assert obs.dropped() == 12


def test_family_emits_events_only_on_increase_and_not_on_restore():
    fam = CounterFamily(name="f", trace_as="hit", track="kernel")
    obs.enable()
    fam["a"] += 2
    fam["a"] -= 1                       # a decrease: no event
    fam.update({"a": 5})                # the bulk restore path: silent
    fam.clear()
    assert [(r[1], r[5]) for r in obs.records()] == \
        [("hit", {"key": "a", "n": 2})]
    assert type(fam.copy()) is not CounterFamily


def test_registry_constructors_idempotent_and_typed():
    reg = TelemetryRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    m = reg.register("y", CounterFamily(name="y"))
    assert reg.register("y", CounterFamily(name="other")) is m


# ---------------------------------------------------------------------------
# the engine and the trainer with the recorder on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke("bert-base-sten"), dtype="float32")
    return cfg, init_lm(cfg, seed=0, device="cpu")


def _reqs(cfg, n=3, plen=8, gen=6):
    rng = np.random.default_rng(9)
    return [Request(uid=u, max_new_tokens=gen,
                    prompt=rng.integers(0, cfg.vocab, plen, dtype=np.int32))
            for u in range(n)]


def test_tracing_changes_no_tokens_and_emits_lifecycle_spans(setup):
    cfg, params = setup
    ekw = dict(max_slots=2, max_seq_len=24, decode_chunk=4, device="cpu")
    tops.reset_kernel_counters()
    off = ServeEngine(params, cfg, **ekw).run(_reqs(cfg))
    counts_off = tops.counter_snapshot()
    assert obs.records() == []
    obs.enable()
    tops.reset_kernel_counters()
    on = ServeEngine(params, cfg, **ekw).run(_reqs(cfg))
    assert [o.tokens for o in on] == [o.tokens for o in off]
    assert tops.counter_snapshot() == counts_off
    names = {r[1] for r in obs.records()}
    assert {"queued", "prefill", "finish", "decode_call",
            "decode_chunk"} <= names
    tracks = {r[2] for r in obs.records()}
    assert {f"req:{u}" for u in range(3)} <= tracks
    doc = to_chrome_trace(obs.records())
    assert validate_chrome_trace(doc) == []
    prefills = [r for r in obs.records() if r[1] == "prefill"]
    assert sorted(r[5]["uid"] for r in prefills) == [0, 1, 2]


def test_warm_tiered_engine_builds_nothing_with_recorder_on(setup):
    cfg, params = setup
    eng = ServeEngine(params, cfg, max_slots=2, max_seq_len=24,
                      decode_chunk=4, tiers=["dense", "1:4:8-gr64"],
                      device="cpu")
    eng.warm_tiers(prompt_lens=(8,))
    obs.enable()
    before = dict(trace_events())
    eng.run(_reqs(cfg))
    eng.set_tier(1)
    eng.run(_reqs(cfg))
    assert trace_events() == before
    assert not [r for r in obs.records() if r[1] == "program_build"]
    switches = [r for r in obs.records() if r[1] == "tier_switch"]
    assert switches and switches[-1][5]["tier_to"] == "1:4:8-gr64"


@pytest.mark.parametrize("loop", ["graph", "host"])
def test_train_trace_on_cpu(loop, tmp_path):
    """``--trace`` on the CPU: the trace validates and holds the loop's
    spans, the GMP recompute events and per-layer ``sparsity`` events;
    the losses are the run's without the recorder, bit for bit."""
    argv = ["--arch", "bert-base-sten", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "16", "--sparsity", "0.75", "--gmp",
            "iterative", "--log-every", "2", "--device", "cpu"]
    if loop == "host":
        argv.append("--host-loop")
    plain = ttrain.run(ttrain.parse_args(argv))
    path = str(tmp_path / "train_trace.json")
    traced = ttrain.run(ttrain.parse_args(argv + ["--trace", path]))
    assert traced["losses"] == plain["losses"]
    assert not obs.enabled()
    doc = load_trace(path)
    assert validate_chrome_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    span = "train_chunk" if loop == "graph" else "train_step"
    assert names.count(span) == (2 if loop == "graph" else 4)
    assert "gmp_recompute" in names
    sp = [e for e in doc["traceEvents"] if e["name"] == "sparsity"]
    assert sp and all("per_layer" in e["args"] for e in sp)
    assert {e["args"]["weight"] for e in sp} >= {"layers/mlp/wi",
                                                  "layers/attn/wo"}
    assert any(k.startswith("train_sparsity/")
               for k in doc["metadata"]["registry"])
    json.dumps(doc)
