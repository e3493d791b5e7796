"""Counter hygiene of the port (the counterpart of
``tests/test_counter_hygiene.py``): the kernel-route, kernel-launch,
dispatch and program-build stores are ``repro_torch.obs`` registry
metrics, ``REGISTRY.reset()`` clears every one of them in place, the
module-level references stay the registered instances (so counts after
a reset land in the registry's snapshot), and the graph bookkeeping
(``counter_snapshot`` / ``counter_delta`` / ``add_counters`` /
``restore_counters``) keeps its semantics on the registry: a replay adds
its captured launches and routes, a restore is silent on the timeline.
The ``_bleed_`` twins assert exact totals, so this file's reset fixture
keeps them order-independent."""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.nmg import dense_to_grouped_nm
from repro_torch.kernels import nmg_gemv
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs
from repro_torch.obs.registry import REGISTRY
from repro_torch.serve import tracecount

disp = importlib.import_module("repro_torch.core.dispatch")


@pytest.fixture(autouse=True)
def _port_state():
    kops.reset_kernel_counters()
    disp.reset_dispatch_counters()
    REGISTRY.reset()
    obs.reset()
    yield
    obs.reset()


def _weight(sparse_dim: int):
    """An [8, 96] n:m:g matrix sparse along its 96 axis: stored [96, 8]
    with sparse_dim 0 (a linear weight), or [8, 96] with 1 (a matmul's
    left operand)."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (8, 96)).astype(np.float32))
    if sparse_dim == 0:
        x = x.T.contiguous()
    return dense_to_grouped_nm(x, 1, 4, 4, gr=2, sparse_dim=sparse_dim)


def _one_routed_matmul():
    kops.nmg_linear(torch.ones(1, 96), _weight(0))


def _one_sparse_dispatch():
    disp.dispatch("matmul", _weight(1), torch.ones(96, 4))


@pytest.mark.parametrize("twin", ["first", "second"])
def test_counter_bleed_twins(twin):
    _one_routed_matmul()
    counts = kops.kernel_counters()
    assert counts[("nmg_gemv", "plain")] == 1, counts


@pytest.mark.parametrize("twin", ["first", "second"])
def test_dispatch_counter_bleed_twins(twin):
    _one_sparse_dispatch()
    counts = disp.dispatch_counters()
    assert sum(v for k, v in counts.items() if k[0] == "impl") == 1, counts


def test_registry_reset_clears_every_store_in_place():
    _one_routed_matmul()
    _one_sparse_dispatch()
    tracecount.note_trace("decode_chunk")
    nmg_gemv.nmg_gemv.launches += 3     # what a wrapper counts on the card
    snap = REGISTRY.snapshot()
    assert sum(snap["kernel_routes"].values()) >= 1, snap
    assert sum(snap["dispatch"].values()) >= 1, snap
    assert snap["serve_program_builds"] == {"decode_chunk": 1}
    assert snap["kernel_launches"]["nmg_gemv"] == 3
    routes, dcounts, builds = (kops._KERNEL_COUNTS, disp._DISPATCH_COUNTS,
                               tracecount._TRACE_EVENTS)
    REGISTRY.reset()
    assert kops.kernel_counters() == {} and disp.dispatch_counters() == {}
    assert tracecount.trace_events() == {}
    assert nmg_gemv.nmg_gemv.launches == 0
    # the module references are the registered instances, still live
    assert kops._KERNEL_COUNTS is routes is REGISTRY.family("kernel_routes")
    assert disp._DISPATCH_COUNTS is dcounts is REGISTRY.family("dispatch")
    assert tracecount._TRACE_EVENTS is builds
    _one_routed_matmul()
    assert REGISTRY.snapshot()["kernel_routes"]["nmg_gemv/plain"] == 1


def test_a_replay_adds_its_captured_launches():
    """What ``serve/graphs.py`` does around a capture and at each replay,
    on the registry stores: the capture's delta is taken and the counters
    put back; each replay adds the delta once more."""
    before = kops.counter_snapshot()
    _one_routed_matmul()                 # the program's recorded work
    nmg_gemv.nmg_gemv.launches += 1      # the launch a capture records
    after = kops.counter_snapshot()
    delta = kops.counter_delta(before, after)
    assert delta == {"routes": {("nmg_linear", "gemv[default]"): 1,
                                ("nmg_gemv", "plain"): 1},
                     "launches": {"nmg_gemv": 1}}
    obs.enable()
    kops.restore_counters(before)        # capture executes nothing
    assert kops.counter_snapshot() == before
    assert obs.records() == []           # a restore is silent
    for n in (1, 2, 3):                  # three replays
        kops.add_counters(delta)
        assert kops.kernel_counters()[("nmg_gemv", "plain")] == n
        assert nmg_gemv.nmg_gemv.launches == n
    assert REGISTRY.snapshot()["kernel_launches"]["nmg_gemv"] == 3
    routes = [r for r in obs.records() if r[1] == "kernel_route"]
    assert len(routes) == 3 * len(delta["routes"])


def test_reset_helpers_clear_everything():
    _one_routed_matmul()
    _one_sparse_dispatch()
    assert kops.kernel_counters() and disp.dispatch_counters()
    kops.reset_kernel_counters()
    disp.reset_dispatch_counters()
    assert kops.kernel_counters() == {} and disp.dispatch_counters() == {}
