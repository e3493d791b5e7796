"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``): ``count_params`` of the port's meta
``init_lm`` equal to the reference's ``jax.eval_shape`` count at full
width for every architecture and for a sparsified smoke config, and
``model_flops`` equal for all 33 runnable cells.  The reference's module
sets ``XLA_FLAGS`` to 512 host devices when imported, so its side runs
in a subprocess.  Then the port alone: a mini dry-run of the smoke
bert-base-sten train step on a (2, 4) fake mesh (the counterpart of the
reference's ``tests/test_dist.py::test_mini_dryrun_8dev``), a failing
and a skipped cell's records, and the CLI with ``--device cpu`` and the
roofline table over its record, each in a subprocess.  Every fake
process group is destroyed within its test."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, get_arch, get_smoke
from repro_torch.configs.registry import ARCHS, ShapeSpec, runnable_cells
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import analyze_program
from repro_torch.models import init_lm

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")
CELLS = [f"{a}/{s}" for a, s, r in runnable_cells() if r is None]
SPARSE = ("nmg", "masked")

_REFERENCE = textwrap.dedent("""
    import functools, json
    from repro.launch import dryrun as d   # sets XLA_FLAGS first
    import jax
    from repro.configs import SHAPES
    from repro.configs.registry import ARCHS, get_arch, get_smoke, \\
        runnable_cells
    from repro.core.builder import SparsityBuilder
    from repro.core.layouts import FixedMaskTensor, GroupedNMTensor
    from repro.core.sparsifiers import GroupedNMSparsifier
    from repro.models import init_lm

    def shapes(cfg):
        return jax.eval_shape(functools.partial(init_lm, cfg=cfg),
                              jax.random.PRNGKey(0))

    out = {"count": {}, "flops": {}, "sparse": {}}
    for name in ARCHS:
        out["count"][name] = d.count_params(shapes(get_arch(name)))
    for arch, shape, reason in runnable_cells():
        if reason is None:
            out["flops"][f"{arch}/{shape}"] = d.model_flops(
                get_arch(arch), SHAPES[shape], out["count"][arch])
    sp = GroupedNMSparsifier(2, 4, 16, gr=8, sparse_dim=0)
    for mode, layout in (("nmg", GroupedNMTensor),
                         ("masked", FixedMaskTensor)):
        def sparsify(p):  # build_cell's, line for line
            sb = SparsityBuilder()
            sb.set_weight("*mlp.w*", sp, layout)
            sb.set_weight("*attn.wq", sp, layout)
            sb.set_weight("*attn.wo", sp, layout)
            return sb.sparsify_params(p)
        out["sparse"][mode] = d.count_params(jax.eval_shape(
            sparsify, shapes(get_smoke("qwen1.5-4b"))))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=ENV,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_count_params_at_full_width_equal_the_reference(arch, reference):
    p = init_lm(get_arch(arch), device="meta")
    assert dryrun.count_params(p) == reference["count"][arch]


@pytest.mark.parametrize("mode", SPARSE)
def test_count_params_sparsified_smoke_equal_the_reference(mode, reference):
    """Smoke qwen1.5-4b with 2:4:16 gr8 on ``*mlp.w*``, ``*attn.wq``,
    ``*attn.wo`` (the dry-run's ``sparse=nmg`` / ``masked``): the layouts'
    leaves (an n:m:g weight's values, block index and gather plan; a
    masked weight's values and mask) count as the reference's."""
    p = dryrun.sparsify(init_lm(get_smoke("qwen1.5-4b"), device="meta"),
                        {"sparse": mode})
    assert dryrun.count_params(p) == reference["sparse"][mode]


@pytest.mark.parametrize("cell", CELLS)
def test_model_flops_equal_the_reference(cell, reference):
    arch, shape = cell.split("/")
    n = dryrun.count_params(init_lm(get_arch(arch), device="meta"))
    assert dryrun.model_flops(get_arch(arch), SHAPES[shape], n) == \
        reference["flops"][cell]


def _mini(cfg, shape, opts):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    with dryrun.fake_world(8):
        mesh = make_host_mesh(2, 4, device="cpu")
        fn, args, _ = dryrun.build_step(cfg, shape, mesh, opts)
        cost = analyze_program(fn, *args)
    assert not dist.is_initialized()
    return cost


def test_mini_dryrun_8dev():
    """The smoke bert-base-sten train step on a (2, 4) fake mesh, on meta:
    real matmul work and collectives per device, no kernel launched."""
    kops.reset_kernel_counters()
    cost = _mini(get_smoke("bert-base-sten"),
                 ShapeSpec("mini", 32, 8, "train"), {})
    assert cost["flops"] > 1e6
    assert cost["collectives"]["total"] > 0
    assert cost["collectives"]["count"] > 0
    assert all(v == 0 for v in kops.counter_snapshot()["launches"].values())


def test_mini_dryrun_nmg_decode_counts_kernel_nodes():
    """Smoke qwen1.5-4b with ``sparse=nmg`` 1:4:8 gr16, a decode step on
    the (2, 4) fake mesh: every n:m:g product is a kernel node of the
    count, on its meta route, and nothing launches."""
    kops.reset_kernel_counters()
    cost = _mini(get_smoke("qwen1.5-4b"), ShapeSpec("mini", 64, 8,
                                                    "decode"),
                 {"sparse": "nmg", "nm": "1:4:8", "gr": "16"})
    assert sum(cost["kernels"].values()) > 0
    snap = kops.counter_snapshot()
    assert all(v == 0 for v in snap["launches"].values())
    assert sum(n for (k, r), n in snap["routes"].items() if r == "meta") \
        == sum(cost["kernels"].values())


def test_failing_and_skipped_cells_are_recorded(tmp_path):
    import torch.distributed as dist

    rec = dryrun.run_cell("qwen1.5-4b", "long_500k", False, str(tmp_path),
                          {}, device="cpu")
    assert rec["skipped"] and not rec["ok"]
    rec = dryrun.run_cell("mamba2-370m", "decode_32k", False, str(tmp_path),
                          {"sparse": "bogus"}, device="cpu")
    assert not rec["ok"] and "bogus" in rec["error"] and rec["traceback"]
    assert not dist.is_initialized()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["mamba2-370m_decode_32k_16x16.json",
                     "qwen1.5-4b_long_500k_16x16.json"]


def test_dryrun_cli_smoke_cell(tmp_path):
    """The reference's CLI smoke cell (``tests/test_system.py::
    test_dryrun_cli_smoke_cell``) through the port's CLI on a CPU mesh,
    at full width and depth, then the roofline table over its record."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(tmp_path)], env=ENV, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"ok": true' in out.stdout and '"dominant"' in out.stdout
    rec = json.loads((tmp_path / "mamba2-370m_decode_32k_16x16.json")
                     .read_text())
    assert rec["chips"] == 256 and rec["collective_bytes_per_dev"]["total"] \
        > 0 and rec["n_params"] == 419874304
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path)], env=ENV, capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert table.returncode == 0, table.stderr[-3000:]
    assert "| mamba2-370m | decode_32k | 16x16 |" in table.stdout
    assert "NVLink" in table.stdout and "**memory**" in table.stdout


def test_trace_step_peak_counts_arguments_and_live_tensors():
    """The record's ``peak`` (``MemTracker`` over meta storages): a 1 MiB
    shard all-gathered to 4 MiB, doubled and shifted, on a (1, 4) fake
    mesh holds its argument and three live 4 MiB results at once; the
    count is the same as without the tracker."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh

    with dryrun.fake_world(4):
        mesh = make_host_mesh(1, 4, device="cpu")
        x = distribute_tensor(torch.empty(1024, 1024, device="meta"), mesh,
                              (Replicate(), Shard(0)))

        def step(x):
            y = x.redistribute(mesh, (Replicate(), Replicate()))
            z = y * 2
            return (z + 1).sum()

        cost, out, peak, note = dryrun.trace_step(step, (x,))
        assert cost == analyze_program(step, x)
    assert out.shape == () and note is None
    assert peak == 2 ** 20 * (1 + 3 * 4) + 4
