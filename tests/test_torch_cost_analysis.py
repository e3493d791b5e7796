"""The port's cost analysis (``repro_torch.launch.cost_analysis``): the
FLOPs of a smoke forward against the reference's ``analyze_hlo`` of the
same forward compiled on the CPU, the rules one op at a time (a matmul,
a meta n:m:g product, views, gathers, indexed writes), the per-device
count of a DTensor program on a fake process group (local shapes, not
global ones; an all-gather's operand bytes), and the roofline terms at
the H100's rates, mirroring ``tests/test_hlo_analysis.py``."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import forward as j_forward, init_lm as j_init_lm
from repro_torch.configs import get_smoke
from repro_torch.core.nmg import dense_to_grouped_nm
from repro_torch.kernels import ops as kops
from repro_torch.launch.cost_analysis import analyze_program, roofline_terms
from repro_torch.launch.hw import H100
from repro_torch.models import forward, init_lm


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "bert-base-sten",
                                  "gemma2-9b", "minicpm3-4b", "mamba2-370m"])
def test_forward_flops_equal_the_reference_hlo(arch):
    """The matmul FLOPs of an unsharded smoke forward (B = 2, S = 64,
    remat "none" in both) within 2% of the reference's ``analyze_hlo`` of
    the forward jitted on the CPU (both count matmul work alone; the
    reference's scan trip count multiplies its layer body, the port runs
    its layers one by one).  They agree exactly here."""
    jc = j_smoke(arch)
    shapes = jax.eval_shape(functools.partial(j_init_lm, cfg=jc),
                            jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    hlo = jax.jit(lambda p, t: j_forward(p, jc, t, remat="none")).lower(
        shapes, tok).compile().as_text()
    want = analyze_hlo(hlo)["flops"]
    cfg = get_smoke(arch)
    got = analyze_program(lambda p, t: forward(p, cfg, t, remat="none"),
                          init_lm(cfg, device="meta"),
                          _meta(2, 64, dtype=torch.int32))
    assert got["flops"] == pytest.approx(want, rel=0.02)
    assert got["kernels"] == {} and got["collectives"]["total"] == 0


def test_single_mm_is_charged_2mnk():
    got = analyze_program(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert got["flops"] == 2 * 64 * 128 * 32
    assert got["bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_views_are_free_and_gathers_charge_rows():
    """A view charges nothing; ``index_select`` of 8 rows of a 100000-row
    table charges those rows (read and written) and the indices, not the
    table (the reference's ``test_gather_not_charged_table``); an
    in-place indexed write charges its slice, not its destination."""
    table = _meta(100000, 64)
    idx = torch.empty(8, dtype=torch.int64, device="meta")
    got = analyze_program(lambda t: t.reshape(-1, 32).T.unsqueeze(0), table)
    assert got["bytes"] == 0
    got = analyze_program(lambda t, i: t.index_select(0, i), table, idx)
    assert got["bytes"] == 2 * 8 * 64 * 4 + 8 * 8
    vals = _meta(8, 64)
    got = analyze_program(lambda t, i, v: t.index_put_((i,), v), table, idx,
                          vals)
    assert got["bytes"] == 8 * 8 + 2 * 8 * 64 * 4


def test_meta_nmg_linear_charged_its_storage_and_launches_nothing():
    """A meta ``nmg_linear`` (decode-shaped, the GEMV route) is one kernel
    node charged n/m of the dense FLOPs (K and N unpadded) and its
    storage, activation and output bytes; no wrapper launches, and its
    route counts under ``meta``, never ``cuda``."""
    K, N, M = 256, 64, 4
    w = dense_to_grouped_nm(_meta(K, N, dtype=torch.bfloat16), 1, 4, 8,
                            gr=16, sparse_dim=0)
    x = _meta(M, K, dtype=torch.bfloat16)
    kops.reset_kernel_counters()
    got = analyze_program(lambda x, w: kops.nmg_linear(x, w), x, w)
    assert got["kernels"] == {"nmg_gemv": 1}
    assert got["flops"] == 2 * M * K * N * 1 / 4
    cols = w.gather_plan().cols
    assert got["bytes"] == (w.val.numel() * 2 + cols.numel() * 4
                            + M * K * 2 + M * N * 2)
    snap = kops.counter_snapshot()
    assert all(v == 0 for v in snap["launches"].values())
    assert snap["routes"][("nmg_gemv", "meta")] == 1
    assert not any(r == "cuda" for _, r in snap["routes"])
    # the SpMM route (M past the crossover), the same rules
    got = analyze_program(lambda x, w: kops.nmg_linear(x, w),
                          _meta(64, K, dtype=torch.bfloat16), w)
    assert got["kernels"] == {"nmg_spmm": 1}
    assert got["flops"] == 2 * 64 * K * N / 4


def test_meta_training_kernels_charged_and_not_launched():
    x = _meta(32, 64, dtype=torch.bfloat16)
    got = analyze_program(lambda x: kops.nm_mask(x, 2, 4), x)
    assert got["kernels"] == {"nm_mask": 1}
    assert got["flops"] == 2 * 4 * 32 * 64
    assert got["bytes"] == 32 * 64 * 2 + 32 * 64
    a, b = _meta(16, 64), _meta(64, 32)
    got = analyze_program(lambda a, b: kops.matmul_threshold(a, b, 0.5), a, b)
    assert got["kernels"] == {"matmul_threshold": 1}
    assert got["flops"] == 2 * 16 * 64 * 32
    assert all(v == 0 for v in kops.counter_snapshot()["launches"].values())


def _fake_mesh(world, shape):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return make_host_mesh(*shape, device="cpu")


def test_sharded_linear_is_charged_its_local_shapes():
    """On a (1, 4) fake mesh a linear whose weight is sharded over its
    output columns is charged a quarter of the unsharded FLOPs per device:
    the count sees each op at the shard's shape (DTensor runs first), and
    the sharding propagation's global-shape run on fake tensors is not
    charged."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = _fake_mesh(4, (1, 4))
    try:
        x = distribute_tensor(_meta(8, 64), mesh, (Replicate(), Replicate()))
        w = distribute_tensor(_meta(64, 32), mesh, (Replicate(), Shard(1)))
        got = analyze_program(lambda x, w: x @ w, x, w)
        assert got["flops"] == 2 * 8 * 64 * 32 / 4
        assert got["collectives"]["total"] == 0
    finally:
        dist.destroy_process_group()


def test_all_gather_is_charged_its_operand_bytes():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = _fake_mesh(4, (1, 4))
    try:
        w = distribute_tensor(_meta(64, 32), mesh, (Replicate(), Shard(0)))
        got = analyze_program(
            lambda w: w.redistribute(mesh, (Replicate(), Replicate())), w)
        coll = got["collectives"]
        assert coll["all-gather"] == 16 * 32 * 4
        assert coll["total"] == 16 * 32 * 4 and coll["count"] == 1
    finally:
        dist.destroy_process_group()


def test_roofline_dominance_at_h100_rates():
    pf, bw, nv = H100["peak_flops_bf16"], H100["hbm_bw"], H100["nvlink_bw"]
    t = roofline_terms(pf, bw / 10, nv / 10)      # 1 s compute
    assert t.dominant == "compute" and t.compute_s == pytest.approx(1.0)
    t = roofline_terms(pf / 10, bw, nv / 10)
    assert t.dominant == "memory" and t.memory_s == pytest.approx(1.0)
    t = roofline_terms(pf / 10, bw / 10, 10 * nv)
    assert t.dominant == "collective"
    assert t.bound_s == pytest.approx(10.0)
    assert roofline_terms(1.0, 1.0, 1.0, "torch-cpu:cpu") == \
        roofline_terms(1.0, 1.0, 1.0)
