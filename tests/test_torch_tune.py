"""The port's tuning subsystem (``repro_torch.tune``) case for case against
the reference's ``tests/test_tune.py``, and against the reference itself
on the same numpy-made inputs.

The guarantees:

* **Defaults** — with no active table every routing answer, counter key
  and decode plan equals the port's routing before tables (pinned below
  against values read from the tree before the tuning subsystem).
* **Routes under any table** — a table changes only which path or kernel
  config runs: forced crossovers (0 and 4096) give the same bits within
  one route and allclose across routes (the reference's two routes differ
  at ULP level, ROADMAP C3), as the reference does under the same table.
* **Plumbing** — keys letter for letter the reference's, one table file
  shared with the reference (each package keeps the other's section byte
  for byte), counter provenance, ``predict_route`` against the counters,
  the CLI, ``$REPRO_TUNE_TABLE``, corrupt tables, the dispatcher's
  conversion-cost tie-break (the reference's choice under the same
  table), and the serving warmup hook.

Tolerance: f32 outputs of two routes (two summation orders) within
rtol = atol = 1e-5, as ``tests/test_torch_kernels.py``; bf16 outputs of
two routes within one bf16 rounding step (rtol = 2**-7).
"""

import collections
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.tune import TuningTable as JaxTable
from repro.tune import bench as jbench
from repro.tune import routing as jrouting
from repro.tune import shape_key as jax_shape_key
from repro_torch import bridge
from repro_torch.core.nmg import dense_to_grouped_nm
from repro_torch.kernels import nmg_gemv, nmg_spmm
from repro_torch.kernels import ops as tops
from repro_torch.tune import TuningTable, bucket, routing, shape_key
from repro_torch.tune import bench as tbench
from repro_torch.tune.table import device_kind, dtype_name

from tests._torch_compat import jax_dense_to_grouped_nm, nmg_to_numpy, \
    smoke_setup

tdisp = importlib.import_module("repro_torch.core.dispatch")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)
CPU = "torch-cpu:cpu"


@pytest.fixture(autouse=True)
def _reset_port_routing():
    routing.clear_active_table()
    tops.reset_kernel_counters()
    tdisp.reset_dispatch_counters()
    yield
    routing.clear_active_table()


def _pair(R, K, fmt, gr, *, sparse_dim=1, dtype=jnp.float32, seed=11):
    """A reference n:m:g tensor of a seeded [R, K] (or [K, R]) matrix and
    its bridged port twin."""
    n, m, g = fmt
    shape = (R, K) if sparse_dim == 1 else (K, R)
    x = np.random.default_rng(seed).standard_normal(shape)
    ref = jax_dense_to_grouped_nm(jnp.asarray(x, dtype), n=n, m=m, g=g,
                                  gr=gr, sparse_dim=sparse_dim)
    return ref, bridge.params_from_numpy(nmg_to_numpy(ref), device="cpu")


def _flip_table(t, dtype, value):
    """A port table that pins this tensor's decode_m_max bucket."""
    tab = TuningTable.for_device()
    tab.put(shape_key("decode_m_max", **tops._route_ctx(t, dtype)), value)
    return tab


def _torch_dtype(jdt):
    return torch.float32 if jdt == jnp.float32 else torch.bfloat16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# defaults: no table => the port's routing before tables, exactly
# ---------------------------------------------------------------------------


def test_no_table_reproduces_shipped_defaults():
    assert routing.active_table() is None
    ctx = dict(K=96, R=8, fmt=(1, 4, 4), gr=2, dtype=torch.float32)
    assert routing.decode_m_max(**ctx) == (routing.DEFAULT_DECODE_M_MAX,
                                           "default")
    assert routing.DEFAULT_DECODE_M_MAX == tops.DECODE_M_MAX == 16
    assert routing.spmm_block_elems() == (1 << 22, "default")
    assert routing.gemv_cuda_config(**ctx) == (None, "default")
    assert routing.spmm_cuda_config(**ctx) == (None, "default")
    assert routing.fused_qkv(**ctx) == (True, "default")
    assert routing.fused_ffn(**ctx) == (True, "default")
    assert routing.matmul_latency_us(M=4, **ctx) == (None, "default")
    assert tdisp.conversion_cost_model() is None


def test_no_table_router_boundary_matches_constant():
    _, t = _pair(8, 96, (1, 4, 4), 2)
    tops.nmg_matmul(t, torch.ones(96, tops.DECODE_M_MAX))
    tops.nmg_matmul(t, torch.ones(96, tops.DECODE_M_MAX + 1))
    assert tops.kernel_counters() == {
        ("nmg_matmul", "gemv[default]"): 1, ("nmg_matmul", "spmm[default]"): 1,
        ("nmg_gemv", "plain"): 1, ("nmg_spmm", "plain"): 1}


def _snapshot_weight(K, R, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return dense_to_grouped_nm(torch.randn(K, R, generator=g), 1, 4, 8,
                               gr=16, sparse_dim=0).to(dtype=dtype)


#: counter keys of (nmg_linear, maybe_fused_qkv, maybe_fused_ffn,
#: nmg_matmul) at M rows, read from the tree before tuning tables
BEFORE = {
    4: {("nmg_ffn", "fused[default]"): 1, ("nmg_ffn", "plain"): 1,
        ("nmg_gemv", "plain"): 2, ("nmg_linear", "gemv[default]"): 1,
        ("nmg_matmul", "gemv[default]"): 1, ("nmg_qkv", "fused[default]"): 1,
        ("nmg_qkv", "plain"): 1},
    17: {("nmg_linear", "spmm[default]"): 1,
         ("nmg_matmul", "spmm[default]"): 1, ("nmg_spmm", "plain"): 2},
    40: {("nmg_linear", "spmm[default]"): 1,
         ("nmg_matmul", "spmm[default]"): 1, ("nmg_spmm", "plain"): 2},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", sorted(BEFORE))
def test_no_table_counter_keys_equal_before(M, dtype):
    wq, wk, wv = (_snapshot_weight(128, 64, s, dtype) for s in (1, 2, 3))
    wi = _snapshot_weight(128, 128, 4, dtype)
    x = torch.randn(M, 128).to(dtype)
    tops.nmg_linear(x, wq)
    tops.maybe_fused_qkv(x, (wq, wk, wv))
    tops.maybe_fused_ffn(x, wi)
    tops.nmg_matmul(wq, x.T.float().contiguous())
    assert tops.kernel_counters() == BEFORE[M]


#: row_plan(gr, M, KN, dtype) -> (body, rows, nt8, per, parts), read from
#: the tree before tuning tables
PLANS_BEFORE = {
    (64, 4, 192, torch.bfloat16): ("tc", 64, 1, 2, 2),
    (64, 16, 192, torch.bfloat16): ("tc", 64, 2, 2, 2),
    (64, 4, 640, torch.bfloat16): ("tc", 64, 1, 2, 5),
    (64, 4, 1728, torch.bfloat16): ("tc", 64, 1, 4, 7),
    (64, 4, 768, torch.bfloat16): ("tc", 64, 1, 2, 6),
    (16, 9, 3456, torch.bfloat16): ("tc", 16, 2, 7, 8),
    (128, 1, 640, torch.bfloat16): ("tc", 64, 1, 2, 5),
    (24, 4, 640, torch.bfloat16): ("general", 4, 0, 0, 1),
    (64, 4, 640, torch.float32): ("rows", 4, 0, 0, 1),
    (3, 4, 640, torch.float32): ("general", 4, 0, 0, 1),
    (32, 40, 60, torch.bfloat16): ("tc", 32, 2, 1, 1),
    (1, 8, 6, torch.bfloat16): ("general", 4, 0, 0, 1),
}


def test_no_table_decode_plans_equal_before():
    for (gr, M, KN, dt), want in PLANS_BEFORE.items():
        p = nmg_gemv.row_plan(gr, M, KN, dt)
        assert (p.body, p.rows, p.nt8, p.per, p.parts) == want
        # the plan's own config, given back as a table entry, is the plan
        assert nmg_gemv.row_plan(gr, M, KN, dt, {"rows": p.rows,
                                                 "parts": p.parts}) == p


def test_kernel_configs_the_kernels_cannot_take_raise():
    """A table entry the kernel cannot take raises; nothing falls back."""
    bf = torch.bfloat16
    assert nmg_gemv.tc_parts_choices(640) == [1, 2, 3, 4, 5]
    assert nmg_gemv.tc_parts_choices(1728) == [1, 2, 3, 4, 5, 6, 7]
    for cfg in ({"rows": 64, "parts": 6}, {"rows": 48, "parts": 1},
                {"rows": 128, "parts": 1}):
        with pytest.raises(ValueError):
            nmg_gemv.row_plan(64, 4, 640, bf, cfg)
    with pytest.raises(ValueError):
        nmg_gemv.row_plan(32, 4, 640, bf, {"rows": 64, "parts": 1})
    with pytest.raises(ValueError):        # rows body: one config
        nmg_gemv.row_plan(64, 4, 640, torch.float32, {"rows": 16, "parts": 2})
    p = nmg_gemv.row_plan(32, 4, 640, bf, {"rows": 16, "parts": 3})
    assert (p.rows, p.per, p.parts) == (16, 4, 3)
    assert nmg_spmm.spmm_split_choices(640, bf) == [1, 2, 3, 4, 5, 10]
    assert nmg_spmm.spmm_split_choices(192, bf, most=8) == [1, 2, 3]
    assert 8 not in nmg_spmm.spmm_split_choices(640, torch.float32)


# ---------------------------------------------------------------------------
# routes under any table
# ---------------------------------------------------------------------------

FMT_GRID = [(1, 4, 4, 2), (2, 4, 2, 4), (2, 4, 16, 8), (3, 6, 1, 2)]
SHAPE_GRID = [(16, 192), (5, 100)]
M_GRID = (1, 4, 16, 17, 64)


@pytest.mark.parametrize("fmt", FMT_GRID,
                         ids=lambda f: "{}:{}:{}gr{}".format(*f))
@pytest.mark.parametrize("shape", SHAPE_GRID,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_tuned_matmul_routes(fmt, shape, dtype):
    """Force each route at every M: the forced route's output equals that
    route's own output bit for bit, the two routes agree within the
    tolerance, and the reference under the same table agrees too."""
    n, m, g, gr = fmt
    R, K = shape
    ref, t = _pair(R, K, (n, m, g), gr)
    tdt = _torch_dtype(dtype)
    for M in M_GRID:
        bn = np.random.default_rng(M).standard_normal((K, M))
        b = torch.from_numpy(bn).to(tdt)
        own = {"gemv": tops.nmg_gemv(t, b), "spmm": tops.nmg_spmm(t, b)}
        for forced, route in ((0, "spmm"), (4096, "gemv")):
            routing.set_active_table(_flip_table(t, tdt, forced))
            tops.reset_kernel_counters()
            got = tops.nmg_matmul(t, b)
            assert ("nmg_matmul", f"{route}[table]") in tops.kernel_counters()
            assert torch.equal(got, own[route])
            jtab = JaxTable.for_device()
            jtab.put(jax_shape_key("decode_m_max", K=K, R=R, fmt=(n, m, g),
                                   gr=gr, dtype=dtype), forced)
            jrouting.set_active_table(jtab)
            want = jops.nmg_matmul(ref, jnp.asarray(bn, dtype),
                                   use_pallas=False)
            np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        np.testing.assert_allclose(_np(own["gemv"]), _np(own["spmm"]),
                                   **F32_TOL)
        routing.clear_active_table()
        jrouting.clear_active_table()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tuned_linear_routes(dtype):
    """The serving entry point (weight sparse along its input axis, the
    x.dtype epilogue on both routes): bitwise within one route, within
    one rounding of the output type across routes."""
    _, w = _pair(512, 192, (1, 4, 8), 16, sparse_dim=0)
    w = w.to(dtype=dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for rows in (1, 4, 16, 17, 64):
        x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
            (rows, 192))).to(dtype)
        own = {"gemv": tops.nmg_gemv(w, x.T, out_dtype=dtype,
                                     transpose_out=True),
               "spmm": tops.nmg_spmm(w, x.T, out_dtype=dtype,
                                     transpose_out=True)}
        for forced, route in ((0, "spmm"), (4096, "gemv")):
            routing.set_active_table(_flip_table(w, dtype, forced))
            got = tops.nmg_linear(x, w)
            assert got.dtype == dtype
            assert torch.equal(got, own[route])
        np.testing.assert_allclose(_np(own["gemv"]), _np(own["spmm"]), **tol)


def test_tuned_spmm_block_bitwise_equals_default():
    """The plain SpMM's block cap schedules blocks only: every cap gives
    the default's bits, also through the table lookup."""
    _, t = _pair(16, 192, (2, 4, 2), 4)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (192, 64)).astype(np.float32))
    want = nmg_spmm.nmg_spmm_plain(t, b, block_elems=1 << 22)
    for blk in (1, 1 << 10, 1 << 14, 1 << 26):
        assert torch.equal(nmg_spmm.nmg_spmm_plain(t, b, block_elems=blk),
                           want)
    tab = TuningTable.for_device()
    tab.put("spmm_block_elems", 1 << 10)
    routing.set_active_table(tab)
    assert routing.spmm_block_elems() == (1 << 10, "table")
    assert torch.equal(nmg_spmm.nmg_spmm_plain(t, b), want)


def test_fused_groups_capped_at_the_kernel_tile():
    """A crossover past 16 routes wider x to the GEMV per projection: the
    fused QKV and FFN launches take at most 16 columns."""
    _, w = _pair(64, 128, (1, 4, 8), 16, sparse_dim=0)
    tab = TuningTable.for_device()
    tab.put("decode_m_max", 64)                  # device-wide
    routing.set_active_table(tab)
    ws = (w, w, w)
    assert tops.maybe_fused_qkv(torch.zeros(16, 128), ws) is not None
    assert tops.maybe_fused_ffn(torch.zeros(16, 128), w) is not None
    tops.reset_kernel_counters()
    assert tops.maybe_fused_qkv(torch.zeros(17, 128), ws) is None
    assert tops.maybe_fused_ffn(torch.zeros(24, 128), w) is None
    y = tops.nmg_linear(torch.ones(24, 128), w)
    assert tops.kernel_counters() == {("nmg_linear", "gemv[table]"): 1,
                                      ("nmg_gemv", "plain"): 1}
    assert y.shape == (24, 64)
    for M in (16, 17, 24):
        assert tops.predict_route("mm_fused_qkv", ws=ws, M=M,
                                  dtype=torch.float32, device="cpu")[0] == (
            ("nmg_qkv", "fused[default]") if M <= 16   # no fused entry
            else ("nmg_linear", "gemv[table]"))


# ---------------------------------------------------------------------------
# table mechanics
# ---------------------------------------------------------------------------


def test_bucketing():
    assert [bucket(x) for x in (1, 2, 3, 96, 1024, 1025, 0)] == \
        [1, 2, 4, 128, 1024, 2048, 1]
    k1 = shape_key("decode_m_max", K=1000, R=1024, fmt=(1, 4, 8), gr=64,
                   dtype=torch.float32)
    k2 = shape_key("decode_m_max", K=1024, R=600, fmt=(1, 4, 8), gr=64,
                   dtype=torch.float32)
    assert k1 == k2 == "decode_m_max/K1024/R1024/1:4:8/gr64/float32"
    assert routing.gemv_cuda_key(K=1000, R=7, fmt=(1, 4, 8), gr=64,
                                 dtype=torch.bfloat16) == \
        "gemv_cuda/K1024/1:4:8/gr64/bfloat16"


@pytest.mark.parametrize("fmt,shape,sd", [
    ((1, 4, 8, 16), (512, 192), 0), ((2, 4, 2, 4), (16, 100), 1),
    ((3, 6, 1, 2), (5, 96), 1), ((1, 4, 8, 64), (256, 768), 0)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_keys_equal_reference(fmt, shape, sd, dtype):
    """The same weight in both packages gives the same router context and
    the same key string for every decision kind, and the same bucket."""
    n, m, g, gr = fmt
    ref, t = _pair(*shape, (n, m, g), gr, sparse_dim=sd, dtype=dtype)
    tdt = _torch_dtype(dtype)
    jctx, tctx = jops._route_ctx(ref, dtype), tops._route_ctx(t, tdt)
    assert (jctx["K"], jctx["R"], jctx["fmt"], jctx["gr"]) == \
        (tctx["K"], tctx["R"], tctx["fmt"], tctx["gr"])
    assert dtype_name(tdt) == jnp.dtype(dtype).name
    for kind in ("decode_m_max", "fused_qkv", "fused_ffn", "matmul_latency"):
        assert shape_key(kind, **tctx) == jax_shape_key(kind, **jctx)
    for x in (jctx["K"], jctx["R"], 3, 4097):
        assert bucket(x) == jbench.bucket(x)
    three = (ref, ref, ref)
    assert tops._fused_ctx((t, t, t), tdt)["R"] == \
        jops._fused_ctx(three, dtype)["R"]


def test_table_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "table.json")
    TuningTable(device=CPU, entries={"decode_m_max": 24},
                meta={"note": "test"}).save(path)
    TuningTable(device="torch-cuda:nvidia_h100_80gb_hbm3",
                entries={"decode_m_max": 8}).save(path)
    back = TuningTable.load(path, device=CPU)
    assert back.entries == {"decode_m_max": 24}
    assert back.meta == {"note": "test"}
    assert TuningTable.load(
        path, device="torch-cuda:nvidia_h100_80gb_hbm3").entries == {
        "decode_m_max": 8}
    empty = TuningTable.load(path, device="torch-cuda:other")
    assert len(empty) == 0
    routing.set_active_table(empty)
    assert routing.decode_m_max(K=96, R=8, fmt=(1, 4, 4), gr=2,
                                dtype=torch.float32) == (16, "default")
    merged = TuningTable(device=CPU, entries={"a": 1, "b": 2})
    merged.merge(TuningTable(device=CPU, entries={"b": 3}, meta={"x": 1}))
    assert merged.entries == {"a": 1, "b": 3} and merged.meta == {"x": 1}


def test_device_kinds_never_collide_with_reference():
    assert device_kind("cpu") == CPU
    assert TuningTable.for_device().device == device_kind()
    assert JaxTable.for_device().device != device_kind()
    assert device_kind().startswith("torch-")


def _section_text(section) -> str:
    """A section exactly as either package's save writes it (indent 2,
    sorted keys, nested under "devices")."""
    return "\n".join("    " + line if i else line for i, line in enumerate(
        json.dumps(section, indent=2, sort_keys=True).split("\n")))


def test_one_table_file_shared_with_reference(tmp_path):
    """A file the reference wrote loads in the port (and its section
    survives the port's save byte for byte), and the reverse."""
    path = str(tmp_path / "shared.json")
    jtab = JaxTable.for_device()
    jtab.put("decode_m_max/K256/R4096/1:4:8/gr64/float32", 64)
    jtab.put("convert_cost/CsrTensor->DenseTensor", 13.700000000000001)
    jtab.meta["generated_by"] = "python -m repro.tune --quick"
    jtab.save(path)
    doc = json.loads(open(path).read())
    jtext = _section_text(doc["devices"][jtab.device])
    assert jtext in open(path).read()
    assert len(TuningTable.load(path)) == 0       # no port section yet
    tab = TuningTable.for_device()
    tab.put("decode_m_max/K256/R4096/1:4:8/gr64/float32", 32)
    tab.put("gemv_cuda/K256/1:4:8/gr64/bfloat16", {"rows": 64, "parts": 2})
    tab.save(path)
    text = open(path).read()
    assert jtext in text
    assert json.loads(text)["devices"][jtab.device] == \
        doc["devices"][jtab.device]
    ttext = _section_text(json.loads(text)["devices"][tab.device])
    assert JaxTable.load(path).entries == jtab.entries
    jtab.put("decode_m_max", 3)
    jtab.save(path)
    text = open(path).read()
    assert ttext in text
    back = routing.load_table(path)
    assert back.entries == tab.entries
    assert routing.gemv_cuda_config(K=200, R=1, fmt=(1, 4, 8), gr=64,
                                    dtype=torch.bfloat16) == (
        {"rows": 64, "parts": 2}, "table")


def test_table_schema_mismatch_rejected(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"schema": 999, "devices": {}}))
    with pytest.raises(ValueError, match="schema"):
        TuningTable.load(str(path))


def test_device_wide_override_and_bucket_precedence():
    ctx = dict(K=96, R=8, fmt=(1, 4, 4), gr=2, dtype=torch.float32)
    tab = TuningTable.for_device()
    tab.put("decode_m_max", 3)
    tab.put("gemv_cuda", {"rows": 4, "parts": 1})
    tab.put("spmm_cuda", {"splits": 2})
    tab.put("fused_qkv", False)
    routing.set_active_table(tab)
    assert routing.decode_m_max(**ctx) == (3, "table")
    assert routing.gemv_cuda_config(**ctx) == ({"rows": 4, "parts": 1},
                                               "table")
    assert routing.spmm_cuda_config(**ctx) == ({"splits": 2}, "table")
    assert routing.fused_qkv(**ctx) == (False, "table")
    tab.put(shape_key("decode_m_max", **ctx), 9)
    tab.put(routing.gemv_cuda_key(**ctx), {"rows": 16, "parts": 2})
    tab.put(shape_key("spmm_cuda", **ctx), {"splits": None})
    tab.put(shape_key("fused_qkv", **ctx), True)
    assert routing.decode_m_max(**ctx) == (9, "table")
    assert routing.gemv_cuda_config(**ctx) == ({"rows": 16, "parts": 2},
                                               "table")
    assert routing.spmm_cuda_config(**ctx) == ({"splits": None}, "table")
    assert routing.fused_qkv(**ctx) == (True, "table")
    # the gemv key has no R: any R of the bucket's K reads it
    assert routing.gemv_cuda_config(**{**ctx, "R": 5000})[1] == "table"


def test_route_counters_show_table_provenance():
    _, t = _pair(8, 96, (1, 4, 4), 2)
    routing.set_active_table(_flip_table(t, torch.float32, 2))
    tops.nmg_matmul(t, torch.ones(96, 2))
    tops.nmg_matmul(t, torch.ones(96, 8))
    counts = tops.kernel_counters()
    assert counts.get(("nmg_matmul", "gemv[table]")) == 1
    assert counts.get(("nmg_matmul", "spmm[table]")) == 1
    _, w = _pair(64, 128, (1, 4, 8), 16, sparse_dim=0)
    tab = TuningTable.for_device()
    tab.put("fused_qkv", False)
    tab.put("fused_ffn", False)
    routing.set_active_table(tab)
    tops.reset_kernel_counters()
    assert tops.maybe_fused_qkv(torch.zeros(4, 128), (w, w, w)) is None
    assert tops.maybe_fused_ffn(torch.zeros(4, 128), w) is None
    assert tops.kernel_counters() == {("nmg_qkv", "sequential[table]"): 1,
                                      ("nmg_ffn", "sequential[table]"): 1}


def _ops_case(op, w, M, dtype):
    x = torch.ones(M, w.dense_shape[0], dtype=dtype)
    if op == "nmg_linear":
        tops.nmg_linear(x, w)
    elif op == "nmg_matmul":
        tops.nmg_matmul(w, x.T)
    elif op == "mm_gated":
        if tops.maybe_fused_ffn(x, w) is None:
            tops.nmg_linear(x, w)
    else:
        if tops.maybe_fused_qkv(x, (w, w, w)) is None:
            for _ in range(3):
                tops.nmg_linear(x, w)


@pytest.mark.parametrize("table", ["none", "spmm", "gemv", "vetoes"])
def test_predict_route_equals_counters(table):
    """``predict_route`` names the keys one call records, under the
    default routing and under tables that flip routes and veto fusion."""
    _, w = _pair(64, 128, (1, 4, 8), 16, sparse_dim=0)
    tab = TuningTable.for_device()
    if table in ("spmm", "gemv"):
        tab.put("decode_m_max", 0 if table == "spmm" else 4096)
    if table == "vetoes":
        tab.put("fused_qkv", False)
        tab.put("fused_ffn", False)
    if table != "none":
        routing.set_active_table(tab)
    for op in ("nmg_linear", "nmg_matmul", "mm_gated", "mm_fused_qkv"):
        for M in (1, 4, 16, 17, 40):
            tops.reset_kernel_counters()
            _ops_case(op, w, M, torch.float32)
            want = tops.predict_route(op, w, M=M, dtype=torch.float32,
                                      ws=(w, w, w), device="cpu")
            assert collections.Counter(want) == tops.kernel_counters(), \
                (op, M)


def test_predict_route_names_the_spmm_config_on_the_card():
    """On the card the SpMM body's split config adds its key (gr a
    multiple of 64 only; other gr take the GEMV route)."""
    _, w64 = _pair(128, 256, (1, 4, 8), 64, sparse_dim=0)
    _, w16 = _pair(64, 128, (1, 4, 8), 16, sparse_dim=0)
    keys = tops.predict_route("nmg_linear", w64, M=32, dtype=torch.bfloat16)
    assert keys == [("nmg_linear", "spmm[default]"), ("nmg_spmm", "cuda"),
                    ("nmg_spmm_cuda", "auto[default]")]
    assert tops.predict_route("nmg_linear", w16, M=32,
                              dtype=torch.bfloat16)[-1] == ("nmg_spmm",
                                                             "cuda")
    tab = TuningTable.for_device()
    tab.put(shape_key("spmm_cuda", **tops._route_ctx(w64, torch.bfloat16)),
            {"splits": 2})
    routing.set_active_table(tab)
    assert tops.predict_route("nmg_linear", w64, M=32, dtype=torch.bfloat16
                              )[-1] == ("nmg_spmm_cuda", "splits2[table]")
    assert tops.predict_route("nmg_linear", w64, M=32, dtype=torch.bfloat16,
                              device="cpu") == [
        ("nmg_linear", "spmm[default]"), ("nmg_spmm", "plain")]


# ---------------------------------------------------------------------------
# timing harness and tuners
# ---------------------------------------------------------------------------


def test_measured_crossover():
    def rec(m, g, s):
        return [{"path": "gemv", "M": m, "us": g},
                {"path": "spmm", "M": m, "us": s}]

    recs = (rec(1, 1.0, 2.0) + rec(8, 2.0, 2.01) + rec(32, 9.0, 3.0)
            + rec(64, 9.0, 1.0))
    assert tbench.measured_crossover(recs) == 8
    assert tbench.measured_crossover(rec(32, 9.0, 3.0)
                                     + rec(64, 9.0, 1.0)) == 0
    noisy = (rec(1, 3.0, 1.0) + rec(4, 1.0, 2.0) + rec(8, 1.0, 2.0)
             + rec(16, 9.0, 3.0) + rec(32, 9.0, 3.0))
    assert tbench.measured_crossover(noisy) == 8
    assert tbench.measured_crossover(rec(1, 1.0, 2.0) + rec(4, 9.0, 3.0)
                                     + rec(8, 9.0, 3.0)) == 1


def test_measured_crossover_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ms = sorted(rng.choice([1, 2, 4, 8, 16, 24, 32, 64], size=5,
                               replace=False).tolist())
        recs = [{"path": p, "M": m, "us": float(rng.uniform(1, 3))}
                for m in ms for p in ("gemv", "spmm")]
        assert tbench.measured_crossover(recs) == \
            jbench.measured_crossover(recs)


def test_tune_decode_threshold_writes_bucketed_entries():
    tab = TuningTable.for_device()
    before = tops.counter_snapshot()
    got = tbench.tune_decode_threshold(tab, K=96, R=16, fmt=(1, 4, 4),
                                       gr=2, ms=(1, 3, 4), reps=1,
                                       device="cpu")
    assert tops.counter_snapshot() == before      # sweeps leave no counts
    key = shape_key("decode_m_max", K=96, R=16, fmt=(1, 4, 4), gr=2,
                    dtype=torch.float32)
    assert tab.get(key) == got and got in (0, 1, 3, 4)
    lat = shape_key("matmul_latency", K=96, R=16, fmt=(1, 4, 4), gr=2,
                    dtype=torch.float32)
    assert sorted(k for k in tab.entries if k.startswith(lat)) == \
        [f"{lat}/M1", f"{lat}/M4"]                 # 3 and 4 share bucket 4
    routing.set_active_table(tab)
    us, src = routing.matmul_latency_us(K=96, R=16, fmt=(1, 4, 4), gr=2,
                                        dtype=torch.float32, M=3)
    assert src == "table" and us == tab.get(f"{lat}/M4") > 0


def test_fused_tuners_time_fusable_probes():
    """The fused decisions are measured on probes the fused launches take
    (the serving orientation), and land under the router's keys."""
    tab = TuningTable.for_device()
    tbench.tune_fused_qkv(tab, K=64, Rs=(64, 32, 32), gr=16, reps=1,
                          device="cpu")
    tbench.tune_fused_ffn(tab, K=64, F=32, gr=16, reps=1, device="cpu")
    assert sorted(tab.entries) == [
        "fused_ffn/K64/R64/1:4:8/gr16/float32",
        "fused_qkv/K64/R128/1:4:8/gr16/float32"]
    with pytest.raises(ValueError):
        tbench.tune_fused_ffn(tab, K=64, F=24, gr=16, reps=1, device="cpu")


def test_gated_sweep_times_the_op_the_model_runs():
    """A packed gated weight is swept with its gate: the GEMV side runs
    the fused FFN where the router fuses (M <= 16) and the GEMV plus gate
    past it, the SpMM side the SpMM plus gate; the sweep leaves no
    counts, and its crossover lands under the weight's bucket."""
    t = tbench._probe_tensor(64, 64, (1, 4, 8), 16, device="cpu")
    calls = []
    real_ffn, real_gemv = tops.nmg_ffn, tops.nmg_gemv
    try:
        tops.nmg_ffn = lambda *a, **k: calls.append("ffn") or real_ffn(
            *a, **k)
        tops.nmg_gemv = lambda *a, **k: calls.append("gemv") or real_gemv(
            *a, **k)
        recs = tbench.sweep_m(t, (4, 20), reps=1, gate="silu")
    finally:
        tops.nmg_ffn, tops.nmg_gemv = real_ffn, real_gemv
    assert {(r["path"], r["M"]) for r in recs} == {
        ("gemv", 4), ("spmm", 4), ("gemv", 20), ("spmm", 20)}
    assert "ffn" in calls and "gemv" in calls
    assert tops.kernel_counters() == {}
    tab = TuningTable.for_device()
    thr = tbench.tune_decode_threshold(tab, K=64, R=64, fmt=(1, 4, 8), gr=16,
                                       ms=(4, 20), reps=1, t=t, gate="silu")
    assert tab.get("decode_m_max/K64/R64/1:4:8/gr16/float32") == thr


def test_cuda_tuners_need_the_card():
    tab = TuningTable.for_device()
    with pytest.raises(ValueError, match="CUDA"):
        tbench.tune_gemv_cuda(tab, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tbench.tune_spmm_cuda(tab, device="cpu")
    assert len(tab) == 0


def test_cli_quick_produces_consumable_table(tmp_path, monkeypatch, capsys):
    from repro_torch.tune import __main__ as cli

    monkeypatch.setattr(cli, "SHAPES_QUICK", ((96, 16),))
    monkeypatch.setattr(cli, "FMTS_QUICK", ((1, 4, 4, 2),))
    monkeypatch.setattr(cli, "MS_QUICK", (1, 4, 8))
    real = tbench.tune_spmm_block
    monkeypatch.setattr(cli.bench, "tune_spmm_block", lambda table, **kw:
                        real(table, K=96, R=16, N=16, fmt=(1, 4, 4), gr=2,
                             candidates=(1 << 10, 1 << 12), reps=1))
    real_qkv = tbench.tune_fused_qkv
    monkeypatch.setattr(cli.bench, "tune_fused_qkv", lambda table, **kw:
                        real_qkv(table, K=64, Rs=(64, 64, 64), gr=16,
                                 reps=1, dtype=kw["dtype"],
                                 device=kw["device"]))
    path = str(tmp_path / "tune_table.json")
    assert cli.main(["--quick", "--skip-convert", "--out", path,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decision,key,value" in out and "gemv_cuda,skipped" in out
    with pytest.raises(SystemExit):
        cli.main(["--quick", "--out", path, "--device", "cpu",
                  "--cuda-configs"])
    tab = routing.load_table(path)
    key = shape_key("decode_m_max", K=96, R=16, fmt=(1, 4, 4), gr=2,
                    dtype=torch.float32)
    assert key in tab and "spmm_block_elems" in tab
    assert shape_key("fused_qkv", K=64, R=192, fmt=(1, 4, 8), gr=16,
                     dtype=torch.float32) in tab
    thr, src = routing.decode_m_max(K=96, R=16, fmt=(1, 4, 4), gr=2,
                                    dtype=torch.float32)
    assert src == "table" and thr == tab.get(key)
    _, t = _pair(16, 96, (1, 4, 4), 2)
    tops.nmg_matmul(t, torch.ones(96, 4))
    assert any(k[0] == "nmg_matmul" and k[1].endswith("[table]")
               for k in tops.kernel_counters())


def test_env_var_table_loading(tmp_path, monkeypatch, capsys):
    env_path = str(tmp_path / "env_table.json")
    TuningTable(device=CPU, entries={"decode_m_max": 5}).save(env_path)
    arg_path = str(tmp_path / "arg_table.json")
    TuningTable(device=CPU, entries={"decode_m_max": 7}).save(arg_path)

    monkeypatch.delenv(routing.ENV_TABLE, raising=False)
    assert routing.load_table_cli(None, verbose=False) is None
    assert routing.active_table() is None

    monkeypatch.setenv(routing.ENV_TABLE, env_path)
    tab = routing.load_table_cli(None, device=CPU)
    assert tab is not None and tab.get("decode_m_max") == 5
    assert routing.active_table() is tab
    assert f"tuning: loaded 1 entries for {CPU}" in capsys.readouterr().out

    tab = routing.load_table_cli(arg_path, verbose=False, device=CPU)
    assert tab.get("decode_m_max") == 7

    bad = tmp_path / "bad.json"
    bad.write_text("{ not json")
    monkeypatch.setenv(routing.ENV_TABLE, str(bad))
    routing.clear_active_table()
    assert routing.load_table_cli(None, verbose=False) is None
    assert routing.active_table() is None
    bad.write_text(json.dumps({"schema": 999, "devices": {}}))
    assert routing.load_table_cli(None, verbose=False) is None
    monkeypatch.setenv(routing.ENV_TABLE, str(tmp_path / "missing.json"))
    assert routing.load_table_cli(None, verbose=False) is None
    with pytest.raises(ValueError):
        routing.load_table_cli(str(bad), verbose=False)


def test_corrupt_table_load_is_robust(tmp_path):
    good = tmp_path / "good.json"
    TuningTable(device=CPU, entries={"decode_m_max": 5}).save(str(good))
    tab = routing.load_table(str(good))
    assert tab is not None and routing.active_table() is tab
    before = routing.table_load_events()
    truncated = tmp_path / "trunc.json"
    truncated.write_text(good.read_text()[: len(good.read_text()) // 2])
    with pytest.warns(RuntimeWarning, match="shipped defaults"):
        assert routing.load_table(str(truncated)) is None
    assert routing.active_table() is tab
    assert routing.table_load_events()[("table", "load_failed")] == \
        before.get(("table", "load_failed"), 0) + 1
    assert routing.decode_m_max(K=96, R=8, fmt=(1, 4, 4), gr=2,
                                dtype=torch.float32) == (5, "table")
    with pytest.raises(ValueError):
        routing.load_table_cli(str(truncated), verbose=False)


# ---------------------------------------------------------------------------
# dispatcher conversion-cost tie-breaker
# ---------------------------------------------------------------------------


def test_dispatch_cost_model_breaks_conversion_ties():
    """Two implementations one lossless conversion away from a FixedMask
    operand: registration order without a cost model, the measured-cheaper
    conversion with one, registration order again after clearing."""
    from repro_torch.core.layouts import CooTensor, CsrTensor, \
        DenseTensor, FixedMaskTensor

    calls = []

    @tdisp.register_op_impl("tune_probe_op", inp=(CsrTensor, DenseTensor))
    def _csr_impl(a, b):
        calls.append("csr")
        return torch.zeros(())

    @tdisp.register_op_impl("tune_probe_op", inp=(CooTensor, DenseTensor))
    def _coo_impl(a, b):
        calls.append("coo")
        return torch.zeros(())

    try:
        fm = FixedMaskTensor.from_dense(torch.eye(4))
        x = torch.ones(4, 4)
        tdisp.dispatch("tune_probe_op", fm, x)
        assert calls == ["csr"]
        tab = TuningTable.for_device()
        tab.put("convert_cost/FixedMaskTensor->CooTensor", 1.0)
        routing.set_active_table(tab)
        assert tdisp.conversion_cost_model() is routing.conversion_cost
        calls.clear()
        tdisp.dispatch("tune_probe_op", fm, x)
        assert calls == ["csr"]        # a partial measurement breaks no tie
        assert not any(k[0] == "cost_model_override"
                       for k in tdisp.dispatch_counters())
        tab.put("convert_cost/FixedMaskTensor->CsrTensor", 100.0)
        calls.clear()
        tdisp.dispatch("tune_probe_op", fm, x)
        assert calls == ["coo"]
        assert any(k[0] == "cost_model_override"
                   for k in tdisp.dispatch_counters())
        routing.clear_active_table()
        assert tdisp.conversion_cost_model() is None
        calls.clear()
        tdisp.dispatch("tune_probe_op", fm, x)
        assert calls == ["csr"]
    finally:
        for k in [k for k in tdisp.sparse_op_table()
                  if k[0] == "tune_probe_op"]:
            del tdisp._OP_IMPLS[k]


@pytest.mark.parametrize("costs,want", [
    ({}, "CsrTensor"),
    ({"CooTensor->FixedMaskTensor": 1.0}, "CsrTensor"),
    ({"CooTensor->FixedMaskTensor": 1.0, "CooTensor->CsrTensor": 5.0},
     "FixedMaskTensor"),
    ({"CooTensor->FixedMaskTensor": 9.0, "CooTensor->CsrTensor": 5.0},
     "CsrTensor")])
def test_dispatch_picks_reference_conversion_under_one_table(tmp_path, costs,
                                                             want):
    """One table file with the same measured costs in each package's
    section: both dispatchers route a (COO, Dense) matmul the same way."""
    from repro.core import layouts as jl
    from repro.core.dispatch import predict_route as jax_predict
    from repro_torch.core import layouts as tl

    path = str(tmp_path / "costs.json")
    entries = {f"convert_cost/{k}": v for k, v in costs.items()}
    JaxTable(device=JaxTable.for_device().device, entries=entries).save(path)
    TuningTable(device=CPU, entries=entries).save(path)
    jrouting.load_table(path)
    routing.load_table(path, device=CPU)
    got = tdisp.predict_route("matmul", (tl.CooTensor, tl.DenseTensor))
    ref = jax_predict("matmul", (jl.CooTensor, jl.DenseTensor))
    assert got == ref and got["target_sig"][0] == want


def test_tune_conversion_costs_feed_the_dispatcher():
    tab = TuningTable.for_device()
    got = tbench.tune_conversion_costs(tab, side=16, reps=1, device="cpu")
    assert len(got) == 12 and all(v > 0 for v in got.values())
    routing.set_active_table(tab)
    from repro_torch.core.layouts import CsrTensor, DenseTensor

    assert routing.conversion_cost(CsrTensor, DenseTensor) == \
        got["convert_cost/CsrTensor->DenseTensor"]
    assert routing.conversion_cost(DenseTensor, DenseTensor) is None


def test_conversion_tuner_and_probe_default_to_the_card():
    """``tune_conversion_costs`` and the probe weights measure on the card
    unless told otherwise: without one they raise ``resolve_device``'s
    error instead of timing the CPU under a card's name; the plain SpMM's
    block tuner, which serves the CPU only, keeps the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    tab = TuningTable.for_device()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tbench.tune_conversion_costs(tab, side=16, reps=1)
    assert not tab.entries
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tbench._probe_tensor(64, 64, (1, 4, 8), 16)
    assert tbench.tune_spmm_block(tab, K=64, R=64, N=8, gr=16,
                                  candidates=(1 << 10,), reps=1) == 1 << 10


# ---------------------------------------------------------------------------
# serving warmup hook and CLIs
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in (8, 20)]


def test_warmup_hook_tunes_engine_shapes():
    """``warmup_engine(tune=True)`` tunes each distinct n:m:g weight shape
    of the engine, activates the table before the engine's programs are
    built, routes every projection with table provenance, leaves no
    tuning launches in the counters, and serves the tokens the default
    routing serves."""
    from repro_torch.serve import Request, ServeEngine, warmup_engine

    _, tcfg, _, tp = smoke_setup(True)
    kw = dict(max_slots=3, max_seq_len=32, decode_chunk=2, device="cpu")

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(_prompts(tcfg.vocab))]

    want = [o.tokens for o in ServeEngine(tp, tcfg, **kw).run(requests())]
    routed = [k for k in tops.kernel_counters() if k[0] == "nmg_linear"]
    assert routed and all(k[1].endswith("[default]") for k in routed)

    eng = ServeEngine(tp, tcfg, **kw)
    tops.reset_kernel_counters()
    before = dict(tops.kernel_counters())
    from repro_torch.tune.bench import autotune_for_serving

    tab = autotune_for_serving(tp, max_slots=3, prompt_lens=[8, 20],
                               reps=1, activate=False)
    assert tops.kernel_counters() == before and routing.active_table() is None
    shapes = {shape_key("decode_m_max", **tops._route_ctx(w, torch.float32))
              for w in (tp["layers"]["attn"][k].layer(0)
                        for k in ("wq", "wk", "wv", "wo"))}
    shapes |= {shape_key("decode_m_max", **tops._route_ctx(
        tp["layers"]["mlp"][k].layer(0), torch.float32)) for k in ("wi", "wo")}
    assert {k for k in tab.entries if k.startswith("decode_m_max/")} == shapes
    assert any(k.startswith("fused_qkv/") for k in tab.entries)

    warmup_engine(eng, requests(), tune=True, tune_reps=1)
    assert routing.active_table() is not None
    tops.reset_kernel_counters()
    got = [o.tokens for o in eng.run(requests())]
    counts = tops.kernel_counters()
    routed = [k for k in counts if k[0] in ("nmg_linear", "nmg_qkv")
              and "[" in k[1]]
    assert routed and all(k[1].endswith("[table]") for k in routed), counts
    assert got == want


def test_serve_cli_loads_and_tunes(tmp_path, capsys):
    from repro_torch.launch import serve as launch

    path = str(tmp_path / "t.json")
    TuningTable(device=CPU, entries={"decode_m_max": 8}).save(path)
    args = ["--arch", "bert-base-sten", "--smoke", "--engine", "--sparse",
            "--nm", "1:4:8", "--device", "cpu", "--requests", "2",
            "--gen-len", "2", "--prompt-len", "8"]
    assert launch.main(args + ["--tuning-table", path]) == 0
    assert f"tuning: loaded 1 entries for {CPU} from {path}" in \
        capsys.readouterr().out
    routing.clear_active_table()
    assert launch.main(args + ["--tune"]) == 0
    assert any(k.startswith("decode_m_max/")
               for k in routing.active_table().entries)
    with pytest.raises(SystemExit):
        launch.main(args + ["--tune", "--no-warmup"])
    with pytest.raises(ValueError):
        launch.main(args + ["--tuning-table", str(tmp_path / "none.json")])


def test_train_cli_loads_the_table_first(tmp_path, capsys):
    from repro_torch.launch import train as ttrain

    path = str(tmp_path / "t.json")
    TuningTable(device=CPU, entries={"decode_m_max": 8}).save(path)
    assert ttrain.parse_args(["--tuning-table", path]).tuning_table == path
    with pytest.raises(ValueError):
        ttrain.run(ttrain.parse_args(["--smoke", "--device", "cpu",
                                      "--tuning-table",
                                      str(tmp_path / "none.json")]))
    out = ttrain.run(ttrain.parse_args([
        "--smoke", "--device", "cpu", "--steps", "1", "--batch", "1",
        "--seq", "8", "--host-loop", "--tuning-table", path]))
    assert out["rc"] == 0
    assert f"tuning: loaded 1 entries for {CPU}" in capsys.readouterr().out
    assert routing.active_table().get("decode_m_max") == 8
