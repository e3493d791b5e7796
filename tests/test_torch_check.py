"""The port's static checker (``repro_torch.check``) against the
reference's (``repro.check``) at the check config, on the CPU:

* every rule R1-R7: the port's trigger fixture yields the rule ids and
  severities of the reference's trigger, under ``--strict`` a nonzero
  exit, and each clean fixture none (the registry and the fixtures in
  lockstep, the rules' ids, names and severities the reference's);
* ``--ignore`` suppresses, ``--strict`` fails on warnings, errors fail
  without it;
* the ``serve`` and ``train`` entries of bert-base-sten: the reference's
  program names, no diagnostic, every kernel call one node named after
  its kernel;
* the CLI: the reference's JSON report keys, ``--device cuda`` (the
  default) raising without a card;
* the differential: no ``DIFF``, the router's keys the reference's;
* R6: estimates carry ``default`` / ``table`` provenance, and the
  estimator is held to values worked by hand from the CUDA formulas
  (``csrc/nmg_rows.cuh:tc::smem_bytes``, ``csrc/nmg_spmm.cu:
  tc_smem_bytes`` / ``tc_shape``) at the ``tc`` and ``rows`` decode
  bodies, the FFN, and the SpMM's staged, unstaged and GEMV-routed
  shapes."""

import json
import math

import pytest
import torch

from repro.check import run_check as j_run_check
from repro.check.diagnostics import Diagnostic as JDiagnostic
from repro.check.differential import _predicted_keys as j_predicted_keys
from repro.check.entries import check_config as j_check_config
from repro.check.fixtures import FIXTURES as J_FIXTURES
from repro.check.rules import all_rules as j_all_rules, \
    run_rules as j_run_rules
from repro_torch.check import Report, Severity, run_check
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.differential import differential_check
from repro_torch.check.fixtures import FIXTURES, R6_CONFIG, R6_SHAPE
from repro_torch.check.program import build_program
from repro_torch.check.rules import all_rules, run_rules
from repro_torch.check.static_pass import gemv_smem, spmm_smem
from repro_torch.core.layouts import GroupedNMTensor
from repro_torch.kernels import ops as tops
from repro_torch.launch.hw import HW_BY_KIND
from repro_torch.tune import routing
from repro_torch.tune.table import TuningTable

CPU = "torch-cpu:cpu"


@pytest.fixture(autouse=True)
def _port_state():
    """The port's counters and tuning table, reset around each test (the
    conftest fixture resets the reference's)."""
    tops.reset_kernel_counters()
    routing.clear_active_table()
    yield
    routing.clear_active_table()


def _ids(diags) -> set:
    return {(d.rule, d.severity.name) for d in diags}


# ---------------------------------------------------------------------------
# the registry and the fixtures
# ---------------------------------------------------------------------------


def test_every_rule_has_trigger_and_clean_fixture():
    missing = {rid for rid in all_rules()
               if rid not in FIXTURES
               or not callable(FIXTURES[rid].get("trigger"))
               or not callable(FIXTURES[rid].get("clean"))}
    assert not missing, f"rules without a fixture pair: {sorted(missing)}"


def test_every_fixture_names_a_registered_rule():
    assert set(FIXTURES) == set(all_rules()) == set(J_FIXTURES)


def test_rule_metadata_is_complete_and_the_references():
    ref = j_all_rules()
    for rid, rule in all_rules().items():
        assert rule.rule_id == rid
        assert rule.name and rule.description and rule.detectors
        assert (rule.name, rule.severity.name) == \
            (ref[rid].name, ref[rid].severity.name)


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_trigger_fixture_fails_as_the_references(rule_id):
    prog = FIXTURES[rule_id]["trigger"]()
    diags = run_rules(prog)
    hits = [d for d in diags if d.rule == rule_id]
    assert hits, f"{rule_id} trigger fixture produced no {rule_id}"
    assert Report(diags).exit_code(strict=True) != 0
    for d in hits:
        assert d.severity == all_rules()[rule_id].severity
        assert d.entry and d.message
    assert _ids(diags) == _ids(j_run_rules(J_FIXTURES[rule_id]["trigger"]()))


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_clean_fixture_passes_as_the_references(rule_id):
    prog = FIXTURES[rule_id]["clean"]()
    assert not [d for d in run_rules(prog) if d.rule == rule_id]
    assert not [d for d in j_run_rules(J_FIXTURES[rule_id]["clean"]())
                if d.rule == rule_id]


def test_error_rules_fail_even_without_strict():
    report = Report(run_rules(FIXTURES["R1"]["trigger"](), rules=["R1"]))
    assert report.exit_code(strict=False) != 0


def test_warning_rules_fail_only_under_strict():
    report = Report(run_rules(FIXTURES["R2"]["trigger"](), rules=["R2"]))
    assert report.exit_code(strict=False) == 0
    assert report.exit_code(strict=True) != 0


def test_ignore_suppresses_rule():
    report = Report(run_rules(FIXTURES["R2"]["trigger"](), rules=["R2"]))
    assert report.filtered(["R2"]).exit_code(strict=True) == 0
    assert report.filtered(["R2:nomatch-*"]).exit_code(strict=True) != 0
    assert report.filtered(["R2:fixture/*"]).exit_code(strict=True) == 0


def test_r1_trigger_and_clean_graphs():
    """The trigger's densified weight reaches an ``aten.mm``; the clean
    program's product is one ``nmg_gemv`` node (the plain version that
    ran for it on the CPU is not in the graph)."""
    trig = FIXTURES["R1"]["trigger"]().graph
    assert any(n.op == "aten.scatter_add_" for n in trig.nodes)
    clean = FIXTURES["R1"]["clean"]().graph
    assert [n.op for n in clean.kernels()] == ["nmg_gemv"]
    assert not any(n.op in ("aten.mm", "aten.bmm", "aten.index")
                   for n in clean.nodes)


def test_r4_capture_not_run_on_the_cpu():
    prog = FIXTURES["R4"]["trigger"]()
    assert prog.capture["captured"] is False
    assert prog.capture["error"].startswith("not run")
    assert [d.location for d in run_rules(prog, rules=["R4"])] == \
        ["graph:loop-body"] * 2


# ---------------------------------------------------------------------------
# the real entries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_entries():
    return j_run_check(("serve", "train"), arch="bert-base-sten", hlo=False)


@pytest.fixture(scope="module")
def port_entries():
    return run_check(("serve", "train"), arch="bert-base-sten", hlo=False,
                     device="cpu")


def test_entries_clean_with_the_references_programs(reference_entries,
                                                    port_entries):
    assert port_entries.programs == reference_entries.programs
    assert port_entries.render() == "" == reference_entries.render()
    assert port_entries.exit_code(strict=True) == 0
    assert any(":decode" in p for p in port_entries.programs)
    assert any(":prefill" in p for p in port_entries.programs)


def test_serve_entry_kernels_are_nodes():
    """Each program's n:m:g products are kernel nodes (decode the GEMV at
    4 slots, prefill the SpMM at 24 tokens), two per layer (``mlp.wi``,
    ``mlp.wo``), and no dense matmul reads a weight of theirs."""
    from repro_torch.check.entries import check_config, entry_programs

    L = check_config().n_layers
    progs = {p.name.split(":")[-1]: p
             for p in entry_programs("serve", hlo=False, device="cpu")}
    kinds = {k: [n.op for n in p.graph.kernels()] for k, p in progs.items()}
    assert kinds["decode"] == ["nmg_gemv"] * 2 * L
    assert kinds["decode_chunk"] == ["nmg_gemv"] * 2 * L * 4
    assert kinds["prefill"] == ["nmg_spmm"] * 2 * L
    for p in progs.values():
        cons = p.graph.consumers()
        read_by = {c.op for n in p.graph.nodes
                   if n.kind == "input" and ".mlp.w" in n.name
                   for c in cons.get(n.index, [])}
        assert read_by <= {"aten.select", "nmg_gemv", "nmg_spmm"}, read_by
    assert all(p.capture is None for p in progs.values())
    assert {e["kernel"] for e in progs["prefill"].smem_estimates} == \
        {"nmg_spmm"}


def test_cli_json_report_has_the_references_keys(tmp_path,
                                                 reference_entries):
    out = tmp_path / "report.json"
    rc = check_main(["--entry", "decode", "--no-hlo", "--json", str(out),
                     "--strict", "--device", "cpu"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert set(doc) == set(reference_entries.to_json())
    assert doc["errors"] == 0 and doc["programs"]
    assert isinstance(doc["diagnostics"], list)
    got = FIXTURES["R2"]["trigger"]()
    (d,) = run_rules(got, rules=["R2"])
    assert set(d.to_dict()) == set(JDiagnostic(
        rule="R2", severity=d.severity, entry="e", message="m").to_dict())


def test_cli_ignore_and_strict(capsys):
    """``--strict`` passes the clean train entry, ``--ignore`` taken (the
    Report's suppression and strictness: the tests above)."""
    assert check_main(["--entry", "train", "--no-hlo", "--device", "cpu",
                       "--strict", "--ignore", "R5"]) == 0
    assert "1 program(s) checked" in capsys.readouterr().out


def test_cli_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        check_main(["--entry", "decode", "--no-hlo"])


# ---------------------------------------------------------------------------
# the differential
# ---------------------------------------------------------------------------


def test_differential_static_vs_runtime_agree():
    """No ``DIFF``, and the router's keys the engine recorded are the ones
    the reference predicts for its own check-config weights (its
    prediction runs nothing; its warm-up would count traces, which a jit
    cache shared with its own tests could hide)."""
    import jax

    from repro.models import init_lm as j_init_lm
    from repro.serve.engine import sparsify_for_serving as j_sparsify

    diags, detail = differential_check(device="cpu")
    assert detail["agree"], "\n".join(d.render() for d in diags)
    assert detail["predicted"] == detail["observed"]
    assert any("gemv" in k for k in detail["observed"])
    assert any("spmm" in k for k in detail["observed"])
    assert "('nmg_gemv', 'plain')" in detail["observed"]
    jcfg = j_check_config()
    jsparse = j_sparsify(j_init_lm(jax.random.PRNGKey(0), jcfg), 1, 4, 8,
                         gr=64)
    want = sorted(map(str, j_predicted_keys(jcfg, jsparse,
                                            detail["widths"])))
    assert [k for k in detail["observed"] if "nmg_linear" in k] == want


# ---------------------------------------------------------------------------
# R6: provenance and the estimator
# ---------------------------------------------------------------------------


def _meta_weight(K, R, gr=64, dtype=torch.bfloat16, fmt=(1, 4, 8)):
    """A weight with the storage shapes of ``GroupedNMTensor.from_dense``
    on the meta device: the estimator reads shapes, never values."""
    n, m, g = fmt
    C = math.comb(m, n)
    K_pad = -(-K // (m * C * g)) * (m * C * g)
    R_pad = -(-R // gr) * gr
    return GroupedNMTensor(
        val=torch.empty((R_pad, K_pad // m, n), dtype=dtype, device="meta"),
        blk_idx=torch.empty((R_pad // gr, K_pad // (m * C * g), C * g),
                            dtype=torch.int32, device="meta"),
        n=n, m=m, g=g, gr=gr, dense_shape=(K, R), sparse_dim=0)


def test_smem_estimates_carry_provenance():
    w = _meta_weight(2560, 2560)
    tab = TuningTable(device=CPU, entries={
        "gemv_cuda": {"rows": 32, "parts": 4}, "spmm_cuda": {"splits": 2}})
    routing.set_active_table(tab)
    try:
        prog = build_program("t/prov", lambda x: x,
                             (torch.ones((2, 8), dtype=torch.bfloat16),),
                             model_dtype=torch.bfloat16,
                             sparse_weights={"w": w}, decode_m=4,
                             prefill_n=24)
    finally:
        routing.clear_active_table()
    gemv, spmm = prog.smem_estimates
    assert (gemv["source"], gemv["config"]) == \
        ("table", {"rows": 32, "parts": 4})
    assert (spmm["source"], spmm["config"]) == ("table", {"splits": 2})
    assert gemv["bytes"] <= gemv["budget"] == 232_448
    default = build_program("t/prov", lambda x: x,
                            (torch.ones((2, 8), dtype=torch.bfloat16),),
                            model_dtype=torch.bfloat16,
                            sparse_weights={"w": w}, decode_m=4)
    (est,) = default.smem_estimates
    assert (est["source"], est["config"]) == ("default", None)


# Hand-worked from the CUDA formulas.  Decode ``tc`` body, 1:4:8 at gr 64:
# a chunk's cs = 1*4*8 = 32 stored values cover cx = 4*4*8 = 128 rows of
# B, so a part of `per` slabs stages a window of pitch 2*per*128 = 256*per
# (tc::window_pitch), and
#   smem = min(per, 4)*nw*rows*64*2          ring
#        + nw*8*nt8*(per*64 + 8)*2           gathered B
#        + ceil4(parts*nw*ceil(rows/parts)*m)*4   part sums
#        + m*wp*2 + nw*per*64*4              window, plan entries
# with m = min(M, 16), nt8 = 1 for m <= 8 else 2, and row_plan's own
# plan: nslab = KN/64, per = ceil(nslab/min(8, ceil(nslab/2))).
GEMV_CASES = [
    # K, R, M, kind, config, dtype, gr -> dynamic bytes
    # K 768: KN 192, nslab 3, per 2, parts 2; 2*64*64*2 + 8*136*2 +
    # 256*4 + 4*512*2 + 2*64*4
    (768, 3072, 4, "gemv", None, "bf16", 64, 16384 + 2176 + 1024 + 4096
     + 512),
    # K 3072: nslab 12, per 2, parts 6, nt8 2; recv 6*11*16 = 1056 floats
    (3072, 768, 16, "gemv", None, "bf16", 64, 16384 + 4352 + 4224 + 16384
     + 512),
    # K 2560: nslab 10, per 2, parts 5; recv 5*13*8 = 520 floats
    (2560, 2560, 8, "gemv", None, "bf16", 64, 16384 + 2176 + 2080 + 8192
     + 512),
    # a table's {rows 32, parts 4} at K 2560: per 3, window pitch 768;
    # 3*32*64*2 + 8*200*2 + 4*8*4*4 + 4*768*2 + 3*64*4
    (2560, 2560, 4, "gemv", {"rows": 32, "parts": 4}, "bf16", 64,
     12288 + 3200 + 512 + 6144 + 768),
    # the R6 trigger's {rows 64, parts 1} at K 8192, M 16: per 32, pitch
    # 8192; 4*64*64*2 + 16*2056*2 + 64*16*4 + 16*8192*2 + 32*64*4
    (8192, 64, 16, "gemv", {"rows": 64, "parts": 1}, "bf16", 64,
     32768 + 65792 + 4096 + 262144 + 8192),
    # fused FFN (nw 2), qwen's packed wi [2560, 13824]: per 2, parts 5;
    # 2*2*64*64*2 + 2*8*136*2 + 5*2*13*4*4 + 4*512*2 + 2*2*64*4
    (2560, 13824, 4, "ffn", None, "bf16", 64, 32768 + 4352 + 2080 + 4096
     + 1024),
    # the same at M 16 (nt8 2): recv 5*2*13*16 = 2080 floats
    (2560, 13824, 16, "ffn", None, "bf16", 64, 32768 + 8704 + 8320 + 16384
     + 1024),
    # the f32 ``rows`` body and the bf16 ``general`` body (gr 24): no
    # dynamic shared memory
    (768, 3072, 4, "gemv", None, "f32", 64, 0),
    (768, 48, 4, "gemv", None, "bf16", 24, 0),
]

# SpMM, bf16 body (tc_shape / tc_smem_bytes): row_warps 4 (8 at gr a
# multiple of 128); staged tiles at most 32 columns, unstaged 64; N cut
# into equal tiles padded to 8 (nt8 = tile/8);
#   smem = 4*(16*row_warps*72*2 + 64*4 + [staged] 8*nt8*256*2)
#        + 2*8*nt8*72*2
SPMM_CASES = [
    # K, R, N, config, dtype, gr -> dynamic bytes
    # N 24 staged: one tile of 24, nt8 3: 4*(9216 + 256 + 12288) + 6912
    (768, 3072, 24, None, "bf16", 64, 4 * 21760 + 6912),
    # a table's {splits 2}: the split moves no byte of the block
    (768, 3072, 24, {"splits": 2}, "bf16", 64, 4 * 21760 + 6912),
    # N 64 staged: two tiles of 32, nt8 4: 4*(9216 + 256 + 16384) + 9216
    (768, 3072, 64, None, "bf16", 64, 4 * 25856 + 9216),
    # K 1500 (B rows not 16-byte aligned: unstaged), N 64: one tile of
    # 64, nt8 8: 4*(9216 + 256) + 18432
    (1500, 1280, 64, None, "bf16", 64, 4 * 9472 + 18432),
    # gr 128: row_warps 8, N 24: 4*(18432 + 256 + 12288) + 6912
    (2560, 2560, 24, None, "bf16", 128, 4 * 30976 + 6912),
    # gr 16 takes the GEMV kernel over 16-column chunks: rows 16, per 2,
    # parts 2, nt8 2; 2*16*64*2 + 8*2*136*2 + 2*8*16*4 + 16*512*2 + 512
    (768, 3072, 24, None, "bf16", 16, 4096 + 4352 + 1024 + 16384 + 512),
    # the f32 body: static shared memory only
    (768, 3072, 24, None, "f32", 64, 0),
]

_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("K,R,M,kind,config,dtype,gr,want", GEMV_CASES)
def test_gemv_estimate_equals_the_cuda_formula(K, R, M, kind, config, dtype,
                                               gr, want):
    w = _meta_weight(K, R, gr=gr, dtype=_DT[dtype])
    if config is not None:
        routing.set_active_table(TuningTable(
            device=CPU, entries={"gemv_cuda": config}))
    est = gemv_smem(w, _DT[dtype], M, CPU, weight="w", ffn=kind == "ffn")
    assert est["kernel"] == ("nmg_ffn" if kind == "ffn" else "nmg_gemv")
    assert est["error"] is None and est["dynamic_bytes"] == want
    assert est["source"] == ("default" if config is None else "table")


@pytest.mark.parametrize("K,R,N,config,dtype,gr,want", SPMM_CASES)
def test_spmm_estimate_equals_the_cuda_formula(K, R, N, config, dtype, gr,
                                               want):
    w = _meta_weight(K, R, gr=gr, dtype=_DT[dtype])
    if config is not None:
        routing.set_active_table(TuningTable(
            device=CPU, entries={"spmm_cuda": config}))
    est = spmm_smem(w, _DT[dtype], N, CPU, weight="w")
    assert est["kernel"] == "nmg_spmm"
    assert est["error"] is None and est["dynamic_bytes"] == want


def test_r6_refused_configs_are_errors():
    """A config the kernel refuses is an R6 ERROR without an estimate: a
    split past the slab count, and a tc config on the f32 rows body."""
    w = _meta_weight(768, 3072)
    routing.set_active_table(TuningTable(
        device=CPU, entries={"spmm_cuda": {"splits": 5}}))
    est = spmm_smem(w, torch.bfloat16, 24, CPU)
    assert est["bytes"] is None and "5 splits" in est["error"]
    routing.set_active_table(TuningTable(
        device=CPU, entries={"gemv_cuda": dict(R6_CONFIG)}))
    est = gemv_smem(_meta_weight(768, 3072, dtype=torch.float32),
                    torch.float32, 4, CPU)
    assert est["bytes"] is None and "rows=4" in est["error"]


def test_r6_trigger_overruns_the_h100_budget():
    K, R, M = R6_SHAPE
    trig = FIXTURES["R6"]["trigger"]()
    (est,) = trig.smem_estimates
    assert est["config"] == R6_CONFIG and est["M"] == M
    assert est["bytes"] == 372_992 > HW_BY_KIND[CPU]["smem_per_block_bytes"]
    (d,) = run_rules(trig, rules=["R6"])
    assert d.severity == Severity.ERROR and "372992 B" in d.message
