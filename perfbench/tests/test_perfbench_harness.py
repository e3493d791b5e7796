"""The harness: driven by data (a cell, a configuration and a metric
dropped in as files are found with no code edited), the result line's
schema, the import check on whole top-level names, and BENCHMARK.json
against the shape it must have."""

import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import perfbench_sizes as sizes
from perfbench import bench

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_forbidden_modules_compare_whole_top_level_names():
    mods = dict.fromkeys(["repro_torch", "repro_torch.serve", "reprox",
                          "repro", "repro.models", "jax", "jaxlib.xla",
                          "flax.linen", "jax_like", "numpy"])
    assert bench.forbidden_modules(mods) == [
        "flax.linen", "jax", "jaxlib.xla", "repro", "repro.models"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & set(bench.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_result_line_schema_and_checks_last():
    line = bench.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"out_tok_s": {"value": 1.5, "unit": "tokens/s"}},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 1},
        checks={"served_gap_mean": {"value": 0.001, "limit": 0.01}},
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.2]]})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"]


def test_report_on_a_cpu_run_gives_the_cells_metrics(monkeypatch):
    sys.path.insert(0, str(PB))
    import run as entry

    res = _serve_cpu(sizes.serve_config(), sizes.decode_mix())

    class FakeCuda:
        @staticmethod
        def get_device_name(i):
            return "cpu-test"

    monkeypatch.setattr(torch, "cuda", FakeCuda)
    spec = bench.spec()
    d = json.loads(entry.report(torch, spec, "sc2-nmg.decode", 1, res, False))
    assert set(d["metrics"]) == {"out_tok_s", "setup_s"}
    assert d["correct"] is True and list(d)[-1] == "checks"


def _serve_cpu(conf, mix, limits=None, seconds=1.0):
    from perfbench import serve

    return serve.run(torch, {"config": conf, "traffic": mix,
                             "limits": limits or {"served_gap_mean": 0.01},
                             "seed": 2 ** 31 + 77, "seconds": seconds,
                             "trace": False, "device": "cpu",
                             "t_start": time.perf_counter()})


def test_a_cell_config_and_metric_dropped_in_as_files(tmp_path):
    """A new configuration, traffic mix, cell, limits and per-layer metric
    reader, each a new file beside copies of the harness: found by name,
    run, and read, with no code edited."""
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "perfbench" / "configs" / "tiny.nmg.json").write_text(
        json.dumps(sizes.serve_config()))
    (root / "perfbench" / "traffic" / "short.json").write_text(
        json.dumps(sizes.decode_mix()))
    (root / "perfbench" / "limits" / "tiny.short.json").write_text(
        json.dumps({"served_gap_mean": 0.01}))
    (root / "perfbench" / "metrics" / "tokens_per_request.py").write_text(
        "def read(ctx):\n"
        "    recs = ctx['records']\n"
        "    return sum(len(t) for _, _, t in recs) / len(recs) if recs "
        "else None\n")
    spec["configs"].append({"name": "tiny.nmg", "source": "x",
                            "file": "perfbench/configs/tiny.nmg.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.short", "config": "tiny.nmg",
                              "traffic": "short", "chips": 1, "why": "t"})
    spec["end_to_end"][0]["workloads"].append("tiny.short")
    spec["per_layer"].append({"name": "tokens_per_request.batch",
                              "unit": "tokens", "better": "higher",
                              "source": "program_counter", "layer": "x",
                              "moves": "out_tok_s",
                              "workloads": ["tiny.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = bench.spec(root)
    files = bench.cell_files(spec, "tiny.short", root)
    assert files["traffic"]["backlog"] == sizes.decode_mix()["backlog"]
    assert [m["name"] for m in bench.metrics_for(spec, "tiny.short", False)] \
        == ["out_tok_s", "setup_s"]
    per = [m["name"] for m in bench.metrics_for(spec, "tiny.short", True)]
    assert per == ["tokens_per_request.batch"]
    res = _serve_cpu(files["config"], files["traffic"], files["limits"])
    value = bench.reader(per[0], root).read(res["ctx"])
    assert value is not None and value > 1
    assert all(c["ok"] for c in res["checks"].values())


def test_readers_fall_back_to_the_shared_reader():
    assert bench.reader("idle_share.train").__file__.endswith("idle_share.py")
    assert bench.reader("engine.admit_share.batch").__file__.endswith(
        "engine.admit_share.py")
    assert bench.kernel_names("nmg")[:2] == ["nmg_gemv", "nmg_ffn"]


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"] and 1 <= spec["run_seconds"] <= 51
    confs = {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).exists()
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in confs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    layers: dict = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert bench.reader(m["name"]) is not None
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], m["layer"])
    for w in cells:
        got = [n for n, m in e2e.items() if w in m.get("workloads", [w])]
        assert "setup_s" in got and len(got) >= 2
        assert bench.metrics_for(spec, w, True)


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "sc2-nmg.decode", "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    bare = tmp_path / "bare"
    shutil.copytree(PB, bare / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    p = subprocess.run(cmd, cwd=bare, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_train_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "bert-gmp.train", "--seed", "2147483711",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["correct"] and d["metrics"]["train_tok_s"]["value"] > 0
