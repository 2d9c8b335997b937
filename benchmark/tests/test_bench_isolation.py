"""What the benchmark may import and read, and the shape of what it
declares and prints."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import common, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# The JAX package's benchmark files, which measure it and not the port.
JAX_BENCH = ("bench/", "bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json")


def sources():
  return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
             else [node.module or ""] if isinstance(node, ast.ImportFrom)
             else [])
    for name in names:
      assert name.split(".")[0] not in common.FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", [p for p in sources()
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_reads_the_jax_packages_benchmark_files(path):
  for node in ast.walk(ast.parse(path.read_text())):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
      assert not any(s in node.value for s in JAX_BENCH), (path, node.value)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
  for name in ("mpi_vision_tpu_torch", "mpi_vision_tpu_torch.serve",
               "jaxtyping"):
    monkeypatch.setitem(sys.modules, name, sys)
  assert common.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, "mpi_vision_tpu.core", sys)
  monkeypatch.setitem(sys.modules, "flax", sys)
  assert common.forbidden_modules() == ["flax", "mpi_vision_tpu.core"]


def test_benchmark_json_follows_the_contract():
  text = (ROOT / "BENCHMARK.json").read_text()
  assert len(text.encode()) <= 64 * 1024
  bench = json.loads(text)
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert bench["paths"] == ["benchmark"]
  assert bench["command"] == ["python3", "benchmark/run.py"]
  assert 1 <= bench["run_seconds"] <= 51
  one_line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(
        c["why"])
    assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
  for w in bench["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and one_line(w["why"])
  four = sum(w["chips"] == 4 for w in bench["workloads"])
  assert four <= max(1, len(bench["workloads"]) // 4)
  metrics = bench["end_to_end"] + bench["per_layer"]
  names = [m["name"] for m in metrics]
  assert len(set(names)) == len(names)
  assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
  for m in bench["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in bench["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert one_line(m["layer"])
    assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
  for m in metrics:
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
      assert m["better"] == "higher"
  layers = {}
  for m in bench["per_layer"]:
    layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
  assert all(len(v) == 1 for v in layers.values())


def test_every_cell_resolves_by_name_and_reports_enough():
  bench = run.load_benchmark()
  cells = {w["name"] for w in bench["workloads"]}
  for w in bench["workloads"]:
    cell, config, traffic = run.resolve(bench, w["name"])
    assert config["name"] == w["config"]
    assert (BENCH / "traffic" / "kinds" / f"{traffic['kind']}.py").is_file()
    e2e = {m["name"] for m in run.cell_metrics(bench, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(bench, cell, True)
  for m in bench["per_layer"]:
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert set(m["workloads"]) <= cells
    for cell in m["workloads"]:
      entry = next(w for w in bench["workloads"] if w["name"] == cell)
      assert m["moves"] in {e["name"] for e in run.cell_metrics(
          bench, entry, False)}
  for m in bench["end_to_end"]:
    assert set(m.get("workloads", cells)) <= cells
  used = {w["config"] for w in bench["workloads"]}
  assert used == {c["name"] for c in bench["configs"]}


def test_the_result_line_has_exactly_the_contract_keys():
  out = {"correct": True, "attempted": 3, "failed": 0,
         "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
         "checks": [{"name": "frame_mean_abs", "value": 1e-7, "limit": 1e-5,
                     "ok": True}],
         "data": {"trace": {"breakdown": {"device_ops": [["k", 0.1]],
                                          "idle_gaps": [["host", 0.2]]}}}}
  device = {"platform": "gpu", "kind": "card", "count": 1,
            "memory_peak_bytes": 1}
  line = run.result_line(out, device, trace=False)
  assert list(line) == ["correct", "attempted", "failed", "metrics",
                        "device", "checks"]
  line = run.result_line(out, device, trace=True)
  assert list(line) == ["correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"]
  assert line["checks"] == {"frame_mean_abs": {"value": 1e-7, "limit": 1e-5}}


def test_no_result_without_a_card_or_without_the_port(tmp_path):
  cmd = [sys.executable, "benchmark/run.py", "--workload",
         "mpi1080p32.burst_1scene", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"]
  bare = tmp_path / "bare"
  shutil.copytree(BENCH, bare / "benchmark",
                  ignore=shutil.ignore_patterns("__pycache__"))
  shutil.copy(ROOT / "BENCHMARK.json", bare)
  for where in (ROOT, bare):
    proc = subprocess.run(cmd, cwd=where, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
