"""BENCHMARK.json against the contract, and every cell resolving to its
files by name."""

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    from portbench import harness

    files = harness.cell_files(BENCH, cell)
    for key in ("config", "traffic", "reference"):
        assert files[key].is_file(), files[key]
    cfg = json.loads(files["config"].read_text())
    traffic = json.loads(files["traffic"].read_text())
    assert cfg["name"] == files["cell"]["config"]
    # the runner's own PerfParams, as its users get them
    assert set(cfg["limits"]) and "perf" not in traffic
    ref = importlib.import_module(f"portbench.reference.{cfg['name']}")
    for fn in ("build", "write_weights", "parse", "reference", "compare",
               "flops"):
        assert callable(getattr(ref, fn))
    reported = set()
    for name, path in files["metrics"].items():
        assert path.is_file(), path
        mod = harness.load_metric(path)
        assert callable(mod.read) and UNIT.match(mod.UNIT)
        reported.add(name)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in reported and len(reported & e2e) >= 2
    assert reported - e2e  # at least one per-layer metric


def test_every_config_used_and_unreduced():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["reduced"] == []
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench").glob("reference/*.py"))
    + [ROOT / "portbench" / "plain.py", ROOT / "portbench" / "roofline.py"],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not names & {"scannertools_tpu", "scannertools_tpu_torch", "jax",
                        "jaxlib", "flax"}, names
