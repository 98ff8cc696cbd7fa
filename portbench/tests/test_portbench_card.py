"""On the card: each configuration's cell at its full size through the
harness, a short window, with ``correct`` true, and the control (the
reference in TF32 in the program's place) failing the same check. Skips
where there is no CUDA device.

    python3 -m pytest portbench/tests -m cuda
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    out = harness.run_cell(BENCH, cell, 2 ** 31 + 1001, 4.0, False, card)
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted({w["config"]: w["name"]
                                           for w in BENCH["workloads"]}))
def test_control_on_card(card, config):
    from portbench.tools import control

    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == config)
    numbers, limits = control.readings(BENCH, cell, 2 ** 31 + 1002, card)
    assert any(numbers[k] > v for k, v in limits.items()), numbers
