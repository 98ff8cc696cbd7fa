"""Whole runs of the harness at a tiny size on the CPU, with the kernels'
plain versions: the result's keys, a sound run that the check passes, the
faults each cell can have that the check must fail, and the control (the
reference in TF32 in the program's place) that it must fail too."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tools.faults import FAULTS, planted

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# clips of two packets, so that a window holds a job's start and with it
# the source's reads
TINY_TRAFFIC = {"width": 128, "height": 96, "pool_frames": 8,
                "clip_frames": 4, "calibration_frames": 2,
                "perf": {"work_packet_size": 2, "io_packet_size": 2},
                "check_packets": 2, "blobs": [1, 2], "max_frames_per_s": 400}
TINY = {
    "face_embedding": {"traffic": TINY_TRAFFIC, "config": {
        "faces_budget": 4, "op_params": {"EmbedFaces": {"faces_budget": 4}}}},
    "pose_detection": {"traffic": TINY_TRAFFIC},
}
CELLS = {"face_embedding": "face_embedding.crowd",
         "pose_detection": "pose_detection.crowd"}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _native_build(tmp_path, monkeypatch):
    monkeypatch.setenv("SCANNERTOOLS_TPU_BUILD", str(tmp_path / "native"))


def run(config, trace=False, seed=SEED):
    return harness.run_cell(BENCH, CELLS[config], seed, 2.5, trace, "cpu",
                            overrides=TINY[config])


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(config, trace):
    out = run(config, trace)
    res = out["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in (BENCH["per_layer"] if trace
                                else BENCH["end_to_end"])
            if CELLS[config] in m.get("workloads", [CELLS[config]])}
    got = set(res["metrics"])
    # a CPU run reports no device metric: of the per-layer ones, only the
    # program's spans
    spans = {"source_ms_per_frame", "host_ops_ms_per_frame"}
    assert got == ({m for m in want if m.split(".")[0] in spans}
                   if trace else want)
    assert len(got) == 2
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_check(fault):
    with planted(fault):
        out = run(FAULTS[fault][0])
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_control_fails_the_check(config):
    from portbench.tools import control

    numbers, limits = control.readings(BENCH, CELLS[config], SEED, "cpu",
                                       TINY[config])
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_same_seed_same_inputs():
    from portbench import drive

    traffic = dict(TINY_TRAFFIC)
    a, b = (drive.draw_pool(traffic, torch.Generator().manual_seed(s), "cpu")
            for s in (SEED, SEED))
    c = drive.draw_pool(traffic, torch.Generator().manual_seed(SEED + 1),
                        "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.asarray(a).dtype == np.uint8
