"""The Faster R-CNN cell through the harness at a tiny size on the CPU,
with the kernels' plain versions: a sound run that the check passes, the
faults of ``tools/faults_frcnn_vgg16.py`` and the control (the reference
in TF32 in the program's place), which it must fail.

The runner resizes to py-faster-rcnn's test size for the frames it is
given (600 within 1000); here its class attributes and the configuration
both take 120 within 160 and 64 RoIs, so that a 96x128 frame runs at
120x160."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.tools.faults_frcnn_vgg16 import FAULTS, planted

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "object_detection.frcnn_vgg16"
SEED = 2 ** 31 + 91
SIZE = {"scale": 120, "max_size": 160, "num_rois": 64}
TINY = {"traffic": {"width": 128, "height": 96, "pool_frames": 8,
                    "clip_frames": 4, "calibration_frames": 2,
                    "perf": {"work_packet_size": 2, "io_packet_size": 2},
                    "check_packets": 2, "check_items": 4, "blobs": [1, 2],
                    "max_frames_per_s": 400,
                    "heads": {"cls": {"detections_per_frame": 2}}},
        "config": SIZE}


@pytest.fixture(autouse=True)
def _tiny_runner(tmp_path, monkeypatch):
    from scannertools_tpu_torch.pipelines import std

    monkeypatch.setenv("SCANNERTOOLS_TPU_BUILD", str(tmp_path / "native"))
    for k, v in SIZE.items():
        monkeypatch.setattr(std.FasterRCNNDetectionPipeline, k, v)


def run(seed=SEED):
    return harness.run_cell(BENCH, CELL, seed, 2.5, False, "cpu",
                            overrides=TINY)


def test_sound_run():
    out = run()
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(out["checks"]) == {"det_miss", "box_gap_px", "score_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_check(fault):
    with planted(fault):
        out = run()
    assert not out["result"]["correct"], out["checks"]


def test_control_fails_the_check():
    from portbench.tools import control

    numbers, limits = control.readings(BENCH, CELL, SEED, "cpu", TINY)
    assert any(numbers[k] > v for k, v in limits.items()), numbers
