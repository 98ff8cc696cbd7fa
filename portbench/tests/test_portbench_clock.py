"""On the card: one short traced run of a cell of each configuration, the
program's ``stream:`` intervals holding the kernels torch.profiler traced
(the clock check), and the stream, wait, load and crop metrics reported.
Skips where there is no CUDA device.

    python3 -m pytest portbench/tests -m cuda
"""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {"face_embedding.crowd": ("mtcnn_stream_ms_per_frame",
                                  "facenet_stream_ms_per_frame",
                                  "device_wait_ms_per_frame",
                                  "facenet_crop_use", "weights_load_s"),
         "pose_detection.crowd": ("openpose_stream_ms_per_frame",
                                  "device_wait_ms_per_frame.pose",
                                  "weights_load_s")}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_clock_check_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.tools import clock

    out, result = clock.traced_run(BENCH, cell, 2 ** 31 + 1003, 6.0)
    assert result["correct"], result["checks"]
    assert out["share"] >= 95.0, out
    assert abs(out["median_end_offset_us"]) < 1000.0, out
    for name in CELLS[cell]:
        assert result["metrics"][name]["value"] > 0, name
