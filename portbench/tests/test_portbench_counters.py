"""The frozen counters against sums worked by hand at small shapes, the
TF32 rounding, and the import check."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, plain, roofline

ROOT = Path(__file__).resolve().parents[2]


def test_conv_and_linear_flops():
    meta = torch.device("meta")
    with plain.count_flops() as n:
        plain.conv2d(torch.empty((2, 3, 8, 10), device=meta),
                     torch.empty((4, 3, 3, 3), device=meta), padding=1)
    # 2 frames x 4 x 8 x 10 outputs, 27 multiply-adds each
    assert n[0] == 2 * (2 * 4 * 8 * 10) * 27
    with plain.count_flops() as n:
        plain.linear(torch.empty((5, 7), device=meta),
                     torch.empty((3, 7), device=meta))
    assert n[0] == 2 * 5 * 3 * 7


def test_pose_flops_by_hand():
    from portbench.reference import pose_detection as P

    h, w, stages = 16, 24, 2
    layers = P._layers(stages)
    hand, hh, ww = 0, h, w
    for name, cin, cout, k, _, _ in layers:
        hand += 2 * hh * ww * cout * cin * k * k
        if name in ("conv1_2", "conv2_2", "conv3_4"):
            hh, ww = hh // 2, ww // 2
    pool = np.zeros((3, h, w, 3), np.uint8)
    assert P.flops({"stages": stages}, None, pool, np.array([2, 0]),
                   [0, 0]) == 2 * hand


def test_face_flops_by_hand(monkeypatch):
    from portbench.reference import face_embedding as F

    cfg = {"mtcnn": {"window_ratio": 0.2, "pyramid_factor": 0.709}}
    per = F.flops_per_item(cfg, 24, 24)
    # P-Net a pyramid level of hs x ws: a 3x3 conv to 10, a SAME 2x2 pool,
    # 3x3 convs to 16 and 32, 1x1 heads of 2 + 4; R-Net and O-Net a crop
    # (the landmark head is not needed)
    levels = F.pyramid_layout(24, 24, cfg)
    pnet = 0
    for _, hs, ws, _ in levels:
        a = (hs - 2) * (ws - 2)
        b = (-(-(hs - 2) // 2) - 2) * (-(-(ws - 2) // 2) - 2)
        c = (-(-(hs - 2) // 2) - 4) * (-(-(ws - 2) // 2) - 4)
        pnet += a * 10 * 27 + b * 16 * 90 + c * (32 * 144 + 6 * 32)
    rnet = (22 * 22 * 28 * 27 + 9 * 9 * 48 * 252 + 3 * 3 * 64 * 192
            + 128 * 576 + 6 * 128)
    onet = (46 * 46 * 32 * 27 + 21 * 21 * 64 * 288 + 8 * 8 * 64 * 576
            + 3 * 3 * 128 * 256 + 256 * 1152 + 6 * 256)
    assert (per["pnet"], per["rnet"], per["onet"]) == (2 * pnet, 2 * rnet,
                                                      2 * onet)
    # R-Net and O-Net are counted on the candidates a frame, FaceNet on
    # the faces kept; pool frame 0 appears twice
    monkeypatch.setattr(F, "stage_inputs", lambda cfg, p, frames: {
        "rnet": np.array([5, 0]), "onet": np.array([2, 0])})
    pool = np.zeros((2, 24, 24, 3), np.uint8)
    rows = [{"faces": np.zeros((3, 5))}, {"faces": np.zeros((0, 5))},
            {"faces": np.zeros((1, 5))}]
    assert F.flops(cfg, None, pool, np.array([0, 1, 0]), rows) == \
        3 * per["pnet"] + 10 * per["rnet"] + 4 * per["onet"] \
        + 4 * per["facenet"]


def test_face_stage_inputs_within_the_capacities():
    import json

    from portbench.reference import face_embedding as F

    cfg = json.loads((ROOT / "portbench/configs/face_embedding.json")
                     .read_text())
    gen = torch.Generator().manual_seed(2 ** 31 + 3)
    p = F.draw(F.SPECS["mtcnn"], gen, "cpu")
    frames = (torch.rand((3, 48, 64, 3), generator=gen) * 255).to(
        torch.uint8).numpy()
    n = F.stage_inputs(cfg, p, frames, block=2)
    m = cfg["mtcnn"]
    assert n["rnet"].shape == n["onet"].shape == (3,)
    assert (n["rnet"] <= m["max_stage2"]).all()
    assert (n["onet"] <= 2 * m["max_faces"]).all()
    assert (n["onet"] <= n["rnet"]).all()


def test_bounds_by_hand():
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    scores = torch.tensor([[0.9, 0.8, 0.0, 0.0]])
    # bytes 4 * 20 + 2 * 21; ops 4 * 2 + 5 * 4 + 14 * (3 + 2)
    ops = 4 * 2 + 20 + 14 * 5
    assert roofline.nms_bound(scores, 2) == pytest.approx(
        roofline.bound_ms(4 * 20 + 2 * 21, ops))
    boxes = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
    # a 2 x 2 crop of a 2 x 2 box reads its 4 pixels (and the taps' right
    # and lower neighbours: 3 x 3)
    b = roofline.crop_bound(1, 8, 8, 3, boxes, torch.zeros(1, dtype=torch.long),
                            2, 2)
    assert b == pytest.approx(roofline.bound_ms(
        4 * 3 * 4 + 24 + 9 * 3 * 4, 4 * (27 + 26)))
    heat = torch.zeros((1, 19, 4, 4))
    heat[0, 0, 1, 1] = 0.5
    assert roofline.peaks_bound(heat, 18, 24, 0.1) == pytest.approx(
        roofline.bound_ms(18 * 16 * 4 + 18 * 24 * 13, 18 * 16 + 8))


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0000002, float("inf")])
    y = plain.round_tf32(x)
    assert y.tolist()[0] == 1.0 and y.tolist()[4] == float("inf")
    assert y[1].item() == 1.0 + 2 ** -10  # half way rounds away from zero
    assert y[2].item() == 1.0 + 2 ** -10
    assert abs(y[3].item() + 3.0) < 1e-6


@pytest.mark.parametrize("name, forbidden", [
    ("scannertools_tpu_torch.fake_probe", False),
    ("scannertools_tpu.fake_probe", True), ("jax.fake_probe", True),
    ("flax_like_probe", False)])
def test_forbidden_modules_compared_whole(name, forbidden):
    sys.modules[name] = type(sys)(name)
    try:
        assert (name in harness.forbidden_modules()) == forbidden
    finally:
        del sys.modules[name]


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "face_embedding.crowd", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_window_opens_and_closes_at_stored_packets(monkeypatch):
    from portbench import drive

    clock = [0.0]
    monkeypatch.setattr(drive.time, "perf_counter", lambda: clock[0])
    rec = drive.Recorder(["a", "b"], seconds=2.0)
    rec.ask("c", [0])  # a job opened ahead of time reads one row
    for first, t in ((0, 1.0), (2, 2.0), (4, 3.5), (6, 3.6)):
        if first < 6:
            rec.ask("c", [first, first + 1])
        clock[0] = t
        for col in ("a", "b"):
            assert rec.window() is None or first == 6
            for r in (first, first + 1):
                if first < 6:
                    rec.append(col, "c", bytes([r]))
    assert rec.closed
    with pytest.raises(drive.WindowClosed):
        rec.ask("c", [6, 7])
    # opened by the first packet stored, closed by the first 2 s later;
    # the frames are those stored after the opening one
    assert rec.window() == (1.0, 3.5, [("c", 2, 2), ("c", 4, 2)])
    assert rec.row("c", 3) == {"a": bytes([3]), "b": bytes([3])}
