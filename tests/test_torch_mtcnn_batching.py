"""MTCNN's per-scale NMS in one call (``models/mtcnn.py``,
``_nms_per_scale``): each pyramid scale's cells padded to
MAX_CELLS_PER_SCALE with score 0 and stacked on the frame axis give the
rows of one ``nms`` call per scale, exactly, at frame sizes where some
scales have fewer than MAX_CELLS_PER_SCALE cells; and a forward makes 4
``nms`` calls (the batched per-scale call, the cross-scale, R-Net and
O-Net calls). CPU tensors, so ``nms`` is ``nms_plain``; the kernel is held
to it on the card (tests/test_torch_kernels_cuda.py).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from scannertools_tpu_torch.models import common as MC
from scannertools_tpu_torch.models import mtcnn as PM


def _scale_cells(h, w, t, seed):
    """Seeded boxes and thresholded scores with each scale's cell count at
    an h x w frame, as ``_stage1_fused`` hands them on."""
    rng = np.random.default_rng(seed)
    cells = []
    for _, hs, ws, _ in PM.pyramid_layout(h, w):
        gh, gw = (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
        if gh <= 0 or gw <= 0:
            continue
        k = min(PM.MAX_CELLS_PER_SCALE, gh * gw)
        c = rng.uniform(0, max(h, w), (t, k, 2))
        wh = rng.uniform(12, 60, (t, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
        p = rng.uniform(0, 1, (t, k))
        p[:, ::5] = 0.75                       # ties
        score = np.where(p > 0.4, p, 0.0)      # the P-Net threshold
        cells.append((torch.from_numpy(boxes.astype(np.float32)),
                      torch.from_numpy(score.astype(np.float32))))
    return cells


@pytest.mark.parametrize("h,w", [(480, 640), (30, 40), (64, 96),
                                 (48, 64), (37, 50)])
def test_per_scale_nms_in_one_call_equals_one_call_a_scale(h, w):
    cells = _scale_cells(h, w, 3, seed=h)
    ks = [s.shape[1] for _, s in cells]
    assert min(ks) < PM.MAX_CELLS_PER_SCALE  # a padded scale
    boxes, scores = PM._nms_per_scale(cells)
    want_b, want_s = [], []
    for b, s in cells:
        bs, ss, vs = MC.nms(b, s, 0.5, s.shape[1])
        want_b.append(bs)
        want_s.append(torch.where(vs, ss, 0.0))
    assert torch.equal(boxes, torch.cat(want_b, dim=1))
    assert torch.equal(scores, torch.cat(want_s, dim=1))
    assert scores.shape == (3, sum(ks))


def test_forward_makes_four_nms_calls():
    """One frame batch through detect_batch: the per-scale calls are one
    call of [scales x T, MAX_CELLS_PER_SCALE] rows."""
    state = PM.init_params(0)
    frames = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (2, 48, 64, 3)).astype(np.float32))
    shapes = []

    def counted(boxes, scores, *args, **kw):
        shapes.append(tuple(scores.shape))
        return MC.nms(boxes, scores, *args, **kw)

    with mock.patch.object(PM, "nms", counted):
        out = PM.detect_batch(state, frames, (0.0, 0.0, 0.0))
    scales = len(PM.pyramid_layout(48, 64))
    assert shapes == [(scales * 2, PM.MAX_CELLS_PER_SCALE),
                      (2, PM.MAX_STAGE1), (2, PM.MAX_STAGE2),
                      (2, 2 * PM.MAX_FACES)]
    assert out[2].any()
