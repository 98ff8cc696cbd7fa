"""Shot-boundary detection over per-frame histograms.

Reference parity: the ``ShotBoundaries`` whole-stream python op
(shot_detection.py:7-28): diffs[i] = mean over 3 channels of the Chebyshev
distance between adjacent histograms (diffs[0]=0); boundary at i>=1 iff
``diffs[i] - mean(window) > 2.5 * std(window)`` with a ±500-frame window
clamped to the stream. Returns ``[boundaries] + [None]*(N-1)`` so only row 0
holds the result, matching the reference read pattern
(tests/test_all.py:233 reads output.load(rows=[0])).

TPU-native design: the reference loops O(N·W) in python with scalar numpy.
Here windowed mean/std come from cumulative sums of diffs and diffs², making
the whole scan two O(N) passes — bit-identical decisions up to float
associativity (validated against the direct formula in tests).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ..registry import register_op

WINDOW_SIZE = 500


def boundaries_from_histograms(hists: np.ndarray,
                               window_size: int = WINDOW_SIZE) -> List[int]:
    """hists: [N, 3, 16] -> boundary frame indices."""
    h = np.asarray(hists, np.float64)
    n = h.shape[0]
    if n == 0:
        return []
    # Chebyshev distance per channel, mean over channels.
    diffs = np.abs(h[1:] - h[:-1]).max(axis=2).mean(axis=1)
    diffs = np.concatenate([[0.0], diffs])

    # Windowed mean/std via prefix sums: window for i is
    # diffs[max(i-W,0) : min(i+W, n)]  (reference shot_detection.py:24).
    c1 = np.concatenate([[0.0], np.cumsum(diffs)])
    c2 = np.concatenate([[0.0], np.cumsum(diffs * diffs)])
    i = np.arange(n)
    lo = np.maximum(i - window_size, 0)
    hi = np.minimum(i + window_size, n)
    cnt = (hi - lo).astype(np.float64)
    s1 = c1[hi] - c1[lo]
    s2 = c2[hi] - c2[lo]
    mean = s1 / cnt
    var = np.maximum(s2 / cnt - mean * mean, 0.0)
    std = np.sqrt(var)

    mask = diffs - mean > 2.5 * std
    mask[0] = False
    return [int(x) for x in np.nonzero(mask)[0]]


@register_op("ShotBoundaries", kind="whole_stream", outputs=("object",))
def shot_boundaries(ctx, histograms, window_size: int = WINDOW_SIZE
                    ) -> Sequence[Any]:
    """histograms: accumulated [N, 3, 16] int32 (or list of per-frame [3,16])."""
    if isinstance(histograms, list):
        if not histograms:  # empty stream -> empty output stream
            return []
        histograms = np.stack([np.asarray(h).reshape(3, -1) for h in histograms])
    n = histograms.shape[0]
    if n == 0:
        return []
    bounds = boundaries_from_histograms(histograms, window_size)
    return [bounds] + [None] * (n - 1)
