"""Shared test fixtures/helpers for downstream packages.

Reference parity: scannertools_infra's pytest fixtures
(scannertools_infra/scannertools_infra/tests.py:11-80): a throwaway-db
client, a real short video, and GPU gating. Downstream op packages import
these instead of rolling their own, exactly like the reference's modules
did with ``from scannertools_infra.tests import sc``.
"""

from __future__ import annotations

import tempfile
from typing import Optional

import numpy as np


def needs_cuda():
    """Skip marker when no CUDA device is available (the reference's
    ``needs_gpu``, tests.py:11-15)."""
    import pytest
    import torch

    return pytest.mark.skipif(
        not torch.cuda.is_available(), reason="no CUDA device available"
    )


def make_config(db_path: Optional[str] = None, **_parity):
    """Throwaway client config (tests.py:17-33; master/worker ports have no
    meaning here: the client runs one process's jobs)."""
    from .config import Config

    return Config(db_path=db_path or tempfile.mkdtemp(prefix="st_tpu_db_"))


def make_client(db_path: Optional[str] = None, device=None):
    """``device`` as for ``Client``: None means the CUDA device."""
    from .client import Client

    return Client(config=make_config(db_path), device=device)


def make_test_video(path: str, n: int = 120, w: int = 96, h: int = 64,
                    fps: float = 24.0, cuts=(40, 80)) -> dict:
    """Synthesize the standard test mp4: colored shots with known cut
    frames and a moving bar (the stand-in for the reference's GCS
    short_video.mp4, tests.py:37-53 — this image has no egress)."""
    import cv2

    colors = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40)]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise IOError(f"VideoWriter failed for {path}")
    shot = 0
    for i in range(n):
        while shot < len(cuts) and i >= cuts[shot]:
            shot += 1
        r, g, b = colors[shot % len(colors)]
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, :] = (b, g, r)
        x = (i * 2) % w
        frame[:, x : min(x + 8, w)] = 255
        writer.write(frame)
    writer.release()
    return {"path": path, "cuts": list(cuts), "n": n, "w": w, "h": h}


def ingest_test_video(sc, name: str = "test1", **kwargs):
    from .storage.named import NamedVideoStream

    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        info = make_test_video(f.name, **kwargs)
    stream = NamedVideoStream(sc, name, path=info["path"])
    return stream, info
