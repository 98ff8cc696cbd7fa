"""The port's media handles (scannertools_tpu_torch/io/media.py) held to
the JAX package's (scannertools_tpu/io/media.py) on one cv2-written mp4
(conftest's test video): metadata, frames by number and by time, the
montage and the re-encoded segment are equal. ``Audio.extract`` needs the
port's libav module and skips where it cannot be built.
"""

import numpy as np
import pytest

from scannertools_tpu.io import media as jmedia
from scannertools_tpu_torch.io import av as pav
from scannertools_tpu_torch.io import media as pmedia
from test_torch_jax_decoder import jax_native_decoder


@pytest.fixture()
def videos(test_video):
    jax_native_decoder()  # both packages decode through the same backend
    return (pmedia.Video(test_video["path"], scanner_name="v"),
            jmedia.Video(test_video["path"], scanner_name="v"))


def test_metadata_equals_jax(videos, test_video):
    p, j = videos
    for name in ("width", "height", "fps", "num_frames", "duration",
                 "scanner_name", "path"):
        assert getattr(p, name)() == getattr(j, name)(), name
    assert (p.num_frames(), p.height(), p.width()) == (
        test_video["n"], test_video["h"], test_video["w"])


def test_frames_equal_jax(videos):
    p, j = videos
    np.testing.assert_array_equal(p.frame(), j.frame())
    np.testing.assert_array_equal(p.frame(number=77), j.frame(number=77))
    np.testing.assert_array_equal(p.frame(time=3.3), j.frame(time=3.3))
    numbers = [200, 3, 3, 150, 61]  # out of order, repeated
    for a, b in zip(p.frames(numbers=numbers), j.frames(numbers=numbers)):
        np.testing.assert_array_equal(a, b)
    times = [0.5, 9.0, 2.25]
    for a, b in zip(p.frames(times=times), j.frames(times=times)):
        np.testing.assert_array_equal(a, b)
    assert len(p.frames()) == p.num_frames()


@pytest.mark.parametrize("kw", [{}, {"rows": 2}, {"cols": 4}])
def test_montage_equals_jax(videos, kw):
    p, j = videos
    frames = [0, 59, 60, 119, 120, 239, 10]
    got, want = p.montage(frames, **kw), j.montage(frames, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_extract_segment_equals_jax(videos, tmp_path):
    p, j = videos
    a = p.extract(path=str(tmp_path / "p.mp4"), segment=(1.0, 3.0))
    b = j.extract(path=str(tmp_path / "j.mp4"), segment=(1.0, 3.0))
    pa, pb = pmedia.Video(a), pmedia.Video(b)
    assert pa.num_frames() == pb.num_frames() == 48
    np.testing.assert_array_equal(np.stack(pa.frames()),
                                  np.stack(pb.frames()))


def test_audio_extract_segment(tmp_path):
    """Audio.extract re-encodes a segment in-process (old/video.py
    parity), as the JAX package's does."""
    if not pav.available():
        pytest.skip("the port's native libav module (st_av) is unavailable")
    rate = 22050
    sig = (0.5 * np.sin(2 * np.pi * 330 * np.arange(rate * 3) / rate)
           ).astype(np.float32)
    src = str(tmp_path / "full.m4a")
    pav.encode_audio(src, sig, rate)
    seg = pmedia.Audio(src).extract(path=str(tmp_path / "seg"), ext=".m4a",
                                    segment=(1.0, 2.0))
    assert seg.path().endswith(".m4a")
    dec, r = pav.decode_audio(seg.path())
    assert r == rate
    assert abs(len(dec) - rate) < rate * 0.2
