"""The guard of the port's tests that run the JAX package on a video with
``ingest`` "i420" or "auto".

The JAX package builds its native libav decoder (``st_av``) on first use,
through one temporary file name shared by every process
(``scannertools_tpu/utils/native.py``). When several test workers start
that build at once on an empty build cache, the ones that lose the race
cache ``None`` for the rest of the process: their JAX runs then fail
(``ingest="i420"``) or silently decode with cv2 (``"auto"``), so the two
packages no longer read the same frames. ``jax_native_decoder`` drops the
cached ``None`` and asks once more, by when the winner has published the
library; where the decoder still cannot be built, the test skips, as the
JAX package's own I420 tests do.
"""

import pytest

from scannertools_tpu.io import av as jax_av
from scannertools_tpu.utils import native as jax_native


def jax_native_decoder() -> None:
    """Make the JAX package's native decoder available in this process, or
    skip the calling test."""
    if jax_av.available():
        return
    jax_native._CACHE.pop("st_av", None)
    if not jax_av.available():
        pytest.skip("the JAX package's native libav decoder (st_av) failed "
                    "to build")


def test_guard_recovers_from_a_lost_build_race():
    """A worker that lost the build race holds ``None`` in the JAX
    package's cache; the guard drops it and finds the published
    library."""
    jax_native_decoder()  # skips where st_av cannot be built at all
    saved = jax_native._CACHE.get("st_av")
    try:
        jax_native._CACHE["st_av"] = None
        assert not jax_av.available()
        jax_native_decoder()
        assert jax_av.available()
        assert jax_native._CACHE["st_av"] is not None
    finally:
        jax_native._CACHE["st_av"] = saved
