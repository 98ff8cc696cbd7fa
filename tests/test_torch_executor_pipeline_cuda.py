"""The executor's one-packet pipeline on the card (``cuda`` tests; each
skips without a CUDA device). No JAX here: the references are the port's
own ops called a chunk at a time.

* ``OpenPoseForward`` enqueues without a host sync (``dims`` is filled on
  the card), so the executor's thread is free while the trunk runs.
* A three-chunk pose run through ``Client.run`` stores the poses that
  chunk-at-a-time calls of ``OpenPoseForward`` and ``OpenPoseDecode``
  give, with two deferred tails.
* The deferred tail's copies run on a stream other than the compute
  stream.
"""

import numpy as np
import pytest
import torch

import scannertools_tpu_torch as st
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.ops import pose as POP

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


class MemoryVideo:
    """Frames in memory behind the executor's decoder interface."""

    is_video = True

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def metadata(self):
        n, h, w, _ = self.frames.shape
        return VideoMetadata("memory", n, 24.0, w, h)

    def decoder(self):
        return self

    def read_frames(self, idxs, out=None):
        data = self.frames[list(idxs)]
        if out is None:
            return data
        out[...] = data
        return out

    def close(self):
        pass


def _state():
    """A two-stage body net from the seed, its output layers scaled so the
    maps hold peaks."""
    state = PP.init_params(0, 2)
    for k in ("Mconv7_stage2_L1.weight", "Mconv7_stage2_L2.weight"):
        state[k] = state[k] * 1000.0
    return state


def _frames(n, seed=67):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 96, 3),
                                                np.uint8)


def _poses(rows):
    return [[p.serialize() for p in frame] for frame in rows]


def test_openpose_forward_raises_no_sync(cuda_device):
    state = {k: v.to(cuda_device) for k, v in _state().items()}
    frames = torch.from_numpy(_frames(4)).to(cuda_device)
    POP.openpose_forward(None, state, frames)  # loads, caches, builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = POP.openpose_forward(None, state, frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[3].cpu().tolist() == [[64, 96]] * 4


@pytest.fixture
def pose_run(tmp_path, monkeypatch, cuda_device):
    """OpenPose over 6 frames in packets of 2 on the card, its body
    weights the scaled two-stage net -> (profiler, stored poses, state)."""
    state = _state()
    monkeypatch.setattr(POP, "_get_params", lambda *a, **k: state)

    def run(frames):
        sc = st.Client(db_path=str(tmp_path / "db"), device="cuda")
        video = MemoryVideo(frames)
        node = sc.ops.OpenPose(frame=sc.io.Input([video]))
        out = st.NamedStream(sc, "poses")
        sc.run(sc.io.Output(node, [out]),
               st.PerfParams.manual(work_packet_size=2, io_packet_size=2),
               cache_mode=st.CacheMode.Overwrite)
        return sc.profiler, list(out.load())
    return run, state


def test_three_chunk_pose_run_matches_chunk_at_a_time(pose_run, cuda_device):
    run, state = pose_run
    frames = _frames(6)
    prof, rows = run(frames)
    dev_state = {k: v.to(cuda_device) for k, v in state.items()}
    want = []
    for a in range(0, 6, 2):
        x = torch.from_numpy(frames[a:a + 2]).to(cuda_device)
        want += POP.openpose_decode(None,
                                    *POP.openpose_forward(None, dev_state, x))
    assert _poses(rows) == _poses(want)
    assert sum(len(f) for f in want) > 0  # the scaled maps group people
    assert prof.counts()["pipeline:deferred_tail"] == 2


def test_tail_copies_run_on_their_own_stream(pose_run, monkeypatch):
    run, _ = pose_run
    seen = []
    host = POP._host

    def recording(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            seen.append(torch.cuda.current_stream(x.device))
        return host(x)

    monkeypatch.setattr(POP, "_host", recording)
    run(_frames(6))
    compute = torch.cuda.current_stream()
    # the decode's four copies a packet, every one off the compute stream
    assert len(seen) == 12
    assert all(s != compute for s in seen)
