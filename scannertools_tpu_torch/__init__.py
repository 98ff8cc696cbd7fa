"""scannertools_tpu_torch — the PyTorch/CUDA port of scannertools_tpu.

The same public API as scannertools_tpu (pipeline graphs over sampled video
streams, ops, named-stream storage), computed with torch on one device:
an NVIDIA GPU by default, where the ops' kernels are hand-written CUDA
(``kernels/csrc``), or the CPU on request, where each kernel's plain torch
version runs instead. Stream files are byte-identical across the two
packages, so either reads what the other wrote.

Quick start (the scannertools_tpu script with only the import changed):

    import scannertools_tpu_torch as st
    sc = st.Client()                 # or st.Client(device="cpu")
    video = st.NamedVideoStream(sc, 'test1', path='video.mp4')
    frame = sc.io.Input([video])
    hist = sc.ops.Histogram(frame=frame)
    out = st.NamedStream(sc, 'test1_hist')
    sc.run(sc.io.Output(hist, [out]), st.PerfParams.estimate(),
           cache_mode=st.CacheMode.Overwrite)
    histograms = list(out.load())
"""

from . import protobufs, types
from .config import CacheMode, Config, DeviceType, PerfParams
from .client import Client
from .registry import register_op, register_python_op
from .runtime.context import Kernel
from .storage import (AudioStorage, AudioStream, CaptionStorage,
                      CaptionStream, FilesStorage, FilesStream, NamedStream,
                      NamedVideoStream, PackedFileStorage, PackedFileStream,
                      PythonStorage, PythonStream)

# Populate the op registry.
from . import ops as _ops  # noqa: F401

FrameType = "frame"  # type tag for python-op signatures (scannerpy.FrameType)

__version__ = "0.1.0"

__all__ = [
    "AudioStorage", "AudioStream", "CacheMode", "CaptionStorage",
    "CaptionStream", "Client", "Config", "DeviceType", "FilesStorage",
    "FilesStream", "FrameType", "Kernel", "NamedStream", "NamedVideoStream",
    "PackedFileStorage", "PackedFileStream", "PerfParams", "PythonStorage",
    "PythonStream", "protobufs", "register_op", "register_python_op",
    "types",
]
