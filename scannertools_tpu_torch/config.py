"""Run-time configuration: PerfParams, CacheMode, DeviceType, database config.

Reference parity: scannerpy's ``PerfParams.estimate()/manual(...)`` knobs
(reference scannertools/tests/test_all.py:45,231) and ``CacheMode`` /
``DeviceType`` enums used throughout the reference op modules.

Here ``work_packet_size`` is the frame-chunk size of one device segment
call and ``io_packet_size`` the host decode/prefetch granularity. The port
runs on one device: the data mesh and the pipeline, spatial and expert
axes, and worker recycling are not ported yet, so their knobs are absent
and passing one raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class DeviceType(enum.Enum):
    """Per-op ``device=`` kwarg (reference API parity).

    ``CPU`` runs the op's segment on CPU tensors — the executor moves the
    segment's inputs to the CPU and returns host outputs (used by
    cross-backend parity tests, mirroring the reference's DeviceTestBench,
    tests/test_all.py:141-147). ``GPU``/``TPU``/unset run on the client's
    device; host ops always run on the host.
    """

    CPU = "cpu"
    GPU = "tpu"   # legacy alias: reference pipelines passing GPU get the accelerator
    TPU = "tpu"


class CacheMode(enum.Enum):
    """Job-level caching semantics (reference old/prelude.py:241-262).

    ``Resume`` extends the reference's table-granularity cache with
    chunk-granularity recovery: committed outputs are skipped like
    ``Ignore``, and an *interrupted* job continues from its completed
    chunk shards instead of recomputing the stream (SURVEY §5's
    per-(video, frame-range) manifest design). Requires named-stream
    sinks and a graph without stateful/whole-stream ops; otherwise it
    degrades to full recomputation of uncommitted jobs."""

    Error = "error"        # committed output exists -> raise
    Ignore = "ignore"      # committed output exists -> skip job
    Overwrite = "overwrite"  # recompute and overwrite
    Resume = "resume"      # skip committed; continue interrupted jobs


# Host-staging budget per work packet. One packet is simultaneously (a) a
# decode-ring slot, (b) a device-resident chunk, and (c) the unit of device
# segment calls — 128 MB amortizes per-chunk launch overhead without
# starving the ring (slots = depth+2 packets).
_PACKET_BYTE_BUDGET = 128 << 20


@dataclasses.dataclass(frozen=True)
class PerfParams:
    """Chunking/prefetch knobs.

    work_packet_size: frames per device segment call.
    io_packet_size:   frames per host decode request (>= work_packet_size).
    prefetch_depth:   number of chunks decoded ahead of device execution.

    ``estimate()`` defers the choice: the executor calls ``resolve()`` per
    job with the stream's actual frame geometry and the graph's stencil
    halo (the reference engine's auto-estimator role — it sized io/work
    packets from stream statistics).
    """

    work_packet_size: int = 64
    io_packet_size: int = 256
    prefetch_depth: int = 2
    auto: bool = False
    fixed: tuple = ()  # fields pinned by estimate(**overrides)
    # Frame ingest format for device-bound sources:
    #   "auto" — decode to planar I420 when the source is 4:2:0 and every
    #            consumer is a device op: half the host->device bytes of
    #            RGB24, no host swscale, YUV->RGB fused into the device op
    #            (hist_i420).
    #   "rgb"  — always decode to RGB24 on the host (bit-exact with cv2).
    #   "i420" — require the planar path (error if the source can't).
    ingest: str = "auto"
    # Sink encoding steering: "auto" lets the executor switch ops that
    # declare a compact sink encoding (OpDef.compact_sink) to it when their
    # output feeds ONLY sinks — fewer device->host + sink bytes for
    # store-raw patterns; loads still return float32. "float32" disables
    # the steering; "float16" is an explicit alias of auto (both only ever
    # touch ops that declared tolerance, and never override an explicitly
    # passed op param).
    sink_dtype: str = "auto"

    @classmethod
    def estimate(cls, **overrides) -> "PerfParams":
        """Auto-size packets per job from stream metadata; any explicitly
        passed knob stays fixed (reference PerfParams.estimate analog)."""
        return cls(auto=True, fixed=tuple(sorted(overrides)), **overrides)

    def resolve(self, frame_bytes: Optional[int] = None,
                halo: int = 0) -> "PerfParams":
        """Concrete params for one job.

        frame_bytes: decoded size of one element (H*W*3 for video; None for
        non-frame streams, which keep the defaults — elements are small).
        halo: extra rows each chunk decodes for temporal stencils.
        """
        if not self.auto:
            return self
        w = self.work_packet_size
        if "work_packet_size" not in self.fixed and frame_bytes:
            w = _PACKET_BYTE_BUDGET // max(frame_bytes, 1) - halo
            w = max(8, min(512, w - w % 8))  # a multiple of 8
        io = self.io_packet_size
        if "io_packet_size" not in self.fixed:
            io = 4 * w
        depth = self.prefetch_depth
        if "prefetch_depth" not in self.fixed:
            depth = max(2, io // max(w, 1))
        return PerfParams(
            work_packet_size=w, io_packet_size=max(io, w),
            prefetch_depth=depth, ingest=self.ingest,
            sink_dtype=self.sink_dtype,
        )

    @classmethod
    def manual(
        cls,
        work_packet_size: int = 64,
        io_packet_size: int = 256,
        prefetch_depth: int = 2,
        ingest: str = "auto",
        sink_dtype: str = "auto",
    ) -> "PerfParams":
        io_packet_size = max(io_packet_size, work_packet_size)
        return cls(
            work_packet_size=work_packet_size,
            io_packet_size=io_packet_size,
            prefetch_depth=prefetch_depth,
            ingest=ingest,
            sink_dtype=sink_dtype,
        )


@dataclasses.dataclass
class Config:
    """Client configuration (reference: engine TOML config; infra/tests.py:17-33).

    db_path: root directory for named-stream storage.
    """

    db_path: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "SCANNERTOOLS_TPU_DB", os.path.expanduser("~/.scannertools_tpu/db")
        )
    )
    n_decode_workers: int = 2
    resources_path: Optional[str] = None  # model-weight cache dir

    def resources_dir(self) -> str:
        path = self.resources_path or os.path.join(
            os.path.dirname(self.db_path), "resources"
        )
        os.makedirs(path, exist_ok=True)
        return path
