"""Run-time configuration: PerfParams, CacheMode, DeviceType, database config.

Reference parity: scannerpy's ``PerfParams.estimate()/manual(...)`` knobs
(reference scannertools/tests/test_all.py:45,231) and ``CacheMode`` /
``DeviceType`` enums used throughout the reference op modules.

Here ``work_packet_size`` is the frame-chunk size of one device segment
call and ``io_packet_size`` the host decode/prefetch granularity. The four
multi-device knobs are the JAX package's, with its defaults and meaning:
``pipeline_instances_per_node`` (the frame-sharded data mesh),
``pipeline_stages``, ``spatial_shards`` and ``expert_shards`` (the
pipeline, spatial and expert axes, each reserving devices of the run's
``parallel/mesh.local_devices``); ``resolve()`` sizes and declines them
by the JAX package's rules. ``recycle_rss_mb`` (worker recycling) is
ported too.
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


class RecycleRequested(RuntimeError):
    """The executor's process RSS crossed PerfParams.recycle_rss_mb at a
    job boundary (every completed job is committed; nothing is lost).
    Catch it — or use parallel/recycling.run_recycling — and re-run in a
    fresh process with a cache mode that skips committed jobs."""


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
    pipeline_instances_per_node: data-parallel lanes over the device mesh.
    prefetch_depth:   number of chunks decoded ahead of device execution.

    ``estimate()`` defers the choice: the executor calls ``resolve()`` per
    job with the stream's actual frame geometry and the graph's stencil
    halo (the reference engine's auto-estimator role — it sized io/work
    packets from stream statistics).
    """

    work_packet_size: int = 64
    io_packet_size: int = 256
    pipeline_instances_per_node: int = 1
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
    # Pipeline parallelism over a model's stage chain: >1 reserves that
    # many devices as a stage pipeline; ops that declare a uniform stage
    # chain (OpDef.stages — OpenPose's body refinement and the face/hand
    # crop nets) run one stage per device on the GPipe schedule
    # (parallel/pipeline_parallel.pipeline_apply_traced). 0/1 = off; -1
    # under estimate() auto-picks the longest declared chain.
    pipeline_stages: int = 0
    # Spatial parallelism over each frame's row axis: >1 reserves that many
    # devices as an 'sp' axis; ops declaring row-shardability
    # (OpDef.sp_halo — Blur's halo, ConvertColor/ConvertToHSV/
    # FrameDifference pointwise) split H over them and exchange halo rows
    # (parallel/spatial). Ops fall back to the unsharded form when H does
    # not divide (counted as the axis not engaged). 0/1 = off; -1 under
    # estimate() auto-picks the largest count the geometry supports.
    spatial_shards: int = 0
    # Expert parallelism: >1 reserves that many devices as an 'expert'
    # axis; ops declaring expert groups (OpDef.experts — MoEHead, the
    # streetstyle attribute heads) split their group-stacked weights over
    # them (parallel/expert.moe_apply,
    # models/streetstyle.heads_apply_sharded) and sum or gather the
    # shards' parts. Ops fall back to the single-device formulation when
    # the group count does not divide the axis (counted). 0/1 = off; -1
    # under estimate() auto-picks a dividing count.
    expert_shards: int = 0
    # Sink encoding steering: "auto" lets the executor switch ops that
    # declare a compact sink encoding (OpDef.compact_sink) to it when their
    # output feeds ONLY sinks — fewer device->host + sink bytes for
    # store-raw patterns; loads still return float32. "float32" disables
    # the steering; "float16" is an explicit alias of auto (both only ever
    # touch ops that declared tolerance, and never override an explicitly
    # passed op param).
    sink_dtype: str = "auto"
    # Worker recycling budget: when >0, the executor raises
    # RecycleRequested at the next JOB boundary once process RSS exceeds
    # this many MB; parallel/recycling.run_recycling respawns the worker,
    # and committed jobs are skipped on re-entry (CacheMode.Ignore/Resume).
    # 0 = off.
    recycle_rss_mb: float = 0.0

    @classmethod
    def estimate(cls, **overrides) -> "PerfParams":
        """Auto-size packets per job from stream metadata; any explicitly
        passed knob stays fixed (reference PerfParams.estimate analog)."""
        return cls(auto=True, fixed=tuple(sorted(overrides)), **overrides)

    def resolve(self, frame_bytes: Optional[int] = None, halo: int = 0,
                n_devices: int = 1, rows: int = 0,
                declared_stages: tuple = (),
                declared_sp_halos: tuple = (),
                declared_experts: tuple = (),
                total_devices: int = 1) -> "PerfParams":
        """Concrete params for one job.

        frame_bytes: decoded size of one element (H*W*3 for video; None for
        non-frame streams, which keep the defaults — elements are small).
        halo: extra rows each chunk decodes for temporal stencils.
        n_devices: data-parallel mesh size (chunks are a multiple of 8
        times it, so that shards are even).

        Axis sizing — the executor passes what the GRAPH declares
        (OpDef.sp_halo/stages/experts) plus the job's frame geometry, and
        resolve() accepts, declines, or auto-sizes (the JAX package's
        predicates, copied as they are):
          * ``pipeline_stages=-1`` picks the longest declared stage chain
            (0 when nothing declares one or devices are short); an
            explicit value is declined to 0 when no declared chain could
            engage it (every chain needs stages >= its length).
          * ``spatial_shards=-1`` picks the largest device count that
            divides the frame's rows with each local shard >= the largest
            declared halo; explicit values are declined when no op
            declares row-shardability or the geometry can't shard.
          * ``expert_shards=-1`` picks the largest device count dividing
            a declared expert-group count; explicit values are declined
            when nothing declares experts divisible by them.
        """
        if not self.auto:
            return self
        w = self.work_packet_size
        if "work_packet_size" not in self.fixed and frame_bytes:
            w = _PACKET_BYTE_BUDGET // max(frame_bytes, 1) - halo
            # a multiple of 8 and of the mesh
            m = 8 * max(1, n_devices)
            w = max(m, min(512, w - w % m))
        io = self.io_packet_size
        if "io_packet_size" not in self.fixed:
            io = 4 * w
        depth = self.prefetch_depth
        if "prefetch_depth" not in self.fixed:
            depth = max(2, io // max(w, 1))

        stages = self.pipeline_stages
        if stages == -1:
            best = max(declared_stages, default=0)
            stages = best if best >= 2 and total_devices >= best else 0
        elif stages > 1 and not any(L <= stages for L in declared_stages):
            stages = 0  # nothing in this graph could engage the pipeline

        sp = self.spatial_shards
        sp_halo = max(declared_sp_halos, default=0)

        def _sp_ok(n):
            return (declared_sp_halos != () and rows > 0 and rows % n == 0
                    and rows // n >= max(sp_halo, 1))
        if sp == -1:
            sp = next((n for n in range(total_devices, 1, -1) if _sp_ok(n)),
                      0)
        elif sp > 1 and not _sp_ok(sp):
            sp = 0  # geometry/divisibility makes the requested axis a loss

        ep = self.expert_shards
        if ep == -1:
            ep = next((n for n in range(total_devices, 1, -1)
                       if any(E % n == 0 for E in declared_experts)), 0)
        elif ep > 1 and not any(E % ep == 0 for E in declared_experts):
            ep = 0

        return PerfParams(
            work_packet_size=w, io_packet_size=max(io, w),
            pipeline_instances_per_node=self.pipeline_instances_per_node,
            prefetch_depth=depth, ingest=self.ingest,
            pipeline_stages=stages,
            spatial_shards=sp,
            expert_shards=ep,
            sink_dtype=self.sink_dtype,
            recycle_rss_mb=self.recycle_rss_mb,
        )

    @classmethod
    def manual(
        cls,
        work_packet_size: int = 64,
        io_packet_size: int = 256,
        pipeline_instances_per_node: int = 1,
        prefetch_depth: int = 2,
        ingest: str = "auto",
        pipeline_stages: int = 0,
        spatial_shards: int = 0,
        expert_shards: int = 0,
        sink_dtype: str = "auto",
        recycle_rss_mb: float = 0.0,
    ) -> "PerfParams":
        io_packet_size = max(io_packet_size, work_packet_size)
        return cls(
            work_packet_size=work_packet_size,
            io_packet_size=io_packet_size,
            pipeline_instances_per_node=pipeline_instances_per_node,
            prefetch_depth=prefetch_depth,
            ingest=ingest,
            pipeline_stages=pipeline_stages,
            spatial_shards=spatial_shards,
            expert_shards=expert_shards,
            sink_dtype=sink_dtype,
            recycle_rss_mb=recycle_rss_mb,
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
