"""Per-op execution context.

Reference parity: scannerpy ``KernelConfig`` (devices/args/output_columns) plus
the Kernel resource lifecycle (``fetch_resources``/``setup_with_resources``,
face_embedding.py:31-52). Kernel-class instances are cached per (op, params)
so TF/torch-style sessions are built once per job, like the reference's
one-kernel-instance-per-worker model.

The context also carries the run's axis reservations (the devices the
executor reserved for ``PerfParams.pipeline_stages``, ``spatial_shards``
and ``expert_shards``) and builds the ops' meshes over them
(``pipe_mesh``, ``sp_mesh``, ``ep_mesh``: a ``parallel/mesh.Mesh`` or
None, under the JAX package's conditions). Each call on a reserved axis is
counted in the profiler: ``axis:<name>:engaged`` when it gives a mesh,
``axis:<name>:not_engaged`` when the op must fall back unsharded.

``packet`` names the work packet the executor is running (``job``, its
first ``row`` and its ``rows``); the ops' own spans and counters carry it,
as the executor's do, so that the spans of one packet share an identifier.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

from .. import protobufs
from ..parallel.mesh import Mesh


class OpContext:
    def __init__(
        self,
        job: int = 0,
        stream_meta: Optional[dict] = None,
        resources_dir: str = "/tmp/scannertools_tpu_resources",
        profiler=None,
        device=None,
        pipe_devices=None,
        sp_devices=None,
        ep_devices=None,
    ):
        self.job = job
        self.stream_meta = stream_meta or {}
        self.resources_dir = resources_dir
        self.profiler = profiler
        self.protobufs = protobufs
        #: the torch device the run's device ops compute on
        self.device = device
        #: devices reserved for stage-pipeline parallelism
        #: (PerfParams.pipeline_stages; ops build a 'pipe' mesh over a
        #: prefix sized to their own stage count — models/pose.py
        #: body_forward_pipelined)
        self.pipe_devices = list(pipe_devices) if pipe_devices else None
        #: devices reserved for spatial (frame-row) parallelism
        #: (PerfParams.spatial_shards; row-shardable ops build an 'sp'
        #: mesh — ops/imgproc.py blur)
        self.sp_devices = list(sp_devices) if sp_devices else None
        #: devices reserved for expert parallelism
        #: (PerfParams.expert_shards; MoE ops build an 'expert' mesh —
        #: ops/nn_generic.py MoEHead)
        self.ep_devices = list(ep_devices) if ep_devices else None
        self._kernel_cache: Dict[Tuple, Any] = {}
        #: the packet being run (set by the executor at each chunk)
        self.packet: Dict[str, int] = {"job": job}
        #: called at the start of each wait on the device: while the
        #: executor runs a packet's deferred host tail, it waits there for
        #: that packet's device work (None: nothing to wait for first)
        self.settle: Optional[Callable[[], None]] = None

    @contextlib.contextmanager
    def wait_device(self):
        """A ``host:wait_device`` span, with the packet's meta, around a
        copy from the device that blocks the calling thread (``settle``
        runs first, inside it); no span without a profiler."""
        span = contextlib.nullcontext() if self.profiler is None \
            else self.profiler.span("host:wait_device", **self.packet)
        with span:
            if self.settle is not None:
                self.settle()
            yield

    def count(self, name: str, n: int) -> None:
        """Count ``n`` of ``name`` for the packet (the event's ``n``
        meta); nothing without a profiler."""
        if self.profiler is not None:
            self.profiler.count(name, n=n, **self.packet)

    def _count(self, axis: str, mesh):
        if self.profiler is not None:
            self.profiler.count(f"axis:{axis}:"
                                + ("engaged" if mesh is not None
                                   else "not_engaged"))
        return mesh

    def pipe_mesh(self, n_stages: int):
        """A 'pipe' mesh of exactly ``n_stages`` reserved devices, or None
        when pipeline parallelism is off / the reservation is smaller."""
        if not self.pipe_devices:
            return None
        if len(self.pipe_devices) < n_stages:
            return self._count("pipe", None)
        return self._count("pipe", Mesh(self.pipe_devices[:n_stages],
                                        ("pipe",)))

    def sp_mesh(self, rows: int = 0, halo: int = 0):
        """An 'sp' mesh over the reserved spatial devices, or None when
        spatial parallelism is off or ``rows`` can't shard over it
        (must divide evenly with each local shard >= ``halo``)."""
        if not self.sp_devices:
            return None
        n = len(self.sp_devices)
        if rows and (rows % n != 0 or rows // n < halo):
            return self._count("sp", None)
        return self._count("sp", Mesh(self.sp_devices, ("sp",)))

    def ep_mesh(self, n_experts: int = 0):
        """An 'expert' mesh over the reserved expert-parallel devices, or
        None when expert parallelism is off or ``n_experts`` doesn't
        divide the axis (MoE ops fall back to the single-device reference
        formulation)."""
        if not self.ep_devices:
            return None
        n = len(self.ep_devices)
        if n_experts and n_experts % n != 0:
            return self._count("expert", None)
        return self._count("expert", Mesh(self.ep_devices, ("expert",)))

    @property
    def fps(self) -> float:
        return float(self.stream_meta.get("fps", 30.0))

    @property
    def frame_width(self) -> int:
        return int(self.stream_meta.get("width", 0))

    @property
    def frame_height(self) -> int:
        return int(self.stream_meta.get("height", 0))

    def kernel_instance(self, cls, params: dict, cached: bool = True):
        """Instantiate a Kernel-style class with the reference lifecycle."""
        key = (cls, tuple(sorted(params.items())))
        if cached and key in self._kernel_cache:
            return self._kernel_cache[key]
        inst = cls(self, **params) if _wants_config(cls) else cls()
        if hasattr(inst, "fetch_resources"):
            inst.fetch_resources()
        if hasattr(inst, "setup_with_resources"):
            inst.setup_with_resources()
        if cached:
            self._kernel_cache[key] = inst
        return inst

    def close(self) -> None:
        for inst in self._kernel_cache.values():
            if hasattr(inst, "close"):
                try:
                    inst.close()
                except Exception:
                    pass
        self._kernel_cache.clear()


def _wants_config(cls) -> bool:
    import inspect

    try:
        sig = inspect.signature(cls.__init__)
        return len(sig.parameters) > 1
    except (TypeError, ValueError):
        return False


class Kernel:
    """Base class for user python kernels (reference scannerpy.Kernel)."""

    def __init__(self, config: OpContext, **kwargs):
        self.config = config
        self.params = kwargs

    def fetch_resources(self) -> None:
        pass

    def setup_with_resources(self) -> None:
        pass

    def execute(self, *columns):
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass
