"""Per-op execution context.

Reference parity: scannerpy ``KernelConfig`` (devices/args/output_columns) plus
the Kernel resource lifecycle (``fetch_resources``/``setup_with_resources``,
face_embedding.py:31-52). Kernel-class instances are cached per (op, params)
so TF/torch-style sessions are built once per job, like the reference's
one-kernel-instance-per-worker model.

The multi-device reservations of the JAX package (pipeline, spatial and
expert meshes) are not carried here: this package runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .. import protobufs


class OpContext:
    def __init__(
        self,
        job: int = 0,
        stream_meta: Optional[dict] = None,
        resources_dir: str = "/tmp/scannertools_tpu_resources",
        profiler=None,
        device=None,
    ):
        self.job = job
        self.stream_meta = stream_meta or {}
        self.resources_dir = resources_dir
        self.profiler = profiler
        self.protobufs = protobufs
        #: the torch device the run's device ops compute on
        self.device = device
        self._kernel_cache: Dict[Tuple, Any] = {}

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
