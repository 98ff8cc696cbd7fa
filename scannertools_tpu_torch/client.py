"""Client — the user entry point.

Reference parity: ``scannerpy.Client`` (``sc``) with ``sc.io.Input/Output``,
``sc.ops.<OpName>``, ``sc.streams.Gather/Range/Stride``, ``sc.run(...)``,
``sc.ingest_videos`` (reference tests/test_all.py:38-47,150-177). In the
reference the client talks gRPC to the Scanner master; here it owns the local
db, the profiler, the executor and the torch device its device ops run on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch

from .config import CacheMode, Config, PerfParams
from .graph import (InputNode, Node, NodeOutput, OpNode, OutputNode,
                    SampleNode, as_output)
from .registry import get_op, has_op
from .runtime.executor import Executor
from .runtime.profiler import Profiler
from .storage.named import NamedStream, NamedVideoStream


class _OpFactory:
    def __init__(self, name: str):
        self._name = name

    def __call__(self, **kwargs) -> Union[Node, NodeOutput]:
        from .registry import get_composite

        inputs: Dict[str, NodeOutput] = {}
        params: Dict[str, Any] = {}
        device = None
        for k, v in kwargs.items():
            if isinstance(v, (Node, NodeOutput)):
                inputs[k] = as_output(v)
            elif k == "device":
                # DeviceType.CPU forces this op's segment onto CPU tensors
                # (reference DeviceTestBench, tests/test_all.py:141-147);
                # GPU/TPU/None run on the client's device.
                from .config import DeviceType

                if v in (DeviceType.CPU, "cpu"):
                    device = "cpu"
            else:
                params[k] = v
        build = get_composite(self._name)
        if build is not None:
            # composite op: expands into a device-forward + host-decode
            # sub-graph (registry.register_composite)
            return build(inputs, params, device)
        get_op(self._name)  # validate the name
        node = OpNode(self._name, inputs, params, device=device)
        return node


class _OpsNamespace:
    def __getattr__(self, name: str) -> _OpFactory:
        if not has_op(name):
            raise AttributeError(f"no registered op {name!r}")
        return _OpFactory(name)


class _IoNamespace:
    def __init__(self, sc: "Client"):
        self._sc = sc

    def Input(self, streams: Sequence[Any]) -> InputNode:
        return InputNode(streams)

    def Output(self, op, streams: Sequence[Any]) -> OutputNode:
        if isinstance(op, (list, tuple)):
            cols = [as_output(o) for o in op]
        else:
            cols = [as_output(op)]
        return OutputNode(cols, streams)


class _StreamsNamespace:
    def Gather(self, src, indices_per_job: Sequence[Sequence[int]]) -> SampleNode:
        return SampleNode(as_output(src), "gather", [list(i) for i in indices_per_job])

    def Range(self, src, ranges) -> SampleNode:
        """Range(src, [(start, end)]) or Range(src, start, end) for one job."""
        if isinstance(ranges, int):
            raise TypeError("use Range(src, [(start, end), ...])")
        if ranges and isinstance(ranges[0], int):
            ranges = [tuple(ranges)]
        return SampleNode(as_output(src), "range", [tuple(r) for r in ranges])

    def Stride(self, src, strides: Sequence[int]) -> SampleNode:
        return SampleNode(as_output(src), "stride", list(strides))

    def StridedRange(self, src, specs) -> SampleNode:
        return SampleNode(as_output(src), "strided_range", [tuple(s) for s in specs])


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scannertools_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev


class Client:
    """``sc = Client()``; optionally pass a Config or db_path.

    ``device``: the torch device device ops run on. None means "cuda",
    and raises where CUDA is absent rather than falling back to the CPU;
    pass ``device="cpu"`` to run there (the kernels' plain versions)."""

    def __init__(self, config: Optional[Config] = None, db_path: Optional[str] = None,
                 device=None, **_parity_kwargs):
        self.device = _resolve_device(device)
        if config is None:
            config = Config()
        if db_path is not None:
            config.db_path = db_path
        import os

        os.makedirs(config.db_path, exist_ok=True)
        self.config = config
        self.profiler = Profiler()
        self.ops = _OpsNamespace()
        self.io = _IoNamespace(self)
        self.streams = _StreamsNamespace()
        self._executor = Executor(self)

    # -- reference-parity helpers ------------------------------------------

    def ingest_videos(self, named_paths, inplace: bool = True):
        """[(name, path), ...] -> [NamedVideoStream]; ``inplace=False`` copies
        the container into the db (reference sc.ingest_videos)."""
        return [
            NamedVideoStream(self, name, path=path, copy=not inplace)
            for name, path in named_paths
        ]

    def run(
        self,
        output: OutputNode,
        perf_params: Optional[PerfParams] = None,
        cache_mode: CacheMode = CacheMode.Error,
        show_progress: bool = False,
        trace_dir: Optional[str] = None,
        job_distribution: str = "static",
        **_parity_kwargs,
    ):
        """Execute the graph. ``trace_dir`` wraps the run in a
        torch.profiler trace (device timeline; pair with
        profiler.write_trace for host spans — the reference's
        profiler().write_trace analog). Jobs run in order in this process:
        ``job_distribution="claims"`` (elastic multi-host work stealing) is
        not available in this package."""
        from .runtime.profiler import torch_trace

        if job_distribution != "static":
            raise NotImplementedError(
                f"job_distribution={job_distribution!r}: this package runs "
                "one process's jobs in order ('static')")
        with torch_trace(trace_dir):
            self._executor.run(output, perf_params, cache_mode,
                               show_progress)

    def table(self, name: str) -> "NamedStream":
        """Handle to a named stream (reference ``sc.table(name)``, used e.g.
        for ``sc.table(t).profiler().write_trace(...)``)."""
        stream = NamedStream(self, name)
        stream.profiler = lambda: self.profiler  # type: ignore[attr-defined]
        return stream

    def summarize(self) -> str:
        lines = ["profiler totals (s):"]
        for k, v in sorted(self.profiler.totals().items()):
            lines.append(f"  {k:40s} {v:8.3f}")
        return "\n".join(lines)
