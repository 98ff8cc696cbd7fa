"""Block-graph pipeline API (the reference's ``old/pipeline.py`` v2 design).

Reference parity: Block/BlockGraph with declared outputs, signature-derived
inputs, topological wiring, and named-output records
(old/pipeline.py:12-211). A Block's ``build(**inputs)`` returns
``self.Output(name=node, ...)``; ``BlockGraph`` wires blocks by matching
each block's build-parameter names against upstream output names and runs
the result through the standard executor.

Example::

    g = BlockGraph(sc)
    g.add(FrameSourceBlock(video))
    g.add(HistogramBlock())
    g.add(ShotBoundariesBlock())
    outputs = g.run(sinks={"boundaries": NamedStream(sc, "shots")})
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional

from ..config import CacheMode, PerfParams


class Block:
    """Declares named outputs; ``build(**inputs)`` wires graph nodes."""

    outputs: List[str] = []

    def _pipeline_initialize(self, sc) -> None:
        self.sc = sc

    def fetch_resources(self) -> None:
        pass

    def validate(self) -> None:
        pass

    def Output(self, **named):
        missing = set(self.outputs) - set(named)
        if missing:
            raise ValueError(f"{self}: build() omitted outputs {missing}")
        return named

    def build(self, **inputs):
        raise NotImplementedError

    def input_names(self) -> List[str]:
        sig = inspect.signature(self.build)
        return [p for p in sig.parameters if p != "self"]

    def __str__(self):
        return type(self).__name__


class BlockGraph:
    def __init__(self, sc):
        self._sc = sc
        self._blocks: List[Block] = []

    def add(self, block: Block) -> Block:
        block._pipeline_initialize(self._sc)
        self._blocks.append(block)
        return block

    def wire(self) -> Dict[str, Any]:
        """Topologically build every block, resolving build() parameters
        from previously produced named outputs (old/pipeline.py toposort)."""
        produced: Dict[str, Any] = {}
        pending = list(self._blocks)
        progress = True
        while pending and progress:
            progress = False
            for block in list(pending):
                needs = block.input_names()
                if all(n in produced for n in needs):
                    block.fetch_resources()
                    block.validate()
                    out = block.build(**{n: produced[n] for n in needs})
                    for name, node in out.items():
                        if name in produced:
                            raise ValueError(
                                f"duplicate output name {name!r} "
                                f"(from {block})"
                            )
                        produced[name] = node
                    pending.remove(block)
                    progress = True
        if pending:
            unmet = {str(b): [n for n in b.input_names()
                              if n not in produced] for b in pending}
            raise ValueError(f"unsatisfiable block inputs: {unmet}")
        return produced

    def run(self, sinks: Dict[str, Any],
            perf_params: Optional[PerfParams] = None,
            cache_mode: CacheMode = CacheMode.Overwrite):
        """Wire, attach sinks by output name, execute; returns the sinks."""
        produced = self.wire()
        sc = self._sc
        for name, stream in sinks.items():
            if name not in produced:
                raise KeyError(f"no block produced output {name!r}; have "
                               f"{sorted(produced)}")
            sc.run(sc.io.Output(produced[name], [stream]),
                   perf_params or PerfParams.estimate(),
                   cache_mode=cache_mode)
        return sinks


# ---- standard blocks (old/pipeline.py's Histogram/FaceDetect analogs) ----

class FrameSourceBlock(Block):
    outputs = ["frame"]

    def __init__(self, *streams):
        self._streams = list(streams)

    def build(self):
        return self.Output(frame=self.sc.io.Input(self._streams))


class GatherBlock(Block):
    outputs = ["sampled"]

    def __init__(self, indices_per_job):
        self._indices = indices_per_job

    def build(self, frame):
        return self.Output(
            sampled=self.sc.streams.Gather(frame, self._indices))


class HistogramBlock(Block):
    outputs = ["histogram"]

    def build(self, frame):
        return self.Output(histogram=self.sc.ops.Histogram(frame=frame))


class ShotBoundariesBlock(Block):
    outputs = ["boundaries"]

    def build(self, histogram):
        return self.Output(
            boundaries=self.sc.ops.ShotBoundaries(histograms=histogram))


class FaceDetectBlock(Block):
    outputs = ["face_bboxes"]

    def build(self, frame):
        return self.Output(
            face_bboxes=self.sc.ops.MTCNNDetectFaces(frame=frame))


class OpticalFlowBlock(Block):
    outputs = ["flow"]

    def build(self, frame):
        return self.Output(flow=self.sc.ops.OpticalFlow(frames=frame))
