"""Legacy high-level Pipeline API.

Reference parity: the ``old/`` pipeline classes (old/prelude.py:219-424):
an abstract ``Pipeline`` with ``fetch_resources → build_sources →
build_pipeline → build_sink → run (job-cache aware) → parse_output`` and
``make_runner()`` turning a class into a one-call function, e.g.
``compute_histograms = HistogramPipeline.make_runner()``
(old/histograms.py:18). Batching/megabatching (old/prelude.py:344-348) is
unnecessary here — the executor streams chunks — but the UX is preserved.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..config import CacheMode, PerfParams
from ..storage.named import NamedStream, NamedVideoStream


class Pipeline:
    """Subclass and set ``job_suffix``; override ``build_pipeline``.

    ``execute(videos=[...], frames=[[...]], ...)`` runs one job per video
    and returns per-video output handles (lists of parsed elements are a
    ``list(stream.load())`` away, matching the reference's lazy loads).
    """

    job_suffix: Optional[str] = None
    base_sources = ["videos", "frames"]
    additional_sources: List[str] = []
    run_opts: Dict[str, Any] = {}
    parser_fn = None

    def __init__(self, sc):
        self._sc = sc
        self._sources: Dict[str, Any] = {}

    # -- overridable stages (old/prelude.py:264-323) ----------------------
    def fetch_resources(self) -> None:
        pass

    def build_sources(self, videos=None, frames=None, **kwargs):
        sc = self._sc
        streams = []
        for v in videos:
            if isinstance(v, NamedVideoStream):
                streams.append(v)
            else:  # path string: ingest under a derived table name
                import os

                name = os.path.splitext(os.path.basename(str(v)))[0]
                streams.append(NamedVideoStream(sc, name, path=str(v)))
        self._videos = streams
        frame = sc.io.Input(streams)
        if frames is not None:
            frame = sc.streams.Gather(frame, frames)
        self._sources = {"frame": frame}
        for k in self.additional_sources:
            if k in kwargs:
                self._sources[k] = kwargs[k]
        return self._sources

    def build_pipeline(self):
        raise NotImplementedError

    def build_sink(self, output_op):
        sc = self._sc
        self._output_streams = [
            NamedStream(sc, f"{v.name}_{self.job_suffix}")
            for v in self._videos
        ]
        return sc.io.Output(output_op, self._output_streams)

    def parse_output(self):
        return self._output_streams

    # -- driver (old/prelude.py:326-353) ----------------------------------
    def execute(self, cache: bool = True, **kwargs):
        self.fetch_resources()
        self.build_sources(**kwargs)
        output_op = self.build_pipeline()
        sink = self.build_sink(output_op)
        cache_mode = CacheMode.Ignore if cache else CacheMode.Overwrite
        pp = PerfParams.manual(**self.run_opts) if self.run_opts \
            else PerfParams.estimate()
        self._sc.run(sink, pp, cache_mode=cache_mode)
        return self.parse_output()

    @classmethod
    def make_runner(cls):
        def runner(sc, **kwargs):
            return cls(sc).execute(**kwargs)

        runner.__name__ = f"run_{cls.__name__}"
        runner.__doc__ = cls.__doc__
        return runner
