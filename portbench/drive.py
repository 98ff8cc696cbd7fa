"""What the benchmark hands the program, and how it watches it.

  * ``draw_pool``: the frames, drawn from the seed on the run's device in
    a few large calls: a smooth colour texture with bright elliptic blobs.
  * ``PoolDecoder``: a memory-backed decoder behind the program's
    ``NamedVideoStream.decoder()`` hook. It writes pool frames into the
    staging slot the executor hands it, records each packet it is asked
    for, and raises ``WindowClosed`` once the window has closed. It
    bypasses video decode.
  * ``StampedStream``: the output stream; its writer stamps the moment each
    row is appended to storage and keeps the row's bytes for the check.
  * ``Recorder``: the packets asked for and stored, and the window they
    make.
  * ``runner``: the cell's runner class (``pipelines/std.py``) with the op
    parameters the configuration states, storing its output column and the
    configuration's extra columns.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.nn.functional as F


class WindowClosed(Exception):
    """Raised by the decoder once the measured window has closed."""


def draw_pool(traffic: dict, gen: torch.Generator, device) -> torch.Tensor:
    """[P, H, W, 3] uint8 frames on ``device``: a texture of smoothed noise
    (values 30-150) under ``blobs`` bright ellipses a frame (skin-toned,
    radii 16-60 px, soft edges)."""
    p, h, w = traffic["pool_frames"], traffic["height"], traffic["width"]
    lo, hi = traffic["blobs"]
    noise = torch.rand((p, 3, max(h // 16, 2), max(w // 16, 2)),
                       generator=gen, device=device)
    tex = F.interpolate(noise, size=(h, w), mode="bilinear",
                        align_corners=False)
    tex = (tex - tex.amin()) / (tex.amax() - tex.amin() + 1e-6) * 120 + 30
    frames = tex.permute(0, 2, 3, 1).contiguous()
    n_blob = hi
    u = torch.rand((p, max(n_blob, 1), 8), generator=gen, device=device)
    count = lo + (u[:, 0, 7] * (hi - lo + 1)).floor().clamp(max=hi - lo)
    keep = torch.arange(n_blob, device=device)[None, :] < count[:, None]
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    for b in range(n_blob):
        cy = (u[:, b, 0] * h).view(-1, 1, 1)
        cx = (u[:, b, 1] * w).view(-1, 1, 1)
        ry = (16 + u[:, b, 2] * 44).view(-1, 1, 1)
        rx = (16 + u[:, b, 3] * 44).view(-1, 1, 1)
        colour = 150 + u[:, b, 4:7] * 100
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        a = (torch.exp(-2.0 * d) * keep[:, b].view(-1, 1, 1))[..., None]
        frames = frames * (1 - a) + colour.view(-1, 1, 1, 3) * a
    return frames.clamp(0, 255).to(torch.uint8)


class Recorder:
    """The stamps of one run: the packets the decoder was asked for, and
    when and what the sink appended.

    The window opens at the first packet stored in every column and
    closes at the first packet stored ``seconds`` or more after it; the
    decoder's next request then raises ``WindowClosed``. Its rate is the
    frames of the packets stored after the opening one, over the time
    between the two: all the work done in that time, with no packet in
    flight at either end.
    """

    def __init__(self, columns, seconds: float = float("inf")):
        self.columns, self.seconds = list(columns), seconds
        self.chunks = {}  # clip -> {first row: rows}
        self.appended = {}  # column -> clip -> [(time, bytes)]
        self.stored = {}  # clip -> rows stored in every column
        self.done = []  # (time, clip, first row, rows), in storing order
        self.closed = False
        self.lock = threading.Lock()

    def ask(self, clip: str, rows) -> None:
        if self.closed:
            raise WindowClosed()
        rows = [int(r) for r in rows]
        with self.lock:
            mine = self.chunks.setdefault(clip, {})
            # a one-row read that opens a job ahead of time is not a packet
            mine[rows[0]] = max(mine.get(rows[0], 0), len(rows))

    def append(self, column: str, clip: str, data: bytes) -> None:
        now = time.perf_counter()
        with self.lock:
            self.appended.setdefault(column, {}).setdefault(clip, []).append(
                (now, data))
            stored = min(len(self.appended.get(c, {}).get(clip, ()))
                         for c in self.columns)
            before = self.stored.get(clip, 0)
            self.stored[clip] = stored
            for first, n in sorted(self.chunks.get(clip, {}).items()):
                if before < first + n <= stored:
                    self.done.append((now, clip, first, n))
                    if now - self.done[0][0] >= self.seconds:
                        self.closed = True

    def window(self):
        """(t0, t1, packets): the window's ends and the packets stored in
        it, each (clip, first row, rows); None before it has closed."""
        end = next((i for i, d in enumerate(self.done)
                    if d[0] - self.done[0][0] >= self.seconds), None)
        if end is None:
            return None
        return (self.done[0][0], self.done[end][0],
                [d[1:] for d in self.done[1:end + 1]])

    def row(self, clip: str, r: int) -> dict:
        """{column: bytes} of row ``r`` of ``clip``."""
        return {c: self.appended[c][clip][r][1] for c in self.columns}


class PoolDecoder:
    """The executor's decoder interface over the frame pool: row r of clip
    ``clip`` is pool frame (offset + r) mod P."""

    i420_supported = False

    def __init__(self, pool: np.ndarray, offset: int, clip: str,
                 recorder: Recorder):
        self.pool, self.offset, self.clip = pool, offset, clip
        self.recorder = recorder

    def read_frames(self, rows, out=None):
        self.recorder.ask(self.clip, rows)
        idx = (self.offset + np.asarray(rows, np.int64)) % len(self.pool)
        if out is None:
            out = np.empty((len(rows), *self.pool.shape[1:]), np.uint8)
        np.take(self.pool, idx, axis=0, out=out)
        return out

    def close(self) -> None:
        pass


def packet_rows(traffic: dict, h: int, w: int) -> int:
    """Frames a work packet: the traffic file's fixed ``perf``, or what the
    runner's default ``PerfParams.estimate()`` resolves to for h x w RGB
    frames."""
    if traffic.get("perf"):
        return traffic["perf"]["work_packet_size"]
    from scannertools_tpu_torch.config import PerfParams

    return PerfParams.estimate().resolve(frame_bytes=h * w * 3) \
        .work_packet_size


def clip_streams(sc, pool: np.ndarray, offsets, n_frames: int,
                 recorder: Recorder, prefix: str = "clip"):
    """One NamedVideoStream a clip over the pool, named ``prefix`` and its
    index."""
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.io.video import VideoMetadata

    _, h, w, _ = pool.shape

    class PoolVideo(st.NamedVideoStream):
        def __init__(self, name, offset):
            super().__init__(sc, name)
            self._offset = offset

        def __len__(self):
            return n_frames

        def video_path(self):
            return "memory"

        def metadata(self):
            return VideoMetadata("memory", n_frames, 30.0, w, h)

        def decoder(self):
            return PoolDecoder(pool, self._offset, self.name, recorder)

    return [PoolVideo(f"{prefix}{i:05d}", int(o))
            for i, o in enumerate(offsets)]


def stamped_stream(sc, name: str, clip: str, column: str,
                   recorder: Recorder):
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.storage.named import NamedStreamWriter

    class StampedWriter(NamedStreamWriter):
        def append(self, element: bytes) -> None:
            super().append(element)
            recorder.append(column, clip, element)

    class StampedStream(st.NamedStream):
        def writer(self, type_name: str):
            return StampedWriter(self, type_name)

    return StampedStream(sc, name)


class _ParamOps:
    """``sc.ops`` with the configuration's parameters added to each op it
    names; remembers the node each op call made."""

    def __init__(self, ops, params: dict, made: dict):
        self._ops, self._params, self._made = ops, params, made

    def __getattr__(self, name):
        factory = getattr(self._ops, name)

        def call(**kwargs):
            node = factory(**{**self._params.get(name, {}), **kwargs})
            self._made[name] = node
            return node
        return call


class _ParamClient:
    def __init__(self, sc, params: dict, made: dict):
        self._sc = sc
        self.ops = _ParamOps(sc.ops, params, made)

    def __getattr__(self, name):
        return getattr(self._sc, name)


def columns(cfg: dict) -> list:
    """The columns a row of the cell stores."""
    return [cfg["output_column"]] + [e["column"] for e in cfg["extra_outputs"]]


def runner(cfg: dict, perf, recorder: Recorder):
    """The configuration's runner class, built with its op parameters,
    storing its output column and ``extra_outputs`` into stamped
    streams (one a clip and column). ``perf`` None keeps the runner's own
    ``PerfParams`` (``PerfParams.estimate()``, what a user of the runner
    gets); a dict fixes them through ``PerfParams.manual``."""
    from scannertools_tpu_torch.pipelines import std

    base = getattr(std, cfg["runner"])
    cols = columns(cfg)

    class Bench(base):
        run_opts = dict(perf or base.run_opts)

        def build_pipeline(self):
            made = {}
            real = self._sc
            self._sc = _ParamClient(real, cfg["op_params"], made)
            try:
                out = super().build_pipeline()
            finally:
                self._sc = real
            return [out] + [made[e["op"]] for e in cfg["extra_outputs"]]

        def build_sink(self, output_op):
            sc = self._sc
            self._output_streams = [
                tuple(stamped_stream(sc, f"{v.name}_{c}", v.name, c,
                                     recorder) for c in cols)
                for v in self._videos]
            return sc.io.Output(output_op, self._output_streams)

    return Bench
