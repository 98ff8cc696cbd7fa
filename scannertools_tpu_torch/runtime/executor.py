"""Graph executor: runs the pipeline IR as eager torch chunk programs on the
client's device, or shard by shard over a mesh of devices.

This is the replacement for the Scanner engine's run loop (master/worker
gRPC scheduling + C++ kernel threads, SURVEY §1 L0). The design:

  * Maximal runs of device ops form a segment; a segment runs its ops in
    order on the client's device, so intermediates stay on the device.
  * Temporal stencils (reference ``.stencil({0,1})``, e.g. optical flow) are
    planned as chunk halos: a backward interval pass computes how many extra
    rows each node needs; sources decode the halo (replicate-clamped at
    stream edges, matching the engine's boundary handling).
  * Stateful ops (reference bounded/unbounded state: tracker.py:12,
    montage_kernel_cpu.cpp:111) carry python state chunk-to-chunk and force
    per-stream sequential order (which this executor is anyway).
  * Whole-stream ops (reference batch=10**7 idiom, shot_detection.py:11)
    accumulate their inputs across chunks and run once at end-of-stream.
  * A job (stream; ``Executor._run_job``) runs as fixed-size frame chunks
    (``work_packet_size``): its axes (``_reserve_axes``), writers and the
    chunks left to run (``_resume_chunks``), one ``_Source`` an
    input (decoder, staging ring, upload decision), then the
    ``_ChunkPipeline``. A prefetch thread decodes ``prefetch_depth``
    chunks ahead and, on CUDA, uploads each on a side stream
    (``_Uploader``).
  * A chunk's device part is every node up to and including the last
    device op; its host tail is the nodes after it and the sink writes.
    Per chunk: ``ctx.packet`` is set, the compute stream adopts each
    upload, the device part runs, uploaded ring slots are released, and
    a ``_Tail`` keeps what the tail reads. Without a host tail (the job
    counts ``pipeline:not_engaged``) it finishes at once; else the
    previous tail is counted (``pipeline:deferred_tail``) and finished
    after this chunk's device part, so the host's work on chunk n
    overlaps the card's on chunk n+1 (on CUDA on a stream of its own,
    ``_Tail``). A tail finishes with its ops, sink writes, the release of
    host-kept slots, ``Profiler.poll``, the heartbeat and the progress.
  * End of stream: the whole-stream ops, the deferred sink columns, the
    commits. Teardown: the sink worker, each ring's cancel, the decode
    thread's join, each ring and decoder closed, the context closed.
  * Multi-device (the JAX package's axes; here the executor splits a
    segment, see ``_run_device_segment``): with
    ``pipeline_instances_per_node != 1`` and more than one local device,
    runs of ``row_local``/``batch_local`` ops go shard by shard over a
    data mesh and ``inner_split`` ops split their nets' batch. The
    pipeline, spatial and expert axes are reservations of devices that
    the ops' own sharded forms use (runtime/context.py); at most one axis
    runs at a time. Static job distribution takes this process's slice
    of the jobs (``parallel/sharded.host_job_slice``: ``RANK`` of
    ``WORLD_SIZE``).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as typeslib
from ..config import CacheMode, PerfParams
from ..graph import (InputNode, Node, NodeOutput, OpNode, OutputNode,
                     SampleNode, toposort)
from ..parallel.mesh import local_devices
from ..parallel.sharded import (data_mesh, gather_rows, host_job_slice,
                                pad_rows_to, row_windows)
from ..registry import get_op
from ..utils.flags import current_mesh, shard_states, sharded_mode
from ..utils.framechunk import FrameChunk
from .context import OpContext
from .profiler import Profiler


def _data_runs(seg: List[OpNode]) -> List[Tuple[Optional[str], list]]:
    """A device segment's ops in maximal runs of one treatment on the
    data mesh, in order: ("row_local" | "batch_local", ops) split frames
    a shard (the run is "batch_local" if any of its ops is),
    ("inner_split", ops) and (None, ops) whole."""
    split = ("row_local", "batch_local")
    runs: List[Tuple[Optional[str], list]] = []
    for node in seg:
        cls = get_op(node.name).data_class(node.params)
        last = runs[-1][0] if runs else "none"
        if last in split and cls in split:
            both = "row_local" if last == cls == "row_local" \
                else "batch_local"
            runs[-1] = (both, runs[-1][1] + [node])
        elif last == cls:
            runs[-1][1].append(node)
        else:
            runs.append((cls, [node]))
    return runs


def _rss_mb() -> float:
    """Resident set size of this process in MB (Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _run_key(output: OutputNode) -> str:
    """The claims namespace of a run: its sink streams' names, as the JAX
    package's executor joins them, so both packages' runs of one graph on
    one db share claims."""
    return "|".join(
        getattr(s, "name", f"{type(s).__name__}#{i}")
        for i, s in enumerate(
            x for job_s in output.streams
            for x in (job_s if isinstance(job_s, (list, tuple)) else [job_s])
        )
    )


def _root_of(node: Node) -> Node:
    """The node under a chain of ``SampleNode``s (else ``node``)."""
    while isinstance(node, SampleNode):
        node = node.inputs["input"].node
    return node


def _video_meta(stream) -> Dict[str, Any]:
    """A video input's ``{fps, width, height}``; {} for another input."""
    if not getattr(stream, "is_video", False):
        return {}
    m = stream.metadata()
    return {"fps": m.fps, "width": m.width, "height": m.height}


def _declared_axes(order: List[Node]) -> Dict[str, List[int]]:
    """The axes the graph's ops declare (OpDef.sp_halo/stages/experts):
    {"sp": halos, "stages": counts >= 2, "experts": counts > 0}."""
    declared = {"sp": [], "stages": [], "experts": []}
    for n in order:
        if not isinstance(n, OpNode):
            continue
        od = get_op(n.name)
        if od.sp_halo is not None:
            h = od.sp_halo(n.params)
            if h is not None:
                declared["sp"].append(int(h))
        for key, declare, least in (("stages", od.stages, 2),
                                    ("experts", od.experts, 1)):
            k = 0 if declare is None else int(declare(n.params) or 0)
            if k >= least:
                declared[key].append(k)
    return declared


def _ser_params(v) -> str:
    """Deterministic serialization for op params (array bytes hashed, not
    elided by repr) — used by the resume signature and the aux cache."""
    if isinstance(v, np.ndarray):
        return (f"ndarray({v.shape},{v.dtype},"
                f"{hashlib.sha256(v.tobytes()).hexdigest()})")
    if isinstance(v, (list, tuple)):
        return f"{type(v).__name__}[" + ",".join(_ser_params(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k!r}:{_ser_params(x)}" for k, x in sorted(v.items(), key=repr)
        ) + "}"
    return repr(v)


def _tree_to(val, device: torch.device):
    """Move every array leaf of a dict/list/tuple tree to ``device``."""
    if isinstance(val, dict):
        return {k: _tree_to(v, device) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return type(val)(_tree_to(v, device) for v in val)
    if isinstance(val, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(val).to(device)
    return val


def _to_device(data, device: torch.device):
    """Segment input -> the segment's device (FrameChunk or tensor)."""
    if isinstance(data, FrameChunk):
        if not data.on_host and data.flat.device == device:
            return data
        return data.device(device)
    if isinstance(data, list):
        data = np.stack(data)
    return torch.as_tensor(data).to(device)


def _to_host(data):
    """Device value -> host object for host ops / sinks."""
    if isinstance(data, FrameChunk):
        return data.host().hwc_u8()
    if isinstance(data, list):
        return data
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    return np.asarray(data)


class _Value:
    """A chunk-scoped dataflow value: rows [a+lo, b+hi] of a node's stream."""

    __slots__ = ("data", "lo", "hi", "is_device", "ready")

    def __init__(self, data, lo: int, hi: int, is_device: bool, ready=None):
        self.data = data
        self.lo = lo
        self.hi = hi
        self.is_device = is_device
        #: CUDA event recorded after this value's upload (None otherwise)
        self.ready = ready

    def slice_rows(self, want_lo: int, want_hi: int, T: int):
        """Rows [a+want_lo, b+want_hi] of this value (static offsets)."""
        start = want_lo - self.lo
        length = T + (want_hi - want_lo)
        assert start >= 0, (start, want_lo, self.lo)
        if isinstance(self.data, FrameChunk):
            return self.data.slice_rows(start, length)
        return self.data[start : start + length]


class _Uploader:
    """Host->device upload of decoded chunks, run by the prefetch thread.

    On CUDA the copy runs on a side stream, so it overlaps the compute
    stream's work on the previous chunk. The staging ring is pageable:
    page-locking it cost 1.62-2.09 s a job on 480-frame jobs, more than
    the asynchronous copy saved (PERF.md); whether a pinned ring pays on
    long jobs is open (ROADMAP 4.3). An event recorded after the copy is
    (a) waited on by the compute stream before the chunk is used and (b)
    synchronized by the prefetch thread before it hands the chunk over,
    so nothing reads a ring slot the consumer releases. The uploaded
    tensor was allocated on the side stream, so the consumer calls
    ``record_stream`` on it before the allocator may reuse it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def upload(self, chunk: FrameChunk):
        """-> (device chunk, CUDA event or None)."""
        if not self.cuda:
            return chunk.device(self.device), None
        with torch.cuda.stream(self._stream):
            dev = chunk.device(self.device)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        ready.synchronize()
        return dev, ready

    def adopt(self, val: _Value) -> None:
        """Consumer side: order the compute stream after the upload."""
        if val.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(val.ready)
        val.data.flat.record_stream(stream)


class _Source:
    """One input of a job: its stream, sampled ``rows``, the rows
    (``lo``, ``hi``) around a chunk that the graph reads, decoder and
    ``meta`` (a video's ``{fps, width, height}``), whether the prefetch
    thread uploads its chunks (``upload``) as I420 planes (``yuv``), and
    its staging ring."""

    __slots__ = ("node", "stream", "rows", "lo", "hi", "decoder", "meta",
                 "upload", "yuv", "frame_bytes", "ring")

    def __init__(self, node, stream, rows, meta, decoder, order, need,
                 ingest, W, depth, host_tail):
        self.node, self.stream, self.rows = node, stream, rows
        self.lo, self.hi = need[node.id]
        self.decoder, self.meta = decoder, meta
        # When every consumer of this input's frames is a device op, the
        # prefetch thread uploads right after decode, overlapping the
        # previous chunk's compute. Mixed host/device consumers keep
        # frames on the host.
        frame_node_ids = {n.id for n in order if _root_of(n) is node}
        consumers = [n for n in order if isinstance(n, OpNode) and any(
            e.node.id in frame_node_ids for e in n.inputs.values())]
        self.upload = bool(consumers) and all(
            get_op(n.name).kind == "device"
            or get_op(n.name).device_inputs  # host op driving
            for n in consumers               # device programs
        ) and decoder is not None
        # I420 ingest: frames headed straight for the device travel as
        # 1.5 B/px YUV planes (half the upload bytes of RGB24, no host
        # swscale), with the YUV->RGB conversion fused into the device op
        # (hist_i420). Host-consumed frames keep the RGB24 decode — no
        # upload to save, and host ops expect RGB.
        can_i420 = getattr(decoder, "i420_supported", False)
        if ingest == "i420" and decoder is not None and not can_i420:
            raise ValueError(
                "PerfParams(ingest='i420') but the source cannot decode to "
                "planar I420 (non-4:2:0 pixel format, odd dims, or the cv2 "
                "fallback decoder)")
        self.yuv = self.upload and can_i420 and ingest in ("auto", "i420")
        self.frame_bytes = 0
        self.ring = None
        if decoder is not None and meta:
            from ..io.prefetch import ChunkRing

            pixels = meta["height"] * meta["width"]
            self.frame_bytes = pixels * 3 // 2 if self.yuv else pixels * 3
            # a deferred tail holds its chunk's host frames while the next
            # chunk runs: one slot more
            self.ring = ChunkRing(
                (W + (self.hi - self.lo)) * self.frame_bytes,
                depth + 2 + (host_tail and not self.upload))

    @classmethod
    def open(cls, node, stream, rows, meta, decoder, *plan) -> "_Source":
        """The source with ``decoder``, warmed ahead of the job, or else
        (a video input) one opened here and closed if the rest raises."""
        if decoder is None and getattr(stream, "is_video", False):
            decoder = stream.decoder()
        try:
            return cls(node, stream, rows, meta, decoder, *plan)
        except BaseException:
            if decoder is not None:
                decoder.close()
            raise

    def read(self, a: int, b: int, packet: dict, uploader: _Uploader,
             profiler: Profiler) -> _Value:
        """Rows [a + lo, b + hi] of the input, clamped to its ends, read
        into the next ring slot (uploaded if ``upload``) or, if it is not
        a video, loaded and parsed; ``packet`` is the spans' meta."""
        last = len(self.rows) - 1
        src_rows = [self.rows[max(0, min(last, p))]
                    for p in range(a + self.lo, b + self.hi + 1)]
        decoder, ring, meta = self.decoder, self.ring, self.meta
        out_buf = None
        if ring is not None:
            # slot waits (consumer busy) are not decode time — keep out of
            # source:read
            with profiler.span("source:wait_slot", **packet):
                slot = ring.acquire()
            n, fb = len(src_rows), self.frame_bytes
            shape = (n, fb) if self.yuv else (n, meta["height"],
                                              meta["width"], 3)
            out_buf = slot[: n * fb].reshape(shape)
        with profiler.span("source:read", **packet):
            if decoder is None:
                elems = list(self.stream.load_bytes(src_rows))
                parse = typeslib.get_type(self.stream.type_name()).parse
                return _Value([parse(e) for e in elems], self.lo, self.hi,
                              False)
            if self.yuv:
                planes = decoder.read_frames_i420(src_rows, out=out_buf)
                if ring is not None:
                    ring.commit()
                data = FrameChunk.from_i420(
                    planes, meta["height"], meta["width"],
                    full_range=getattr(decoder, "i420_full_range", False),
                    bt709=getattr(decoder, "i420_bt709", False))
            else:
                frames = decoder.read_frames(src_rows, out=out_buf)
                if ring is not None:
                    ring.commit()
                data = FrameChunk.from_hwc(frames)
            ready = None
            if self.upload:
                with profiler.span("source:upload", **packet):
                    data, ready = uploader.upload(data)
            return _Value(data, self.lo, self.hi, is_device=self.upload,
                          ready=ready)

    def release(self, uploaded: bool) -> None:
        """Recycle the oldest ring slot after the device part if the
        chunk was ``uploaded`` (the prefetch thread waited for the copy),
        after the tail if not (host consumers copied what they keep)."""
        if self.ring is not None and self.upload == uploaded:
            self.ring.release()

    def cancel(self) -> None:
        """Wake a producer blocked acquiring a ring slot."""
        if self.ring is not None:
            self.ring.cancel()

    def close(self) -> None:
        """Free the ring and the decoder (the decode thread joined)."""
        if self.ring is not None:
            self.ring.close()
        if self.decoder is not None:
            self.decoder.close()


def _tail_start(order: List[Node]) -> Tuple[int, Optional[str]]:
    """Where a chunk's host tail starts in ``order``: (the index after the
    last device op, None) when an op follows it; else (len(order), why
    the chunk runs whole)."""
    last = max((i for i, n in enumerate(order) if isinstance(n, OpNode)
                and get_op(n.name).kind == "device"), default=None)
    if last is None:
        return len(order), "no device op"
    if not any(isinstance(n, OpNode) for n in order[last + 1:]):
        return len(order), "no host tail"
    return last + 1, None


def _tensors(data):
    """The tensors of a value (a tensor, FrameChunk or nest of them)."""
    if isinstance(data, FrameChunk):
        data = data.flat
    if isinstance(data, torch.Tensor):
        yield data
    elif isinstance(data, (list, tuple)):
        for d in data:
            yield from _tensors(d)
    elif isinstance(data, dict):
        for d in data.values():
            yield from _tensors(d)


class _Tail:
    """A chunk's host tail, kept between its device part and its run:
    the chunk's rows, its packet meta and the values the tail reads.

    Deferred on CUDA (``defer``), it runs on a stream of its own: an event
    ends the chunk's device work on the compute stream, the tail's stream
    waits on it, and the tail's first wait on the device
    (``OpContext.settle``, inside its ``host:wait_device`` span) waits for
    it on the host, so each copy finds its data ready and none queues
    behind the next chunk's work on the compute stream."""

    __slots__ = ("row", "rows", "packet", "values", "ready", "stream")

    def __init__(self, row: int, rows: int, packet: dict,
                 values: Dict[Tuple[int, int], _Value]):
        self.row, self.rows, self.packet = row, rows, packet
        self.values = values
        self.ready = None
        self.stream = None

    def defer(self, stream) -> None:
        """Mark the end of the chunk's device work for ``stream`` (the
        tail's CUDA stream; None off CUDA: nothing to mark)."""
        if stream is None:
            return
        self.ready = torch.cuda.Event(blocking=True)
        self.ready.record(torch.cuda.current_stream(stream.device))
        self.stream = stream

    @contextlib.contextmanager
    def running(self, ctx: OpContext):
        """The tail's run: ``ctx`` names its packet, and a deferred tail
        computes and copies on its own stream after the chunk's device
        work."""
        ctx.packet = self.packet
        if self.stream is None:
            yield
            return
        stream, ready = self.stream, self.ready
        stream.wait_event(ready)
        for v in self.values.values():
            if v.is_device:
                for t in _tensors(v.data):
                    if t.device == stream.device:
                        t.record_stream(stream)

        def settle():
            ready.synchronize()  # the chunk's device work
            stream.synchronize()  # what the tail itself launched

        ctx.settle = settle
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            ctx.settle = None


class _ChunkPipeline:
    """A job's chunks from its sources to its sinks (the one-packet
    pipeline of the module docstring), then its end of stream.
    ``pending`` is the deferred tail that waits for the next chunk's
    device part; ``last`` is the chunk seen last, for the error note."""

    def __init__(self, ex, ctx, order, output, need, ws_nodes, writers,
                 shard_mode, n_out, W, heartbeat, show_progress):
        self.ex, self.profiler, self.ctx = ex, ex.profiler, ctx
        self.job = ctx.job
        self.need, self.ws_nodes, self.writers = need, ws_nodes, writers
        self.shard_mode, self.n_out, self.W = shard_mode, n_out, W
        self.heartbeat, self.show_progress = heartbeat, show_progress
        self.uploader = _Uploader(ex.device)
        split, not_engaged = _tail_start(order)
        self.device_part, self.tail_nodes = order[:split], order[split:]
        self.tail_reads = {(e.node.id, e.index)
                           for n in self.tail_nodes + [output]
                           for e in n.inputs.values()}
        if not_engaged is not None:
            self.profiler.count("pipeline:not_engaged", job=self.job,
                                reason=not_engaged)
        self.tail_stream = (torch.cuda.Stream(ex.device)
                            if ex.device.type == "cuda" and self.tail_nodes
                            else None)
        # whole-stream accumulators: node.id -> list of per-chunk host inputs
        self.ws_ids = {n.id for n in ws_nodes}
        self.ws_acc: Dict[int, List[List[Any]]] = {
            n.id: [[] for _ in n.inputs] for n in ws_nodes}
        self.state: Dict[int, Any] = {}
        self.sources: List[_Source] = []
        self.prefetched: Optional[_Prefetcher] = None
        self.sink_worker: Optional[_SinkWorker] = None
        self.pending: Optional[_Tail] = None
        self.last = (-1, 0)

    def read(self, a: int):
        """Chunk ``a`` of every source, on the decode thread ->
        (a, rows, {(source id, 0): value})."""
        b = min(a + self.W, self.n_out) - 1
        T = b - a + 1
        packet = {"job": self.job, "row": a, "rows": T}
        return a, T, {(s.node.id, 0): s.read(a, b, packet, self.uploader,
                                             self.profiler)
                      for s in self.sources}

    def run(self, chunks: Sequence[int], depth: int, on_drained) -> None:
        """Every chunk in ``chunks``, decoded ``depth`` ahead (inline at
        0), in the order the module docstring gives."""
        ex, ctx = self.ex, self.ctx
        self.prefetched = _Prefetcher(self.read, chunks, depth=depth,
                                      on_drained=on_drained)
        # sink serialization + IO runs off the critical path: chunk N+1's
        # decode/compute overlaps chunk N's writes (reference save workers)
        self.sink_worker = _SinkWorker(depth=2 * max(1, len(self.writers)))
        for a, T, src_vals in self.prefetched:
            self.last = (a, T)
            ctx.packet = {"job": self.job, "row": a, "rows": T}
            for v in src_vals.values():
                self.uploader.adopt(v)
            values: Dict[Tuple[int, int], _Value] = dict(src_vals)
            del src_vals
            ex._run_chunk(self.device_part, self.need, values, ctx, T,
                          self.state, self.ws_acc, self.ws_ids)
            for s in self.sources:
                s.release(uploaded=True)
            tail = _Tail(a, T, ctx.packet, {
                k: v for k, v in values.items() if k in self.tail_reads})
            del values
            if not self.tail_nodes:
                self._finish(tail)
                continue
            tail.defer(self.tail_stream)
            if self.pending is not None:
                self.profiler.count("pipeline:deferred_tail",
                                    **self.pending.packet)
            self.finish_pending()
            self.pending = tail
        self.finish_pending()

    def _finish(self, tail: _Tail) -> None:
        """Chunk ``tail.row``'s host tail and sink writes, then the
        release of host-kept slots, the poll, heartbeat and progress."""
        ex, ctx = self.ex, self.ctx
        self.last = (tail.row, tail.rows)
        with tail.running(ctx):
            ex._run_chunk(self.tail_nodes, self.need, tail.values, ctx,
                          tail.rows, self.state, self.ws_acc, self.ws_ids)
            # write non-deferred sink columns (async; the _to_host copy
            # inside stays synchronous)
            for edge, writer, deferred in self.writers:
                if deferred:
                    continue
                val = tail.values[(edge.node.id, edge.index)]
                ex._write_column(
                    writer, edge, val, tail.rows, ctx,
                    shard_start=tail.row if self.shard_mode else None,
                    sink_worker=self.sink_worker)
        for s in self.sources:
            s.release(uploaded=False)
        self.profiler.poll()
        if self.heartbeat is not None:
            self.heartbeat()
        if self.show_progress:
            print(f"  job {self.job}: rows {tail.row + tail.rows}/"
                  f"{self.n_out}", flush=True)

    def finish_pending(self) -> None:
        """Finish the pending tail, if there is one."""
        tail, self.pending = self.pending, None
        if tail is not None:
            self._finish(tail)

    def end_of_stream(self) -> None:
        """The whole-stream ops (each an ``op:<name>`` span over all the
        rows), the deferred sink columns, then every writer's commit."""
        # all async writes must land before deferred writes / commit
        self.sink_worker.flush()
        ws_out: Dict[Tuple[int, int], List[Any]] = {}
        for node in self.ws_nodes:
            opdef = get_op(node.name)
            args = [_concat_host(parts) for parts in self.ws_acc[node.id]]
            with self.profiler.span(f"op:{node.name}", job=self.job, row=0,
                                    rows=self.n_out):
                res = opdef.fn(self.ctx, *args, **node.params)
            if opdef.n_outputs == 1:
                res = (res,)
            for k, r in enumerate(res):
                ws_out[(node.id, k)] = list(r)
        for edge, writer, deferred in self.writers:
            if not deferred:
                continue
            ser = typeslib.get_type(self.ex._column_type(edge)).serialize
            for el in ws_out[(edge.node.id, edge.index)]:
                writer.append(b"" if el is None else ser(el))
        for _, writer, _ in self.writers:
            if self.shard_mode:
                writer.commit_from_shards(list(range(0, self.n_out, self.W)))
            else:
                writer.commit()

    def abort(self, e: Exception) -> None:
        """The job failed with ``e``: note the chunk, store the pending
        tail's chunk as it would have been without the deferral, abort
        the writers once the sink worker has stopped."""
        row, rows = self.last
        e.add_note(f"scannertools_tpu_torch: job {self.job}, chunk rows "
                   f"{row}..{row + rows - 1} of {self.n_out}")
        if self.pending is not None:
            try:
                self.finish_pending()
            except Exception as tail_error:
                e.add_note(f"its previous chunk's host tail failed "
                           f"too: {tail_error!r}")
        if self.sink_worker is not None:
            self.sink_worker.close()
        for _, writer, _ in self.writers:
            writer.abort()

    def close(self) -> None:
        """The job's teardown: the decode thread is woken and joined
        before the ring slots and decoders it writes are freed."""
        if self.sink_worker is not None:
            self.sink_worker.close()
        for s in self.sources:
            s.cancel()
        if self.prefetched is not None:
            self.prefetched.close()
        for s in self.sources:
            s.close()


class Executor:
    def __init__(self, client):
        self.client = client
        self.profiler: Profiler = client.profiler
        self.device: torch.device = client.device
        # resolved op aux trees (model weights), keyed by (op name,
        # serialized params, device): loaded and moved once per executor
        self._aux: Dict[Tuple[str, str, str], Any] = {}
        # the data mesh of the current run (None: unsharded)
        self._mesh = None

    # ------------------------------------------------------------------ plan

    def _intervals(self, order: List[Node]) -> Dict[int, Tuple[int, int]]:
        """Backward pass: rows (relative to the output chunk) each node must
        produce. Output/sink nodes need (0, 0); an op with stencil (s_lo,
        s_hi) needing (lo, hi) requires (lo+s_lo, hi+s_hi) of its inputs."""
        need: Dict[int, Tuple[int, int]] = {}

        def widen(nid: int, lo: int, hi: int):
            cur = need.get(nid, (0, 0))
            need[nid] = (min(cur[0], lo), max(cur[1], hi))

        for node in reversed(order):
            lo, hi = need.get(node.id, (0, 0))
            if isinstance(node, OpNode):
                s_lo, s_hi = get_op(node.name).stencil
            else:
                s_lo, s_hi = 0, 0
            for e in node.inputs.values():
                widen(e.node.id, lo + s_lo, hi + s_hi)
            need.setdefault(node.id, (lo, hi))
        return need

    def _effective_rows(self, order: List[Node], source: InputNode, job: int,
                        n_rows: int) -> List[int]:
        samples = [n for n in order if isinstance(n, SampleNode)
                   and _root_of(n) is source]
        # chained samplers compose (Range of a Stride etc.). *Parallel*
        # branches never reach here: run() partitions the output columns
        # per sampling branch (_sampling_groups) and launches one sub-run
        # per branch, so each planned order holds a single linear chain.
        heads = [s for s in samples
                 if not isinstance(s.inputs["input"].node, SampleNode)]
        if len(heads) > 1:
            raise AssertionError(
                "parallel sampling branches survived _sampling_groups"
            )
        rows = list(range(n_rows))
        for node in samples:
            rows = [rows[i] for i in node.indices(job, len(rows))]
        return rows

    def _sampling_groups(self, output: OutputNode,
                         order: List[Node]) -> Optional[List[OutputNode]]:
        """Partition the output columns by sampling branch.

        The reference graph composes stream samplings freely — a Gather
        branch and a full-rate branch can feed different sinks in one graph
        (tests/test_all.py:41,167,183). Each branch has its own row domain,
        so the chunk planner runs one sub-run per branch: this computes,
        per column, which sample-chain tip (or the raw Input) it reads each
        source through, groups identical assignments, and returns one
        OutputNode per group (None when a single group covers everything —
        the common case, zero overhead).

        An op whose inputs mix two different samplings of one source has no
        well-defined zipped row domain — rejected with a clear error.
        """
        # per node: source_id -> frozenset of sample-path tips; a tip is a
        # SampleNode id, or None for a direct (full-rate) read
        sig: Dict[int, Dict[int, frozenset]] = {}
        for n in order:
            if isinstance(n, InputNode):
                sig[n.id] = {n.id: frozenset([None])}
            elif isinstance(n, SampleNode):
                up = n.inputs["input"].node
                if not isinstance(up, (InputNode, SampleNode)):
                    raise NotImplementedError(
                        "sampling an op output is not supported; sample "
                        "the Input and branch after")
                (src_id,) = sig[up.id].keys()
                sig[n.id] = {src_id: frozenset([n.id])}
            else:
                merged: Dict[int, set] = {}
                for e in n.inputs.values():
                    for src_id, tips in sig.get(e.node.id, {}).items():
                        merged.setdefault(src_id, set()).update(tips)
                if isinstance(n, OpNode):
                    for src_id, tips in merged.items():
                        if len(tips) > 1:
                            raise ValueError(
                                f"op '{n.name}' zips two different "
                                "samplings of one Input — the row domains "
                                "differ; sample once and branch after")
                sig[n.id] = {k: frozenset(v) for k, v in merged.items()}

        def col_key(e: NodeOutput):
            return tuple(sorted(
                (src_id, tuple(sorted(-1 if t is None else t for t in tips)))
                for src_id, tips in sig[e.node.id].items()))

        keys = [col_key(e) for e in output.columns]
        if len(set(keys)) <= 1:
            return None
        groups: Dict[Any, List[int]] = {}
        for i, k in enumerate(keys):
            groups.setdefault(k, []).append(i)
        outs = []
        for idxs in groups.values():
            cols = [output.columns[i] for i in idxs]
            streams = []
            for job in range(len(output.streams)):
                sinks = self._job_sinks(output, job)
                if len(sinks) != len(output.columns):
                    raise ValueError(
                        f"job {job}: {len(output.columns)} output "
                        f"column(s) but {len(sinks)} sink stream(s); pass "
                        "one sink per column")
                sel = [sinks[i] for i in idxs]
                streams.append(sel[0] if len(sel) == 1 else tuple(sel))
            names = ([output.col_names[i] for i in idxs]
                     if output.col_names else None)
            outs.append(OutputNode(cols, streams, names))
        return outs

    @staticmethod
    def _steer_sink_dtypes(perf: PerfParams, order: List[Node],
                           output: OutputNode) -> None:
        """Compact sink encodings: an op that declares a compact storage
        dtype (OpDef.compact_sink) gets it by default when its output feeds
        ONLY sinks. Explicit op params and PerfParams(sink_dtype="float32")
        both win over the steering.

        A param injected by an earlier run of the same graph object is
        dropped first, in every mode, so a node that has since gained an
        op consumer (or a run with steering off) never keeps it."""
        if perf.sink_dtype not in ("auto", "float32", "float16"):
            raise ValueError(
                f"sink_dtype must be auto|float32|float16, got "
                f"{perf.sink_dtype!r}")
        op_consumed = {
            e.node.id
            for n in order if isinstance(n, OpNode)
            for e in n.inputs.values()
        }
        for node in order:
            if not isinstance(node, OpNode):
                continue
            stale = getattr(node, "_sink_steered", None)
            if stale:
                node.params.pop(stale, None)
                node._sink_steered = None
            pname = get_op(node.name).compact_sink
            if (perf.sink_dtype != "float32" and pname
                    and pname not in node.params
                    and node.id not in op_consumed
                    and any(e.node is node for e in output.columns)):
                node.params[pname] = "float16"
                node._sink_steered = pname  # injected, not user-passed

    # ------------------------------------------------------------------ run

    def run(
        self,
        output: OutputNode,
        perf_params: Optional[PerfParams] = None,
        cache_mode: CacheMode = CacheMode.Error,
        show_progress: bool = False,
        job_distribution: str = "static",
        claim_timeout_sec: float = 300.0,
    ):
        perf = perf_params or PerfParams.estimate()
        order = toposort(output)
        sources = [n for n in order if isinstance(n, InputNode)]
        if not sources:
            raise ValueError("graph has no Input")
        # parallel sampling branches -> one sub-run per branch, each with
        # its own row domain (see _sampling_groups)
        groups = self._sampling_groups(output, order)
        if groups is not None:
            for sub in groups:
                self.run(sub, perf_params=perf_params, cache_mode=cache_mode,
                         show_progress=show_progress,
                         job_distribution=job_distribution,
                         claim_timeout_sec=claim_timeout_sec)
            return
        self._steer_sink_dtypes(perf, order, output)
        # multi-source graphs zip rows across inputs (reference: N-input
        # jobs, e.g. audio + captions in old/test_audio.py:7-29); every
        # input must carry the same number of per-job streams
        if len({len(s.streams) for s in sources}) != 1:
            raise ValueError(
                "all Inputs must have the same number of job streams: "
                + ", ".join(str(len(s.streams)) for s in sources)
            )
        need = self._intervals(order)

        # Multi-device: shard the frame axis of device segments over the
        # local mesh (pipeline_instances_per_node analog; parallel/sharded).
        self._mesh = None
        if perf.pipeline_instances_per_node != 1:
            devs = local_devices(self.device)
            if len(devs) > 1:
                n = perf.pipeline_instances_per_node
                self._mesh = data_mesh(min(n if n > 1 else len(devs),
                                           len(devs)), self.device)
            else:
                self.profiler.count("axis:data:not_engaged",
                                    reason="one local device")

        # Job distribution (reference master/worker analog): "static" runs
        # this process's contiguous slice of the jobs (RANK of WORLD_SIZE;
        # every job in a lone process); "claims" runs the jobs this process
        # wins through storage-backed claims (parallel/workqueue.py).
        n_jobs = len(sources[0].streams)
        claims = None
        if job_distribution == "claims":
            from ..parallel.workqueue import WorkClaims

            claims = WorkClaims(self.client.config.db_path, _run_key(output))
            if cache_mode == CacheMode.Overwrite:
                # committed runs leave their claims in place (they mark the
                # job done for Ignore/Resume); an explicit Overwrite must be
                # able to re-claim, so clear this run's namespace first
                claims.clear()
            jobs = claims.iter_jobs(n_jobs)
        else:
            jobs = iter(host_job_slice(n_jobs))
        # Job-boundary overlap: job N's decode thread, once it drains its
        # last chunk, opens job N+1's decoders and decodes their first frame
        # (container probe + seek index + first keyframe), hiding the next
        # job's ramp behind job N's remaining compute, sink drain and
        # commit. A warmed decoder is handed to job N+1 only after job N's
        # decode thread has been joined, so no decoder is used from two
        # threads at once. A failed warm-up is counted
        # (``job:warm_failed`` in the profiler) and the job opens its own.
        warm: Dict[Tuple[int, int], Any] = {}
        overlap = not os.environ.get("ST_TPU_NO_JOB_OVERLAP")

        def warm_job(job: int) -> None:
            for si, src in enumerate(sources):
                ins = src.streams[job]
                if not getattr(ins, "is_video", False) or (job, si) in warm:
                    continue
                t0 = time.perf_counter()
                try:
                    with self.profiler.span("job:warm", job=job):
                        dec = ins.decoder()
                        warm[(job, si)] = dec
                        rows = self._effective_rows(order, src, job, len(ins))
                        if rows:
                            dec.read_frames([rows[0]])
                except Exception as e:
                    self.profiler.add_interval(
                        "job:warm_failed", t0, time.perf_counter(), job=job,
                        error=repr(e))
                    dec = warm.pop((job, si), None)
                    if dec is not None:
                        dec.close()

        did_work = [False]  # set by run_one on a real (non-skipped) job

        def run_one(job: int, nxt: Optional[int] = None) -> None:
            sink_streams = self._job_sinks(output, job)
            if all(s.committed() for s in sink_streams):
                if cache_mode == CacheMode.Error:
                    raise RuntimeError(
                        f"job {job}: output stream already committed "
                        "(pass cache_mode=CacheMode.Ignore/Overwrite)"
                    )
                if cache_mode in (CacheMode.Ignore, CacheMode.Resume):
                    for si in range(len(sources)):  # warmed for nothing
                        dec = warm.pop((job, si), None)
                        if dec is not None:
                            dec.close()
                    return
            heartbeat = None
            if claims is not None:
                # Heartbeat BOTH claims this process holds: the running job
                # and the looked-ahead next one (claimed by the iterator
                # pull before this job runs). Without the second, its claim
                # would age past claim_timeout_sec during a long job and a
                # live peer would reap it and run the job twice.
                def heartbeat(j=job, n=nxt):
                    claims.heartbeat(j)
                    if n is not None:
                        claims.heartbeat(n)
            drained = (lambda: warm_job(nxt)) if nxt is not None and \
                overlap else None
            with self.profiler.span("job:run", job=job):
                self._run_job(output, order, need, sources, job,
                              sink_streams, perf, show_progress,
                              resume=cache_mode == CacheMode.Resume,
                              heartbeat=heartbeat, warm=warm,
                              on_decode_drained=drained)
            did_work[0] = True

        def check_recycle_budget() -> None:
            # At a job boundary every completed job is committed, so a
            # typed restart request loses nothing; run_recycling (or any
            # caller) re-runs in a fresh process with Ignore/Resume. Only
            # after real work: a fresh worker whose baseline RSS already
            # exceeds the budget must still make progress (skipping
            # committed jobs must never trigger a restart loop).
            if not did_work[0] or not perf.recycle_rss_mb:
                return
            rss = _rss_mb()
            if rss > perf.recycle_rss_mb:
                from ..config import RecycleRequested

                raise RecycleRequested(
                    f"process RSS {rss:.0f} MB > "
                    f"recycle_rss_mb={perf.recycle_rss_mb:g}; completed "
                    "jobs are committed — re-run in a fresh process with "
                    "CacheMode.Ignore/Resume to continue")

        try:
            cur = next(jobs, None)
            while cur is not None:
                nxt = next(jobs, None)
                run_one(cur, nxt)
                cur = nxt
                if cur is not None:
                    try:
                        check_recycle_budget()
                    except Exception:
                        # don't strand the looked-ahead claim until it ages
                        # out: the successor process re-claims it at once
                        if claims is not None:
                            claims.release(cur)
                        raise
        finally:
            for dec in warm.values():  # unconsumed warm-ups
                dec.close()
            warm.clear()

        if claims is None:
            return
        # Completion: a claims run returns only when EVERY job is committed
        # (the reference master waits for all work). A dead worker's claims
        # go stale (no heartbeat): reap them and absorb the jobs. Committed
        # jobs are never reaped; a live holder keeps heartbeating, so this
        # process waits on it and re-checks for staleness each pass.

        def committed(j: int) -> bool:
            return all(s.committed() for s in self._job_sinks(output, j))

        while not all(committed(j) for j in range(n_jobs)):
            claims.reclaim_stale(older_than_sec=claim_timeout_sec,
                                 is_committed=committed)
            progressed = False
            for job in claims.iter_jobs(n_jobs):
                run_one(job)
                progressed = True
                check_recycle_budget()
            if not progressed:
                time.sleep(min(5.0, max(0.5, claim_timeout_sec / 4)))

    def _job_sinks(self, output: OutputNode, job: int):
        s = output.streams[job]
        if isinstance(s, (list, tuple)):
            return list(s)
        return [s]

    def _resume_signature(self, order, output, rows_per, W,
                          in_streams, ingest: str = "auto") -> str:
        """Content hash namespacing CacheMode.Resume shards. Covers the full
        graph topology (per-node input edges by topo position), op params
        (deterministically serialized — array params hashed by bytes, not
        elided by repr), the sinked (node, column) list, the sampled row set
        + chunk size, and the input stream identity (video path + size +
        mtime), so no structurally different run can reuse foreign shards.
        Same formula as the JAX package's, so either package resumes the
        other's shards."""
        pos = {n.id: i for i, n in enumerate(order)}
        ser = _ser_params

        nodes_sig = []
        for n in order:
            edges = sorted(
                (name, pos[e.node.id], e.index) for name, e in n.inputs.items()
            )
            params = ""
            if isinstance(n, OpNode):
                params = ser(n.params)
            elif isinstance(n, SampleNode):
                params = ser((n.mode, n.per_job))
            nodes_sig.append((type(n).__name__, getattr(n, "name", ""),
                              edges, params))
        sinks_sig = sorted(
            (pos[e.node.id], e.index) for e in output.columns
        )
        idents: List[Any] = []
        for in_stream in in_streams:
            ident: List[Any] = [type(in_stream).__name__,
                                getattr(in_stream, "name", None),
                                len(in_stream)]
            if getattr(in_stream, "is_video", False):
                try:
                    p = in_stream.video_path()
                    st = os.stat(p)
                    ident += [p, st.st_size, int(st.st_mtime)]
                except (AttributeError, OSError):
                    pass
            idents.append(ident)
        sig_src = repr((rows_per, W, nodes_sig, sinks_sig, idents, ingest))
        return hashlib.sha256(sig_src.encode()).hexdigest()[:12]

    def _run_job(self, output, order, need, sources, job, sink_streams, perf,
                 show_progress, resume: bool = False, heartbeat=None,
                 warm=None, on_decode_drained=None):
        """One job. ``heartbeat`` is called after every chunk (claims
        mode); ``warm`` maps (job, source index) to decoders opened ahead
        of time (the one for this job is taken out and used);
        ``on_decode_drained`` runs on the decode thread once its last chunk
        is decoded."""
        in_streams = [s.streams[job] for s in sources]
        metas = [_video_meta(ins) for ins in in_streams]
        stream_meta = next((m for m in metas if m), {})
        perf, reserved = self._reserve_axes(order, need, sources, job, perf,
                                            stream_meta)
        ctx = OpContext(job=job, stream_meta=stream_meta,
                        resources_dir=self.client.config.resources_dir(),
                        profiler=self.profiler, device=self.device,
                        pipe_devices=reserved.get("pipe"),
                        sp_devices=reserved.get("sp"),
                        ep_devices=reserved.get("expert"))
        # the device clocks against perf_counter, for the stream spans: the
        # card is idle between jobs, so the wait is short
        for d in ([self.device] if self._mesh is None
                  else [self.device] + self._mesh.device_list()):
            self.profiler.calibrate(d)

        # rows are zipped across inputs (reference N-input jobs): every
        # source must sample down to the same element count
        rows_per = [self._effective_rows(order, src, job, len(ins))
                    for src, ins in zip(sources, in_streams)]
        n_out = len(rows_per[0])
        if any(len(r) != n_out for r in rows_per):
            raise ValueError(
                "multi-input graphs zip rows 1:1; effective row counts "
                f"differ per input: {[len(r) for r in rows_per]}")
        W = perf.work_packet_size
        ws_nodes = [n for n in order if isinstance(n, OpNode)
                    and get_op(n.name).kind == "whole_stream"]
        # sink columns: (edge, writer, deferred?). Strict 1:1 — silently
        # mapping excess columns onto the last sink would open two writers
        # on the same stream (interleaved corruption).
        if len(sink_streams) != len(output.columns):
            raise ValueError(
                f"job {job}: {len(output.columns)} output column(s) but "
                f"{len(sink_streams)} sink stream(s); pass one sink per "
                "column (per-job tuples for multi-column outputs)")
        writers = [(edge, sink.writer(self._column_type(edge)),
                    any(edge.node is n for n in ws_nodes))
                   for edge, sink in zip(output.columns, sink_streams)]
        shard_mode, chunks = self._resume_chunks(
            order, output, writers, rows_per, W, in_streams, perf.ingest,
            job, resume, show_progress)

        # io_packet_size expresses how far ahead the host may read
        # (reference io packets); realized here as prefetch depth in chunks.
        # The staging ring needs depth+2 slots: `depth` queued + 1 parked in
        # the queue handoff + 1 being decoded. prefetch_depth=0 disables the
        # decode thread entirely (strict single-thread alternation).
        depth = 0 if perf.prefetch_depth <= 0 else max(
            perf.prefetch_depth,
            perf.io_packet_size // max(perf.work_packet_size, 1))
        pipe = _ChunkPipeline(self, ctx, order, output, need, ws_nodes,
                              writers, shard_mode, n_out, W, heartbeat,
                              show_progress)
        try:
            for si, (src, ins) in enumerate(zip(sources, in_streams)):
                pipe.sources.append(_Source.open(
                    src, ins, rows_per[si], metas[si],
                    (warm or {}).pop((job, si), None), order, need,
                    perf.ingest, W, depth, bool(pipe.tail_nodes)))
            pipe.run(chunks, depth, on_decode_drained)
            pipe.end_of_stream()
        except Exception as e:
            pipe.abort(e)
            raise
        finally:
            pipe.close()
            ctx.close()

    def _reserve_axes(self, order, need, sources, job, perf, stream_meta):
        """-> (``perf``, resolved if ``auto``; {axis: reserved devices}).
        Axis reservations are METADATA-driven: devices are reserved only
        when some op in this graph DECLARES the axis
        (OpDef.sp_halo/stages/experts) — a requested axis nothing can
        consume reserves nothing (and is counted as not engaged). The
        axes would split the same devices differently, so combining them
        (or one with a data mesh of more than one device) is rejected up
        front, as the JAX package does."""
        declared = _declared_axes(order)
        devs = local_devices(self.device)
        # PerfParams.estimate() defers packet and axis sizing to here,
        # where the job's frame geometry, stencil halo and the graph's
        # declared axes are known
        if perf.auto:
            halo = max([0] + [need[s.id][1] - need[s.id][0]
                              for s in sources])
            frame_bytes = None
            if stream_meta.get("width"):
                frame_bytes = stream_meta["width"] * stream_meta["height"] * 3
            perf = perf.resolve(
                frame_bytes, halo,
                n_devices=1 if self._mesh is None else self._mesh.size,
                rows=int(stream_meta.get("height") or 0),
                declared_stages=tuple(declared["stages"]),
                declared_sp_halos=tuple(declared["sp"]),
                declared_experts=tuple(declared["experts"]),
                total_devices=len(devs),
            )
        axes_on = {
            "pipeline_stages": perf.pipeline_stages > 1,
            "spatial_shards": perf.spatial_shards > 1,
            "expert_shards": perf.expert_shards > 1,
            "pipeline_instances_per_node":
                self._mesh is not None and self._mesh.size > 1,
        }
        if sum(axes_on.values()) > 1:
            on = [k for k, v in axes_on.items() if v]
            raise ValueError(
                f"PerfParams axes {on} are mutually exclusive: each "
                "reserves the same mesh devices with a different sharding "
                "inside one segment. Pick one per run.")
        reserved = {}
        for axis, size, decl in (("pipe", perf.pipeline_stages, "stages"),
                                 ("sp", perf.spatial_shards, "sp"),
                                 ("expert", perf.expert_shards, "experts")):
            if size <= 1:
                continue
            if declared[decl] and len(devs) >= size:
                reserved[axis] = devs[:size]
            else:
                self.profiler.count(
                    f"axis:{axis}:not_engaged", job=job,
                    reason="no op declares it" if not declared[decl]
                    else f"{len(devs)} devices < {size}")
        return perf, reserved

    def _resume_chunks(self, order, output, writers, rows_per, W, in_streams,
                       ingest, job, resume, show_progress):
        """-> (shard mode?, the chunks to run). Chunk-granular resume
        (CacheMode.Resume; SURVEY §5 shard manifests) requires
        shard-capable writers and a chunk-local graph (no stateful carry,
        no whole-stream accumulation)."""
        n_out = len(rows_per[0])
        all_chunks = list(range(0, n_out, W))
        kinds = {get_op(n.name).kind for n in order if isinstance(n, OpNode)}
        if not (resume and not kinds & {"stateful", "whole_stream"}
                and all(w.supports_shards for _, w, _ in writers)):
            return False, all_chunks
        # namespace shards by the run signature so a changed sampling /
        # graph wiring / input video / sinked column / chunk size can
        # never resume from foreign shards
        sig = self._resume_signature(order, output, rows_per, W, in_streams,
                                     ingest)
        for _, w, _ in writers:
            w.shard_key = sig
        done = None
        for _, w, _ in writers:
            shards = w.existing_shards()
            mine = {a for a in all_chunks
                    if shards.get(a) == min(a + W, n_out) - a}
            done = mine if done is None else (done & mine)
        done = done or set()
        if done and show_progress:
            print(f"  job {job}: resuming, {len(done)}/"
                  f"{len(all_chunks)} chunks already done", flush=True)
        return True, [a for a in all_chunks if a not in done]

    # ----------------------------------------------------------- chunk exec

    def _run_chunk(self, order, need, values, ctx, T, state, ws_acc, ws_ids):
        # group maximal runs of device ops into segments
        i = 0
        n = len(order)
        while i < n:
            node = order[i]
            if isinstance(node, OpNode) and get_op(node.name).kind == "device":
                seg = [node]
                j = i + 1
                # ops forced onto different devices can't share a segment
                while j < n and isinstance(order[j], OpNode) and \
                        get_op(order[j].name).kind == "device" and \
                        order[j].device == node.device:
                    seg.append(order[j])
                    j += 1
                self._run_device_segment(seg, need, values, ctx, T)
                i = j
                continue
            self._run_host_node(node, need, values, ctx, T, state, ws_acc,
                                ws_ids)
            i += 1

    def _run_device_segment(self, seg: List[OpNode], need, values, ctx, T):
        """Run a segment's ops in order on one device, or over the data
        mesh run by run (``_data_runs``): a run of ``row_local`` and
        ``batch_local`` ops shard by shard (``_run_sharded_segment``), an
        ``inner_split`` op whole with the mesh set (``_run_inner_split``),
        any other op whole, counted as not engaged. An op passed
        ``device=DeviceType.CPU`` computes on CPU tensors (its kernels'
        plain versions) and hands host arrays on, like the JAX package's
        forced-CPU segments, which stay unsharded as they do there."""
        on_cpu = seg[0].device == "cpu"  # grouping guarantees uniformity
        if self._mesh is None or on_cpu:
            device = torch.device("cpu") if on_cpu else self.device
            values.update(self._segment_outputs(seg, need, values, ctx, T,
                                                device, on_cpu))
            return
        for cls, run in _data_runs(seg):
            if cls in ("row_local", "batch_local"):
                self._run_sharded_segment(run, need, values, ctx, T, cls)
            elif cls == "inner_split":
                self._run_inner_split(run, need, values, ctx, T)
            else:
                self.profiler.count("axis:data:not_engaged",
                                    reason="not row- or batch-local: "
                                    + "+".join(n.name for n in run))
                values.update(self._segment_outputs(run, need, values, ctx,
                                                    T, self.device))

    def _run_inner_split(self, run: List[OpNode], need, values, ctx,
                         T: int) -> None:
        """``inner_split`` ops, each whole on the client's device with
        ``current_mesh`` and ``shard_states`` (its weights on each device
        of the mesh, one copy a device) set: the op couples the chunk's
        rows (a crop budget) and then splits its net's batch over the
        mesh itself (``parallel/sharded.split_batch``)."""
        mesh = self._mesh
        for node in run:
            opdef = get_op(node.name)
            states = None if opdef.aux is None else [
                self._resolve_aux(opdef, node, ctx, d)
                for d in mesh.device_list()]
            token_m = current_mesh.set(mesh)
            token_s = shard_states.set(states)
            try:
                values.update(self._segment_outputs([node], need, values,
                                                    ctx, T, self.device))
            finally:
                current_mesh.reset(token_m)
                shard_states.reset(token_s)
            self.profiler.count("axis:data:engaged", segment=node.name,
                                shards=mesh.size, by="inner_split")

    def _segment_outputs(self, seg, need, values, ctx, T, device,
                         on_cpu=False) -> Dict[Tuple[int, int], "_Value"]:
        """The segment's ops in order on ``device`` over a chunk of T
        rows, inputs looked up in ``values`` -> every output value."""
        local: Dict[Tuple[int, int], _Value] = {}
        outs: Dict[Tuple[int, int], _Value] = {}
        for node in seg:
            n_lo, n_hi = need[node.id]
            opdef = get_op(node.name)
            s_lo, s_hi = opdef.stencil
            args = []
            for e in node.inputs.values():
                v = local.get((e.node.id, e.index))
                if v is None:
                    ext = values[(e.node.id, e.index)]
                    v = _Value(_to_device(ext.data, device), ext.lo, ext.hi,
                               True)
                    local[(e.node.id, e.index)] = v
                args.append(v.slice_rows(n_lo + s_lo, n_hi + s_hi, T))
            label = "device:" + node.name + ("@cpu" if on_cpu else "")
            with self.profiler.span(label, **ctx.packet):
                if opdef.aux is not None:
                    args.insert(0, self._resolve_aux(opdef, node, ctx,
                                                     device))
                with self.profiler.stream_span("stream:" + node.name,
                                               device, **ctx.packet):
                    res = opdef.fn(ctx, *args, **node.params)
            if opdef.n_outputs == 1:
                res = (res,)
            for k, r in enumerate(res):
                if on_cpu:
                    r = _to_host(r)
                outs[(node.id, k)] = local[(node.id, k)] = _Value(
                    r, n_lo, n_hi, True)
        return outs

    def _run_sharded_segment(self, seg: List[OpNode], need, values, ctx,
                             T: int, by: str) -> None:
        """The segment over the data mesh. The chunk's T output rows are
        padded to a multiple of the mesh (``local`` rows a shard); each
        external input (rows [lo, T-1+hi] of its stream) is padded to
        match by replicating its last row, and shard k gets its rows
        ``[k*local, k*local + local + hi - lo)``: its own frames plus the
        halo its stencils read (``row_windows``). The segment runs on
        each shard's device as a chunk of ``local`` rows with
        ``sharded_mode`` and ``current_mesh`` set, and each output's rows
        come back in order on the client's device, cut to the chunk's.
        Every output row below T reads real rows only, so the rows equal
        the unsharded run's: bit for bit when every op is ``row_local``
        (``by``), within the nets' rounding at another batch when some op
        is ``batch_local``. A failure on a shard raises; nothing reruns
        the segment whole."""
        mesh = self._mesh
        devs = mesh.device_list()
        m = len(devs)
        local = -(-T // m)
        seg_ids = {n.id for n in seg}
        windows: Dict[Tuple[int, int], list] = {}
        for node in seg:
            for e in node.inputs.values():
                key = (e.node.id, e.index)
                if e.node.id in seg_ids or key in windows:
                    continue
                v = values[key]
                extra = v.hi - v.lo
                windows[key] = row_windows(
                    pad_rows_to(v.data, local * m + extra), m, local, extra)
        parts: List[Dict[Tuple[int, int], _Value]] = []
        token = sharded_mode.set(True)
        token_m = current_mesh.set(mesh)
        try:
            for k, dev in enumerate(devs):
                shard_vals = {
                    key: _Value(w[k], values[key].lo, values[key].hi, True)
                    for key, w in windows.items()}
                parts.append(self._segment_outputs(seg, need, shard_vals,
                                                   ctx, local, dev))
        finally:
            sharded_mode.reset(token)
            current_mesh.reset(token_m)
        self.profiler.count("axis:data:engaged",
                            segment="+".join(n.name for n in seg), shards=m,
                            by=by)
        for key in parts[0]:
            n_lo, n_hi = need[key[0]]
            # shard k's row i is the chunk's row k*local + n_lo + i: take
            # each shard's own rows, the first shard's leading halo and
            # the last shard's trailing one
            rows = []
            for k, p in enumerate(parts):
                a = 0 if k == 0 else -n_lo
                b = local - n_lo + (n_hi if k == m - 1 else 0)
                rows.append(_rows_of(p[key].data, a, b - a))
            data = _rows_of(gather_rows(rows, self.device), 0,
                            T + n_hi - n_lo)
            values[key] = _Value(data, n_lo, n_hi, True)

    def _resolve_aux(self, opdef, node, ctx, device: torch.device):
        key = (opdef.name, _ser_params(node.params), str(device))
        if key not in self._aux:
            # first use: the weights read (or drawn) and moved to the device
            with self.profiler.span(f"load:{opdef.name}", device=str(device)):
                self._aux[key] = _tree_to(opdef.aux(ctx, node.params),
                                          device)
        return self._aux[key]

    def _run_host_node(self, node, need, values, ctx, T, state, ws_acc,
                       ws_ids):
        if isinstance(node, InputNode):
            return  # source value injected by the chunk loop
        if isinstance(node, SampleNode):
            e = node.inputs["input"]
            values[(node.id, 0)] = values[(e.node.id, e.index)]
            return
        if isinstance(node, OutputNode):
            return
        assert isinstance(node, OpNode), node
        opdef = get_op(node.name)
        n_lo, n_hi = need[node.id]
        s_lo, s_hi = opdef.stencil

        args = []
        for e in node.inputs.values():
            v = values[(e.node.id, e.index)]
            data = v.slice_rows(n_lo + s_lo, n_hi + s_hi, T)
            if (v.is_device or isinstance(data, FrameChunk)) \
                    and not opdef.device_inputs:
                data = self._copy_out(data, v.is_device, ctx)
            args.append(data)

        if node.id in ws_ids:
            for slot, a in enumerate(args):
                # accumulated values outlive the chunk; frame arrays may be
                # views of recycled decode-ring slots -> deep copy here
                if isinstance(a, np.ndarray):
                    a = a.copy()
                ws_acc[node.id][slot].append(a)
            return

        with self.profiler.span(f"op:{node.name}", **ctx.packet):
            if opdef.kind == "stateful":
                st = state.get(node.id)
                if st is None and opdef.init_state is not None:
                    st = opdef.init_state(ctx)
                st, res = opdef.fn(ctx, st, *args, **node.params)
                state[node.id] = st
            else:
                res = opdef.fn(ctx, *args, **node.params)
        if opdef.n_outputs == 1:
            res = (res,)
        for k, r in enumerate(res):
            values[(node.id, k)] = _Value(r, n_lo, n_hi, False)

    @staticmethod
    def _copy_out(data, on_device: bool, ctx: OpContext):
        """``_to_host(data)``; from the device, where the executor's thread
        waits for the card, inside ``ctx.wait_device()`` (a
        ``host:wait_device`` span with the packet's meta)."""
        if not on_device:
            return _to_host(data)
        with ctx.wait_device():
            return _to_host(data)

    # ------------------------------------------------------------- sinks

    def _column_type(self, edge: NodeOutput) -> str:
        node = edge.node
        if isinstance(node, OpNode):
            return get_op(node.name).outputs[edge.index]
        if isinstance(node, (InputNode, SampleNode)):
            return _root_of(node).streams[0].type_name()
        raise ValueError(f"cannot sink from {node}")

    def _write_column(self, writer, edge, val: _Value, T: int,
                      ctx: OpContext, sink_worker, shard_start=None):
        """Store a chunk's rows of a column; ``ctx.packet`` is the spans'
        meta."""
        packet = ctx.packet
        data = val.slice_rows(0, 0, T)
        was_host = not val.is_device
        if val.is_device or isinstance(data, FrameChunk):
            data = self._copy_out(data, val.is_device, ctx)
        if was_host and isinstance(data, np.ndarray):
            # host-path frame arrays (incl. host FrameChunks) can be views
            # of recycled decode-ring slots; the async writer outlives the
            # chunk, so detach (device copies are already fresh)
            data = data.copy()
        elif was_host and isinstance(data, list):
            # same hazard element-wise: a host op may return numpy views
            # into ring slots inside a list column
            data = [el.copy() if isinstance(el, np.ndarray) else el
                    for el in data]
        ser = typeslib.get_type(self._column_type(edge)).serialize

        def emit():
            with self.profiler.span("sink:write", **packet):
                if isinstance(data, list):
                    elements = [b"" if el is None else
                                el if isinstance(el, bytes) else ser(el)
                                for el in data]
                else:
                    elements = [ser(data[t]) for t in range(T)]
                if shard_start is not None:
                    # durable per-chunk shard (CacheMode.Resume checkpoints)
                    writer.append_shard(shard_start, elements)
                else:
                    for el in elements:
                        writer.append(el)

        sink_worker.submit(emit)


def _rows_of(data, start: int, length: int):
    """Rows [start, start + length) of a tensor, FrameChunk or tuple."""
    if isinstance(data, FrameChunk):
        return data.slice_rows(start, length)
    if isinstance(data, tuple):
        return tuple(_rows_of(d, start, length) for d in data)
    return data[start:start + length]


def _concat_host(parts: List[Any]):
    if not parts:
        return []
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=0)
    out = []
    for p in parts:
        out.extend(p)
    return out


class _SinkWorker:
    """Serialize + write sink elements off the chunk critical path.

    Reference analog: the engine's save workers — sink IO runs on its own
    thread so kernel threads never block on storage (SURVEY §1 L0). One FIFO
    worker preserves per-writer append order; errors surface on the next
    submit() or at flush() (before commit, so a failed write can never be
    committed). The queue is bounded: a slow disk applies backpressure
    instead of buffering the whole stream in memory.
    """

    def __init__(self, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                if self._err is None:  # after an error, drop (order broken)
                    try:
                        task()
                    except BaseException as e:  # surface via submit/flush
                        self._err = e
            finally:
                self._q.task_done()

    def submit(self, task) -> None:
        if self._err is not None:
            raise self._err
        self._q.put(task)

    def flush(self) -> None:
        """Drain all pending writes; raise any deferred error."""
        self._q.join()
        if self._err is not None:
            raise self._err

    def close(self) -> None:
        """Idempotent; drains pending tasks then joins the worker. Callers
        tearing down after an error must close() before writer.abort() so no
        write races the abort."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()


class _Prefetcher:
    """Decode-ahead: runs ``fn(chunk_start)`` in a worker thread, keeping up
    to ``depth`` chunks queued (reference analog: io packets decoded ahead
    of kernel threads). ``on_drained`` runs once after the last chunk is
    decoded, on the thread that decoded it (while compute and sinks still
    run): the hook for the next job's decoder warm-up."""

    def __init__(self, fn, starts: Sequence[int], depth: int = 2,
                 on_drained=None):
        self._starts = list(starts)
        self._fn = fn
        self._stop = threading.Event()
        self._thread = None
        self._on_drained = on_drained
        if depth <= 0:
            # synchronous mode: decode inline on the consumer thread
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _drained(self):
        cb, self._on_drained = self._on_drained, None
        if cb is not None:
            cb()

    def _work(self):
        try:
            for a in self._starts:
                if self._stop.is_set():
                    return
                self._q.put(self._fn(a))
            self._drained()
            self._q.put(None)
        except BaseException as e:  # surface decode errors to the consumer
            self._q.put(e)

    def __iter__(self):
        if self._thread is None:  # synchronous mode
            for a in self._starts:
                if self._stop.is_set():
                    return
                yield self._fn(a)
            self._drained()
            return
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        """Stop and JOIN the worker before the caller tears down resources
        the worker writes into (decode ring slots, decoder handles) — without
        the join, an error-path close() can free a slot mid-write
        (use-after-free in st_io.cpp). The drain loop keeps the queue empty
        so a worker blocked in q.put() can finish its final put and see the
        stop flag."""
        self._stop.set()
        if self._thread is None:
            return
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
