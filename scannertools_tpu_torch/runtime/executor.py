"""Graph executor: runs the pipeline IR as eager torch chunk programs on one
device.

This is the replacement for the Scanner engine's run loop (master/worker
gRPC scheduling + C++ kernel threads, SURVEY §1 L0). The design:

  * Each job (stream) is planned as a sequence of fixed-size frame chunks
    (``PerfParams.work_packet_size`` analog).
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
  * Host decode runs in a prefetch thread, ahead of device execution
    (``prefetch_depth``). On CUDA the same thread uploads each chunk from
    the staging ring on a side stream; the compute stream waits on the
    copy's event (see ``_Uploader``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as typeslib
from ..config import CacheMode, PerfParams
from ..graph import (InputNode, Node, NodeOutput, OpNode, OutputNode,
                     SampleNode, toposort)
from ..registry import get_op
from ..utils.framechunk import FrameChunk
from .context import OpContext
from .profiler import Profiler


def _clamp(i: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, i))


def _ser_params(v) -> str:
    """Deterministic serialization for op params (array bytes hashed, not
    elided by repr) — used by the resume signature and the aux cache."""
    import hashlib

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
    stream's work on the previous chunk. The staging ring is pageable: a
    pinned ring costs more to page-lock per job than the asynchronous copy
    saves (PERF.md). An event recorded after the copy is (a) waited on by
    the compute stream before the chunk is used and (b) synchronized by the
    prefetch thread before it hands the chunk over — so by the time the
    consumer releases the ring slot, nothing reads it any more. The
    uploaded tensor was allocated on the side stream, so the consumer calls
    ``record_stream`` on it before the allocator may reuse it.
    """

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


class Executor:
    def __init__(self, client):
        self.client = client
        self.profiler: Profiler = client.profiler
        self.device: torch.device = client.device
        # resolved op aux trees (model weights), keyed by (op name,
        # serialized params, device): loaded and moved once per executor
        self._aux: Dict[Tuple[str, str, str], Any] = {}

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
        def root_of(s: Node) -> Node:
            n = s
            while isinstance(n, SampleNode):
                n = n.inputs["input"].node
            return n

        samples = [n for n in order if isinstance(n, SampleNode)
                   and root_of(n) is source]
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
                         show_progress=show_progress)
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

        for job in range(len(sources[0].streams)):
            sink_streams = self._job_sinks(output, job)
            if all(s.committed() for s in sink_streams):
                if cache_mode == CacheMode.Error:
                    raise RuntimeError(
                        f"job {job}: output stream already committed "
                        "(pass cache_mode=CacheMode.Ignore/Overwrite)"
                    )
                if cache_mode in (CacheMode.Ignore, CacheMode.Resume):
                    continue
            self._run_job(output, order, need, sources, job, sink_streams,
                          perf, show_progress,
                          resume=cache_mode == CacheMode.Resume)

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
        import hashlib
        import os as _os

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
                    st = _os.stat(p)
                    ident += [p, st.st_size, int(st.st_mtime)]
                except (AttributeError, OSError):
                    pass
            idents.append(ident)
        sig_src = repr((rows_per, W, nodes_sig, sinks_sig, idents, ingest))
        return hashlib.sha256(sig_src.encode()).hexdigest()[:12]

    def _run_job(self, output, order, need, sources, job, sink_streams, perf,
                 show_progress, resume: bool = False):
        in_streams = [s.streams[job] for s in sources]
        stream_meta = {}
        for ins in in_streams:
            if getattr(ins, "is_video", False):
                m = ins.metadata()
                stream_meta = {"fps": m.fps, "width": m.width,
                               "height": m.height}
                break
        # PerfParams.estimate() defers packet sizing to here, where the
        # job's frame geometry and stencil halo are known
        if perf.auto:
            frame_bytes = None
            halo = 0
            for src in sources:
                s_lo, s_hi = need[src.id]
                halo = max(halo, s_hi - s_lo)
            if stream_meta.get("width"):
                frame_bytes = stream_meta["width"] * stream_meta["height"] * 3
            perf = perf.resolve(frame_bytes, halo)
        ctx = OpContext(
            job=job,
            stream_meta=stream_meta,
            resources_dir=self.client.config.resources_dir(),
            profiler=self.profiler,
            device=self.device,
        )

        # rows are zipped across inputs (reference N-input jobs): every
        # source must sample down to the same element count
        rows_per = [self._effective_rows(order, src, job, len(ins))
                    for src, ins in zip(sources, in_streams)]
        n_out = len(rows_per[0])
        if any(len(r) != n_out for r in rows_per):
            raise ValueError(
                "multi-input graphs zip rows 1:1; effective row counts "
                f"differ per input: {[len(r) for r in rows_per]}"
            )
        W = perf.work_packet_size

        # Column plumbing -------------------------------------------------
        op_nodes = [n for n in order if isinstance(n, OpNode)]
        ws_nodes = [n for n in op_nodes if get_op(n.name).kind == "whole_stream"]
        ws_ids = {n.id for n in ws_nodes}
        # sink columns: (edge, writer, deferred?). Strict 1:1 — silently
        # mapping excess columns onto the last sink would open two writers
        # on the same stream (interleaved corruption).
        if len(sink_streams) != len(output.columns):
            raise ValueError(
                f"job {job}: {len(output.columns)} output column(s) but "
                f"{len(sink_streams)} sink stream(s); pass one sink per "
                "column (per-job tuples for multi-column outputs)"
            )
        writers = []
        for i, edge in enumerate(output.columns):
            tname = self._column_type(edge)
            writers.append(
                (edge, sink_streams[i].writer(tname), edge.node.id in ws_ids))

        # whole-stream accumulators: node.id -> list of per-chunk host inputs
        ws_acc: Dict[int, List[List[Any]]] = {
            n.id: [[] for _ in n.inputs] for n in ws_nodes
        }
        state: Dict[int, Any] = {}

        all_chunks = list(range(0, n_out, W))
        chunks = all_chunks

        # Chunk-granular resume (CacheMode.Resume; SURVEY §5 shard
        # manifests): requires shard-capable writers and a chunk-local graph
        # (no stateful carry, no whole-stream accumulation).
        stateful = any(get_op(n.name).kind == "stateful" for n in op_nodes)
        shard_mode = (
            resume and not stateful and not ws_nodes
            and all(w.supports_shards for _, w, _ in writers)
        )
        if shard_mode:
            # namespace shards by the run signature so a changed sampling /
            # graph wiring / input video / sinked column / chunk size can
            # never resume from foreign shards
            sig = self._resume_signature(order, output, rows_per, W,
                                         in_streams, perf.ingest)
            for _, w, _ in writers:
                w.shard_key = sig
            done = None
            for _, w, _ in writers:
                shards = w.existing_shards()
                mine = {
                    a for a in all_chunks
                    if shards.get(a) == min(a + W, n_out) - a
                }
                done = mine if done is None else (done & mine)
            done = done or set()
            chunks = [a for a in all_chunks if a not in done]
            if done and show_progress:
                print(f"  job {job}: resuming, {len(done)}/"
                      f"{len(all_chunks)} chunks already done", flush=True)

        # io_packet_size expresses how far ahead the host may read
        # (reference io packets); realized here as prefetch depth in chunks.
        # The staging ring needs depth+2 slots: `depth` queued + 1 parked in
        # the queue handoff + 1 being decoded. prefetch_depth=0 disables the
        # decode thread entirely (strict single-thread alternation).
        depth = 0 if perf.prefetch_depth <= 0 else max(
            perf.prefetch_depth,
            perf.io_packet_size // max(perf.work_packet_size, 1))

        # Per-source decode state (multi-source graphs zip N inputs):
        # decoder + staging ring per video input, prefetch-upload decision
        # per input's own consumer set.
        uploader = _Uploader(self.device)
        decoders: List[Any] = []
        rings: List[Any] = []
        uploads: List[bool] = []
        yuvs: List[bool] = []
        metas: List[Dict[str, Any]] = []
        prefetched = None
        sink_worker = None
        last_chunk = [-1, 0]
        try:
            for src, ins in zip(sources, in_streams):
                decoder = ins.decoder() if getattr(ins, "is_video", False) \
                    else None
                decoders.append(decoder)
                meta = {}
                if decoder is not None:
                    m = ins.metadata()
                    meta = {"fps": m.fps, "width": m.width,
                            "height": m.height}

                # When every consumer of this input's frames is a device
                # op, the prefetch thread uploads right after decode,
                # overlapping the previous chunk's compute. Mixed host/device
                # consumers keep frames on the host.
                def _root(n):
                    while isinstance(n, SampleNode):
                        n = n.inputs["input"].node
                    return n

                frame_node_ids = {src.id} | {
                    n.id for n in order
                    if isinstance(n, SampleNode) and _root(n) is src
                }
                consumers = [
                    n for n in order if isinstance(n, OpNode)
                    and any(e.node.id in frame_node_ids
                            for e in n.inputs.values())
                ]
                upload = bool(consumers) and all(
                    get_op(n.name).kind == "device"
                    or get_op(n.name).device_inputs  # host op driving
                    for n in consumers               # device programs
                ) and decoder is not None
                # I420 ingest: frames headed straight for the device travel
                # as 1.5 B/px YUV planes (half the upload bytes of RGB24, no
                # host swscale), with the YUV->RGB conversion fused into the
                # device op (hist_i420). Host-consumed frames keep the RGB24
                # decode — no upload to save, and host ops expect RGB.
                can_i420 = getattr(decoder, "i420_supported", False)
                if perf.ingest == "i420" and decoder is not None \
                        and not can_i420:
                    raise ValueError(
                        "PerfParams(ingest='i420') but the source cannot "
                        "decode to planar I420 (non-4:2:0 pixel format, odd "
                        "dims, or the cv2 fallback decoder)")
                yuv = (upload and can_i420
                       and perf.ingest in ("auto", "i420"))
                ring = None
                if decoder is not None and meta:
                    from ..io.prefetch import ChunkRing

                    s_lo, s_hi = need[src.id]
                    frame_bytes = meta["height"] * meta["width"] * 3
                    if yuv:
                        frame_bytes = meta["height"] * meta["width"] * 3 // 2
                    ring = ChunkRing((W + (s_hi - s_lo)) * frame_bytes,
                                     depth + 2)
                rings.append(ring)
                uploads.append(upload)
                yuvs.append(yuv)
                metas.append(meta)

            def decode_chunk(a: int):
                b = min(a + W, n_out) - 1
                T = b - a + 1
                vals: Dict[Tuple[int, int], _Value] = {}
                for si, (src, ins) in enumerate(zip(sources, in_streams)):
                    s_lo, s_hi = need[src.id]
                    rows = rows_per[si]
                    positions = [
                        _clamp(p, 0, n_out - 1)
                        for p in range(a + s_lo, b + s_hi + 1)
                    ]
                    src_rows = [rows[p] for p in positions]
                    decoder, ring, meta = decoders[si], rings[si], metas[si]
                    yuv = yuvs[si]
                    out_buf = None
                    if decoder is not None and ring is not None:
                        # slot waits (consumer busy) are not decode
                        # time — keep out of source:read
                        with self.profiler.span("source:wait_slot"):
                            slot = ring.acquire()
                        h, w = meta["height"], meta["width"]
                        if yuv:
                            fb = h * w * 3 // 2
                            out_buf = slot[: len(src_rows) * fb].reshape(
                                len(src_rows), fb
                            )
                        else:
                            fb = h * w * 3
                            out_buf = slot[: len(src_rows) * fb].reshape(
                                len(src_rows), h, w, 3
                            )
                    with self.profiler.span("source:read"):
                        if decoder is not None:
                            if yuv:
                                planes = decoder.read_frames_i420(
                                    src_rows, out=out_buf)
                                if ring is not None:
                                    ring.commit()
                                data = FrameChunk.from_i420(
                                    planes, meta["height"], meta["width"],
                                    full_range=getattr(
                                        decoder, "i420_full_range", False),
                                    bt709=getattr(decoder, "i420_bt709",
                                                  False))
                            else:
                                frames = decoder.read_frames(
                                    src_rows, out=out_buf)
                                if ring is not None:
                                    ring.commit()
                                data = FrameChunk.from_hwc(frames)
                            ready = None
                            if uploads[si]:
                                with self.profiler.span("source:upload"):
                                    data, ready = uploader.upload(data)
                            vals[(src.id, 0)] = _Value(
                                data, s_lo, s_hi, is_device=uploads[si],
                                ready=ready)
                        else:
                            elems = list(ins.load_bytes(src_rows))
                            parse = typeslib.get_type(
                                ins.type_name()).parse
                            vals[(src.id, 0)] = _Value(
                                [parse(e) for e in elems], s_lo, s_hi, False)
                return a, T, vals

            prefetched = _Prefetcher(decode_chunk, chunks, depth=depth)
            # sink serialization + IO runs off the critical path: chunk
            # N+1's decode/compute overlaps chunk N's writes (reference save
            # workers)
            sink_worker = _SinkWorker(depth=2 * max(1, len(writers)))

            for a, T, src_vals in prefetched:
                last_chunk[:] = (a, T)
                for v in src_vals.values():
                    uploader.adopt(v)
                values: Dict[Tuple[int, int], _Value] = dict(src_vals)
                self._run_chunk(order, need, values, ctx, T, state,
                                ws_acc, ws_ids)
                # write non-deferred sink columns (async; the _to_host copy
                # inside stays synchronous)
                for edge, writer, deferred in writers:
                    if deferred:
                        continue
                    val = values[(edge.node.id, edge.index)]
                    self._write_column(writer, edge, val, T,
                                       shard_start=a if shard_mode else None,
                                       sink_worker=sink_worker)
                for ring in rings:
                    # the upload of this chunk completed before the prefetch
                    # thread handed it over, and host consumers copied what
                    # they keep: the staging slot can be recycled
                    if ring is not None:
                        ring.release()
                if show_progress:
                    print(f"  job {job}: rows {a + T}/{n_out}", flush=True)

            # all async writes must land before deferred writes / commit
            sink_worker.flush()

            # end-of-stream: whole-stream ops then deferred sinks
            ws_out: Dict[Tuple[int, int], List[Any]] = {}
            for node in ws_nodes:
                opdef = get_op(node.name)
                args = [
                    _concat_host(parts) for parts in ws_acc[node.id]
                ]
                with self.profiler.span(f"op:{node.name}"):
                    res = opdef.fn(ctx, *args, **node.params)
                if opdef.n_outputs == 1:
                    ws_out[(node.id, 0)] = list(res)
                else:
                    for k, r in enumerate(res):
                        ws_out[(node.id, k)] = list(r)
            for edge, writer, deferred in writers:
                if not deferred:
                    continue
                tname = self._column_type(edge)
                ser = typeslib.get_type(tname).serialize
                for el in ws_out[(edge.node.id, edge.index)]:
                    writer.append(b"" if el is None else ser(el))

            for _, writer, _ in writers:
                if shard_mode:
                    writer.commit_from_shards(all_chunks)
                else:
                    writer.commit()
        except Exception as e:
            e.add_note(
                f"scannertools_tpu_torch: job {job}, chunk rows "
                f"{last_chunk[0]}..{last_chunk[0] + last_chunk[1] - 1} "
                f"of {n_out}"
            )
            if sink_worker is not None:
                sink_worker.close()  # no write may race the aborts below
            for _, writer, _ in writers:
                writer.abort()
            raise
        finally:
            if sink_worker is not None:
                sink_worker.close()
            # order matters: wake a producer blocked in ring.acquire, join
            # the decode thread (each upload it started has completed), and
            # only then free ring slots / the decoders it may have been
            # writing into
            live_rings = [r for r in rings if r is not None]
            for ring in live_rings:
                ring.cancel()
            if prefetched is not None:
                prefetched.close()
            for ring in live_rings:
                ring.close()
            for decoder in decoders:
                if decoder is not None:
                    decoder.close()
            ctx.close()

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
        """Run a segment's ops in order on one device. An op passed
        ``device=DeviceType.CPU`` computes on CPU tensors (its kernels'
        plain versions) and hands host arrays on, like the JAX package's
        forced-CPU segments."""
        on_cpu = seg[0].device == "cpu"  # grouping guarantees uniformity
        device = torch.device("cpu") if on_cpu else self.device
        local: Dict[Tuple[int, int], _Value] = {}
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
            with self.profiler.span(label):
                if opdef.aux is not None:
                    res = opdef.fn(ctx, self._resolve_aux(opdef, node, ctx,
                                                          device),
                                   *args, **node.params)
                else:
                    res = opdef.fn(ctx, *args, **node.params)
            if opdef.n_outputs == 1:
                res = (res,)
            for k, r in enumerate(res):
                if on_cpu:
                    r = _to_host(r)
                values[(node.id, k)] = local[(node.id, k)] = _Value(
                    r, n_lo, n_hi, True)

    def _resolve_aux(self, opdef, node, ctx, device: torch.device):
        key = (opdef.name, _ser_params(node.params), str(device))
        if key not in self._aux:
            self._aux[key] = _tree_to(opdef.aux(ctx, node.params), device)
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
                data = _to_host(data)
            args.append(data)

        if node.id in ws_ids:
            for slot, a in enumerate(args):
                # accumulated values outlive the chunk; frame arrays may be
                # views of recycled decode-ring slots -> deep copy here
                if isinstance(a, np.ndarray):
                    a = a.copy()
                ws_acc[node.id][slot].append(a)
            return

        with self.profiler.span(f"op:{node.name}"):
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

    # ------------------------------------------------------------- sinks

    def _column_type(self, edge: NodeOutput) -> str:
        node = edge.node
        if isinstance(node, OpNode):
            return get_op(node.name).outputs[edge.index]
        if isinstance(node, (InputNode, SampleNode)):
            src = node
            while isinstance(src, SampleNode):
                src = src.inputs["input"].node
            s = src.streams[0]
            return s.type_name()
        raise ValueError(f"cannot sink from {node}")

    def _write_column(self, writer, edge, val: _Value, T: int,
                      shard_start=None, sink_worker=None):
        data = val.slice_rows(0, 0, T)
        was_host = not val.is_device
        if val.is_device or isinstance(data, FrameChunk):
            data = _to_host(data)
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
            with self.profiler.span("sink:write"):
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

        if sink_worker is not None:
            sink_worker.submit(emit)
        else:
            emit()


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
    of kernel threads)."""

    def __init__(self, fn, starts: Sequence[int], depth: int = 2):
        self._starts = list(starts)
        self._fn = fn
        self._stop = threading.Event()
        self._thread = None
        if depth <= 0:
            # synchronous mode: decode inline on the consumer thread
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for a in self._starts:
                if self._stop.is_set():
                    return
                self._q.put(self._fn(a))
            self._q.put(None)
        except BaseException as e:  # surface decode errors to the consumer
            self._q.put(e)

    def __iter__(self):
        if self._thread is None:  # synchronous mode
            for a in self._starts:
                if self._stop.is_set():
                    return
                yield self._fn(a)
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
