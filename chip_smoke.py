#!/usr/bin/env python3
"""Chip smoke test of scannertools_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from ``scannertools_tpu_torch/kernels/csrc``
and holds each one to its plain torch version on the card (difference 0) at
ragged geometries (I420 widths that are not a multiple of 16, unaligned
frames), at the main path's 1080p 64-frame chunk on random, flat-colour and
all-bin-15 frames, and at one 7680x4320 frame. It times with CUDA events,
median of 20 calls, each call on an idle card with the wrapper's host work
inside the window (the method of the first port): each kernel's wrapper
(``ms``; on flat frames, ``flat_ms``), its plain version (``plain_ms``),
and one PyTorch reduction over the same bytes (``read_ms``: the card's own
read rate on them). ``device_ms`` is the kernel's time alone: the card is
kept busy while the wrapper's host work runs, so only the device's time of
the call is measured.

Phase 1 also holds the flow kernel ``flow_update`` to its plain version
(difference 0) in both warp modes, at ragged sizes (odd sides, levels of
at most 16 rows, a 2-row level) and at the flow path's finest level, a
32-pair 640x480 chunk, where it times it the same ways.

Phase 2 drives the main path through the public API on the default device:
``Client() -> Histogram -> ShotBoundaries -> NamedStream`` over a 1080p,
480-frame, 24 fps video with cuts at 120, 240 and 360, once with RGB24 and
once with I420 ingest. The frames come from a synthetic decoder behind the
package's NamedVideoStream, so the script needs neither a video file nor
the libav development files the native decoder is built from; libav decode
itself is covered by the CPU tests. Each run must give
the boundaries [120, 240, 360], histogram rows equal to the plain version's
on the same frames, and launches of its kernel.

Phase 3 drives the flow path the same way: ``Client() -> Stride(frame, [2])
-> OpticalFlow`` at 640x480 over a synthetic texture panning by a known
whole pixel per frame, with RGB and I420 (grey chroma) ingest. Graph A
sinks the flow only, so it is stored as float16 (the default steering):
the stored bytes, the recovered motion (median interior error under 0.15
px) and (levels + 1) * iters = 12 launches of ``flow_update`` per chunk
are checked. Graph B sinks ``FlowHistogram`` of the flow, whose rows must
equal those of the plain versions run on the card over the same frames.
One chunk's time is split by stage with CUDA events.

Phase 1 holds ``nms`` (kernels/csrc/nms.cu) to its plain version
(difference 0) on seeded box clouds at K = 1, 5, 63, 64, 65, 96, 127, 128,
129, 256, 1000 (on both paths), 1280 (the one-launch path's shared-memory
limit), 1281, 2048 and 4096 (the device-memory path), both overlap modes,
batches with tied scores and an all-invalid frame, max_out below the kept
count, at and above K, and alternating chains within and across tiles; and
``crop_and_resize`` (kernels/csrc/crop_resize.cu) at 24, 48, 160 and 227
px outputs over mixed, upsampled, downsampled, edge and degenerate boxes
from 16 frames of 640x480 in one launch, and at C = 1, 3, 4 and 256
channels, output widths 227 and 1 (rows off a 16-byte boundary), on
frames on and off a 16-byte boundary. Each is timed at the face path's
calls: ``nms`` at the cross-scale call of a 16-frame chunk (the record),
the five pyramid scales' call, R-Net and O-Net calls, and at the detection
models' [1, 1000] and [2, 2048] calls; ``crop_and_resize`` at FaceNet's 512
crops of 160x160 (16 frames at the budget of 32 faces that phase 4 passes;
the record; ``library_ms`` is ``F.grid_sample`` at the same sample
positions, checked to agree), gender's, R-Net's and O-Net's, and at 1000
RoIs of a 256-channel P2 map at 7x7 and 14x14.

Phase 4 drives the face suite at 640x480: 32 frames of a synthetic texture
with drifting bright blobs, chunks of 16, RGB ingest, the port's seeded
weights written by its ``save_params`` and passed as ``weights_path``, and
thresholds (0.5, 0.5, 0.5) (the reference's keep nothing with these
weights). Four graphs in turn through ``Client.run``: ``MTCNNDetectFaces``,
``EmbedFaces(bboxes=faces)``, ``DetectGender(bboxes=faces)`` and
``EmbedFaces`` over the stored faces (``BboxesToPadded``). Their stored rows
must equal those of the same graphs with both kernels patched to their
plain versions on the card; most frames must have faces, embeddings unit
norm within 1e-5, the launches 4 ``nms`` and 2-3 crops a chunk. FaceNet
embeddings and gender logits of seeded crops on the card are held to the
CPU's, and one chunk's time is split by stage with CUDA events.

Phase 1 also holds ``crop_and_resize_levels`` (the crop kernel with an FPN
level a box) to its plain version with ``==`` at Mask R-CNN's calls of an
8-frame chunk: 8000 boxes at 7x7 and 800 at 14x14 from the four levels
P2..P5 of 800x1088 canvases at C = 256, boxes on every level, past the
edges and zero boxes, and times it beside four ``F.grid_sample`` calls
(one a level); and Mask R-CNN's two ``nms`` calls (the five levels'
proposals [40, 1000] and the class-shifted finals [8, 1000] with the
index) on both paths, timed on each.

Phase 5 drives object detection on 32 640x480 frames in chunks of 8:
``DetectObjects`` (SSD) and ``NNInput`` → ``FasterRCNN`` →
``FasterRCNNOutput``, each graph twice (the first run with the npz read),
rows equal to the plain-patched runs, launches, card against CPU, a
per-stage split.

Phase 6 drives Mask R-CNN the same way: ``MaskRCNNDetectObjects``
R-50-FPN over the same frames (800x1088 canvases, the reference's TEST
caps) on the port's seeded weights with the RPN's and the box head's output
layers scaled, written as npz; twice, rows (boxes, scores, labels, mask
canvases) equal to a run with ``nms`` and ``crop_and_resize_levels``
patched to their plain versions, 2 ``nms`` and 2 level crops a chunk,
detections in most frames, masks of a quarter of the frame; one
X-101-32x8d-FPN chunk the same way; the trunk and heads on the card against
the CPU; one chunk split by stage.

Phase 7 drives OpenPose at 640x480. ``pose_peaks``
(kernels/csrc/peaks.cu) is held to ``find_peaks_plain`` (equal) on the
seeded body net's maps of an 8-frame chunk (the record, timed), and on
random, tied, sparse and ragged maps, one whose best peaks all fall to
one column, peaks and plateaus across the kernel's row bands, a constant
plateau, trained-like maps (15 Gaussian blobs a part) and maps off a
16-byte boundary; the net's, trained-like and plateau maps are timed
beside their bounds and the ``max_pool2d``/``topk`` yardstick, with
the kernel's registers and the clusters resident. ``OpenPose`` runs over 16 frames of the face phase's video in
chunks of 8 on the port's seeded body (its two output layers scaled,
POSE_HEAD_SCALES, so that people form), written as npz, twice; its rows
must equal a run with ``find_peaks`` and the crop patched to their plain
versions, with one ``pose_peaks`` a chunk. One chunk of two scales with
the cubic upsample, one of the CPM2 chain and one with ``compute_face``
and ``compute_hands`` (the chunk's frames reach the decode on the card,
which cuts the face and hand crops there with the crop kernel's gray mode
and runs both crop nets; the grouping gains 3 drawn people a frame, whose
faces the seeded people lack; the gray crop's launches are this run's)
are held the same way. Drawn heat and PAF maps of those people go through
``pose_peaks``, ``limb_scores`` and ``group_people`` and must give exactly
them; ``OpenPoseDecode`` then runs the face and hand nets on 368x368
crops of the chunk's frames (the gray crop equal to its plain version and
timed at the 48 hand crops), and the crop nets and the body net are held
to the CPU. One chunk is split by stage.

Phase 8 drives the attribute classifiers and the generic NN ops on the
face phase's 32 frames in chunks of 16: ``MTCNNDetectFaces`` →
``PrepareClothingBbox`` → ``DetectClothing`` (StreetStyle at 299x299, 16
heads; the window scan and the crops on the host with cv2) twice, the
first run with the npz files read and the second warm; then
``DetectHairStyle`` and ``DetectFaceLandmarks`` on the same faces,
``NNInput`` → ``NNForward(model="facenet_detector")`` →
``FacenetOutput`` with ``InfoFromFrame``, and ``MoEHead`` over FaceNet
embeddings (``NNForward``) of one chunk, on the port's seeded weights
written as npz. Each graph's rows must equal those of the same graph with
``nms`` and ``crop_and_resize`` patched to their plain versions, with
MTCNN's 4 ``nms`` and 2 crops a chunk; records over their vocabularies,
finite landmarks and MoE rows, detector boxes in the frame. One chunk is
split by stage (MTCNN, the window scan, the host crops, the copies, the
StreetStyle forwards), and StreetStyle, the facenet detector, FaceNet and
MoE on the card are held to the CPU on one chunk.

Phase 9 drives the legacy runners, the storage backends and CTC forced
alignment. ``detect_shots`` (the ShotDetectionPipeline runner) runs over
phase 2's stream from a decoder that gives RGB only, as cv2's does, so
that its "auto" ingest takes ``hist_rgb``: boundaries [120, 240, 360]
equal to phase 2's graph, one launch a 128-frame packet, and a second run
with ``cache=True`` that skips the committed output (no launch). A
``FaceDetectionPipeline`` subclass whose ``build_pipeline`` passes phase
4's weights and thresholds runs over phase 4's frames: rows equal to phase
4's ``MTCNNDetectFaces`` graph, 4 ``nms`` and 2 crops a chunk. Phase 2's
histograms go to a ``PackedFileStream`` sink and read back equal to the
``NamedStream`` rows, byte for byte; an sqlite ``SQLInputStream`` →
Python op → ``SQLOutputStream`` job updates 100 rows; a WAV
``AudioStream`` (the card's machine has no libav: WAV only) goes through
a Python op. Then CTC at full width: 600 caption windows of T uniform in
250-350 frames of V = 32 labels, lines of 40-80 characters (S 81-161),
emissions the log-softmax of seeded logits with each line's path planted.
``TranscriptAligner.align_words_ctc`` aligns the whole track in one
``ctc_viterbi`` launch (kernels/csrc/ctc.cu) on its warp path (a warp a
window, no back-pointer scratch: the peak device memory of the call is
logged), its records equal to the CPU's; the kernel is held to
``ctc_viterbi_plain`` on the card over every window (states equal,
scores bit-equal) and, on both of its paths, on tied windows, batches of
S on the warp lanes' edges, a 1025-state window, a Tmax past shared
memory, V = 29 and 48 and emissions off a 16-byte boundary; it is timed
beside its bound, the floor of the scan's Tmax - 1 dependent steps (a
step's latency from ``viterbi_step_probe``, the warp path's steps with no
emission load and no move stored; the block path's beside it) and the
time of the longest window alone.

Phase 10 drives the job layer and the weights-in path. Weights in: the
OpenPose body (phase 7's scaled seeded weights) is written as a
``pose_iter_440000.caffemodel`` and SSD's seeded weights as a
``frozen_inference_graph.pb`` (every third name with ``/read``), both
parsed and timed (MB/s), then ported by the kit's CLI (``python -m
scannertools_tpu_torch.tools.port_checkpoints --strict``), whose npz must
equal the seeded trees bit for bit; ``OpenPose`` (``pose_peaks``) and
``DetectObjects`` (``nms``) on the kit's npz give rows equal to the same
graphs on the seeded weights and to runs with the kernels patched to their
plain versions. The job layer: 12 jobs of 96 1080p RGB frames (phase 2's
synthetic decoder, two cuts a job) through ``Histogram → ShotBoundaries``:
a static run in this process (boundaries and ``hist_rgb`` rows held to the
plain version; the RSS after every job logged), two claims workers (this
script's hidden ``--claims-worker`` mode) of which the slowed one is
SIGKILLed once both hold claims, and the survivor reaps and finishes every
job, rows equal to the static run's (the jobs run twice are logged);
24 short jobs with the job-boundary decoder warm-up on and off
(``ST_TPU_NO_JOB_OVERLAP``) in turns, three times each, on cv2-written
mp4v files when cv2 reads them back (else the synthetic decoder), medians
of the run time and of the gap from a job's last sink write to the next
job's first device chunk logged, and no warm-up may fail; and
``run_recycling`` over the first 3 jobs with ``CacheMode.Resume`` and
``recycle_rss_mb`` 64 MB over each worker's RSS before its first job, in
3 processes, rows equal to the static run's. Each phase logs its wall
seconds.

Phase 11 drives the multi-device axes on meshes of logical shards over
the card's one device (``SCANNERTOOLS_TORCH_LOGICAL_DEVICES=8`` for the
phase only: ``cuda:0`` eight times), each line naming its mesh. The shards
share one H100, so the phase proves the code paths and claims no scaling.
Data axis: phase 2's graph, RGB and I420, with
``pipeline_instances_per_node=4``: boundaries [120, 240, 360], rows equal
to phase 2's unsharded rows, 4 launches of the chunk's kernel a chunk,
frames/s beside phase 2's; the executor's ``Histogram`` segment on one
1080p 64-frame chunk over the mesh of 4 (pad, a launch a shard, gather)
is timed beside the same segment unsharded (the same byte bound). The
net graphs on the data axis (``NET_GRAPHS``): phase 4's MTCNN ->
EmbedFaces and DetectGender (32 frames, chunks of 16), phase 5's
DetectObjects and Faster R-CNN graphs (16 frames, chunks of 8), one
8-frame chunk of phase 6's R-50-FPN graph and phase 7's OpenPose (16
frames, chunks of 8), each unsharded and with
``pipeline_instances_per_node=4`` on one Client: the box, face, detection
and person counts, labels and shapes equal to the unsharded run's, the
float outputs within 1e-4 of their largest value (the largest difference
logged), ``axis:data:engaged`` on every chunk (by "batch_local", and
"inner_split" for the face nets, which split their compacted crop batch)
and never ``not_engaged``, the split segments' kernels launched on every
shard (4 a chunk: MTCNN's 4 ``nms`` and 2 crops each, SSD's ``nms``,
Faster R-CNN's ``nms`` and crop, Mask R-CNN's 2 ``nms`` and 2 level
crops, OpenPose's ``pose_peaks``), and both runs' wall seconds logged.
Static multi-host: the first 4 of phase 10's jobs in two
processes of this script (``--static-slice``, ``RANK``/``WORLD_SIZE`` 0/2
and 1/2) into one db, the union of their rows equal to phase 10's static
rows. Spatial: ``Blur(kernel_size=5) -> ConvertToHSV`` on 8 seeded 1080p
frames with ``spatial_shards=4``, bit-equal to unsharded. Pipeline:
``OpenPose`` at 640x480 on phase 7's weights with ``pipeline_stages=5``:
the people found equal to the unpiped run's, the body maps of a chunk
within 1e-4 of their largest value, one ``pose_peaks`` a chunk. Expert:
``MoEHead`` (8 experts, 128-d rows) with ``expert_shards=4`` and
``DetectClothing`` (two fixed boxes a frame of the face video) with
``expert_shards=8``: MoEHead's routing and dropped rows equal to
unsharded and its values within 1e-5 of the largest (a device's products
batched over 2 experts, not 8, may add in another order), DetectClothing's
rows equal, and the sharded MoE and heads timed beside the single-device
forms. Tensor: ``tp_model`` of the
gender net with a model axis of 2, within 1e-4 of the largest logit.
Dry run: ``run_dryrun(4)``'s loss within 1e-3 of one unsharded step's,
and the pipeline, spatial and expert goldens. Every axis it asks for must
count as engaged and never as not engaged (the profiler's
``axis:<name>:*`` counters); the phase must end within 120 s.

Phase 12 draws every family's default weights on the card (the JAX
package's ``init_*(jax.random.PRNGKey(0))`` through
``models/jax_random.py``), holds each to the committed digest of the JAX
package's draw (``tools/jax_defaults_digest.json``: paths, shapes, sums,
8 values a leaf) and logs each family's draw ms beside the card's name
and power limit. It then runs the six single-process examples of
``examples/`` unedited, at their own widths on default weights, over a
96-frame 640x480 clip that cv2 writes (cuts at 24, 48 and 72; the
examples' stride of 30 gives each net graph 4 frames): in one subprocess
of this script (``--examples-worker``) that maps the name
``scannertools_tpu`` to the port (``tools/jax_alias.py``), each example
runs once with the kernels, their launches counted from 0, and once
with every kernel patched to its plain version. The face, Faster R-CNN
and pose examples, whose random nets keep no row, run again on npz files
of the default draw with their output layers raised
(``write_examples_npz``), passed through each example's weights
argument. Each graph's stored rows must equal its plain run's, the shot
cuts must be the planted ones, the plain runs must launch nothing, no
module of JAX or of the JAX package may load, and ``hist_rgb`` or
``hist_i420``, ``nms``, the crops and ``pose_peaks`` must each launch.
The npz runs, SSD, Mask R-CNN and the shot runs must keep a row in every
stream; a default-weight graph that keeps none is logged on a line of
its own. The launches join the kernels line.

Output, on stdout: one JSON line per phase-1 check, the run totals, then
``{"kernels": [...]}``, the card's name and power limit from nvidia-smi,
and last ``{"ok": true, "device": {...}}``. Any failure raises: the exit
code is then not 0 and the last line is not printed. Without a CUDA device,
or without the package beside this file, it fails the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from scannertools_tpu_torch.tools.timing import (band_edge_maps, blob_maps,
                                                 box_cloud, card,
                                                 grid_sample_crops,
                                                 grid_sample_level_crops,
                                                 level_boxes,
                                                 peaks_yardstick, time_ms,
                                                 yardstick_agrees)

N_FRAMES, HEIGHT, WIDTH, FPS = 480, 1080, 1920, 24.0
CUTS = (120, 240, 360)
CHUNK = 64
COLORS = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40)]
BAR = 16  # moving white bar width, px (even: whole chroma columns)

# phase 3: 640x480 texture panning FLOW_MOTION px per frame, every
# FLOW_STRIDE-th frame sampled, FLOW_CHUNK pairs per chunk
FLOW_FRAMES, FLOW_H, FLOW_W = 128, 480, 640
FLOW_STRIDE, FLOW_CHUNK = 2, 32
FLOW_MOTION = (1, 1)  # (x, y) px per source frame
FLOW_LAUNCHES_PER_CHUNK = 12  # (levels + 1) * iters at the defaults
# flow_update per pixel: r0 20 B + r1 20 B + flow 8 B + out 20 B, and the
# float32 operations of csrc/flow.cu's kernel per warp mode
FLOW_BYTES_PER_PX = 68
FLOW_OPS_PER_PX = {16: 116, 0: 107}

# phase 4: the face suite on FACE_FRAMES frames of FACE_W x FACE_H in chunks
# of FACE_CHUNK
FACE_FRAMES, FACE_H, FACE_W, FACE_CHUNK = 32, 480, 640, 16
# the port's seeded weights score most P-Net cells and MTCNN faces of these
# frames between 0.5 and 0.6 (the reference's 0.45, 0.6, 0.7 keep none):
# 0.5 at every stage keeps rows at each one (12-17 faces a frame)
FACE_THRESHOLDS = (0.5, 0.5, 0.5)
# phase 5: object detection on DET_FRAMES frames of FACE_W x FACE_H (the
# face phase's drifting blobs) in chunks of DET_CHUNK; Faster R-CNN reads
# them resized to FRCNN_W x FRCNN_H (conv5_3 37x50: 16,650 anchors, the
# top 2048 to nms, 300 RoIs a frame)
DET_FRAMES, DET_CHUNK = 32, 8
FRCNN_W, FRCNN_H = 800, 600
FRCNN_MEAN = (102.9801, 115.9465, 122.7717)
# the port's seeded weights give near-uniform class probabilities (about
# 1/81), so the reference's 0.7 keeps nothing; 0.016 keeps a few boxes a
# frame after the decode's NMS (the phase logs how many)
FRCNN_SCORE = 0.016
# phase 6: Mask R-CNN on the detection phase's frames (DET_FRAMES of
# 640x480 in chunks of DET_CHUNK): 800x1067 letterboxes on 800x1088
# canvases (P2 200x272: 163,200 anchors a frame), the reference's TEST caps
# (1000 a level, 1000 proposals, 100 finals at score 0.05)
MRCNN_CANVAS = (800, 1088)
MRCNN_ARCH = "R-50-FPN"
MRCNN_X_ARCH = "X-101-32x8d-FPN"  # the reference's default checkpoint
# the port's seeded weights with these output layers scaled, so that the
# RPN's scores and deltas and the box head's probabilities and deltas
# spread as a trained model's do: unscaled, the seeded trunk's activations
# (a few hundred) put most sigmoids at 0 or 1 and push each refined box to
# the canvas's edge
MRCNN_HEAD_SCALES = (("rpn.cls_logits", 0.02), ("rpn.bbox_pred", 0.002),
                     ("box.cls_score", 0.05), ("box.bbox_pred", 0.002))
# the decode's confidence filter: the reference's 0.5 keeps 0-2 of these
# weights' finals a frame (scores about 0.2-0.65); 0.25 keeps some masks in
# every frame
MRCNN_CONFIDENCE = 0.25
# launches a chunk: nms for the proposals and for the finals; the level
# crop at 7x7 (RoIAlign) and 14x14 (masks)
MRCNN_LAUNCHES_PER_CHUNK = {"nms": 2, "crop_and_resize": 0,
                            "crop_and_resize_levels": 2}
MRCNN_CPU_MIN_SIZE = 320  # card against CPU: one frame at a 320x448 canvas
# phase 7: OpenPose on POSE_FRAMES frames of FACE_W x FACE_H (the face
# phase's drifting blobs) in chunks of POSE_CHUNK, the body at stages=6
POSE_FRAMES, POSE_CHUNK = 16, 8
# the port's seeded body maps are near 1e-4 (LeCun-normal layers under
# ReLU), where no pixel clears the 0.1 peak threshold; its two output
# layers scaled so give peaks, feasible limbs and 14-15 people a frame
POSE_HEAD_SCALES = (("Mconv7_stage6_L1.weight", 10000.0),
                    ("Mconv7_stage6_L2.weight", 3000.0))
POSE_PEOPLE = 3  # drawn people a frame
POSE_CROP = 368  # the wrapper's face and hand crops
POSE_CPU_HW = (240, 320)  # card against CPU: the body net on one frame
# phase 8: the attribute classifiers and the generic NN ops on the face
# phase's frames and faces (FACE_FRAMES of FACE_W x FACE_H, chunks of
# FACE_CHUNK): the facenet detector's mean colours (its docstring's), and
# the experts of MoEHead over FaceNet's 128-d embeddings
FACENET_DETECTOR_MEAN = (119.3, 110.6, 101.4)
# the seeded detector puts half its template cells above the reference's
# 0.5 (78,000 a frame), which FacenetOutput's host NMS (quadratic) takes
# minutes over; 0.9999 keeps 65-76 candidates a frame
FACENET_DETECTOR_SCORE = 0.9999
MOE_DIMS = (8, 128, 256)  # n_experts, d_model, d_hidden
# card against CPU, float32 nets: largest difference over largest value
CARD_CPU_RTOL = 1e-4
CROP_LIBRARY_ATOL = 0.1

# H100 SXM data sheet peaks: HBM3 bandwidth and FP32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ timing


def read_ms(x) -> float:
    """One PyTorch reduction over the bytes of ``x``: the card's own read
    rate on them (an int64 sum; PyTorch's int32 sum runs several times
    slower)."""
    import torch

    flat = x.reshape(-1)
    words = flat.view(torch.int64) if flat.numel() % 8 == 0 else \
        flat.view(torch.int32)
    return time_ms(lambda: words.sum())


def bound_ms(bytes_moved: float, fp32_ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 1


def random_frames(gen, t: int, nbytes: int):
    import torch

    return torch.randint(0, 256, (t, nbytes), dtype=torch.uint8,
                         device="cuda", generator=gen)


def check_kernels():
    """-> per-kernel records at the main path's shape (1080p, T=64)."""
    import torch

    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.utils.framechunk import LANES

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"hist_rgb": 0, "hist_i420": 0}
    records = {}

    def compare(name, got, want, **shape):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst[name] = max(worst[name], err)
        log({"check": name, **shape, "max_abs_err": err})
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}: max abs diff {err}")

    def lane_rows(t, payload):
        return random_frames(gen, t, -(-payload // LANES) * LANES)

    def unaligned(x):  # the same frames, one byte past a 16-byte boundary
        buf = torch.zeros(x.numel() + 16, dtype=torch.uint8, device="cuda")
        out = buf[1:x.numel() + 1].view(x.shape)
        out.copy_(x)
        return out

    def flat_rgb(t, h, w, rng=None):
        """One colour, or (rng=(lo, hi)) random bytes in [lo, hi)."""
        n = -(-h * w * 3 // LANES) * LANES
        x = torch.zeros((t, n), dtype=torch.uint8, device="cuda")
        px = x[:, :h * w * 3].view(t, h * w, 3)
        if rng is None:
            px.copy_(torch.tensor(COLORS[0], dtype=torch.uint8))
        else:
            px.copy_(torch.randint(rng[0], rng[1], px.shape,
                                   dtype=torch.uint8, device="cuda",
                                   generator=gen))
        return x

    def flat_i420(t, h, w, yuv, y_range=None):
        """One Y, U, V, or (y_range) random luma over grey chroma."""
        n = -(-h * w * 3 // 2 // LANES) * LANES
        x = torch.zeros((t, n), dtype=torch.uint8, device="cuda")
        x[:, :h * w] = yuv[0]
        x[:, h * w:h * w * 5 // 4] = yuv[1]
        x[:, h * w * 5 // 4:h * w * 3 // 2] = yuv[2]
        if y_range is not None:
            x[:, :h * w] = torch.randint(y_range[0], y_range[1], (t, h * w),
                                         dtype=torch.uint8, device="cuda",
                                         generator=gen)
        return x

    def check_rgb(flat, t, h, w, c=3, **tags):
        npix = h * w * c
        got = H.hist_rgb(flat, npix, c)
        compare("hist_rgb", got, H.hist_rgb_plain(flat, npix, c), t=t, h=h,
                w=w, c=c, **tags)
        return got

    def check_i420(flat, t, h, w, coef_sets=((False, False),), **tags):
        for bt709, full in coef_sets:
            got = H.hist_i420(flat, h, w, full, bt709)
            compare("hist_i420", got,
                    H.hist_i420_plain(flat, h, w, full, bt709), t=t, h=h,
                    w=w, bt709=bt709, full_range=full, **tags)
        return got

    all_coefs = [(b, f) for b in (False, True) for f in (False, True)]

    # RGB byte streams in the FrameChunk layout, plus unaligned NHWC tensors
    # (the byte-load path) and 1- to 6-channel streams
    for t, h, w in [(3, 33, 17), (2, 120, 128), (CHUNK, HEIGHT, WIDTH),
                    (1, 4320, 7680)]:
        flat = lane_rows(t, h * w * 3)
        check_rgb(flat, t, h, w)
        if (t, h, w) == (CHUNK, HEIGHT, WIDTH):
            npix = h * w * 3
            nbytes = t * npix
            bound, by = bound_ms(nbytes + t * 3 * 16 * 4, nbytes)
            flat_frames = flat_rgb(t, h, w)
            records["hist_rgb"] = {
                "ms": time_ms(lambda: H.hist_rgb(flat, npix, 3)),
                "flat_ms": time_ms(lambda: H.hist_rgb(flat_frames, npix, 3)),
                "device_ms": time_ms(lambda: H.hist_rgb(flat, npix, 3),
                                     fence=True),
                "read_ms": read_ms(flat),
                "plain_ms": time_ms(lambda: H.hist_rgb_plain(flat, npix, 3),
                                    reps=5, warm=1),
                "bound_ms": bound, "bound_by": by}
            check_rgb(flat_frames, t, h, w, frames="flat")
            del flat_frames
            got = check_rgb(flat_rgb(t, h, w, (240, 256)), t, h, w,
                            frames="bin15")
            if not (got[:, :, 15] == h * w).all():
                raise AssertionError("hist_rgb: bin-15 frames miscounted")
            check_rgb(unaligned(flat[:2]), 2, h, w, layout="unaligned")
        del flat
    for t, h, w, c in [(3, 33, 17, 3), (2, 31, 29, 1), (2, 45, 37, 4),
                       (2, 23, 41, 2), (2, 23, 41, 5), (2, 23, 41, 6)]:
        nhwc = random_frames(gen, t, h * w * c).reshape(t, h, w, c)
        check_rgb(nhwc, t, h, w, c, layout="nhwc")

    for t, h, w in [(3, 34, 18), (2, 120, 128), (2, HEIGHT, WIDTH - 2),
                    (CHUNK, HEIGHT, WIDTH), (1, 4320, 7680)]:
        flat = lane_rows(t, h * w * 3 // 2)
        check_i420(flat, t, h, w, all_coefs)
        if (t, h, w) == (CHUNK, HEIGHT, WIDTH):
            nbytes = t * h * w * 3 // 2
            # per luma sample: (Y-yo)*ys and three sums; per chroma sample:
            # two offsets and four products
            ops = t * (6 * h * w + 6 * (h // 2) * (w // 2))
            bound, by = bound_ms(nbytes + t * 3 * 16 * 4, ops)
            red = flat_i420(t, h, w, (81, 90, 240))  # red, limited BT.601
            records["hist_i420"] = {
                "ms": time_ms(lambda: H.hist_i420(flat, h, w)),
                "flat_ms": time_ms(lambda: H.hist_i420(red, h, w)),
                "device_ms": time_ms(lambda: H.hist_i420(flat, h, w),
                                     fence=True),
                "read_ms": read_ms(flat),
                "plain_ms": time_ms(lambda: H.hist_i420_plain(flat, h, w),
                                    reps=5, warm=1),
                "bound_ms": bound, "bound_by": by}
            check_i420(red, t, h, w, frames="flat")
            del red
            # near-white luma over grey chroma: every value >= 240, most
            # past 255 (counted apart in the kernel, folded into bin 15)
            got = check_i420(flat_i420(t, h, w, (0, 128, 128), (235, 256)),
                             t, h, w, frames="bin15")
            if not (got[:, :, 15] == h * w).all():
                raise AssertionError("hist_i420: bin-15 frames miscounted")
            check_i420(unaligned(flat[:2]), 2, h, w, layout="unaligned")
        del flat
    torch.cuda.synchronize()
    for name in records:
        records[name]["max_abs_err"] = worst[name]
        log({"timing": name, "shape": [CHUNK, HEIGHT, WIDTH],
             **records[name]})
    return records


def check_flow_update():
    """-> the flow_update record at the flow path's finest level (32 pairs
    of 640x480, warp_px 16), after holding the kernel to its plain version
    in both warp modes at ragged sizes and at that level."""
    import torch

    from scannertools_tpu_torch.ops import optical_flow as OF

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0

    def inputs(t, h, w, spread):
        r0, r1 = (torch.randn((t, h, w, 5), device="cuda", generator=gen)
                  * 10 for _ in range(2))
        flow = torch.randn((t, h, w, 2), device="cuda", generator=gen) \
            * spread
        return r0, r1, flow

    record = {}
    shapes = [(2, 33, 47), (3, 15, 17), (2, 16, 9), (1, 2, 5), (2, 61, 81),
              (FLOW_CHUNK, FLOW_H, FLOW_W)]
    for warp_px in (16, 0):
        for t, h, w in shapes:
            # flow within a few px (as the pyramid gives it) and past
            # warp_px and the frame (every clamp taken)
            for spread in (2.0, 25.0):
                args = inputs(t, h, w, spread)
                got = OF.flow_update(*args, warp_px)
                want = OF.flow_update_plain(*args, warp_px)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                log({"check": "flow_update", "t": t, "h": h, "w": w,
                     "warp_px": warp_px, "flow_spread": spread,
                     "max_abs_err": err})
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"flow_update disagrees with its plain version at "
                        f"{(t, h, w)}, warp_px {warp_px}: max abs diff "
                        f"{err}")
            if (t, h, w) != (FLOW_CHUNK, FLOW_H, FLOW_W):
                continue
            args = inputs(t, h, w, 2.0)
            npx = t * h * w
            bound, by = bound_ms(npx * FLOW_BYTES_PER_PX,
                                 npx * FLOW_OPS_PER_PX[warp_px])
            timing = {
                "ms": time_ms(lambda: OF.flow_update(*args, warp_px)),
                "device_ms": time_ms(lambda: OF.flow_update(*args, warp_px),
                                     fence=True),
                "plain_ms": time_ms(
                    lambda: OF.flow_update_plain(*args, warp_px), reps=5,
                    warm=1),
                "bound_ms": bound, "bound_by": by}
            log({"timing": "flow_update", "warp_px": warp_px,
                 "shape": [t, h, w], **timing})
            if warp_px == 16:
                record = timing
            del args
    torch.cuda.synchronize()
    record["max_abs_err"] = worst
    return record


def nms_bound(boxes, scores, max_out: int, score_thresh: float,
              index: bool = False) -> tuple:
    """The bound of one nms call on these inputs: boxes and scores read,
    boxes, scores and valid (and the int64 index) written once; the
    operations its data needs:
    K * ceil(log2 K) comparisons a frame for a stable sort of the scores
    (what the function needs, not the kernel's K * K rank sort), 5 a box
    for its area and 14 an overlap (4 max/min, 2 differences, 2 clamps, a
    product, a sum and a difference, a division, 2 comparisons) for each
    pair after a valid row."""
    t, k = scores.shape
    nbytes = t * k * (16 + 4) + t * max_out * (16 + 4 + 1 + 8 * index)
    # valid rows lead the score order: the v of a frame pair with the rows
    # after them
    per_frame_valid = (scores > score_thresh).sum(dim=1).tolist()
    pairs = sum(v * (k - 1) - v * (v - 1) // 2 for v in per_frame_valid)
    ops = t * (k * math.ceil(math.log2(k)) + 5 * k) + 14 * pairs
    return bound_ms(nbytes, ops)


def check_nms():
    """-> the nms record at the main path's largest call (the cross-scale
    NMS of a 16-frame chunk: [16, 256] boxes, max_out 256), after holding
    the kernel to its plain version (difference 0) on seeded clouds, on
    both of its paths (one launch, or the mask in device memory, as
    MC.nms_geometry picks them)."""
    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.tools.nms_probe import path as forced_path

    rng = np.random.default_rng(2)
    worst = 0.0

    def check(boxes, scores, iou, max_out, score_thresh, mode, **tags):
        nonlocal worst
        b = torch.from_numpy(boxes).cuda()
        s = torch.from_numpy(scores).cuda()
        got = MC.nms(b, s, iou, max_out, score_thresh, mode, index=True)
        want = MC.nms_plain(b, s, iou, max_out, score_thresh, mode,
                            index=True)
        if not all(torch.equal(g, w) for g, w in zip(
                got[:3], MC.nms(b, s, iou, max_out, score_thresh, mode))):
            raise AssertionError(f"nms with the index disagrees with nms "
                                 f"without it at {tags}")
        err = max(float((g.float() - w.float()).abs().max())
                  if g.numel() else 0.0 for g, w in zip(got, want))
        worst = max(worst, err)
        log({"check": "nms", "t": int(scores.shape[0]),
             "k": int(scores.shape[1]), "max_out": max_out, "mode": mode,
             "kept": int(got[2].sum()), "max_abs_err": err, **tags})
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"nms disagrees with its plain version at "
                                 f"{tags}, k {scores.shape}: {err}")

    limit = MC.NMS_SHARED_MAX_K
    for mode in ("union", "min"):
        for k in (1, 5, 63, 64, 65, 96, 127, 128, 129, 256, 1000, limit,
                  limit + 1, 2048, 4096):
            # K = 1000 on both paths (2 frames spread, 32 do not); at the
            # limit, enough frames for the one-launch path
            t = 16 if k <= 256 else (MC.NMS_SPREAD_BELOW_T if k == limit
                                     else 2)
            # denser clouds at the tile edges: suppression crosses tiles
            boxes = box_cloud(rng, t, k, 600.0 if k in (96, 128, 256)
                              else 40.0 * max(1.0, (k / 128) ** 0.5))
            scores = rng.uniform(0, 1, (t, k)).astype(np.float32)
            scores[:, ::5] = 0.5          # ties
            scores[0] = 0.0               # an all-invalid frame
            iou = 0.7 if mode == "union" else 0.3
            kept = int(MC.nms_plain(torch.from_numpy(boxes).cuda(),
                                    torch.from_numpy(scores).cuda(), iou,
                                    k, 0.0, mode)[2].sum(dim=1).max())
            for max_out in sorted({max(1, k // 2), max(1, kept // 2), k,
                                   k + 7}):
                check(boxes, scores, iou, max_out, 0.0, mode,
                      path=MC.nms_geometry(t, k)["path"])
            if k == 1000:  # and the one-launch path at this K
                many = np.concatenate([boxes] * 16)
                check(many, np.concatenate([scores] * 16), iou, k, 0.0,
                      mode, path=MC.nms_geometry(len(many), k)["path"])
    # alternating chains: box i overlaps only box i + 1 (IoU 0.25), within
    # a tile, across tiles, and on the device-memory path
    for n in (64, 150, 1500):
        chain = np.stack([np.arange(n) * 6.0, np.zeros(n),
                          np.arange(n) * 6.0 + 10, np.full(n, 10.0)],
                         axis=1).astype(np.float32)
        check(np.stack([chain, chain]), np.stack(
            [np.linspace(1.0, 0.5, n), np.full(n, 0.5)]).astype(np.float32),
            0.2, n, 0.0, "union", case="chain")

    timings = {}
    # the face path's calls of a chunk (the five pyramid scales' calls in
    # one), then the detection models': SSD's class-shifted call of a
    # chunk with the kept index (normalized boxes shifted by 4 a label),
    # Faster R-CNN's proposals of a chunk at 800x600, a Mask R-CNN FPN
    # level, the proposals of two frames; Mask R-CNN's two calls of an
    # 8-frame chunk at 800x1088 (the five levels' proposals, and the finals
    # on boxes shifted by 2 * 1088 a label, scores above 0.05, with the
    # index), each also timed on the other path, forced
    for name, t, k, max_out, mode, iou, index, thresh in (
            ("cross_scale", FACE_CHUNK, 256, 256, "union", 0.7, False, 0.0),
            ("per_scale", 5 * FACE_CHUNK, 128, 128, "union", 0.7, False,
             0.0),
            ("rnet", FACE_CHUNK, 96, 96, "union", 0.7, False, 0.0),
            ("onet", FACE_CHUNK, 64, 32, "min", 0.7, False, 0.0),
            ("ssd", DET_CHUNK, 512, 100, "union", 0.6, True, 0.0),
            ("rpn_chunk", DET_CHUNK, 2048, 300, "union", 0.7, False, 0.0),
            ("fpn_level", 1, 1000, 1000, "union", 0.7, False, 0.0),
            ("rpn", 2, 2048, 300, "union", 0.7, False, 0.0),
            ("mrcnn_proposals", 5 * DET_CHUNK, 1000, 1000, "union", 0.7,
             False, 0.0),
            ("mrcnn_final", DET_CHUNK, 1000, 100, "union", 0.5, True,
             0.05)):
        if name == "ssd":
            cloud = box_cloud(rng, t, k, 1.0, lo=0.02, hi=0.5)
            cloud += rng.integers(1, 91, (t, k, 1)) * 4.0
        elif name.startswith("mrcnn"):
            cloud = box_cloud(rng, t, k, 1088.0, lo=4.0, hi=400.0)
            if name == "mrcnn_final":
                cloud += rng.integers(1, 81, (t, k, 1)) * 2.0 * 1088
        else:
            cloud = box_cloud(rng, t, k, 800.0 if "rpn" in name else 600.0)
        cloud = cloud.astype(np.float32)
        scores = rng.uniform(0, 1 if thresh == 0.0 else 0.3,
                             (t, k)).astype(np.float32)
        # every timed call is held to the plain version first, on both
        # paths where it is timed on both
        paths = [None] + (["shared", "global"] if name.startswith("mrcnn")
                          else [])
        for p in paths:
            with forced_path(p):
                check(cloud, scores, iou, max_out, thresh, mode, call=name,
                      path=MC.nms_geometry(t, k)["path"])
        boxes = torch.from_numpy(cloud).cuda()
        scores = torch.from_numpy(scores).cuda()
        bound, by = nms_bound(boxes, scores, max_out, thresh, index)

        def call():
            return MC.nms(boxes, scores, iou, max_out, thresh, mode, index)

        timings[name] = {
            "ms": time_ms(call), "device_ms": time_ms(call, fence=True),
            "plain_ms": time_ms(lambda: MC.nms_plain(
                boxes, scores, iou, max_out, thresh, mode, index), reps=5,
                warm=1),
            "bound_ms": bound, "bound_by": by}
        for p in paths[1:]:
            with forced_path(p):
                timings[name][f"device_ms.{p}"] = time_ms(call, fence=True)
        log({"timing": "nms", "call": name, "shape": [t, k],
             "max_out": max_out, "mode": mode, "index": index,
             "score_thresh": thresh, "path": MC.nms_geometry(t, k)["path"],
             "kept": int(MC.nms(boxes, scores, iou, max_out, thresh,
                                mode)[2].sum()), **timings[name]})
    torch.cuda.synchronize()
    record = dict(timings["cross_scale"])
    record["max_abs_err"] = worst
    return record


def crop_bound(images, boxes, oh: int, ow: int) -> tuple:
    """Bytes: the crops written once, the boxes and frame indices read, and
    each frame pixel that some crop's taps read, once (overlapping boxes
    share their pixels); operations: 9 a value (two y-lerps and an x-lerp)
    and 26 a pixel for its two sample positions and four weights. boxes:
    [T, K, 4], K a frame of ``images``."""
    import torch

    t, _, _, c = images.shape
    flat = boxes.reshape(-1, 4)
    fi = torch.arange(t, device=flat.device).repeat_interleave(
        boxes.shape[1])
    n_out = flat.shape[0] * oh * ow
    nbytes = (n_out * c * 4 + flat.shape[0] * (16 + 8)
              + touched_pixels(images, flat, fi, oh, ow) * c * 4)
    return bound_ms(nbytes, n_out * (9 * c + 26))


def touched_pixels(images, flat, fi, oh: int, ow: int) -> int:
    """The pixels of ``images`` [T, H, W, C] that the taps of the crops of
    ``flat`` [B, 4] boxes from frames ``fi`` read, each counted once."""
    import torch

    from scannertools_tpu_torch.models import common as MC

    t, h, w, _ = images.shape
    touched = torch.zeros((t, h, w), dtype=torch.bool, device=flat.device)
    for i in range(0, flat.shape[0], 64):
        b = flat[i:i + 64]
        y0, y1, _, _ = MC._taps(b[:, 1], b[:, 3], oh, h)
        x0, x1, _, _ = MC._taps(b[:, 0], b[:, 2], ow, w)
        rows, cols = torch.cat([y0, y1], 1), torch.cat([x0, x1], 1)
        touched[fi[i:i + 64, None, None], rows[:, :, None],
                cols[:, None, :]] = True
    return int(touched.sum())


def level_crop_bound(maps, boxes, level, fi, oh: int, ow: int) -> tuple:
    """crop_bound of the level crop: the crops written, the boxes, levels
    and frame indices read, and each pixel of each level that some crop's
    taps read, once."""
    from scannertools_tpu_torch.models import common as MC

    c = maps[0].shape[3]
    n_out = boxes.shape[0] * oh * ow
    pixels = 0
    for lvl, (m, stride) in enumerate(zip(maps, MC.FPN_STRIDES)):
        sel = level == lvl
        pixels += touched_pixels(m, boxes[sel] / stride, fi[sel], oh, ow)
    nbytes = n_out * c * 4 + boxes.shape[0] * (16 + 8 + 8) + pixels * c * 4
    return bound_ms(nbytes, n_out * (9 * c + 26))


def check_level_crop() -> dict:
    """-> {call: timing} of crop_and_resize_levels at Mask R-CNN's calls of
    an 8-frame chunk: the four FPN levels of 800x1088 canvases at C = 256
    (P2 [8, 200, 272, 256] .. P5 [8, 25, 34, 256]), 8000 boxes at 7x7 (the
    RoIAlign of 1000 proposals a frame) and 800 at 14x14 (the masks of 100
    finals a frame), boxes on every level, past the edges, and zero boxes,
    each held to its plain version with ``==`` first. ``library_ms``: four
    ``F.grid_sample`` calls, one a level over its boxes (the grids built
    and the crops gathered outside the window)."""
    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import maskrcnn as PM

    rng = np.random.default_rng(8)
    canvas = MRCNN_CANVAS
    maps = [torch.from_numpy(rng.standard_normal(
        (DET_CHUNK, canvas[0] // s, canvas[1] // s, 256)).astype(
            np.float32)).cuda() for s in MC.FPN_STRIDES]
    timings = {}
    for name, k, size in (("roi_align_7", 1000, 7), ("mask_14", 100, 14)):
        boxes, fi = level_boxes(rng, DET_CHUNK, k, canvas)
        boxes = torch.from_numpy(boxes).cuda()
        fi = torch.from_numpy(fi).cuda()
        level = PM.fpn_level_for(boxes)
        per_level = torch.bincount(level, minlength=4).tolist()
        if min(per_level) == 0:
            raise AssertionError(f"level crop {name}: boxes a level "
                                 f"{per_level}")
        args = (maps, boxes, level, fi, (size, size))
        got = MC.crop_and_resize_levels(*args)
        if not torch.equal(got, MC.crop_and_resize_levels_plain(*args)):
            raise AssertionError(f"crop_and_resize_levels disagrees with its "
                                 f"plain version at {name}")
        lib_out, lib_call = grid_sample_level_crops(
            maps, boxes, level, fi, size, size, MC._sample_positions,
            MC.FPN_STRIDES)
        lib_err = float((lib_out - got).abs().max())
        if not lib_err < CROP_LIBRARY_ATOL:
            raise AssertionError(f"grid_sample and crop_and_resize_levels "
                                 f"differ by {lib_err} at {name}")
        del lib_out, got
        bound, by = level_crop_bound(maps, boxes, level, fi, size, size)
        timings[name] = {
            "ms": time_ms(lambda: MC.crop_and_resize_levels(*args)),
            "device_ms": time_ms(lambda: MC.crop_and_resize_levels(*args),
                                 fence=True),
            "plain_ms": time_ms(lambda: MC.crop_and_resize_levels_plain(
                *args), reps=5, warm=1),
            "library_ms": time_ms(lib_call),
            "library": "4 F.grid_sample, one a level",
            "library_max_abs_err": lib_err, "max_abs_err": 0.0,
            "bound_ms": bound, "bound_by": by}
        log({"timing": "crop_and_resize_levels", "call": name,
             "shape": [DET_CHUNK * k, size, size, 256],
             "boxes_a_level": per_level, **timings[name]})
    torch.cuda.synchronize()
    return timings


def check_crop():
    """-> the crop_and_resize record at FaceNet's crop of a 16-frame 640x480
    chunk (MAX_FACES boxes a frame, the budget phase 4 passes, 160x160),
    after holding the kernel to its plain version (difference 0) at the
    four output sizes of the face path, and at 1, 3, 4 and 256 channels."""
    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.ops.faces import MAX_FACES

    rng = np.random.default_rng(3)
    worst = 0.0
    frames = torch.from_numpy(rng.uniform(
        0, 255, (FACE_CHUNK, FACE_H, FACE_W, 3)).astype(np.float32)).cuda()
    for size in (24, 48, 160, 227):
        for kind in ("mixed", "small", "large", "edge", "degenerate"):
            b = 64
            if kind == "small":    # upsampled
                boxes = box_cloud(rng, 1, b, 600.0)[0]
                boxes[:, 2:] = boxes[:, :2] + rng.uniform(2, size / 2, (b, 2))
            elif kind == "large":  # downsampled
                boxes = box_cloud(rng, 1, b, 600.0)[0]
                boxes[:, 2:] = boxes[:, :2] + rng.uniform(size, 470, (b, 2))
            elif kind == "edge":   # on and past the frame's edges
                boxes = box_cloud(rng, 1, b, 600.0)[0]
                boxes[::2, :2] -= 100
                boxes[1::2, 2:] += 200
            elif kind == "degenerate":
                boxes = box_cloud(rng, 1, b, 600.0)[0]
                boxes[:, 2] = boxes[:, 0] - rng.uniform(0, 5, b)
            else:
                boxes = box_cloud(rng, 1, b, 600.0)[0]
            fi = torch.from_numpy(rng.integers(0, FACE_CHUNK, b)).cuda()
            bt = torch.from_numpy(boxes).cuda()
            got = MC.crop_and_resize(frames, bt, (size, size), fi)
            want = MC.crop_and_resize_plain(frames, bt, (size, size), fi)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            log({"check": "crop_and_resize", "size": size, "boxes": kind,
                 "n": b, "max_abs_err": err})
            if not torch.equal(got, want):
                raise AssertionError(f"crop_and_resize disagrees with its "
                                     f"plain version: {size} {kind}: {err}")
    # both kernels (rows for C <= 4, channel vectors for C = 256) at widths
    # 227 (rows mostly off a 16-byte boundary) and 1, on frames on and off
    # a 16-byte boundary (off it, C = 256 takes the row kernel)
    for c in (1, 3, 4, 256):
        maps = torch.from_numpy(rng.uniform(
            0, 255, (2, 61, 83, c)).astype(np.float32)).cuda()
        shifted = torch.empty(maps.numel() + 1, device="cuda")[1:].view(
            maps.shape)
        shifted.copy_(maps)
        boxes = torch.from_numpy(box_cloud(rng, 1, 24, 70.0)[0]).cuda()
        fi = torch.from_numpy(rng.integers(0, 2, 24)).cuda()
        for ow in (227, 1):
            want = MC.crop_and_resize_plain(maps, boxes, (9, ow), fi)
            for base, imgs in (("aligned", maps), ("offset", shifted)):
                got = MC.crop_and_resize(imgs, boxes, (9, ow), fi)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                log({"check": "crop_and_resize", "channels": c,
                     "out": [9, ow], "frames": base, "n": 24,
                     "max_abs_err": err})
                if not torch.equal(got, want):
                    raise AssertionError(f"crop_and_resize disagrees with "
                                         f"its plain version: C {c}, width "
                                         f"{ow}, {base}: {err}")

    # FPN level P2 of an 800x1344 canvas (stride 4), 256 channels; Faster
    # R-CNN's conv5_3 maps of a chunk at 800x600 (stride 16), 512 channels
    p2 = torch.from_numpy(rng.standard_normal((1, 200, 336, 256)).astype(
        np.float32)).cuda()
    c5 = torch.from_numpy(rng.standard_normal(
        (DET_CHUNK, FRCNN_H // 16, FRCNN_W // 16, 512)).astype(
            np.float32)).cuda()
    timings = {}
    for name, images, k, size in (("facenet", frames, MAX_FACES, 160),
                                  ("gender", frames, MAX_FACES, 227),
                                  ("rnet", frames, 96, 24),
                                  ("onet", frames, 64, 48),
                                  ("roi_align_c512", c5, 300, 7),
                                  ("roi_7", p2, 1000, 7),
                                  ("roi_14", p2, 1000, 14)):
        t, h, w, c = images.shape
        boxes = torch.from_numpy(
            box_cloud(rng, t, k) if images is frames else
            box_cloud(rng, t, k, float(min(h, w)), lo=2.0,
                      hi=min(60.0, float(min(h, w))))).cuda()
        fi = torch.arange(t).cuda().repeat_interleave(k)
        flat = boxes.reshape(-1, 4).contiguous()
        lib_out, lib_call = grid_sample_crops(images, boxes, size, size,
                                              MC._sample_positions)
        got = MC.crop_and_resize(images, flat, (size, size), fi)
        if images is c5:  # the RoIAlign's call: held to the plain version
            err = float((got - MC.crop_and_resize_plain(
                images, flat, (size, size), fi)).abs().max())
            worst = max(worst, err)
            log({"check": "crop_and_resize", "call": name,
                 "shape": [t * k, size, size, c], "max_abs_err": err})
            if err != 0.0:
                raise AssertionError(f"crop_and_resize disagrees with its "
                                     f"plain version at {name}: {err}")
        lib_err = float((lib_out - got).abs().max())
        # the positions' round trip through [-1, 1] moves a sample by a few
        # float32 ulps of 640 px (6.1e-5 each), times pixel steps up to 255
        if not lib_err < CROP_LIBRARY_ATOL:
            raise AssertionError(f"grid_sample and crop_and_resize differ "
                                 f"by {lib_err} at {name}")
        del lib_out, got
        bound, by = crop_bound(images, boxes, size, size)
        timings[name] = {
            "ms": time_ms(lambda: MC.crop_and_resize(images, flat,
                                                     (size, size), fi)),
            "device_ms": time_ms(lambda: MC.crop_and_resize(
                images, flat, (size, size), fi), fence=True),
            "plain_ms": time_ms(lambda: MC.crop_and_resize_plain(
                images, flat, (size, size), fi), reps=5, warm=1),
            "library_ms": time_ms(lib_call),
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": by}
        log({"timing": "crop_and_resize", "call": name,
             "shape": [t * k, size, size, c], **timings[name]})
    torch.cuda.synchronize()
    record = dict(timings["facenet"])
    del record["library_max_abs_err"]
    record["max_abs_err"] = worst
    return record


# ------------------------------------------------------------ phase 2


def shot_of(i: int, cuts=CUTS) -> int:
    return sum(i >= c for c in cuts)


def rgb_to_i420_limited(rgb):
    """BT.601 limited-range YUV of one RGB colour (the decoder's job)."""
    r, g, b = (float(v) / 255.0 for v in rgb)
    y = 16 + 65.481 * r + 128.553 * g + 24.966 * b
    u = 128 - 37.797 * r - 74.203 * g + 112.0 * b
    v = 128 + 112.0 * r - 93.786 * g - 18.214 * b
    return tuple(int(round(c)) for c in (y, u, v))


class SyntheticDecoder:
    """The decoder interface the executor calls, drawing the shots and a
    moving bar straight into the staging slot it is given."""

    i420_supported = True
    i420_full_range = False
    i420_bt709 = False

    def __init__(self, n: int, h: int, w: int, cuts=CUTS, first: int = 0):
        """Shots change at ``cuts``; shot k has colour COLORS[first + k]
        (mod 4)."""
        self.n, self.h, self.w = n, h, w
        self.cuts, self.first = tuple(cuts), first
        self._rgb = {}  # shot -> its bar-less RGB frame, drawn once
        self._i420 = {}  # shot -> its bar-less I420 frame

    def _bar(self, i: int) -> int:
        return (i * 2 * BAR) % (self.w - BAR)

    def read_frames(self, rows, out=None):
        if out is None:
            out = np.empty((len(rows), self.h, self.w, 3), np.uint8)
        for k, i in enumerate(rows):
            shot = shot_of(i, self.cuts)
            if shot not in self._rgb:
                frame = np.empty((self.h, self.w, 3), np.uint8)
                frame[:] = COLORS[(self.first + shot) % len(COLORS)]
                self._rgb[shot] = frame
            out[k] = self._rgb[shot]
            x = self._bar(i)
            out[k, :, x:x + BAR] = 255
        return out

    def read_frames_i420(self, rows, out=None):
        h, w = self.h, self.w
        if out is None:
            out = np.empty((len(rows), h * w * 3 // 2), np.uint8)
        for k, i in enumerate(rows):
            shot = shot_of(i, self.cuts)
            if shot not in self._i420:
                frame = np.empty(h * w * 3 // 2, np.uint8)
                yv, uv, vv = rgb_to_i420_limited(
                    COLORS[(self.first + shot) % len(COLORS)])
                frame[:h * w] = yv
                frame[h * w:h * w * 5 // 4] = uv
                frame[h * w * 5 // 4:] = vv
                self._i420[shot] = frame
            out[k] = self._i420[shot]
            x = self._bar(i)
            yp = out[k, :h * w].reshape(h, w)
            up = out[k, h * w:h * w * 5 // 4].reshape(h // 2, w // 2)
            vp = out[k, h * w * 5 // 4:].reshape(h // 2, w // 2)
            yp[:, x:x + BAR] = 235
            up[:, x // 2:(x + BAR) // 2] = 128
            vp[:, x // 2:(x + BAR) // 2] = 128
        return out

    def close(self) -> None:
        pass


def synthetic_stream_class(n: int, h: int, w: int, make_decoder):
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.io.video import VideoMetadata

    class SyntheticVideoStream(st.NamedVideoStream):
        """A NamedVideoStream whose decoder is ``make_decoder()``."""

        def __len__(self) -> int:
            return n

        def video_path(self) -> str:
            return "synthetic"

        def metadata(self) -> VideoMetadata:
            return VideoMetadata("synthetic", n, FPS, w, h)

        def decoder(self):
            return make_decoder()

    return SyntheticVideoStream


def plain_histograms(ingest: str, device: str = "cuda"):
    """[N, 3, 16] histograms of the synthetic frames by the plain
    versions, on the card."""
    import torch

    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.utils.framechunk import FrameChunk

    dec = SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH)
    out = []
    for a in range(0, N_FRAMES, CHUNK):
        rows = list(range(a, min(a + CHUNK, N_FRAMES)))
        if ingest == "rgb":
            chunk = FrameChunk.from_hwc(dec.read_frames(rows)).device(device)
            out.append(H.hist_rgb_plain(chunk.flat, chunk.npix, 3))
        else:
            chunk = FrameChunk.from_i420(dec.read_frames_i420(rows),
                                         HEIGHT, WIDTH).device(device)
            out.append(H.hist_i420_plain(chunk.flat, HEIGHT, WIDTH))
    return torch.cat(out).cpu().numpy()


def run_pipeline(db: str):
    """-> ({ingest: launches of each kernel in that run}, {ingest: its
    histogram rows and frames/s}, for phase 11)."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H

    stream_cls = synthetic_stream_class(
        N_FRAMES, HEIGHT, WIDTH,
        lambda: SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH))
    launches, results = {}, {}
    for ingest in ("rgb", "i420"):
        sc = st.Client(db_path=os.path.join(db, ingest))
        video = stream_cls(sc, "video")
        frame = sc.io.Input([video])
        hist = sc.ops.Histogram(frame=frame)
        bounds = sc.ops.ShotBoundaries(histograms=hist)
        hist_out = st.NamedStream(sc, "hist")
        shots_out = st.NamedStream(sc, "shots")
        out = sc.io.Output([hist, bounds], [(hist_out, shots_out)])
        perf = st.PerfParams.manual(work_packet_size=CHUNK, ingest=ingest)

        H.hist_rgb.launches = 0
        H.hist_i420.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(out, perf, cache_mode=st.CacheMode.Overwrite)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[ingest] = {"hist_rgb": H.hist_rgb.launches,
                            "hist_i420": H.hist_i420.launches}

        cuts = next(shots_out.load(rows=[0]))
        rows = np.stack([np.stack(r) for r in hist_out.load()])
        want = plain_histograms(ingest)
        log({"run": "pipeline", "ingest": ingest, "frames": N_FRAMES,
             "height": HEIGHT, "width": WIDTH, "seconds": seconds,
             "frames_per_s": N_FRAMES / seconds, "boundaries": cuts,
             "launches": launches[ingest],
             "totals_s": sc.profiler.totals()})
        print(sc.summarize(), flush=True)
        if cuts != list(CUTS):
            raise AssertionError(f"{ingest}: boundaries {cuts}, want {CUTS}")
        if rows.shape != (N_FRAMES, 3, 16) or not (rows == want).all():
            raise AssertionError(f"{ingest}: histogram rows differ from the "
                                 "plain version's")
        kernel = "hist_rgb" if ingest == "rgb" else "hist_i420"
        other = "hist_i420" if ingest == "rgb" else "hist_rgb"
        expected = -(-N_FRAMES // CHUNK)
        if launches[ingest][kernel] != expected or launches[ingest][other]:
            raise AssertionError(
                f"{ingest}: launches {launches[ingest]}, want {expected} of "
                f"{kernel} and none of {other}")
        results[ingest] = {"rows": rows, "frames_per_s": N_FRAMES / seconds}
    return launches, results


# ------------------------------------------------------------ phase 3


class TextureDecoder:
    """The decoder interface the executor calls: a smoothed random grey
    texture under a FLOW_W x FLOW_H window, the content moving by
    FLOW_MOTION px per frame (so the true flow between frames i and j is
    (j - i) * FLOW_MOTION). I420 frames carry the grey as luma over grey
    chroma."""

    i420_supported = True
    i420_full_range = False
    i420_bt709 = False

    def __init__(self, n: int, h: int, w: int, seed: int = 0):
        self.n, self.h, self.w = n, h, w
        mx, my = FLOW_MOTION
        # three 7-px box passes (about a Gaussian of sigma 3.5) take 21 px
        noise = np.random.default_rng(seed).random(
            (h + n * abs(my) + 21, w + n * abs(mx) + 21))
        for axis in (0, 1, 0, 1, 0, 1):
            c = np.cumsum(noise, axis=axis)
            noise = (np.take(c, range(7, c.shape[axis]), axis=axis)
                     - np.take(c, range(0, c.shape[axis] - 7), axis=axis))
        lo, hi = noise.min(), noise.max()
        self._tex = ((noise - lo) / (hi - lo) * 255).astype(np.uint8)

    def _gray(self, i: int):
        mx, my = FLOW_MOTION
        y0 = (self.n - i) * my if my > 0 else i * -my
        x0 = (self.n - i) * mx if mx > 0 else i * -mx
        return self._tex[y0:y0 + self.h, x0:x0 + self.w]

    def read_frames(self, rows, out=None):
        if out is None:
            out = np.empty((len(rows), self.h, self.w, 3), np.uint8)
        for k, i in enumerate(rows):
            out[k] = self._gray(i)[..., None]
        return out

    def read_frames_i420(self, rows, out=None):
        h, w = self.h, self.w
        if out is None:
            out = np.empty((len(rows), h * w * 3 // 2), np.uint8)
        for k, i in enumerate(rows):
            out[k, :h * w] = self._gray(i).reshape(-1)
            out[k, h * w:] = 128
        return out

    def close(self) -> None:
        pass


def flow_sampled_rows() -> list:
    return list(range(0, FLOW_FRAMES, FLOW_STRIDE))


def plain_flow_histograms():
    """[rows, 2, 64] FlowHistogram rows of the texture (RGB), chunked as
    the executor chunks them, with every flow_update replaced by its plain
    version, on the card."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.ops import imgproc as IP
    from scannertools_tpu_torch.ops import optical_flow as OF
    from scannertools_tpu_torch.utils.framechunk import FrameChunk

    dec = TextureDecoder(FLOW_FRAMES, FLOW_H, FLOW_W)
    rows = flow_sampled_rows()
    out = []
    OF.flow_update.launches = 0
    with mock.patch.object(OF, "_update_matrices", OF.flow_update_plain):
        for a in range(0, len(rows), FLOW_CHUNK):
            b = min(a + FLOW_CHUNK, len(rows))
            src = [rows[min(p, len(rows) - 1)] for p in range(a, b + 1)]
            chunk = FrameChunk.from_hwc(dec.read_frames(src)).device("cuda")
            flow = OF.optical_flow(None, chunk)
            out.append(IP.flow_histogram(None, flow))
    if OF.flow_update.launches:
        raise AssertionError("the plain flow launched the kernel")
    return torch.cat(out).cpu().numpy()


def flow_stage_ms():
    """One FLOW_CHUNK-pair 640x480 chunk through farneback_pairs, each
    stage bracketed by CUDA events on the compute stream: -> {stage: ms
    summed over its calls, "chunk": ms of the whole call, "kernels_ms":
    the device time of its kernels by torch.profiler}. The flow must equal
    that of an untimed call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.ops import optical_flow as OF

    dec = TextureDecoder(FLOW_FRAMES, FLOW_H, FLOW_W)
    rows = flow_sampled_rows()[:FLOW_CHUNK + 1]
    frames = torch.from_numpy(dec.read_frames(rows)).cuda()
    gray = OF._rgb2gray_u8(frames)[..., 0].to(torch.float32)
    g0, g1 = gray[:-1], gray[1:]
    want = OF.farneback_pairs(g0, g1)  # warm: index maps, taps
    # resize_hw: the pyramid's resizes and the flow's upsample
    stages = {"_sepconv": "pyramid", "resize_hw": "pyramid",
              "_poly_exp": "poly_exp",
              "_update_matrices": "flow_update", "_box_blur": "box_blur",
              "_solve_flow": "solve_flow"}
    marks = []

    def timed(stage, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((stage, start, end))
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name, stage in stages.items():
            stack.enter_context(mock.patch.object(
                OF, name, timed(stage, getattr(OF, name))))
        torch.cuda.synchronize()
        got = timed("chunk", OF.farneback_pairs)(g0, g1)
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("the timed flow differs from the untimed one")
    out = dict.fromkeys(["pyramid", "poly_exp", "flow_update", "box_blur",
                         "solve_flow", "chunk"], 0.0)
    for stage, start, end in marks:
        out[stage] += start.elapsed_time(end)
    # the card's busy time in the chunk: the kernels' own times, traced
    # in a further call (the tracer slows the host, not the kernels)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        OF.farneback_pairs(g0, g1)
        torch.cuda.synchronize()
    # the device-side entries only: an operator's row repeats the device
    # time of the kernels it launched
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out["kernels_ms"] = busy if busy > 0 else "not measured"
    out["pairs"] = FLOW_CHUNK
    return out


def run_flow_pipeline(db: str):
    """-> flow_update launches in graph A's RGB run; every check raises."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import optical_flow as OF

    stream_cls = synthetic_stream_class(
        FLOW_FRAMES, FLOW_H, FLOW_W,
        lambda: TextureDecoder(FLOW_FRAMES, FLOW_H, FLOW_W))
    n = len(flow_sampled_rows())
    chunks = -(-n // FLOW_CHUNK)
    truth = np.array(FLOW_MOTION, np.float32) * FLOW_STRIDE
    runs = [("A", "rgb"), ("A", "i420"), ("B", "rgb")]
    launches = {}
    for graph, ingest in runs:
        sc = st.Client(db_path=os.path.join(db, graph + ingest))
        video = stream_cls(sc, "texture")
        frames = sc.streams.Stride(sc.io.Input([video]), [FLOW_STRIDE])
        flow = sc.ops.OpticalFlow(frames=frames)
        col = flow if graph == "A" else sc.ops.FlowHistogram(flow=flow)
        out = st.NamedStream(sc, "flow" if graph == "A" else "flowhist")
        perf = st.PerfParams.manual(work_packet_size=FLOW_CHUNK,
                                    ingest=ingest)

        OF.flow_update.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(col, [out]), perf,
               cache_mode=st.CacheMode.Overwrite)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[graph + ingest] = OF.flow_update.launches
        result = {"run": "flow_pipeline", "graph": graph, "ingest": ingest,
                  "rows": n, "height": FLOW_H, "width": FLOW_W,
                  "seconds": seconds, "rows_per_s": n / seconds,
                  "launches": {"flow_update": OF.flow_update.launches},
                  "totals_s": sc.profiler.totals()}
        if OF.flow_update.launches != chunks * FLOW_LAUNCHES_PER_CHUNK:
            raise AssertionError(
                f"flow {graph} {ingest}: {OF.flow_update.launches} launches "
                f"of flow_update, want {chunks} x {FLOW_LAUNCHES_PER_CHUNK}")
        if graph == "A":
            stored = sum(len(b) for b in out.load_bytes(range(n)))
            flows = np.stack(list(out.load()))
            inner = flows[:-1, 32:-32, 32:-32]
            err = float(np.median(np.linalg.norm(inner - truth, axis=-1)))
            result.update(stored_bytes=stored, median_err_px=err,
                          last_row_max=float(np.abs(flows[-1]).max()))
            log(result)
            want_bytes = n * (8 + FLOW_H * FLOW_W * 2 * 2)  # float16
            if stored != want_bytes:
                raise AssertionError(f"flow {ingest}: {stored} bytes "
                                     f"stored, want {want_bytes}")
            if flows.shape != (n, FLOW_H, FLOW_W, 2) or \
                    flows.dtype != np.float32 or \
                    not np.isfinite(flows).all():
                raise AssertionError(f"flow {ingest}: {flows.shape} "
                                     f"{flows.dtype} rows")
            if not err < 0.15:
                raise AssertionError(f"flow {ingest}: median error {err} "
                                     f"px against {truth.tolist()}")
        else:
            rows = np.stack(list(out.load()))
            want = plain_flow_histograms()
            result["rows_equal_plain"] = bool(
                rows.shape == want.shape and (rows == want).all())
            log(result)
            if not result["rows_equal_plain"]:
                raise AssertionError("FlowHistogram rows differ from the "
                                     "plain versions'")
        print(sc.summarize(), flush=True)
    log({"flow_stages_ms": flow_stage_ms(), "shape": [FLOW_CHUNK, FLOW_H,
                                                      FLOW_W]})
    return launches["Argb"]


# ------------------------------------------------------------ phase 4


class FaceDecoder:
    """The decoder interface the executor calls: a seeded smoothed colour
    texture with bright elliptic blobs (skin-toned, 40-110 px) drifting
    across it, FACE_W x FACE_H RGB, drawn once per process (the executor
    opens a decoder per run)."""

    i420_supported = False
    _drawn = {}  # (n, h, w, seed) -> [n, h, w, 3] uint8

    def __init__(self, n: int, h: int, w: int, seed: int = 4):
        key = (n, h, w, seed)
        if key not in self._drawn:
            self._drawn[key] = self._draw(n, h, w, seed)
        self._frames = self._drawn[key]

    @staticmethod
    def _draw(n: int, h: int, w: int, seed: int):
        rng = np.random.default_rng(seed)
        noise = rng.random((h + 21, w + 21, 3))
        for axis in (0, 1, 0, 1, 0, 1):  # three 7-px box passes
            c = np.cumsum(noise, axis=axis)
            noise = (np.take(c, range(7, c.shape[axis]), axis=axis)
                     - np.take(c, range(0, c.shape[axis] - 7), axis=axis))
        lo, hi = noise.min(), noise.max()
        tex = ((noise - lo) / (hi - lo) * 120 + 30).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        blobs = [(rng.uniform(60, h - 60), rng.uniform(60, w - 60),
                  rng.uniform(-3, 3), rng.uniform(-4, 4),
                  rng.uniform(20, 45), rng.uniform(16, 36),
                  rng.uniform(170, 250, 3)) for _ in range(5)]
        frames = np.empty((n, h, w, 3), np.uint8)
        for i in range(n):
            f = tex.copy()
            for cy, cx, vy, vx, ry, rx, colour in blobs:
                d = ((yy - cy - vy * i) / ry) ** 2 + ((xx - cx - vx * i)
                                                      / rx) ** 2
                a = np.exp(-2.0 * d)[..., None]
                f = f * (1 - a) + colour * a
            frames[i] = np.clip(f, 0, 255)
        return frames

    def read_frames(self, rows, out=None):
        if out is None:
            out = np.empty((len(rows), *self._frames.shape[1:]), np.uint8)
        out[:] = self._frames[list(rows)]
        return out

    def close(self) -> None:
        pass


FACE_GRAPHS = ("faces", "embs", "genders", "embs_padded")
# launches of each kernel per chunk in each graph: 4 nms (the five pyramid
# scales' calls at 640x480 in one, then the cross-scale, R-Net and O-Net
# calls) and 2 crops (R-Net, O-Net) in every MTCNN forward, one crop per
# crop net
FACE_LAUNCHES_PER_CHUNK = {
    "faces": {"nms": 4, "crop_and_resize": 2},
    "embs": {"nms": 4, "crop_and_resize": 3},
    "genders": {"nms": 4, "crop_and_resize": 3},
    "embs_padded": {"nms": 0, "crop_and_resize": 1},
}


def write_face_weights(d: str) -> dict:
    """The port's seeded weights of the three nets, written by the port's
    save_params in the JAX package's layout -> {model: npz path}."""
    from scannertools_tpu_torch.models import facenet, gender, mtcnn, weights

    paths = {}
    for name, lib in (("mtcnn", mtcnn), ("facenet", facenet),
                      ("gender", gender)):
        paths[name] = os.path.join(d, f"{name}.npz")
        weights.save_params(paths[name], lib.to_flax(lib.init_params(0)))
    return paths


def face_graph(sc, stream, name: str, weights: dict, faces_stream=None):
    """The output column of face graph ``name`` over ``stream``'s frames."""
    from scannertools_tpu_torch.ops.faces import MAX_FACES

    frame = sc.io.Input([stream])
    if name == "embs_padded":  # boxes read back from a stream
        return sc.ops.EmbedFaces(frame=frame,
                                 bboxes=sc.io.Input([faces_stream]),
                                 weights_path=weights["facenet"],
                                 faces_budget=MAX_FACES)
    faces = sc.ops.MTCNNDetectFaces(frame=frame,
                                    weights_path=weights["mtcnn"],
                                    thresholds=FACE_THRESHOLDS)
    if name == "faces":
        return faces
    if name == "embs":
        return sc.ops.EmbedFaces(frame=frame, bboxes=faces,
                                 weights_path=weights["facenet"],
                                 faces_budget=MAX_FACES)
    return sc.ops.DetectGender(frame=frame, bboxes=faces,
                               weights_path=weights["gender"],
                               faces_budget=MAX_FACES)


def run_face_graphs(db: str, weights: dict, device: str = "cuda"):
    """The four face graphs in turn through Client.run, as
    tests/test_nn_pipeline.py runs them -> ({graph: loaded rows},
    {graph: launches}, {graph: result line})."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC

    stream_cls = synthetic_stream_class(
        FACE_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(FACE_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=db, device=device)
    video = stream_cls(sc, "faces_video")
    rows, launches, results = {}, {}, {}
    for name in FACE_GRAPHS:
        out = st.NamedStream(sc, name)
        col = face_graph(sc, video, name, weights, faces_stream=(
            st.NamedStream(sc, "faces") if name == "embs_padded" else None))
        perf = st.PerfParams.manual(work_packet_size=FACE_CHUNK,
                                    ingest="rgb")
        MC.nms.launches = MC.crop_and_resize.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(col, [out]), perf,
               cache_mode=st.CacheMode.Overwrite)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = {"nms": MC.nms.launches,
                          "crop_and_resize": MC.crop_and_resize.launches}
        rows[name] = list(out.load())
        results[name] = {"run": "face_pipeline", "graph": name,
                         "frames": FACE_FRAMES, "height": FACE_H,
                         "width": FACE_W, "seconds": seconds,
                         "frames_per_s": FACE_FRAMES / seconds,
                         "launches": launches[name],
                         "totals_s": sc.profiler.totals()}
    return rows, launches, results


def plain_face_graphs(db: str, weights: dict):
    """The same graphs on the card with nms and crop_and_resize replaced by
    their plain versions -> {graph: loaded rows}."""
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import mtcnn as PM
    from scannertools_tpu_torch.ops import faces as PFO

    with mock.patch.object(PM, "nms", MC.nms_plain), \
            mock.patch.object(PM, "crop_and_resize",
                              MC.crop_and_resize_plain), \
            mock.patch.object(PFO, "crop_and_resize",
                              MC.crop_and_resize_plain):
        rows, launches, _ = run_face_graphs(db, weights)
    if any(n for lc in launches.values() for n in lc.values()):
        raise AssertionError(f"the plain face graphs launched kernels: "
                             f"{launches}")
    return rows


def face_embedding_checks(faces, embs) -> dict:
    """Unit norm within 1e-5 for each face whose truncated pixel box is not
    empty, the zero vector for the others (face_embedding.py:70)."""
    worst, zeros = 0.0, 0
    for fl, el in zip(faces, embs):
        if el.shape != (len(fl), 128) or el.dtype != np.float32:
            raise AssertionError(f"embeddings {el.shape} {el.dtype} for "
                                 f"{len(fl)} faces")
        for b, e in zip(fl, el):
            x1, y1, x2, y2 = (np.trunc(np.float32(v) * np.float32(s))
                              for v, s in ((b.x1, FACE_W), (b.y1, FACE_H),
                                           (b.x2, FACE_W), (b.y2, FACE_H)))
            if x2 > x1 and y2 > y1:
                worst = max(worst, abs(float(np.linalg.norm(e)) - 1.0))
            elif e.any():
                raise AssertionError("a degenerate crop's embedding is not "
                                     "the zero vector")
            else:
                zeros += 1
    if not worst < 1e-5:
        raise AssertionError(f"embedding norms off 1 by {worst}")
    return {"max_norm_err": worst, "zero_rows": zeros}


def card_vs_cpu() -> dict:
    """FaceNet embeddings and gender logits of fixed seeded crops with the
    port's seeded weights, on the card and on the CPU: no discrete decision
    intervenes, so this is the nets' float32 agreement (TF32 in cuDNN would
    show as about 1e-3)."""
    import torch

    from scannertools_tpu_torch.models import facenet, gender

    rng = np.random.default_rng(6)
    out = {}
    for name, lib, size, fn in (("facenet", facenet, 160, facenet.embed),
                                ("gender", gender, gender.INPUT_SIZE,
                                 gender.logits)):
        state = lib.init_params(0)
        crops = torch.from_numpy(rng.uniform(0, 255, (8, size, size, 3))
                                 .astype(np.float32))
        cpu = fn(state, crops)
        card = fn({k: v.cuda() for k, v in state.items()},
                  crops.cuda()).cpu()
        err = float((card - cpu).abs().max())
        scale = float(cpu.abs().max())
        out[name] = {"max_abs_diff": err, "max_abs": scale}
        if not err <= CARD_CPU_RTOL * scale:
            raise AssertionError(f"{name}: card and CPU differ by {err} "
                                 f"(largest value {scale})")
    return out


def face_stage_ms(weights: dict) -> dict:
    """One FACE_CHUNK-frame chunk through the three forwards on the card,
    each stage bracketed by CUDA events on the compute stream -> {stage: ms
    summed over its calls}, the forwards' own ms, and the kernels' device
    time by torch.profiler in a further call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.models import facenet as PF
    from scannertools_tpu_torch.models import gender as PG
    from scannertools_tpu_torch.models import mtcnn as PM
    from scannertools_tpu_torch.ops import faces as PFO

    frames = torch.from_numpy(FaceDecoder(FACE_FRAMES, FACE_H, FACE_W)
                              .read_frames(range(FACE_CHUNK))).cuda()
    aux = {m: PFO._get_params(m, weights[m]) for m in weights}
    aux = {"mtcnn": {n: {k: v.cuda() for k, v in sd.items()}
                     for n, sd in aux["mtcnn"].items()},
           "facenet": {k: v.cuda() for k, v in aux["facenet"].items()},
           "gender": {k: v.cuda() for k, v in aux["gender"].items()}}
    budget = PFO.MAX_FACES

    def forwards():
        nb, sc_, v = PFO.mtcnn_forward(None, aux["mtcnn"], frames,
                                       thresholds=FACE_THRESHOLDS)
        PFO.face_embed_forward(None, aux["facenet"], frames, nb, v,
                               faces_budget=budget)
        PFO.gender_forward(None, aux["gender"], frames, nb, v,
                           faces_budget=budget)

    forwards()  # warm: index maps, taps, cuDNN plans
    marks = []
    calls = {"nms": 0, "crop": 0}
    nms_names = ["nms_scales", "nms_cross_scale", "nms_rnet", "nms_onet"]

    def timed(stage, fn):
        def run(*args, **kw):
            name = stage(args) if callable(stage) else stage
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((name, start, end))
            return out
        return run

    def nms_stage(args):
        calls["nms"] += 1
        return nms_names[(calls["nms"] - 1) % len(nms_names)]

    def crop_stage(args):
        return {24: "crop_rnet", 48: "crop_onet", 160: "crop_facenet",
                227: "crop_gender"}[args[2][0]]

    def net_stage(args):
        return {PM.PNet: "pnet", PM.RNet: "rnet", PM.ONet: "onet"}[args[0]]

    patches = [(PM, "resize_hw", "pyramid"), (PM, "nms", nms_stage),
               (PM, "crop_and_resize", crop_stage),
               (PFO, "crop_and_resize", crop_stage),
               (PM, "apply_net", net_stage), (PF, "embed", "facenet"),
               (PG, "classify", "gender"),
               (PFO, "mtcnn_forward", "mtcnn_forward"),
               (PFO, "face_embed_forward", "face_embed_forward"),
               (PFO, "gender_forward", "gender_forward")]
    with contextlib.ExitStack() as stack:
        for mod, name, stage in patches:
            stack.enter_context(mock.patch.object(
                mod, name, timed(stage, getattr(mod, name))))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forwards()
        end.record()
        torch.cuda.synchronize()
    out = {"chunk": start.elapsed_time(end)}
    for stage, s, e in marks:
        out[stage] = out.get(stage, 0.0) + s.elapsed_time(e)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        forwards()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out["kernels_ms"] = busy if busy > 0 else "not measured"
    out["frames"] = FACE_CHUNK
    return out


def run_face_pipeline(db: str):
    """Phase 4 -> {kernel: launches over the four graphs}; every check
    raises."""
    weights = write_face_weights(db)
    rows, launches, results = run_face_graphs(os.path.join(db, "faces"),
                                              weights)
    plain = plain_face_graphs(os.path.join(db, "faces_plain"), weights)
    chunks = -(-FACE_FRAMES // FACE_CHUNK)
    for name in FACE_GRAPHS:
        want = {k: n * chunks
                for k, n in FACE_LAUNCHES_PER_CHUNK[name].items()}
        results[name]["rows_equal_plain"] = _face_rows_equal(
            name, rows[name], plain[name])
        log(results[name])
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]}, want "
                                 f"{want}")
        if not results[name]["rows_equal_plain"]:
            raise AssertionError(f"{name}: rows differ from the plain "
                                 "kernels' run")
    faces = rows["faces"]
    with_faces = sum(1 for f in faces if f)
    counts = [len(f) for f in faces]
    if len(faces) != FACE_FRAMES or with_faces <= FACE_FRAMES // 2:
        raise AssertionError(f"faces in {with_faces} of {len(faces)} frames")
    if any(len(g) != n for g, n in zip(rows["genders"], counts)) or any(
            x not in ("M", "F") for g in rows["genders"] for x in g):
        raise AssertionError("gender lists do not match the faces")
    norms = face_embedding_checks(faces, rows["embs"])
    padded = max(float(np.abs(a - b).max()) if a.size else 0.0
                 for a, b in zip(rows["embs_padded"], rows["embs"]))
    if not padded <= 1e-5:
        raise AssertionError(f"BboxesToPadded embeddings differ from the "
                             f"rewired ones by {padded}")
    log({"faces_per_frame": counts, "frames_with_faces": with_faces,
         **norms, "padded_vs_rewired_max_abs": padded,
         "card_vs_cpu": card_vs_cpu()})
    log({"face_stages_ms": face_stage_ms(weights),
         "shape": [FACE_CHUNK, FACE_H, FACE_W]})
    return {k: sum(launches[g][k] for g in FACE_GRAPHS)
            for k in ("nms", "crop_and_resize")}


def _face_rows_equal(name: str, got, want) -> bool:
    if len(got) != len(want):
        return False
    if name in ("embs", "embs_padded"):
        return all(a.shape == b.shape and np.array_equal(a, b)
                   for a, b in zip(got, want))
    return got == want


# ------------------------------------------------------------ phase 5


DET_GRAPHS = ("objects", "frcnn")
# launches of each kernel per chunk: SSD one nms for the chunk's frames;
# Faster R-CNN one nms (the proposals) and one crop (the RoIAlign)
DET_LAUNCHES_PER_CHUNK = {
    "objects": {"nms": 1, "crop_and_resize": 0},
    "frcnn": {"nms": 1, "crop_and_resize": 1},
}


def write_detection_weights(d: str) -> dict:
    """The port's seeded weights of SSD and Faster R-CNN, written by the
    port's save_params in the JAX package's layout -> {model: npz path}."""
    from scannertools_tpu_torch.models import faster_rcnn, ssd, weights

    paths = {}
    for name, lib in (("ssd", ssd), ("faster_rcnn", faster_rcnn)):
        paths[name] = os.path.join(d, f"{name}.npz")
        weights.save_params(paths[name], lib.to_flax(lib.init_params(0)))
    return paths


def detection_graph(sc, stream, name: str, weights: dict):
    """The output columns and stream names of detection graph ``name``."""
    frame = sc.io.Input([stream])
    if name == "objects":
        return [sc.ops.DetectObjects(frame=frame,
                                     weights_path=weights["ssd"])], \
            ["objects"]
    pre = sc.ops.NNInput(frame=frame, input_width=FRCNN_W,
                         input_height=FRCNN_H, mean_colors=FRCNN_MEAN)
    cls_prob, rois, fc7 = sc.ops.FasterRCNN(
        input=pre, weights_path=weights["faster_rcnn"])
    boxes, feats = sc.ops.FasterRCNNOutput(
        cls_prob=cls_prob, rois=rois, fc7=fc7, score_threshold=FRCNN_SCORE)
    return [boxes, feats], ["frcnn_boxes", "frcnn_feats"]


def run_detection_graphs(db: str, weights: dict, device: str = "cuda",
                         runs: int = 1):
    """The two detection graphs in turn through Client.run, each ``runs``
    times in a row -> ({graph: [loaded rows of each output]}, {graph:
    [launches of each run]}, {graph: result}). The first run of a graph
    reads and converts its npz; a later one finds the weights cached, so
    its frames/s is the warm rate."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC

    stream_cls = synthetic_stream_class(
        DET_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(DET_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=db, device=device)
    video = stream_cls(sc, "det_video")
    rows, launches, results = {}, {}, {}
    for name in DET_GRAPHS:
        cols, names = detection_graph(sc, video, name, weights)
        outs = [st.NamedStream(sc, n) for n in names]
        perf = st.PerfParams.manual(work_packet_size=DET_CHUNK, ingest="rgb")
        launches[name], per_run = [], []
        for _ in range(runs):
            before = sc.profiler.totals()
            MC.nms.launches = MC.crop_and_resize.launches = 0
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.run(sc.io.Output(cols, [tuple(outs)]), perf,
                   cache_mode=st.CacheMode.Overwrite)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name].append(
                {"nms": MC.nms.launches,
                 "crop_and_resize": MC.crop_and_resize.launches})
            per_run.append({
                "seconds": seconds, "frames_per_s": DET_FRAMES / seconds,
                "totals_s": {k: v - before.get(k, 0.0)
                             for k, v in sc.profiler.totals().items()}})
        rows[name] = [list(o.load()) for o in outs]
        results[name] = {"run": "detection_pipeline", "graph": name,
                         "frames": DET_FRAMES, "height": FACE_H,
                         "width": FACE_W, "launches": launches[name],
                         "runs": per_run}
    return rows, launches, results


def plain_detection_graphs(db: str, weights: dict):
    """The same graphs on the card with nms and crop_and_resize replaced by
    their plain versions -> {graph: rows}."""
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import faster_rcnn as PR
    from scannertools_tpu_torch.models import ssd as PS

    with mock.patch.object(PS, "nms", MC.nms_plain), \
            mock.patch.object(PR, "nms", MC.nms_plain), \
            mock.patch.object(PR, "crop_and_resize",
                              MC.crop_and_resize_plain):
        rows, launches, _ = run_detection_graphs(db, weights)
    if any(n for runs in launches.values() for lc in runs
           for n in lc.values()):
        raise AssertionError(f"the plain detection graphs launched kernels: "
                             f"{launches}")
    return rows


def _detection_rows_equal(got, want) -> bool:
    """Box lists equal, and feature arrays equal in shape and bytes."""
    def same(a, b):
        if isinstance(a, np.ndarray):
            return a.shape == np.shape(b) and np.array_equal(a, b)
        return a == b
    return len(got) == len(want) and all(
        len(g) == len(w) and all(same(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def detection_card_vs_cpu() -> dict:
    """SSD's outputs on seeded 300x300 inputs, and Faster R-CNN's conv5_3
    map, RPN logits (a 224x224 input) and head probabilities (seeded
    pooled RoIs), with the port's seeded weights on the card and on the
    CPU: no discrete decision intervenes."""
    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import faster_rcnn as PR
    from scannertools_tpu_torch.models import ssd as PS

    rng = np.random.default_rng(7)
    x_ssd = torch.from_numpy(rng.uniform(-1, 1, (2, 300, 300, 3)).astype(
        np.float32))
    x_vgg = torch.from_numpy(rng.uniform(-120, 130, (1, 3, 224, 224))
                             .astype(np.float32))
    pooled = torch.from_numpy(rng.standard_normal(
        (16, PR.POOL * PR.POOL * PR.FEAT)).astype(np.float32))

    def frcnn_parts(net, x, p):
        feat = net.vgg(x)
        rpn = torch.relu(net.rpn_conv(feat))
        head = torch.relu(net.fc7(torch.relu(net.fc6(p))))
        return (feat, net.rpn_cls_score(rpn), net.rpn_bbox_pred(rpn),
                torch.softmax(net.cls_score(head), dim=-1))

    ssd_state = PS.init_params(0)
    net = PR.FasterRCNN()
    net.load_state_dict(PR.init_params(0))
    with torch.no_grad(), MC.full_f32():
        cpu = {"ssd": MC.apply_net(PS.SSDMobileNetV1, ssd_state, x_ssd),
               "faster_rcnn": frcnn_parts(net, x_vgg, pooled)}
        card = {"ssd": MC.apply_net(
                    PS.SSDMobileNetV1,
                    {k: v.cuda() for k, v in ssd_state.items()},
                    x_ssd.cuda()),
                "faster_rcnn": frcnn_parts(net.cuda(), x_vgg.cuda(),
                                           pooled.cuda())}
    out = {}
    for name in cpu:
        for i, (c, g) in enumerate(zip(cpu[name], card[name])):
            err = float((g.cpu() - c).abs().max())
            scale = float(c.abs().max())
            out[f"{name}_{i}"] = {"max_abs_diff": err, "max_abs": scale}
            if not err <= CARD_CPU_RTOL * scale:
                raise AssertionError(f"{name} output {i}: card and CPU "
                                     f"differ by {err} (largest {scale})")
    return out


def detection_stage_ms(weights: dict) -> dict:
    """One DET_CHUNK-frame chunk through both forwards on the card, each
    stage bracketed by CUDA events on the compute stream -> {stage: ms
    summed over its calls}, the host decode's ms, and the kernels' device
    time by torch.profiler in a further call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.models import faster_rcnn as PR
    from scannertools_tpu_torch.models import ssd as PS
    from scannertools_tpu_torch.ops import detection_decode as PD
    from scannertools_tpu_torch.ops import faces as PFO
    from scannertools_tpu_torch.ops import nn_generic as PN
    from scannertools_tpu_torch.ops import objects as PO

    frames = torch.from_numpy(FaceDecoder(DET_FRAMES, FACE_H, FACE_W)
                              .read_frames(range(DET_CHUNK))).cuda()
    ssd_state = {k: v.cuda() for k, v in PFO._get_params(
        "ssd", weights["ssd"]).items()}
    frcnn_state = {k: v.cuda() for k, v in PFO._get_params(
        "faster_rcnn", weights["faster_rcnn"]).items()}
    arrays = {}

    def forwards():
        PO.ssd_forward(None, ssd_state, frames)
        x = PN.nn_input(None, frames, FRCNN_W, FRCNN_H, FRCNN_MEAN)
        arrays["frcnn"] = PN.faster_rcnn_forward(None, frcnn_state, x)

    forwards()  # warm: index maps, taps, cuDNN plans
    marks = []

    def timed(stage, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((stage, start, end))
            return out
        return run

    patches = [(PS, "resize_hw", "ssd_resize"),
               (PS, "apply_net", "ssd_net"),
               (PS, "_prefilter", "ssd_prefilter"),
               (PS, "nms", "ssd_nms"),
               (PO, "ssd_forward", "ssd_forward"),
               (PN, "nn_input", "frcnn_nn_input"),
               (PR.VGG16, "forward", "frcnn_vgg16"),
               (PR, "propose_boxes", "frcnn_proposals"),
               (PR, "topk_stable", "frcnn_topk"),
               (PR, "nms", "frcnn_nms"),
               (PR, "crop_and_resize", "frcnn_roi_align"),
               (PN, "faster_rcnn_forward", "frcnn_forward")]
    with contextlib.ExitStack() as stack:
        for obj, name, stage in patches:
            stack.enter_context(mock.patch.object(
                obj, name, timed(stage, getattr(obj, name))))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forwards()
        end.record()
        torch.cuda.synchronize()
    out = {"chunk": start.elapsed_time(end)}
    for stage, s, e in marks:
        out[stage] = out.get(stage, 0.0) + s.elapsed_time(e)
    host = [a.cpu().numpy() for a in arrays["frcnn"]]
    t0 = time.perf_counter()
    PD.faster_rcnn_output(None, *host, score_threshold=FRCNN_SCORE)
    out["frcnn_decode_host"] = (time.perf_counter() - t0) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        forwards()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out["kernels_ms"] = busy if busy > 0 else "not measured"
    out["frames"] = DET_CHUNK
    return out


def run_detection_pipeline(db: str):
    """Phase 5 -> {kernel: launches over the two graphs}; every check
    raises."""
    weights = write_detection_weights(db)
    # twice: the first run's frames/s holds the npz read, the second's not
    rows, launches, results = run_detection_graphs(
        os.path.join(db, "det"), weights, runs=2)
    plain = plain_detection_graphs(os.path.join(db, "det_plain"), weights)
    chunks = -(-DET_FRAMES // DET_CHUNK)
    for name in DET_GRAPHS:
        want = {k: n * chunks
                for k, n in DET_LAUNCHES_PER_CHUNK[name].items()}
        results[name]["rows_equal_plain"] = all(
            _detection_rows_equal(g, w)
            for g, w in zip(rows[name], plain[name]))
        log(results[name])
        if any(lc != want for lc in launches[name]):
            raise AssertionError(f"{name}: launches {launches[name]}, want "
                                 f"{want} each run")
        if not results[name]["rows_equal_plain"]:
            raise AssertionError(f"{name}: rows differ from the plain "
                                 "kernels' run")
    (objects,) = rows["objects"]
    if len(objects) != DET_FRAMES or any(
            len(f) != 100 or not all(1 <= b.label <= 90 for b in f)
            for f in objects):
        raise AssertionError("DetectObjects: not 100 rows of labels 1..90 "
                             "in every frame")
    boxes, feats = rows["frcnn"]
    counts = [len(f) for f in boxes]
    with_boxes = sum(1 for n in counts if n)
    if len(boxes) != DET_FRAMES or with_boxes <= DET_FRAMES // 2:
        raise AssertionError(f"Faster R-CNN boxes in {with_boxes} of "
                             f"{len(boxes)} frames")
    for bl, fl in zip(boxes, feats):
        fl = np.asarray(fl)
        if fl.shape != (len(bl), 4096) or not all(
                1 <= b.label <= 80 and b.score > FRCNN_SCORE for b in bl):
            raise AssertionError("Faster R-CNN boxes and features disagree")
    log({"frcnn_boxes_per_frame": counts, "frames_with_boxes": with_boxes,
         "card_vs_cpu": detection_card_vs_cpu()})
    log({"detection_stages_ms": detection_stage_ms(weights),
         "shape": [DET_CHUNK, FACE_H, FACE_W],
         "frcnn_input": [FRCNN_H, FRCNN_W]})
    # the main path's count: each graph's first run
    return {k: sum(launches[g][0][k] for g in DET_GRAPHS)
            for k in ("nms", "crop_and_resize")}


# ------------------------------------------------------------ phase 6


def maskrcnn_state(arch: str) -> dict:
    """The port's seeded Mask R-CNN weights with MRCNN_HEAD_SCALES."""
    from scannertools_tpu_torch.models import maskrcnn as PM

    state = PM.init_params(0, arch)
    for key, scale in MRCNN_HEAD_SCALES:
        state[key + ".weight"] = state[key + ".weight"] * scale
    return state


def write_maskrcnn_weights(d: str) -> str:
    """maskrcnn_state of R-50-FPN, written by the port's save_params in the
    JAX package's layout (164 MB) -> the npz path."""
    from scannertools_tpu_torch.models import maskrcnn as PM
    from scannertools_tpu_torch.models import weights

    path = os.path.join(d, "maskrcnn.npz")
    weights.save_params(path, PM.to_flax(maskrcnn_state(MRCNN_ARCH),
                                         MRCNN_ARCH))
    return path


def _mrcnn_launches() -> dict:
    from scannertools_tpu_torch.models import common as MC

    return {"nms": MC.nms.launches,
            "crop_and_resize": MC.crop_and_resize.launches,
            "crop_and_resize_levels": MC.crop_and_resize_levels.launches}


def run_maskrcnn_graph(db: str, weights_path, arch: str = MRCNN_ARCH,
                       frames: int = DET_FRAMES, runs: int = 1,
                       device: str = "cuda"):
    """MaskRCNNDetectObjects over the first ``frames`` of the detection
    phase's video through Client.run, ``runs`` times in a row -> (the
    loaded rows, [launches of each run], [each run's seconds, frames/s and
    span totals]). The first run reads and converts the npz; a later one
    finds the weights cached, so its frames/s is the warm rate."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC

    stream_cls = synthetic_stream_class(
        DET_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(DET_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=db, device=device)
    frame = sc.io.Input([stream_cls(sc, "mrcnn_video")])
    if frames < DET_FRAMES:
        frame = sc.streams.Gather(frame, [list(range(frames))])
    dets = sc.ops.MaskRCNNDetectObjects(
        frame=frame, weights_path=weights_path, arch=arch,
        confidence_threshold=MRCNN_CONFIDENCE)
    out = st.NamedStream(sc, "mrcnn")
    perf = st.PerfParams.manual(work_packet_size=DET_CHUNK, ingest="rgb")
    launches, per_run = [], []
    for _ in range(runs):
        before = sc.profiler.totals()
        MC.nms.launches = MC.crop_and_resize.launches = 0
        MC.crop_and_resize_levels.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(dets, [out]), perf,
               cache_mode=st.CacheMode.Overwrite)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches.append(_mrcnn_launches())
        per_run.append({
            "seconds": seconds, "frames_per_s": frames / seconds,
            "totals_s": {k: v - before.get(k, 0.0)
                         for k, v in sc.profiler.totals().items()}})
    return list(out.load()), launches, per_run


def plain_maskrcnn_graph(db: str, weights_path, **kw):
    """run_maskrcnn_graph on the card with nms and the level crop replaced
    by their plain versions -> the loaded rows."""
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import maskrcnn as PM

    with mock.patch.object(PM, "nms", MC.nms_plain), \
            mock.patch.object(PM, "crop_and_resize_levels",
                              MC.crop_and_resize_levels_plain):
        rows, launches, _ = run_maskrcnn_graph(db, weights_path, **kw)
    if any(n for lc in launches for n in lc.values()):
        raise AssertionError(f"the plain Mask R-CNN graph launched kernels: "
                             f"{launches}")
    return rows


def _maskrcnn_rows_equal(got, want) -> bool:
    """The same detections: boxes (with scores and labels) equal, mask
    canvases equal in shape and bytes."""
    return len(got) == len(want) and all(
        len(g) == len(w) and all(
            a["bbox"] == b["bbox"] and a["mask"].shape == b["mask"].shape
            and np.array_equal(a["mask"], b["mask"]) for a, b in zip(g, w))
        for g, w in zip(got, want))


def maskrcnn_card_vs_cpu() -> dict:
    """The R-50-FPN trunk (P2..P6 and the RPN's logits and deltas of each
    level) on one frame at a MRCNN_CPU_MIN_SIZE letterbox, the box head on
    seeded 7x7 crops and the mask head on seeded 14x14 crops, with
    maskrcnn_state's weights on the card and on the CPU: no discrete
    decision intervenes."""
    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import maskrcnn as PM

    frame = torch.from_numpy(FaceDecoder(DET_FRAMES, FACE_H, FACE_W)
                             .read_frames([0])).to(torch.float32)
    images, _ = PM.preprocess(frame, MRCNN_CPU_MIN_SIZE, PM.MAX_SIZE)
    rng = np.random.default_rng(10)
    roi7 = torch.from_numpy(rng.normal(0, 100, (16, 7, 7, 256)).astype(
        np.float32))
    roi14 = torch.from_numpy(rng.normal(0, 100, (16, 14, 14, 256)).astype(
        np.float32))

    def parts(net, x, r7, r14):
        fpn = net.backbone(x.permute(0, 3, 1, 2))
        rpn = [t for f in fpn for t in net.rpn(f)]
        return [*fpn, *rpn, *net.box(r7), net.mask(r14)]

    net = PM.MaskRCNN(MRCNN_ARCH)
    net.load_state_dict(maskrcnn_state(MRCNN_ARCH))
    with torch.no_grad(), MC.full_f32():
        cpu = parts(net, images, roi7, roi14)
        card = parts(net.cuda(), images.cuda(), roi7.cuda(), roi14.cuda())
    worst = {"max_abs_diff": 0.0, "max_abs": 0.0, "rel": 0.0}
    for i, (c, g) in enumerate(zip(cpu, card)):
        err = float((g.cpu() - c).abs().max())
        scale = float(c.abs().max())
        if not err <= CARD_CPU_RTOL * scale:
            raise AssertionError(f"Mask R-CNN part {i}: card and CPU differ "
                                 f"by {err} (largest {scale})")
        if err / scale >= worst["rel"]:
            worst = {"max_abs_diff": err, "max_abs": scale,
                     "rel": err / scale, "part": i}
    return {"canvas": list(images.shape[1:3]), "parts": len(cpu), **worst}


def maskrcnn_stage_ms(weights_path: str) -> dict:
    """One DET_CHUNK-frame chunk through MaskRCNNForward on the card, each
    stage bracketed by CUDA events on the compute stream -> {stage: ms
    summed over its calls}, the host decode's ms, and the kernels' device
    time by torch.profiler in a further call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.models import maskrcnn as PM
    from scannertools_tpu_torch.ops import faces as PFO
    from scannertools_tpu_torch.ops import objects as PO

    frames = torch.from_numpy(FaceDecoder(DET_FRAMES, FACE_H, FACE_W)
                              .read_frames(range(DET_CHUNK))).cuda()
    state = {k: v.cuda() for k, v in PFO._get_params(
        "maskrcnn", weights_path, MRCNN_ARCH).items()}
    arrays = {}

    def forward():
        arrays["out"] = PO.maskrcnn_forward(None, state, frames)

    forward()  # warm: anchors, index maps, cuDNN plans
    marks = []
    calls = {"topk": 0, "nms": 0}

    def timed(stage, fn):
        def run(*args, **kw):
            name = stage(args) if callable(stage) else stage
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((name, start, end))
            return out
        return run

    def topk_stage(args):  # five levels, then across them
        calls["topk"] += 1
        return "topk_levels" if calls["topk"] % 6 else "topk_cross"

    def nms_stage(args):
        calls["nms"] += 1
        return "nms_proposals" if calls["nms"] % 2 else "nms_final"

    def crop_stage(args):
        return {7: "roi_align_7", 14: "mask_crop_14"}[args[4][0]]

    patches = [(PM, "preprocess", "preprocess"),
               (PM.BackboneFPN, "body", "backbone"),
               (PM.BackboneFPN, "fpn", "fpn"),
               (PM.RPNHead, "forward", "rpn_head"),
               (PM, "propose", "proposals"),
               (PM, "topk_stable", topk_stage), (PM, "nms", nms_stage),
               (PM, "crop_and_resize_levels", crop_stage),
               (PM.BoxHead, "forward", "box_head"),
               (PM, "select_detections", "select_detections"),
               (PM.MaskHead, "forward", "mask_head"),
               (PO, "maskrcnn_forward", "forward")]
    with contextlib.ExitStack() as stack:
        for obj, name, stage in patches:
            stack.enter_context(mock.patch.object(
                obj, name, timed(stage, getattr(obj, name))))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
    out = {"chunk": start.elapsed_time(end)}
    for stage, s, e in marks:
        out[stage] = out.get(stage, 0.0) + s.elapsed_time(e)
    out["topk_share"] = (out["topk_levels"] + out["topk_cross"]) \
        / out["chunk"]
    host = [a.cpu().numpy() for a in arrays["out"]]
    t0 = time.perf_counter()
    PO.maskrcnn_decode(None, *host, confidence_threshold=MRCNN_CONFIDENCE)
    out["decode_host"] = (time.perf_counter() - t0) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        forward()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out["kernels_ms"] = busy if busy > 0 else "not measured"
    out["frames"] = DET_CHUNK
    return out


def run_maskrcnn_pipeline(db: str):
    """Phase 6 -> {kernel: launches of the R-50-FPN graph's first run};
    every check raises."""
    weights = write_maskrcnn_weights(db)
    chunks = -(-DET_FRAMES // DET_CHUNK)
    # twice: the first run's frames/s holds the npz read, the second's not
    rows, launches, per_run = run_maskrcnn_graph(
        os.path.join(db, "mrcnn"), weights, runs=2)
    plain = plain_maskrcnn_graph(os.path.join(db, "mrcnn_plain"), weights)
    want = {k: n * chunks for k, n in MRCNN_LAUNCHES_PER_CHUNK.items()}
    counts = [len(f) for f in rows]
    result = {"run": "maskrcnn_pipeline", "arch": MRCNN_ARCH,
              "frames": DET_FRAMES, "height": FACE_H, "width": FACE_W,
              "canvas": list(MRCNN_CANVAS), "launches": launches,
              "runs": per_run, "masks_per_frame": counts,
              "confidence_threshold": MRCNN_CONFIDENCE,
              "rows_equal_plain": _maskrcnn_rows_equal(rows, plain)}
    log(result)
    if any(lc != want for lc in launches):
        raise AssertionError(f"Mask R-CNN: launches {launches}, want {want} "
                             f"each run")
    if not result["rows_equal_plain"]:
        raise AssertionError("Mask R-CNN: rows differ from the plain "
                             "kernels' run")
    with_dets = sum(1 for n in counts if n)
    if len(rows) != DET_FRAMES or with_dets <= DET_FRAMES // 2:
        raise AssertionError(f"Mask R-CNN detections in {with_dets} of "
                             f"{len(rows)} frames")
    for f in rows:
        for d in f:
            b = d["bbox"]
            if d["mask"].shape != (FACE_H // 4, FACE_W // 4) or not (
                    1 <= b.label <= 80 and b.score >= MRCNN_CONFIDENCE
                    and 0.0 <= b.x1 <= b.x2 <= 1.0
                    and 0.0 <= b.y1 <= b.y2 <= 1.0
                    and np.isfinite(d["mask"]).all()):
                raise AssertionError(f"Mask R-CNN detection out of its "
                                     f"contract: {b}, mask "
                                     f"{d['mask'].shape}")
    # the ResNeXt trunk (grouped convolutions): one chunk on the default
    # weights (no weights_path: its npz would be 400 MB), which are the
    # JAX package's draw, the same checks
    x_rows, x_launches, x_runs = run_maskrcnn_graph(
        os.path.join(db, "mrcnn_x"), None, arch=MRCNN_X_ARCH,
        frames=DET_CHUNK)
    x_plain = plain_maskrcnn_graph(os.path.join(db, "mrcnn_x_plain"), None,
                                   arch=MRCNN_X_ARCH, frames=DET_CHUNK)
    x_result = {"run": "maskrcnn_pipeline", "arch": MRCNN_X_ARCH,
                "frames": DET_CHUNK, "launches": x_launches, "runs": x_runs,
                "masks_per_frame": [len(f) for f in x_rows],
                "rows_equal_plain": _maskrcnn_rows_equal(x_rows, x_plain)}
    log(x_result)
    if not any(x_result["masks_per_frame"]):
        log({"maskrcnn_note": f"{MRCNN_X_ARCH} keeps no row on default "
             f"weights ({DET_CHUNK} frames)"})
    if x_launches != [MRCNN_LAUNCHES_PER_CHUNK]:
        raise AssertionError(f"{MRCNN_X_ARCH}: launches {x_launches}")
    if not x_result["rows_equal_plain"] or len(x_rows) != DET_CHUNK:
        raise AssertionError(f"{MRCNN_X_ARCH}: rows differ from the plain "
                             "kernels' run")
    log({"maskrcnn_card_vs_cpu": maskrcnn_card_vs_cpu()})
    log({"maskrcnn_stages_ms": maskrcnn_stage_ms(weights),
         "shape": [DET_CHUNK, FACE_H, FACE_W],
         "canvas": list(MRCNN_CANVAS)})
    return launches[0]


# ------------------------------------------------------------ phase 7


def pose_state() -> dict:
    """The port's seeded OpenPoseBody weights with its two output layers
    scaled by POSE_HEAD_SCALES."""
    from scannertools_tpu_torch.models import pose as PP

    state = PP.init_params(0)
    for key, scale in POSE_HEAD_SCALES:
        state[key] = state[key] * scale
    return state


def write_pose_weights(d: str) -> str:
    """pose_state in the JAX package's layout, as an uncompressed npz (206
    MB) -> its path."""
    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.models import weights

    path = os.path.join(d, "openpose.npz")
    np.savez(path, **weights._flatten(PP.to_flax(pose_state())))
    return path


def pose_frames(rows) -> "torch.Tensor":
    """Frames of the pose video, float32 on the card."""
    import torch

    return torch.from_numpy(FaceDecoder(POSE_FRAMES, FACE_H, FACE_W)
                            .read_frames(list(rows))).cuda().float()


def _pose_launches() -> dict:
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP

    return {"pose_peaks": PP.find_peaks.launches,
            "crop_and_resize": MC.crop_and_resize.launches}


def _reset_pose_launches() -> None:
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP

    PP.find_peaks.launches = MC.crop_and_resize.launches = 0


def pose_graph(sc, frame, graph: str, weights_path: str):
    """The output columns of pose graph ``graph``: "openpose" (one scale,
    linear), "multiscale" (two scales, cubic), "crop_nets" (one scale,
    linear, with the face and hand crop nets on their seeded weights) or
    "cpm2" (CPM2Input -> CPM2 -> CPM2Output)."""
    if graph == "cpm2":
        pre = sc.ops.CPM2Input(frame=frame)
        n = sc.ops.CPM2(cpm2_input=pre, weights_path=weights_path)
        return sc.ops.CPM2Output(cpm2_resized_map=n[0], cpm2_joints=n[1],
                                 original_frame_info=sc.ops.InfoFromFrame(
                                     frames=frame))
    params = {"openpose": {},
              "multiscale": dict(pose_num_scales=2, pose_upsample="cubic"),
              "crop_nets": dict(compute_face=True, compute_hands=True)}
    return sc.ops.OpenPose(frame=frame, weights_path=weights_path,
                           **params[graph])


def run_pose_graph(db: str, weights_path: str, graph: str = "openpose",
                   frames: int = POSE_FRAMES, runs: int = 1,
                   perf_kw=None):
    """Pose graph ``graph`` over the first ``frames`` of the pose video
    through Client.run on the card, in POSE_CHUNK-frame chunks, ``runs``
    times -> (the loaded rows, [launches of each run], [each run's
    seconds, frames/s, span totals and pipeline-axis counts]). The first
    run reads and converts the npz. ``perf_kw``: more PerfParams knobs
    (phase 11's pipeline_stages)."""
    import torch

    import scannertools_tpu_torch as st

    stream_cls = synthetic_stream_class(
        POSE_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(POSE_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=db, device="cuda")
    frame = sc.io.Input([stream_cls(sc, "pose_video")])
    if frames < POSE_FRAMES:
        frame = sc.streams.Gather(frame, [list(range(frames))])
    col = pose_graph(sc, frame, graph, weights_path)
    out = st.NamedStream(sc, "poses")
    perf = st.PerfParams.manual(work_packet_size=POSE_CHUNK, ingest="rgb",
                                **(perf_kw or {}))
    launches, per_run = [], []
    for _ in range(runs):
        before = sc.profiler.totals()
        counts = sc.profiler.counts()
        _reset_pose_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(col, [out]), perf,
               cache_mode=st.CacheMode.Overwrite)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches.append(_pose_launches())
        after = sc.profiler.counts()
        per_run.append({
            "seconds": seconds, "frames_per_s": frames / seconds,
            "totals_s": {k: v - before.get(k, 0.0)
                         for k, v in sc.profiler.totals().items()},
            "axis_counts": {k: after.get(f"axis:pipe:{k}", 0)
                            - counts.get(f"axis:pipe:{k}", 0)
                            for k in ("engaged", "not_engaged")}})
    return list(out.load()), launches, per_run


def plain_pose_graph(db: str, weights_path: str, **kw):
    """run_pose_graph with find_peaks and the crop patched to their plain
    versions -> the loaded rows."""
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import pose as POP

    with mock.patch.object(PP, "find_peaks", PP.find_peaks_plain), \
            mock.patch.object(POP, "crop_and_resize",
                              MC.crop_and_resize_plain):
        rows, launches, _ = run_pose_graph(db, weights_path, **kw)
    if any(n for lc in launches for n in lc.values()):
        raise AssertionError(f"the plain pose graph launched kernels: "
                             f"{launches}")
    return rows


def _pose_rows_equal(got, want) -> bool:
    """The same poses, byte for byte."""
    return len(got) == len(want) and all(
        [p.serialize() for p in g] == [p.serialize() for p in w]
        for g, w in zip(got, want))


def crop_items(rows) -> dict:
    """The face and hand crops OpenPoseDecode cuts for ``rows``, counted as
    it picks them: a face where face_bbox scores above 0.05, a hand where
    the wrist and elbow are seen (the body keypoints, which the crop nets
    leave as they are)."""
    from scannertools_tpu_torch.ops import pose as POP

    P = POP.Pose
    n = {"face": 0, "hand": 0}
    for f in rows:
        for p in f:
            (fx0, _), (fx1, _), fs = p.face_bbox()
            n["face"] += int(fs > 0.05 and fx1 > fx0)
            n["hand"] += sum(POP._hand_box(p, wrist, elbow) is not None
                             for wrist, elbow in ((P.LWrist, P.LElbow),
                                                  (P.RWrist, P.RElbow)))
    return n


def check_crop_net_graph(db: str, weights_path: str) -> dict:
    """OpenPose with compute_face and compute_hands over one POSE_CHUNK
    chunk through Client.run: the chunk's frames reach the decode on the
    card, which cuts the face and hand crops there with the gray crop (one
    launch a net) and runs both crop nets. The seeded body's people find
    no nose and both ears together, so no face: the grouping of each frame
    gains that frame's drawn people (drawn_places), whose faces and
    forearms are whole. Its rows must equal the same graph's with
    find_peaks and the crop patched to their plain versions -> the record,
    with the launches of that run."""
    from unittest import mock

    from scannertools_tpu_torch.models import pose as PP

    group = PP.group_people
    drawn = drawn_places(POSE_CHUNK, FACE_W)
    calls = []

    def with_drawn(peaks, valid, scores):
        i = len(calls) % POSE_CHUNK  # the decode groups frames in order
        calls.append(i)
        return group(peaks, valid, scores) + [
            (0.9, drawn_keypoints(pts)) for pts in drawn[i]]

    with mock.patch.object(PP, "group_people", with_drawn):
        rows, launches, runs = run_pose_graph(
            os.path.join(db, "crop_nets"), weights_path, graph="crop_nets",
            frames=POSE_CHUNK)
        calls.clear()
        plain = plain_pose_graph(os.path.join(db, "crop_nets_plain"),
                                 weights_path, graph="crop_nets",
                                 frames=POSE_CHUNK)
    items = crop_items(rows)
    want = {"pose_peaks": 1,
            "crop_and_resize": int(items["face"] > 0) + int(items["hand"] > 0)}
    result = {"run": "pose_pipeline", "graph": "crop_nets",
              "frames": POSE_CHUNK, "launches": launches, "runs": runs,
              "people_per_frame": [len(f) for f in rows],
              "drawn_per_frame": POSE_PEOPLE, "crops": items,
              "rows_equal_plain": _pose_rows_equal(rows, plain)}
    log(result)
    if not (items["face"] and items["hand"]):
        raise AssertionError(f"the crop-net chunk cut {items}: both nets "
                             f"must run")
    if launches != [want] or not result["rows_equal_plain"]:
        raise AssertionError(f"pose graph crop_nets: launches {launches}, "
                             f"want [{want}]; rows equal to the plain run: "
                             f"{result['rows_equal_plain']}")
    written = {"face": sum(bool(p.face_keypoints().any()) for f in rows
                           for p in f),
               "hand": sum(bool(hk.any()) for f in rows for p in f
                           for hk in p.hand_keypoints())}
    if written != items:
        raise AssertionError(f"the crop nets wrote {written} keypoint "
                             f"sets, the decode cut {items} crops")
    return result


# The drawn people: parts (x, y offsets from the neck) and the limbs drawn
# between them (LIMB_SEQ indices): neck, shoulders, elbows, wrists, nose,
# eyes and ears; 11 limbs, so a person has 12 parts.
POSE_PARTS = {1: (0, 0), 2: (-40, 0), 5: (40, 0), 3: (-55, 60),
              4: (-60, 120), 6: (55, 60), 7: (60, 120), 0: (0, -50),
              14: (-12, -60), 15: (12, -60), 16: (-25, -55),
              17: (25, -55)}
POSE_LIMBS = (0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 16)


def drawn_places(t: int, w: int) -> list:
    """POSE_PEOPLE people a frame at known places: for each of t frames,
    a {part: (x, y)} in pixels for each person."""
    people = []
    for i in range(t):
        frame = []
        for p in range(POSE_PEOPLE):
            nx = 110 + p * (w - 220) // max(POSE_PEOPLE - 1, 1) + 3 * i
            ny = 180 + 7 * p + 2 * i
            frame.append({part: (nx + dx, ny + dy)
                          for part, (dx, dy) in POSE_PARTS.items()})
        people.append(frame)
    return people


def drawn_keypoints(pts: dict) -> np.ndarray:
    """A drawn person as group_people gives it: [18, 3] (x, y, 0.9)."""
    from scannertools_tpu_torch.models import pose as PP

    kp = np.zeros((PP.N_PARTS, 3), np.float32)
    for part, (x, y) in pts.items():
        kp[part] = (x, y, 0.9)
    return kp


def drawn_people(t: int, h: int, w: int):
    """Heat [t, 19, h, w] and PAF [t, 38, h, w] maps (float32, numpy) of
    the drawn_places people, and those places: a single pixel of 0.9 at
    each part, and for each limb a corridor of half-width 2 px along the
    segment holding its unit vector in the limb's two PAF channels (as
    tests/test_pose.py draws them)."""
    from scannertools_tpu_torch.models import pose as PP

    heat = np.zeros((t, PP.N_HEAT, h, w), np.float32)
    paf = np.zeros((t, PP.N_PAF, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    people = drawn_places(t, w)
    for i in range(t):
        for pts in people[i]:
            for part, (x, y) in pts.items():
                heat[i, part, y, x] = 0.9
            for limb in POSE_LIMBS:
                a, b = PP.LIMB_SEQ[limb]
                (ax, ay), (bx, by) = pts[a], pts[b]
                d = np.array([bx - ax, by - ay], np.float32)
                u = d / np.linalg.norm(d)
                s = np.clip(((xx - ax) * d[0] + (yy - ay) * d[1])
                            / float(d @ d), 0.0, 1.0)
                near = np.hypot(xx - ax - s * d[0], yy - ay - s * d[1]) <= 2
                cx, cy = PP.PAF_IDX[limb]
                paf[i, cx][near] = u[0]
                paf[i, cy][near] = u[1]
    return heat, paf, people


def check_drawn_people() -> dict:
    """The drawn maps of a POSE_CHUNK chunk at 480x640 through pose_peaks
    (held to find_peaks_plain, fill rows and all), limb_scores and
    group_people: exactly the drawn people. Then OpenPoseDecode with
    compute_face and compute_hands on the chunk's frames on the card: the
    gray crops held to their plain versions, the rows equal to the decode
    with the crop patched to its plain version, and the crop nets on one
    face and one hand crop held to the CPU -> the record, with the gray
    crop's timings at this call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import pose as POP

    t, h, w = POSE_CHUNK, FACE_H, FACE_W
    heat, paf, drawn = drawn_people(t, h, w)
    heat, paf = torch.from_numpy(heat).cuda(), torch.from_numpy(paf).cuda()
    peaks, valid = PP.find_peaks(heat)
    for g, p in zip((peaks, valid), PP.find_peaks_plain(heat)):
        if not torch.equal(g, p):
            raise AssertionError("pose_peaks disagrees with its plain "
                                 "version on the drawn maps")
    scores = PP.limb_scores(paf, peaks, valid)
    dims = torch.tensor([[h, w]], dtype=torch.int32).repeat(t, 1)
    hp, hv, hs = (a.cpu().numpy() for a in (peaks, valid, scores))
    for i in range(t):
        got = sorted(PP.group_people(hp[i], hv[i], hs[i]),
                     key=lambda p: p[1][1, 0])
        if len(got) != POSE_PEOPLE:
            raise AssertionError(f"frame {i}: {len(got)} people, drawn "
                                 f"{POSE_PEOPLE}")
        for (score, kp), pts in zip(got, drawn[i]):
            if not np.array_equal(kp, drawn_keypoints(pts)) or \
                    not score > 0.4:
                raise AssertionError(f"frame {i}: a person {kp.tolist()} "
                                     f"(score {score}) is not drawn")
    frames = pose_frames(range(t))
    _reset_pose_launches()
    poses = POP.openpose_decode(None, peaks, valid, scores, dims,
                                frame=frames, compute_face=True,
                                compute_hands=True)
    launches = _pose_launches()
    if launches["crop_and_resize"] != 2:
        raise AssertionError(f"the decode launched {launches}, want one "
                             f"crop a net")
    with mock.patch.object(POP, "crop_and_resize",
                           MC.crop_and_resize_plain):
        plain = POP.openpose_decode(None, peaks, valid, scores, dims,
                                    frame=frames, compute_face=True,
                                    compute_hands=True)
    if not _pose_rows_equal(poses, plain):
        raise AssertionError("the decode's rows differ from the plain "
                             "crop's")
    # the decode's face and hand items, as it builds them
    P = POP.Pose
    items = {"face": [], "hand": []}
    for i, fp in enumerate(poses):
        for p in fp:
            (fx0, fy0), (fx1, fy1), _ = p.face_bbox()
            items["face"].append((i, fx0, fy0, fx1, fy1))
            for wrist, elbow in ((P.LWrist, P.LElbow), (P.RWrist, P.RElbow)):
                items["hand"].append((i, *POP._hand_box(p, wrist,
                                                        elbow)[:4]))
    record = {"people": t * POSE_PEOPLE, "launches": launches}
    nets = {"face": (PP.init_face_params(0), P.FACE_KEYPOINTS),
            "hand": (PP.init_hand_params(0), P.HAND_KEYPOINTS)}
    for name, rows in items.items():
        it = torch.tensor(rows, dtype=torch.float32, device="cuda")
        crops = POP.crop_batch(frames, it, POSE_CROP)
        with mock.patch.object(POP, "crop_and_resize",
                               MC.crop_and_resize_plain):
            want = POP.crop_batch(frames, it, POSE_CROP)
        if not torch.equal(crops, want):
            raise AssertionError(f"the gray crop disagrees with its plain "
                                 f"version on the {name} crops")
        outside = int(((it[:, 1:3] < 0) | (it[:, 3:5] > 1)).any(1).sum())
        state, _ = nets[name]
        with torch.no_grad():
            cpu = PP.crop_maps(state, crops[:1].cpu().permute(0, 3, 1, 2))
            card = PP.crop_maps({k: v.cuda() for k, v in state.items()},
                                crops[:1].permute(0, 3, 1, 2)).cpu()
        err = float((card - cpu).abs().max())
        scale = float(cpu.abs().max())
        if not err <= CARD_CPU_RTOL * scale:
            raise AssertionError(f"the {name} net: card and CPU differ by "
                                 f"{err} (largest {scale})")
        record[name] = {"crops": len(rows), "past_an_edge": outside,
                        "card_vs_cpu": {"max_abs_diff": err,
                                        "max_abs": scale}}
        if name == "hand":  # the record's call: 2 hands a person
            boxes, fi = POP.crop_boxes(it, h, w)  # frame-major
            args = (frames, boxes, (POSE_CROP, POSE_CROP), fi)
            bound, by = crop_bound(frames, boxes.view(t, -1, 4), POSE_CROP,
                                   POSE_CROP)
            record["gray_crop"] = {
                "shape": [len(rows), POSE_CROP, POSE_CROP, 3],
                "ms": time_ms(lambda: MC.crop_and_resize(*args,
                                                         gray=True)),
                "device_ms": time_ms(lambda: MC.crop_and_resize(
                    *args, gray=True), fence=True),
                "plain_ms": time_ms(lambda: MC.crop_and_resize_plain(
                    *args, gray=True), reps=5, warm=1),
                "library_ms": None, "max_abs_err": 0.0,
                "bound_ms": bound, "bound_by": by}
    return record


def pose_stage_ms(state: dict) -> dict:
    """One POSE_CHUNK-frame chunk through OpenPoseForward on the card, each
    stage bracketed by CUDA events on the compute stream -> {stage: ms
    summed over its calls}, the chunk's ms, the grouping's host ms over the
    chunk, and the busy share by torch.profiler in a further call."""
    from unittest import mock

    import torch

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import pose as POP

    frames = pose_frames(range(POSE_CHUNK))
    arrays = {}

    def forward():
        arrays["out"] = POP.openpose_forward(None, state, frames)

    forward()  # warm: cuDNN plans, resize taps
    marks = []

    def timed(stage, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((stage, start, end))
            return out
        # find_peaks counts its launches on the name it is reached by
        run.launches = getattr(fn, "launches", 0)
        return run

    patches = [(PP, "body_maps", "body_net"), (PP, "resize_hw", "resize"),
               (PP, "find_peaks", "pose_peaks"),
               (PP, "limb_scores", "limb_scores")]
    with contextlib.ExitStack() as stack:
        for obj, name, stage in patches:
            stack.enter_context(mock.patch.object(
                obj, name, timed(stage, getattr(obj, name))))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
    out = {"chunk": start.elapsed_time(end)}
    for stage, s, e in marks:
        out[stage] = out.get(stage, 0.0) + s.elapsed_time(e)
    peaks, valid, scores, _ = (a.cpu().numpy() for a in arrays["out"])
    t0 = time.perf_counter()
    people = [PP.group_people(peaks[i], valid[i], scores[i])
              for i in range(POSE_CHUNK)]
    out["grouping_host"] = (time.perf_counter() - t0) * 1e3
    out["people_per_frame"] = [len(p) for p in people]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out["kernels_ms"] = busy if busy > 0 else "not measured"
    out["busy_share"] = busy / wall if busy > 0 else "not measured"
    out["frames"] = POSE_CHUNK
    return out


def crop_net_stage_ms(frames, n_face: int, n_hand: int) -> dict:
    """The crop nets of a decode with n_face face and n_hand hand crops of
    POSE_CROP px: the gray crop and each net's forward, CUDA events."""
    import torch

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import pose as POP

    out = {}
    rng = np.random.default_rng(14)
    for name, n, init, n_kp in (
            ("face", n_face, PP.init_face_params, PP.FACE_KEYPOINTS),
            ("hand", n_hand, PP.init_hand_params, PP.HAND_KEYPOINTS)):
        state = {k: v.cuda() for k, v in init(0).items()}
        xy = rng.uniform(0.0, 0.8, (n, 2))
        items = torch.tensor(np.concatenate(
            [rng.integers(0, frames.shape[0], (n, 1)), xy, xy + 0.15], 1),
            dtype=torch.float32, device="cuda")
        crops = POP.crop_batch(frames, items, POSE_CROP)
        with torch.no_grad():
            out[f"{name}_net"] = time_ms(
                lambda: PP.crop_keypoints(state, crops, n_kp), reps=3,
                warm=1)
        out[f"{name}_crops"] = n
    return out


def pose_card_vs_cpu(state: dict) -> dict:
    """The body net's maps on one frame at POSE_CPU_HW, on the card and on
    the CPU: no discrete decision intervenes."""
    import torch

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.utils.numerics import resize_hw

    frame = pose_frames([0]).cpu()
    x = resize_hw((frame / 256.0 - 0.5).permute(0, 3, 1, 2), 2,
                  *POSE_CPU_HW, "linear").contiguous()
    with torch.no_grad():
        cpu = PP.body_maps(state, x)
        card = PP.body_maps({k: v.cuda() for k, v in state.items()},
                            x.cuda())
    out = {"hw": list(POSE_CPU_HW)}
    for name, c, g in zip(("heat", "paf"), cpu, card):
        err = float((g.cpu() - c).abs().max())
        scale = float(c.abs().max())
        if not err <= CARD_CPU_RTOL * scale:
            raise AssertionError(f"the body net's {name}: card and CPU "
                                 f"differ by {err} (largest {scale})")
        out[name] = {"max_abs_diff": err, "max_abs": scale}
    return out


def peaks_bound(heat) -> tuple:
    """Bytes: the 18 part maps read once and the peaks and valid flags
    written; operations: a compare a pixel, and eight more for each pixel
    above the threshold (this run's data)."""
    from scannertools_tpu_torch.models import pose as PP

    t, _, h, w = heat.shape
    parts = heat[:, :PP.N_PARTS]
    above = int((parts > PP._f32(PP.THRE_PEAK)).sum())
    nbytes = parts.numel() * 4 + t * PP.N_PARTS * PP.MAX_PEAKS * (12 + 1)
    return bound_ms(nbytes, parts.numel() + 8 * above)


def pose_net_maps(state: dict):
    """The seeded body net's heat maps of a POSE_CHUNK chunk at 480x640 on
    the card: find_peaks' input on the main path."""
    import torch

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.utils.numerics import div

    frames = pose_frames(range(POSE_CHUNK))
    x = (div(frames, 256.0) - 0.5).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        heat, _ = PP.infer_maps(state, x, (FACE_H, FACE_W))
    return heat.contiguous()


def check_pose_peaks(state: dict) -> dict:
    """pose_peaks held to find_peaks_plain (equal) on the seeded net's maps
    of a POSE_CHUNK chunk at 480x640 (the main path's call, and the
    record), random maps, maps with ties, a map whose best peaks all fall
    to one column, fewer than 24 peaks, ragged sizes, peaks and plateaus
    across the kernel's band edges, a constant plateau (every pixel a
    peak), trained-like maps, and maps off a 16-byte boundary (the 4-byte
    path); timed on the net's, the trained-like and the plateau maps,
    each beside its bound, the count of pixels above the threshold and
    the max_pool2d/topk yardstick."""
    import torch

    from scannertools_tpu_torch.models import pose as PP

    heat = pose_net_maps(state)
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = {"net": heat,
             "random": torch.randn((2, 19, 97, 131), device="cuda",
                                   generator=gen),
             "ties": torch.zeros((2, 19, 60, 80), device="cuda"),
             "one_thread": torch.zeros((1, 19, FACE_H, FACE_W),
                                       device="cuda"),
             "few": torch.zeros((1, 57, 31, 45), device="cuda"),
             "small": torch.rand((3, 19, 5, 7), device="cuda",
                                 generator=gen),
             "band_edge": torch.from_numpy(band_edge_maps(
                 "edge", 2, FACE_H, FACE_W)).cuda(),
             "band_plateau": torch.from_numpy(band_edge_maps(
                 "plateau", 2, FACE_H, FACE_W)).cuda(),
             "constant": torch.full((POSE_CHUNK, 19, FACE_H, FACE_W), 0.5,
                                    device="cuda"),
             "trained_like": blob_maps(POSE_CHUNK, 19, FACE_H, FACE_W,
                                       seed=0),
             "misaligned": torch.randn((3, 19, 61, 83), device="cuda",
                                       generator=gen)}
    cases["ties"][:, :, 1::3, 1::3] = 0.5
    flat = cases["one_thread"].view(1, 19, -1)
    flat[:, :, ::512] = torch.linspace(0.2, 0.9, flat[:, :, ::512].shape[-1],
                                       device="cuda")
    cases["few"][0, 3, 0, 2] = cases["few"][0, 3, 5, 5] = 0.7
    store = torch.empty(heat.numel() + 1, device="cuda")
    cases["net_off_16_bytes"] = store[1:].view(heat.shape)
    cases["net_off_16_bytes"].copy_(heat)
    thre = PP._f32(PP.THRE_PEAK)
    for name, hm in cases.items():
        got = PP.find_peaks(hm)
        want = PP.find_peaks_plain(hm)
        ok = all(torch.equal(g, p) for g, p in zip(got, want))
        n = int(got[1].sum())
        log({"check": "pose_peaks", "maps": name, "shape": list(hm.shape),
             "valid_peaks": n, "equal": ok})
        if not ok:
            raise AssertionError(f"pose_peaks disagrees with its plain "
                                 f"version on the {name} maps")
    log({"kernel": "pose_peaks", "vec": PP.find_peaks_info(True),
         "scalar": PP.find_peaks_info(False)})
    timings = {}
    for name in ("net", "trained_like", "constant"):
        hm = cases[name]
        bound, by = peaks_bound(hm)
        yardstick = peaks_yardstick(hm, PP.N_PARTS, thre, PP.MAX_PEAKS)
        peaks, valid = PP.find_peaks(hm)
        if name != "constant" and not yardstick_agrees(yardstick(), peaks,
                                                      valid, hm.shape[3]):
            raise AssertionError(f"the max_pool2d/topk yardstick finds "
                                 f"other peaks on the {name} maps")
        timings[name] = {
            "ms": time_ms(lambda: PP.find_peaks(hm)),
            "device_ms": time_ms(lambda: PP.find_peaks(hm), fence=True),
            "bound_ms": bound, "bound_by": by,
            "above": int((hm[:, :PP.N_PARTS] > thre).sum()),
            "valid_peaks": int(valid.sum()),
            "yardstick_ms": time_ms(yardstick, fence=True)}
    record = {**{k: timings["net"][k] for k in ("ms", "device_ms",
                                                "bound_ms", "bound_by",
                                                "yardstick_ms")},
              "plain_ms": time_ms(lambda: PP.find_peaks_plain(heat),
                                  reps=5, warm=1),
              "max_abs_err": 0.0}
    log({"timing": "pose_peaks", "shape": list(heat.shape),
         "maps": timings,
         "yardstick": "F.max_pool2d(3, 1, 1) -> where -> torch.topk(24): "
                      "the same peaks, not top_k's tie or fill order",
         **record})
    return record


def run_pose_pipeline(db: str):
    """Phase 7 -> ({kernel: launches of the main path's first run}, the
    pose_peaks record); every check raises."""
    import torch

    state = pose_state()
    record = check_pose_peaks({k: v.cuda() for k, v in state.items()})
    weights = write_pose_weights(db)
    chunks = -(-POSE_FRAMES // POSE_CHUNK)
    # twice: the first run's frames/s holds the npz read, the second's not
    rows, launches, per_run = run_pose_graph(os.path.join(db, "pose"),
                                             weights, runs=2)
    plain = plain_pose_graph(os.path.join(db, "pose_plain"), weights)
    want = {"pose_peaks": chunks, "crop_and_resize": 0}
    counts = [len(f) for f in rows]
    result = {"run": "pose_pipeline", "graph": "openpose",
              "frames": POSE_FRAMES, "height": FACE_H, "width": FACE_W,
              "launches": launches, "runs": per_run,
              "people_per_frame": counts,
              "rows_equal_plain": _pose_rows_equal(rows, plain)}
    log(result)
    if any(lc != want for lc in launches):
        raise AssertionError(f"OpenPose: launches {launches}, want {want} "
                             f"each run")
    if not result["rows_equal_plain"] or len(rows) != POSE_FRAMES:
        raise AssertionError("OpenPose: rows differ from the plain "
                             "kernels' run")
    for f in rows:
        for p in f:
            kp = p.pose_keypoints()
            seen = kp[:, 2] > 0
            if not (np.isfinite(p._kp).all() and p._score > 0.4
                    and (kp[seen, :2] >= 0).all()
                    and (kp[seen, :2] < 1).all()):
                raise AssertionError(f"a pose out of its contract: "
                                     f"{p._score} {kp.tolist()}")
    for graph in ("multiscale", "cpm2"):
        g_rows, g_launches, g_runs = run_pose_graph(
            os.path.join(db, graph), weights, graph=graph,
            frames=POSE_CHUNK)
        g_plain = plain_pose_graph(os.path.join(db, graph + "_plain"),
                                   weights, graph=graph, frames=POSE_CHUNK)
        g_result = {"run": "pose_pipeline", "graph": graph,
                    "frames": POSE_CHUNK, "launches": g_launches,
                    "runs": g_runs,
                    "people_per_frame": [len(f) for f in g_rows],
                    "rows_equal_plain": _pose_rows_equal(g_rows, g_plain)}
        log(g_result)
        if g_launches != [{"pose_peaks": 1, "crop_and_resize": 0}] or \
                not g_result["rows_equal_plain"]:
            raise AssertionError(f"pose graph {graph}: {g_result}")
    crop_nets = check_crop_net_graph(db, weights)
    drawn = check_drawn_people()
    log({"pose_drawn_people": drawn})
    log({"pose_card_vs_cpu": pose_card_vs_cpu(state)})
    stages = pose_stage_ms({k: v.cuda() for k, v in state.items()})
    stages.update(crop_net_stage_ms(pose_frames(range(POSE_CHUNK)),
                                    POSE_CHUNK * POSE_PEOPLE,
                                    2 * POSE_CHUNK * POSE_PEOPLE))
    log({"pose_stages_ms": stages, "shape": [POSE_CHUNK, FACE_H, FACE_W]})
    torch.cuda.synchronize()
    # the body path's first run, and the gray crop's launches from the
    # crop-net chunk's run
    main_launches = dict(launches[0])
    main_launches["crop_and_resize"] += \
        crop_nets["launches"][0]["crop_and_resize"]
    return main_launches, record, drawn["gray_crop"]


# ------------------------------------------------------------ phase 8


ATTR_GRAPHS = ("clothing", "hair_landmarks", "facenet_detector", "moe")
# launches a chunk in each graph: MTCNN's 4 nms and 2 crops where faces
# are found; the attribute and landmark crops are cut on the host (cv2), so
# the crop kernel runs no more
ATTR_LAUNCHES_PER_CHUNK = {
    "clothing": {"nms": 4, "crop_and_resize": 2},
    "hair_landmarks": {"nms": 4, "crop_and_resize": 2},
    "facenet_detector": {"nms": 0, "crop_and_resize": 0},
    "moe": {"nms": 0, "crop_and_resize": 0},
}


def write_attribute_weights(d: str) -> dict:
    """The port's seeded StreetStyle head sets and facenet detector beside
    the face phase's nets, written by the port's save_params in the JAX
    package's layout -> {model: npz path}."""
    from scannertools_tpu_torch.models import (facenet_detector,
                                               streetstyle, weights)

    paths = write_face_weights(d)
    for name, lib in (("streetstyle_clothing", streetstyle.CLOTHING),
                      ("streetstyle_hairstyle", streetstyle.HAIRSTYLE),
                      ("facenet_detector", facenet_detector)):
        paths[name] = os.path.join(d, f"{name}.npz")
        weights.save_params(paths[name], lib.to_flax(lib.init_params(0)))
    return paths


def attribute_graph(sc, stream, name: str, weights: dict):
    """The output columns and stream names of phase-8 graph ``name``."""
    frame = sc.io.Input([stream])
    if name == "facenet_detector":
        pre = sc.ops.NNInput(frame=frame, mean_colors=FACENET_DETECTOR_MEAN,
                             pad_mod=8)
        maps = sc.ops.NNForward(input=pre, model="facenet_detector",
                                weights_path=weights["facenet_detector"])
        info = sc.ops.InfoFromFrame(frames=frame)
        return [sc.ops.FacenetOutput(
            scores=maps, frame_info=info,
            score_threshold=FACENET_DETECTOR_SCORE)], ["fd_faces"]
    if name == "moe":  # FaceNet embeddings of one chunk's frames, routed
        rows = sc.streams.Range(frame, [(0, FACE_CHUNK)])
        pre = sc.ops.NNInput(frame=rows, input_width=160, input_height=160)
        emb = sc.ops.NNForward(input=pre,
                               model="facenet_inception_resnet_v1",
                               weights_path=weights["facenet"])
        e, f, h = MOE_DIMS
        return [sc.ops.MoEHead(input=emb, n_experts=e, d_model=f,
                               d_hidden=h, capacity_batch=FACE_CHUNK)], \
            ["moe"]
    faces = sc.ops.MTCNNDetectFaces(frame=frame,
                                    weights_path=weights["mtcnn"],
                                    thresholds=FACE_THRESHOLDS)
    if name == "clothing":
        windows = sc.ops.PrepareClothingBbox(frame=frame, bboxes=faces)
        return [faces, windows, sc.ops.DetectClothing(
            frame=frame, bboxes=windows, adjust_bboxes=False,
            weights_path=weights["streetstyle_clothing"])], \
            ["attr_faces", "windows", "clothing"]
    return [sc.ops.DetectHairStyle(
                frame=frame, bboxes=faces,
                weights_path=weights["streetstyle_hairstyle"]),
            sc.ops.DetectFaceLandmarks(frame=frame, bboxes=faces,
                                       weights_path=weights["mtcnn"])], \
        ["hair", "landmarks"]


def run_attribute_graphs(db: str, weights: dict, runs: int = 1):
    """The phase-8 graphs in turn through Client.run on the card, the
    clothing graph ``runs`` times in a row (the first run reads its npz
    files, a later one is warm), the others once -> ({graph: [loaded rows
    of each output]}, {graph: [launches of each run]}, {graph: result})."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC

    stream_cls = synthetic_stream_class(
        FACE_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(FACE_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=db)
    video = stream_cls(sc, "attr_video")
    rows, launches, results = {}, {}, {}
    for name in ATTR_GRAPHS:
        cols, names = attribute_graph(sc, video, name, weights)
        outs = [st.NamedStream(sc, n) for n in names]
        perf = st.PerfParams.manual(work_packet_size=FACE_CHUNK,
                                    ingest="rgb")
        launches[name], per_run = [], []
        frames = FACE_CHUNK if name == "moe" else FACE_FRAMES
        for _ in range(runs if name == "clothing" else 1):
            before = sc.profiler.totals()
            MC.nms.launches = MC.crop_and_resize.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.run(sc.io.Output(cols, [tuple(outs)]), perf,
                   cache_mode=st.CacheMode.Overwrite)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name].append(
                {"nms": MC.nms.launches,
                 "crop_and_resize": MC.crop_and_resize.launches})
            per_run.append({
                "seconds": seconds, "frames_per_s": frames / seconds,
                "totals_s": {k: v - before.get(k, 0.0)
                             for k, v in sc.profiler.totals().items()}})
        if name == "clothing":
            per_run[0]["label"] = "cold: npz read, cuDNN plans"
            for r in per_run[1:]:
                r["label"] = "warm"
        rows[name] = [list(o.load()) for o in outs]
        results[name] = {"run": "attribute_pipeline", "graph": name,
                         "frames": frames, "height": FACE_H,
                         "width": FACE_W, "launches": launches[name],
                         "runs": per_run}
    return rows, launches, results


def plain_attribute_graphs(db: str, weights: dict):
    """The same graphs on the card with nms and crop_and_resize replaced by
    their plain versions -> {graph: rows}."""
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import mtcnn as PM

    with mock.patch.object(PM, "nms", MC.nms_plain), \
            mock.patch.object(PM, "crop_and_resize",
                              MC.crop_and_resize_plain):
        rows, launches, _ = run_attribute_graphs(db, weights)
    if any(n for runs in launches.values() for lc in runs
           for n in lc.values()):
        raise AssertionError(f"the plain attribute graphs launched "
                             f"kernels: {launches}")
    return rows


def _attribute_rows_equal(got, want) -> bool:
    """Records' predictions, arrays and box lists equal."""
    def same(a, b):
        if hasattr(a, "predictions"):
            return type(a) is type(b) and np.array_equal(a.predictions,
                                                         b.predictions)
        if isinstance(a, np.ndarray):
            return a.shape == np.shape(b) and np.array_equal(a, b)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y)
                                            for x, y in zip(a, b))
        return a == b
    return same(got, want)


def attribute_checks(rows) -> dict:
    """Every face has its window, clothing and hair records over their
    vocabularies and finite landmarks; the facenet detector's boxes lie in
    the frame; the MoE rows are finite -> counts."""
    from scannertools_tpu_torch.models import streetstyle

    faces, windows, clothing = rows["clothing"]
    hair, landmarks = rows["hair_landmarks"]
    counts = [len(f) for f in faces]
    with_faces = sum(1 for n in counts if n)
    if len(faces) != FACE_FRAMES or with_faces <= FACE_FRAMES // 2:
        raise AssertionError(f"faces in {with_faces} of {len(faces)} "
                             "frames")
    for name, got in (("windows", windows), ("clothing", clothing),
                      ("hair", hair), ("landmarks", landmarks)):
        if [len(x) for x in got] != counts:
            raise AssertionError(f"{name} do not match the faces")
    for recs, attrs in ((clothing, streetstyle.CLOTHING_ATTRIBUTES),
                        (hair, streetstyle.HAIRSTYLE_ATTRIBUTES)):
        sizes = np.array([len(v) for _, v in attrs])
        for r in (r for f in recs for r in f):
            p = r.predictions
            if p.shape != sizes.shape or (p < 0).any() or \
                    (p >= sizes).any():
                raise AssertionError(f"a prediction out of its vocabulary: "
                                     f"{p}")
    if not all(l.shape == (5, 2) and np.isfinite(l).all()
               for f in landmarks for l in f):
        raise AssertionError("landmarks not finite [5, 2]")
    fd = rows["facenet_detector"][0]
    for f in fd:
        for b in f:
            if not (0 <= b.x1 < b.x2 <= FACE_W and 0 <= b.y1 < b.y2
                    <= FACE_H):
                raise AssertionError(f"a facenet detector box off the "
                                     f"frame: {b}")
    moe = np.stack(rows["moe"][0])
    if moe.shape != (FACE_CHUNK, MOE_DIMS[1]) or not np.isfinite(moe).all():
        raise AssertionError(f"MoE rows {moe.shape} not finite")
    return {"faces_per_frame": counts, "frames_with_faces": with_faces,
            "facenet_detector_boxes_per_frame": [len(f) for f in fd],
            "moe_rows_dropped": int((~moe.any(axis=1)).sum()),
            "clothing_values_seen": len({tuple(r.predictions) for f in
                                         clothing for r in f})}


def _chunk_frames():
    """The first FACE_CHUNK frames of the face phase's video (uint8)."""
    return FaceDecoder(FACE_FRAMES, FACE_H, FACE_W).read_frames(
        range(FACE_CHUNK))


def attribute_stage_ms(weights: dict) -> dict:
    """One FACE_CHUNK-frame chunk through the clothing path and the hair
    and landmark nets on the card, each stage timed -> {stage: ms}, the
    faces and crops of the chunk, and the crops kept for the card against
    the CPU. Device stages by CUDA events on the compute stream; host
    stages (the window scan, the cv2 crops) by the host clock; the copies
    by CUDA events around a synchronous copy (pageable host memory)."""
    import torch

    from scannertools_tpu_torch.models import mtcnn as mtcnn_lib
    from scannertools_tpu_torch.models import streetstyle
    from scannertools_tpu_torch.models.common import apply_net
    from scannertools_tpu_torch.ops import clothing as PC
    from scannertools_tpu_torch.ops import faces as PFO

    dev = torch.device("cuda")
    host = _chunk_frames()
    mt = PFO._device_state("mtcnn", weights["mtcnn"], dev)
    states = {m: PFO._device_state(m, weights[m], dev)
              for m in ("streetstyle_clothing", "streetstyle_hairstyle")}

    def events(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def chunk():
        out = {}
        frames, out["upload_frames"] = events(
            lambda: torch.from_numpy(host).to(dev))
        (nb, sc_, v), out["mtcnn_forward"] = events(
            lambda: PFO.mtcnn_forward(None, mt, frames,
                                      thresholds=FACE_THRESHOLDS))
        faces, out["mtcnn_decode"] = host_ms(lambda: PFO.mtcnn_decode(
            None, nb.cpu().numpy(), sc_.cpu().numpy(), v.cpu().numpy()))
        windows, out["window_scan"] = host_ms(
            lambda: PC.prepare_clothing_bbox(None, host, faces))
        f32 = PFO._to_f32_frames(host)
        crops = {}
        for tag, boxes, fn in (
                ("clothing", windows, PC.clothing_crop),
                ("hair", faces, PC._hair_crop),
                ("landmarks", faces,
                 lambda f, b: PFO._crop_resize_host(f, b, 48))):
            (crops[tag], _, _), out[f"host_crops_{tag}"] = host_ms(
                lambda: PFO._host_crops(f32, boxes, fn))
        for tag, model in (("clothing", "streetstyle_clothing"),
                           ("hair", "streetstyle_hairstyle")):
            x, out[f"upload_crops_{tag}"] = events(
                lambda: torch.from_numpy(crops[tag]).to(dev))
            pred, out[f"streetstyle_{tag}"] = events(
                lambda: streetstyle._predict_multihead(
                    states[model], x, streetstyle.CLOTHING_ATTRIBUTES
                    if tag == "clothing"
                    else streetstyle.HAIRSTYLE_ATTRIBUTES))
            _, out[f"download_{tag}"] = events(lambda: pred.cpu())
        lx, out["upload_crops_landmarks"] = events(
            lambda: torch.from_numpy(
                (crops["landmarks"] - 127.5) * 0.0078125).to(dev))
        _, out["onet_landmarks"] = events(
            lambda: apply_net(mtcnn_lib.ONet, mt["onet"], lx)[2].cpu())
        return out, faces, crops

    chunk()  # warm: cuDNN plans, index maps
    t0 = time.perf_counter()
    stages, faces, crops = chunk()
    stages["chunk_wall"] = (time.perf_counter() - t0) * 1e3
    stages["frames"] = FACE_CHUNK
    stages["faces"] = sum(len(f) for f in faces)
    stages["crops"] = {k: int(v.shape[0]) for k, v in crops.items()}
    return stages, crops


def attribute_card_vs_cpu(weights: dict, crops: dict) -> dict:
    """One chunk on the card and on the CPU with the same weights: the
    StreetStyle logits of the chunk's clothing and hair crops, the facenet
    detector's maps of its NNInput frames, and MoEHead over FaceNet
    embeddings of its frames (routing equal, then values) -> the
    differences; each within CARD_CPU_RTOL of the largest value."""
    import torch

    from scannertools_tpu_torch.models import facenet_detector, streetstyle
    from scannertools_tpu_torch.ops import faces as PFO
    from scannertools_tpu_torch.ops import nn_generic as PN
    from scannertools_tpu_torch.parallel import expert

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    frames = torch.from_numpy(_chunk_frames()).to(torch.float32)
    out = {}

    def held(name, fn):
        a = fn(cpu)
        b = fn(dev)
        pairs = list(zip(a, b)) if isinstance(a, (list, tuple)) \
            else [(a, b)]
        err = max(float((y.cpu() - x).abs().max()) for x, y in pairs)
        scale = max(float(x.abs().max()) for x, _ in pairs)
        out[name] = {"max_abs_diff": err, "max_abs": scale}
        if not err <= CARD_CPU_RTOL * scale:
            raise AssertionError(f"{name}: card and CPU differ by {err} "
                                 f"(largest value {scale})")
        return a, b

    for tag, model, attrs in (
            ("clothing", "streetstyle_clothing",
             streetstyle.CLOTHING_ATTRIBUTES),
            ("hair", "streetstyle_hairstyle",
             streetstyle.HAIRSTYLE_ATTRIBUTES)):
        x = torch.from_numpy(crops[tag])
        held(f"streetstyle_{tag}", lambda d: streetstyle.forward(
            PFO._device_state(model, weights[model], d), x.to(d),
            attrs)[0])
    pre = PN.nn_input(None, frames, mean_colors=FACENET_DETECTOR_MEAN,
                      pad_mod=8)
    held("facenet_detector", lambda d: facenet_detector.apply(
        PFO._device_state("facenet_detector", weights["facenet_detector"],
                          d), pre.to(d)))
    x160 = PN.nn_input(None, frames, input_width=160, input_height=160)
    emb, _ = held("facenet_embeddings", lambda d: PN.nn_forward(
        None, PFO._device_state("facenet", weights["facenet"], d),
        x160.to(d), model="facenet_inception_resnet_v1"))
    params = expert.init_moe_params(0, *MOE_DIMS)
    route = [torch.argmax(emb.to(d) @ params["router"].to(d), -1).cpu()
             for d in (cpu, dev)]
    if not torch.equal(*route):
        raise AssertionError("MoE routing differs between card and CPU")
    held("moe", lambda d: expert.moe_reference(
        {k: v.to(d) for k, v in params.items()}, emb.to(d),
        capacity=expert.capacity_for(FACE_CHUNK, MOE_DIMS[0], 2.0)))
    return out


def run_attribute_pipeline(db: str):
    """Phase 8 -> {kernel: launches of the clothing graph's first run};
    every check raises."""
    weights = write_attribute_weights(db)
    rows, launches, results = run_attribute_graphs(
        os.path.join(db, "attributes"), weights, runs=2)
    plain = plain_attribute_graphs(os.path.join(db, "attributes_plain"),
                                   weights)
    chunks = -(-FACE_FRAMES // FACE_CHUNK)
    for name in ATTR_GRAPHS:
        n = 1 if name == "moe" else chunks
        want = {k: v * n for k, v in ATTR_LAUNCHES_PER_CHUNK[name].items()}
        results[name]["rows_equal_plain"] = _attribute_rows_equal(
            rows[name], plain[name])
        log(results[name])
        if any(lc != want for lc in launches[name]):
            raise AssertionError(f"{name}: launches {launches[name]}, want "
                                 f"{want} each run")
        if not results[name]["rows_equal_plain"]:
            raise AssertionError(f"{name}: rows differ from the plain "
                                 "kernels' run")
    log({"attribute_checks": attribute_checks(rows)})
    stages, crops = attribute_stage_ms(weights)
    log({"attribute_stages_ms": stages,
         "shape": [FACE_CHUNK, FACE_H, FACE_W]})
    log({"attribute_card_vs_cpu": attribute_card_vs_cpu(weights, crops)})
    return launches["clothing"][0]


# ------------------------------------------------------------ phase 9


# phase 9: CTC forced alignment of a track of CTC_WINDOWS caption windows,
# T uniform in CTC_T frames, CTC_V labels, lines of CTC_CHARS characters
CTC_WINDOWS, CTC_T, CTC_V, CTC_CHARS = 600, (250, 350), 32, (40, 80)
CTC_FRAME_S = 0.02  # wav2vec2's 20 ms frames
SHOTS_RUNNER_CHUNK = 128  # ShotDetectionPipeline.run_opts' work packet


class RgbSyntheticDecoder(SyntheticDecoder):
    """Phase 2's frames from a decoder that gives RGB only, as the cv2
    decoder does: the runner's "auto" ingest then takes RGB24."""

    i420_supported = False


def run_shots_runner(db: str) -> dict:
    """detect_shots over phase 2's stream, then again with cache=True,
    which must skip the committed output -> the runner's result line."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.pipelines import detect_shots

    stream_cls = synthetic_stream_class(
        N_FRAMES, HEIGHT, WIDTH,
        lambda: RgbSyntheticDecoder(N_FRAMES, HEIGHT, WIDTH))
    sc = st.Client(db_path=os.path.join(db, "runners"))
    runs = []
    for _ in range(2):
        H.hist_rgb.launches = H.hist_i420.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = detect_shots(sc, videos=[stream_cls(sc, "video")])
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "hist_rgb": H.hist_rgb.launches,
                     "hist_i420": H.hist_i420.launches,
                     "boundaries": next(outs[0].load(rows=[0]))})
    direct = next(st.NamedStream(os.path.join(db, "rgb"), "shots").load(
        rows=[0]))
    want = {"hist_rgb": -(-N_FRAMES // SHOTS_RUNNER_CHUNK), "hist_i420": 0}
    result = {"run": "detect_shots", "frames": N_FRAMES, "height": HEIGHT,
              "width": WIDTH, "first": runs[0], "cached": runs[1],
              "frames_per_s": N_FRAMES / runs[0]["seconds"],
              "equal_direct_graph": runs[0]["boundaries"] == direct}
    log(result)
    for run in runs:
        if run["boundaries"] != list(CUTS) or direct != list(CUTS):
            raise AssertionError(f"detect_shots: {run['boundaries']}, "
                                 f"phase 2 {direct}, want {list(CUTS)}")
    if {k: runs[0][k] for k in want} != want:
        raise AssertionError(f"detect_shots: launches {runs[0]}, want {want}")
    if runs[1]["hist_rgb"] or runs[1]["hist_i420"]:
        raise AssertionError("detect_shots with cache=True ran the job "
                             f"again: {runs[1]}")
    return {"hist_rgb": runs[0]["hist_rgb"]}


def run_face_runner(db: str) -> dict:
    """FaceDetectionPipeline over phase 4's frames, through a subclass whose
    build_pipeline passes phase 4's weights and thresholds; its rows must
    equal phase 4's MTCNNDetectFaces graph -> {kernel: launches}."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.pipelines import FaceDetectionPipeline

    mtcnn_npz = os.path.join(db, "mtcnn.npz")  # written by phase 4

    class FaceRunner(FaceDetectionPipeline):
        run_opts = {"work_packet_size": FACE_CHUNK, "ingest": "rgb"}

        def build_pipeline(self):
            return self._sc.ops.MTCNNDetectFaces(
                frame=self._sources["frame"], weights_path=mtcnn_npz,
                thresholds=FACE_THRESHOLDS)

    stream_cls = synthetic_stream_class(
        FACE_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(FACE_FRAMES, FACE_H, FACE_W))
    sc = st.Client(db_path=os.path.join(db, "face_runner"))
    MC.nms.launches = MC.crop_and_resize.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = FaceRunner.make_runner()(sc, videos=[stream_cls(sc, "faces")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"nms": MC.nms.launches,
                "crop_and_resize": MC.crop_and_resize.launches}
    rows = list(outs[0].load())
    direct = list(st.NamedStream(os.path.join(db, "faces"), "faces").load())
    chunks = -(-FACE_FRAMES // FACE_CHUNK)
    want = {k: n * chunks for k, n in FACE_LAUNCHES_PER_CHUNK["faces"].items()}
    log({"run": "face_runner", "frames": FACE_FRAMES, "height": FACE_H,
         "width": FACE_W, "seconds": seconds, "launches": launches,
         "faces": sum(len(f) for f in rows),
         "equal_direct_graph": _face_rows_equal("faces", rows, direct)})
    if launches != want:
        raise AssertionError(f"face runner: launches {launches}, want {want}")
    if not _face_rows_equal("faces", rows, direct) or not any(rows):
        raise AssertionError("face runner: rows differ from phase 4's graph")
    return launches


def run_storage_paths(db: str) -> dict:
    """Phase 2's histograms to a PackedFileStream and back; an sqlite
    SQLInputStream -> Python op -> SQLOutputStream job; a WAV AudioStream
    through a Python op -> {kernel: launches of the histogram job}."""
    import sqlite3
    import wave

    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch import types as st_types
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.storage.sql import (SQLConfig,
                                                    SQLInputStream,
                                                    SQLOutputStream,
                                                    SQLQuery, SQLStorage)

    sc = st.Client(db_path=os.path.join(db, "storage"))
    # histograms of phase 2's RGB stream, sunk to one packed file
    stream_cls = synthetic_stream_class(
        N_FRAMES, HEIGHT, WIDTH,
        lambda: SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH))
    packed = st.PackedFileStream(os.path.join(db, "hist.pack"))
    hist = sc.ops.Histogram(frame=sc.io.Input([stream_cls(sc, "video")]))
    H.hist_rgb.launches = H.hist_i420.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.run(sc.io.Output(hist, [packed]),
           st.PerfParams.manual(work_packet_size=CHUNK, ingest="rgb"),
           cache_mode=st.CacheMode.Overwrite)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"hist_rgb": H.hist_rgb.launches,
                "hist_i420": H.hist_i420.launches}
    named = st.NamedStream(os.path.join(db, "rgb"), "hist")
    parse = st_types.get_type(named.type_name()).parse
    got = np.stack([np.stack(parse(b)) for b in packed.load_bytes()])
    want = np.stack([np.stack(r) for r in named.load()])
    packed_equal = got.shape == (N_FRAMES, 3, 16) and bool((got == want).all())
    bytes_equal = list(packed.load_bytes()) == list(named.load_bytes())

    # sqlite rows through a Python op (tests/test_sql.py's update by id)
    dbfile = os.path.join(db, "t.db")
    conn = sqlite3.connect(dbfile)
    conn.execute("CREATE TABLE test (id integer PRIMARY KEY, a integer, "
                 "b integer, grp integer)")
    conn.executemany("INSERT INTO test VALUES (?, ?, 0, ?)",
                     [(i, 10 * i, i % 3) for i in range(1, 101)])
    conn.execute("CREATE TABLE jobs (id integer PRIMARY KEY, name text)")
    conn.commit()

    @st.register_python_op(name="ChipSmokeAddOne", outputs=("bytes",))
    def add_one(ctx, rows):
        return [json.dumps([{"id": x["id"], "b": x["a"] + 1}
                            for x in json.loads(bytes(r).decode())]).encode()
                for r in rows]

    storage = SQLStorage(SQLConfig(adapter="sqlite", dbname=dbfile),
                         job_table="jobs")
    rows_in = SQLInputStream(
        query=SQLQuery(fields="test.id as id, test.a as a", table="test",
                       id="test.id", group="test.grp"),
        filter="1=1", storage=storage)
    sql_out = SQLOutputStream(table="test", storage=storage,
                              job_name="chip_smoke", insert=False)
    sc.run(sc.io.Output(sc.ops.ChipSmokeAddOne(rows=sc.io.Input([rows_in])),
                        [sql_out]), st.PerfParams.estimate(),
           cache_mode=st.CacheMode.Overwrite)
    b = [r[0] for r in conn.execute("SELECT b FROM test ORDER BY id")]
    conn.close()
    sql_ok = (len(rows_in) == 3 and sql_out.committed()
              and b == [10 * i + 1 for i in range(1, 101)])

    # WAV audio (the card's machine has no libav: WAV only) through an op
    rate = 16000
    sig = (0.5 * np.sin(2 * np.pi * 440 * np.arange(rate * 5) / rate)
           * 32767).astype(np.int16)
    wav_path = os.path.join(db, "a.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())

    @st.register_python_op(name="ChipSmokeRms", outputs=("object",))
    def rms(ctx, samples):
        return [float(np.sqrt(np.mean(np.square(s)))) for s in samples]

    audio = st.AudioStream(wav_path, frame_size=1.0)
    audio_out = st.NamedStream(sc, "rms")
    sc.run(sc.io.Output(sc.ops.ChipSmokeRms(samples=sc.io.Input([audio])),
                        [audio_out]), st.PerfParams.estimate(),
           cache_mode=st.CacheMode.Overwrite)
    levels = list(audio_out.load())
    want_rms = [float(np.sqrt(np.mean(np.square(
        sig[i * rate:(i + 1) * rate].astype(np.float32) / 32768.0))))
        for i in range(5)]
    audio_ok = levels == want_rms

    result = {"run": "storage", "packed_seconds": seconds,
              "launches": launches, "packed_rows_equal_named": packed_equal,
              "packed_bytes_equal_named": bytes_equal, "sql_ok": sql_ok,
              "audio_rms": levels, "audio_ok": audio_ok}
    log(result)
    want_launches = {"hist_rgb": -(-N_FRAMES // CHUNK), "hist_i420": 0}
    if launches != want_launches:
        raise AssertionError(f"packed sink: launches {launches}, want "
                             f"{want_launches}")
    if not (packed_equal and bytes_equal and sql_ok and audio_ok):
        raise AssertionError(f"storage round trips: {result}")
    return launches


def ctc_bound(t_len, s_len) -> tuple:
    """(bound_ms, bound_by) of a ctc_viterbi call on windows of these T
    and S: log_probs read once and the path written once, the labels,
    skips and lengths read once and the scores written once (the int8
    back-pointers are the kernel's own scratch, not the function's); a
    compare, a compare and an add a lattice cell."""
    cells = sum((t - 1) * s for t, s in zip(t_len, s_len))
    nbytes = (sum(t * CTC_V * 4 + t * 4 for t in t_len)
              + sum(s * 5 for s in s_len) + len(t_len) * 12)
    return bound_ms(nbytes, 3 * cells)


def ctc_paths_hold(CA) -> dict:
    """ctc_viterbi held to ctc_viterbi_plain on the card on both paths,
    beyond the track: every move tied (warp and block), windows of S on
    the warp lanes' edges (batches of Smax 33, 256 and 257), a window of
    1025 states and one of a Tmax past shared memory (block path), and
    the ring's fills (V 29 and 48, emissions off a 16-byte boundary) ->
    {check: [path taken, equal]}."""
    import torch

    from scannertools_tpu_torch.tools.timing import (CTC_LANE_EDGES,
                                                     ctc_edge_batch,
                                                     planted_emissions)

    rng = np.random.default_rng(91)
    fit = max(t for t in range(3000, 4000)
              if CA.window_bytes(t, CTC_V) <= CA.SHARED_MAX)
    tok = rng.integers(1, CTC_V, 40).tolist()
    batches = {
        "ties_warp": CA.pack_windows(
            [(np.zeros((t, CTC_V), np.float32),
              [2 + k % 27 for k in range(n)])
             for t, n in [(1, 1), (3, 3), (300, 80), (350, 127)]]),
        "ties_block": CA.pack_windows(
            [(np.zeros((t, CTC_V), np.float32),
              [2 + k % 27 for k in range(n)])
             for t, n in [(1, 1), (3, 3), (300, 80), (600, 512)]]),
        "long_block": CA.pack_windows(
            [(planted_emissions(rng, tok, fit + 1, CTC_V), tok),
             (planted_emissions(rng, [3, 4], 9, CTC_V), [3, 4])]),
        "v29_4byte": ctc_edge_batch(93, [3, 33, 81, 161], v=29, extra=60),
        "v48_bulk": ctc_edge_batch(94, [3, 33, 81, 161], v=48, extra=60),
    }
    for smax in (33, 256, 257):
        batches[f"edges_smax{smax}"] = ctc_edge_batch(
            92 + smax, [s for s in CTC_LANE_EDGES if s <= smax])
    out = {}
    for name, packed in batches.items():
        args = [torch.from_numpy(x).cuda() for x in packed]
        before = dict(CA.ctc_viterbi.path_launches)
        got = CA.ctc_viterbi(*args)
        path = [p for p, n in CA.ctc_viterbi.path_launches.items()
                if n != before[p]]
        want = CA.ctc_viterbi_plain(*args)
        out[name] = [path, all(bool(torch.equal(a, b))
                               for a, b in zip(got, want))]
    # emissions a float off a 16-byte boundary: the 4-byte fill at V = 32
    packed = ctc_edge_batch(95, [3, 33, 81, 161], extra=60)
    lp = torch.from_numpy(packed[0]).cuda()
    buf = torch.empty(lp.numel() + 1, dtype=torch.float32, device=lp.device)
    view = buf[1:].view(lp.shape)
    view.copy_(lp)
    rest = [torch.from_numpy(x).cuda() for x in packed[1:]]
    got = CA.ctc_viterbi(view, *rest)
    want = CA.ctc_viterbi_plain(lp, *rest)
    out["v32_unaligned"] = [
        [CA.viterbi_geometry(4, lp.shape[1], 161, CTC_V,
                             aligned=False)["path"]],
        all(bool(torch.equal(a, b)) for a, b in zip(got, want))]
    return out


def run_ctc(db: str) -> tuple:
    """Phase 9's CTC track: the main path (TranscriptAligner.
    align_words_ctc over the track, one launch, on the warp path), then
    ctc_viterbi held to its plain version on the card over every window
    and on both paths' edge cases (``ctc_paths_hold``), timed -> (launches,
    the kernel's record)."""
    import torch

    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.ops.legacy_extras import TranscriptAligner
    from scannertools_tpu_torch.storage.captions import Caption
    from scannertools_tpu_torch.tools.timing import ctc_track

    vocab = CA.char_vocab()
    track = ctc_track(9, CTC_WINDOWS, vocab, CTC_T, CTC_V, CTC_CHARS)

    # the track as one emission array with a caption a window: a caption
    # spans its window's frames, so margin 0 cuts exactly that window
    log_probs = np.concatenate([lp for lp, _, _ in track])
    caps, at = [], 0
    for i, (lp, line, _) in enumerate(track):
        caps.append(Caption(i, (at + 0.5) * CTC_FRAME_S,
                            (at + lp.shape[0] - 0.5) * CTC_FRAME_S, line))
        at += lp.shape[0]
    CA.ctc_viterbi.launches = 0
    CA.ctc_viterbi.path_launches = {"warp": 0, "block": 0}
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    words = TranscriptAligner().align_words_ctc(caps, log_probs, CTC_FRAME_S,
                                                vocab=vocab, margin_s=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated() - mem_before
    launches = CA.ctc_viterbi.launches
    path_launches = dict(CA.ctc_viterbi.path_launches)
    n_words = sum(len(line.split()) for _, line, _ in track)
    hits = sum(w.success() for w in words)
    # the same records on the CPU, where the DP is the plain version
    cpu_words = TranscriptAligner().align_words_ctc(
        caps, log_probs, CTC_FRAME_S, vocab=vocab, margin_s=0.0, device="cpu")
    records_equal = [dataclasses.astuple(w) for w in words] == \
        [dataclasses.astuple(w) for w in cpu_words]

    # the kernel against its plain version on the card, every window
    packed = CA.pack_windows([(lp, tok) for lp, _, tok in track])
    args = [torch.from_numpy(x).cuda() for x in packed]
    geo = CA.viterbi_geometry(*packed[0].shape[:2], packed[2].shape[1],
                              CTC_V)
    states, scores = CA.ctc_viterbi(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    want_states, want_scores = CA.ctc_viterbi_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t2) * 1e3
    states_equal = bool(torch.equal(states, want_states))
    scores_equal = bool(torch.equal(scores, want_scores))
    err = float((scores - want_scores).abs().max())
    held = ctc_paths_hold(CA)

    t_len, s_len = packed[1].tolist(), packed[4].tolist()
    longest = int(np.argmax(t_len))
    one = [x[longest:longest + 1] for x in args]
    bound, by = ctc_bound(t_len, s_len)
    # the scan's floor: Tmax - 1 dependent steps at the latency of one,
    # the slope of the probe (the warp path's steps with no emission load
    # and no move stored, in one warp of Smax states) between two step
    # counts; the block path's probe beside it
    smax, lo, hi = max(s_len), max(t_len) - 1, 8 * (max(t_len) - 1)

    def slope(path):
        probe_lo = time_ms(lambda: CA.viterbi_step_probe(lo, smax, path=path),
                           fence=True)
        probe_hi = time_ms(lambda: CA.viterbi_step_probe(hi, smax, path=path),
                           fence=True)
        return (probe_hi - probe_lo) / (hi - lo) * 1e6

    step_ns, block_step_ns = slope("warp"), slope("block")
    record = {
        "ms": time_ms(lambda: CA.ctc_viterbi(*args)),
        "device_ms": time_ms(lambda: CA.ctc_viterbi(*args), fence=True),
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by,
        "step_ns": step_ns, "step_floor_ms": step_ns * lo * 1e-6,
        "block_step_ns": block_step_ns,
        # the kernel's device time on the track's longest window alone
        "one_window_ms": time_ms(lambda: CA.ctc_viterbi(*one), fence=True),
        "max_abs_err": err}
    CA.ctc_viterbi.launches = launches  # timing launches do not count
    log({"run": "ctc", "windows": CTC_WINDOWS, "frames": int(sum(t_len)),
         "t_range": [min(t_len), max(t_len)],
         "s_range": [min(s_len), max(s_len)], "v": CTC_V,
         "seconds": seconds, "launches": launches,
         "path_launches": path_launches, "path": geo["path"],
         "k": geo["k"], "windows_per_block": geo["windows"],
         "blocks": geo["blocks"],
         "shared_bytes_per_window": geo["window_bytes"],
         "scratch_bytes": geo["scratch_bytes"],
         "max_memory_allocated": peak_bytes,
         "words": len(words), "words_in_lines": n_words, "words_found": hits,
         "records_equal_cpu": records_equal, "states_equal": states_equal,
         "scores_bit_equal": scores_equal, "held": held})
    log({"timing": "ctc_viterbi", "shape": [CTC_WINDOWS, max(t_len), CTC_V,
                                           max(s_len)], **record})
    if launches != 1 or path_launches != {"warp": 1, "block": 0}:
        raise AssertionError(f"align_words_ctc: {path_launches} launches "
                             "of ctc_viterbi, want 1 on the warp path")
    if len(words) != n_words or hits < 0.99 * n_words:
        raise AssertionError(f"align_words_ctc: {len(words)} words, "
                             f"{hits} found, of {n_words}")
    want_paths = {"ties_warp": "warp", "ties_block": "block",
                  "long_block": "block", "v29_4byte": "warp",
                  "v48_bulk": "warp", "edges_smax33": "warp",
                  "edges_smax256": "warp", "edges_smax257": "block",
                  "v32_unaligned": "warp"}
    if not (records_equal and states_equal and scores_equal
            and all(ok for _, ok in held.values())):
        raise AssertionError("ctc_viterbi disagrees with its plain version")
    if {k: p for k, (p, _) in held.items()} != \
            {k: [p] for k, p in want_paths.items()}:
        raise AssertionError(f"ctc_viterbi took the wrong path: {held}")
    return launches, record


def run_port_rest(db: str) -> tuple:
    """Phase 9 -> ({kernel: launches by path}, the ctc_viterbi record)."""
    launches = {"detect_shots": run_shots_runner(db),
                "face_runner": run_face_runner(db),
                "storage": run_storage_paths(db)}
    launches["ctc"], record = run_ctc(db)
    return launches, record


# ------------------------------------------------------------ phase 10


# phase 10: the job layer and the weights-in path. JOB_COUNT jobs of
# JOB_FRAMES 1080p RGB frames (phase 2's synthetic decoder, two cuts a job,
# job_cuts) through Histogram -> ShotBoundaries in chunks of JOB_CHUNK: a
# static run, two claims workers (one SIGKILLed inside a job), and the
# first RECYCLE_JOBS jobs under run_recycling; WARM_JOBS short jobs of
# WARM_FRAMES at WARM_W x WARM_H time the job-boundary warm-up, with it on
# and off in turns, WARM_TURNS times each
JOB_COUNT, JOB_FRAMES, JOB_CHUNK = 12, 96, 32
JOB_VICTIM_READ_S = 0.5  # the claims victim's decode, slowed a chunk
JOB_CLAIM_TIMEOUT = 3.0  # the survivor's claim_timeout_sec
WARM_JOBS, WARM_FRAMES, WARM_H, WARM_W, WARM_TURNS = 24, 48, 480, 640, 3
RECYCLE_JOBS = 3
RECYCLE_MARGIN_MB = 64.0  # a recycling worker's budget over its baseline
DEVICE = "cuda"  # phase 10's Client device (a CPU rehearsal sets "cpu")


def _sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _client(db: str):
    import scannertools_tpu_torch as st

    return st.Client(db_path=db, device=None if DEVICE == "cuda" else DEVICE)


def job_cuts(j: int) -> tuple:
    return (20 + 2 * j, 60 + j)


class SlowSyntheticDecoder(SyntheticDecoder):
    """The claims victim's decoder: JOB_VICTIM_READ_S more a read, so that
    the kill lands inside a job."""

    def read_frames(self, rows, out=None):
        time.sleep(JOB_VICTIM_READ_S)
        return super().read_frames(rows, out)


def job_graph(sc, prefix: str, jobs, slow: bool = False):
    """Histogram -> ShotBoundaries over ``jobs`` of the job set, sunk to
    <prefix>_hist<j> and <prefix>_shots<j> -> (output, [(hist, shots)])."""
    import scannertools_tpu_torch as st

    dec = SlowSyntheticDecoder if slow else SyntheticDecoder
    videos = [synthetic_stream_class(
        JOB_FRAMES, HEIGHT, WIDTH,
        lambda j=j: dec(JOB_FRAMES, HEIGHT, WIDTH, job_cuts(j), j))(
            sc, f"job{j}") for j in jobs]
    hist = sc.ops.Histogram(frame=sc.io.Input(videos))
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    sinks = [(st.NamedStream(sc, f"{prefix}_hist{j}"),
              st.NamedStream(sc, f"{prefix}_shots{j}")) for j in jobs]
    return sc.io.Output([hist, bounds], sinks), sinks


def job_perf(**kw):
    import scannertools_tpu_torch as st

    return st.PerfParams.manual(work_packet_size=JOB_CHUNK, ingest="rgb",
                                **kw)


def job_rows(sinks) -> list:
    """[(histogram bytes, boundaries)] of each job's sinks."""
    return [(b"".join(np.stack(r).tobytes() for r in h.load()),
             next(s.load(rows=[0]))) for h, s in sinks]


def plain_job_histograms(j: int) -> bytes:
    """Job j's [JOB_FRAMES, 3, 16] histograms by hist_rgb's plain version
    on the phase's device, as bytes."""
    import torch

    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.utils.framechunk import FrameChunk

    dec = SyntheticDecoder(JOB_FRAMES, HEIGHT, WIDTH, job_cuts(j), j)
    out = []
    for a in range(0, JOB_FRAMES, JOB_CHUNK):
        chunk = FrameChunk.from_hwc(dec.read_frames(
            list(range(a, min(a + JOB_CHUNK, JOB_FRAMES))))).device(DEVICE)
        out.append(H.hist_rgb_plain(chunk.flat, chunk.npix, 3))
    return torch.cat(out).cpu().numpy().tobytes()


def _logging_run_job(log_fn):
    """Executor._run_job wrapped to call ``log_fn(job)`` after each job
    (the original is restored by the caller)."""
    from scannertools_tpu_torch.runtime import executor as ex

    orig = ex.Executor._run_job

    def run_job(self, output, order, need, sources, job, *a, **k):
        out = orig(self, output, order, need, sources, job, *a, **k)
        _sync()
        log_fn(job)
        return out

    ex.Executor._run_job = run_job
    return orig


def run_static_jobs(db: str) -> tuple:
    """The job set in one process, in order -> (rows, hist_rgb launches,
    [RSS MB after each job])."""
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.runtime import executor as ex

    sc = _client(os.path.join(db, "static"))
    out, sinks = job_graph(sc, "static", range(JOB_COUNT))
    rss = []
    orig = _logging_run_job(lambda job: rss.append(ex._rss_mb()))
    try:
        H.hist_rgb.launches = H.hist_i420.launches = 0
        _sync()
        t0 = time.perf_counter()
        sc.run(out, job_perf(), cache_mode=st.CacheMode.Overwrite)
        _sync()
        seconds = time.perf_counter() - t0
        launches = H.hist_rgb.launches
    finally:
        ex.Executor._run_job = orig
    rows = job_rows(sinks)
    log({"run": "jobs_static", "jobs": JOB_COUNT, "frames_per_job":
         JOB_FRAMES, "height": HEIGHT, "width": WIDTH, "seconds": seconds,
         "frames_per_s": JOB_COUNT * JOB_FRAMES / seconds,
         "hist_rgb": launches, "hist_i420": H.hist_i420.launches,
         "rss_mb_after_job": rss})
    want = JOB_COUNT * -(-JOB_FRAMES // JOB_CHUNK)
    if launches != want or H.hist_i420.launches:
        raise AssertionError(f"static jobs: {launches} hist_rgb launches, "
                             f"want {want}")
    for j, (hist, cuts) in enumerate(rows):
        if cuts != list(job_cuts(j)):
            raise AssertionError(f"job {j}: boundaries {cuts}, want "
                                 f"{list(job_cuts(j))}")
        if hist != plain_job_histograms(j):
            raise AssertionError(f"job {j}: histograms differ from the "
                                 "plain version's")
    return rows, launches, rss


def claims_worker(role: str, db: str, device: str = "cuda") -> int:
    """``chip_smoke.py --claims-worker ROLE DB``: one claims worker over
    the job set (the "victim" with a slowed decode). Prints a JSON line as
    each job starts and ends, and one when the run returns."""
    global DEVICE
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.runtime import executor as ex

    DEVICE = device
    sc = _client(db)
    out, _ = job_graph(sc, "claims", range(JOB_COUNT),
                       slow=role == "victim")
    orig = ex.Executor._run_job

    def run_job(self, output, order, need, sources, job, *a, **k):
        log({"worker": role, "start": job})
        out = orig(self, output, order, need, sources, job, *a, **k)
        log({"worker": role, "done": job})
        return out

    ex.Executor._run_job = run_job
    H.hist_rgb.launches = 0
    sc.run(out, job_perf(), cache_mode=st.CacheMode.Ignore,
           job_distribution="claims", claim_timeout_sec=JOB_CLAIM_TIMEOUT)
    _sync()
    log({"worker": role, "finished": True, "hist_rgb": H.hist_rgb.launches,
         "warm_failed": sc.profiler.counts().get("job:warm_failed", 0)})
    return 0


def _claim_holders(claims_root: str) -> set:
    """The pids written in the claim files under ``claims_root``."""
    pids = set()
    for dirpath, _, names in os.walk(claims_root):
        for n in names:
            try:
                with open(os.path.join(dirpath, n)) as f:
                    pids.add(int(f.read().split()[0].rsplit(":", 1)[1]))
            except (OSError, ValueError, IndexError):
                continue
    return pids


def _reap(proc) -> None:
    """Kill ``proc`` if it still runs, and wait for it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _worker_lines(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                out.append(json.loads(line))
    return out


def claim_op_us(d: str, n: int = 500) -> dict:
    """Mean microseconds of WorkClaims' try_claim and heartbeat on the db's
    file system: a claims job costs one try_claim and two heartbeats a
    chunk (its claim and the look-ahead's)."""
    from scannertools_tpu_torch.parallel.workqueue import WorkClaims

    c = WorkClaims(d, "claim_op_probe")
    out = {}
    for name, op in (("try_claim_us", c.try_claim),
                     ("heartbeat_us", c.heartbeat)):
        t0 = time.perf_counter()
        for j in range(n):
            op(j)
        out[name] = (time.perf_counter() - t0) / n * 1e6
    c.clear()
    chunks = -(-JOB_FRAMES // JOB_CHUNK)
    out["per_job_us"] = out["try_claim_us"] + 2 * chunks * out["heartbeat_us"]
    return out


def run_claims(db: str, static_rows: list) -> int:
    """Two claims workers on the card over the job set; the victim is
    SIGKILLed once both hold claims and the survivor reaps its stale
    claims and finishes -> the survivor's hist_rgb launches."""
    import signal
    import subprocess

    cdb = os.path.join(db, "claims")
    os.makedirs(cdb)
    procs, logs = {}, {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as files:
        for role in ("victim", "survivor"):
            logs[role] = os.path.join(db, f"claims_{role}.log")
            procs[role] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--claims-worker",
                 role, cdb, DEVICE],
                stdout=files.enter_context(open(logs[role], "w")),
                stderr=subprocess.STDOUT)
            files.callback(_reap, procs[role])
        pids = {r: p.pid for r, p in procs.items()}
        while set(pids.values()) - _claim_holders(os.path.join(cdb,
                                                               "_claims")):
            if any(p.poll() is not None for p in procs.values()) or \
                    time.perf_counter() - t0 > 120:
                raise AssertionError("claims: a worker ended or never "
                                     "claimed before the kill")
            time.sleep(0.05)
        killed_at = time.perf_counter() - t0
        procs["victim"].send_signal(signal.SIGKILL)
        procs["victim"].wait(timeout=30)
        procs["survivor"].wait(timeout=300)
        seconds = time.perf_counter() - t0
    lines = {r: _worker_lines(path) for r, path in logs.items()}
    if procs["survivor"].returncode != 0:
        with open(logs["survivor"]) as f:
            raise AssertionError("claims survivor failed:\n" + f.read()[-4000:])
    started = {r: [ln["start"] for ln in ls if "start" in ln]
               for r, ls in lines.items()}
    done = {r: [ln["done"] for ln in ls if "done" in ln]
            for r, ls in lines.items()}
    [final] = [ln for ln in lines["survivor"] if ln.get("finished")]
    sc = _client(cdb)
    _, sinks = job_graph(sc, "claims", range(JOB_COUNT))
    rows = job_rows(sinks)
    result = {"run": "claims", "jobs": JOB_COUNT, "seconds": seconds,
              "victim_killed_at_s": killed_at, "victim_started":
              started["victim"], "victim_done": done["victim"],
              "survivor_started": started["survivor"],
              "ran_twice": sorted(set(started["victim"])
                                  & set(started["survivor"])),
              "stale_reaped": sorted(set(started["victim"])
                                     - set(done["victim"])),
              "survivor_hist_rgb": final["hist_rgb"],
              "warm_failed": final["warm_failed"],
              "claim_ops": claim_op_us(os.path.join(db, "claim_probe")),
              "rows_equal_static": rows == static_rows}
    log(result)
    if not started["victim"] or len(done["victim"]) == JOB_COUNT:
        raise AssertionError("claims: the victim ran no job, or all of them")
    if not all(s.committed() for pair in sinks for s in pair) or \
            not result["rows_equal_static"]:
        raise AssertionError("claims: rows differ from the static run's")
    if final["warm_failed"]:
        raise AssertionError(f"claims: {final['warm_failed']} warm-ups "
                             "failed")
    return final["hist_rgb"]


def warm_videos(d: str) -> tuple:
    """WARM_JOBS mp4v files written by cv2 (a cut in each) if cv2 reads
    them back -> ("cv2", paths); else ("synthetic", None)."""
    import cv2

    os.makedirs(d, exist_ok=True)
    paths = []
    for j in range(WARM_JOBS):
        path = os.path.join(d, f"warm{j}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                            (WARM_W, WARM_H))
        if not w.isOpened():
            return "synthetic", None
        cut = 12 + j % 24
        for i in range(WARM_FRAMES):
            f = np.empty((WARM_H, WARM_W, 3), np.uint8)
            f[:] = COLORS[(j + (i >= cut)) % len(COLORS)][::-1]
            x = (i * 2 * BAR) % (WARM_W - BAR)
            f[:, x:x + BAR] = 255
            w.write(f)
        w.release()
        cap = cv2.VideoCapture(path)
        ok = cap.isOpened() and cap.read()[0] and int(
            cap.get(cv2.CAP_PROP_FRAME_COUNT)) == WARM_FRAMES
        cap.release()
        if not ok:
            return "synthetic", None
        paths.append(path)
    return "cv2", paths


def _job_gaps_ms(profiler) -> list:
    """Per job boundary: the previous job's last sink write's end to the
    next job's first device chunk's start, ms (host clock)."""
    runs = sorted(profiler.intervals("job:run"), key=lambda iv: iv["ts"])
    writes = profiler.intervals("sink:write")
    dev = [iv for name in {n for n in profiler.totals()
                           if n.startswith("device:")}
           for iv in profiler.intervals(name)]
    gaps = []
    for a, b in zip(runs, runs[1:]):
        end = max((w["ts"] + w["dur"] for w in writes
                   if a["ts"] <= w["ts"] <= a["ts"] + a["dur"]), default=None)
        start = min((d["ts"] for d in dev
                     if b["ts"] <= d["ts"] <= b["ts"] + b["dur"]),
                    default=None)
        if end is not None and start is not None:
            gaps.append((start - end) / 1e3)
    return gaps


def run_warmup(db: str) -> int:
    """WARM_JOBS short jobs with the warm-up on and off in turns ->
    hist_rgb launches of the runs."""
    import statistics

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H

    decoder, paths = warm_videos(os.path.join(db, "warm_videos"))
    saved = {k: os.environ.get(k) for k in ("ST_TPU_NO_JOB_OVERLAP",
                                            "SCANNERTOOLS_TPU_DECODER")}
    runs = {True: [], False: []}
    launches, first_rows = 0, None
    try:
        if decoder == "cv2":
            os.environ["SCANNERTOOLS_TPU_DECODER"] = "cv2"
        for turn in range(WARM_TURNS):
            for overlap in (True, False):
                if overlap:
                    os.environ.pop("ST_TPU_NO_JOB_OVERLAP", None)
                else:
                    os.environ["ST_TPU_NO_JOB_OVERLAP"] = "1"
                sc = _client(os.path.join(db, f"warm_{turn}_{overlap}"))
                if decoder == "cv2":
                    videos = [st.NamedVideoStream(sc, f"w{j}", path=p)
                              for j, p in enumerate(paths)]
                else:
                    videos = [synthetic_stream_class(
                        WARM_FRAMES, WARM_H, WARM_W,
                        lambda j=j: SyntheticDecoder(
                            WARM_FRAMES, WARM_H, WARM_W, (12 + j,), j))(
                                sc, f"w{j}") for j in range(WARM_JOBS)]
                hist = sc.ops.Histogram(frame=sc.io.Input(videos))
                bounds = sc.ops.ShotBoundaries(histograms=hist)
                sinks = [(st.NamedStream(sc, f"wh{j}"),
                          st.NamedStream(sc, f"ws{j}"))
                         for j in range(WARM_JOBS)]
                H.hist_rgb.launches = 0
                _sync()
                t0 = time.perf_counter()
                sc.run(sc.io.Output([hist, bounds], sinks),
                       st.PerfParams.manual(work_packet_size=WARM_FRAMES,
                                            ingest="rgb"),
                       cache_mode=st.CacheMode.Overwrite)
                _sync()
                seconds = time.perf_counter() - t0
                launches += H.hist_rgb.launches
                gaps = _job_gaps_ms(sc.profiler)
                failed = sc.profiler.counts().get("job:warm_failed", 0)
                warmed = sc.profiler.counts().get("job:warm", 0)
                runs[overlap].append({"seconds": seconds,
                                      "gap_ms_median": statistics.median(gaps),
                                      "warmed": warmed, "warm_failed": failed,
                                      "hist_rgb": H.hist_rgb.launches})
                rows = job_rows(sinks)
                if first_rows is None:
                    first_rows = rows
                if failed or rows != first_rows or \
                        H.hist_rgb.launches != WARM_JOBS or \
                        warmed != (WARM_JOBS - 1 if overlap else 0):
                    raise AssertionError(
                        f"warm-up (overlap {overlap}): {failed} failed, "
                        f"{warmed} warmed, {H.hist_rgb.launches} launches, "
                        f"rows equal {rows == first_rows}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    med = {k: {"seconds": statistics.median(r["seconds"] for r in v),
               "gap_ms": statistics.median(r["gap_ms_median"] for r in v)}
           for k, v in runs.items()}
    log({"run": "job_warmup", "decoder": decoder, "jobs": WARM_JOBS,
         "frames_per_job": WARM_FRAMES, "height": WARM_H, "width": WARM_W,
         "overlap_on": runs[True], "overlap_off": runs[False],
         "median_on": med[True], "median_off": med[False]})
    return launches


def recycle_work(attempt: int, db: str, device: str, log_path: str) -> None:
    """run_recycling's target: the first RECYCLE_JOBS jobs with
    CacheMode.Resume and recycle_rss_mb RECYCLE_MARGIN_MB over this
    process's RSS before its first job; a JSON line per job to
    ``log_path`` (RSS after it, launches)."""
    global DEVICE
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.runtime import executor as ex

    DEVICE = device
    sc = _client(db)
    out, _ = job_graph(sc, "recycle", range(RECYCLE_JOBS))
    baseline = ex._rss_mb()

    def note(job):
        with open(log_path, "a") as f:
            f.write(json.dumps({"attempt": attempt, "pid": os.getpid(),
                                "job": job, "rss_mb": ex._rss_mb(),
                                "baseline_mb": baseline,
                                "hist_rgb": H.hist_rgb.launches}) + "\n")

    _logging_run_job(note)
    sc.run(out, job_perf(recycle_rss_mb=baseline + RECYCLE_MARGIN_MB),
           cache_mode=st.CacheMode.Resume)


def run_recycle(db: str, static_rows: list) -> int:
    """run_recycling over the first RECYCLE_JOBS jobs -> hist_rgb launches
    of its workers."""
    from scannertools_tpu_torch.parallel.recycling import run_recycling

    rdb = os.path.join(db, "recycle")
    log_path = os.path.join(db, "recycle.jsonl")
    t0 = time.perf_counter()
    procs = run_recycling(recycle_work, args=(rdb, DEVICE, log_path),
                          max_restarts=2 * RECYCLE_JOBS)
    seconds = time.perf_counter() - t0
    jobs = _worker_lines(log_path)
    sc = _client(rdb)
    _, sinks = job_graph(sc, "recycle", range(RECYCLE_JOBS))
    rows = job_rows(sinks)
    result = {"run": "recycling", "processes": procs, "seconds": seconds,
              "jobs": jobs, "rows_equal_static":
              rows == static_rows[:RECYCLE_JOBS]}
    log(result)
    if procs < 3 or sorted(j["job"] for j in jobs) != list(
            range(RECYCLE_JOBS)):
        raise AssertionError(f"recycling: {procs} processes, jobs run "
                             f"{[j['job'] for j in jobs]}")
    if not result["rows_equal_static"]:
        raise AssertionError("recycling: rows differ from the static run's")
    return sum(j["hist_rgb"] for j in jobs)


# -- weights in


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _pb_ld(field: int, payload: bytes) -> bytes:
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def _to_source(kind: str, a) -> np.ndarray:
    """A flax-layout leaf -> its source checkpoint's layout (caffe OIHW,
    TF HWIO or [kH, kW, C, 1] depthwise)."""
    a = np.asarray(a, np.float32)
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "tf_depthwise":
        return a.transpose(0, 1, 3, 2)
    if kind in ("tf_conv", "raw"):
        return a
    raise KeyError(kind)


def caffemodel_bytes(flat: dict, mapping: dict) -> bytes:
    """A NetParameter of LayerParameters (name, BlobShape, packed floats)
    holding ``flat``'s leaves under their caffe names."""
    layers = {}
    for path, (ck, kind) in mapping.items():
        layer, leaf = ck.rsplit(".", 1)
        layers.setdefault(layer, {})[leaf] = _to_source(kind, flat[path])
    out = []
    for name, blobs in layers.items():
        body = [_pb_ld(1, name.encode())]
        for leaf in ("weight", "bias"):
            if leaf in blobs:
                b = blobs[leaf]
                dims = b"".join(_pb_varint(1 << 3) + _pb_varint(d)
                                for d in b.shape)
                body.append(_pb_ld(7, _pb_ld(7, dims)
                                   + _pb_ld(5, b.astype("<f4").tobytes())))
        out.append(_pb_ld(100, b"".join(body)))
    return b"".join(out)


def frozen_graph_bytes(flat: dict, mapping: dict) -> bytes:
    """A GraphDef of float Const nodes (tensor_content) holding ``flat``'s
    leaves under their TF names, every third with TF1's /read suffix, and
    one Identity node."""
    nodes = []
    for i, (path, (tfk, kind)) in enumerate(sorted(mapping.items())):
        a = _to_source(kind, flat[path])
        shape = b"".join(_pb_ld(2, _pb_varint(1 << 3) + _pb_varint(d))
                         for d in a.shape)
        tensor = (_pb_varint(1 << 3) + _pb_varint(1) + _pb_ld(2, shape)
                  + _pb_ld(4, a.astype("<f4").tobytes()))
        attr = _pb_ld(1, b"value") + _pb_ld(2, _pb_ld(8, tensor))
        name = tfk + ("/read" if i % 3 == 0 else "")
        nodes.append(_pb_ld(1, _pb_ld(1, name.encode())
                            + _pb_ld(2, b"Const") + _pb_ld(5, attr)))
    nodes.append(_pb_ld(1, _pb_ld(1, b"Preprocessor/map")
                        + _pb_ld(2, b"Identity")))
    return b"".join(nodes)


def run_objects_graph(db: str, ssd_path: str) -> tuple:
    """DetectObjects over phase 5's frames with ``weights_path`` ->
    (rows, nms launches)."""
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import common as MC

    stream_cls = synthetic_stream_class(
        DET_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(DET_FRAMES, FACE_H, FACE_W))
    sc = _client(db)
    cols, names = detection_graph(sc, stream_cls(sc, "det_video"),
                                  "objects", {"ssd": ssd_path})
    outs = [st.NamedStream(sc, n) for n in names]
    MC.nms.launches = 0
    sc.run(sc.io.Output(cols, [tuple(outs)]),
           st.PerfParams.manual(work_packet_size=DET_CHUNK, ingest="rgb"),
           cache_mode=st.CacheMode.Overwrite)
    _sync()
    return [list(o.load()) for o in outs], MC.nms.launches


def run_weights_in(db: str) -> dict:
    """Synthesized artifacts -> the kit's CLI -> OpenPose and DetectObjects
    on its npz -> {kernel: launches of the runs on the kit's npz}."""
    import subprocess
    from unittest import mock

    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import porting_maps as pm
    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.models import ssd, weights
    from scannertools_tpu_torch.tools.port_checkpoints import read_ssd_graph
    from scannertools_tpu_torch.utils.caffemodel import read_caffemodel

    art = os.path.join(db, "artifacts")
    os.makedirs(art)
    seeded = {"openpose": weights._flatten(PP.to_flax(pose_state())),
              "ssd": weights._flatten(ssd.to_flax(ssd.init_params(0)))}
    files = {"openpose": os.path.join(art, "pose_iter_440000.caffemodel"),
             "ssd": os.path.join(art, "frozen_inference_graph.pb")}
    with open(files["openpose"], "wb") as f:
        f.write(caffemodel_bytes(seeded["openpose"], pm.openpose_mapping()))
    with open(files["ssd"], "wb") as f:
        f.write(frozen_graph_bytes(seeded["ssd"], pm.ssd_mapping()))
    # the kit's CLI runs beside the parse timing and the seeded-weight
    # runs (most of its time is save_params' compression of the 206 MB
    # body)
    t0 = time.perf_counter()
    kit = subprocess.Popen(
        [sys.executable, "-m", "scannertools_tpu_torch.tools.port_checkpoints",
         "--artifacts", art, "--families", "openpose,ssd", "--strict"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        parse = {}
        for fam, reader in (("openpose", read_caffemodel),
                            ("ssd", read_ssd_graph)):
            t1 = time.perf_counter()
            n = len(reader(files[fam]))
            seconds = time.perf_counter() - t1
            size = os.path.getsize(files[fam])
            parse[fam] = {"bytes": size, "arrays": n, "seconds": seconds,
                          "mb_per_s": size / seconds / 1e6}
        pose_seeded, _, _ = run_pose_graph(
            os.path.join(db, "kit_pose_seeded"), write_pose_weights(art))
        ssd_seeded_path = os.path.join(art, "ssd_seeded.npz")
        weights.save_params(ssd_seeded_path,
                            ssd.to_flax(ssd.init_params(0)))
        obj_seeded, _ = run_objects_graph(
            os.path.join(db, "kit_ssd_seeded"), ssd_seeded_path)
        kit_log, _ = kit.communicate(timeout=600)
        kit_seconds = time.perf_counter() - t0
    finally:
        if kit.poll() is None:
            kit.kill()
            kit.wait()
    if kit.returncode != 0:
        raise AssertionError("port kit failed:\n" + kit_log)
    ported = {}
    for fam in ("openpose", "ssd"):
        with np.load(os.path.join(art, "ported", f"{fam}.npz")) as z:
            got = {k: z[k] for k in z.files}
        want = seeded[fam]
        ported[fam] = sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            and got[k].tobytes() == np.asarray(want[k]).tobytes()
            for k in want)
    npz = {fam: os.path.join(art, "ported", f"{fam}.npz")
           for fam in ("openpose", "ssd")}
    pose_kit, pose_launches, pose_runs = run_pose_graph(
        os.path.join(db, "kit_pose"), npz["openpose"])
    pose_plain = plain_pose_graph(os.path.join(db, "kit_pose_plain"),
                                  npz["openpose"])
    obj_kit, nms_launches = run_objects_graph(os.path.join(db, "kit_ssd"),
                                              npz["ssd"])
    with mock.patch.object(ssd, "nms", MC.nms_plain):
        obj_plain, plain_nms = run_objects_graph(
            os.path.join(db, "kit_ssd_plain"), npz["ssd"])
    if plain_nms:
        raise AssertionError("the plain DetectObjects run launched nms")
    result = {"run": "weights_in", "parse": parse, "kit_seconds": kit_seconds,
              "npz_equal_seeded": ported,
              "openpose": {"launches": pose_launches, "runs": pose_runs,
                           "people_per_frame": [len(f) for f in pose_kit],
                           "rows_equal_seeded":
                           _pose_rows_equal(pose_kit, pose_seeded),
                           "rows_equal_plain":
                           _pose_rows_equal(pose_kit, pose_plain)},
              "objects": {"nms": nms_launches,
                          "rows_equal_seeded": all(
                              _detection_rows_equal(g, w)
                              for g, w in zip(obj_kit, obj_seeded)),
                          "rows_equal_plain": all(
                              _detection_rows_equal(g, w)
                              for g, w in zip(obj_kit, obj_plain))}}
    log(result)
    if not all(ported.values()):
        raise AssertionError(f"the kit's npz differ from the seeded trees: "
                             f"{ported}")
    for name in ("openpose", "objects"):
        r = result[name]
        if not (r["rows_equal_seeded"] and r["rows_equal_plain"]):
            raise AssertionError(f"{name} on the kit's weights: {r}")
    if pose_launches != [{"pose_peaks": -(-POSE_FRAMES // POSE_CHUNK),
                          "crop_and_resize": 0}] or \
            nms_launches != -(-DET_FRAMES // DET_CHUNK):
        raise AssertionError(f"weights in: launches {pose_launches}, "
                             f"nms {nms_launches}")
    if sum(map(len, pose_kit)) == 0 or len(obj_kit[0]) != DET_FRAMES:
        raise AssertionError("weights in: no people or no object rows")
    return {"pose_peaks": pose_launches[0]["pose_peaks"], "nms": nms_launches}


def run_job_layer(db: str) -> tuple:
    """Phase 10 -> ({kernel: launches by part}, the static run's rows, for
    phase 11); every check raises."""
    launches = {"weights_in": run_weights_in(db)}
    static_rows, static_launches, rss = run_static_jobs(db)
    launches["static"] = {"hist_rgb": static_launches}
    launches["claims"] = {"hist_rgb": run_claims(db, static_rows)}
    launches["warmup"] = {"hist_rgb": run_warmup(db)}
    launches["recycling"] = {"hist_rgb": run_recycle(db, static_rows)}
    later = rss[1:]
    log({"rss_per_job": {"mb_after_job": rss,
                         "mb_per_job_after_the_first":
                         (later[-1] - later[0]) / max(len(later) - 1, 1)}})
    return launches, static_rows


# ------------------------------------------------------------ phase 11


# phase 11: the multi-device axes on meshes of logical shards over the
# card's one device (parallel/mesh.LOGICAL_DEVICES_ENV = MESH_DEVICES).
# The shards share one H100, so these runs prove the code paths and claim
# no scaling. Data axis: phase 2's graph with pipeline_instances_per_node
# DATA_SHARDS; static multi-host: SLICE_JOBS of phase 10's jobs over two
# processes (RANK/WORLD_SIZE); spatial: Blur(SP_BLUR_K) -> ConvertToHSV on
# SP_FRAMES 1080p frames in chunks of SP_CHUNK; pipeline: phase 7's OpenPose
# at 640x480 with PP_STAGES stages; expert: MoEHead (MOE_DIMS) over
# MOE_ROWS seeded rows in chunks of MOE_CHUNK, and DetectClothing over the
# face video's frames with EP_BOXES fixed boxes a frame; tensor: TP_NET at
# TP_BATCH with a model axis of TP_MODEL; the dry run on DRY_DEVICES.
MESH_DEVICES = 8
DATA_SHARDS = 4
SLICE_JOBS = 4
SP_SHARDS, SP_BLUR_K, SP_FRAMES, SP_CHUNK = 4, 5, 8, 4
PP_STAGES = 5
EP_SHARDS_MOE, EP_SHARDS_CLOTHING = 4, 8
MOE_ROWS, MOE_CHUNK = 256, 64
EP_MOE_RTOL = 1e-5  # products batched over E/n experts: another order
EP_FRAMES, EP_BOXES = 16, ((0.1, 0.1, 0.5, 0.9), (0.45, 0.2, 0.95, 0.8))
TP_NET, TP_BATCH, TP_MODEL = "gender_levi_hassner", 16, 2
DRY_DEVICES = 4
DRY_RTOL = 1e-3  # bfloat16 convolutions: a data row's batch slice apart
PHASE11_SECONDS = 120.0  # the phase's wall-time limit


def _mesh_names(devices) -> list:
    return [str(d) for d in devices]


def _axes_engaged(sc, axis: str, what: str) -> dict:
    """The profiler's counts of ``axis``; raises unless it engaged and
    never fell back."""
    counts = sc.profiler.counts()
    got = {"engaged": counts.get(f"axis:{axis}:engaged", 0),
           "not_engaged": counts.get(f"axis:{axis}:not_engaged", 0)}
    if got["not_engaged"] or not got["engaged"]:
        raise AssertionError(f"{what}: the {axis} axis counts {got}")
    return got


class NoiseDecoder(SyntheticDecoder):
    """Seeded random RGB frames (drawn once per process), so that a blur
    and a colour conversion have texture to work on."""

    i420_supported = False
    _drawn = {}

    def read_frames(self, rows, out=None):
        key = (self.n, self.h, self.w)
        if key not in self._drawn:
            self._drawn[key] = np.random.default_rng(11).integers(
                0, 256, (self.n, self.h, self.w, 3), np.uint8)
        data = self._drawn[key][list(rows)]
        if out is None:
            return data
        out[...] = data
        return out


def run_data_axis(db: str, phase2: dict) -> dict:
    """Phase 2's graph, RGB and I420, over a data mesh of DATA_SHARDS
    logical shards -> {kernel: launches}."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.parallel.sharded import data_mesh

    mesh = data_mesh(DATA_SHARDS, DEVICE).names()
    stream_cls = synthetic_stream_class(
        N_FRAMES, HEIGHT, WIDTH,
        lambda: SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH))
    launches = {"hist_rgb": 0, "hist_i420": 0}
    chunks = -(-N_FRAMES // CHUNK)
    for ingest in ("rgb", "i420"):
        sc = _client(os.path.join(db, f"data_{ingest}"))
        hist = sc.ops.Histogram(frame=sc.io.Input([stream_cls(sc, "v")]))
        bounds = sc.ops.ShotBoundaries(histograms=hist)
        hist_out, shots_out = (st.NamedStream(sc, "hist"),
                               st.NamedStream(sc, "shots"))
        H.hist_rgb.launches = H.hist_i420.launches = 0
        _sync()
        t0 = time.perf_counter()
        sc.run(sc.io.Output([hist, bounds], [(hist_out, shots_out)]),
               st.PerfParams.manual(work_packet_size=CHUNK, ingest=ingest,
                                    pipeline_instances_per_node=DATA_SHARDS),
               cache_mode=st.CacheMode.Overwrite)
        _sync()
        seconds = time.perf_counter() - t0
        got = {"hist_rgb": H.hist_rgb.launches,
               "hist_i420": H.hist_i420.launches}
        cuts = next(shots_out.load(rows=[0]))
        rows = np.stack([np.stack(r) for r in hist_out.load()])
        axes = _axes_engaged(sc, "data", f"data axis {ingest}")
        log({"run": "data_axis", "ingest": ingest, "mesh": mesh,
             "frames": N_FRAMES, "seconds": seconds,
             "frames_per_s": N_FRAMES / seconds,
             "phase2_frames_per_s": phase2[ingest]["frames_per_s"],
             "boundaries": cuts, "launches": got, "axis_counts": axes})
        kernel = "hist_rgb" if ingest == "rgb" else "hist_i420"
        other = "hist_i420" if ingest == "rgb" else "hist_rgb"
        if cuts != list(CUTS):
            raise AssertionError(f"data axis {ingest}: boundaries {cuts}")
        if not np.array_equal(rows, phase2[ingest]["rows"]):
            raise AssertionError(f"data axis {ingest}: rows differ from "
                                 "phase 2's unsharded rows")
        if got[kernel] != DATA_SHARDS * chunks or got[other]:
            raise AssertionError(f"data axis {ingest}: launches {got}, want "
                                 f"{DATA_SHARDS} a chunk of {kernel}")
        launches[kernel] += got[kernel]
    return launches


def sharded_segment_timing(db: str) -> dict:
    """The executor's Histogram segment on one 1080p CHUNK-frame RGB chunk
    over a data mesh of DATA_SHARDS (the frames padded and windowed, a
    hist_rgb launch a shard, the rows gathered on the client's device),
    against the same segment unsharded: both through the executor's own
    segment runner, with the same byte bound (each byte read once, the
    rows written once)."""
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.graph import InputNode, NodeOutput, OpNode
    from scannertools_tpu_torch.parallel.sharded import data_mesh
    from scannertools_tpu_torch.runtime.context import OpContext
    from scannertools_tpu_torch.runtime.executor import Executor, _Value
    from scannertools_tpu_torch.utils.framechunk import FrameChunk

    dec = NoiseDecoder(CHUNK, HEIGHT, WIDTH)
    chunk = FrameChunk.from_hwc(dec.read_frames(range(CHUNK))).device(
        "cuda")
    src = InputNode([])
    node = OpNode("Histogram", {"frame": NodeOutput(src, 0)}, {})
    need = {src.id: (0, 0), node.id: (0, 0)}
    ex = Executor(st.Client(db_path=os.path.join(db, "segment")))
    ctx = OpContext(profiler=ex.profiler, device=ex.device)
    mesh = data_mesh(DATA_SHARDS, "cuda")

    def segment(m):
        ex._mesh = m
        values = {(src.id, 0): _Value(chunk, 0, 0, True)}
        ex._run_device_segment([node], need, values, ctx, CHUNK)
        return values[(node.id, 0)].data

    got, want = segment(mesh), segment(None)
    err = int((got.long() - want.long()).abs().max())
    nbytes = CHUNK * chunk.npix
    bound, by = bound_ms(nbytes + CHUNK * 3 * 16 * 4, nbytes)
    rec = {"timing": "histogram_segment_sharded", "mesh": mesh.names(),
           "shape": [CHUNK, HEIGHT, WIDTH],
           "ms": time_ms(lambda: segment(mesh)),
           "device_ms": time_ms(lambda: segment(mesh), fence=True),
           "unsharded_ms": time_ms(lambda: segment(None)),
           "unsharded_device_ms": time_ms(lambda: segment(None),
                                          fence=True),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err}
    log(rec)
    if err:
        raise AssertionError(f"the sharded Histogram segment differs from "
                             f"the unsharded one by {err}")
    return rec


def static_slice_worker(db: str, device: str = "cuda") -> int:
    """``chip_smoke.py --static-slice DB``: the first SLICE_JOBS of phase
    10's jobs with static distribution, under this process's RANK and
    WORLD_SIZE. Prints one JSON line: the jobs it committed and its
    launches."""
    global DEVICE
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H

    DEVICE = device
    sc = _client(db)
    out, _ = job_graph(sc, "slices", range(SLICE_JOBS))
    ran = []
    _logging_run_job(ran.append)
    H.hist_rgb.launches = 0
    sc.run(out, job_perf(), cache_mode=st.CacheMode.Overwrite)
    _sync()
    log({"worker": "static_slice", "rank": int(os.environ["RANK"]),
         "world_size": int(os.environ["WORLD_SIZE"]), "jobs": ran,
         "hist_rgb": H.hist_rgb.launches})
    return 0


def run_static_slices(db: str, static_rows: list) -> int:
    """Two processes (RANK 0 and 1 of WORLD_SIZE 2) over SLICE_JOBS jobs
    into one db -> their hist_rgb launches; the union of their rows must
    equal phase 10's static rows."""
    import subprocess

    d = os.path.join(db, "slices")
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--static-slice", d,
             DEVICE], env=env, stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__))))
    lines = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"static slice worker exit {p.returncode}")
        lines.append(json.loads(out.strip().splitlines()[-1]))
    sc = _client(d)
    _, sinks = job_graph(sc, "slices", range(SLICE_JOBS))
    rows = job_rows(sinks)
    jobs = [ln["jobs"] for ln in lines]
    per = -(-SLICE_JOBS // 2)
    log({"run": "static_slices",
         "mesh": _mesh_names(local_mesh_devices()[:1] * 2),
         "workers": lines, "rows_equal_static":
         rows == static_rows[:SLICE_JOBS]})
    if jobs != [list(range(0, per)), list(range(per, SLICE_JOBS))]:
        raise AssertionError(f"static slices: jobs {jobs}")
    if rows != static_rows[:SLICE_JOBS]:
        raise AssertionError("static slices: rows differ from phase 10's "
                             "static run")
    return sum(ln["hist_rgb"] for ln in lines)


def run_spatial_axis(db: str) -> dict:
    """Blur(SP_BLUR_K) -> ConvertToHSV at 1080p, spatial_shards=SP_SHARDS
    against unsharded: both outputs bit-equal."""
    import scannertools_tpu_torch as st

    stream_cls = synthetic_stream_class(
        SP_FRAMES, HEIGHT, WIDTH,
        lambda: NoiseDecoder(SP_FRAMES, HEIGHT, WIDTH))
    outs, per = {}, {}
    for shards in (SP_SHARDS, 0):
        sc = _client(os.path.join(db, f"sp{shards}"))
        blur = sc.ops.Blur(frame=sc.io.Input([stream_cls(sc, "v")]),
                           kernel_size=SP_BLUR_K)
        hsv = sc.ops.ConvertToHSV(frame=blur)
        sinks = (st.NamedStream(sc, "blur"), st.NamedStream(sc, "hsv"))
        _sync()
        t0 = time.perf_counter()
        sc.run(sc.io.Output([blur, hsv], [sinks]),
               st.PerfParams.manual(work_packet_size=SP_CHUNK, ingest="rgb",
                                    spatial_shards=shards),
               cache_mode=st.CacheMode.Overwrite)
        _sync()
        per[shards] = time.perf_counter() - t0
        outs[shards] = [np.stack(list(s.load())) for s in sinks]
        if shards:
            axes = _axes_engaged(sc, "sp", "spatial axis")
    equal = all(np.array_equal(a, b) for a, b in zip(outs[SP_SHARDS],
                                                     outs[0]))
    log({"run": "spatial_axis", "mesh": _mesh_names(
        local_mesh_devices()[:SP_SHARDS]), "frames": SP_FRAMES,
         "height": HEIGHT, "width": WIDTH, "kernel_size": SP_BLUR_K,
         "seconds": per[SP_SHARDS], "unsharded_seconds": per[0],
         "bit_equal": equal, "axis_counts": axes})
    if not equal:
        raise AssertionError("spatial axis: output differs from unsharded")
    return {"seconds": per[SP_SHARDS], "unsharded_seconds": per[0]}


def local_mesh_devices() -> list:
    from scannertools_tpu_torch.parallel.mesh import local_devices

    return local_devices(DEVICE)


def _poses_close(got, want, atol: float = 1e-4) -> bool:
    """The same people in every frame, keypoints and scores within
    ``atol`` (maps a microbatch at a time round otherwise)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if abs(a._score - b._score) > atol * max(1.0, abs(b._score)) or \
                    not np.allclose(a._kp, b._kp, rtol=0, atol=atol):
                return False
    return True


def run_pipeline_axis(db: str) -> dict:
    """OpenPose at 640x480 with pipeline_stages=PP_STAGES against the
    unpiped run on phase 7's weights: the body maps of a chunk within
    CARD_CPU_RTOL of the largest, the people found equal."""
    import torch

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.parallel.mesh import Mesh

    path = write_pose_weights(db)
    got, launches, runs = run_pose_graph(
        os.path.join(db, "pp"), path, perf_kw={"pipeline_stages":
                                                 PP_STAGES})
    want, _, ref_runs = run_pose_graph(os.path.join(db, "pp_ref"), path)
    state = {k: v.cuda() for k, v in pose_state().items()}
    x = (pose_frames(range(POSE_CHUNK)) / 256.0 - 0.5).permute(
        0, 3, 1, 2).contiguous()
    mesh = Mesh(local_mesh_devices()[:PP_STAGES], ("pipe",))
    with torch.no_grad():
        piped = PP.body_forward_pipelined(state, x, mesh)
        plain = PP.body_maps(state, x)
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(piped, plain))
        ms = time_ms(lambda: PP.body_forward_pipelined(state, x, mesh),
                     reps=3, warm=1)
        plain_ms = time_ms(lambda: PP.body_maps(state, x), reps=3, warm=1)
    people = _poses_close(got, want)
    chunks = -(-POSE_FRAMES // POSE_CHUNK)
    log({"run": "pipeline_axis", "mesh": mesh.names(), "stages": PP_STAGES,
         "frames": POSE_FRAMES, "people_per_frame": [len(f) for f in got],
         "people_equal": people, "maps_err_of_max": err,
         "chunk_body_ms": ms, "chunk_body_unpiped_ms": plain_ms,
         "seconds": runs[0]["seconds"], "unpiped_seconds":
         ref_runs[0]["seconds"], "launches": launches[0],
         "axis_counts": runs[0]["axis_counts"]})
    if not err <= CARD_CPU_RTOL:
        raise AssertionError(f"pipeline axis: maps differ by {err} of max")
    if not people or sum(map(len, got)) == 0:
        raise AssertionError("pipeline axis: people differ from unpiped")
    ax = runs[0]["axis_counts"]
    if ax["not_engaged"] or not ax["engaged"]:
        raise AssertionError(f"pipeline axis: counts {ax}")
    if launches[0]["pose_peaks"] != chunks:
        raise AssertionError(f"pipeline axis: launches {launches[0]}")
    return {"ms": ms, "plain_ms": plain_ms, **launches[0]}


# data axis over the nets: each graph of NET_GRAPHS over its first frames
# of the face video in its chunks, unsharded and with
# pipeline_instances_per_node=DATA_SHARDS on one Client (the weights moved
# to the card once). Launches a chunk of the sharded run: every shard
# launches its split segment's kernels (MTCNN's 4 nms and 2 crops, SSD's
# nms, Faster R-CNN's nms and RoIAlign, Mask R-CNN's 2 nms and 2 level
# crops, OpenPose's pose_peaks), and each face net its compaction crop once
# on the client's device. The float outputs of the sharded run are held to
# the unsharded run's within NET_RTOL of their largest value (another
# batch's cuDNN algorithms); counts, labels and keep sets exactly.
NET_GRAPHS = {
    "faces": (FACE_FRAMES, FACE_CHUNK,
              {"nms": 4 * DATA_SHARDS,
               "crop_and_resize": 2 * DATA_SHARDS + 2}),
    "objects": (16, DET_CHUNK, {"nms": DATA_SHARDS}),
    "frcnn": (16, DET_CHUNK, {"nms": DATA_SHARDS,
                              "crop_and_resize": DATA_SHARDS}),
    "maskrcnn": (DET_CHUNK, DET_CHUNK,
                 {"nms": 2 * DATA_SHARDS,
                  "crop_and_resize_levels": 2 * DATA_SHARDS}),
    "openpose": (POSE_FRAMES, POSE_CHUNK, {"pose_peaks": DATA_SHARDS}),
}
NET_RTOL = CARD_CPU_RTOL


def net_graph(sc, frame, name: str, weights: dict):
    """The output columns and stream names of data-axis graph ``name``:
    phase 4's MTCNN -> EmbedFaces and DetectGender, phase 5's two graphs,
    phase 6's R-50-FPN graph, phase 7's OpenPose."""
    from scannertools_tpu_torch.ops.faces import MAX_FACES

    if name == "faces":
        faces = sc.ops.MTCNNDetectFaces(frame=frame,
                                        weights_path=weights["mtcnn"],
                                        thresholds=FACE_THRESHOLDS)
        return [faces,
                sc.ops.EmbedFaces(frame=frame, bboxes=faces,
                                  weights_path=weights["facenet"],
                                  faces_budget=MAX_FACES),
                sc.ops.DetectGender(frame=frame, bboxes=faces,
                                    weights_path=weights["gender"],
                                    faces_budget=MAX_FACES)], \
            ["faces", "embs", "genders"]
    if name == "objects":
        return [sc.ops.DetectObjects(frame=frame,
                                     weights_path=weights["ssd"])], \
            ["objects"]
    if name == "frcnn":
        pre = sc.ops.NNInput(frame=frame, input_width=FRCNN_W,
                             input_height=FRCNN_H, mean_colors=FRCNN_MEAN)
        cls_prob, rois, fc7 = sc.ops.FasterRCNN(
            input=pre, weights_path=weights["faster_rcnn"])
        boxes, feats = sc.ops.FasterRCNNOutput(
            cls_prob=cls_prob, rois=rois, fc7=fc7,
            score_threshold=FRCNN_SCORE)
        return [boxes, feats], ["frcnn_boxes", "frcnn_feats"]
    if name == "maskrcnn":
        return [sc.ops.MaskRCNNDetectObjects(
            frame=frame, weights_path=weights["maskrcnn"], arch=MRCNN_ARCH,
            confidence_threshold=MRCNN_CONFIDENCE)], ["mrcnn"]
    return [pose_graph(sc, frame, "openpose", weights["openpose"])], \
        ["poses"]


def _net_launches() -> dict:
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP

    return {"nms": MC.nms.launches,
            "crop_and_resize": MC.crop_and_resize.launches,
            "crop_and_resize_levels": MC.crop_and_resize_levels.launches,
            "pose_peaks": PP.find_peaks.launches}


def _reset_net_launches() -> None:
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP

    MC.nms.launches = MC.crop_and_resize.launches = 0
    MC.crop_and_resize_levels.launches = PP.find_peaks.launches = 0


def _element_parts(el):
    """A stored element -> (what must be equal, its float values)."""
    if isinstance(el, np.ndarray):
        return ("array", el.shape), el.astype(np.float64).ravel()
    if isinstance(el, str):
        return el, np.zeros(0)
    if isinstance(el, dict):  # a Mask R-CNN detection
        (lab, box), mask = _element_parts(el["bbox"]), el["mask"]
        return (lab, mask.shape), np.concatenate([box, mask.ravel()])
    if hasattr(el, "_kp"):  # a Pose
        return ("pose", el._kp.shape), np.concatenate(
            [[el._score], np.asarray(el._kp, np.float64).ravel()])
    return el.label, np.array([el.x1, el.y1, el.x2, el.y2, el.score])


def _net_rows_compare(got: list, want: list) -> dict:
    """One stream's rows of the sharded run against the unsharded run's
    -> {"count", "equal" (lengths, labels, shapes), "err_of_max"}."""
    equal = len(got) == len(want)
    err, top, count = 0.0, 0.0, 0
    for g, w in zip(got, want):  # a frame's elements (array rows too)
        g, w = list(g), list(w)
        count += len(g)
        if len(g) != len(w):
            equal = False
            continue
        for a, b in zip(g, w):
            (ka, va), (kb, vb) = _element_parts(a), _element_parts(b)
            if ka != kb or va.shape != vb.shape:
                equal = False
                continue
            if vb.size:
                err = max(err, float(np.abs(va - vb).max()))
                top = max(top, float(np.abs(vb).max()))
    return {"count": count, "equal": equal,
            "err_of_max": err / top if top else err}


def run_net_data_axis(db: str, name: str, weights: dict) -> dict:
    """Graph ``name`` of NET_GRAPHS unsharded (a first run moves the
    weights to the card), with pipeline_instances_per_node=DATA_SHARDS,
    and unsharded again, on one Client -> the sharded run's launches.
    Raises unless the counts, labels and shapes equal the unsharded
    run's, the float outputs agree within NET_RTOL of their largest
    value, the data axis engaged on every chunk and never fell back, and
    the split segments launched their kernels on every shard."""
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.parallel.sharded import data_mesh

    frames, chunk, per_chunk = NET_GRAPHS[name]
    stream_cls = synthetic_stream_class(
        FACE_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(FACE_FRAMES, FACE_H, FACE_W))
    sc = _client(os.path.join(db, f"nets_{name}"))
    frame = sc.io.Input([stream_cls(sc, "net_video")])
    frame = sc.streams.Gather(frame, [list(range(frames))])
    cols, names = net_graph(sc, frame, name, weights)
    outs = [st.NamedStream(sc, n) for n in names]

    def run(inst: int):
        before = {k: len(sc.profiler.intervals(f"axis:data:{k}"))
                  for k in ("engaged", "not_engaged")}
        _reset_net_launches()
        _sync()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(cols, [tuple(outs)]),
               st.PerfParams.manual(work_packet_size=chunk, ingest="rgb",
                                    pipeline_instances_per_node=inst),
               cache_mode=st.CacheMode.Overwrite)
        _sync()
        seconds = time.perf_counter() - t0
        axis = {k: sc.profiler.intervals(f"axis:data:{k}")[n:]
                for k, n in before.items()}
        return ([list(o.load()) for o in outs], _net_launches(), seconds,
                axis)

    run(1)
    got, launches, seconds, axis = run(DATA_SHARDS)
    want, one_launches, one_seconds, _ = run(1)
    chunks = -(-frames // chunk)
    cmp = {n: _net_rows_compare(g, w) for n, g, w in zip(names, got, want)}
    engaged = {}
    for iv in axis["engaged"]:
        by = iv["meta"]["by"]
        engaged[by] = engaged.get(by, 0) + 1
    want_launches = {k: per_chunk.get(k, 0) * chunks for k in launches}
    rec = {"run": "data_axis_nets", "graph": name,
           "mesh": data_mesh(DATA_SHARDS, DEVICE).names(), "frames": frames,
           "chunk": chunk, "counts": {n: c["count"] for n, c in cmp.items()},
           "counts_equal": all(c["equal"] for c in cmp.values()),
           "err_of_max": {n: c["err_of_max"] for n, c in cmp.items()},
           "axis_counts": {"engaged": engaged,
                           "not_engaged": len(axis["not_engaged"])},
           "launches": launches, "unsharded_launches": one_launches,
           "seconds": seconds, "unsharded_seconds": one_seconds}
    log(rec)
    if not rec["counts_equal"]:
        raise AssertionError(f"data axis {name}: counts, labels or shapes "
                             "differ from the unsharded run")
    worst = max(rec["err_of_max"].values())
    if not worst <= NET_RTOL:
        raise AssertionError(f"data axis {name}: outputs differ by {worst} "
                             "of their largest value")
    if axis["not_engaged"] or sum(engaged.values()) < chunks:
        raise AssertionError(f"data axis {name}: counts {rec['axis_counts']}")
    if launches != want_launches:
        raise AssertionError(f"data axis {name}: launches {launches}, want "
                             f"{want_launches}")
    return {k: launches[k] + one_launches[k] for k in launches}


def run_net_data_axes(db: str) -> dict:
    """Every graph of NET_GRAPHS on the weights phases 4-7 wrote into
    ``db`` -> {kernel: launches of the graphs' sharded and unsharded
    timed runs}."""
    weights = {k: os.path.join(db, f"{k}.npz") for k in
               ("mtcnn", "facenet", "gender", "ssd", "faster_rcnn",
                "maskrcnn", "openpose")}
    total: dict = {}
    for name in NET_GRAPHS:
        for k, n in run_net_data_axis(db, name, weights).items():
            total[k] = total.get(k, 0) + n
    return total


def run_expert_axis(db: str) -> dict:
    """MoEHead with expert_shards=EP_SHARDS_MOE and DetectClothing with
    expert_shards=EP_SHARDS_CLOTHING, each against the unsharded run:
    MoEHead's dropped rows equal and its values within EP_MOE_RTOL of the
    largest, DetectClothing's rows equal."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.models import streetstyle as SS
    from scannertools_tpu_torch.parallel import expert as PE
    from scannertools_tpu_torch.parallel.mesh import Mesh
    from scannertools_tpu_torch.protobufs import BoundingBox

    e, f, hdim = MOE_DIMS
    x = np.random.default_rng(17).normal(size=(MOE_ROWS, f)).astype(
        np.float32)
    moe_rows, moe_s = {}, {}
    for shards in (EP_SHARDS_MOE, 0):
        sc = _client(os.path.join(db, f"moe{shards}"))
        y = sc.ops.MoEHead(input=sc.io.Input([st.PythonStream(list(x))]),
                           n_experts=e, d_model=f, d_hidden=hdim,
                           capacity_batch=MOE_CHUNK)
        out = st.NamedStream(sc, "moe")
        _sync()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(y, [out]),
               st.PerfParams.manual(work_packet_size=MOE_CHUNK,
                                    expert_shards=shards),
               cache_mode=st.CacheMode.Overwrite)
        _sync()
        moe_s[shards] = time.perf_counter() - t0
        moe_rows[shards] = np.stack(list(out.load()))
        if shards:
            moe_axes = _axes_engaged(sc, "expert", "MoEHead")

    boxes = [BoundingBox(x1=a, y1=b, x2=c, y2=d, score=1.0)
             for a, b, c, d in EP_BOXES]

    @st.register_python_op(name="SmokeFixedBoxes", outputs=("object",))
    def smoke_fixed_boxes(ctx, frames):
        return [list(boxes) for _ in range(len(frames))]

    stream_cls = synthetic_stream_class(
        EP_FRAMES, FACE_H, FACE_W,
        lambda: FaceDecoder(EP_FRAMES, FACE_H, FACE_W))
    cl_rows, cl_s = {}, {}
    for shards in (EP_SHARDS_CLOTHING, 0):
        sc = _client(os.path.join(db, f"cl{shards}"))
        frame = sc.io.Input([stream_cls(sc, "v")])
        cl = sc.ops.DetectClothing(
            frame=frame, bboxes=sc.ops.SmokeFixedBoxes(frames=frame),
            adjust_bboxes=False)
        out = st.NamedStream(sc, "clothing")
        _sync()
        t0 = time.perf_counter()
        sc.run(sc.io.Output(cl, [out]),
               st.PerfParams.manual(work_packet_size=FACE_CHUNK,
                                    ingest="rgb", expert_shards=shards),
               cache_mode=st.CacheMode.Overwrite)
        _sync()
        cl_s[shards] = time.perf_counter() - t0
        cl_rows[shards] = [[r.predictions.tolist() for r in row]
                           for row in out.load()]
        if shards:
            cl_axes = _axes_engaged(sc, "expert", "DetectClothing")

    # the expert forms alone on one chunk, timed beside the unsharded ones
    dev = torch.device(DEVICE)
    state = PE.MOE.to_flax(PE.init_moe_params(0, e, f, hdim))
    params = {k: torch.from_numpy(v).to(dev) for k, v in state.items()}
    xt = torch.from_numpy(x[:MOE_CHUNK]).to(dev)
    m_moe = Mesh(local_mesh_devices()[:EP_SHARDS_MOE], ("expert",))
    m_cl = Mesh(local_mesh_devices()[:EP_SHARDS_CLOTHING], ("expert",))
    w = torch.randn(16, SS.FEATURES, 12, device=dev) * 0.05
    b = torch.randn(16, 12, device=dev) * 0.05
    feat = torch.randn(FACE_CHUNK * len(EP_BOXES), SS.FEATURES, device=dev)
    timing = {
        "moe_ms": time_ms(lambda: PE.moe_apply(params, xt, m_moe,
                                               capacity=2 * MOE_CHUNK // e)),
        "moe_plain_ms": time_ms(lambda: PE.moe_reference(
            params, xt, capacity=2 * MOE_CHUNK // e)),
        "heads_ms": time_ms(lambda: SS.heads_apply_sharded(
            (w, b, None), feat, m_cl)),
        "heads_plain_ms": time_ms(lambda: SS.heads_logits((w, b, None),
                                                          feat))}
    dropped = [~r.any(axis=1) for r in (moe_rows[EP_SHARDS_MOE],
                                        moe_rows[0])]
    moe_err = float(np.abs(moe_rows[EP_SHARDS_MOE] - moe_rows[0]).max()) \
        / float(np.abs(moe_rows[0]).max())
    moe_close = np.array_equal(*dropped) and moe_err <= EP_MOE_RTOL
    cl_equal = cl_rows[EP_SHARDS_CLOTHING] == cl_rows[0]
    log({"run": "expert_axis", "moe_mesh": m_moe.names(),
         "clothing_mesh": m_cl.names(), "moe_rows": MOE_ROWS,
         "moe_dropped": int(dropped[1].sum()),
         "moe_drops_equal": np.array_equal(*dropped),
         "moe_err_of_max": moe_err,
         "clothing_frames": EP_FRAMES, "clothing_equal": cl_equal,
         "moe_seconds": moe_s, "clothing_seconds": cl_s,
         "moe_axis_counts": moe_axes, "clothing_axis_counts": cl_axes,
         **timing})
    if not moe_close:
        raise AssertionError(f"expert axis: MoEHead rows differ by "
                             f"{moe_err} of the largest, or drop others")
    if not cl_equal:
        raise AssertionError("expert axis: DetectClothing rows differ")
    return timing


def run_tensor_axis() -> dict:
    """tp_model(TP_NET) with a model axis of TP_MODEL against the plain
    forward: outputs within CARD_CPU_RTOL of the largest value."""
    import torch

    from scannertools_tpu_torch.ops.faces import _get_params
    from scannertools_tpu_torch.ops.nn_generic import get_model
    from scannertools_tpu_torch.parallel import model_sharding as MS
    from scannertools_tpu_torch.parallel.mesh import Mesh

    grid = np.empty((1, TP_MODEL), dtype=object)
    for i, d in enumerate(local_mesh_devices()[:TP_MODEL]):
        grid[0, i] = d
    mesh = Mesh(grid, ("data", "model"))
    sharded, run = MS.tp_model(TP_NET, mesh)
    model, fwd = get_model(TP_NET)
    state = {k: v.to(DEVICE) for k, v in _get_params(model, None).items()}
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (TP_BATCH, 227, 227, 3)).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        got, want = run(x), fwd(state, x)
        err = float((got - want).abs().max()) / float(want.abs().max())
        rec = {"run": "tensor_axis", "mesh": mesh.names(), "net": TP_NET,
               "batch": TP_BATCH, "split_weights": sum(
                   isinstance(v, MS.ColumnShards) for v in sharded.values()),
               "err_of_max": err, "ms": time_ms(lambda: run(x), reps=5),
               "plain_ms": time_ms(lambda: fwd(state, x), reps=5)}
    log(rec)
    if not err <= CARD_CPU_RTOL:
        raise AssertionError(f"tensor axis: outputs differ by {err} of max")
    return rec


def run_dry(db: str) -> dict:
    """run_dryrun(DRY_DEVICES)'s loss against one unsharded step on the
    same weights and data, and the pp/sp/ep goldens on the card."""
    from scannertools_tpu_torch.parallel import dryrun as D
    from scannertools_tpu_torch.parallel.mesh import make_mesh

    loss = D.run_dryrun(DRY_DEVICES, device=DEVICE)
    params = D.default_params(DEVICE)  # run_dryrun's weights
    frames, labels = D._data(16, 32)
    _, want = D.train_step(params, frames.to(DEVICE), labels.to(DEVICE))
    D.run_pp_sp_dryrun(MESH_DEVICES, device=DEVICE)
    rec = {"run": "dryrun", "mesh": make_mesh(DRY_DEVICES,
                                              device=DEVICE).names(),
           "loss": loss, "unsharded_loss": want,
           "rel_diff": abs(loss - want) / abs(want)}
    log(rec)
    if not rec["rel_diff"] <= DRY_RTOL:
        raise AssertionError(f"dry run: loss {loss} against {want}")
    return rec


def run_axes(db: str, phase2: dict, static_rows: list) -> dict:
    """Phase 11 -> {"launches": {kernel: n}, "records": {...}}; every check
    raises. The logical-device count is set for the phase only."""
    from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV

    before = os.environ.get(LOGICAL_DEVICES_ENV)
    os.environ[LOGICAL_DEVICES_ENV] = str(MESH_DEVICES)
    try:
        launches = run_data_axis(db, phase2)
        for k, n in run_net_data_axes(db).items():
            launches[k] = launches.get(k, 0) + n
        records = {"hist_rgb_sharded": sharded_segment_timing(db)}
        launches["hist_rgb"] += run_static_slices(db, static_rows)
        records["spatial"] = run_spatial_axis(db)
        pp = run_pipeline_axis(db)
        records["pipeline"] = pp
        launches["pose_peaks"] += pp["pose_peaks"]
        records["expert"] = run_expert_axis(db)
        records["tensor"] = run_tensor_axis()
        records["dryrun"] = run_dry(db)
    finally:
        if before is None:
            os.environ.pop(LOGICAL_DEVICES_ENV, None)
        else:
            os.environ[LOGICAL_DEVICES_ENV] = before
    return {"launches": launches, "records": records}


# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 12

EXAMPLES_HW = (480, 640)
EXAMPLES_FRAMES = 96  # stride 30 gives each net graph 4 frames
EXAMPLES_CUTS = [24, 48, 72]
# tag -> (example, its arguments with {video}, {db} and {npz} filled in,
# the streams it stores, whether they are one-row shot streams, whether
# it must keep a row): the six single-process examples of examples/, as
# a user runs them, on default weights; then the three whose default
# nets keep no row (faces, Faster R-CNN, pose) on EXAMPLES_NPZ's files
EXAMPLE_RUNS = {
    "shots": ("shot_detection.py", ["{video}"], ["example_shots"], True,
              True),
    "faces": ("face_pipeline.py", ["{video}"],
              ["demo_faces", "demo_embs", "demo_genders"], False, False),
    "ssd": ("object_detection.py", ["{video}", "--model", "ssd"],
            ["objdet_boxes"], False, True),
    "faster_rcnn": ("object_detection.py",
                    ["{video}", "--model", "faster_rcnn"],
                    ["frcnn_boxes", "frcnn_feats"], False, False),
    "pose": ("pose_pipeline.py", ["{video}", "--faces", "--hands"],
             ["pose_out"], False, False),
    "segmentation": ("segmentation.py", ["{video}"], ["demo_masks"], False,
                     True),
    "elastic": ("elastic_cluster.py", ["--db", "{db}", "{video}", "{video}"],
                ["shots_0", "shots_1"], True, True),
    "faces_npz": ("face_pipeline.py", ["{video}", "{npz}/mtcnn.npz"],
                  ["demo_faces", "demo_embs", "demo_genders"], False, True),
    "faster_rcnn_npz": ("object_detection.py",
                        ["{video}", "--model", "faster_rcnn", "--weights",
                         "{npz}/faster_rcnn.npz"],
                        ["frcnn_boxes", "frcnn_feats"], False, True),
    "pose_npz": ("pose_pipeline.py", ["{video}", "--faces", "--hands",
                                      "--weights", "{npz}/openpose.npz"],
                 ["pose_out"], False, True),
}
# EXAMPLES_NPZ's edits of the default draw
EXAMPLES_NPZ_FRCNN_BIAS = 20.0  # class 1's logit raised over random ones
EXAMPLES_NPZ_POSE_SCALE = 1000.0


# each kernel wrapper -> its plain version, by module
PLAIN_OF = {"nms": "nms_plain", "crop_and_resize": "crop_and_resize_plain",
            "crop_and_resize_levels": "crop_and_resize_levels_plain",
            "find_peaks": "find_peaks_plain", "hist_rgb": "hist_rgb_plain",
            "hist_i420": "hist_i420_plain"}


def _kernel_modules():
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import histogram as H

    return {"nms": MC, "crop_and_resize": MC, "crop_and_resize_levels": MC,
            "find_peaks": PP, "hist_rgb": H, "hist_i420": H}


def _example_launches() -> dict:
    return {k: getattr(m, k).launches
            for k, m in _kernel_modules().items()}


def _reset_example_launches() -> None:
    for k, m in _kernel_modules().items():
        getattr(m, k).launches = 0


@contextlib.contextmanager
def plain_kernels():
    """Every reference to a kernel wrapper in the port's loaded modules
    replaced by the wrapper's plain version (a sweep of the modules'
    globals, each module once whatever names it is loaded under)."""
    from unittest import mock

    plain = {id(getattr(m, k)): getattr(m, PLAIN_OF[k])
             for k, m in _kernel_modules().items()}
    seen = set()
    with contextlib.ExitStack() as stack:
        for name, mod in list(sys.modules.items()):
            if mod is None or id(mod) in seen or not (
                    getattr(mod, "__name__", "") or "").startswith(
                        "scannertools_tpu_torch"):
                continue
            seen.add(id(mod))
            for attr, val in list(vars(mod).items()):
                if id(val) in plain:
                    stack.enter_context(
                        mock.patch.object(mod, attr, plain[id(val)]))
        yield


def _plain_rows(x):
    """A stored row -> nested lists, dicts, bytes and numbers, equal for
    equal rows (numpy arrays by their dtype, shape and bytes)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain_rows(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "serialize") and hasattr(x, "pose_keypoints"):
        return x.serialize()
    if isinstance(x, dict):
        return {k: _plain_rows(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain_rows(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    return x


def examples_worker(out_json: str, video: str, workdir: str, npz: str,
                    device: str = "cuda") -> int:
    """This script's hidden ``--examples-worker`` mode: each example of
    EXAMPLE_RUNS under the ``scannertools_tpu`` alias on the card, once
    with the kernels (their launches counted from 0) and once with every
    kernel patched to its plain version -> a JSON of launches, rows
    equal, row counts and seconds a run. ``npz``: the directory of
    EXAMPLES_NPZ's files. ``device`` "cpu" (a rehearsal) points the
    examples' ``Client()`` at the CPU."""
    import runpy

    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch import client
    from scannertools_tpu_torch.tools import jax_alias

    if device != "cuda":
        resolve = client._resolve_device
        client._resolve_device = lambda d: resolve(device if d is None
                                                   else d)
    jax_alias.install()
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for tag, (script, args, names, one_row, _) in EXAMPLE_RUNS.items():
        path = os.path.join(here, "examples", script)
        rows, launches, seconds = {}, {}, {}
        for mode in ("kernels", "plain"):
            db = os.path.join(workdir, tag, mode)
            os.environ["SCANNERTOOLS_TPU_DB"] = os.path.join(db, "db")
            argv = [a.format(video=video, db=os.path.join(db, "edb"),
                             npz=npz) for a in args]
            sys.argv = [path, *argv]
            _reset_example_launches()
            t0 = time.perf_counter()
            with plain_kernels() if mode == "plain" else \
                    contextlib.nullcontext():
                with contextlib.redirect_stdout(sys.stderr):
                    runpy.run_path(path, run_name="__main__")
            if device == "cuda":
                torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - t0
            launches[mode] = _example_launches()
            sc = st.Client(db_path=os.path.join(db, "edb") if "{db}" in
                           args else os.path.join(db, "db"), device=device)
            rows[mode] = {n: list(st.NamedStream(sc, n).load(
                rows=[0] if one_row else None)) for n in names}
        out[tag] = {
            "seconds": seconds, "launches": launches["kernels"],
            "plain_launches": launches["plain"],
            "rows_equal_plain": _plain_rows(rows["kernels"])
            == _plain_rows(rows["plain"]),
            "rows": {n: [len(r) if isinstance(r, (list, np.ndarray))
                         else r for r in v]
                     for n, v in rows["kernels"].items()},
            "cuts": {n: [list(map(int, r)) for r in v]
                     for n, v in rows["kernels"].items()} if one_row
            else None}
    loaded = jax_alias.jax_package_modules()
    with open(out_json, "w") as f:
        json.dump({"runs": out, "jax_modules": loaded}, f)
    return 0 if not loaded else 1


def write_examples_video(path: str) -> None:
    """A 96-frame 640x480 mp4v clip, cv2-written: four shots of 24 frames
    (cuts at 24, 48 and 72) with a moving white bar."""
    import cv2

    h, w = EXAMPLES_HW
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
    for i in range(EXAMPLES_FRAMES):
        f = np.zeros((h, w, 3), np.uint8)
        f[:] = COLORS[i // 24][::-1]
        x = (i * 6) % (w - 40)
        f[h // 4:3 * h // 4, x:x + 40] = 255
        vw.write(f)
    vw.release()


def write_examples_npz(d: str) -> None:
    """The weights files of the ``*_npz`` example runs, each the default
    draw (drawn on the card) with the edits tests/test_torch_examples.py
    makes, so that random nets keep rows: MTCNN's face-class biases
    raised (faces pass 0.45, 0.6 and 0.7), Faster R-CNN's class-1 logit
    raised by EXAMPLES_NPZ_FRCNN_BIAS (every RoI scores above 0.7), the
    OpenPose body's last-stage output layers scaled by
    EXAMPLES_NPZ_POSE_SCALE (PAF and heat peaks pass the thresholds).
    Written in ``save_params``'s layout (``weights._flatten``'s keys) but
    stored uncompressed: its zlib pass takes about 50 s on Faster R-CNN's
    553 MB."""
    import torch

    from scannertools_tpu_torch.models import (faster_rcnn, jax_random,
                                               mtcnn, pose, weights)

    key = jax_random.prng_key(0, DEVICE)
    trees = {"mtcnn": mtcnn.default_tree(key),
             "faster_rcnn": faster_rcnn.default_tree(key),
             "openpose": pose.default_tree(key)}
    for net, head in (("pnet", "conv4_1"), ("rnet", "fc2_1"),
                      ("onet", "fc2_1")):
        trees["mtcnn"][net][head]["bias"] = torch.tensor([-1.5, 1.5])
    trees["faster_rcnn"]["params"]["cls_score"]["bias"][1] += \
        EXAMPLES_NPZ_FRCNN_BIAS
    for layer in ("s5_L1_6", "s5_L2_6"):  # Mconv7_stage6_L1 and _L2
        trees["openpose"]["params"][layer]["kernel"] *= \
            EXAMPLES_NPZ_POSE_SCALE
    os.makedirs(d, exist_ok=True)
    for name, tree in trees.items():
        np.savez(os.path.join(d, f"{name}.npz"), **weights._flatten(
            tree, leaf=lambda t: t.detach().cpu().numpy()))


def check_default_weights() -> dict:
    """Every family's default weights drawn on the card and held to the
    committed digest of the JAX package's draw -> {family: draw ms}."""
    import torch

    from scannertools_tpu_torch.tools import jax_defaults as JDF

    ref = JDF.load_reference()
    out, name = {}, card()
    for family in JDF.FAMILIES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = JDF.draw(family, "cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        leaves = JDF.flat(tree)
        if any(v.device.type != "cuda" for v in leaves.values()):
            raise AssertionError(f"{family}: a leaf was drawn off the card")
        worst = JDF.check_digest(JDF.digest(tree), ref[family])
        n = sum(v.numel() for v in leaves.values())
        out[family] = ms
        log({"default_weights": family, "leaves": len(leaves),
             "parameters": n, "draw_ms": ms, "worst_over_scale": worst,
             "card": name})
        del tree, leaves
    torch.cuda.empty_cache()
    return out


def run_examples(db: str) -> dict:
    """Phase 12 -> {kernel: launches of the examples' kernel runs}; every
    check raises."""
    import subprocess

    draw_ms = check_default_weights()
    video = os.path.join(db, "examples.mp4")
    write_examples_video(video)
    npz = os.path.join(db, "examples_npz")
    t0 = time.perf_counter()
    write_examples_npz(npz)
    log({"examples_npz_seconds": time.perf_counter() - t0})
    out_json = os.path.join(db, "examples.json")
    log_path = os.path.join(db, "examples_worker.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--examples-worker",
             out_json, video, os.path.join(db, "examples"), npz, DEVICE],
            stdout=f, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=600)
        finally:
            _reap(proc)
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            raise AssertionError(f"examples worker rc {rc}:\n"
                                 + f.read()[-4000:])
    with open(out_json) as f:
        result = json.load(f)
    runs = result["runs"]
    log({"run": "examples", "seconds": seconds, "draw_ms": draw_ms,
         "runs": runs})
    if result["jax_modules"]:
        raise AssertionError(f"the alias loaded {result['jax_modules']}")
    for tag, r in runs.items():
        if not r["rows_equal_plain"]:
            raise AssertionError(f"{tag}: rows differ from the plain "
                                 f"kernels' run")
        if any(r["plain_launches"].values()):
            raise AssertionError(f"{tag}: the plain run launched "
                                 f"{r['plain_launches']}")
        if r["cuts"] is not None and any(
                v != [EXAMPLES_CUTS] for v in r["cuts"].values()):
            raise AssertionError(f"{tag}: cuts {r['cuts']}")
        keeps = EXAMPLE_RUNS[tag][4]
        for name, counts in r["rows"].items():
            if any(counts):
                continue
            if keeps:
                raise AssertionError(f"{tag}: {name} keeps no row, so "
                                     f"its equality with the plain run "
                                     f"shows nothing")
            log({"examples_note": f"{EXAMPLE_RUNS[tag][0]}: "
                 f"{name} keeps no row on default weights "
                 f"({len(counts)} frames)"})
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in PLAIN_OF}
    need = {"hist": total["hist_rgb"] + total["hist_i420"],
            "nms": total["nms"],
            "crop": total["crop_and_resize"]
            + total["crop_and_resize_levels"],
            "pose_peaks": total["find_peaks"]}
    if not all(need.values()):
        raise AssertionError(f"examples: a kernel never launched: {need}")
    log({"examples_launches": total})
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from scannertools_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    log({"phase": "build", "sources": build.sources(),
         "seconds": time.perf_counter() - t0})

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log({"phase": name, "seconds": time.perf_counter() - t0})
        return out

    records = phase("1: histograms", check_kernels)
    records["flow_update"] = phase("1: flow_update", check_flow_update)
    records["nms"] = phase("1: nms", check_nms)
    records["crop_and_resize"] = phase("1: crop", check_crop)
    phase("1: level crop", check_level_crop)

    db = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        launches, phase2 = phase("2: shot detection", run_pipeline, db)
        flow_launches = phase("3: flow", run_flow_pipeline, db)
        face_launches = phase("4: faces", run_face_pipeline, db)
        det_launches = phase("5: detection", run_detection_pipeline, db)
        mrcnn_launches = phase("6: Mask R-CNN", run_maskrcnn_pipeline, db)
        pose_launches, records["pose_peaks"], gray = phase(
            "7: pose", run_pose_pipeline, db)
        attr_launches = phase("8: attributes", run_attribute_pipeline, db)
        rest_launches, records["ctc_viterbi"] = phase(
            "9: runners, storage, CTC", run_port_rest, db)
        job_launches, static_rows = phase("10: job layer, weights in",
                                          run_job_layer, db)
        t11 = time.perf_counter()
        axes = phase("11: multi-device axes", run_axes, db, phase2,
                     static_rows)
        if time.perf_counter() - t11 > PHASE11_SECONDS:
            raise AssertionError(f"phase 11 took over {PHASE11_SECONDS} s")
        ex_launches = phase("12: default weights, examples", run_examples,
                            db)
    finally:
        shutil.rmtree(db, ignore_errors=True)

    log({"launches_by_path": {"faces": face_launches,
                              "detection": det_launches,
                              "maskrcnn": mrcnn_launches,
                              "pose": pose_launches,
                              "attributes": attr_launches,
                              "runners_storage_ctc": rest_launches,
                              "job_layer_weights_in": job_launches,
                              "axes": axes["launches"],
                              "examples": ex_launches}})
    job_hist = sum(v.get("hist_rgb", 0) for v in job_launches.values())
    log({"timing": "crop_and_resize", "call": "pose_gray_hands", **gray})
    kernels = [
        {"name": "hist_rgb", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/histogram.cu",
         "replaces": "scannertools_tpu/ops/histogram.py:168",
         "launches": (launches["rgb"]["hist_rgb"] + job_hist
                      + axes["launches"]["hist_rgb"]
                      + ex_launches["hist_rgb"]),
         **records["hist_rgb"],
         "library_ms": None},
        {"name": "hist_i420", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/histogram.cu",
         "replaces": "scannertools_tpu/ops/histogram.py:260",
         "launches": (launches["i420"]["hist_i420"]
                      + axes["launches"]["hist_i420"]
                      + ex_launches["hist_i420"]),
         **records["hist_i420"],
         "library_ms": None},
        {"name": "flow_update", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/flow.cu",
         "replaces": "scannertools_tpu/ops/optical_flow.py:244",
         "launches": flow_launches, **records["flow_update"],
         "library_ms": None},
        # no torchvision on the card's machine: no library NMS to time
        {"name": "nms", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/nms.cu",
         "replaces": "scannertools_tpu/models/common.py:33",
         "launches": (face_launches["nms"] + det_launches["nms"]
                      + mrcnn_launches["nms"] + attr_launches["nms"]
                      + job_launches["weights_in"]["nms"]
                      + axes["launches"]["nms"] + ex_launches["nms"]),
         **records["nms"],
         "library_ms": None},
        {"name": "crop_and_resize", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/crop_resize.cu",
         "replaces": "scannertools_tpu/models/common.py:105",
         # the level crop (Mask R-CNN's) and the gray mode (OpenPose's)
         # are the same kernel source
         "launches": (face_launches["crop_and_resize"]
                      + det_launches["crop_and_resize"]
                      + mrcnn_launches["crop_and_resize"]
                      + mrcnn_launches["crop_and_resize_levels"]
                      + pose_launches["crop_and_resize"]
                      + attr_launches["crop_and_resize"]
                      + axes["launches"]["crop_and_resize"]
                      + axes["launches"]["crop_and_resize_levels"]
                      + ex_launches["crop_and_resize"]
                      + ex_launches["crop_and_resize_levels"]),
         **records["crop_and_resize"]},
        # no single torch call finds local maxima with top_k's tie order;
        # yardstick_ms: max_pool2d -> where -> topk, the same peaks
        {"name": "pose_peaks", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/peaks.cu",
         "replaces": "scannertools_tpu/models/pose.py:363",
         "launches": (pose_launches["pose_peaks"]
                      + job_launches["weights_in"]["pose_peaks"]
                      + axes["launches"]["pose_peaks"]
                      + ex_launches["find_peaks"]),
         **records["pose_peaks"],
         "library_ms": None},
        # ctc_loss sums paths (log-sum-exp); no torch call takes the best
        # path and its back-pointers
        {"name": "ctc_viterbi", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/ctc.cu",
         "replaces": "scannertools_tpu/ops/ctc_align.py:79",
         "launches": rest_launches["ctc"], **records["ctc_viterbi"],
         "library_ms": None},
    ]
    log({"kernels": kernels})
    print(card(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--claims-worker"]:
        sys.exit(claims_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--static-slice"]:
        sys.exit(static_slice_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--examples-worker"]:
        sys.exit(examples_worker(*sys.argv[2:]))
    sys.exit(main())
