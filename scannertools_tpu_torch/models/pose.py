"""Multi-person 2D pose estimation: the OpenPose/CPM two-branch network with
Part-Affinity-Field grouping, and the CMU face and hand crop networks.

Reference parity: the scannertools_caffe pose stack (CPM2 caffe forward,
cpm2_kernel.cpp:13-28; CPM2Output's multi-person PAF grouping,
cpm2_output_kernel_cpu.cpp:115-773) and the OpenPose wrapper op
(openpose_kernel.cpp). The algorithm is Cao et al., "Realtime Multi-Person
2D Pose Estimation using Part Affinity Fields" (CVPR 2017); COCO-18
keypoint order.

The JAX package's models/pose.py in torch, on NCHW maps:

  * ``OpenPoseBody(stages)`` and ``OpenPoseCrop(out_channels, stages)`` as
    ``nn.Module``s whose layers carry the caffe names of
    ``porting_maps.openpose_mapping``/``openpose_crop_mapping``, so that a
    pytorch-openpose state_dict loads by name; ``from_flax``/``to_flax``
    carry the JAX package's parameters across through the same maps.
  * ``find_peaks``: the 3x3 local maxima above THRE_PEAK and the top
    MAX_PEAKS of each part. For CUDA tensors it is the hand-written kernel
    ``pose_peaks`` (kernels/csrc/peaks.cu: a cluster of 8 blocks a part
    map, one row band each, 16-byte loads, candidates kept per warp
    against a running cut-off, merged in block rank 0's shared memory),
    one launch a chunk; CPU tensors take ``find_peaks_plain``, the JAX
    formula in torch (a -1 pad, eight ``>=`` tests, ``topk_stable``:
    ``torch.topk`` promises no order among ties), which the kernel equals
    bit for bit.
  * ``limb_scores``: the 10-point PAF line integral of every candidate
    limb, batched over the chunk, in plain torch. It gathers only the two
    PAF channels of each limb (the JAX package gathers all 38, then picks
    two: the same values).
  * ``infer_maps``, ``merge_scale_maps`` and ``device_stage`` through
    ``utils/numerics.resize_hw``, which computes ``jax.image.resize`` with
    ``antialias=False``. Every resize here either passes
    ``antialias=False`` in the JAX package (the scaled inputs) or
    upsamples (the maps), where antialiasing does nothing, so the two
    agree.
  * ``group_people``: the host grouping, copied (numpy).

The pipeline-parallel forms run the uniform refinement stages (the
body's stages 2..6, the crop nets' stages 2..6) one per device of a
'pipe' mesh on the GPipe schedule (parallel/pipeline_parallel), frames as
the microbatches; the front (VGG + CPM feature + stage 1) runs unsharded.
``RefineStage``/``_CropRefineStage`` apply one stage to the packed hidden
state (the stage's outputs, then the features), with the weights of
``refine_stage_params``/``crop_stage_params`` (the caffe names without
their stage number). ``PerfParams(pipeline_stages>=5)`` reaches them
through ``OpenPoseForward``/``OpenPoseDecode`` (``infer_maps``,
``device_stage`` and ``crop_keypoints`` take the mesh).
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import build as _build
from ..utils.numerics import div, mean, resize_hw
from . import porting_maps
from . import weights as weights_lib
from .common import _skeleton, apply_net, topk_stable

N_PARTS = 18       # COCO-18 (pose_detection.py:5)
N_HEAT = 19        # + background
N_LIMBS = 19
N_PAF = 38
MAX_PEAKS = 24     # static per-part peak capacity (peaks.cu's kMaxPeaks)
MAX_PEOPLE = 96    # cpm2_output emits <= 96 people
THRE_PEAK = 0.10   # heatmap peak threshold (OpenPose thre1)
THRE_PAF = 0.05    # PAF sample threshold (cpm2: inter threshold 0.05)
MIN_SAMPLES = 9    # of 10 integral samples (cpm2: min-count 9)
N_SAMPLES = 10
FACE_KEYPOINTS = 70
HAND_KEYPOINTS = 21

# COCO limb sequence, 0-indexed into the 18 keypoints, and the PAF channel
# pair feeding each limb (standard COCO OpenPose tables).
LIMB_SEQ = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
    (0, 15), (15, 17), (2, 16), (5, 17),
]
PAF_IDX = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
]


def _f32(x: float) -> float:
    """A threshold as the float32 the JAX package compares in."""
    return float(np.float32(x))


# ------------------------------------------------------------ networks

# VGG19's first ten convolutions (name, features, 2x2 max pool after)
_VGG = [("conv1_1", 64, False), ("conv1_2", 64, True),
        ("conv2_1", 128, False), ("conv2_2", 128, True),
        ("conv3_1", 256, False), ("conv3_2", 256, False),
        ("conv3_3", 256, False), ("conv3_4", 256, True),
        ("conv4_1", 512, False), ("conv4_2", 512, False)]
# the crop nets' front runs on to conv5_2
_CROP_VGG = _VGG + [("conv4_3", 512, False), ("conv4_4", 512, False),
                    ("conv5_1", 512, False), ("conv5_2", 512, False)]


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """flax's "SAME" convolution at stride 1 (odd k)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _front(net: nn.Module, table, x: torch.Tensor) -> torch.Tensor:
    for name, _, pool in table:
        x = torch.relu(getattr(net, name)(x))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x


def _add_front(net: nn.Module, table) -> None:
    cin = 3
    for name, f, _ in table:
        setattr(net, name, _conv(cin, f, 3))
        cin = f


class OpenPoseBody(nn.Module):
    """VGG19 (conv1_1..conv4_2) + the CPM feature convolutions + ``stages``
    two-branch stages (L1: PAFs, L2: heat maps). [B, 3, H, W] in [-0.5,
    0.5] -> (heat [B, 19, H/8, W/8], paf [B, 38, H/8, W/8])."""

    def __init__(self, stages: int = 6):
        super().__init__()
        self.stages = stages
        _add_front(self, _VGG)
        self.conv4_3_CPM = _conv(512, 256, 3)
        self.conv4_4_CPM = _conv(256, 128, 3)
        for tag, out in (("L1", N_PAF), ("L2", N_HEAT)):
            for j in range(1, 4):
                setattr(self, f"conv5_{j}_CPM_{tag}", _conv(128, 128, 3))
            setattr(self, f"conv5_4_CPM_{tag}", _conv(128, 512, 1))
            setattr(self, f"conv5_5_CPM_{tag}", _conv(512, out, 1))
            for s in range(2, stages + 1):
                for j in range(1, 6):
                    cin = N_PAF + N_HEAT + 128 if j == 1 else 128
                    setattr(self, f"Mconv{j}_stage{s}_{tag}",
                            _conv(cin, 128, 7))
                setattr(self, f"Mconv6_stage{s}_{tag}", _conv(128, 128, 1))
                setattr(self, f"Mconv7_stage{s}_{tag}", _conv(128, out, 1))

    def _branch(self, h: torch.Tensor, stage: int, tag: str) -> torch.Tensor:
        if stage == 1:
            for j in range(1, 5):
                h = torch.relu(getattr(self, f"conv5_{j}_CPM_{tag}")(h))
            return getattr(self, f"conv5_5_CPM_{tag}")(h)
        for j in range(1, 7):
            h = torch.relu(getattr(self, f"Mconv{j}_stage{stage}_{tag}")(h))
        return getattr(self, f"Mconv7_stage{stage}_{tag}")(h)

    def forward(self, x):
        x = _front(self, _VGG, x)
        x = torch.relu(self.conv4_3_CPM(x))
        feat = torch.relu(self.conv4_4_CPM(x))
        paf = self._branch(feat, 1, "L1")
        heat = self._branch(feat, 1, "L2")
        for s in range(2, self.stages + 1):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf = self._branch(inp, s, "L1")
            heat = self._branch(inp, s, "L2")
        return heat, paf


class OpenPoseCrop(nn.Module):
    """The CMU single-person crop networks (face: 70 keypoints + background;
    hand: 21 + background): VGG19 to conv5_2, the conv5_3_CPM feature
    layer, a 1x1 stage-1 head, then ``stages - 1`` 7x7 refinement stages
    over [out, feat]. [B, 3, H, W] -> [B, out_channels, H/8, W/8]."""

    def __init__(self, out_channels: int, stages: int = 6):
        super().__init__()
        self.stages = stages
        _add_front(self, _CROP_VGG)
        self.conv5_3_CPM = _conv(512, 128, 3)
        self.conv6_1_CPM = _conv(128, 512, 1)
        self.conv6_2_CPM = _conv(512, out_channels, 1)
        for s in range(2, stages + 1):
            for j in range(1, 6):
                cin = out_channels + 128 if j == 1 else 128
                setattr(self, f"Mconv{j}_stage{s}", _conv(cin, 128, 7))
            setattr(self, f"Mconv6_stage{s}", _conv(128, 128, 1))
            setattr(self, f"Mconv7_stage{s}", _conv(128, out_channels, 1))

    def forward(self, x):
        feat = torch.relu(self.conv5_3_CPM(_front(self, _CROP_VGG, x)))
        out = self.conv6_2_CPM(torch.relu(self.conv6_1_CPM(feat)))
        for s in range(2, self.stages + 1):
            h = torch.cat([out, feat], dim=1)
            for j in range(1, 7):
                h = torch.relu(getattr(self, f"Mconv{j}_stage{s}")(h))
            out = getattr(self, f"Mconv7_stage{s}")(h)
        return out


class _BodyFront(nn.Module):
    """OpenPoseBody's front (VGG + CPM feature + stage 1), with the body's
    layer names, so that it applies a subset of the body's weights ->
    (paf, heat, feat)."""

    def __init__(self):
        super().__init__()
        _add_front(self, _VGG)
        self.conv4_3_CPM = _conv(512, 256, 3)
        self.conv4_4_CPM = _conv(256, 128, 3)
        for tag, out in (("L1", N_PAF), ("L2", N_HEAT)):
            for j in range(1, 4):
                setattr(self, f"conv5_{j}_CPM_{tag}", _conv(128, 128, 3))
            setattr(self, f"conv5_4_CPM_{tag}", _conv(128, 512, 1))
            setattr(self, f"conv5_5_CPM_{tag}", _conv(512, out, 1))

    _branch = OpenPoseBody._branch

    def forward(self, x):
        x = _front(self, _VGG, x)
        x = torch.relu(self.conv4_3_CPM(x))
        feat = torch.relu(self.conv4_4_CPM(x))
        return self._branch(feat, 1, "L1"), self._branch(feat, 1, "L2"), feat


class RefineStage(nn.Module):
    """One uniform OpenPose refinement stage (the body's stages 2..6 share
    this shape) over the packed hidden state ``[B, N_PAF + N_HEAT + 128,
    h, w]`` (paf ++ heat ++ feat): emits the new paf and heat with feat
    passed through, keeping the hidden shape uniform — the pipeline's
    stage function. Its layers are ``Mconv{j}_{L1,L2}``, the body's
    ``Mconv{j}_stage{s}_{L1,L2}`` without the stage (``refine_stage_params``)."""

    def __init__(self):
        super().__init__()
        for tag, out in (("L1", N_PAF), ("L2", N_HEAT)):
            for j in range(1, 6):
                cin = N_PAF + N_HEAT + 128 if j == 1 else 128
                setattr(self, f"Mconv{j}_{tag}", _conv(cin, 128, 7))
            setattr(self, f"Mconv6_{tag}", _conv(128, 128, 1))
            setattr(self, f"Mconv7_{tag}", _conv(128, out, 1))

    def forward(self, h):
        feat = h[:, N_PAF + N_HEAT:]
        outs = []
        for tag in ("L1", "L2"):
            a = h
            for j in range(1, 7):
                a = torch.relu(getattr(self, f"Mconv{j}_{tag}")(a))
            outs.append(getattr(self, f"Mconv7_{tag}")(a))
        return torch.cat(outs + [feat], dim=1)


def refine_stage_params(state, stages: int = 6) -> List[Dict]:
    """The body's refinement stages 2..``stages`` as RefineStage weights
    (``Mconv{j}_stage{s}_{tag}`` -> ``Mconv{j}_{tag}``), one dict a
    stage."""
    subs = []
    for s in range(2, stages + 1):
        sub = {}
        for tag in ("L1", "L2"):
            for j in range(1, 8):
                for p in ("weight", "bias"):
                    sub[f"Mconv{j}_{tag}.{p}"] = \
                        state[f"Mconv{j}_stage{s}_{tag}.{p}"]
        subs.append(sub)
    return subs


def _subset(state, cls, *init) -> Dict:
    keys = _skeleton(cls, *init).state_dict().keys()
    return {k: state[k] for k in keys}


def _pipelined(front_out, stacked, stage_cls, stage_init, pipe_mesh):
    from ..parallel.pipeline_parallel import pipeline_apply_traced

    h = torch.cat(front_out, dim=1)
    return pipeline_apply_traced(
        lambda p, hh: apply_net(stage_cls, p, hh, init=stage_init),
        stacked, h[:, None], pipe_mesh)[:, 0]


def body_forward_pipelined(state, x: torch.Tensor, pipe_mesh,
                           stages: int = 0):
    """OpenPoseBody's forward with its refinement stages one per device of
    ``pipe_mesh`` (a 'pipe' axis of stages - 1 devices): x [T, 3, H, W] ->
    (heat, paf) as ``body_maps``, the frames as the GPipe microbatches. The
    front runs unsharded (about 15% of the operations); the five 7x7
    refinement stages dominate, and each device holds one stage's
    weights."""
    from ..parallel.pipeline_parallel import stack_stage_params

    stages = stages or body_init(state)[0]
    front = apply_net(_BodyFront, _subset(state, _BodyFront), x)
    stacked = stack_stage_params(refine_stage_params(state, stages))
    out = _pipelined(front, stacked, RefineStage, (), pipe_mesh)
    return out[:, N_PAF:N_PAF + N_HEAT], out[:, :N_PAF]


def body_init(state) -> Tuple[int]:
    """OpenPoseBody's constructor arguments for a state_dict: (stages,)."""
    return (sum(1 for k in state if k.endswith("_L1.weight")
                and k.startswith("Mconv7_stage")) + 1,)


def crop_init(state) -> Tuple[int, int]:
    """OpenPoseCrop's constructor arguments for a state_dict:
    (out_channels, stages)."""
    return (int(state["conv6_2_CPM.bias"].shape[0]),
            sum(1 for k in state if k.startswith("Mconv7_stage")
                and k.endswith(".weight")) + 1)


def body_maps(state, x: torch.Tensor):
    """x [B, 3, H, W] in [-0.5, 0.5] -> (heat, paf) at H/8 x W/8, in full
    float32, with ``state``'s weights (on x's device)."""
    return apply_net(OpenPoseBody, state, x, init=body_init(state))


def crop_maps(state, x: torch.Tensor) -> torch.Tensor:
    return apply_net(OpenPoseCrop, state, x, init=crop_init(state))


# ------------------------------------------------------------ weights

def _flax_stages(variables, body: bool) -> int:
    p = variables["params"]
    if body:  # s0_* .. s{stages-1}_*
        return len({k.split("_")[0] for k in p if k[0] == "s"})
    return 1 + sum(1 for k in p if k.startswith("Mconv7_stage"))


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's OpenPoseBody variables -> an OpenPoseBody
    state_dict (caffe names, porting_maps.openpose_mapping)."""
    return weights_lib.flax_to_torch(variables, porting_maps.openpose_mapping(
        _flax_stages(variables, True)))


def to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(
        state, porting_maps.openpose_mapping(body_init(state)[0]))


def crop_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's OpenPoseCrop variables (face or hand) -> an
    OpenPoseCrop state_dict (porting_maps.openpose_crop_mapping)."""
    return weights_lib.flax_to_torch(
        variables, porting_maps.openpose_crop_mapping(
            _flax_stages(variables, False)))


def crop_to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(
        state, porting_maps.openpose_crop_mapping(crop_init(state)[1]))


def _init(cls, seed: int, *init) -> Dict[str, torch.Tensor]:
    shapes = {k: tuple(v.shape)
              for k, v in _skeleton(cls, *init).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))


def init_params(seed: int = 0, stages: int = 6) -> Dict[str, torch.Tensor]:
    """Deterministic random OpenPoseBody weights from a ``torch.Generator``
    seeded with ``seed`` (weights.init_state); not the JAX package's
    values."""
    return _init(OpenPoseBody, seed, stages)


def init_face_params(seed: int = 0, stages: int = 6):
    return _init(OpenPoseCrop, seed, FACE_KEYPOINTS + 1, stages)


def init_hand_params(seed: int = 0, stages: int = 6):
    return _init(OpenPoseCrop, seed, HAND_KEYPOINTS + 1, stages)


# the crop nets as the ops' weight loaders see a model: init_params,
# from_flax, to_flax
FACE_NET = types.SimpleNamespace(init_params=init_face_params,
                                 from_flax=crop_from_flax,
                                 to_flax=crop_to_flax)
HAND_NET = types.SimpleNamespace(init_params=init_hand_params,
                                 from_flax=crop_from_flax,
                                 to_flax=crop_to_flax)


class _CropFront(nn.Module):
    """OpenPoseCrop's front (VGG to conv5_2, conv5_3_CPM, the stage-1
    head) with the crop net's layer names -> (out, feat)."""

    def __init__(self, out_channels: int):
        super().__init__()
        _add_front(self, _CROP_VGG)
        self.conv5_3_CPM = _conv(512, 128, 3)
        self.conv6_1_CPM = _conv(128, 512, 1)
        self.conv6_2_CPM = _conv(512, out_channels, 1)

    def forward(self, x):
        feat = torch.relu(self.conv5_3_CPM(_front(self, _CROP_VGG, x)))
        return self.conv6_2_CPM(torch.relu(self.conv6_1_CPM(feat))), feat


class _CropRefineStage(nn.Module):
    """One uniform OpenPoseCrop refinement stage (stages 2..6) over the
    packed hidden ``[B, out_channels + 128, h, w]`` (out ++ feat): emits
    the new out with feat passed through. Layers ``Mconv{j}``
    (``crop_stage_params``)."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.out_channels = out_channels
        for j in range(1, 6):
            setattr(self, f"Mconv{j}",
                    _conv(out_channels + 128 if j == 1 else 128, 128, 7))
        self.Mconv6 = _conv(128, 128, 1)
        self.Mconv7 = _conv(128, out_channels, 1)

    def forward(self, h):
        a = h
        for j in range(1, 7):
            a = torch.relu(getattr(self, f"Mconv{j}")(a))
        return torch.cat([self.Mconv7(a), h[:, self.out_channels:]], dim=1)


def crop_stage_params(state, stages: int = 6) -> List[Dict]:
    """A crop net's refinement stages 2..``stages`` as _CropRefineStage
    weights (``Mconv{j}_stage{s}`` -> ``Mconv{j}``)."""
    return [{f"Mconv{j}.{p}": state[f"Mconv{j}_stage{s}.{p}"]
             for j in range(1, 8) for p in ("weight", "bias")}
            for s in range(2, stages + 1)]


def crop_forward_pipelined(state, x: torch.Tensor, pipe_mesh,
                           stages: int = 0) -> torch.Tensor:
    """OpenPoseCrop's forward with its ``stages - 1`` refinement stages one
    per device of ``pipe_mesh`` (the crops as the microbatches; the front
    unsharded, as ``body_forward_pipelined``): x [B, 3, H, W] -> the final
    maps [B, out_channels, H/8, W/8]."""
    from ..parallel.pipeline_parallel import stack_stage_params

    out_channels, n = crop_init(state)
    stages = stages or n
    front = apply_net(_CropFront, _subset(state, _CropFront, out_channels),
                      x, init=(out_channels,))
    stacked = stack_stage_params(crop_stage_params(state, stages))
    h = _pipelined(front, stacked, _CropRefineStage, (out_channels,),
                   pipe_mesh)
    return h[:, :out_channels]


def crop_keypoints(state, crops: torch.Tensor, n_kp: int,
                   pipe_mesh=None) -> torch.Tensor:
    """Single-person crops [B, H, W, 3] in [-0.5, 0.5] -> [B, n_kp, 3]: (x,
    y) crop-normalized in [0, 1] and the score, the per-channel argmax of
    the net's maps (the first index among equal values, as
    ``jnp.argmax``); the background channel dropped. ``pipe_mesh`` runs
    the refinement stages one per device (``crop_forward_pipelined``)."""
    x = crops.permute(0, 3, 1, 2)
    maps = (crop_maps(state, x) if pipe_mesh is None
            else crop_forward_pipelined(state, x, pipe_mesh))[:, :n_kp]
    b, _, mh, mw = maps.shape
    flat = maps.reshape(b, n_kp, mh * mw)
    idx = torch.argmax(flat, dim=-1)
    score = flat.gather(-1, idx[..., None])[..., 0]
    ys = div(torch.div(idx, mw, rounding_mode="floor").to(torch.float32), mh)
    xs = div((idx % mw).to(torch.float32), mw)
    return torch.stack([xs, ys, score], dim=-1)


# ------------------------------------------------------------ peaks

def _check_heat(heat: torch.Tensor, name: str) -> None:
    if heat.dim() != 4 or heat.shape[1] < N_PARTS:
        raise ValueError(f"{name}: heat must be [T, C >= {N_PARTS}, H, W], "
                         f"got {tuple(heat.shape)}")
    if heat.dtype != torch.float32 or not heat.is_contiguous():
        raise ValueError(f"{name}: heat must be contiguous float32, got "
                         f"{heat.dtype}")
    if heat.shape[2] * heat.shape[3] < MAX_PEAKS:
        raise ValueError(f"{name}: a map of {heat.shape[2]}x{heat.shape[3]} "
                         f"has fewer than {MAX_PEAKS} pixels")


def find_peaks_plain(heat: torch.Tensor):
    """The JAX package's find_peaks in plain torch, batched; see
    ``find_peaks``."""
    _check_heat(heat, "find_peaks_plain")
    t, _, h, w = heat.shape
    hm = heat[:, :N_PARTS]
    pad = F.pad(hm, (1, 1, 1, 1), value=-1.0)
    is_max = torch.ones_like(hm, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                is_max &= hm >= pad[:, :, 1 + dy:1 + dy + h,
                                    1 + dx:1 + dx + w]
    score = torch.where(is_max & (hm > _f32(THRE_PEAK)), hm, -1.0)
    top, idx = topk_stable(score.reshape(t, N_PARTS, h * w), MAX_PEAKS)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return torch.stack([xs, ys, top], dim=-1), top > 0


PEAKS_CLUSTER = 8  # blocks a part map (peaks.cu's kCluster)


@functools.cache
def _peaks_lib() -> ctypes.CDLL:
    lib = _build.load("peaks")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.st_pose_peaks.restype = i
    lib.st_pose_peaks.argtypes = [p, i, i, i, i, p, p, p]
    lib.st_pose_peaks_info.restype = i
    lib.st_pose_peaks_info.argtypes = [i, p]
    return lib


def find_peaks_info(vec: bool = True) -> dict:
    """The ``pose_peaks`` kernel's resources on the current card, for its
    16-byte (``vec``) or 4-byte form: registers a thread, static shared
    bytes and local (spill) bytes, blocks resident an SM, and clusters
    resident on the card (``cudaOccupancyMaxActiveClusters``)."""
    out = (ctypes.c_int * 5)()
    rc = _peaks_lib().st_pose_peaks_info(int(vec), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"find_peaks_info: CUDA error {rc}")
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "blocks_per_sm", "clusters"), out))


def find_peaks(heat: torch.Tensor):
    """heat [T, C, H, W] float32 (C >= 18, NCHW: the 18 part maps first) ->
    (peaks [T, 18, MAX_PEAKS, 3] float32 (x, y, score), valid [T, 18,
    MAX_PEAKS] bool = score > 0).

    A pixel is a peak when it is >= its 8 neighbours (-1 outside the map)
    and > THRE_PEAK; its score is its value, any other pixel's -1.0. The
    slots are ``jax.lax.top_k``'s over each part's flattened map: scores
    descending, equal scores by flat index ascending; so with fewer than
    MAX_PEAKS peaks the rest are the lowest indices that are not peaks,
    with score -1.0.

    For CUDA tensors one launch of the ``pose_peaks`` kernel serves the
    chunk: a cluster of PEAKS_CLUSTER blocks a part map, each a band of
    rows, 16-byte loads where W % 4 == 0 and ``heat`` is 16-byte aligned
    (4-byte loads otherwise). CPU tensors take ``find_peaks_plain``."""
    _check_heat(heat, "find_peaks")
    if heat.device.type == "cpu":
        return find_peaks_plain(heat)
    if heat.device.type != "cuda":
        raise ValueError(f"find_peaks: unsupported device {heat.device}")
    t, c, h, w = heat.shape
    if h * w > 2**31 - 1 or t * N_PARTS * PEAKS_CLUSTER > 2**31 - 1:
        raise ValueError(f"find_peaks: heat {tuple(heat.shape)} exceeds the "
                         f"kernel's 32-bit indices")
    peaks = torch.empty((t, N_PARTS, MAX_PEAKS, 3), dtype=torch.float32,
                        device=heat.device)
    valid = torch.empty((t, N_PARTS, MAX_PEAKS), dtype=torch.bool,
                        device=heat.device)
    if t == 0:
        return peaks, valid
    with torch.cuda.device(heat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _peaks_lib().st_pose_peaks(heat.data_ptr(), t, c, h, w,
                                        peaks.data_ptr(), valid.data_ptr(),
                                        stream)
    if rc != 0:
        raise RuntimeError(f"find_peaks: CUDA launch failed with error {rc}")
    find_peaks.launches += 1
    return peaks, valid


find_peaks.launches = 0


# ------------------------------------------------------------ limbs

@functools.cache
def _limb_tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """LIMB_SEQ's A and B parts and PAF_IDX's x and y channels on
    ``device``."""
    return tuple(torch.tensor(col, dtype=torch.int64, device=device)
                 for col in (*zip(*LIMB_SEQ), *zip(*PAF_IDX)))


def limb_scores(paf: torch.Tensor, peaks: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Line-integral scores of every candidate limb connection, for a chunk.

    paf [T, 38, H, W]; peaks [T, 18, K, 3]; valid [T, 18, K] -> [T,
    N_LIMBS, K, K] float32, -inf for infeasible pairs: the 10 samples at t
    = i / 10 from peak A towards B, rounded by floor(x + 0.5) and clamped
    to the map, each the dot of the limb's two PAF channels with the unit
    direction; feasible when all 10 exceed THRE_PAF, the peaks do not
    coincide and both are valid; the score is then the mean
    (cpm2_output_kernel_cpu.cpp:568-607). As jitted XLA computes the JAX
    package's formula: the division by 10 (the sample fractions and the
    mean) a product with its float32 reciprocal, and each sample position
    one fused multiply-add (a position on a half pixel rounds the same
    way, where two roundings would move it by one pixel).

    ``peaks``' coordinates must be whole pixels (as ``find_peaks`` gives
    them), below 2^24."""
    t, _, h, w = paf.shape
    a_idx, b_idx, cx_idx, cy_idx = _limb_tables(paf.device)
    pa, pb = peaks[:, a_idx], peaks[:, b_idx]  # [T, L, K, 3]
    va, vb = valid[:, a_idx], valid[:, b_idx]
    ax, ay = pa[..., :, None, 0], pa[..., :, None, 1]
    bx, by = pb[..., None, :, 0], pb[..., None, :, 1]
    dx = bx - ax  # [T, L, K, K]
    dy = by - ay
    raw_norm = torch.sqrt(dx * dx + dy * dy)
    norm = raw_norm + _f32(1e-8)
    ux, uy = dx / norm, dy / norm
    ts = div(torch.arange(N_SAMPLES, dtype=torch.float32,
                          device=paf.device), N_SAMPLES).double()
    # jitted XLA contracts ax + dx * ts into one fused multiply-add (one
    # rounding). In float64 the product and the sum of these whole-pixel
    # coordinates are exact, so one rounding to float32 gives its value.
    sx = (ax.double()[..., None] + dx.double()[..., None] * ts).float()
    sy = (ay.double()[..., None] + dy.double()[..., None] * ts).float()
    xi = torch.clamp(torch.floor(sx + 0.5), 0, w - 1).to(torch.int64)
    yi = torch.clamp(torch.floor(sy + 0.5), 0, h - 1).to(torch.int64)
    lin = yi * w + xi
    frame = torch.arange(t, device=paf.device)[:, None] * N_PAF
    shape = (t, N_LIMBS, 1, 1, 1)
    flat = paf.reshape(-1)
    fx = flat[((frame + cx_idx) * (h * w)).view(shape) + lin]
    fy = flat[((frame + cy_idx) * (h * w)).view(shape) + lin]
    dots = fx * ux[..., None] + fy * uy[..., None]
    n_good = (dots > _f32(THRE_PAF)).sum(dim=-1)
    mean_score = mean(dots, (4,))
    feasible = ((n_good > MIN_SAMPLES) & (raw_norm > _f32(1e-6))
                & va[..., :, None] & vb[..., None, :])
    return torch.where(feasible, mean_score, float("-inf"))


# ------------------------------------------------------------ maps

def _body(state, x: torch.Tensor, pipe_mesh):
    return body_maps(state, x) if pipe_mesh is None \
        else body_forward_pipelined(state, x, pipe_mesh)


def infer_maps(state, x: torch.Tensor, out_hw: Tuple[int, int],
               upsample: str = "linear", pipe_mesh=None):
    """x [T, 3, H, W] in [-0.5, 0.5] -> (heat [T, 19, oh, ow], paf [T, 38,
    oh, ow]): the body net's maps resized to ``out_hw`` (the CPM2
    resized-heatmap contract), ``upsample`` "linear" or "cubic".
    ``pipe_mesh`` runs the refinement stages one per device
    (``body_forward_pipelined``)."""
    heat, paf = _body(state, x, pipe_mesh)
    oh, ow = out_hw
    return (resize_hw(heat, 2, oh, ow, upsample),
            resize_hw(paf, 2, oh, ow, upsample))


def merge_scale_maps(maps: List[torch.Tensor], out_hw: Tuple[int, int],
                     upsample: str = "linear") -> torch.Tensor:
    """The CMU multi-scale merge: each scale's raw net maps [T, C, h_s,
    w_s] (largest grid first) cubic-resized to the largest scale's grid,
    averaged there, then resized once to ``out_hw``."""
    _, _, bh, bw = maps[0].shape
    acc = maps[0]
    for m in maps[1:]:
        acc = acc + resize_hw(m, 2, bh, bw, "cubic")
    merged = div(acc, len(maps))
    if (bh, bw) == tuple(out_hw):
        return merged
    return resize_hw(merged, 2, out_hw[0], out_hw[1], upsample)


def device_stage(state, frames_f32: torch.Tensor,
                 scales: Tuple[float, ...] = (1.0,),
                 upsample: str = "linear", pipe_mesh=None):
    """The device side of a chunk: [T, H, W, 3] raw [0, 255] -> (peaks [T,
    18, K, 3], valid [T, 18, K], scores [T, L, K, K]). Preprocess as
    CPM2Input: / 256 - 0.5. Each scale runs the net at its own resolution
    (the scaled input resized linearly without antialiasing, as the JAX
    package asks) and the raw maps merge at the largest scale's grid
    (``merge_scale_maps``)."""
    x = (div(frames_f32, 256.0) - 0.5).permute(0, 3, 1, 2).contiguous()
    _, _, h, w = x.shape
    if len(scales) == 1 and scales[0] == 1.0:
        heat, paf = infer_maps(state, x, (h, w), upsample, pipe_mesh)
    else:
        heats, pafs = [], []
        for s in sorted(scales, reverse=True):  # largest grid first
            hs = max(8, int(round(h * s)) // 8 * 8)
            ws = max(8, int(round(w * s)) // 8 * 8)
            xi = x if (hs, ws) == (h, w) else resize_hw(x, 2, hs, ws,
                                                         "linear")
            hm, pf = _body(state, xi, pipe_mesh)
            heats.append(hm)
            pafs.append(pf)
        heat = merge_scale_maps(heats, (h, w), upsample)
        paf = merge_scale_maps(pafs, (h, w), upsample)
    peaks, valid = find_peaks(heat.contiguous())
    return peaks, valid, limb_scores(paf, peaks, valid)


# ----------------------------------------------------------- host grouping

def group_people(peaks: np.ndarray, valid: np.ndarray,
                 scores: np.ndarray) -> List[Tuple[float, np.ndarray]]:
    """Greedy limb assignment + subset clustering (host; tiny data) — an
    exact transcription of connect_limbs_coco
    (cpm2_output_kernel_cpu.cpp:463-760), a copy of the JAX package's:

    per limb k (in LIMB_SEQ order):
      * both endpoints peakless -> skip (:502-503); one side peakless ->
        each unassigned peak of the other side seeds a 1-part subset
        (:504-562);
      * otherwise greedy-accept candidate pairs in descending line-integral
        score order, each peak used once, at most min(nA, nB) connections
        (:625-646);
      * limb 0 connections each seed a 2-part subset (:650-666); for later
        limbs every subset whose A-part holds this connection's A-peak gets
        the B-peak assigned (overwriting, count incremented — the
        reference's bookkeeping, :692-720); connections matching no subset
        seed a new one (:707-719).
    Prune: cnt >= 3 and score/cnt > 0.4 (:730-732), insertion order, at
    most MAX_PEOPLE (:749).

    peaks: [18, K, 3]; valid: [18, K]; scores: [L, K, K] from
    ``limb_scores`` (-inf = infeasible). Returns
    [(score/cnt, kp [18,3] heatmap coords)].
    """
    K = peaks.shape[1]
    # subsets: part -> peak index, plus the reference's score/cnt counters
    subsets: List[Dict] = []

    for l, (pa, pb) in enumerate(LIMB_SEQ):
        va_idx = [i for i in range(K) if valid[pa, i]]
        vb_idx = [j for j in range(K) if valid[pb, j]]
        if not va_idx and not vb_idx:
            continue
        if not va_idx:
            for j in vb_idx:
                if not any(ss["parts"].get(pb) == j for ss in subsets):
                    subsets.append({"parts": {pb: j}, "cnt": 1,
                                    "score": float(peaks[pb, j, 2])})
            continue
        if not vb_idx:
            for i in va_idx:
                if not any(ss["parts"].get(pa) == i for ss in subsets):
                    subsets.append({"parts": {pa: i}, "cnt": 1,
                                    "score": float(peaks[pa, i, 2])})
            continue

        s = scores[l]
        cands = [(float(s[i, j]), i, j) for i in va_idx for j in vb_idx
                 if np.isfinite(s[i, j])]
        cands.sort(key=lambda c: -c[0])
        num = min(len(va_idx), len(vb_idx))
        occ_a, occ_b = set(), set()
        conns = []
        for sc, i, j in cands:
            if len(conns) == num:
                break
            if i in occ_a or j in occ_b:
                continue
            conns.append((i, j, sc))
            occ_a.add(i)
            occ_b.add(j)

        if l == 0:
            for i, j, sc in conns:
                subsets.append({
                    "parts": {pa: i, pb: j}, "cnt": 2,
                    "score": float(peaks[pa, i, 2] + peaks[pb, j, 2]) + sc})
        else:
            for i, j, sc in conns:
                found = 0
                for ss in subsets:
                    if ss["parts"].get(pa) == i:
                        ss["parts"][pb] = j
                        ss["cnt"] += 1
                        ss["score"] += float(peaks[pb, j, 2]) + sc
                        found += 1
                if found == 0:
                    subsets.append({
                        "parts": {pa: i, pb: j}, "cnt": 2,
                        "score": float(peaks[pa, i, 2]
                                       + peaks[pb, j, 2]) + sc})

    people = []
    for ss in subsets:
        cnt = ss["cnt"]
        if cnt < 3 or ss["score"] / cnt <= 0.4:  # reference pruning
            continue
        kp = np.zeros((N_PARTS, 3), np.float32)
        for part, pk in ss["parts"].items():
            kp[part] = peaks[part, pk]
        people.append((float(ss["score"] / cnt), kp))
        if len(people) == MAX_PEOPLE:
            break
    return people
