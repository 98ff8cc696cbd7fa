"""Facenet-style fully-convolutional face detector (template regression).

Reference parity: the scannertools_caffe "Facenet" pipeline — a fully-conv
face detector whose output grid carries per-template sigmoid confidences
plus (dcx, dcy, dcw, dch) box adjustments (FacenetKernel reshapes the net
to scaled frame dims, facenet_kernel.cpp:37-46; the decode lives in
ops/detection_decode.py FacenetOutput, matching
facenet_output_kernel_cpu.cpp). This network produces that output
contract: [B, H/8, W/8, n_templates * 5].

The JAX package's models/facenet_detector.py as an ``nn.Module`` whose
parameter names are the flax scopes (``down0``, ``conv2``, ``head0``,
``out``), in NCHW on NHWC input and output, in full float32
(``common.full_f32``). Every convolution pads as flax's ``"SAME"``
(``common.same_pad``): a stride-2 convolution on an even side pads (0, 1).

Registered as ``facenet_detector`` in the generic model registry, so the
full pipeline is:

    pre  = sc.ops.NNInput(frame=frame, mean_colors=(119.3, 110.6, 101.4))
    maps = sc.ops.NNForward(input=pre, model='facenet_detector')
    info = sc.ops.InfoFromFrame(frames=frame)
    faces = sc.ops.FacenetOutput(scores=maps, frame_info=info)
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from . import weights as weights_lib
from .common import _skeleton, apply_net, same_pad

N_TEMPLATES = 25  # facenet_output_kernel_cpu.cpp:20-30
_WIDTHS = (32, 64, 128)


class FacenetDetector(nn.Module):
    """[B, H, W, 3] mean-subtracted, H, W % 8 == 0 -> [B, H/8, W/8,
    n_templates * 5]: logits of the templates and 4 box adjustments
    each."""

    def __init__(self, n_templates: int = N_TEMPLATES):
        super().__init__()
        cin = 3
        for i, f in enumerate(_WIDTHS):
            self.add_module(f"down{i}", nn.Conv2d(cin, f, 3, stride=2))
            self.add_module(f"conv{i}", nn.Conv2d(f, f, 3))
            cin = f
        self.head0 = nn.Conv2d(cin, 256, 3)
        self.out = nn.Conv2d(256, n_templates * 5, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(len(_WIDTHS)):
            x = torch.relu(getattr(self, f"down{i}")(same_pad(x, 3, 2)))
            x = torch.relu(getattr(self, f"conv{i}")(same_pad(x, 3, 1)))
        x = torch.relu(self.head0(same_pad(x, 3, 1)))
        return self.out(x).permute(0, 2, 3, 1)


def apply(state, x: torch.Tensor) -> torch.Tensor:
    return apply_net(FacenetDetector, state, x)


# ------------------------------------------------------------ weights

def torch_mapping() -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)}: the flax scopes are the module
    names; kernels HWIO -> OIHW."""
    scopes = [f"{p}{i}" for i in range(len(_WIDTHS))
              for p in ("down", "conv")] + ["head0", "out"]
    out = {}
    for s in scopes:
        out[f"params/{s}/kernel"] = (f"{s}.weight", "conv")
        out[f"params/{s}/bias"] = (f"{s}.bias", "raw")
    return out


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's FacenetDetector variables -> a state_dict."""
    return weights_lib.flax_to_torch(variables, torch_mapping())


def to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(state, torch_mapping())


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic random weights from a ``torch.Generator`` seeded with
    ``seed`` (weights.init_state); not the JAX package's values."""
    shapes = {k: tuple(v.shape) for k, v in
              _skeleton(FacenetDetector).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))
