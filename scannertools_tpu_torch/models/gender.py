"""Gender classifier — Levi–Hassner CNN (the rude-carnie model).

Reference parity: ``DetectGender`` (gender_detection.py:10-29) crops each
bbox and calls rude-carnie's ``get_gender_batch``, whose network is the
Levi & Hassner (CVPR-W 2015) age/gender architecture: 227×227 input,
3 conv blocks (96/7×7/s4, 256/5×5, 384/3×3 with max-pool + LRN), two
512-d fully-connected layers, 2-way softmax over ('M', 'F').

The network of the JAX package's models/gender.py as an ``nn.Module`` with
rude-carnie's scope names (``conv1``-``conv3``, ``full1``, ``full2``,
``output``; porting_maps.gender_mapping), in full float32
(``common.full_f32``), on NHWC input. flax (like TF) flattens the last
pooled activations HWC before ``full1``; this module flattens them CHW, and
the converter permutes ``full1``'s kernel rows once (kind
``linear_conv:384,6,6``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import porting_maps
from . import weights as weights_lib
from .common import _skeleton, apply_net

LABELS = ("M", "F")
INPUT_SIZE = 227
# the last pooled activations: 227 -> conv1 s4 56 -> pool 27 -> pool 13
# -> pool 6
FLAT_CHW = (384, 6, 6)


def _lrn(x, radius=2, alpha=2e-5 * 5, beta=0.75, bias=1.0):
    """Local response normalization over channels (dim 1, AlexNet-style),
    the window sum added in the JAX package's order."""
    sq = x * x
    c = x.shape[1]
    padded = F.pad(sq, (0, 0, 0, 0, radius, radius))
    n = 2 * radius + 1
    s = padded[:, 0:c]
    for i in range(1, n):
        s = s + padded[:, i:i + c]
    return x / (bias + alpha / n * s) ** beta


class LeviHassner(nn.Module):
    """[B, 227, 227, 3] raw [0,255] NHWC -> logits [B, n_classes]."""

    def __init__(self, n_classes: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 96, 7, stride=4)
        self.conv2 = nn.Conv2d(96, 256, 5, padding=2)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1)
        self.full1 = nn.Linear(384 * 6 * 6, 512)
        self.full2 = nn.Linear(512, 512)
        self.output = nn.Linear(512, n_classes)

    def forward(self, x):
        x = (x - 127.0).permute(0, 3, 1, 2)
        x = _lrn(F.max_pool2d(torch.relu(self.conv1(x)), 3, 2))
        x = _lrn(F.max_pool2d(torch.relu(self.conv2(x)), 3, 2))
        x = F.max_pool2d(torch.relu(self.conv3(x)), 3, 2)
        x = torch.relu(self.full1(x.reshape(x.shape[0], -1)))  # CHW
        x = torch.relu(self.full2(x))
        return self.output(x)


# ------------------------------------------------------------ weights

def torch_mapping() -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)} from porting_maps.gender_mapping, the
    TF scope ``conv1/weights`` as the module key ``conv1.weight``. Kinds
    for this module: convs HWIO -> OIHW, ``full1`` permuted from HWC to CHW
    columns, the other dense kernels transposed."""
    out = {}
    for path, (tf_key, kind) in porting_maps.gender_mapping().items():
        scope, leaf = tf_key.split("/")
        key = f"{scope}.{'weight' if leaf == 'weights' else 'bias'}"
        if leaf == "weights":
            if kind == "tf_conv":
                kind = "conv"
            elif scope == "full1":
                kind = "linear_conv:" + ",".join(map(str, FLAT_CHW))
            else:
                kind = "linear"
        out[path] = (key, kind)
    return out


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's gender variables ({'params': ...}) -> a
    LeviHassner state_dict."""
    return weights_lib.flax_to_torch(variables, torch_mapping())


def to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(state, torch_mapping())


def default_tree(key: torch.Tensor) -> Dict:
    """The JAX package's ``init_params(key)``, drawn in torch on the key's
    device (weights.draw_flax)."""
    return weights_lib.draw_flax(key, weights_lib.flax_shapes(
        torch_mapping(), _skeleton(LeviHassner).state_dict()))


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of deterministic random weights from a ``torch.Generator``
    seeded with ``seed`` (weights.init_state): the port's own seeded set
    (phases 4-11 of chip_smoke.py are tuned to it); a model's default weights,
    what an op draws without a ``weights_path``, are the JAX package's draw
    (``default_tree``)."""
    shapes = {k: tuple(v.shape) for k, v in
              LeviHassner().state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))


def logits(state, crops_f32: torch.Tensor) -> torch.Tensor:
    """crops: [K, 227, 227, 3] -> [K, 2] logits."""
    return apply_net(LeviHassner, state, crops_f32)


def classify(state, crops_f32: torch.Tensor) -> torch.Tensor:
    """crops: [K, 227, 227, 3] -> [K] int32 (0='M', 1='F')."""
    return torch.argmax(logits(state, crops_f32), dim=-1).to(torch.int32)
