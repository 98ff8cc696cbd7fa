"""FaceNet embedding network — Inception-ResNet-V1 → 128-d.

Reference parity: ``EmbedFaces`` (face_embedding.py:10-89) restores the TF1
FaceNet checkpoint ``20170512-110547`` (Inception-ResNet-V1, 128-d
embeddings, Szegedy et al. 2016 architecture), crops each bbox from the
frame, resizes to 160×160, applies ``facenet.prewhiten`` and L2-normalizes
the embedding.

The network of the JAX package's models/facenet.py at full width (5
Block35, 10 Block17, 5 Block8 and the final Block8, 128-d), as an
``nn.Module`` with facenet-pytorch's ``InceptionResnetV1`` parameter names
(``conv2d_1a.conv``, ``repeat_1.0.branch0``, ``mixed_6a``, ``block8``,
``last_linear``, ``last_bn``; models/porting_maps.py), so a facenet-pytorch
state_dict with a 128-d ``last_linear`` loads as it is. It runs in eval
mode, in full float32 (``common.full_f32``), on NHWC input. As flax
computes them:

  * BatchNorm uses its running statistics with eps 1e-3:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` (flax's order);
    the bottleneck's has no learned scale in flax (its torch ``weight``
    is 1 after conversion);
  * the global average pool is a sum times 1/n (``utils.numerics.mean``, as
    jitted ``jnp.mean``), and the output ``x / (||x|| + 1e-10)``;
  * ``prewhiten`` uses the population std (ddof 0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.numerics import mean
from . import porting_maps
from . import weights as weights_lib
from .common import _skeleton, apply_net, batch_norm

EMBEDDING_SIZE = 128  # face_embedding.py:12
BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(batch_norm(self.bn, self.conv(x)))


# the JAX package's name for the conv -> BatchNorm -> relu unit
ConvBN = BasicConv2d


class Block35(nn.Module):
    """Inception-ResNet-A, input/output 256ch, residual scale 0.17."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3, padding=1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)  # linear

    def forward(self, x):
        up = self.conv2d(torch.cat(
            [self.branch0(x), self.branch1(x), self.branch2(x)], dim=1))
        return torch.relu(x + self.scale * up)


class Block17(nn.Module):
    """Inception-ResNet-B, 896ch, scale 0.10."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(896, 128, 1),
            BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)],
                                   dim=1))
        return torch.relu(x + self.scale * up)


class Block8(nn.Module):
    """Inception-ResNet-C, 1792ch, scale 0.20; the final block has no
    relu."""

    def __init__(self, scale: float = 0.20, activate: bool = True):
        super().__init__()
        self.scale = scale
        self.activate = activate
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(1792, 192, 1),
            BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)],
                                   dim=1))
        out = x + self.scale * up
        return torch.relu(out) if self.activate else out


class Mixed6a(nn.Module):
    """Reduction A: 256 -> 896 channels."""

    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(
            BasicConv2d(256, 192, 1),
            BasicConv2d(192, 192, 3, padding=1),
            BasicConv2d(192, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class Mixed7a(nn.Module):
    """Reduction B: 896 -> 1792 channels."""

    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(nn.Module):
    """[B, 160, 160, 3] prewhitened NHWC -> [B, 128] L2-normalized."""

    def __init__(self, embedding_size: int = EMBEDDING_SIZE):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35() for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block17() for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block8() for _ in range(5)])
        self.block8 = Block8(activate=False)
        self.last_linear = nn.Linear(1792, embedding_size, bias=False)
        self.last_bn = nn.BatchNorm1d(embedding_size, eps=BN_EPS)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_6a(self.repeat_1(x))
        x = self.mixed_7a(self.repeat_2(x))
        x = self.block8(self.repeat_3(x))
        x = mean(x, (2, 3))  # global average pool
        x = batch_norm(self.last_bn, self.last_linear(x))
        return x / (torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + 1e-10)


# ------------------------------------------------------------ weights

def torch_mapping() -> Dict:
    """porting_maps.facenet_expanded_mapping: {flax path: (torch key,
    kind)}."""
    return porting_maps.facenet_expanded_mapping()


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's FaceNet variables ({'params', 'batch_stats'}) ->
    an InceptionResnetV1 state_dict (load_state_dict(strict=True) takes
    it). Entries flax has no counterpart of: every BatchNorm's
    ``num_batches_tracked`` (0) and ``last_bn.weight`` (1, flax's bottleneck
    BatchNorm has no scale)."""
    extra = {k: torch.zeros((), dtype=torch.int64)
             for k in _skeleton(InceptionResnetV1).state_dict()
             if k.endswith(".num_batches_tracked")}
    extra["last_bn.weight"] = torch.ones(EMBEDDING_SIZE)
    return weights_lib.flax_to_torch(variables, torch_mapping(), extra)


def to_flax(state) -> Dict:
    """An InceptionResnetV1 state_dict -> the JAX package's variables."""
    return weights_lib.torch_to_flax(state, torch_mapping())


def default_tree(key: torch.Tensor) -> Dict:
    """The JAX package's ``init_params(key)``, drawn in torch on the key's
    device (weights.draw_flax)."""
    return weights_lib.draw_flax(key, weights_lib.flax_shapes(
        torch_mapping(), _skeleton(InceptionResnetV1).state_dict()))


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of deterministic random weights from a ``torch.Generator``
    seeded with ``seed`` (weights.init_state): the port's own seeded set
    (phases 4-11 of chip_smoke.py are tuned to it); a model's default weights,
    what an op draws without a ``weights_path``, are the JAX package's draw
    (``default_tree``)."""
    shapes = {k: tuple(v.shape) for k, v in
              InceptionResnetV1().state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ forward

def prewhiten(x: torch.Tensor) -> torch.Tensor:
    """facenet.prewhiten: per-image (x - mean)/max(std, 1/sqrt(numel))
    (face_embedding.py:71); the population std, means as jitted
    ``jnp.mean`` computes them."""
    dims = tuple(range(1, x.dim()))
    c = x - mean(x, dims, keepdim=True)
    std = torch.sqrt(mean(c * c, dims, keepdim=True))
    n = np.float32(np.prod(x.shape[1:]))
    floor = float(np.float32(1.0) / np.sqrt(n))
    return c / torch.clamp_min(std, floor)


def embed(state, crops_f32: torch.Tensor) -> torch.Tensor:
    """crops: [K, 160, 160, 3] raw [0,255] -> [K, 128] L2-normalized."""
    return apply_net(InceptionResnetV1, state, prewhiten(crops_f32))
