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

``embed`` runs the net folded (``InceptionResnetV1(folded=True)``, weights
from ``fold``, built once per weight set by ``folded``): each BatchNorm is
folded into the convolution or linear layer before it, and each residual
block's scale into its ``conv2d``, so a conv unit is one convolution with a
bias. On the card a unit is one cuDNN call with its ReLU
(``torch.cudnn_convolution_relu``), and a residual block's ``conv2d`` one
with the sum and the ReLU (``torch.cudnn_convolution_add_relu``); elsewhere
the ReLU and the sum run in place. The activations are NCHW-contiguous from
the first convolution on: the permuted NHWC crops carry channels_last
strides, and with them cuDNN ran its float32 NCHW engine between layout
transposes. On an H100 at 2560 crops the net took 0.159 ms a crop unfolded
on the permuted crops, and 0.098 folded, fused and NCHW; channels_last
weights and activations kept the transposes (0.130). The folded net's
embeddings differ from flax's order of operations in the last bits (about
1e-6).
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.numerics import mean
from . import porting_maps
from . import weights as weights_lib
from .common import _skeleton, apply_net, batch_norm

EMBEDDING_SIZE = 128  # face_embedding.py:12
BN_EPS = 1e-3


def _fused(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether a folded unit runs as one cuDNN call (the convolution, its
    bias, the residual sum where it has one, the ReLU): on the card, with
    the weight there too (a split weight of ``parallel/model_sharding.py``
    is a placeholder off the card)."""
    return x.is_cuda and weight.is_cuda


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> relu. ``folded``: one
    convolution with a bias (the BatchNorm folded in by ``fold``) and its
    ReLU, in place or in its cuDNN call (``_fused``)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 folded: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              bias=folded)
        self.bn = None if folded else nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        c = self.conv
        if self.bn is not None:
            return torch.relu(batch_norm(self.bn, c(x)))
        if _fused(x, c.weight):
            return torch.cudnn_convolution_relu(
                x, c.weight, c.bias, c.stride, c.padding, c.dilation,
                c.groups)
        return torch.relu_(c(x))


# the JAX package's name for the conv -> BatchNorm -> relu unit
ConvBN = BasicConv2d


class _Residual(nn.Module):
    """An Inception-ResNet block: ``x + scale * conv2d(branches)``, then a
    ReLU unless ``activate`` is False. ``folded``: the scale is in
    ``conv2d``'s weight and bias (``fold``), so the sum and the ReLU run on
    ``conv2d``'s output in place, or in its cuDNN call (``_fused``)."""

    def __init__(self, scale: float, folded: bool, activate: bool = True):
        super().__init__()
        self.scale = scale
        self.folded = folded
        self.activate = activate

    def residual(self, x, branches):
        c = self.conv2d
        if not self.folded:
            out = x + self.scale * c(branches)
        elif self.activate and _fused(branches, c.weight):
            return torch.cudnn_convolution_add_relu(
                branches, c.weight, x, 1.0, c.bias, c.stride, c.padding,
                c.dilation, c.groups)
        else:
            out = c(branches).add_(x)
        return torch.relu_(out) if self.activate else out


class Block35(_Residual):
    """Inception-ResNet-A, input/output 256ch, residual scale 0.17."""

    def __init__(self, scale: float = 0.17, folded: bool = False):
        super().__init__(scale, folded)
        unit = functools.partial(BasicConv2d, folded=folded)
        self.branch0 = unit(256, 32, 1)
        self.branch1 = nn.Sequential(unit(256, 32, 1),
                                     unit(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(unit(256, 32, 1),
                                     unit(32, 32, 3, padding=1),
                                     unit(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)  # linear

    def forward(self, x):
        return self.residual(x, torch.cat(
            [self.branch0(x), self.branch1(x), self.branch2(x)], dim=1))


class Block17(_Residual):
    """Inception-ResNet-B, 896ch, scale 0.10."""

    def __init__(self, scale: float = 0.10, folded: bool = False):
        super().__init__(scale, folded)
        unit = functools.partial(BasicConv2d, folded=folded)
        self.branch0 = unit(896, 128, 1)
        self.branch1 = nn.Sequential(
            unit(896, 128, 1),
            unit(128, 128, (1, 7), padding=(0, 3)),
            unit(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        return self.residual(x, torch.cat(
            [self.branch0(x), self.branch1(x)], dim=1))


class Block8(_Residual):
    """Inception-ResNet-C, 1792ch, scale 0.20; the final block has no
    relu."""

    def __init__(self, scale: float = 0.20, activate: bool = True,
                 folded: bool = False):
        super().__init__(scale, folded, activate)
        unit = functools.partial(BasicConv2d, folded=folded)
        self.branch0 = unit(1792, 192, 1)
        self.branch1 = nn.Sequential(
            unit(1792, 192, 1),
            unit(192, 192, (1, 3), padding=(0, 1)),
            unit(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        return self.residual(x, torch.cat(
            [self.branch0(x), self.branch1(x)], dim=1))


class Mixed6a(nn.Module):
    """Reduction A: 256 -> 896 channels."""

    def __init__(self, folded: bool = False):
        super().__init__()
        unit = functools.partial(BasicConv2d, folded=folded)
        self.branch0 = unit(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(
            unit(256, 192, 1),
            unit(192, 192, 3, padding=1),
            unit(192, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class Mixed7a(nn.Module):
    """Reduction B: 896 -> 1792 channels."""

    def __init__(self, folded: bool = False):
        super().__init__()
        unit = functools.partial(BasicConv2d, folded=folded)
        self.branch0 = nn.Sequential(unit(896, 256, 1),
                                     unit(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(unit(896, 256, 1),
                                     unit(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(unit(896, 256, 1),
                                     unit(256, 256, 3, padding=1),
                                     unit(256, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(nn.Module):
    """[B, 160, 160, 3] prewhitened NHWC -> [B, 128] L2-normalized.
    ``folded``: the tree of the weights ``fold`` gives, every conv unit and
    ``last_linear`` with a bias and no BatchNorm."""

    def __init__(self, embedding_size: int = EMBEDDING_SIZE,
                 folded: bool = False):
        super().__init__()
        unit = functools.partial(BasicConv2d, folded=folded)
        self.conv2d_1a = unit(3, 32, 3, stride=2)
        self.conv2d_2a = unit(32, 32, 3)
        self.conv2d_2b = unit(32, 64, 3, padding=1)
        self.conv2d_3b = unit(64, 80, 1)
        self.conv2d_4a = unit(80, 192, 3)
        self.conv2d_4b = unit(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35(folded=folded)
                                        for _ in range(5)])
        self.mixed_6a = Mixed6a(folded)
        self.repeat_2 = nn.Sequential(*[Block17(folded=folded)
                                        for _ in range(10)])
        self.mixed_7a = Mixed7a(folded)
        self.repeat_3 = nn.Sequential(*[Block8(folded=folded)
                                        for _ in range(5)])
        self.block8 = Block8(activate=False, folded=folded)
        self.last_linear = nn.Linear(1792, embedding_size, bias=folded)
        self.last_bn = None if folded \
            else nn.BatchNorm1d(embedding_size, eps=BN_EPS)

    def forward(self, x):
        # NCHW-contiguous from here on: one copy of the crops (module doc)
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_6a(self.repeat_1(x))
        x = self.mixed_7a(self.repeat_2(x))
        x = self.block8(self.repeat_3(x))
        x = self.last_linear(mean(x, (2, 3)))  # global average pool
        if self.last_bn is not None:
            x = batch_norm(self.last_bn, x)
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


# ------------------------------------------------------------ the fold

def _fold_bn(state, weight: str, bn: str):
    """(W · m, bias − mean · m) with m = rsqrt(var + eps) · scale per output
    channel: the eval BatchNorm ``bn`` folded into the layer of ``weight``
    before it."""
    mul = torch.rsqrt(state[f"{bn}.running_var"] + BN_EPS) \
        * state[f"{bn}.weight"]
    w = state[weight]
    return (w * mul.view((-1,) + (1,) * (w.dim() - 1)),
            state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * mul)


@torch.no_grad()
def fold(state) -> Dict[str, torch.Tensor]:
    """An ``InceptionResnetV1`` state_dict -> the weights of
    ``InceptionResnetV1(folded=True)``, on the same device: every
    BatchNorm folded into the convolution or linear layer before it
    (``_fold_bn``), and each residual block's scale into its ``conv2d``'s
    weight and bias. Each call builds a new set and counts it in
    ``fold.builds``."""
    out = {}
    for name, m in _skeleton(InceptionResnetV1).named_modules():
        if isinstance(m, BasicConv2d):
            out[f"{name}.conv.weight"], out[f"{name}.conv.bias"] = _fold_bn(
                state, f"{name}.conv.weight", f"{name}.bn")
        elif isinstance(m, _Residual):
            for leaf in ("weight", "bias"):
                out[f"{name}.conv2d.{leaf}"] = \
                    state[f"{name}.conv2d.{leaf}"] * m.scale
    out["last_linear.weight"], out["last_linear.bias"] = _fold_bn(
        state, "last_linear.weight", "last_bn")
    fold.builds += 1
    return out


fold.builds = 0

# a raw state's fold, keyed by its first convolution's weight and kept while
# that lives: (weak references to the state's tensors with their in-place
# versions, the folded set)
_FOLDS = WeakIdKeyDictionary()
_FOLDS_LOCK = threading.Lock()


def folded(state) -> Dict[str, torch.Tensor]:
    """``fold(state)``, built once per weight set: kept while the state's
    tensors live, and built again when one of them is replaced or changed
    in place. A state that is folded already (no BatchNorm) is returned as
    it is."""
    if "last_bn.running_var" not in state:
        return state
    tensors = tuple(state.values())
    with _FOLDS_LOCK:
        hit = _FOLDS.get(state["conv2d_1a.conv.weight"])
        if hit is not None and len(hit[0]) == len(tensors) and all(
                ref() is t and version == t._version
                for (ref, version), t in zip(hit[0], tensors)):
            return hit[1]
        out = fold(state)
        _FOLDS[state["conv2d_1a.conv.weight"]] = (
            tuple((weakref.ref(t), t._version) for t in tensors), out)
        return out


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
    """crops: [K, 160, 160, 3] raw [0,255] -> [K, 128] L2-normalized, on
    ``state`` raw or folded, through the folded net (``folded``)."""
    return apply_net(InceptionResnetV1, folded(state), prewhiten(crops_f32),
                     init=(EMBEDDING_SIZE, True))
