"""Multi-head clothing / hairstyle attribute classifiers.

Reference parity: ``DetectClothing`` / ``DetectHairStyle``
(old/clothing_detection.py:212-260, old/hairstyle_detection.py:56-120) run
the StreetStyle-derived "newsanchor" classifier: one shared CNN trunk over
a 299×299 ImageNet-normalized crop, with one softmax head per clothing /
hair attribute, returning ``(scores, features)`` where ``scores`` is the
per-attribute logits list. The reference does NOT contain that trunk — it
downloads the model *definition* from a third-party GitHub at run time
(clothing_detection.py:13-14). What IS reference behavior — the attribute
vocabularies, the 299×299 ImageNet-normalized input, the multi-head argmax
protocol, and ``(scores, features)`` — is reproduced exactly; the trunk is
the JAX package's compact inception-style tower (scannertools_tpu's
models/streetstyle.py).

The net is an ``nn.Module`` in NCHW on NHWC input, whose parameter names
are the flax scopes (``stem1``, ``mix2.b3r``, ``head7``), in full float32
(``common.full_f32``). As flax computes it:

  * every convolution and max-pool pads as flax's ``"SAME"``
    (``common.same_pad``, ``common.max_pool_same``): ``stem2`` takes 150 to
    75 with pads (0, 1), the second max-pool 38 to 19 with (0, 1) of -inf;
  * the inception block's pooled branch is ``nn.avg_pool(..., "SAME")``,
    which counts the zero padding (a divisor of 9 at the border too);
  * the block concatenates ``[b1, b3, bp]`` on the channel axis, and the
    heads read the global mean of the last block;
  * ``normalize`` divides by constants through their float32 reciprocals
    (``utils.numerics``), as jitted XLA does.

``stack_head_params`` lays the heads on a leading expert axis, zero-padded
to the widest vocabulary, with a validity mask: ``heads_logits`` computes
all heads in one product from it, and ``masked_argmax`` (padded classes
at -inf) gives the per-head argmax. The sharded form of the heads
(``heads_apply_sharded`` in the JAX package) waits for the multi-device
port.
"""

from __future__ import annotations

import types
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.numerics import mean, recip
from . import weights as weights_lib
from .common import _skeleton, apply_net, max_pool_same, same_pad

INPUT_SIZE = 299  # transforms.Resize((299, 299)) (clothing_detection.py:217)
IMAGENET_MEAN = (0.485, 0.456, 0.406)  # clothing_detection.py:220
IMAGENET_STD = (0.229, 0.224, 0.225)

# Exact attribute vocabularies (old/clothing_detection.py:17-88).
CLOTHING_ATTRIBUTES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("Clothing pattern",
     ("solid", "graphics", "striped", "floral", "plaid", "spotted")),
    ("Major color",
     ("black", "white", "more color", "blue", "gray", "red", "pink",
      "green", "yellow", "brown", "purple", "orange", "cyan", "dark blue")),
    ("Wearing necktie", ("necktie no", "necktie yes")),
    ("Collar presence", ("collar no", "collar yes")),
    ("Wearing scarf", ("scarf no", "scarf yes")),
    ("Sleeve length", ("long sleeve", "short sleeve", "no sleeve")),
    ("Neckline shape", ("round", "folded", "v-shape")),
    ("Clothing category",
     ("shirt", "outerwear", "t-shirt", "dress", "tank top", "suit",
      "sweater")),
    ("Wearing jacket?", ("jacket no", "jacket yes")),
    ("Wearing hat?", ("hat no", "hat yes")),
    ("Wearing glasses?", ("glasses no", "glasses yes")),
    ("Multiple layers?", ("one layer", "more layer")),
    ("Necktie color",
     ("black", "white", "more color", "blue", "gray", "red", "pink",
      "green", "yellow", "brown", "purple", "orange", "cyan", "dark blue")),
    ("Necktie pattern", ("solid", "striped", "spotted")),
    ("Hair color", ("black", "white", "blond", "brown", "gray")),
    ("Hair length", ("long", "medium", "short", "bald")),
)

# Exact vocabularies (old/hairstyle_detection.py:17-30).
HAIRSTYLE_ATTRIBUTES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("Hair color 3", ("black", "white", "blond")),
    ("Hair color 5", ("black", "white", "blond", "brown", "gray")),
    ("Hair length", ("long", "medium", "short", "bald")),
)


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(same_pad(x, conv.kernel_size[0], conv.stride[0]))


class _InceptionBlock(nn.Module):
    """Parallel 1×1 / 3×3 / pooled-1×1 branches, concatenated."""

    def __init__(self, cin: int, width: int):
        super().__init__()
        w = width
        self.b1 = nn.Conv2d(cin, w, 1)
        self.b3r = nn.Conv2d(cin, w // 2, 1)
        self.b3 = nn.Conv2d(w // 2, w, 3)
        self.bp = nn.Conv2d(cin, w // 2, 1)

    def forward(self, x):
        b1 = torch.relu(self.b1(x))
        b3 = torch.relu(_conv_same(self.b3, torch.relu(self.b3r(x))))
        bp = F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)
        bp = torch.relu(self.bp(bp))
        return torch.cat([b1, b3, bp], dim=1)


# (block, input channels, width): each block puts out 2 * width + width / 2
_BLOCKS = (("mix1", 64, 64), ("mix2", 160, 96), ("mix3", 240, 128))
FEATURES = 320


class MultiHeadAttributeNet(nn.Module):
    """Shared trunk + one logits head per attribute. [B, 299, 299, 3]
    ImageNet-normalized NHWC -> ``(scores, features)`` exactly like the
    reference's fetched classifier (clothing_detection.py:246): ``scores``
    a list of [B, n_values] logits, one per attribute, ``features`` the
    pooled trunk embedding [B, 320]; ``with_heads=False`` returns the
    features alone."""

    def __init__(self, head_sizes: Sequence[int]):
        super().__init__()
        self.head_sizes = tuple(head_sizes)
        self.stem1 = nn.Conv2d(3, 32, 3, stride=2)
        self.stem2 = nn.Conv2d(32, 64, 3, stride=2)
        for name, cin, width in _BLOCKS:
            self.add_module(name, _InceptionBlock(cin, width))
        for i, k in enumerate(self.head_sizes):
            self.add_module(f"head{i}", nn.Linear(FEATURES, k))

    def forward(self, x, with_heads: bool = True):
        x = torch.relu(_conv_same(self.stem1, x.permute(0, 3, 1, 2)))
        x = torch.relu(_conv_same(self.stem2, x))
        for name, _, _ in _BLOCKS:
            x = getattr(self, name)(max_pool_same(x, 3, 2))
        feat = mean(x, (2, 3))  # global average pool
        if not with_heads:
            return feat
        scores = [getattr(self, f"head{i}")(feat)
                  for i in range(len(self.head_sizes))]
        return scores, feat


def head_sizes(attributes) -> Tuple[int, ...]:
    return tuple(len(vals) for _, vals in attributes)


def normalize(crops_f32: torch.Tensor) -> torch.Tensor:
    """[B, 299, 299, 3] in [0, 255] -> ImageNet-normalized (the reference's
    ToTensor + Normalize transform, clothing_detection.py:217-221)."""
    x = crops_f32 * recip(255.0)
    m = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                     device=crops_f32.device)
    inv_std = torch.from_numpy(np.float32(1) / np.asarray(
        IMAGENET_STD, np.float32)).to(crops_f32.device)
    return (x - m) * inv_std


def forward(state, crops_f32: torch.Tensor, attributes,
            with_heads: bool = True):
    """Raw [0, 255] crops [B, 299, 299, 3] -> the net's ``(scores,
    features)`` (or the features) with ``state``'s weights."""
    return apply_net(MultiHeadAttributeNet, state, normalize(crops_f32),
                     with_heads, init=(head_sizes(attributes),))


# ------------------------------------------------------------ heads

def stack_head_params(state, attributes):
    """Per-attribute heads stacked on a leading 'expert' axis — kernels
    [E, F, Kmax] / biases [E, Kmax], zero-padded to the widest vocabulary,
    plus a validity mask [E, Kmax] (True = real class): the layout the
    expert-sharded heads split one group per device."""
    sizes = head_sizes(attributes)
    kmax = max(sizes)
    ws, bs, mask = [], [], []
    for i, k in enumerate(sizes):
        w = state[f"head{i}.weight"]  # [k, F]
        b = state[f"head{i}.bias"]    # [k]
        ws.append(F.pad(w.t(), (0, kmax - k)))
        bs.append(F.pad(b, (0, kmax - k)))
        mask.append(torch.arange(kmax, device=w.device) < k)
    return torch.stack(ws), torch.stack(bs), torch.stack(mask)


def heads_logits(stacked, feat: torch.Tensor) -> torch.Tensor:
    """Every head's logits [B, E, Kmax] in one product: the single-device
    form of the JAX package's ``heads_apply_sharded``."""
    w, b, _ = stacked
    return torch.einsum("bf,efk->bek", feat, w) + b[None]


def masked_argmax(stacked, logits: torch.Tensor) -> torch.Tensor:
    """[B, E, Kmax] logits -> [B, E] int32 argmax per head, the padded
    classes at -inf."""
    masked = torch.where(stacked[2][None], logits, float("-inf"))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def _predict_multihead(state, crops_f32: torch.Tensor,
                       attributes) -> torch.Tensor:
    """argmax-per-attribute [B, E] int32 (the reference's per-head
    torch.max, clothing_detection.py:249-253; ``torch.argmax`` takes the
    first of equal values, as ``jnp.argmax``)."""
    scores, _ = forward(state, crops_f32, attributes)
    return torch.stack([torch.argmax(s, dim=-1) for s in scores],
                       dim=1).to(torch.int32)


def predict_clothing(state, crops_f32: torch.Tensor) -> torch.Tensor:
    """[B, 299, 299, 3] raw [0,255] -> [B, 16] int32 argmax per
    attribute."""
    return _predict_multihead(state, crops_f32, CLOTHING_ATTRIBUTES)


def predict_hairstyle(state, crops_f32: torch.Tensor) -> torch.Tensor:
    """[B, 299, 299, 3] raw [0,255] -> [B, 3] int32 argmax per
    attribute."""
    return _predict_multihead(state, crops_f32, HAIRSTYLE_ATTRIBUTES)


# ------------------------------------------------------------ weights

def torch_mapping(n_heads: int) -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)}: the flax scopes are the module
    names; convolution kernels HWIO -> OIHW, dense kernels transposed."""
    scopes = ["stem1", "stem2"] + [f"{m}/{b}" for m, _, _ in _BLOCKS
                                   for b in ("b1", "b3r", "b3", "bp")]
    out = {}
    for scope in scopes + [f"head{i}" for i in range(n_heads)]:
        key = scope.replace("/", ".")
        kind = "linear" if scope.startswith("head") else "conv"
        out[f"params/{scope}/kernel"] = (f"{key}.weight", kind)
        out[f"params/{scope}/bias"] = (f"{key}.bias", "raw")
    return out


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MultiHeadAttributeNet variables ({'params': ...},
    either head set) -> a state_dict."""
    n = sum(1 for k in variables["params"] if k.startswith("head"))
    return weights_lib.flax_to_torch(variables, torch_mapping(n))


def to_flax(state) -> Dict:
    n = sum(1 for k in state if k.startswith("head")
            and k.endswith(".weight"))
    return weights_lib.torch_to_flax(state, torch_mapping(n))


def _init(attributes, seed: int) -> Dict[str, torch.Tensor]:
    shapes = {k: tuple(v.shape) for k, v in _skeleton(
        MultiHeadAttributeNet, head_sizes(attributes)).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))


def init_params_clothing(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic random weights of the 16-head net from a
    ``torch.Generator`` seeded with ``seed`` (weights.init_state); not the
    JAX package's values."""
    return _init(CLOTHING_ATTRIBUTES, seed)


def init_params_hairstyle(seed: int = 0) -> Dict[str, torch.Tensor]:
    return _init(HAIRSTYLE_ATTRIBUTES, seed)


# the two head sets as the ops' weight loaders see a model: init_params,
# from_flax, to_flax
CLOTHING = types.SimpleNamespace(init_params=init_params_clothing,
                                 from_flax=from_flax, to_flax=to_flax)
HAIRSTYLE = types.SimpleNamespace(init_params=init_params_hairstyle,
                                  from_flax=from_flax, to_flax=to_flax)
