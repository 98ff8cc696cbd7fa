"""Weight porting & persistence.

Reference parity: the reference downloads pretrained TF1/Caffe checkpoints
at runtime (face_embedding.py:31 FaceNet tar, object_detection.py:38 SSD
frozen graph, openpose_kernel.cpp:35-78 caffemodels). This environment has
no egress, so models initialize deterministically random unless a weights
file is supplied; this module is the bridge (the JAX package's
models/weights.py, numpy only, plus the torch direction):

  * ``save_params`` / ``load_params`` — flatten a flax-layout variables
    tree to npz (portable, no pickle). The file format is the JAX
    package's: either package reads what the other wrote.
  * ``from_torch_conv`` / ``from_torch_linear`` / ``from_torch_bn`` — layout
    converters (torch OIHW → flax HWIO etc.), and ``port_state_dict``,
    which drives a {flax path: (torch key, kind)} mapping over a torch
    ``state_dict`` to fill a flax variables tree.
  * ``flax_to_torch`` / ``torch_to_flax`` — the same mappings
    (models/porting_maps.py) driven both ways without a template: a flax
    tree (HWIO convs, [I, O] dense kernels, BatchNorm scale/bias with
    mean/var, PReLU alpha) to a torch ``state_dict`` (OIHW, [O, I],
    weight/bias/running_mean/running_var) and back. Kind
    ``linear_conv:C,H,W`` is a dense layer after a conv: flax flattens its
    input HWC, torch CHW, so its kernel rows are permuted
    (porting_maps.linear_after_conv and its inverse). Kind
    ``conv_transpose`` mirrors the kernel's spatial axes both ways
    (``from_torch_conv_transpose``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import jax_random


# ------------------------------------------------------------- npz persist

def _flatten(tree: Any, prefix: str = "", leaf=np.asarray
             ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", leaf))
    else:
        out[prefix[:-1]] = leaf(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def save_params(path: str, variables: Any) -> None:
    np.savez_compressed(path, **_flatten(variables))


def load_params(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


# --------------------------------------------------------- torch converters

def from_torch_conv(w: np.ndarray) -> np.ndarray:
    """torch conv weight [O, I, kH, kW] -> flax [kH, kW, I, O]."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def from_torch_depthwise(w: np.ndarray) -> np.ndarray:
    """torch depthwise [C, 1, kH, kW] -> flax grouped-conv [kH, kW, 1, C]."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def from_torch_linear(w: np.ndarray) -> np.ndarray:
    """torch linear [O, I] -> flax kernel [I, O]."""
    return np.transpose(np.asarray(w), (1, 0))


def from_torch_bn(weight, bias, running_mean, running_var):
    """-> flax BatchNorm {scale, bias} params + {mean, var} batch_stats."""
    return (
        {"scale": np.asarray(weight), "bias": np.asarray(bias)},
        {"mean": np.asarray(running_mean), "var": np.asarray(running_var)},
    )


def from_torch_conv_transpose(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight [I, O, kH, kW] -> flax [kH, kW, I, O],
    flipped in both spatial axes: flax's ``nn.ConvTranspose`` runs with
    ``transpose_kernel=False`` (a correlation of the dilated input, the
    kernel not flipped), so it computes torch's transposed convolution only
    with the kernel mirrored. (The JAX package's converter does not flip:
    a real checkpoint's upsampling comes out mirrored there.)"""
    return np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]


def from_tf_conv(w: np.ndarray) -> np.ndarray:
    """TF conv weight [kH, kW, I, O] — already flax layout."""
    return np.asarray(w)


def from_tf_depthwise(w: np.ndarray) -> np.ndarray:
    """TF depthwise [kH, kW, C, multiplier=1] -> flax grouped-conv
    [kH, kW, 1, C]."""
    return np.transpose(np.asarray(w), (0, 1, 3, 2))


_KIND_FNS = {
    "conv": from_torch_conv,
    "conv_transpose": from_torch_conv_transpose,
    "depthwise": from_torch_depthwise,
    "linear": from_torch_linear,
    "tf_conv": from_tf_conv,
    "tf_depthwise": from_tf_depthwise,
    "raw": np.asarray,
}


def as_f32(v) -> torch.Tensor:
    """A leaf (numpy, npz-loaded or a tensor) -> a float32 tensor; a
    tensor stays on its device."""
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.from_numpy(np.array(v, np.float32))


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def port_state_dict(variables: Dict[str, Any],
                    state_dict: Mapping[str, Any],
                    mapping: Mapping[str, Tuple[str, str]]) -> Dict[str, Any]:
    """Fill ``variables`` (a flax tree, e.g. {'params': ..., 'batch_stats':
    ...}) from a torch state_dict.

    mapping: {"params/conv1/conv/kernel": ("conv2d_1a.conv.weight", "conv"),
              ...} — flax slash-path -> (torch key, kind). Entries whose
    torch key is missing raise KeyError (porting must be total).
    """
    flat = _flatten(variables)
    for flax_key, (torch_key, kind) in mapping.items():
        if flax_key not in flat:
            raise KeyError(f"flax param {flax_key!r} not in variables tree")
        arr = _KIND_FNS[kind](_numpy(state_dict[torch_key]))
        if arr.shape != flat[flax_key].shape:
            raise ValueError(
                f"{flax_key}: shape {arr.shape} != expected "
                f"{flat[flax_key].shape} (torch key {torch_key})"
            )
        flat[flax_key] = arr.astype(flat[flax_key].dtype)
    return _unflatten(flat)


# ---------------------------------------------- flax tree <-> state_dict

def _chw(kind: str) -> Tuple[int, int, int]:
    c, h, w = (int(x) for x in kind.split(":")[1].split(","))
    return c, h, w


def _perm(a, axes):
    return a.permute(*axes) if isinstance(a, torch.Tensor) \
        else np.transpose(a, axes)


def _to_torch(kind: str, a):
    """A flax-layout leaf (numpy, or a tensor on any device) -> the torch
    layout of ``kind`` (the inverse of _KIND_FNS and of
    porting_maps.linear_after_conv)."""
    if kind in ("conv", "tf_conv"):  # HWIO -> OIHW
        return _perm(a, (3, 2, 0, 1))
    if kind == "conv_transpose":  # HWIO, mirrored -> IOHW
        a = a.flip(0, 1) if isinstance(a, torch.Tensor) else a[::-1, ::-1]
        return _perm(a, (2, 3, 0, 1))
    if kind == "linear":
        return _perm(a, (1, 0))
    if kind.startswith("linear_conv:"):  # [H*W*C, O] -> [O, C*H*W]
        c, h, w = _chw(kind)
        o = a.shape[1]
        return _perm(a.reshape(h, w, c, o), (3, 2, 0, 1)).reshape(
            o, c * h * w)
    if kind == "raw":
        return a
    raise ValueError(f"no torch layout for weight kind {kind!r}")


def _flax_shape(kind: str, s: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax-layout shape of a torch-layout leaf of ``kind`` (what
    ``_to_flax`` gives, with no data)."""
    if kind in ("conv", "tf_conv"):
        return (s[2], s[3], s[1], s[0])
    if kind == "conv_transpose":
        return (s[2], s[3], s[0], s[1])
    if kind == "linear" or kind.startswith("linear_conv:"):
        return (s[1], s[0])
    if kind == "raw":
        return tuple(s)
    raise ValueError(f"no flax layout for weight kind {kind!r}")


def _to_flax(kind: str, a: np.ndarray) -> np.ndarray:
    if kind in ("conv", "tf_conv"):
        return from_torch_conv(a)
    if kind == "conv_transpose":
        return from_torch_conv_transpose(a)
    if kind.startswith("linear_conv:"):
        c, h, w = _chw(kind)
        o = a.shape[0]
        return a.reshape(o, c, h, w).transpose(2, 3, 1, 0).reshape(
            h * w * c, o)
    return _KIND_FNS[kind](a)


def flax_to_torch(variables: Any, mapping: Mapping[str, Tuple[str, str]],
                  extra: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """A flax-layout tree -> {torch key: float tensor} through ``mapping``
    ({flax path: (torch key, kind)}), plus ``extra`` entries the flax tree
    has no counterpart of. Every mapped flax path must exist (KeyError);
    the result's order is the mapping's. Tensor leaves stay on their
    device, and the ``extra`` entries join them there."""
    flat = _flatten(variables, leaf=lambda v: v if isinstance(
        v, torch.Tensor) else np.asarray(v))
    out: Dict[str, torch.Tensor] = {}
    device = None
    for flax_key, (torch_key, kind) in mapping.items():
        if flax_key not in flat:
            raise KeyError(f"flax param {flax_key!r} not in variables tree")
        leaf = flat[flax_key]
        if isinstance(leaf, torch.Tensor):
            device = leaf.device
            out[torch_key] = _to_torch(kind, leaf.float()).contiguous()
        else:
            a = _to_torch(kind, np.asarray(leaf, np.float32))
            out[torch_key] = torch.from_numpy(np.ascontiguousarray(a))
    for k, v in (extra or {}).items():
        out[k] = v if device is None else v.to(device)
    return out


def torch_to_flax(state_dict: Mapping[str, Any],
                  mapping: Mapping[str, Tuple[str, str]]) -> Dict[str, Any]:
    """A torch state_dict -> the flax-layout tree of ``mapping`` (what the
    JAX package's ``save_params`` writes and ``load_params`` reads)."""
    flat = {flax_key: np.ascontiguousarray(
                _to_flax(kind, _numpy(state_dict[torch_key])), np.float32)
            for flax_key, (torch_key, kind) in mapping.items()}
    return _unflatten(flat)


def init_state(shapes: Mapping[str, Tuple[int, ...]],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Deterministic random weights for a module's state_dict shapes, in
    key order from ``generator``: conv and dense weights normal with std
    1/sqrt(fan in) of the torch layout, biases and BatchNorm shifts and
    means 0, BatchNorm scales and variances 1, PReLU slopes 0.25 (keys
    ending in "prelu<n>.weight"). This is the port's own seeded set (each
    model's ``init_params(seed)``); a model's default weights are the JAX
    package's draw, ``default_params``."""
    out: Dict[str, torch.Tensor] = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        module = key.rsplit(".", 2)[-2] if "." in key else ""
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
        elif leaf == "weight" and module.startswith("prelu"):
            out[key] = torch.full(shape, 0.25)
        elif leaf == "weight" and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            out[key] = torch.randn(shape, generator=generator) \
                * float(1.0 / np.sqrt(fan_in))
        elif leaf in ("weight", "running_var"):
            out[key] = torch.ones(shape)
        else:  # bias, running_mean
            out[key] = torch.zeros(shape)
    return out


# -------------------------------------- the JAX package's default draw

def flax_shapes(mapping: Mapping[str, Tuple[str, str]],
                torch_shapes: Mapping[str, Any]) -> Dict[str, Tuple]:
    """{flax path: flax-layout shape} of a mapping's tree, from the torch
    shapes (a state_dict, on the meta device or any other): the tree
    ``torch_to_flax`` would give, with no data."""
    return {path: _flax_shape(kind, tuple(torch_shapes[tk].shape))
            for path, (tk, kind) in mapping.items()}


# the constant leaves by name: biases and BatchNorm shifts 0, BatchNorm
# scales 1, the MTCNN PReLU's slopes 0.25, batch statistics' means 0 and
# variances 1 (a kernel is the one leaf a flax layer draws)
_CONSTANTS = {"bias": 0.0, "scale": 1.0, "alpha": 0.25, "mean": 0.0,
              "var": 1.0}


def draw_flax(key: torch.Tensor, shapes: Mapping[str, Tuple],
              collections: bool = True) -> Dict[str, Any]:
    """One flax ``Module.init(key, ...)``, drawn in torch on the key's
    device: ``shapes`` is its flat tree {"params/<scope...>/<leaf>":
    shape, "batch_stats/<scope...>/<leaf>": shape} (``collections``
    False: a tree of params alone, its paths without "params/"). Every
    ``Dense``, ``Conv`` and ``ConvTranspose`` kernel is LeCun normal on
    the root key folded with its scope path and its ``make_rng("params")``
    counter, 1: a layer creates its kernel first, its bias second (flax's
    ``_fold_in_static``); the other leaves are constants."""
    flat: Dict[str, torch.Tensor] = {}
    for path, shape in shapes.items():
        parts = path.split("/")
        if collections and parts[0] not in ("params", "batch_stats"):
            raise ValueError(f"no initializer for collection {parts[0]!r}")
        scope = tuple(parts[1 if collections else 0:-1])
        if parts[-1] == "kernel":
            flat[path] = jax_random.lecun_normal(
                jax_random.fold_in_static(key, scope + (1,)), shape)
        elif parts[-1] in _CONSTANTS:
            flat[path] = jax_random.constant(
                None, shape, _CONSTANTS[parts[-1]], key.device)
        else:
            raise ValueError(f"no initializer for {path!r}")
    return _unflatten(flat)


def default_params(lib, *arch, device=None):
    """A model's default weights: the JAX package's ``init_*(
    jax.random.PRNGKey(0))`` for it, drawn in torch on ``device`` (None:
    the card, as a ``Client``'s) by ``lib.default_tree`` and turned into
    the port's weights by ``lib.from_flax``. ``arch``: the model's arch
    argument, where it has one (Mask R-CNN's name, MoE's dims)."""
    from ..client import _resolve_device

    key = jax_random.prng_key(0, _resolve_device(device))
    return lib.from_flax(lib.default_tree(key, *arch), *arch)
