"""Generic NN ops: the model registry, ``NNInput`` preprocessing, the
descriptor-driven ``NNForward``, the ``MoEHead`` and the ``FasterRCNN``
forward.

Reference parity: the generic ``Caffe`` op + ``CaffeInput`` preprocessing
(caffe_kernel.{h,cpp}: loads a net from a NetDescriptor, reshapes the input
blob, runs ForwardPrefilled, emits each output blob as an F32 frame;
caffe_input_kernel.cpp: Halide resize + mean-subtract + channel swap +
optional /255 + planar transpose) and the ``FasterRCNN`` Caffe op
(faster_rcnn_kernel.cpp:6-33). The structure is the JAX package's
(scannertools_tpu's ops/nn_generic.py): a registry of models by name (the
analog of caffe prototxt paths in ``NetDescriptor.model_path``), each name
mapped to the forward the JAX registry names, with the JAX package's
inputs and outputs (NHWC); preprocessing is a device op.

``MoEHead`` runs on one device (``parallel/expert.moe_reference``); its
expert-sharded form waits for the multi-device port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import (facenet, facenet_detector, faster_rcnn, gender, pose,
                      ssd, streetstyle)
from ..parallel.expert import capacity_for, moe_reference
from ..registry import register_op
from ..utils.framechunk import as_hwc_f32
from ..utils.net_descriptor import NetDescriptor
from ..utils.numerics import div, resize_hw
from .faces import _get_params


def _openpose_maps(state, x: torch.Tensor):
    """[B, H, W, 3] in [-0.5, 0.5] -> (heat [B, H/8, W/8, 19], paf [.., 38]),
    NHWC as the JAX package's ``OpenPoseBody().apply`` gives them."""
    heat, paf = pose.body_maps(state, x.permute(0, 3, 1, 2))
    return heat.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)


# registry name -> (the model's name in faces._MODELS: its weights, its
# forward(state, x)); the forwards the JAX registry names
_NN_REGISTRY: Dict[str, Tuple[str, Callable]] = {
    "facenet_inception_resnet_v1": ("facenet", facenet.embed),
    "ssd_mobilenet_v1": ("ssd", ssd.detect),
    "gender_levi_hassner": ("gender", gender.logits),
    "openpose_body": ("openpose", _openpose_maps),
    "facenet_detector": ("facenet_detector", facenet_detector.apply),
    "faster_rcnn": ("faster_rcnn", faster_rcnn.apply),
    "streetstyle_clothing": ("streetstyle_clothing",
                             streetstyle.predict_clothing),
    "streetstyle_hairstyle": ("streetstyle_hairstyle",
                              streetstyle.predict_hairstyle),
}


def get_model(name: str) -> Tuple[str, Callable]:
    """Registry name -> (weights name for ``faces._get_params``, forward)."""
    if name not in _NN_REGISTRY:
        raise KeyError(
            f"no registered model {name!r}; available: {sorted(_NN_REGISTRY)}"
        )
    return _NN_REGISTRY[name]


@register_op("NNInput", kind="device", outputs=("array_f32",))
def nn_input(ctx, frame, input_width: int = -1, input_height: int = -1,
             mean_colors=(), normalize: bool = False, transpose: bool = False,
             pad_mod: int = -1):
    """CaffeInput-equivalent preprocessing (caffe_input_transformer_base.h:
    35-99 semantics): resize to descriptor dims, subtract per-channel mean,
    optional /255 normalize, optional planar transpose, pad to %pad_mod."""
    x = as_hwc_f32(frame)
    if input_width > 0 and input_height > 0:
        x = resize_hw(x, 1, input_height, input_width, "linear")
    if normalize:
        x = div(x, 255.0)
    if mean_colors:
        x = x - torch.tensor(list(mean_colors), dtype=x.dtype,
                             device=x.device)
    if pad_mod > 0:
        ph = (-x.shape[1]) % pad_mod
        pw = (-x.shape[2]) % pad_mod
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    if transpose:
        # NHWC -> NCHW planar, like Caffe blobs
        x = x.permute(0, 3, 1, 2).contiguous()
    return x


def _resolve_descriptor(model: str, descriptor_path: str,
                        weights_path: Optional[str]):
    if descriptor_path:
        desc = NetDescriptor.from_file(descriptor_path)
        model = model or desc.model_path
        weights_path = weights_path or (desc.model_weights_path or None)
    return model, weights_path


def _nn_aux(ctx, params):
    model, weights_path = _resolve_descriptor(
        params.get("model", ""), params.get("descriptor_path", ""),
        params.get("weights_path"))
    return _get_params(get_model(model)[0], weights_path)


@register_op("NNForward", kind="device", aux=_nn_aux,
             outputs=("array_f32",))
def nn_forward(ctx, aux, input, model: str = "", descriptor_path: str = "",
               weights_path: Optional[str] = None):
    """Generic forward pass (the reference's ``Caffe`` op,
    caffe_kernel.cpp:335-431). ``model`` names a registry entry, or
    ``descriptor_path`` points at a NetDescriptor TOML whose model_path is
    the registry name. Device op: weights enter via OpDef.aux. Output: the
    model's (first) output, rows = frames."""
    model, _ = _resolve_descriptor(model, descriptor_path, weights_path)
    _, fwd = get_model(model)
    out = fwd(aux, torch.as_tensor(input).to(torch.float32).contiguous())
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _moe_dims(params) -> Tuple[int, int, int]:
    dims = (int(params.get("n_experts", 8)), int(params.get("d_model", 0)),
            int(params.get("d_hidden", 256)))
    if dims[1] <= 0:
        raise ValueError("MoEHead requires d_model (input feature width)")
    return dims


def _moe_aux(ctx, params):
    return _get_params("moe", params.get("weights_path"), _moe_dims(params))


@register_op("MoEHead", kind="device", aux=_moe_aux, outputs=("array_f32",))
def moe_head(ctx, aux, input, n_experts: int = 8, d_model: int = 0,
             d_hidden: int = 256, capacity_factor: float = 2.0,
             capacity_batch: int = 0,
             weights_path: Optional[str] = None):
    """Routed mixture-of-experts FFN head over per-row feature vectors
    (e.g. FaceNet/streetstyle embeddings from NNForward) — an addition of
    the JAX package with no reference analog (the reference's nets are
    fixed per-frame CNNs, SURVEY §2j); rows flatten to [T, d_model].

    Top-1 routing with a per-expert capacity; tokens over it are dropped
    (a zero row). ``capacity_batch > 0`` sizes the capacity from that
    fixed batch, max(1, int(capacity_factor * capacity_batch /
    n_experts)), so that what is dropped does not depend on the chunk's
    length; 0 sizes it from the chunk's rows."""
    x = as_hwc_f32(input)  # FrameChunk or plain array -> f32
    x = x.reshape(x.shape[0], -1)
    if x.shape[1] != int(d_model):
        raise ValueError(
            f"MoEHead d_model={d_model} but input rows flatten to "
            f"{x.shape[1]} features")
    cap = capacity_for(capacity_batch, n_experts, capacity_factor) \
        if capacity_batch > 0 else 0
    return moe_reference(aux, x, capacity_factor=capacity_factor,
                         capacity=cap)


def _frcnn_aux(ctx, params):
    return _get_params(get_model("faster_rcnn")[0],
                       params.get("weights_path"))


@register_op("FasterRCNN", kind="device", aux=_frcnn_aux,
             outputs=("array_f32", "array_f32", "array_f32"))
def faster_rcnn_forward(ctx, aux, input, weights_path: Optional[str] = None):
    """Faster R-CNN forward (faster_rcnn_kernel.cpp:6-33): input is the
    NNInput-preprocessed frame batch (BGR, caffe mean); emits per frame
    cls_prob [R,81], rois [R,5] (batch, x1, y1, x2, y2 in input pixels —
    im_info scale is 1.0, matching the reference's net_config), fc7
    [R,4096]. Feed FasterRCNNOutput for the 0.7-threshold argmax decode."""
    x = torch.as_tensor(input).to(torch.float32).contiguous()
    return get_model("faster_rcnn")[1](aux, x)
