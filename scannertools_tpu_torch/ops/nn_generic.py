"""Generic NN ops: the model registry, ``NNInput`` preprocessing and the
``FasterRCNN`` forward.

Reference parity: ``CaffeInput`` preprocessing (caffe_input_kernel.cpp:
Halide resize + mean-subtract + channel swap + optional /255 + planar
transpose) and the ``FasterRCNN`` Caffe op (faster_rcnn_kernel.cpp:6-33).
The structure is the JAX package's (scannertools_tpu's ops/nn_generic.py):
a registry of models by name (the analog of caffe prototxt paths in
``NetDescriptor.model_path``), preprocessing as a device op.

The registry holds the models this package has. The generic ``NNForward``
and ``MoEHead`` ops, and the NetDescriptor files they read, are not ported
yet (ROADMAP item 14): building either raises ``NotImplementedError``.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..registry import register_composite, register_op
from ..utils.framechunk import as_hwc_f32
from ..utils.numerics import div, resize_hw
from .faces import _MODELS, _get_params

# registry name -> the model's name in faces._MODELS (its module and
# weights)
_NN_REGISTRY: Dict[str, str] = {
    "facenet_inception_resnet_v1": "facenet",
    "ssd_mobilenet_v1": "ssd",
    "gender_levi_hassner": "gender",
    "faster_rcnn": "faster_rcnn",
}


def get_model(name: str) -> ModuleType:
    if name not in _NN_REGISTRY:
        raise KeyError(
            f"no registered model {name!r}; available: {sorted(_NN_REGISTRY)}"
        )
    return _MODELS[_NN_REGISTRY[name]]


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


def _unported(name: str):
    def build(inputs, params, device):
        raise NotImplementedError(
            f"{name} is not ported to scannertools_tpu_torch yet (ROADMAP "
            f"item 14); the models it would run are registered here: "
            f"{sorted(_NN_REGISTRY)}")
    return build


register_composite("NNForward")(_unported("NNForward"))
register_composite("MoEHead")(_unported("MoEHead"))


def _frcnn_aux(ctx, params):
    return _get_params(_NN_REGISTRY["faster_rcnn"],
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
    return get_model("faster_rcnn").apply(aux, x)
