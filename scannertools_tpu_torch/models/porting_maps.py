"""Concrete weight-porting maps: torch checkpoint naming <-> the JAX
package's flax trees (a copy of scannertools_tpu's models/porting_maps.py,
numpy only).

Reference parity: the reference downloads exact pretrained artifacts
(FaceNet 20170512-110547, MTCNN's det1-3.npy, SSD frozen graph). This
module provides the deterministic key correspondences so those weights —
via their widely-used torch ports (facenet-pytorch's ``MTCNN`` and
``InceptionResnetV1``) — drop into the models:

    import torch
    from facenet_pytorch import InceptionResnetV1
    sd = InceptionResnetV1(pretrained='vggface2').state_dict()
    variables = port_facenet(facenet_variables_template, sd)

The maps are built programmatically from both sides' (identical) layer
orders. No checkpoint can be fetched in this build environment, so tests
assert *structural* totality: every flax parameter is covered exactly once
with shape-compatible converters (weights.port_state_dict validates shapes
at port time and raises on any mismatch).

This package's torch modules take their parameter names from these maps,
and ``weights.flax_to_torch`` drives a map the other way: an npz written
by the JAX package's ``save_params`` loads into them with
``load_state_dict(strict=True)``.

Caveat: torch flattens conv activations as CHW before dense layers while
flax flattens HWC — dense kernels that consume conv outputs are
re-permuted with ``linear_after_conv``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from . import weights as W


def linear_after_conv(w: np.ndarray, chw: Tuple[int, int, int]) -> np.ndarray:
    """torch dense [O, C*H*W] following a conv (CHW flatten) -> flax kernel
    [H*W*C, O] (HWC flatten)."""
    c, h, wd = chw
    o = np.asarray(w).shape[0]
    k = np.asarray(w).reshape(o, c, h, wd).transpose(2, 3, 1, 0)
    return k.reshape(h * wd * c, o)


# ---------------------------------------------------------------- MTCNN

# facenet-pytorch module names per net; PReLU weights are per-channel.
_PNET = [
    ("conv1", "conv1", "conv"), ("prelu1", "prelu1", "prelu"),
    ("conv2", "conv2", "conv"), ("prelu2", "prelu2", "prelu"),
    ("conv3", "conv3", "conv"), ("prelu3", "prelu3", "prelu"),
    ("conv4_1", "conv4_1", "conv"), ("conv4_2", "conv4_2", "conv"),
]
_RNET = [
    ("conv1", "conv1", "conv"), ("prelu1", "prelu1", "prelu"),
    ("conv2", "conv2", "conv"), ("prelu2", "prelu2", "prelu"),
    ("conv3", "conv3", "conv"), ("prelu3", "prelu3", "prelu"),
    ("fc1", "dense4", "linear_conv:64,3,3"), ("prelu4", "prelu4", "prelu"),
    ("fc2_1", "dense5_1", "linear"), ("fc2_2", "dense5_2", "linear"),
]
_ONET = [
    ("conv1", "conv1", "conv"), ("prelu1", "prelu1", "prelu"),
    ("conv2", "conv2", "conv"), ("prelu2", "prelu2", "prelu"),
    ("conv3", "conv3", "conv"), ("prelu3", "prelu3", "prelu"),
    ("conv4", "conv4", "conv"), ("prelu4", "prelu4", "prelu"),
    ("fc1", "dense5", "linear_conv:128,3,3"), ("prelu5", "prelu5", "prelu"),
    ("fc2_1", "dense6_1", "linear"), ("fc2_2", "dense6_2", "linear"),
    ("fc2_3", "dense6_3", "linear"),
]


def mtcnn_mapping() -> Dict[str, Tuple[str, str]]:
    out: Dict[str, Tuple[str, str]] = {}
    for net, table in (("pnet", _PNET), ("rnet", _RNET), ("onet", _ONET)):
        for flax_name, torch_name, kind in table:
            if kind == "prelu":
                out[f"{net}/{flax_name}/alpha"] = (
                    f"{torch_name}.weight", "raw")
            elif kind.startswith("linear"):
                out[f"{net}/{flax_name}/kernel"] = (
                    f"{torch_name}.weight", kind)
                out[f"{net}/{flax_name}/bias"] = (
                    f"{torch_name}.bias", "raw")
            else:  # conv
                out[f"{net}/{flax_name}/kernel"] = (
                    f"{torch_name}.weight", "conv")
                out[f"{net}/{flax_name}/bias"] = (
                    f"{torch_name}.bias", "raw")
    return out


def port_mtcnn(params: Dict, state_dicts: Dict[str, dict]) -> Dict:
    """params: models.mtcnn.init_params output; state_dicts:
    {'pnet': PNet().state_dict(), 'rnet': ..., 'onet': ...}."""
    merged = {}
    for net, sd in state_dicts.items():
        for k, v in sd.items():
            merged[f"{net}::{k}"] = v
    mapping = {
        path: (f"{path.split('/')[0]}::{tk}", kind)
        for path, (tk, kind) in mtcnn_mapping().items()
    }
    return _port_with_linear_conv(params, merged, mapping)


# --------------------------------------------------------------- FaceNet

def _facenet_convbn(flax_prefix: str, torch_prefix: str, out):
    out[f"{flax_prefix}/conv/kernel"] = (f"{torch_prefix}.conv.weight",
                                         "conv")
    out[f"BN:{flax_prefix}/bn"] = (f"{torch_prefix}.bn", "bn")


def facenet_mapping() -> Dict[str, Tuple[str, str]]:
    """flax path (under params/) -> facenet-pytorch InceptionResnetV1 key.
    BN entries use the pseudo-kind 'bn' expanded by port_facenet into
    scale/bias/mean/var."""
    out: Dict[str, Tuple[str, str]] = {}
    stem = [
        ("conv1", "conv2d_1a"), ("conv2", "conv2d_2a"), ("conv3", "conv2d_2b"),
        ("conv4", "conv2d_3b"), ("conv5", "conv2d_4a"), ("conv6", "conv2d_4b"),
    ]
    for f, t in stem:
        _facenet_convbn(f, t, out)
    for i in range(5):
        t = f"repeat_1.{i}"
        f = f"block35_{i}"
        _facenet_convbn(f"{f}/b0", f"{t}.branch0", out)
        _facenet_convbn(f"{f}/b1_0", f"{t}.branch1.0", out)
        _facenet_convbn(f"{f}/b1_1", f"{t}.branch1.1", out)
        _facenet_convbn(f"{f}/b2_0", f"{t}.branch2.0", out)
        _facenet_convbn(f"{f}/b2_1", f"{t}.branch2.1", out)
        _facenet_convbn(f"{f}/b2_2", f"{t}.branch2.2", out)
        out[f"{f}/up/kernel"] = (f"{t}.conv2d.weight", "conv")
        out[f"{f}/up/bias"] = (f"{t}.conv2d.bias", "raw")
    _facenet_convbn("ra0", "mixed_6a.branch0", out)
    _facenet_convbn("ra1_0", "mixed_6a.branch1.0", out)
    _facenet_convbn("ra1_1", "mixed_6a.branch1.1", out)
    _facenet_convbn("ra1_2", "mixed_6a.branch1.2", out)
    for i in range(10):
        t = f"repeat_2.{i}"
        f = f"block17_{i}"
        _facenet_convbn(f"{f}/b0", f"{t}.branch0", out)
        _facenet_convbn(f"{f}/b1_0", f"{t}.branch1.0", out)
        _facenet_convbn(f"{f}/b1_1", f"{t}.branch1.1", out)
        _facenet_convbn(f"{f}/b1_2", f"{t}.branch1.2", out)
        out[f"{f}/up/kernel"] = (f"{t}.conv2d.weight", "conv")
        out[f"{f}/up/bias"] = (f"{t}.conv2d.bias", "raw")
    _facenet_convbn("rb0_0", "mixed_7a.branch0.0", out)
    _facenet_convbn("rb0_1", "mixed_7a.branch0.1", out)
    _facenet_convbn("rb1_0", "mixed_7a.branch1.0", out)
    _facenet_convbn("rb1_1", "mixed_7a.branch1.1", out)
    _facenet_convbn("rb2_0", "mixed_7a.branch2.0", out)
    _facenet_convbn("rb2_1", "mixed_7a.branch2.1", out)
    _facenet_convbn("rb2_2", "mixed_7a.branch2.2", out)
    for i in range(5):
        t = f"repeat_3.{i}"
        f = f"block8_{i}"
        _facenet_convbn(f"{f}/b0", f"{t}.branch0", out)
        _facenet_convbn(f"{f}/b1_0", f"{t}.branch1.0", out)
        _facenet_convbn(f"{f}/b1_1", f"{t}.branch1.1", out)
        _facenet_convbn(f"{f}/b1_2", f"{t}.branch1.2", out)
        out[f"{f}/up/kernel"] = (f"{t}.conv2d.weight", "conv")
        out[f"{f}/up/bias"] = (f"{t}.conv2d.bias", "raw")
    _facenet_convbn("block8_final/b0", "block8.branch0", out)
    _facenet_convbn("block8_final/b1_0", "block8.branch1.0", out)
    _facenet_convbn("block8_final/b1_1", "block8.branch1.1", out)
    _facenet_convbn("block8_final/b1_2", "block8.branch1.2", out)
    out["block8_final/up/kernel"] = ("block8.conv2d.weight", "conv")
    out["block8_final/up/bias"] = ("block8.conv2d.bias", "raw")
    out["bottleneck/kernel"] = ("last_linear.weight", "linear")
    out["BN:bottleneck_bn"] = ("last_bn", "bn_nofscale")
    return out


def facenet_expanded_mapping() -> Dict[str, Tuple[str, str]]:
    """facenet_mapping with bn pseudo-entries expanded to concrete
    scale/bias/mean/var leaves (what port_state_dict consumes; also used
    by the synthetic kit drill to invert artifacts)."""
    mapping: Dict[str, Tuple[str, str]] = {}
    for path, (tk, kind) in facenet_mapping().items():
        if kind == "bn":
            bn = path[3:]
            mapping[f"params/{bn}/scale"] = (f"{tk}.weight", "raw")
            mapping[f"params/{bn}/bias"] = (f"{tk}.bias", "raw")
            mapping[f"batch_stats/{bn}/mean"] = (f"{tk}.running_mean", "raw")
            mapping[f"batch_stats/{bn}/var"] = (f"{tk}.running_var", "raw")
        elif kind == "bn_nofscale":
            bn = path[3:]
            mapping[f"params/{bn}/bias"] = (f"{tk}.bias", "raw")
            mapping[f"batch_stats/{bn}/mean"] = (f"{tk}.running_mean", "raw")
            mapping[f"batch_stats/{bn}/var"] = (f"{tk}.running_var", "raw")
        else:
            mapping[f"params/{path}"] = (tk, kind)
    return mapping


def port_facenet(variables: Dict, state_dict: Dict) -> Dict:
    """Expand bn pseudo-entries then drive weights.port_state_dict."""
    return W.port_state_dict(variables, state_dict,
                             facenet_expanded_mapping())


# ------------------------------------------------- SSD-MobileNetV1 (TF)

def ssd_mapping() -> Dict[str, Tuple[str, str]]:
    """flax path -> TF checkpoint variable name for
    ``ssd_mobilenet_v1_coco_2017_11_17`` (the exact artifact the reference
    loads, object_detection.py:38-44). Obtain the variables with
    ``tf.train.load_checkpoint(model.ckpt).get_tensor(name)`` or by reading
    the frozen graph's constants; keys here are the canonical
    FeatureExtractor/BoxPredictor variable names."""
    out: Dict[str, Tuple[str, str]] = {}
    fx = "FeatureExtractor/MobilenetV1"

    def convbn(flax_prefix, tf_prefix, depthwise=False):
        wname = "depthwise_weights" if depthwise else "weights"
        kind = "tf_depthwise" if depthwise else "tf_conv"
        out[f"params/{flax_prefix}/kernel"] = (f"{tf_prefix}/{wname}", kind)
        bn = flax_prefix.rsplit("/", 1)[0]
        leaf = flax_prefix.rsplit("/", 1)[1]
        bn_name = {"conv": "bn", "dw": "dw_bn", "pw": "pw_bn"}[leaf]
        out[f"params/{bn}/{bn_name}/scale"] = (f"{tf_prefix}/BatchNorm/gamma",
                                               "raw")
        out[f"params/{bn}/{bn_name}/bias"] = (f"{tf_prefix}/BatchNorm/beta",
                                              "raw")
        out[f"batch_stats/{bn}/{bn_name}/mean"] = (
            f"{tf_prefix}/BatchNorm/moving_mean", "raw")
        out[f"batch_stats/{bn}/{bn_name}/var"] = (
            f"{tf_prefix}/BatchNorm/moving_variance", "raw")

    convbn("conv0/conv", f"{fx}/Conv2d_0")
    for i in range(1, 14):
        convbn(f"ds{i}/dw", f"{fx}/Conv2d_{i}_depthwise", depthwise=True)
        convbn(f"ds{i}/pw", f"{fx}/Conv2d_{i}_pointwise")
    extras = [(256, 512), (128, 256), (128, 256), (64, 128)]
    for j, (mid, big) in enumerate(extras):
        n = j + 2  # TF numbers the extra pairs 2..5
        convbn(f"extra{j}_a/conv",
               f"{fx}/Conv2d_13_pointwise_1_Conv2d_{n}_1x1_{mid}")
        convbn(f"extra{j}_b/conv",
               f"{fx}/Conv2d_13_pointwise_2_Conv2d_{n}_3x3_s2_{big}")
    for k in range(6):
        out[f"params/loc{k}/kernel"] = (
            f"BoxPredictor_{k}/BoxEncodingPredictor/weights", "tf_conv")
        out[f"params/loc{k}/bias"] = (
            f"BoxPredictor_{k}/BoxEncodingPredictor/biases", "raw")
        out[f"params/cls{k}/kernel"] = (
            f"BoxPredictor_{k}/ClassPredictor/weights", "tf_conv")
        out[f"params/cls{k}/bias"] = (
            f"BoxPredictor_{k}/ClassPredictor/biases", "raw")
    return out


def port_ssd(variables: Dict, tf_vars: Mapping) -> Dict:
    """variables: models.ssd.init_params output; tf_vars: {tf name: array}."""
    return W.port_state_dict(variables, tf_vars, ssd_mapping())


# -------------------------------------------- OpenPose body (caffemodel)

def openpose_mapping(stages: int = 6) -> Dict[str, Tuple[str, str]]:
    """flax path -> ``<caffe layer>.weight/.bias`` keys for the COCO
    pose_deploy_linevec caffemodel the reference downloads
    (openpose_kernel.cpp:35-78; layer names from the public prototxt).
    Torch ports of this model (e.g. pytorch-openpose) keep these layer
    names, so their state_dicts feed straight through; raw caffemodels can
    be dumped to the same {layer.weight: OIHW array} dict with caffe or
    protobuf parsing."""
    out: Dict[str, Tuple[str, str]] = {}
    vgg = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
           "conv3_3", "conv3_4", "conv4_1", "conv4_2"]

    def conv(flax_prefix, caffe_layer, bare=False):
        base = flax_prefix if bare else f"{flax_prefix}/conv"
        out[f"params/{base}/kernel"] = (f"{caffe_layer}.weight", "conv")
        out[f"params/{base}/bias"] = (f"{caffe_layer}.bias", "raw")

    for i, layer in enumerate(vgg):
        conv(f"vgg{i}", layer)
    conv("cpm0", "conv4_3_CPM")
    conv("cpm1", "conv4_4_CPM")
    for tag, L in (("L1", "L1"), ("L2", "L2")):
        for j in range(3):
            conv(f"s0_{tag}_{j}", f"conv5_{j + 1}_CPM_{L}")
        conv(f"s0_{tag}_3", f"conv5_4_CPM_{L}")
        conv(f"s0_{tag}_4", f"conv5_5_CPM_{L}", bare=True)
        for s in range(1, stages):
            st = s + 1  # caffe stages are 2..6
            for j in range(5):
                conv(f"s{s}_{tag}_{j}", f"Mconv{j + 1}_stage{st}_{L}")
            conv(f"s{s}_{tag}_5", f"Mconv6_stage{st}_{L}")
            conv(f"s{s}_{tag}_6", f"Mconv7_stage{st}_{L}", bare=True)
    return out


def port_openpose(params: Dict, state_dict: Mapping, stages: int = 6) -> Dict:
    return W.port_state_dict(params, state_dict, openpose_mapping(stages))


def openpose_crop_mapping(stages: int = 6) -> Dict[str, Tuple[str, str]]:
    """flax path -> caffe layer names for the CMU face/hand crop nets
    (pose_face/pose_hand deploy prototxts behind openpose_kernel.cpp:
    108-141). One mapping serves both: the nets share layer names and
    differ only in the head's channel count (71 vs 22)."""
    out: Dict[str, Tuple[str, str]] = {}

    def conv(name, caffe=None, bare=False):
        base = name if bare else f"{name}/conv"
        caffe = caffe or name
        out[f"params/{base}/kernel"] = (f"{caffe}.weight", "conv")
        out[f"params/{base}/bias"] = (f"{caffe}.bias", "raw")

    for blk, reps in (("conv1", 2), ("conv2", 2), ("conv3", 4),
                      ("conv4", 4)):
        for i in range(1, reps + 1):
            conv(f"{blk}_{i}")
    conv("conv5_1")
    conv("conv5_2")
    conv("conv5_3_CPM")
    conv("conv6_1_CPM")
    conv("conv6_2_CPM", bare=True)
    for s in range(2, stages + 1):
        for j in range(1, 7):
            conv(f"Mconv{j}_stage{s}")
        conv(f"Mconv7_stage{s}", bare=True)
    return out


def port_openpose_crop(params: Dict, state_dict: Mapping,
                       stages: int = 6) -> Dict:
    """Port a face (71-ch) or hand (22-ch) caffemodel state_dict."""
    return W.port_state_dict(params, state_dict,
                             openpose_crop_mapping(stages))


# --------------------------------------- Levi–Hassner gender (rude-carnie)

def gender_mapping() -> Dict[str, Tuple[str, str]]:
    """flax path -> rude-carnie TF checkpoint variable names
    (model.py scopes conv1/conv2/conv3/full1/full2/output with
    weights/biases). TF flattens conv activations NHWC — same order as
    flax — so the first dense kernel ports raw."""
    out: Dict[str, Tuple[str, str]] = {}
    for f, t in (("conv1", "conv1"), ("conv2", "conv2"), ("conv3", "conv3")):
        out[f"params/{f}/kernel"] = (f"{t}/weights", "tf_conv")
        out[f"params/{f}/bias"] = (f"{t}/biases", "raw")
    for f, t in (("fc1", "full1"), ("fc2", "full2"), ("fc3", "output")):
        out[f"params/{f}/kernel"] = (f"{t}/weights", "raw")  # TF [I, O]
        out[f"params/{f}/bias"] = (f"{t}/biases", "raw")
    return out


def port_gender(variables: Dict, tf_vars: Mapping) -> Dict:
    return W.port_state_dict(variables, tf_vars, gender_mapping())


# ------------------------------------------- Mask R-CNN (maskrcnn-benchmark)

def maskrcnn_mapping(arch: str = "X-101-32x8d-FPN") -> Dict[str, Tuple[str, str]]:
    """flax path (over the MaskRCNNModel ``variables`` dict:
    trunk/box/mask roots) -> maskrcnn-benchmark state_dict key
    (maskrcnn_detection.py:340-360's checkpoint; strip any leading
    ``module.``). FrozenBatchNorm2d's four tensors land on our frozen
    nn.BatchNorm params/batch_stats."""
    from .maskrcnn import ARCHS

    blocks = ARCHS[arch][0]
    out: Dict[str, Tuple[str, str]] = {}

    def conv(flax_path, torch_key, kind="conv", bias=False):
        out[f"{flax_path}/kernel"] = (f"{torch_key}.weight", kind)
        if bias:
            out[f"{flax_path}/bias"] = (f"{torch_key}.bias", "raw")

    def bn(flax_prefix, torch_prefix):
        out[f"trunk/params/backbone/{flax_prefix}/scale"] = (
            f"{torch_prefix}.weight", "raw")
        out[f"trunk/params/backbone/{flax_prefix}/bias"] = (
            f"{torch_prefix}.bias", "raw")
        out[f"trunk/batch_stats/backbone/{flax_prefix}/mean"] = (
            f"{torch_prefix}.running_mean", "raw")
        out[f"trunk/batch_stats/backbone/{flax_prefix}/var"] = (
            f"{torch_prefix}.running_var", "raw")

    conv("trunk/params/backbone/stem_conv", "backbone.body.stem.conv1")
    bn("stem_bn", "backbone.body.stem.bn1")
    for si, nb in enumerate(blocks):
        for bi in range(nb):
            f = f"layer{si + 1}b{bi}"
            t = f"backbone.body.layer{si + 1}.{bi}"
            for j in (1, 2, 3):
                conv(f"trunk/params/backbone/{f}/conv{j}", f"{t}.conv{j}")
                bn(f"{f}/bn{j}", f"{t}.bn{j}")
            if bi == 0:
                conv(f"trunk/params/backbone/{f}/downsample_conv",
                     f"{t}.downsample.0")
                bn(f"{f}/downsample_bn", f"{t}.downsample.1")
    for i in range(1, 5):
        conv(f"trunk/params/backbone/fpn_inner{i}",
             f"backbone.fpn.fpn_inner{i}", bias=True)
        conv(f"trunk/params/backbone/fpn_layer{i}",
             f"backbone.fpn.fpn_layer{i}", bias=True)
    conv("trunk/params/rpn/conv", "rpn.head.conv", bias=True)
    conv("trunk/params/rpn/cls_logits", "rpn.head.cls_logits", bias=True)
    conv("trunk/params/rpn/bbox_pred", "rpn.head.bbox_pred", bias=True)
    # box head: fc6 consumes the CHW-flattened 7x7x256 RoI
    out["box/params/fc6/kernel"] = (
        "roi_heads.box.feature_extractor.fc6.weight", "linear_conv:256,7,7")
    out["box/params/fc6/bias"] = (
        "roi_heads.box.feature_extractor.fc6.bias", "raw")
    for f, t in (("fc7", "roi_heads.box.feature_extractor.fc7"),
                 ("cls_score", "roi_heads.box.predictor.cls_score"),
                 ("bbox_pred", "roi_heads.box.predictor.bbox_pred")):
        out[f"box/params/{f}/kernel"] = (f"{t}.weight", "linear")
        out[f"box/params/{f}/bias"] = (f"{t}.bias", "raw")
    for i in range(1, 5):
        conv(f"mask/params/mask_fcn{i}",
             f"roi_heads.mask.feature_extractor.mask_fcn{i}", bias=True)
    conv("mask/params/conv5_mask", "roi_heads.mask.predictor.conv5_mask",
         kind="conv_transpose", bias=True)
    conv("mask/params/mask_fcn_logits",
         "roi_heads.mask.predictor.mask_fcn_logits", bias=True)
    return out


def port_maskrcnn(variables: Dict, state_dict: Mapping,
                  arch: str = "X-101-32x8d-FPN") -> Dict:
    """variables: MaskRCNNModel(...).variables; state_dict: the benchmark
    checkpoint's (``module.`` prefixes stripped)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    return _port_with_linear_conv(variables, sd, maskrcnn_mapping(arch))


# -------------------------------------------------------------- helpers

def faster_rcnn_mapping() -> Dict[str, Tuple[str, str]]:
    """flax path -> ``<caffe layer>.weight/.bias`` for a py-faster-rcnn
    VGG16 caffemodel (the net behind faster_rcnn_kernel.cpp; layer names
    from the public test.prototxt: conv1_1..conv5_3, rpn_conv/3x3,
    rpn_cls_score, rpn_bbox_pred, fc6, fc7, cls_score, bbox_pred). fc6
    flattens caffe's CHW pool5 — ported with the linear_conv permutation
    (512,7,7); every other dense is a plain [O,I] -> [I,O] transpose."""
    out: Dict[str, Tuple[str, str]] = {}

    def conv(flax_path, caffe_layer):
        out[f"params/{flax_path}/kernel"] = (f"{caffe_layer}.weight", "conv")
        out[f"params/{flax_path}/bias"] = (f"{caffe_layer}.bias", "raw")

    for blk, reps in (("conv1", 2), ("conv2", 2), ("conv3", 3),
                      ("conv4", 3), ("conv5", 3)):
        for i in range(1, reps + 1):
            conv(f"vgg/{blk}_{i}", f"{blk}_{i}")
    conv("rpn_conv", "rpn_conv/3x3")
    conv("rpn_cls_score", "rpn_cls_score")
    conv("rpn_bbox_pred", "rpn_bbox_pred")
    out["params/fc6/kernel"] = ("fc6.weight", "linear_conv:512,7,7")
    out["params/fc6/bias"] = ("fc6.bias", "raw")
    for d in ("fc7", "cls_score", "bbox_pred"):
        out[f"params/{d}/kernel"] = (f"{d}.weight", "linear")
        out[f"params/{d}/bias"] = (f"{d}.bias", "raw")
    return out


def port_faster_rcnn(variables: Dict, state_dict: Mapping) -> Dict:
    return _port_with_linear_conv(variables, state_dict,
                                  faster_rcnn_mapping())


def _port_with_linear_conv(params: Dict, state_dict: Dict,
                           mapping: Dict[str, Tuple[str, str]]) -> Dict:
    """port_state_dict variant supporting the 'linear_conv:C,H,W' kind."""
    flat = W._flatten(params)
    for flax_key, (torch_key, kind) in mapping.items():
        t = state_dict[torch_key]
        arr = np.asarray(getattr(t, "numpy", lambda: t)())
        if kind.startswith("linear_conv:"):
            c, h, wd = (int(x) for x in kind.split(":")[1].split(","))
            arr = linear_after_conv(arr, (c, h, wd))
        else:
            arr = W._KIND_FNS[kind](arr)
        if flax_key not in flat:
            raise KeyError(flax_key)
        if arr.shape != flat[flax_key].shape:
            raise ValueError(
                f"{flax_key}: {arr.shape} != {flat[flax_key].shape}")
        flat[flax_key] = arr.astype(flat[flax_key].dtype)
    return W._unflatten(flat)


def coverage_report(variables: Dict, mapping_paths) -> Tuple[set, set]:
    """(unmapped flax params, mapped-but-nonexistent paths) — both should
    be empty for a total mapping."""
    flat = set(W._flatten(variables))
    mapped = set(mapping_paths)
    return flat - mapped, mapped - flat
