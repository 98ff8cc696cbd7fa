"""NetDescriptor — TOML model-descriptor configs.

Reference parity: scannertools/scannertools/net_descriptor.py:5-152 (TOML →
NetDescriptor proto: model/weights paths, in/out layer names, input dims,
mean colors, normalize/transpose/pad_mod flags) used by the generic Caffe
op (caffe_kernel.cpp:81-260). Here the descriptor drives the generic
``NNForward``/``NNInput`` ops (ops/nn_generic.py) with model registry
names instead of caffe prototxt paths. A copy of the JAX package's
utils/net_descriptor.py (scannertools_tpu), which imports no JAX.
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import List


@dataclasses.dataclass
class NetDescriptor:
    model_path: str = ""
    model_weights_path: str = ""
    input_layer_names: List[str] = dataclasses.field(default_factory=list)
    output_layer_names: List[str] = dataclasses.field(default_factory=list)
    input_width: int = -1
    input_height: int = -1
    normalize: bool = False
    preserve_aspect_ratio: bool = False
    transpose: bool = False
    pad_mod: int = -1
    uses_python: bool = False
    mean_colors: List[float] = dataclasses.field(default_factory=list)

    @classmethod
    def from_file(cls, path: str) -> "NetDescriptor":
        with open(path, "rb") as f:
            args = tomllib.load(f)
        return cls.from_dict(args)

    @classmethod
    def from_dict(cls, args: dict) -> "NetDescriptor":
        net = args["net"]
        d = cls(
            model_path=net["model"],
            model_weights_path=net["weights"],
            input_layer_names=list(net["input_layers"]),
            output_layer_names=list(net["output_layers"]),
            input_width=net.get("input_width", -1),
            input_height=net.get("input_height", -1),
            normalize=net.get("normalize", False),
            preserve_aspect_ratio=net.get("preserve_aspect_ratio", False),
            # the reference reads the misspelled 'tranpose' key
            # (net_descriptor.py:134); accept both
            transpose=net.get("transpose", net.get("tranpose", False)),
            pad_mod=net.get("pad_mod", -1),
            uses_python=net.get("uses_python", False),
        )
        mean = args.get("mean-image", {})
        if "colors" in mean:
            order = net["input"]["channel_ordering"]
            d.mean_colors = [mean["colors"][c] for c in order]
        elif "image" in mean:
            raise NotImplementedError(
                "binaryproto mean images are not supported (the reference "
                "raises here too, net_descriptor.py:147)"
            )
        return d
