"""Model zoo: torch implementations of the reference's NN ops, with the
JAX package's architectures and the torch names of models/porting_maps.py
(SURVEY §2a/2f).

Pretrained weights are not bundled (no-egress build environment); load them
as an npz in the JAX package's layout via models/weights.py."""

from . import (common, facenet, facenet_detector,  # noqa: F401
               faster_rcnn, gender, maskrcnn, mtcnn, porting_maps, pose,
               ssd, streetstyle, weights)
