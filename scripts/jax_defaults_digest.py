#!/usr/bin/env python3
"""Write the digest of the JAX package's default weights.

For each family of ``scannertools_tpu_torch/tools/jax_defaults.py`` this
runs the JAX package's own ``init_*(jax.random.PRNGKey(0))`` (the draw
its ops make without a ``weights_path``) and writes every leaf's path,
shape, sums, largest magnitude and 8 sampled values to
``scannertools_tpu_torch/tools/jax_defaults_digest.json``, which the
port's tests and ``chip_smoke.py`` hold the torch draw to with no JAX.

    JAX_PLATFORMS=cpu python scripts/jax_defaults_digest.py [--check]

``--check`` compares with the committed file instead of writing it
(exit 1 on a difference). About 2 minutes on a CPU: Faster R-CNN's
init alone takes about 24 s, Mask R-CNN X-101's 22 s.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from scannertools_tpu_torch.tools import jax_defaults  # noqa: E402


def jax_tree(family: str):
    """The JAX package's default draw of ``family``, as numpy."""
    from scannertools_tpu.models import (facenet, facenet_detector,
                                         faster_rcnn, gender, maskrcnn,
                                         mtcnn, pose, ssd, streetstyle)
    from scannertools_tpu.parallel import dryrun, expert

    key = jax.random.PRNGKey(0)
    if family.startswith("maskrcnn:"):
        tree = maskrcnn.MaskRCNNModel(key, arch=family.split(":")[1]) \
            .variables
    else:
        tree = {
            "mtcnn": mtcnn.init_params,
            "gender": gender.init_params,
            "facenet": facenet.init_params,
            "facenet_detector": facenet_detector.init_params,
            "ssd": ssd.init_params,
            "streetstyle_clothing": streetstyle.init_params_clothing,
            "streetstyle_hairstyle": streetstyle.init_params_hairstyle,
            "openpose": pose.init_params,
            "openpose_face": pose.init_face_params,
            "openpose_hand": pose.init_hand_params,
            "faster_rcnn": faster_rcnn.init_params,
            "moe": lambda k: expert.init_moe_params(
                k, *jax_defaults.MOE_DIMS),
            "dryrun": dryrun.init_params,
        }[family](key)
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_digest(families=None):
    return {f: jax_defaults.digest(jax_tree(f))
            for f in (families or jax_defaults.FAMILIES)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    got = jax_digest()
    if args.check:
        same = got == jax_defaults.load_reference()
        print("digest equal" if same else "digest DIFFERS")
        return 0 if same else 1
    with open(jax_defaults.DIGEST_PATH, "w") as f:
        json.dump(got, f, separators=(",", ":"))
    print(f"wrote {jax_defaults.DIGEST_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
