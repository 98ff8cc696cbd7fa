"""The JAX package's default weights, family by family, and a digest that
holds a draw to them without JAX.

Each family is a model the port draws by default (an op without a
``weights_path``): its ``default_tree`` draws the JAX package's
``init_*(jax.random.PRNGKey(0))`` in torch, in the flax layout. The
committed file ``jax_defaults_digest.json`` holds, for every leaf of the
JAX package's own draw (written by ``scripts/jax_defaults_digest.py``
from the JAX package), its path, shape, float64 sum and sum of squares,
largest magnitude and 8 values at fixed flat indices; ``check_digest``
holds a torch draw to it. The 8 values and the largest magnitude agree
within ``RTOL`` of the leaf's largest magnitude (the inverse error
function is float64 here, XLA's float32 polynomial there), the sums
within what that bound allows over the leaf's elements; batch statistics
and the constant leaves (zeros, ones) exactly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..models import (facenet, facenet_detector, faster_rcnn, gender,
                      jax_random, maskrcnn, mtcnn, pose, ssd, streetstyle,
                      weights)
from ..parallel import dryrun, expert

DIGEST_PATH = os.path.join(os.path.dirname(__file__),
                           "jax_defaults_digest.json")
RTOL = 1e-6  # of a leaf's largest magnitude
N_SAMPLES = 8
MOE_DIMS = (8, 128, 256)  # MoEHead's defaults over FaceNet's embedding


# family -> (its default_tree, the arguments after the key): the JAX
# package's init_* for each (models/mtcnn.py, gender.py, facenet.py,
# facenet_detector.py, ssd.py, streetstyle.py's two, pose.py's body (6
# stages) and crop nets, faster_rcnn.py, maskrcnn.py's MaskRCNNModel in
# both archs, parallel/expert.py's init_moe_params at MOE_DIMS,
# parallel/dryrun.py), in the order of the draw
_DRAWS = {
    "mtcnn": (mtcnn.default_tree, ()),
    "gender": (gender.default_tree, ()),
    "facenet": (facenet.default_tree, ()),
    "facenet_detector": (facenet_detector.default_tree, ()),
    "ssd": (ssd.default_tree, ()),
    "streetstyle_clothing": (streetstyle.CLOTHING.default_tree, ()),
    "streetstyle_hairstyle": (streetstyle.HAIRSTYLE.default_tree, ()),
    "openpose": (pose.default_tree, ()),
    "openpose_face": (pose.FACE_NET.default_tree, ()),
    "openpose_hand": (pose.HAND_NET.default_tree, ()),
    "faster_rcnn": (faster_rcnn.default_tree, ()),
    "maskrcnn:R-50-FPN": (maskrcnn.default_tree, ("R-50-FPN",)),
    "maskrcnn:X-101-32x8d-FPN": (maskrcnn.default_tree,
                                 ("X-101-32x8d-FPN",)),
    "moe": (expert.default_tree, (MOE_DIMS,)),
    "dryrun": (dryrun.default_tree, ()),
}
FAMILIES: List[str] = list(_DRAWS)


def draw(family: str, device=None) -> Dict[str, Any]:
    """The family's default tree (flax layout), drawn on ``device`` (None:
    the card, as a ``Client``'s)."""
    from ..client import _resolve_device

    fn, args = _DRAWS[family]
    return fn(jax_random.prng_key(0, _resolve_device(device)), *args)


def flat(tree: Any) -> Dict[str, Any]:
    """A nested tree -> {slash path: leaf}, the leaves as they are."""
    return weights._flatten(tree, leaf=lambda v: v)


def sample_indices(n: int) -> List[int]:
    """N_SAMPLES fixed flat indices of a leaf of n elements: the first,
    the last and a multiplicative hash's spread between."""
    if n == 0:
        return []
    return sorted({0, n - 1} | {(i * 2654435761 + 97) % n
                                for i in range(N_SAMPLES - 2)})


def digest(tree: Any) -> Dict[str, Dict[str, Any]]:
    """{path: {shape, sum, sumsq, max_abs, idx, vals}} of a tree whose
    leaves are tensors (any device) or numpy arrays."""
    out = {}
    for path, leaf in sorted(flat(tree).items()):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        t64 = t.detach().reshape(-1).double()
        idx = sample_indices(t64.numel())
        out[path] = {
            "shape": list(t.shape),
            "sum": float(t64.sum()),
            "sumsq": float((t64 * t64).sum()),
            "max_abs": float(t64.abs().max()) if t64.numel() else 0.0,
            "idx": idx,
            "vals": t64[idx].cpu().tolist(),
        }
    return out


def load_reference() -> Dict[str, Dict[str, Any]]:
    with open(DIGEST_PATH) as f:
        return json.load(f)


def check_digest(got: Dict[str, Dict[str, Any]],
                 want: Dict[str, Dict[str, Any]]) -> float:
    """Hold a digest to the reference's (see the module docstring); raise
    AssertionError at the first leaf out of bounds. Returns the worst
    sampled difference over the leaf's largest magnitude."""
    if sorted(got) != sorted(want):
        raise AssertionError(
            f"paths differ: {sorted(set(got) ^ set(want))[:6]}")
    worst = 0.0
    for path, w in want.items():
        g = got[path]
        if g["shape"] != w["shape"] or g["idx"] != w["idx"]:
            raise AssertionError(f"{path}: shape {g['shape']} against "
                                 f"{w['shape']}")
        scale = w["max_abs"]
        n = int(np.prod(w["shape"]))
        exact = "batch_stats" in path.split("/") or path.endswith(
            ("/bias", "/scale", "/alpha"))
        tol = 0.0 if exact else RTOL * scale
        diffs = [abs(a - b) for a, b in zip(g["vals"], w["vals"])]
        diffs.append(abs(g["max_abs"] - scale))
        if max(diffs) > tol:
            raise AssertionError(f"{path}: sampled values differ by "
                                 f"{max(diffs)} > {tol}")
        if abs(g["sum"] - w["sum"]) > n * tol + 1e-9 * abs(w["sum"]) or \
                abs(g["sumsq"] - w["sumsq"]) > n * tol * (2 * scale + tol) \
                + 1e-9 * w["sumsq"]:
            raise AssertionError(f"{path}: sums {g['sum']}, {g['sumsq']} "
                                 f"against {w['sum']}, {w['sumsq']}")
        if scale:
            worst = max(worst, max(diffs) / scale)
    return worst
