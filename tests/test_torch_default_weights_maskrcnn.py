"""Mask R-CNN's default weights (the JAX package's ``MaskRCNNModel(
jax.random.PRNGKey(0), arch).variables``: the trunk's ``init`` on the
key, the box and mask heads' on the two keys of ``split(key)``) drawn by
the port, held to the JAX package's draw, and its ``init_shapes``.

R-50-FPN element by element: the JAX tree's paths and shapes, batch
statistics exact, every params leaf within 1e-6 of its largest magnitude
(measured 2.4e-7 of it); then the same weights, the op's default draw
and its flax layout, through the port's trunk and heads and the JAX
package's, within 1e-5 of each output's largest value (the bound of
tests/test_torch_maskrcnn.py). X-101-32x8d-FPN (107,837,877 parameters;
the JAX init takes about 22 s here) is held by the committed digest of
the JAX package's draw (``tools/jax_defaults.py``) in the quick tier,
element by element under ``slow``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from scannertools_tpu.models import maskrcnn as JM
from scannertools_tpu_torch.tools import jax_defaults as JDF
from scannertools_tpu_torch.models import jax_random as JR
from scannertools_tpu_torch.models import maskrcnn as PM
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.models import weights as PW
from test_torch_default_weights import _close, assert_tree_close
from test_torch_maskrcnn import _jax_model

X101 = "X-101-32x8d-FPN"


@functools.lru_cache(maxsize=None)
def jax_variables(arch):
    return jax.tree_util.tree_map(
        np.asarray, JM.MaskRCNNModel(jax.random.PRNGKey(0), arch=arch)
        .variables)


def test_r50_default_tree_matches_jax_init():
    got = PM.default_tree(JR.prng_key(0, "cpu"), "R-50-FPN")
    assert assert_tree_close(got, jax_variables("R-50-FPN")) < 5e-7


def test_r50_forward_on_default_weights():
    """The op's default R-50-FPN weights (its aux with no weights_path)
    through the port's backbone, RPN and heads, and the same weights in
    the flax layout through the JAX package's."""
    state = PFO._get_params("maskrcnn", None, "R-50-FPN")
    v = PM.to_flax(state, "R-50-FPN")
    model = _jax_model("R-50-FPN")
    rng = np.random.default_rng(4)
    images = rng.uniform(-120, 150, (1, 64, 96, 3)).astype(np.float32)
    roi7 = rng.normal(0, 100, (3, 7, 7, 256)).astype(np.float32)
    roi14 = rng.normal(0, 100, (3, 14, 14, 256)).astype(np.float32)
    fpn, rpn = jax.jit(model.trunk.apply)(v["trunk"], images)
    cls, deltas = jax.jit(model.box_head.apply)(v["box"], roi7)
    masks = jax.jit(model.mask_head.apply)(v["mask"], roi14)
    net = PM.MaskRCNN("R-50-FPN")
    net.load_state_dict(state)
    with torch.no_grad():
        pfpn = net.backbone(torch.from_numpy(images).permute(0, 3, 1, 2))
        for p, f in zip(pfpn, fpn):
            _close(p.permute(0, 2, 3, 1).numpy(), f)
        for p, (logits, d) in zip(pfpn, rpn):
            pl, pd = net.rpn(p)
            _close(pl.numpy(), np.asarray(logits).reshape(1, -1))
            _close(pd.numpy(), np.asarray(d).reshape(1, -1, 4))
        for g, w in zip(net.box(torch.from_numpy(roi7)), (cls, deltas)):
            _close(g.numpy(), w)
        _close(net.mask(torch.from_numpy(roi14)).permute(0, 2, 3, 1)
               .numpy(), masks)


@pytest.mark.parametrize("arch", ["R-50-FPN", X101])
def test_init_shapes_equal_jax(arch):
    """The shape tree with no draw: the JAX package's ``init_shapes``
    (``jax.eval_shape``) leaf for leaf, as tensors on the meta device."""
    got = PW._flatten(PM.init_shapes(arch), leaf=lambda t: t)
    want = PW._flatten(JM.init_shapes(arch), leaf=lambda s: s)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(s.shape), k


def test_x101_default_tree_matches_digest():
    got = JDF.digest(PM.default_tree(JR.prng_key(0, "cpu"), X101))
    assert JDF.check_digest(got, JDF.load_reference()[
        "maskrcnn:" + X101]) < 5e-7


@pytest.mark.slow
def test_x101_default_tree_matches_jax_init():
    got = PM.default_tree(JR.prng_key(0, "cpu"), X101)
    assert assert_tree_close(got, jax_variables(X101)) < 5e-7
