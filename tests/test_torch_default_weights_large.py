"""The default weights of every family held to the committed digest of
the JAX package's draw (``tools/jax_defaults.py``,
``jax_defaults_digest.json``), and the three large inits element by
element under ``slow``.

The digest is what ``chip_smoke.py`` holds the draw on the card to. In
the quick tier every family but Mask R-CNN X-101 (its own file) is
drawn on the CPU and held to it: paths and shapes equal, 8 sampled
values and the largest magnitude of each leaf within 1e-6 of that
magnitude, the float64 sums within what that bound allows, batch
statistics and constant leaves exact. Faster R-CNN (138,307,339
parameters; the JAX init takes about 24 s here) and OpenPose at 6 stages
(52,311,446; 10 s) are held this way; element by element, with their
forwards on the same weights in both packages, under ``slow``, where a
test also writes the digest anew from the JAX package and requires it
to equal the committed file.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from scannertools_tpu.models import faster_rcnn as JFR
from scannertools_tpu.models import pose as JP
from scannertools_tpu.ops import nn_generic as JN
from scannertools_tpu_torch.models import faster_rcnn as PFR
from scannertools_tpu_torch.tools import jax_defaults as JDF
from scannertools_tpu_torch.models import jax_random as JR
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.ops import nn_generic as PN
from test_torch_default_weights import _close, assert_tree_close

KEY = jax.random.PRNGKey(0)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "jax_defaults_digest.py")


def test_digest_names_every_family():
    ref = JDF.load_reference()
    assert list(ref) == JDF.FAMILIES
    assert sum(len(v) for v in ref.values()) > 2000


@pytest.mark.parametrize("family", [f for f in JDF.FAMILIES
                                    if f != "maskrcnn:X-101-32x8d-FPN"])
def test_default_tree_matches_digest(family):
    got = JDF.digest(JDF.draw(family, "cpu"))
    assert JDF.check_digest(got, JDF.load_reference()[family]) < 5e-7


def test_digest_check_catches_a_changed_leaf():
    """The check is not vacuous: one sampled value moved by 2e-6 of its
    leaf's scale, a sum moved past its bound (n elements times 1e-6 of
    the scale), or a shape changed, and it raises."""
    want = JDF.load_reference()["gender"]
    got = JDF.digest(JDF.draw("gender", "cpu"))
    path = "params/conv1/kernel"
    scale = want[path]["max_abs"]
    n = int(np.prod(want[path]["shape"]))
    for field, change in (("vals", lambda g: [g[0] + 2e-6 * scale]
                           + g[1:]), ("sum", lambda g: g + 2e-6 * n * scale),
            ("shape", lambda g: g[:-1] + [g[-1] + 1])):
        bad = {k: dict(v) for k, v in got.items()}
        bad[path][field] = change(bad[path][field])
        with pytest.raises(AssertionError):
            JDF.check_digest(bad, want)


@pytest.mark.slow
def test_faster_rcnn_default_tree_matches_jax_init():
    want = jax.tree_util.tree_map(np.asarray, JFR.init_params(KEY))
    got = PFR.default_tree(JR.prng_key(0, "cpu"))
    assert assert_tree_close(got, want) < 5e-7


@pytest.mark.slow
def test_openpose_default_tree_matches_jax_init():
    want = jax.tree_util.tree_map(np.asarray, JP.init_params(KEY))
    got = PP.default_tree(JR.prng_key(0, "cpu"))
    assert assert_tree_close(got, want) < 5e-7


@pytest.mark.slow
@pytest.mark.parametrize("name,shape", [("faster_rcnn", (1, 64, 96, 3)),
                                        ("openpose_body", (1, 32, 32, 3))])
def test_registry_forward_on_default_weights(name, shape):
    """NNForward on the op's default weights against the JAX registry's
    forward on the same weights (their flax layout), within 1e-5 of the
    output's largest value; Faster R-CNN's 301st JAX row dropped as in
    tests/test_torch_nn_generic.py."""
    state = PN._nn_aux(None, {"model": name})
    lib = PN._MODELS[PN.get_model(name)[0]]
    tree = jax.tree_util.tree_map(np.asarray, lib.to_flax(state))
    x = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    if name == "openpose_body":
        x = x / 255 - 0.5
    want = jax.jit(JN.get_model(name)[1])(tree, x)
    want = np.asarray(want[0] if isinstance(want, (tuple, list)) else want)
    got = PN.nn_forward(None, state, torch.from_numpy(x), model=name) \
        .numpy()
    if name == "faster_rcnn":
        want = want[:, :got.shape[1]]
    _close(got, want)


@pytest.mark.slow
def test_committed_digest_equals_the_jax_draw():
    spec = importlib.util.spec_from_file_location("jax_defaults_digest",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.jax_digest() == JDF.load_reference()
