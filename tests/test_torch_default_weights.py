"""The port's default weights held to the JAX package's, family by family:
what an op draws without a ``weights_path`` (``weights.default_params``:
the JAX package's ``init_*(jax.random.PRNGKey(0))`` drawn in torch by
``models/jax_random.py``), against the JAX package's own draw.

For each family the default tree (flax layout, ``default_tree``) has the
JAX tree's paths and shapes, its batch statistics are exact, and every
params leaf is within 1e-6 of the leaf's largest magnitude (XLA's
float32 ``erf_inv`` against a float64 one; the worst measured is 2.4e-7
of it). Then the same weights, the port's default draw as the op holds
it and in the flax layout, go through the port's forward and the JAX
forward, which agree to the tolerances the parity tests state: the nets'
outputs within 1e-5 of their largest value and the attribute heads'
predictions equal (tests/test_torch_nn_generic.py), MTCNN's keep sets
equal and boxes within 2e-3 px (tests/test_torch_faces.py), its scores
within 3e-5 (the face tests hold 1e-5 on the JAX package's draw; on the
port's the cascade's float32 sums in another order move one of 64 scores
near 0.62 by 1.2e-5), MoE within 1e-6 (values near 1), the dry
run's loss within 1e-5 of JAX's on JAX's own draw
(tests/test_torch_dryrun.py).

Families here: MTCNN, gender, FaceNet, the facenet detector, SSD, both
StreetStyle head sets, OpenPose's body at 2 stages (the same key paths as
6: its scopes are named by stage) and both crop nets, MoE and the dry
run. Mask R-CNN and the three large inits (Faster R-CNN, Mask R-CNN
X-101, OpenPose at 6 stages) have files of their own.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from scannertools_tpu.models import facenet as JF
from scannertools_tpu.models import facenet_detector as JFD
from scannertools_tpu.models import gender as JG
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import pose as JP
from scannertools_tpu.models import ssd as JS
from scannertools_tpu.models import streetstyle as JSS
from scannertools_tpu.ops import nn_generic as JN
from scannertools_tpu.parallel import dryrun as JD
from scannertools_tpu.parallel import expert as JE
from scannertools_tpu_torch.models import facenet as PF
from scannertools_tpu_torch.models import facenet_detector as PFD
from scannertools_tpu_torch.models import gender as PG
from scannertools_tpu_torch.models import jax_random as JR
from scannertools_tpu_torch.models import mtcnn as PM
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.models import ssd as PS
from scannertools_tpu_torch.models import streetstyle as PSS
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.parallel import dryrun as PD
from scannertools_tpu_torch.parallel import expert as PE
from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV

LEAF_RTOL = 1e-6   # of a leaf's largest magnitude
NET_RTOL = 1e-5    # of the output's largest magnitude
BOX_PX_ATOL = 2e-3
SCORE_ATOL = 3e-5  # MTCNN scores, see the docstring
MOE_ATOL = 1e-6
MOE_DIMS = (4, 24, 16)

KEY = jax.random.PRNGKey(0)

# family -> (the JAX package's draw, the port's default tree)
FAMILIES = {
    "mtcnn": (lambda: JM.init_params(KEY), PM.default_tree),
    "gender": (lambda: JG.init_params(KEY), PG.default_tree),
    "facenet": (lambda: JF.init_params(KEY), PF.default_tree),
    "facenet_detector": (lambda: JFD.init_params(KEY), PFD.default_tree),
    "ssd": (lambda: JS.init_params(KEY), PS.default_tree),
    "streetstyle_clothing": (lambda: JSS.init_params_clothing(KEY),
                             PSS.CLOTHING.default_tree),
    "streetstyle_hairstyle": (lambda: JSS.init_params_hairstyle(KEY),
                              PSS.HAIRSTYLE.default_tree),
    "openpose@2": (lambda: JP.init_params(KEY, stages=2),
                   lambda k: PP.default_tree(k, 2)),
    "openpose_face": (lambda: JP.init_face_params(KEY),
                      PP.FACE_NET.default_tree),
    "openpose_hand": (lambda: JP.init_hand_params(KEY),
                      PP.HAND_NET.default_tree),
    "moe": (lambda: JE.init_moe_params(KEY, *MOE_DIMS),
            lambda k: PE.default_tree(k, MOE_DIMS)),
    "dryrun": (lambda: JD.init_params(KEY), PD.default_tree),
}


@functools.lru_cache(maxsize=None)
def jax_tree(family):
    return jax.tree_util.tree_map(np.asarray, FAMILIES[family][0]())


@functools.lru_cache(maxsize=None)
def port_tree(family):
    """The port's default draw in the flax layout, as numpy: the weights
    both forwards take."""
    return PW._unflatten(_flat(FAMILIES[family][1](JR.prng_key(0, "cpu"))))


def _flat(tree):
    return PW._flatten(tree, leaf=lambda v: v.numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v))


def assert_tree_close(got, want) -> float:
    """Paths and shapes equal, batch statistics exact, params within
    LEAF_RTOL of each leaf's largest magnitude -> the worst ratio."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    worst = 0.0
    for path, a in w.items():
        b = g[path]
        assert b.shape == a.shape and b.dtype == np.float32, path
        if "batch_stats" in path.split("/"):
            np.testing.assert_array_equal(b, a, err_msg=path)
            continue
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = float(np.abs(b - a).max()) if a.size else 0.0
        assert err <= LEAF_RTOL * scale, (path, err, scale)
        if scale:
            worst = max(worst, err / scale)
    return worst


@pytest.mark.parametrize("family", list(FAMILIES))
def test_default_tree_matches_jax_init(family):
    got = FAMILIES[family][1](JR.prng_key(0, "cpu"))
    worst = assert_tree_close(got, jax_tree(family))
    assert worst < 5e-7  # measured at most 2.4e-7


def _close(got, want, rtol=NET_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# registry name -> (family, one row of test_torch_nn_generic.py's input)
REGISTRY = {
    "facenet_inception_resnet_v1": ("facenet", (1, 160, 160, 3)),
    "ssd_mobilenet_v1": ("ssd", (1, 64, 64, 3)),
    "gender_levi_hassner": ("gender", (1, 227, 227, 3)),
    "facenet_detector": ("facenet_detector", (1, 32, 48, 3)),
    "streetstyle_clothing": ("streetstyle_clothing", (1, 299, 299, 3)),
    "streetstyle_hairstyle": ("streetstyle_hairstyle", (1, 299, 299, 3)),
}


@pytest.mark.parametrize("name", list(REGISTRY))
def test_registry_forward_on_default_weights(name):
    """``NNForward``'s forward on the op's own default weights (its aux
    with no weights_path) against the JAX registry's forward on the same
    weights."""
    family, shape = REGISTRY[name]
    state = PN._nn_aux(None, {"model": name})
    x = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    want = jax.jit(JN.get_model(name)[1])(port_tree(family), x)
    want = np.asarray(want[0] if isinstance(want, (tuple, list)) else want)
    got = PN.nn_forward(None, state, torch.from_numpy(x), model=name) \
        .numpy()
    if got.dtype == np.int32:  # the attribute heads' predictions
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


def test_default_params_cached_per_device():
    """The op's weight cache keys a default draw on its device, and a
    direct aux call (no executor context) draws on the CPU."""
    a = PFO._get_params("gender", None)
    assert a is PFO._get_params("gender", None, device="cpu")
    assert ("gender", None, "cpu") in PFO._MODEL_CACHE
    assert a is PFO._gender_aux(None, {})
    assert all(v.device.type == "cpu" for v in a.values())


@pytest.mark.parametrize("draw", ["default_params", "MaskRCNNModel",
                                  "dryrun", "jax_defaults"])
def test_default_draws_go_to_the_card_unless_asked(draw):
    """A public draw with no device draws where a ``Client()`` runs: on
    the card, and with none it raises rather than drawing on the CPU."""
    from scannertools_tpu_torch.models import maskrcnn as PMR
    from scannertools_tpu_torch.tools import jax_defaults as JDF

    fn = {"default_params": lambda: PW.default_params(PE, (2, 4, 8)),
          "MaskRCNNModel": lambda: PMR.MaskRCNNModel(0).variables,
          "dryrun": PD.default_params,
          "jax_defaults": lambda: JDF.draw("dryrun")}[draw]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            fn()
        return
    leaves = PW._flatten(fn(), leaf=lambda t: t).values()
    assert all(t.device.type == "cuda" for t in leaves)


def test_mtcnn_cascade_on_default_weights():
    """The cascade at zero thresholds (random nets keep no face at the
    reference's) on two frames: keep sets equal, boxes and scores within
    the face tests' bounds."""
    zero = (0.0, 0.0, 0.0)
    state = PFO._get_params("mtcnn", None)
    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3)) \
        .astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(
        lambda p, f: JM.detect_batch(p, f, zero))(port_tree("mtcnn"),
                                                  frames)]
    got = [a.numpy() for a in PM.detect_batch(state, torch.from_numpy(
        frames), zero)]
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[2].sum(axis=1) > 10).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_PX_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_ATOL)


def test_openpose_body_forward_on_default_weights():
    state = PP.from_flax(port_tree("openpose@2"))
    x = np.random.default_rng(5).uniform(-0.5, 0.5, (1, 48, 64, 3)) \
        .astype(np.float32)
    heat, paf = jax.jit(JP.OpenPoseBody(stages=2).apply)(
        port_tree("openpose@2"), x)
    gh, gp = PP.body_maps(state, torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(gh.permute(0, 2, 3, 1).numpy(), heat)
    _close(gp.permute(0, 2, 3, 1).numpy(), paf)


@pytest.mark.parametrize("family,n_out", [("openpose_face", 71),
                                          ("openpose_hand", 22)])
def test_crop_nets_forward_on_default_weights(family, n_out):
    state = PFO._get_params(family, None)
    x = np.random.default_rng(6).uniform(-0.5, 0.5, (2, 32, 32, 3)) \
        .astype(np.float32)
    want = jax.jit(JP.OpenPoseCrop(n_out).apply)(port_tree(family), x)
    got = PP.crop_maps(state, torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_moe_on_default_weights():
    """``MoEHead``'s default experts (its aux: the JAX package's
    ``init_moe_params(PRNGKey(0), E, F, H)``) through the reference
    formulation of each package."""
    e, f, h = MOE_DIMS
    state = PN._moe_aux(None, {"n_experts": e, "d_model": f,
                               "d_hidden": h})
    x = np.random.default_rng(7).normal(size=(40, f)).astype(np.float32)
    want = np.asarray(jax.jit(JE.moe_reference)(port_tree("moe"), x))
    got = PE.moe_reference(state, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)  # the dropped rows
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_default_loss_matches_jax(monkeypatch, n):
    """The dry run on its default weights (the JAX package's
    ``init_params(PRNGKey(0))``, drawn by the port) against JAX's run on
    its own: one sharded step's loss within 1e-5."""
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")
    want = JD.run_dryrun(n)
    got = PD.run_dryrun(n, device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)
    PD.run_pp_sp_dryrun(n, device="cpu")  # its MoE on PRNGKey(3)'s draw
