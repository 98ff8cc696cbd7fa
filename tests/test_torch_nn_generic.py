"""The port's generic NN ops (``NNForward`` over the eight registry names,
its NetDescriptor, the facenet detector chain, ``MoEHead``) held to the
JAX package.

Both packages run on the same weights. For the registry forwards these are
the port's seeded weights (``init_params(0)``) carried to the JAX package
by each model's ``to_flax`` (no JAX initialisation: Faster R-CNN's alone
is 550 MB); for the facenet detector and the experts, the JAX package's
initialisation carried by ``from_flax`` or through the npz its
``save_params`` wrote. Inputs are made from a seed with numpy.

Tolerances, and why. The nets' outputs within 1e-5 of their largest value
(convolutions and products add in other orders; measured at most 3e-6 of
it, the gender logits'). The attribute heads' predictions and the SSD
boxes' keep sets are compared exactly (no seeded case is a near-tie).
Faster R-CNN at 64x96 has 216 anchors, fewer than its 300 RoIs: the JAX
package then emits a 301st row (ROADMAP queue 3), so the port's 300 rows
are held to JAX's first 300. MoE: routing, capacity slots and dropped
rows equal, values within 1e-6 of values near 1 (float32 products in
another order; measured 1.5e-7). The facenet detector chain's boxes within
1e-2 px of frames of 96 px: a difference d of the maps (measured 3.3e-5
of values up to 38) moves a box edge by d times its template's side (up
to 229 px), times ``exp`` of the size adjustment; measured 9.9e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import facenet_detector as JFD
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops import nn_generic as JN
from scannertools_tpu.parallel import expert as JE
from scannertools_tpu.utils.net_descriptor import NetDescriptor as JND
from scannertools_tpu_torch.models import facenet_detector as PFD
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.parallel import expert as PE
from scannertools_tpu_torch.utils.net_descriptor import NetDescriptor

RTOL = 1e-5  # of the largest |value|
MOE_ATOL = 1e-6
BOX_PX_ATOL = 1e-2
MEAN = (119.3, 110.6, 101.4)

# registry name -> a small input (NHWC; OpenPose's in [-0.5, 0.5])
REGISTRY_INPUTS = {
    "facenet_inception_resnet_v1": (2, 160, 160, 3),
    "ssd_mobilenet_v1": (2, 64, 64, 3),
    "gender_levi_hassner": (2, 227, 227, 3),
    "openpose_body": (1, 32, 32, 3),
    "facenet_detector": (2, 32, 48, 3),
    "faster_rcnn": (1, 64, 96, 3),
    "streetstyle_clothing": (2, 299, 299, 3),
    "streetstyle_hairstyle": (2, 299, 299, 3),
}


def test_registries_hold_the_same_names():
    assert sorted(PN._NN_REGISTRY) == sorted(JN._NN_REGISTRY) == sorted(
        REGISTRY_INPUTS)


@pytest.mark.parametrize("name", list(REGISTRY_INPUTS))
def test_nn_forward_matches_jax_registry(name):
    wname, _ = PN.get_model(name)
    lib = PFO._MODELS[wname]
    state = lib.init_params(0)
    tree = lib.to_flax(state)
    x = np.random.default_rng(3).uniform(0, 255, REGISTRY_INPUTS[name]) \
        .astype(np.float32)
    if name == "openpose_body":
        x = x / 255 - 0.5
    _, japply = JN.get_model(name)
    want = jax.jit(japply)(tree, x)
    want = np.asarray(want[0] if isinstance(want, (tuple, list)) else want)
    got = PN.nn_forward(None, state, torch.from_numpy(x), model=name) \
        .numpy()
    if name == "faster_rcnn":  # JAX's 301st row (see the docstring)
        assert want.shape[1] == got.shape[1] + 1
        want = want[:, :got.shape[1]]
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.int32:  # the attribute heads' predictions
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=RTOL * float(np.abs(want).max()))


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="no registered model"):
        PN.get_model("vgg_face")
    with pytest.raises(KeyError, match="no registered model"):
        PN._nn_aux(None, {"model": "vgg_face"})


DESCRIPTOR = """
[net]
model = "facenet_detector"
weights = "{weights}"
input_layers = ["data"]
output_layers = ["prob"]
pad_mod = 8
tranpose = false

[net.input]
channel_ordering = ["blue", "green", "red"]

[mean-image.colors]
red = 119.3
green = 110.6
blue = 101.4
"""


@pytest.fixture(scope="module")
def detector_npz(tmp_path_factory):
    """(JAX variables, npz path) of the JAX package's facenet detector."""
    v = jax.jit(JFD.init_params)(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("fd") / "facenet_detector.npz")
    JW.save_params(path, v)
    return jax.tree.map(np.asarray, v), path


def test_descriptor_resolves_like_jax(tmp_path, detector_npz):
    _, weights = detector_npz
    path = tmp_path / "facenet.toml"
    path.write_text(DESCRIPTOR.format(weights=weights))
    got, want = NetDescriptor.from_file(str(path)), JND.from_file(str(path))
    assert vars(got) == vars(want)
    assert got.mean_colors == [101.4, 110.6, 119.3] and got.pad_mod == 8
    assert PN._resolve_descriptor("", str(path), None) == \
        JN._resolve_descriptor("", str(path), None) == \
        ("facenet_detector", weights)
    # the op's weights: the descriptor's npz, through from_flax
    aux = PN._nn_aux(None, {"descriptor_path": str(path)})
    assert aux is PFO._get_params("facenet_detector", weights)


def test_facenet_detector_weights_round_trip(detector_npz):
    v, path = detector_npz
    state = PFD.from_flax(v)
    flat, back = JW._flatten(v), PW._flatten(PFD.to_flax(state))
    assert sorted(flat) == sorted(back)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    loaded = PFO._get_params("facenet_detector", path)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    # a stride-2 convolution on an even side pads (0, 1): 48x64 -> 6x8
    out = PFD.apply(state, torch.zeros(1, 48, 64, 3))
    assert out.shape == (1, 6, 8, PFD.N_TEMPLATES * 5)


def _detector_chain(pkg, db, path, weights, descriptor=None):
    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "v", path=path)])
    g = sc.streams.Gather(frame, [[0, 1, 70, 130]])
    pre = sc.ops.NNInput(frame=g, mean_colors=MEAN, pad_mod=8)
    if descriptor:
        maps = sc.ops.NNForward(input=pre, descriptor_path=descriptor)
    else:
        maps = sc.ops.NNForward(input=pre, model="facenet_detector",
                                weights_path=weights)
    info = sc.ops.InfoFromFrame(frames=g)
    faces = sc.ops.FacenetOutput(scores=maps, frame_info=info)
    outs = [pkg.NamedStream(sc, n) for n in ("maps", "faces")]
    sc.run(sc.io.Output([maps, faces], [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=2, ingest="rgb"),
           cache_mode=pkg.CacheMode.Overwrite)
    return [list(o.load()) for o in outs]


def test_facenet_detector_chain_matches_jax(tmp_path, test_video,
                                            detector_npz):
    _, weights = detector_npz
    desc = tmp_path / "facenet.toml"
    desc.write_text(DESCRIPTOR.format(weights=weights))
    maps, faces = _detector_chain(st, str(tmp_path / "t"),
                                  test_video["path"], weights)
    jmaps, jfaces = _detector_chain(jst, str(tmp_path / "j"),
                                    test_video["path"], weights)
    dmaps, dfaces = _detector_chain(st, str(tmp_path / "d"),
                                    test_video["path"], None, str(desc))
    scale = max(float(np.abs(m).max()) for m in jmaps)
    for a, b, c in zip(maps, jmaps, dmaps):
        assert a.shape == b.shape == (8, 12, 125)  # 64x96: no padding
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale)
        np.testing.assert_array_equal(a, c)
    assert sum(len(f) for f in faces) > 0
    assert [len(f) for f in faces] == [len(f) for f in jfaces] == \
        [len(f) for f in dfaces]
    for f, jf in zip(faces, jfaces):
        np.testing.assert_allclose([[b.x1, b.y1, b.x2, b.y2] for b in f],
                                   [[b.x1, b.y1, b.x2, b.y2] for b in jf],
                                   rtol=0, atol=BOX_PX_ATOL)


# ------------------------------------------------------------ experts


@pytest.fixture(scope="module")
def moe():
    """The JAX package's init_moe_params(PRNGKey(0), 4, 16, 32) (numpy)
    and 24 seeded rows."""
    p = jax.tree.map(np.asarray,
                     JE.init_moe_params(jax.random.PRNGKey(0), 4, 16, 32))
    x = np.random.default_rng(0).normal(size=(24, 16)).astype(np.float32)
    return p, x


def test_dispatch_mask_matches_jax(moe):
    p, x = moe
    logits = x @ p["router"]
    for cap in (1, 3, 12):
        want = np.asarray(JE._dispatch_mask(jnp.asarray(logits), cap))
        got = PE._dispatch_mask(torch.from_numpy(logits), cap).numpy()
        assert got.shape == want.shape == (24, 4, cap)
        np.testing.assert_array_equal(got > 0, want > 0)  # routing, slots
        np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)


# (capacity_batch, capacity_factor): 0 sizes the capacity from the chunk
# (max(1, int(2 * 24 / 4)) = 12, nothing dropped); 4 at factor 2 gives 2
# slots an expert, so tokens are dropped
@pytest.mark.parametrize("capacity_batch,factor,dropped", [
    (0, 2.0, False), (4, 2.0, True), (24, 1.0, True), (96, 2.0, False)])
def test_moe_head_matches_moe_reference(moe, capacity_batch, factor,
                                        dropped):
    p, x = moe
    cap = max(1, int(factor * capacity_batch / 4)) if capacity_batch else 0
    want = np.asarray(jax.jit(lambda p, x: JE.moe_reference(
        p, x, capacity_factor=factor, capacity=cap))(p, x))
    state = PE.MOE.from_flax(p, (4, 16, 32))
    got = PN.moe_head(None, state, x.reshape(24, 4, 4), n_experts=4,
                      d_model=16, d_hidden=32, capacity_factor=factor,
                      capacity_batch=capacity_batch).numpy()
    zero = ~np.abs(got).any(axis=1)
    np.testing.assert_array_equal(zero, ~np.abs(want).any(axis=1))
    assert zero.any() == dropped
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)


def test_moe_head_checks_widths(moe, tmp_path):
    p, x = moe
    state = PE.MOE.from_flax(p, (4, 16, 32))
    with pytest.raises(ValueError, match="d_model=8"):
        PN.moe_head(None, state, x, n_experts=4, d_model=8, d_hidden=32)
    with pytest.raises(ValueError, match="requires d_model"):
        PN._moe_aux(None, {"n_experts": 4})
    path = str(tmp_path / "moe.npz")
    JW.save_params(path, p)
    with pytest.raises(ValueError, match="shapes"):  # dims not the file's
        PN._moe_aux(None, {"n_experts": 4, "d_model": 16, "d_hidden": 8,
                           "weights_path": path})
    aux = PN._moe_aux(None, {"n_experts": 4, "d_model": 16,
                             "d_hidden": 32, "weights_path": path})
    assert all(np.array_equal(aux[k].numpy(), p[k]) for k in p)
    seeded = PE.init_moe_params(0, 4, 16, 32)
    assert {k: tuple(v.shape) for k, v in seeded.items()} == \
        {k: v.shape for k, v in p.items()}
    # He-normal: variance 2 / fan_in, fan_in the leading axes times F
    assert abs(float(seeded["w1"].std()) - (2 / 64) ** 0.5) < 0.02


def test_moe_head_pipeline_matches_jax(tmp_path, moe):
    """MoEHead over the rows of an in-process stream, chunks of 8, in
    both packages, the capacity pinned by capacity_batch (2 slots an
    expert a chunk, so rows are dropped)."""
    p, x = moe
    path = str(tmp_path / "moe.npz")
    JW.save_params(path, p)
    outs = []
    for pkg in (st, jst):
        kw = dict(device="cpu") if pkg is st else {}
        sc = pkg.Client(db_path=str(tmp_path / pkg.__name__), **kw)
        rows = sc.io.Input([pkg.PythonStream(list(x))])
        y = sc.ops.MoEHead(input=rows, n_experts=4, d_model=16, d_hidden=32,
                           capacity_batch=4, weights_path=path)
        out = pkg.NamedStream(sc, "moe")
        sc.run(sc.io.Output(y, [out]),
               pkg.PerfParams.manual(work_packet_size=8),
               cache_mode=pkg.CacheMode.Overwrite)
        outs.append(np.stack(list(out.load())))
    got, want = outs
    assert got.shape == want.shape == (24, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ATOL)
    assert (~got.any(axis=1)).any()

