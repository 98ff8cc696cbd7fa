"""The port's pose nets and pipelines held to the JAX package.

Both packages run on the same weights: the port's seeded initialisation
(``init_params``, ``init_face_params``, ``init_hand_params``) carried to
the JAX package's flax layout by ``to_flax``/``crop_to_flax`` and, for the
pipelines, written as npz files that both packages load. Seeded weights
leave the body's maps near 1e-3 (LeCun-normal layers under ReLU shrink the
signal), where no pixel clears the peak threshold; the pipelines' body
scales its two output layers by HEAD_SCALE so that peaks and feasible limbs
appear (the test video, a flat colour with a moving bar, still forms no
person: the decode with the crop nets runs on people patched into the
grouping of both packages, as tests/test_pose_subnets.py does).

Tolerances, and why:
  * the nets: within 1e-5 of the largest absolute value of each output
    (convolutions add in other orders in XLA and in PyTorch's CPU kernels;
    measured about 1e-6), as for Mask R-CNN.
  * the weights: the round trip through the port's porting maps is exact.
  * the pipelines' stored streams: peaks' positions, valid flags, dims and
    the feasible limbs equal; peak scores and limb scores within 1e-5 of
    the largest map value (the nets' difference); poses equal in count,
    keypoints within 1e-5 (face and hand keypoints are crop-normalized
    argmax positions, equal, and scores within 1e-5 of the crop maps'
    scale); the CPM2 maps within 1e-5 of their largest value.
"""

import jax
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import pose as JP
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.models import weights as PW
from test_torch_jax_decoder import jax_native_decoder

RTOL_OF_MAX = 1e-5
HEAD_SCALE = 1000.0
ROWS = [0, 70]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _close(got, want, what: str):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_MAX * scale,
                               err_msg=what)


def _frames(seed: int, shape=(2, 64, 64, 3)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


# ------------------------------------------------------------ nets


@pytest.mark.parametrize("stages", [2, 6])
def test_body_matches_flax(stages):
    state = PP.init_params(stages, stages)
    x = _frames(stages)
    heat, paf = jax.jit(JP.OpenPoseBody(stages=stages).apply)(
        PP.to_flax(state), x)
    with torch.no_grad():
        got = PP.body_maps(state, _t(x).permute(0, 3, 1, 2))
    assert got[0].shape == (2, JP.N_HEAT, 8, 8)
    _close(got[0].permute(0, 2, 3, 1), heat, "heat")
    _close(got[1].permute(0, 2, 3, 1), paf, "paf")


@pytest.mark.parametrize("net", ["face", "hand"])
def test_crop_net_matches_flax(net):
    init = {"face": PP.init_face_params, "hand": PP.init_hand_params}[net]
    n_kp = {"face": PP.FACE_KEYPOINTS, "hand": PP.HAND_KEYPOINTS}[net]
    state = init(7)
    x = _frames(8)
    variables = PP.crop_to_flax(state)
    want = jax.jit(JP.OpenPoseCrop(n_kp + 1).apply)(variables, x)
    with torch.no_grad():
        got = PP.crop_maps(state, _t(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want, net)
    # the keypoint decode on the same crops
    kp_want = np.asarray(jax.jit(
        lambda v, c: JP.crop_keypoints(v, c, n_kp))(variables, x))
    with torch.no_grad():
        kp = PP.crop_keypoints(state, _t(x), n_kp).numpy()
    np.testing.assert_array_equal(kp[..., :2], kp_want[..., :2])
    _close(kp[..., 2], kp_want[..., 2], net + " scores")


def test_weights_round_trip_through_porting_maps():
    """The port's trees have the JAX package's paths and shapes; flax ->
    state_dict -> flax is exact, from the JAX package's own init (a hand
    net of two stages) and from the port's seeded body."""
    key = jax.random.PRNGKey(0)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(lambda: JP.init_params(key)))
    body = PP.init_params(0)
    assert jax.tree_util.tree_map(np.shape, PP.to_flax(body)) == shapes
    back = PP.from_flax(PP.to_flax(body))
    assert list(back) == list(body)
    assert all(torch.equal(back[k], body[k]) for k in body)
    for init, n in ((JP.init_face_params, PP.FACE_KEYPOINTS + 1),
                    (JP.init_hand_params, PP.HAND_KEYPOINTS + 1)):
        shapes = jax.tree_util.tree_map(
            lambda a: a.shape, jax.eval_shape(lambda: init(key)))
        state = PP.init_face_params(0) if n == 71 else PP.init_hand_params(0)
        assert jax.tree_util.tree_map(np.shape,
                                      PP.crop_to_flax(state)) == shapes
    variables = JP.init_hand_params(key, stages=2)
    state = PP.crop_from_flax(variables)
    assert PP.crop_init(state) == (PP.HAND_KEYPOINTS + 1, 2)
    PP.OpenPoseCrop(*PP.crop_init(state)).load_state_dict(state)
    again = PP.crop_to_flax(state)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------ pipelines


def _save(path: str, tree) -> str:
    np.savez(path, **PW._flatten(tree))
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """npz files of the port's seeded body (output layers scaled) and
    crop nets, in the JAX package's layout."""
    d = tmp_path_factory.mktemp("pose_weights")
    body = PP.init_params(0)
    for key in ("Mconv7_stage6_L1.weight", "Mconv7_stage6_L2.weight"):
        body[key] = body[key] * HEAD_SCALE
    return {"body": _save(str(d / "body.npz"), PP.to_flax(body)),
            "face": _save(str(d / "face.npz"),
                          PP.crop_to_flax(PP.init_face_params(1))),
            "hand": _save(str(d / "hand.npz"),
                          PP.crop_to_flax(PP.init_hand_params(2)))}


def _run(pkg, db, path, build):
    """``build(sc, frames) -> (columns, names)`` over ROWS of the video in
    chunks of 2, RGB ingest -> the loaded streams."""
    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "v", path=path)])
    g = sc.streams.Gather(frame, [ROWS])
    cols, names = build(sc, g)
    outs = [pkg.NamedStream(sc, n) for n in names]
    sc.run(sc.io.Output(cols, [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=2, ingest="rgb"),
           cache_mode=pkg.CacheMode.Overwrite)
    return [list(o.load()) for o in outs]


def _forward_cols(sc, g, weights, **params):
    f = sc.ops.OpenPoseForward(frame=g, weights_path=weights["body"],
                               **params)
    return [f[0], f[1], f[2], f[3]]


FWD_NAMES = ["peaks", "valid", "scores", "dims"]


def _assert_forward_equal(got, want):
    """The forward's four streams of both packages."""
    peaks, valid, scores, dims = got
    jpeaks, jvalid, jscores, jdims = want
    assert len(peaks) == len(ROWS)
    for i in range(len(ROWS)):
        np.testing.assert_array_equal(valid[i], jvalid[i])
        np.testing.assert_array_equal(dims[i], jdims[i])
        np.testing.assert_array_equal(peaks[i][..., :2], jpeaks[i][..., :2])
        _close(peaks[i][..., 2], jpeaks[i][..., 2], "peak scores")
        feasible = np.isfinite(jscores[i])
        np.testing.assert_array_equal(np.isfinite(scores[i]), feasible)
        _close(scores[i][feasible], jscores[i][feasible], "limb scores")
    assert sum(int(v.sum()) for v in valid) > 10
    assert sum(int(np.isfinite(s).sum()) for s in scores) > 0


def _assert_poses_close(got, want):
    assert [len(f) for f in got] == [len(f) for f in want]
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert abs(a._score - b._score) <= RTOL_OF_MAX * max(
                1.0, abs(b._score))
            np.testing.assert_allclose(a._kp, b._kp, rtol=0,
                                       atol=RTOL_OF_MAX)


@pytest.mark.parametrize("scales,upsample", [(1, "linear"), (2, "cubic")],
                         ids=["1-linear", "2-cubic"])
def test_openpose_pipeline_matches_jax(tmp_path, test_video, weights,
                                       scales, upsample):
    """The port's OpenPose composite (it passes pose_upsample on) against
    the JAX package's OpenPoseForward -> OpenPoseDecode (its composite
    drops pose_upsample), with the forward's streams beside the poses."""
    jax_native_decoder()
    params = dict(pose_num_scales=scales, pose_upsample=upsample)

    def port(sc, g):
        poses = sc.ops.OpenPose(frame=g, weights_path=weights["body"],
                                **params)
        return [poses] + _forward_cols(sc, g, weights, **params), \
            ["poses"] + FWD_NAMES

    def ref(sc, g):
        f = _forward_cols(sc, g, weights, **params)
        poses = sc.ops.OpenPoseDecode(peaks=f[0], valid=f[1], scores=f[2],
                                      dims=f[3])
        return [poses] + f, ["poses"] + FWD_NAMES

    got = _run(st, str(tmp_path / "t"), test_video["path"], port)
    want = _run(jst, str(tmp_path / "j"), test_video["path"], ref)
    _assert_forward_equal(got[1:], want[1:])
    _assert_poses_close(got[0], want[0])


def test_cpm2_chain_matches_jax(tmp_path, test_video, weights):
    jax_native_decoder()

    def build(sc, g):
        pre = sc.ops.CPM2Input(frame=g)
        n = sc.ops.CPM2(cpm2_input=pre, weights_path=weights["body"])
        info = sc.ops.InfoFromFrame(frames=g)
        poses = sc.ops.CPM2Output(cpm2_resized_map=n[0], cpm2_joints=n[1],
                                  original_frame_info=info)
        return [poses, pre, n[0], n[1]], ["poses", "pre", "heat", "paf"]

    got = _run(st, str(tmp_path / "t"), test_video["path"], build)
    want = _run(jst, str(tmp_path / "j"), test_video["path"], build)
    for i in range(len(ROWS)):
        np.testing.assert_array_equal(got[1][i], want[1][i])
        assert got[2][i].shape == (64, 96, JP.N_HEAT)
        _close(got[2][i], want[2][i], "heat")
        _close(got[3][i], want[3][i], "paf")
    _assert_poses_close(got[0], want[0])


def _person():
    """One person in heat-map pixels of the 64x96 frame: face and both
    forearms, so that both crop nets run."""
    from scannertools_tpu_torch.ops.pose import Pose

    kp = np.zeros((18, 3), np.float32)
    for part, (x, y) in ((Pose.Nose, (48, 14)), (Pose.REye, (44, 11)),
                         (Pose.LEye, (52, 11)), (Pose.REar, (40, 13)),
                         (Pose.LEar, (57, 13)), (Pose.RElbow, (30, 40)),
                         (Pose.RWrist, (26, 54)), (Pose.LElbow, (66, 40)),
                         (Pose.LWrist, (72, 52))):
        kp[part] = (x, y, 0.9)
    return kp


def test_openpose_face_hands_match_jax(tmp_path, test_video, weights,
                                       monkeypatch):
    """compute_face/compute_hands on both packages with the grouping
    patched to known people (a frame with one, a frame with two; one
    person's box partly outside the frame): the face and hand slots
    filled by the crop nets on 32x32 crops."""
    jax_native_decoder()
    base = _person()
    moved = base.copy()
    moved[:, 0] += 30.0  # right forearm past the frame's right edge
    moved[:, 2] = np.where(base[:, 2] > 0, 0.8, 0.0)
    calls = {"n": 0}

    def people(peaks, valid, scores):
        calls["n"] += 1
        if calls["n"] % 2:
            return [(0.9, base.copy())]
        return [(0.9, base.copy()), (0.7, moved.copy())]

    monkeypatch.setattr(JP, "group_people", people)
    monkeypatch.setattr(PP, "group_people", people)
    params = dict(compute_face=True, compute_hands=True, crop_net_size=32,
                  face_weights_path=weights["face"],
                  hand_weights_path=weights["hand"])

    def build(sc, g):
        return [sc.ops.OpenPose(frame=g, weights_path=weights["body"],
                                **params)], ["poses"]

    got = _run(st, str(tmp_path / "t"), test_video["path"], build)[0]
    calls["n"] = 0
    want = _run(jst, str(tmp_path / "j"), test_video["path"], build)[0]
    assert [len(f) for f in got] == [1, 2]
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a._score == b._score
            np.testing.assert_array_equal(a.pose_keypoints(),
                                          b.pose_keypoints())
            for mine, theirs in ((a.face_keypoints(), b.face_keypoints()),
                                 *zip(a.hand_keypoints(),
                                      b.hand_keypoints())):
                assert np.abs(theirs[:, 2]).max() > 0
                np.testing.assert_allclose(mine[:, :2], theirs[:, :2],
                                           rtol=0, atol=1e-6)
                _close(mine[:, 2], theirs[:, 2], "crop scores")
