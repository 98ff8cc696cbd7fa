"""Tensor parallelism (``parallel/model_sharding.py``) on logical CPU
devices, held to the JAX package's ``tp_model`` on the session's 8
virtual CPU devices (tests/conftest.py) over the same weights (the port's
seeded gender net written as an uncompressed npz of its ``to_flax``
tree).

The layout rule keeps the JAX package's meaning in torch's layouts: the
output channels, which lead in OIHW and ``[out, in]`` and trail in HWIO
and ``[in, out]``. The column-parallel forward equals the port's
unsharded forward exactly (each output channel is the same dot product),
and JAX's within 1e-5 of the largest logit (two conv implementations; the
nn tests' tolerance)."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from scannertools_tpu.parallel import model_sharding as jms
from scannertools_tpu_torch.models import gender
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.parallel import model_sharding as ms
from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV, Mesh

CPU = torch.device("cpu")
RTOL = 1e-5


def _grid(d, m):
    g = np.empty((d, m), dtype=object)
    g[:] = CPU
    return Mesh(g, ("data", "model"))


@pytest.mark.parametrize("torch_shape,jax_shape", [
    ((64, 32, 3, 3), (3, 3, 32, 64)),     # conv OIHW / HWIO
    ((512, 13824), (13824, 512)),         # linear [out, in] / [in, out]
    ((3, 4096), (4096, 3)),               # out-features do not divide
    ((96, 3, 7, 7), (7, 7, 3, 96)),       # under min_size
    ((512,), (512,)),                     # a bias: too small
])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_spec_for_shards_the_output_channels_as_jax(torch_shape, jax_shape,
                                                   n):
    got = ms._spec_for(torch_shape, n, 1 << 14)
    want = tuple(jms._spec_for(jax_shape, n, 1 << 14))
    if not want or "model" not in want:
        assert got == ()
        return
    out_axis_jax = len(jax_shape) - 1
    assert want.index("model") == out_axis_jax
    assert got.index("model") == 0


@pytest.fixture(scope="module")
def gender_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "gender.npz")
    np.savez(path, **PW._flatten(gender.to_flax(gender.init_params(0))))
    return path


def _input(batch=2):
    return np.random.default_rng(3).uniform(0, 255, (batch, 227, 227, 3)) \
        .astype(np.float32)


def test_tp_model_matches_jax(gender_npz):
    x = _input()
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    _, jrun = jms.tp_model("gender_levi_hassner", jmesh,
                           weights_path=gender_npz)
    want = np.asarray(jrun(x))
    state, run = ms.tp_model("gender_levi_hassner", _grid(1, 2),
                             weights_path=gender_npz)
    n_split = sum(isinstance(v, ms.ColumnShards) for v in state.values())
    assert n_split == 4  # conv2, conv3, full1, full2 (>= 65536 elements)
    got = run(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)
    plain = PN.get_model("gender_levi_hassner")[1](
        PFO._get_params("gender", gender_npz), torch.from_numpy(x))
    assert np.array_equal(got, plain.numpy())


@pytest.mark.parametrize("d,m", [(2, 2), (1, 4), (4, 2)])
def test_tp_apply_splits_batch_over_data_rows(gender_npz, d, m):
    state = PFO._get_params("gender", gender_npz)
    _, apply_fn = PN.get_model("gender_levi_hassner")
    mesh = _grid(d, m)
    run = ms.tp_apply(apply_fn, ms.shard_params(state, mesh), mesh)
    x = torch.from_numpy(_input(4))
    # a batch slice a data row: equal to the plain forward of each slice
    want = torch.cat([apply_fn(state, c) for c in x.chunk(d)])
    assert torch.equal(run(x), want)


def test_tp_model_default_mesh_and_facenet(monkeypatch):
    """The default mesh: one data row over every local device; FaceNet's
    convolutions and its last linear layer split four ways."""
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "4")
    state, run = ms.tp_model("facenet_inception_resnet_v1", device="cpu")
    assert sum(isinstance(v, ms.ColumnShards) for v in state.values()) > 50
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (2, 160, 160, 3)).astype(np.float32))
    want = PN.get_model("facenet_inception_resnet_v1")[1](
        PFO._get_params("facenet", None), x)
    assert torch.equal(run(x), want)


def test_a_mesh_without_a_model_axis_is_refused():
    with pytest.raises(ValueError, match="'model' axis"):
        ms.shard_params({}, Mesh([CPU] * 2, ("data",)))
