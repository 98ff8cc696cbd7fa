"""The port's device meshes (``parallel/mesh.py``) and frame sharding
(``parallel/sharded.py``) held to the JAX package's on the session's 8
virtual CPU devices (tests/conftest.py); the port's side is 8 logical CPU
devices (``SCANNERTOOLS_TORCH_LOGICAL_DEVICES=8``). Every comparison is
exact: these move and slice rows and do no arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from scannertools_tpu.parallel import mesh as jmesh
from scannertools_tpu.parallel import sharded as jsharded
from scannertools_tpu_torch.parallel import mesh, sharded
from scannertools_tpu_torch.utils.framechunk import FrameChunk

CPU = torch.device("cpu")


@pytest.fixture()
def eight(monkeypatch):
    monkeypatch.setenv(mesh.LOGICAL_DEVICES_ENV, "8")


def test_local_devices_logical_count(monkeypatch):
    monkeypatch.delenv(mesh.LOGICAL_DEVICES_ENV, raising=False)
    assert mesh.local_devices("cpu") == [CPU]
    monkeypatch.setenv(mesh.LOGICAL_DEVICES_ENV, "8")
    assert mesh.local_devices("cpu") == [CPU] * 8
    monkeypatch.setenv(mesh.LOGICAL_DEVICES_ENV, "0")
    with pytest.raises(ValueError):
        mesh.local_devices("cpu")


def test_local_devices_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_devices()
    with pytest.raises(RuntimeError):
        mesh.local_devices("cuda")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_make_mesh_shapes_match_jax(eight, n, axes):
    got = mesh.make_mesh(n, axes, device="cpu")
    want = jmesh.make_mesh(n, axes)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.names() == ["cpu"] * got.size
    assert got == mesh.make_mesh(n, axes, device="cpu")


def test_mesh_refuses_a_ragged_grid():
    with pytest.raises(ValueError):
        mesh.Mesh([CPU] * 3, ("data", "model"))


@pytest.mark.parametrize("local", [1, 2, 5])
def test_halo_exchange_1_matches_jax(eight, local):
    x = np.random.default_rng(local).integers(0, 256, (8 * local, 3, 4),
                                              np.uint8)
    jm = JMesh(np.array(jax.devices()[:8]), ("data",))
    want = np.asarray(jax.jit(shard_map(
        lambda s: jmesh.halo_exchange_1(s, "data"), mesh=jm,
        in_specs=P("data"), out_specs=P("data"), check_rep=False))(
            jnp.asarray(x)))
    m = mesh.make_mesh(8, ("data",), device="cpu")
    shards = mesh.shard_frames(m, torch.from_numpy(x))
    got = torch.cat(mesh.halo_exchange_1(shards)).numpy()
    assert got.shape == want.shape and (got == want).all()


@pytest.mark.parametrize("n_jobs", [0, 1, 3, 4, 7, 12])
@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_host_job_slice_matches_jax(n_jobs, count):
    got = [sharded.host_job_slice(n_jobs, i, count) for i in range(count)]
    want = [jsharded.host_job_slice(n_jobs, i, count)
            for i in range(count)]
    assert got == want
    assert [j for r in got for j in r] == list(range(n_jobs))


def test_host_job_slice_reads_rank_and_world_size(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert sharded.host_job_slice(5) == range(0, 5)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert sharded.host_job_slice(5) == range(3, 5)
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError):
        sharded.host_job_slice(5)


@pytest.mark.parametrize("t,multiple", [(9, 8), (16, 8), (3, 4), (1, 8)])
def test_pad_rows_to_multiple_matches_jax(t, multiple):
    x = np.random.default_rng(t).integers(0, 256, (t, 4, 6, 3), np.uint8)
    want = jsharded.pad_rows_to_multiple(x, multiple)
    got = sharded.pad_rows_to_multiple(torch.from_numpy(x), multiple)
    assert (got.numpy() == want).all()
    assert (sharded.pad_rows_to_multiple(x, multiple) == want).all()
    chunk = sharded.pad_rows_to_multiple(FrameChunk.from_hwc(x), multiple)
    assert (chunk.hwc_u8() == want).all()
    rows = list(x)
    padded = sharded.pad_rows_to_multiple(rows, multiple)
    assert len(padded) == len(want) and padded[-1] is rows[-1]


def test_shard_value_and_windows(eight):
    m = sharded.data_mesh(4, "cpu")
    assert m.shape == {"data": 4}
    assert sharded.frame_sharding(m, 3) == ("data", None, None)
    x = torch.arange(12)
    shards = sharded.shard_value(m, x)
    assert [s.tolist() for s in shards] == [[0, 1, 2], [3, 4, 5],
                                            [6, 7, 8], [9, 10, 11]]
    with pytest.raises(ValueError):
        sharded.shard_value(m, torch.arange(10))
    # windows with a 1-row forward halo = core + halo_exchange_1's row on
    # interior shards
    wins = sharded.row_windows(torch.arange(13), 4, 3, 1)
    halo = mesh.halo_exchange_1(shards)
    assert [w.tolist() for w in wins[:3]] == [h.tolist() for h in halo[:3]]
    assert wins[3].tolist() == [9, 10, 11, 12]
    back = sharded.gather_rows(shards, CPU)
    assert torch.equal(back, x)
