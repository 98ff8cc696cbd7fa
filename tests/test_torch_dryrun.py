"""The port's multi-device dry run (``parallel/dryrun.py``) on 8 logical
CPU devices, held to the JAX package's on the session's 8 virtual CPU
devices (tests/conftest.py): the miniature embedding stack's loss after
one sharded training step, on the JAX package's ``init_params`` carried
across by ``from_flax``, within 1e-5 of JAX's loss (bfloat16
convolutions in both, measured equal); the sharded step against one
unsharded step (loss within 1e-6; each weight's update within 1e-2 of
its largest: the convolutions' gradients are bfloat16, summed a batch
slice at a time in the sharded step, about 8 bits of mantissa); and the pipeline/spatial/expert goldens and the executor's dry
runs for the data, pipeline, spatial and expert axes."""

import jax
import numpy as np
import pytest
import torch

from scannertools_tpu.parallel import dryrun as JD
from scannertools_tpu_torch.parallel import dryrun as D
from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV, Mesh

CPU = torch.device("cpu")


@pytest.fixture()
def eight(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JD.init_params(jax.random.PRNGKey(0)))


def test_weights_carry_across(jax_params):
    p = D.from_flax(jax_params)
    assert p["conv1"].shape == (64, 3, 3, 3)
    back = D.to_flax(p)
    assert all(np.array_equal(back[k], jax_params[k]) for k in jax_params)
    seeded = D.init_params(0)
    assert {k: tuple(v.shape) for k, v in seeded.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


def test_forward_matches_jax(jax_params):
    frames, _ = D._data(8, 32)
    want = np.asarray(jax.jit(JD.forward)(jax_params, frames.numpy()))
    got = D.forward(D.from_flax(jax_params), frames).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_run_dryrun_loss_matches_jax(eight, jax_params, n):
    want = JD.run_dryrun(n)
    got = D.run_dryrun(n, params=D.from_flax(jax_params), device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("d,m", [(1, 2), (2, 2), (4, 2), (8, 1)])
def test_sharded_step_equals_one_unsharded_step(jax_params, d, m):
    p = D.from_flax(jax_params)
    frames, labels = D._data(16, 32)
    grid = np.empty((d, m), dtype=object)
    grid[:] = CPU
    new_s, loss_s = D.sharded_train_step(p, frames, labels,
                                         Mesh(grid, ("data", "model")))
    new_u, loss_u = D.train_step(p, frames, labels)
    assert abs(loss_s - loss_u) <= 1e-6
    for k in new_u:
        step_u, step_s = new_u[k] - p[k], new_s[k] - p[k]
        scale = float(step_u.abs().max())
        assert scale > 0  # the step moved them
        torch.testing.assert_close(step_s, step_u, rtol=0,
                                   atol=1e-2 * scale)


def test_pp_sp_ep_goldens(eight):
    D.run_pp_sp_dryrun(8, device="cpu")


@pytest.mark.parametrize("which", ["executor", "pp_executor", "sp_executor",
                                   "ep_executor"])
def test_executor_dryruns(eight, which):
    getattr(D, f"run_{which}_dryrun")(8, device="cpu")
