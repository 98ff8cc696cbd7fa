"""Pipeline parallelism (``parallel/pipeline_parallel.py``: the GPipe
schedule, one stage a device) and the pipelined pose forms
(``models/pose.py``), on logical CPU devices, held to the JAX package's on
the session's 8 virtual CPU devices (tests/conftest.py).

The tanh chain is held to each package's ``sequential_reference`` exactly
on the port (the same stage calls in the same order) and within 1e-5 to
JAX's; the pipelined body maps are held to JAX's ``body_forward_pipelined``
within 1e-5 of their largest value (the float32 tolerance of the pose
tests), and to the port's unpipelined maps likewise (a microbatch is one
frame, and a convolution of another batch size may round otherwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from scannertools_tpu.models import pose as JP
from scannertools_tpu.parallel import pipeline_parallel as jpp
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.parallel import pipeline_parallel as pp
from scannertools_tpu_torch.parallel.mesh import Mesh
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

CPU = torch.device("cpu")
RTOL_OF_MAX = 1e-5


def _mesh(n):
    return Mesh([CPU] * n, ("pipe",))


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("pipe",))


def _chain(n, seed=0, f=8):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(f, f), scale=0.3).astype(np.float32),
             "b": rng.normal(size=(f,), scale=0.1).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("S,M", [(1, 3), (2, 1), (4, 8), (8, 2), (8, 16)])
def test_gpipe_matches_sequential_in_both_packages(S, M):
    per = _chain(S, S)
    x = np.random.default_rng(M).normal(size=(M, 2, 8)).astype(np.float32)

    def tfn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def jfn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    tstack = pp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per])
    got = pp.pipeline_apply(tfn, tstack, torch.from_numpy(x), _mesh(S))
    assert torch.equal(got, pp.sequential_reference(tfn, tstack,
                                                    torch.from_numpy(x)))
    jstack = jpp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per])
    want = np.asarray(jpp.pipeline_apply(jfn, jstack, jnp.asarray(x),
                                         _jmesh(S)))
    ref = np.asarray(jpp.sequential_reference(jfn, jstack, jnp.asarray(x)))
    np.testing.assert_allclose(want, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_stage_count_refused_in_both_packages():
    per = _chain(4)
    tstack = pp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per])
    x = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="leading .stage. axis 4"):
        pp.pipeline_apply(lambda p, h: h, tstack, x, _mesh(2))
    with pytest.raises(ValueError, match="leading .stage. axis 4"):
        pp.pipeline_apply_traced(lambda p, h: h, tstack, x, _mesh(8))
    jstack = jpp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per])
    with pytest.raises(ValueError, match="leading .stage. axis 4"):
        jpp.pipeline_apply(lambda p, h: h, jstack, jnp.zeros((2, 1, 8)),
                           _jmesh(2))


def _frames(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_MAX * scale,
                               err_msg=what)


@pytest.mark.parametrize("stages", [3, 6])
def test_body_pipelined_matches_jax(stages):
    state = PP.init_params(stages, stages)
    x = _frames(stages)
    jm = _jmesh(stages - 1)
    heat, paf = jax.jit(lambda v, f: JP.body_forward_pipelined(
        v, f, jm, stages=stages))(PP.to_flax(state), x)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = PP.body_forward_pipelined(state, xt, _mesh(stages - 1))
        plain = PP.body_maps(state, xt)
    _close(got[0], plain[0], "heat, unpipelined")
    _close(got[1], plain[1], "paf, unpipelined")
    _close(got[0].permute(0, 2, 3, 1), heat, "heat")
    _close(got[1].permute(0, 2, 3, 1), paf, "paf")


def test_refine_stage_params_mirror_jax_names():
    state = PP.init_params(1, 3)
    subs = PP.refine_stage_params(state, 3)
    jsubs = JP.refine_stage_params(PP.to_flax(state), 3)
    assert len(subs) == len(jsubs) == 2
    for sub, jsub in zip(subs, jsubs):
        for tag in ("L1", "L2"):
            for j in range(7):
                w = sub[f"Mconv{j + 1}_{tag}.weight"].permute(2, 3, 1, 0)
                layer = jsub["params"][f"{tag}_{j}"]
                layer = layer["conv"] if j < 6 else layer
                np.testing.assert_array_equal(w.numpy(),
                                              np.asarray(layer["kernel"]))


def test_crop_pipelined_equals_unpipelined():
    state = PP.init_hand_params(4, stages=6)
    crops = torch.from_numpy(_frames(4, (3, 48, 48, 3)))
    with torch.no_grad():
        got = PP.crop_keypoints(state, crops, PP.HAND_KEYPOINTS,
                                pipe_mesh=_mesh(5))
        want = PP.crop_keypoints(state, crops, PP.HAND_KEYPOINTS)
    _close(got, want, "hand keypoints")


def test_pipe_mesh_of_a_short_reservation_is_counted():
    ctx = OpContext(device=CPU, pipe_devices=[CPU] * 4, profiler=Profiler())
    assert ctx.pipe_mesh(5) is None
    assert ctx.pipe_mesh(4).shape == {"pipe": 4}
    assert ctx.profiler.counts() == {"axis:pipe:not_engaged": 1,
                                     "axis:pipe:engaged": 1}
    assert OpContext().pipe_mesh(5) is None
