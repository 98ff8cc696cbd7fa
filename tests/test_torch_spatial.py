"""Spatial parallelism (``parallel/spatial.py``) and the sp branches of
``ops/imgproc.py`` on 8 logical CPU devices, held to the JAX package's on
the session's 8 virtual CPU devices (tests/conftest.py).

Halo exchanges move rows: equal. ``Blur`` sums u8 pixels exactly in
float32, so its row-sharded result is bit-equal to JAX's row-sharded
one and to both packages' unsharded ones; the pointwise ops
(``ConvertColor``, ``ConvertToHSV``, ``FrameDifference``) are too. A conv
stack through ``spatial_apply`` is bit-equal to the port's unsharded
conv and within 1e-5 of JAX's (two conv implementations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from scannertools_tpu.ops import imgproc as jimg
from scannertools_tpu.parallel import spatial as jsp
from scannertools_tpu.runtime.context import OpContext as JContext
from scannertools_tpu_torch.ops import imgproc as img
from scannertools_tpu_torch.parallel import spatial as sp
from scannertools_tpu_torch.parallel.mesh import Mesh
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

CPU = torch.device("cpu")


def _mesh(n, axis="sp"):
    return Mesh([CPU] * n, (axis,))


def _jmesh(n, axis="sp"):
    return JMesh(np.array(jax.devices()[:n]), (axis,))


def _ctx(n):
    return OpContext(device=CPU, sp_devices=[CPU] * n, profiler=Profiler())


@pytest.mark.parametrize("halo", [1, 2, 4])
def test_halo_exchange_rows_matches_jax(halo):
    x = np.random.default_rng(halo).normal(size=(2, 8 * 4, 5, 3)) \
        .astype(np.float32)
    jm = _jmesh(8)
    want = np.asarray(jax.jit(shard_map(
        lambda s: jsp.halo_exchange_rows(s, halo, "sp"), mesh=jm,
        in_specs=P(None, "sp"), out_specs=P(None, "sp"),
        check_rep=False))(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = torch.cat(sp.halo_exchange_rows(list(t.split(4, dim=1)), halo),
                    dim=1).numpy()
    assert got.shape == want.shape and (got == want).all()


def _conv_pair(seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 3, 3, 4), scale=0.2).astype(np.float32)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)

    def jconv(img, row_mask=None):
        if row_mask is not None:
            img = img * row_mask[None, :, None, None]
        return jax.lax.conv_general_dilated(
            img, jnp.asarray(k), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tconv(img, row_mask=None):
        if row_mask is not None:
            img = img * row_mask[None, :, None, None]
        return F.conv2d(img.permute(0, 3, 1, 2), kt, padding=1) \
            .permute(0, 2, 3, 1)

    return jconv, tconv


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spatial_apply_conv(n):
    jconv, tconv = _conv_pair(n)
    x = np.random.default_rng(0).normal(size=(1, 4 * n, 16, 3)) \
        .astype(np.float32)
    got = sp.spatial_apply(tconv, torch.from_numpy(x), 1, _mesh(n, "data"))
    assert torch.equal(got, tconv(torch.from_numpy(x)))
    want = np.asarray(jsp.spatial_apply(jconv, jnp.asarray(x), 1,
                                        _jmesh(n, "data")))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_spatial_apply_traced_gets_global_rows():
    seen = []

    def fn(padded, g):
        seen.append(g.tolist())
        return padded

    x = torch.arange(12.).reshape(1, 12, 1)
    out = sp.spatial_apply_traced(fn, x, 2, _mesh(3))
    assert torch.equal(out, x)
    assert seen == [list(range(-2, 6)), list(range(2, 10)),
                    list(range(6, 14))]


@pytest.mark.parametrize("rows,halo", [(10, 1), (16, 3)])
def test_spatial_apply_refuses_bad_geometry(rows, halo):
    x = torch.zeros(1, rows, 2)
    with pytest.raises(ValueError, match="must divide"):
        sp.spatial_apply(lambda p, m: p, x, halo, _mesh(8, "data"))
    with pytest.raises(ValueError):
        sp.spatial_apply_pointwise(lambda p: p, torch.zeros(1, 10, 2),
                                   _mesh(8))


def _frames(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("k", [3, 4, 5, 9])
def test_blur_sp_bit_equal_to_jax(k):
    x = _frames(2, 48, 20, k)
    jctx = JContext(sp_devices=jax.devices()[:8])
    want_sp = np.asarray(jax.jit(
        lambda f: jimg.blur(jctx, f, kernel_size=k))(jnp.asarray(x)))
    want = np.asarray(jax.jit(
        lambda f: jimg.blur(None, f, kernel_size=k))(jnp.asarray(x)))
    ctx = _ctx(8)
    got = img.blur(ctx, torch.from_numpy(x), kernel_size=k).numpy()
    assert ctx.profiler.counts() == {"axis:sp:engaged": 1}
    plain = img.blur(None, torch.from_numpy(x), kernel_size=k).numpy()
    assert (got == want_sp).all() and (want_sp == want).all()
    assert (got == plain).all()


@pytest.mark.parametrize("op,params", [
    ("convert_color", {"conversion": "COLOR_RGB2GRAY"}),
    ("convert_color", {"conversion": "COLOR_RGB2YUV"}),
    ("convert_to_hsv", {}),
    ("frame_difference", {}),
])
def test_pointwise_sp_ops_equal_jax(op, params):
    x = _frames(3, 32, 12, 7)
    jctx = JContext(sp_devices=jax.devices()[:8])
    want = np.asarray(jax.jit(
        lambda f: getattr(jimg, op)(jctx, f, **params))(jnp.asarray(x)))
    ctx = _ctx(8)
    got = getattr(img, op)(ctx, torch.from_numpy(x), **params).numpy()
    plain = getattr(img, op)(None, torch.from_numpy(x), **params).numpy()
    assert (got == want).all() and (got == plain).all()
    assert ctx.profiler.counts() == {"axis:sp:engaged": 1}


def test_rows_that_do_not_divide_fall_back_counted():
    x = torch.from_numpy(_frames(2, 30, 12, 1))
    ctx = _ctx(8)
    got = img.blur(ctx, x, kernel_size=5)
    assert torch.equal(got, img.blur(None, x, kernel_size=5))
    assert torch.equal(img.convert_to_hsv(ctx, x),
                       img.convert_to_hsv(None, x))
    assert ctx.profiler.counts() == {"axis:sp:not_engaged": 2}
