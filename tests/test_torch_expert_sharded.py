"""Expert parallelism on logical CPU devices: the sharded MoE
(``parallel/expert.py``: ``moe_apply``, ``MoEHead`` under
``PerfParams(expert_shards)``) and the sharded
StreetStyle heads (``models/streetstyle.heads_apply_sharded``,
``DetectClothing``/``DetectHairStyle`` over an 'expert' mesh), held to the
JAX package's on the session's 8 virtual CPU devices (tests/conftest.py)
and to the port's single-device forms.

Tolerances. MoE: routing, slots and dropped rows equal; values within
1e-6 of values near 1 against JAX (float32 products in another order, as
tests/test_torch_nn_generic.py; through the executor, on u8 pixels as
features, within 1e-5 of the largest value), and within 1e-6 of the
port's single-device formulation (top-1: a token's output is one slot's
and the partial sums add exact zeros, but a device's products are
batched over E/n experts, not E, and may add in another order). Heads: logits within 1e-5 of the largest against JAX;
predictions equal to the unsharded path's except at a near-tie (none in
these seeded cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map  # noqa: F401
from jax.sharding import Mesh as JMesh

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import streetstyle as JS
from scannertools_tpu.models import weights as JW
from scannertools_tpu.parallel import expert as JE
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.models import streetstyle as PS
from scannertools_tpu_torch.ops import clothing as PC
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.parallel import expert as PE
from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV, Mesh
from scannertools_tpu_torch.protobufs import BoundingBox
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

CPU = torch.device("cpu")
MOE_ATOL = 1e-6


def _mesh(n):
    return Mesh([CPU] * n, ("expert",))


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("expert",))


@pytest.fixture(scope="module")
def moe16():
    p = jax.tree.map(np.asarray,
                     JE.init_moe_params(jax.random.PRNGKey(1), 16, 24, 32))
    x = np.random.default_rng(1).normal(size=(40, 24)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cap", [0, 2])
def test_moe_apply_matches_jax_and_reference(moe16, n, cap):
    p, x = moe16
    want = np.asarray(JE.moe_apply(p, jnp.asarray(x), _jmesh(n),
                                   capacity=cap))
    state = PE.MOE.from_flax(p, (16, 24, 32))
    got = PE.moe_apply(state, torch.from_numpy(x), _mesh(n), capacity=cap)
    ref = PE.moe_reference(state, torch.from_numpy(x), capacity=cap)
    zero = ~np.abs(got.numpy()).any(axis=1)
    np.testing.assert_array_equal(zero, ~np.abs(want).any(axis=1))
    assert zero.any()  # both capacities drop tokens of these rows
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MOE_ATOL)
    np.testing.assert_array_equal(zero, ~np.abs(ref.numpy()).any(axis=1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=MOE_ATOL)


def test_moe_apply_refuses_experts_that_do_not_divide(moe16):
    p, x = moe16
    with pytest.raises(ValueError, match="must divide"):
        PE.moe_apply(PE.MOE.from_flax(p), torch.from_numpy(x), _mesh(3))


def test_moe_head_op_under_an_expert_mesh(moe16):
    p, x = moe16
    state = PE.MOE.from_flax(p, (16, 24, 32))
    kw = dict(n_experts=16, d_model=24, d_hidden=32, capacity_batch=16)
    ctx = OpContext(device=CPU, ep_devices=[CPU] * 8, profiler=Profiler())
    got = PN.moe_head(ctx, state, torch.from_numpy(x), **kw).numpy()
    one = PN.moe_head(None, state, torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(~got.any(axis=1), ~one.any(axis=1))
    np.testing.assert_allclose(got, one, rtol=0, atol=MOE_ATOL)
    ctx3 = OpContext(device=CPU, ep_devices=[CPU] * 3, profiler=Profiler())
    # 16 experts do not divide 3 devices: the single-device formulation
    assert np.array_equal(
        PN.moe_head(ctx3, state, torch.from_numpy(x), **kw).numpy(), one)
    assert ctx.profiler.counts() == {"axis:expert:engaged": 1}
    assert ctx3.profiler.counts() == {"axis:expert:not_engaged": 1}


class _Rows:
    is_video = True

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def metadata(self):
        n, h, w, _ = self.frames.shape
        return VideoMetadata("fake", n, 24.0, w, h)

    def decoder(self):
        return self

    def read_frames(self, idxs, out=None):
        data = self.frames[list(idxs)]
        if out is None:
            return data
        out[...] = data
        return out

    def close(self):
        pass


def test_moe_head_expert_shards_through_executor(tmp_path, monkeypatch,
                                                 moe16):
    """MoEHead with expert_shards=8 in the port's executor against the
    JAX package's run with expert_shards=8 on the same npz weights."""
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")
    p, _ = moe16
    frames = np.random.default_rng(29).integers(0, 256, (8, 2, 4, 3),
                                                np.uint8)
    path = str(tmp_path / "moe.npz")
    JW.save_params(path, p)
    outs = []
    for pkg in (st, jst):
        kw = dict(device="cpu") if pkg is st else {}
        sc = pkg.Client(db_path=str(tmp_path / pkg.__name__), **kw)
        y = sc.ops.MoEHead(input=sc.io.Input([_Rows(frames)]),
                           n_experts=16, d_model=24, d_hidden=32,
                           weights_path=path)
        out = pkg.NamedStream(sc, "moe")
        sc.run(sc.io.Output(y, [out]),
               pkg.PerfParams.manual(work_packet_size=4, expert_shards=8),
               cache_mode=pkg.CacheMode.Overwrite)
        outs.append(np.stack(list(out.load())))
        if pkg is st:
            counts = sc.profiler.counts()
    # pixel features: values up to about 20, so 1e-5 of the largest
    scale = float(np.abs(outs[1]).max())
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5 * scale)
    assert counts["axis:expert:engaged"] == 2
    assert "axis:expert:not_engaged" not in counts


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_heads_apply_sharded_matches_jax(n):
    rng = np.random.default_rng(n)
    w = rng.normal(size=(16, 32, 10), scale=0.1).astype(np.float32)
    b = rng.normal(size=(16, 10), scale=0.1).astype(np.float32)
    feat = rng.normal(size=(5, 32)).astype(np.float32)
    jm = JMesh(np.array((jax.devices() * 2)[:n]), ("expert",)) \
        if n <= 8 else None
    got = PS.heads_apply_sharded(
        (torch.from_numpy(w), torch.from_numpy(b), None),
        torch.from_numpy(feat), _mesh(n))
    assert torch.equal(got, PS.heads_logits(
        (torch.from_numpy(w), torch.from_numpy(b), None),
        torch.from_numpy(feat)))
    if jm is not None:
        want = np.asarray(jax.jit(lambda ww, bb, ff: JS.heads_apply_sharded(
            (ww, bb, None), ff, jm))(w, b, feat))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


@pytest.fixture(scope="module")
def clothing_frames():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (2, 96, 80, 3), np.uint8)


@pytest.mark.parametrize("op,n", [("clothing", 8), ("clothing", 4),
                                  ("hairstyle", 3)])
def test_attribute_ops_under_an_expert_mesh(clothing_frames, op, n):
    boxes = [[BoundingBox(x1=0.1, y1=0.1, x2=0.8, y2=0.9, score=1.0),
              BoundingBox(x1=0.3, y1=0.2, x2=0.6, y2=0.5, score=1.0)],
             [BoundingBox(x1=0.2, y1=0.1, x2=0.9, y2=0.7, score=1.0)]]
    fn = PC.detect_clothing if op == "clothing" else PC.detect_hairstyle
    kw = {"adjust_bboxes": False} if op == "clothing" else {}
    ctx = OpContext(device=CPU, ep_devices=[CPU] * n, profiler=Profiler())
    got = fn(ctx, clothing_frames, boxes, **kw)
    want = fn(OpContext(device=CPU), clothing_frames, boxes, **kw)
    assert [[r.predictions.tolist() for r in row] for row in got] == \
        [[r.predictions.tolist() for r in row] for row in want]
    assert ctx.profiler.counts() == {"axis:expert:engaged": 1}


def test_ep_mesh_of_experts_that_do_not_divide_is_counted():
    ctx = OpContext(device=CPU, ep_devices=[CPU] * 3, profiler=Profiler())
    assert ctx.ep_mesh(16) is None
    assert ctx.ep_mesh(3).shape == {"expert": 3}
    assert ctx.profiler.counts() == {"axis:expert:not_engaged": 1,
                                     "axis:expert:engaged": 1}


@pytest.mark.parametrize("attrs", ["CLOTHING_ATTRIBUTES",
                                   "HAIRSTYLE_ATTRIBUTES"])
def test_stacked_heads_carry_across_from_jax_trees(attrs):
    """A JAX StreetStyle tree (the port's seeded weights through
    ``to_flax``, as numpy) loads through ``from_flax`` into the same
    stacked heads the JAX package's ``stack_head_params`` lays out."""
    init = PS.init_params_clothing if attrs.startswith("CLOTH") \
        else PS.init_params_hairstyle
    tree = PS.to_flax(init(3))
    w, b, mask = PS.stack_head_params(PS.from_flax(tree),
                                      getattr(PS, attrs))
    jw, jb, jmask = JS.stack_head_params(tree, getattr(JS, attrs))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
