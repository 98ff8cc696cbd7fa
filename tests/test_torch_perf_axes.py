"""The port's ``PerfParams`` axis knobs (``pipeline_instances_per_node``,
``pipeline_stages``, ``spatial_shards``, ``expert_shards``): ``manual``
and ``estimate`` take them, ``resolve()`` equals the JAX package's on a
grid of geometries and declared axes (the ``-1`` auto-picks included: the
predicates are copied as they are, the auto-engage mismatch of ROADMAP
queue 3 with them), the executor rejects combined axes with the JAX
package's error, and an axis asked for that nothing engages is counted."""

import dataclasses
import itertools

import numpy as np
import pytest

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.parallel.mesh import LOGICAL_DEVICES_ENV

KNOBS = ("pipeline_instances_per_node", "pipeline_stages", "spatial_shards",
         "expert_shards")


def _fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)
            if f.name not in ("auto", "fixed")}


def test_field_names_and_defaults_match_jax():
    got, want = _fields(st.PerfParams()), _fields(jst.PerfParams())
    assert got == want
    assert list(got) == [f.name for f in dataclasses.fields(jst.PerfParams)
                         if f.name not in ("auto", "fixed")]


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("value", [-1, 0, 1, 2, 5])
def test_manual_matches_jax(knob, value):
    got = st.PerfParams.manual(work_packet_size=32, **{knob: value})
    want = jst.PerfParams.manual(work_packet_size=32, **{knob: value})
    assert _fields(got) == _fields(want)
    assert _fields(got.resolve(1920 * 1080 * 3)) == _fields(got)


GEOMETRIES = [  # (frame_bytes, halo, n_devices, rows, total_devices)
    (None, 0, 1, 0, 1), (1920 * 1080 * 3, 0, 1, 1080, 8),
    (640 * 480 * 3, 1, 4, 480, 8), (96 * 64 * 3, 2, 8, 64, 8),
    (3840 * 2160 * 3, 0, 2, 2160, 5), (32 * 24 * 3, 0, 1, 24, 3),
]
DECLARED = [  # (stages, sp halos, experts)
    ((), (), ()), ((5,), (), ()), ((5, 6), (0, 4), (16,)),
    ((), (0,), ()), ((), (4, 0), ()), ((), (), (16, 3)), ((2,), (1,), (8,)),
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("declared", DECLARED)
def test_resolve_matches_jax(geometry, declared):
    frame_bytes, halo, n_devices, rows, total = geometry
    stages, sp, experts = declared
    for pp, spv, ep, inst in itertools.product([-1, 0, 2, 5], [-1, 0, 2, 4],
                                               [-1, 0, 2, 4], [1, 4]):
        kw = dict(pipeline_stages=pp, spatial_shards=spv, expert_shards=ep,
                  pipeline_instances_per_node=inst)
        rk = dict(n_devices=n_devices, rows=rows, declared_stages=stages,
                  declared_sp_halos=sp, declared_experts=experts,
                  total_devices=total)
        for fixed in ({}, {"work_packet_size": 16}):
            got = st.PerfParams.estimate(**kw, **fixed).resolve(
                frame_bytes, halo, **rk)
            want = jst.PerfParams.estimate(**kw, **fixed).resolve(
                frame_bytes, halo, **rk)
            assert _fields(got) == _fields(want), (kw, fixed)


class _Video:
    is_video = True

    def __init__(self, n=4, h=16, w=16):
        self.frames = np.random.default_rng(0).integers(
            0, 256, (n, h, w, 3), np.uint8)

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


@pytest.fixture()
def eight(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


def _run(tmp_path, perf, op="Histogram", db="db", **params):
    sc = st.Client(db_path=str(tmp_path / db), device="cpu")
    node = getattr(sc.ops, op)(frame=sc.io.Input([_Video()]), **params)
    out = st.NamedStream(sc, "out")
    sc.run(sc.io.Output(node, [out]), perf,
           cache_mode=st.CacheMode.Overwrite)
    return sc.profiler.counts(), out


@pytest.mark.parametrize("axes", [
    dict(pipeline_stages=5, spatial_shards=4),
    dict(spatial_shards=2, expert_shards=2),
    dict(pipeline_instances_per_node=8, spatial_shards=2),
])
def test_combined_axes_are_refused_as_in_jax(eight, tmp_path, axes):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _run(tmp_path, st.PerfParams.manual(work_packet_size=4, **axes))


@pytest.mark.parametrize("axis,knob", [("pipe", "pipeline_stages"),
                                       ("sp", "spatial_shards"),
                                       ("expert", "expert_shards")])
def test_an_axis_nothing_declares_is_counted_not_engaged(eight, tmp_path,
                                                         axis, knob):
    counts, _ = _run(tmp_path, st.PerfParams.manual(work_packet_size=4,
                                                    **{knob: 4}))
    assert counts[f"axis:{axis}:not_engaged"] == 1
    assert f"axis:{axis}:engaged" not in counts


def test_an_axis_wider_than_the_devices_is_counted(tmp_path, monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "2")
    counts, _ = _run(tmp_path, st.PerfParams.manual(work_packet_size=4,
                                                    spatial_shards=4),
                     op="Blur", kernel_size=3)
    assert counts["axis:sp:not_engaged"] == 1


def test_estimate_auto_engages_the_declared_axis(eight, tmp_path):
    counts, out = _run(tmp_path, st.PerfParams.estimate(
        work_packet_size=4, spatial_shards=-1), op="Blur", kernel_size=3)
    assert counts["axis:sp:engaged"] == 1
    assert "axis:sp:not_engaged" not in counts
    _, ref = _run(tmp_path, st.PerfParams.manual(work_packet_size=4),
                  op="Blur", db="ref", kernel_size=3)
    assert (np.stack(list(out.load())) == np.stack(list(ref.load()))).all()
