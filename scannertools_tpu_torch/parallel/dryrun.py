"""Multi-device dry run: a full training step, and the executor's axes,
over an n-device mesh.

The JAX package's parallel/dryrun.py jits a training step over a mesh to
check that its sharding layout compiles and runs. Here the same
miniature of the framework's embedding stack (conv backbone -> pooled
features -> projection head, the FaceNet-style shape), in bfloat16 where
the JAX package casts, trains one step with ``torch.autograd`` over a
(data, model) mesh: the convolutions run data-parallel (a batch slice per
data row, their gradients summed into one replicated leaf), the
projection's columns and the classifier's rows split over the model axis
(its partial logits summed: the all-reduce), and the loss averages over
the whole batch. ``run_pp_sp_dryrun`` checks the pipeline, spatial and
expert forms against their unsharded goldens, and the ``run_*_executor_
dryrun`` functions drive the executor's data, pipeline, spatial and expert
axes against unsharded runs of the same graphs. No kernel needs a
backward: the step is plain torch.
"""

from __future__ import annotations

import math
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import jax_random
from ..models.common import same_pad
from ..models.weights import as_f32
from .expert import _he_normal
from .mesh import Mesh, local_devices, make_mesh

_KEYS = ("conv1", "conv2", "proj", "cls")


def init_params(seed: int = 0, c_in: int = 3, width: int = 64,
                embed: int = 128) -> Dict[str, torch.Tensor]:
    """He-normal weights from a ``torch.Generator`` seeded with ``seed``
    (the port's own seeded set; the dry run's default is the JAX
    package's draw, ``default_params``): convolutions OIHW, ``proj``
    [width, embed], ``cls`` [embed, 32]."""
    gen = torch.Generator().manual_seed(seed)
    hwio = {"conv1": (3, 3, c_in, width), "conv2": (3, 3, width, width),
            "proj": (width, embed), "cls": (embed, 32)}
    return from_flax({k: _he_normal(s, gen).numpy()
                      for k, s in hwio.items()})


def default_tree(key: torch.Tensor, c_in: int = 3, width: int = 64,
                 embed: int = 128) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params(key)``, drawn in torch on the key's
    device: He-normal on the four keys of ``split(key, 4)``, HWIO."""
    hwio = {"conv1": (3, 3, c_in, width), "conv2": (3, 3, width, width),
            "proj": (width, embed), "cls": (embed, 32)}
    return {k: jax_random.he_normal(sub, s) for sub, (k, s) in
            zip(jax_random.split(key, 4), hwio.items())}


def default_params(device=None) -> Dict[str, torch.Tensor]:
    """The dry run's default weights: the JAX package's ``init_params(
    jax.random.PRNGKey(0))``, drawn on ``device`` (None: the card, as a
    ``Client``'s)."""
    from ..client import _resolve_device

    return from_flax(default_tree(jax_random.prng_key(
        0, _resolve_device(device))))


def from_flax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` tree (numpy or tensors) -> the
    port's: HWIO convolutions to OIHW, the dense matrices as they are."""
    out = {}
    for k in _KEYS:
        a = as_f32(tree[k])
        out[k] = a.permute(3, 2, 0, 1).contiguous() if a.dim() == 4 else a
    return out


def to_flax(params) -> Dict[str, np.ndarray]:
    out = {}
    for k in _KEYS:
        a = params[k].detach().cpu()
        out[k] = (a.permute(2, 3, 1, 0) if a.dim() == 4 else a).numpy()
    return out


def _features(params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] -> pooled float32 features [B, width]; the
    convolutions in bfloat16 (stride 2, flax SAME)."""
    x = frames.to(torch.bfloat16).permute(0, 3, 1, 2) / 255.0
    for name in ("conv1", "conv2"):
        w = params[name].to(device=x.device, dtype=torch.bfloat16)
        x = torch.relu(F.conv2d(same_pad(x, 3, 2), w, stride=2))
    return torch.mean(x, dim=(2, 3)).to(torch.float32)


def forward(params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] float -> [B, 32] logits."""
    emb = _features(params, frames) @ params["proj"]
    emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-6)
    return emb @ params["cls"]


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].to(logits.device)).sum()


def loss_fn(params, frames, labels) -> torch.Tensor:
    return _nll_sum(forward(params, frames), labels) / frames.shape[0]


def train_step(params, frames, labels, lr: float = 1e-2):
    """One unsharded step on the params' device -> (new params, loss)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = loss_fn(leaves, frames, labels)
    grads = torch.autograd.grad(loss, [leaves[k] for k in _KEYS])
    new = {k: (leaves[k] - lr * g).detach()
           for k, g in zip(_KEYS, grads)}
    return new, float(loss.detach())


def _data(batch: int, hw: int):
    frames = np.random.default_rng(0).integers(
        0, 255, (batch, hw, hw, 3)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 32, (batch,))
    return torch.from_numpy(frames), torch.from_numpy(labels)


def param_shardings(mesh: Mesh) -> Dict[str, tuple]:
    """Each dry-run parameter's placement on ``mesh``, as the JAX
    package's PartitionSpecs give it: for each axis of the parameter, the
    mesh axis it is split over (None: whole on every device). The
    convolutions are replicated, ``proj``'s columns and ``cls``'s rows
    split over the 'model' axis; ``sharded_train_step`` places them so."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"the mesh {mesh.axis_names} has no 'model' axis")
    return {"conv1": (None, None, None, None),
            "conv2": (None, None, None, None),
            "proj": (None, "model"), "cls": ("model", None)}


def _place(params, mesh: Mesh) -> Dict[str, Any]:
    """Each parameter where ``param_shardings`` puts it, as a leaf that
    takes a gradient: a whole one on mesh[0, 0] (a data row copies it to
    its device), a split one as its slices along the split axis, slice j
    on mesh[0, j]."""
    out = {}
    for k, spec in param_shardings(mesh).items():
        leaf = params[k].detach()
        if "model" in spec:
            out[k] = [part.to(mesh.devices[0, j]).requires_grad_(True)
                      for j, part in enumerate(leaf.chunk(
                          mesh.devices.shape[1], spec.index("model")))]
        else:
            out[k] = leaf.to(mesh.devices[0, 0]).requires_grad_(True)
    return out


def sharded_train_step(params, frames, labels, mesh: Mesh,
                       lr: float = 1e-2):
    """One step over a (data, model) mesh -> (new params, loss): the
    parameters placed by ``param_shardings`` (``_place``), a batch slice
    per data row."""
    D, M = mesh.devices.shape
    home = mesh.devices[0, 0]
    embed = params["proj"].shape[1]
    if embed % M or frames.shape[0] % D:
        raise ValueError(f"the mesh {mesh.shape} does not divide embed "
                         f"{embed} and batch {frames.shape[0]}")
    placed = _place(params, mesh)
    proj, cls = placed["proj"], placed["cls"]
    total = None
    for d, (fd, ld) in enumerate(zip(frames.chunk(D), labels.chunk(D))):
        row = mesh.devices[d]
        feats = _features({k: placed[k].to(row[0])
                           for k in ("conv1", "conv2")}, fd.to(row[0]))
        emb = [feats.to(row[j]) @ proj[j].to(row[j]) for j in range(M)]
        sq = sum((e * e).sum(-1, keepdim=True).to(row[0]) for e in emb)
        norm = torch.sqrt(sq) + 1e-6
        logits = sum(((e / norm.to(row[j])) @ cls[j].to(row[j])).to(row[0])
                     for j, e in enumerate(emb))
        part = _nll_sum(logits, ld).to(home)
        total = part if total is None else total + part
    loss = total / frames.shape[0]
    loss.backward()
    new = {}
    for k, spec in param_shardings(mesh).items():
        if "model" in spec:
            new[k] = torch.cat([(p - lr * p.grad).detach().to(home)
                                for p in placed[k]], spec.index("model"))
        else:
            new[k] = (placed[k] - lr * placed[k].grad).detach()
    return new, float(loss.detach())


def run_dryrun(n_devices: int, batch: int = 16, hw: int = 32,
               params: Optional[Dict] = None, device=None) -> float:
    """One sharded training step on tiny shapes over ``make_mesh(
    n_devices)``; returns the loss. ``params``: the weights (default
    the JAX package's draw, ``default_params``, on the mesh's first
    device)."""
    mesh = make_mesh(n_devices, device=device)
    frames, labels = _data(batch, hw)
    if params is None:
        params = default_params(mesh.devices[0, 0])
    _, loss = sharded_train_step(params, frames, labels, mesh)
    return loss


def pytest_approx_rows(a, b, tol: float = 1e-5):
    """Row-wise approx equality helper (no pytest dependency here): returns
    ``a`` when every element matches ``b`` within tol, else ``b`` (so the
    caller's equality assert fails and prints both)."""
    if len(a) != len(b):
        return b
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return b
        for x, y in zip(ra, rb):
            if abs(x - y) > tol:
                return b
    return a


def run_pp_sp_dryrun(n_devices: int, device=None) -> None:
    """Pipeline-parallel (one stage per device), spatial-parallel
    (row-sharded conv with halo exchange) and expert-parallel (top-1 MoE,
    experts split per device) on tiny shapes, each checked against its
    unsharded golden."""
    from .expert import _from_flax, default_tree, moe_apply, moe_reference
    from .pipeline_parallel import (pipeline_apply, sequential_reference,
                                    stack_stage_params)
    from .spatial import spatial_apply

    devs = local_devices(device)[:n_devices]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    # pp: n_devices stages, 2*n microbatches
    f = 8
    stacked = stack_stage_params([
        {"w": t(rng.normal(size=(f, f), scale=0.3)),
         "b": t(rng.normal(size=(f,), scale=0.1))}
        for _ in range(n_devices)])

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    x = t(rng.normal(size=(2 * n_devices, 2, f)))
    got = pipeline_apply(stage_fn, stacked, x, Mesh(devs, ("pipe",)))
    want = sequential_reference(stage_fn, stacked, x)
    if not torch.allclose(got, want, atol=1e-5):
        raise AssertionError("pp dryrun: mismatch")

    # sp: 3x3 SAME conv, rows sharded, halo=1, bit-exact vs unsharded. The
    # conv is nine shifted products summed in a fixed order, so that each
    # output pixel's arithmetic is the same at any image height on any
    # device (a library convolution may pick another algorithm for
    # another height)
    k = t(rng.normal(size=(3, 3, 3, 4), scale=0.2)).to(devs[0])

    def conv(img, row_mask=None):
        if row_mask is not None:
            img = img * row_mask[None, :, None, None]
        pad = F.pad(img, (0, 0, 1, 1, 1, 1))
        h, w = img.shape[1], img.shape[2]
        y = None
        for dy in range(3):
            for dx in range(3):
                term = pad[:, dy:dy + h, dx:dx + w, :, None] \
                    * k[dy, dx].to(img.device)
                y = term if y is None else y + term
        return y.sum(dim=3)

    img = t(rng.normal(size=(1, 4 * n_devices, 16, 3))).to(devs[0])
    got_sp = spatial_apply(conv, img, halo=1, mesh=Mesh(devs, ("data",)))
    if not torch.equal(got_sp, conv(img)):
        raise AssertionError("sp dryrun: halo-exchange mismatch")

    # ep: n_devices experts, one per device, top-1 routing; the JAX
    # package's init_moe_params(PRNGKey(3), n_devices, 8, 16), drawn where
    # the rows and the golden are, on the CPU
    mp = _from_flax(default_tree(jax_random.prng_key(3, "cpu"),
                                 (n_devices, 8, 16)))
    xt = t(rng.normal(size=(4 * n_devices, 8)))
    got_ep = moe_apply(mp, xt, Mesh(devs, ("expert",)))
    if not torch.allclose(got_ep, moe_reference(mp, xt), atol=1e-5):
        raise AssertionError("ep dryrun: mismatch")


class _FakeVideo:
    """A seeded synthetic video behind the executor's source interface."""

    is_video = True

    def __init__(self, n: int, h: int, w: int, seed: int):
        from ..io.video import VideoMetadata

        self.frames = np.random.default_rng(seed).integers(
            0, 256, (n, h, w, 3), np.uint8)
        self._meta = VideoMetadata("fake", n, 24.0, w, h)

    def __len__(self):
        return len(self.frames)

    def metadata(self):
        return self._meta

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


def _client(d: str, device):
    import scannertools_tpu_torch as st

    return st, st.Client(db_path=d + "/db", device=device)


def _engaged(sc, axis: str) -> None:
    counts = sc.profiler.counts()
    if counts.get(f"axis:{axis}:not_engaged") or \
            not counts.get(f"axis:{axis}:engaged"):
        raise AssertionError(f"the {axis} axis did not engage: {counts}")


def run_executor_dryrun(n_devices: int, device=None) -> None:
    """The chunked executor over an n-device data mesh, with a tail chunk
    whose frame count does not divide the mesh and a stencil whose halo
    crosses shard boundaries: Histogram and FrameDifference rows equal to
    the plain references, and MTCNN's rows within 1e-5 of a 1-instance
    run (``MTCNNForward`` is ``batch_local``: its segment splits frames a
    shard, each shard's nets at a smaller batch)."""
    from ..ops.histogram import hist_rgb_plain

    n_frames = 2 * n_devices + 3  # ragged tail: W=2n -> tail T=3
    fv = _FakeVideo(n_frames, 16, 128, 0)
    with tempfile.TemporaryDirectory() as d:
        st, sc = _client(d, device)
        frame = sc.io.Input([fv])
        hist = sc.ops.Histogram(frame=frame)
        fd = sc.ops.FrameDifference(frames=frame)
        out_h = st.NamedStream(sc, "dry_h")
        out_d = st.NamedStream(sc, "dry_d")
        perf = st.PerfParams.manual(work_packet_size=2 * n_devices,
                                    pipeline_instances_per_node=n_devices)
        sc.run(sc.io.Output([hist, fd], [(out_h, out_d)]), perf,
               cache_mode=st.CacheMode.Overwrite)
        got = np.stack([np.stack(h) for h in out_h.load()])
        x = torch.from_numpy(fv.frames)
        want = hist_rgb_plain(x, 16 * 128 * 3).numpy()
        if got.shape != want.shape or not (got == want).all():
            raise AssertionError("executor dryrun: sharded histogram "
                                 "mismatch")
        diffs = list(out_d.load())
        if len(diffs) != n_frames:
            raise AssertionError("executor dryrun: FrameDifference rows")
        for i in (1, n_devices, n_frames - 1):  # incl. shard-edge rows
            want_d = np.abs(fv.frames[i].astype(np.int16)
                            - fv.frames[i - 1].astype(np.int16)
                            ).astype(np.uint8)
            if not (diffs[i] == want_d).all():
                raise AssertionError(f"executor dryrun: stencil row {i} "
                                     "wrong across shards")
        _engaged(sc, "data")

        faces = sc.ops.MTCNNDetectFaces(frame=frame)
        rows = {}
        for inst in (n_devices, 1):
            out_f = st.NamedStream(sc, f"dry_f{inst}")
            sc.run(sc.io.Output(faces, [out_f]),
                   st.PerfParams.manual(work_packet_size=2 * n_devices,
                                        pipeline_instances_per_node=inst),
                   cache_mode=st.CacheMode.Overwrite)
            rows[inst] = [[(b.x1, b.y1, b.x2, b.y2, b.score) for b in fl]
                          for fl in out_f.load()]
        if len(rows[n_devices]) != n_frames or not _rows_close(
                rows[n_devices], rows[1], 1e-5):
            raise AssertionError("executor dryrun: sharded MTCNN rows "
                                 "differ from the 1-instance run")


def _rows_close(a, b, tol: float) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if any(abs(p - q) > tol for p, q in zip(x, y)):
                return False
    return True


def run_pp_executor_dryrun(n_devices: int, device=None) -> None:
    """PerfParams(pipeline_stages=5) through the executor: OpenPose's five
    uniform refinement stages one per device inside a normal ``sc.run``,
    held to the unpipelined run."""
    if n_devices < 5:
        return
    fv = _FakeVideo(4, 48, 48, 7)
    with tempfile.TemporaryDirectory() as d:
        st, sc = _client(d, device)

        def run(stages, tag):
            node = sc.ops.OpenPoseForward(frame=sc.io.Input([fv]))
            out = st.NamedStream(sc, f"pp_dry_{tag}")
            sc.run(sc.io.Output(node[0], [out]),
                   st.PerfParams.manual(work_packet_size=4,
                                        pipeline_stages=stages),
                   cache_mode=st.CacheMode.Overwrite)
            return np.stack(list(out.load()))

        got = run(5, "pipe")
        want = run(0, "ref")
        if got.shape != want.shape or not np.allclose(got, want, atol=1e-3):
            raise AssertionError("pp executor dryrun mismatch")
        _engaged(sc, "pipe")


def run_sp_executor_dryrun(n_devices: int, device=None) -> None:
    """PerfParams(spatial_shards=n) through the executor: a FrameDifference
    -> Blur -> ConvertToHSV chain — every op declaring OpDef.sp_halo — runs
    row-sharded one slab per device, bit-exact against the unsharded run;
    then ``estimate(spatial_shards=-1)`` picks the count from the declared
    metadata and engages through the same run."""
    fv = _FakeVideo(4, 8 * n_devices, 32, 13)
    with tempfile.TemporaryDirectory() as d:
        st, sc = _client(d, device)

        def run(perf, tag):
            frame = sc.io.Input([fv])
            diff = sc.ops.FrameDifference(frames=frame)
            blurred = sc.ops.Blur(frame=diff, kernel_size=9)
            hsv = sc.ops.ConvertToHSV(frame=blurred)
            out = st.NamedStream(sc, f"sp_dry_{tag}")
            sc.run(sc.io.Output(hsv, [out]), perf,
                   cache_mode=st.CacheMode.Overwrite)
            return np.stack(list(out.load()))

        got = run(st.PerfParams.manual(work_packet_size=4,
                                       spatial_shards=n_devices), "sp")
        want = run(st.PerfParams.manual(work_packet_size=4), "ref")
        if got.shape != want.shape or not (got == want).all():
            raise AssertionError("sp executor dryrun mismatch")
        auto = run(st.PerfParams.estimate(work_packet_size=4,
                                          spatial_shards=-1), "auto")
        if not (auto == want).all():
            raise AssertionError("sp estimator auto-engage mismatch")
        _engaged(sc, "sp")


def _near_tie(scores: torch.Tensor, rtol: float = 1e-4) -> bool:
    """The best two logits of a head are within ``rtol`` of its largest
    magnitude: an argmax there may go either way."""
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1]) <= rtol * float(scores.abs().max())


def run_ep_executor_dryrun(n_devices: int, device=None) -> None:
    """PerfParams(expert_shards=n) through the executor: MoEHead's experts
    one group per device with the partial outputs summed, within 1e-4 of
    the single-device formulation; then DetectClothing's 16 attribute
    heads split over the 'expert' mesh, whose predictions must equal the
    single-device per-head path's except at a head whose best two logits
    are a near-tie (the port compares logits, not argmaxes alone)."""
    from ..models import streetstyle
    from ..ops.clothing import clothing_crop
    from ..ops.faces import _get_params
    from ..protobufs import BoundingBox

    n_frames, h, w = 8, 8, 8  # d_model = 8*8*3 = 192
    fv = _FakeVideo(n_frames, h, w, 29)
    with tempfile.TemporaryDirectory() as d:
        st, sc = _client(d, device)

        def run(shards, tag):
            y = sc.ops.MoEHead(input=sc.io.Input([fv]),
                               n_experts=2 * n_devices, d_model=h * w * 3,
                               d_hidden=32)
            out = st.NamedStream(sc, f"ep_dry_{tag}")
            sc.run(sc.io.Output(y, [out]),
                   st.PerfParams.manual(work_packet_size=4,
                                        expert_shards=shards),
                   cache_mode=st.CacheMode.Overwrite)
            return np.stack(list(out.load()))

        got = run(n_devices, "ep")
        want = run(0, "ref")
        if got.shape != want.shape or not np.allclose(got, want, atol=1e-4):
            raise AssertionError("ep executor dryrun mismatch")
        _engaged(sc, "expert")

        box = BoundingBox(x1=0.1, y1=0.1, x2=0.9, y2=0.9, score=1.0)

        @st.register_python_op(name="EpDryFace", outputs=("object",))
        def ep_dry_face(ctx, frames):
            return [[box] for _ in range(len(frames))]

        def run_clothing(shards, tag):
            frame = sc.io.Input([fv])
            cl = sc.ops.DetectClothing(frame=frame,
                                       bboxes=sc.ops.EpDryFace(frames=frame),
                                       adjust_bboxes=False)
            out = st.NamedStream(sc, f"ep_cl_{tag}")
            sc.run(sc.io.Output(cl, [out]),
                   st.PerfParams.manual(work_packet_size=4,
                                        expert_shards=shards),
                   cache_mode=st.CacheMode.Overwrite)
            return [[r.predictions.tolist() for r in row]
                    for row in out.load()]

        got_cl = run_clothing(n_devices, "ep")
        want_cl = run_clothing(0, "ref")
        if len(got_cl) != len(want_cl):
            raise AssertionError("expert-sharded clothing rows")
        state = _get_params("streetstyle_clothing", None)
        for i, (g, wnt) in enumerate(zip(got_cl, want_cl)):
            if g == wnt:
                continue
            crop = clothing_crop(fv.frames[i].astype(np.float32), box)
            scores, _ = streetstyle.forward(
                state, torch.from_numpy(crop[None].astype(np.float32)),
                streetstyle.CLOTHING_ATTRIBUTES)
            for e, (a, b) in enumerate(zip(g[0], wnt[0])):
                if a != b and not _near_tie(scores[e][0]):
                    raise AssertionError(
                        f"expert-sharded clothing head {e} of frame {i}: "
                        f"{a} against {b} off a near-tie")
        _engaged(sc, "expert")
