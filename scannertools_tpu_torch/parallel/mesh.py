"""Device meshes for the multi-device axes.

Reference parity: the reference scales by data parallelism over stream
elements (``pipeline_instances_per_node`` within a node, gRPC
master/worker across nodes; SURVEY §2j). The JAX package (its
parallel/mesh.py) puts frames on a ``jax.sharding.Mesh`` of chips, with a
``ppermute`` for temporal halos.

Here a mesh is a named grid of ``torch.device``s held by one process (the
JAX package is single-controller too: one process drives every device). A
shard is a tensor on its device; the collectives are explicit copies
between shards (``halo_exchange_1`` below; a sum on one device for
``psum``; a ``torch.cat`` on the output device for an all-gather). A
device may repeat in the grid: a real multi-GPU host has ``cuda:0..N-1``
(peer copies), while ``SCANNERTOOLS_TORCH_LOGICAL_DEVICES=N`` makes
``local_devices`` return N logical devices over the first real one, as
the JAX tests multiply the CPU with
``--xla_force_host_platform_device_count``. That variable is never set by
default; the CPU tests set it to 8 and ``chip_smoke.py``'s phase 11 sets it
for its meshes on the one card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LOGICAL_DEVICES_ENV = "SCANNERTOOLS_TORCH_LOGICAL_DEVICES"


def local_devices(device=None) -> List[torch.device]:
    """This process's devices of ``device``'s type (the counterpart of
    ``jax.devices()``): every CUDA device (``cuda:0..N-1``) by default,
    or the CPU when ``device`` is the CPU. With
    ``SCANNERTOOLS_TORCH_LOGICAL_DEVICES=N`` set, N logical devices over
    the first real one. Raises where CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        real = [torch.device("cpu")]
    elif dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError("local_devices: no CUDA device; pass the CPU "
                               "device to build a CPU mesh")
        real = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"local_devices: unsupported device {dev}")
    logical = os.environ.get(LOGICAL_DEVICES_ENV)
    if logical:
        n = int(logical)
        if n < 1:
            raise ValueError(f"{LOGICAL_DEVICES_ENV}={logical!r}: need >= 1")
        return [real[0]] * n
    return real


class Mesh:
    """An ndarray of ``torch.device`` with one name per axis, as
    ``jax.sharding.Mesh``: ``.devices``, ``.axis_names``, ``.shape`` (axis
    name -> size) and ``.size``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices)[:len(axis_names)] or (1,),
                       dtype=object)
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        if len(flat) != arr.size or arr.ndim != len(axis_names):
            raise ValueError(f"Mesh: {len(flat)} devices do not form a grid "
                             f"for axes {tuple(axis_names)}")
        for i, d in enumerate(flat):
            arr.flat[i] = torch.device(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)

    def names(self) -> List[str]:
        """The devices as strings, in mesh order (what the smoke prints)."""
        return [str(d) for d in self.devices.flat]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    def _key(self) -> Tuple:
        return (self.axis_names, self.devices.shape, tuple(self.names()))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.names()})"


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data", "model"),
              device=None) -> Mesh:
    """1- or 2-axis mesh over ``local_devices(device)``. With 2 axes the
    model axis gets up to 2 devices and data the rest (frames are the
    scalable axis, mirroring the reference's data-parallel design)."""
    devs = local_devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if len(axes) == 1:
        return Mesh(devs, axes)
    model = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // model
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devs[: data * model]):
        grid.flat[i] = d
    return Mesh(grid, axes)


def move(x, device: torch.device):
    """A tensor or FrameChunk on ``device`` (no copy when it is there)."""
    from ..utils.framechunk import FrameChunk

    if isinstance(x, FrameChunk):
        if not x.on_host and x.flat.device == device:
            return x
        src = torch.from_numpy(x.flat) if x.on_host else x.flat
        return x._like(src.to(device, non_blocking=True))
    return torch.as_tensor(x).to(device, non_blocking=True)


def shard_frames(mesh: Mesh, frames, axis: str = "data") -> list:
    """A [T, ...] tensor or FrameChunk -> one contiguous frame block per
    device along ``axis``, each on its device. T must divide the axis
    (pad first: parallel/sharded.pad_rows_to_multiple)."""
    devs = mesh.axis_devices(axis)
    t = len(frames)
    if t % len(devs):
        raise ValueError(f"shard_frames: {t} frames do not divide mesh "
                         f"axis {axis!r} of {len(devs)}")
    local = t // len(devs)
    return [move(_rows(frames, k * local, local), d)
            for k, d in enumerate(devs)]


def _rows(x, start: int, length: int):
    from ..utils.framechunk import FrameChunk

    if isinstance(x, FrameChunk):
        return x.slice_rows(start, length)
    return x[start:start + length]


def halo_exchange_1(shards: list) -> list:
    """Append each shard's successor's first frame (a 1-frame forward
    halo): shard i gets ``[shard i, first frame of shard i + 1]``, copied
    to shard i's device. The last shard has no successor and replicates
    its own final frame (the stream-edge clamp, matching the executor's
    replicate padding). The ``ppermute`` of the JAX package's
    ``halo_exchange_1``, for a temporal stencil (0, 1) such as flow's
    pairs."""
    out = []
    n = len(shards)
    for i, x in enumerate(shards):
        tail = x[-1:] if i == n - 1 else shards[i + 1][:1].to(
            x.device, non_blocking=True)
        out.append(torch.cat([x, tail], dim=0))
    return out
