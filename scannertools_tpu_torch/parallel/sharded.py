"""Multi-device execution: the frame axis of a chunk sharded over a mesh.

Reference parity: ``pipeline_instances_per_node`` replicated the op pipeline
across GPUs of a node and gRPC master/worker spread work across nodes
(SURVEY §2j; scannertools_infra/tests.py:17-33). The JAX package (its
parallel/sharded.py) shards one jitted chunk program's frame axis with
``NamedSharding`` and lets GSPMD partition it.

Here the executor splits a device segment itself (runtime/executor.py):

  * Intra-host: the chunk's frames are padded to a multiple of the data
    mesh (``pad_rows_to_multiple``), each shard gets its contiguous frames
    plus the temporal halo its stencils need (``row_windows``), the
    segment runs on each shard's device, and ``gather_rows`` puts the
    shards' rows back in order on the client's device.
  * An op that couples a chunk's rows before a per-row net (the face
    nets' crop budget) runs whole and hands its net's batch to
    ``split_batch``: a slice of rows a device, gathered in order.
  * Inter-host: jobs (videos / frame ranges) partition statically across
    processes by their index (``host_job_slice``): the master/worker
    control plane collapses into deterministic ownership, with storage
    (named streams) as the only shared state. The index and count are
    torchrun's ``RANK``/``WORLD_SIZE``, or arguments; no process group is
    needed.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.framechunk import FrameChunk
from .mesh import Mesh, local_devices, move, shard_frames


def data_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-axis "data" mesh over the first ``n_devices`` local devices."""
    devs = local_devices(device)
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(devs, ("data",))


def frame_sharding(mesh: Mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """The partition spec of a frame-sharded value: axis 0 (frames) over
    "data", the rest replicated (``P("data", None, ...)``)."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"frame_sharding: mesh has no 'data' axis: "
                         f"{mesh.axis_names}")
    return ("data",) + (None,) * (ndim - 1)


def pad_frames_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_rows_to(x, n: int):
    """Pad axis 0 of a tensor, numpy array, list, FrameChunk, or a
    tuple/list/dict of them, to ``n`` rows by replicating the last row."""
    if isinstance(x, dict):
        return {k: pad_rows_to(v, n) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(pad_rows_to(v, n) for v in x)
    if isinstance(x, FrameChunk):
        return x._like(pad_rows_to(x.flat, n))
    extra = n - len(x)
    if extra < 0:
        raise ValueError(f"pad_rows_to: {len(x)} rows exceed {n}")
    if extra == 0:
        return x
    if isinstance(x, list):
        return x + [x[-1]] * extra
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)])
    return torch.cat([x, x[-1:].expand(extra, *x.shape[1:])], dim=0)


def pad_rows_to_multiple(x, multiple: int):
    """Pad axis 0 of every leaf (tensor, array or FrameChunk) up to a
    multiple of ``multiple`` by replicating the last row. The executor's
    slicing is front-anchored, so the replicated tail is never read."""
    if isinstance(x, dict):
        return {k: pad_rows_to_multiple(v, multiple) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(pad_rows_to_multiple(v, multiple) for v in x)
    return pad_rows_to(x, pad_frames_to(len(x), multiple))


def shard_value(mesh: Mesh, x) -> list:
    """A chunk value (tensor or FrameChunk, frames already padded to a
    multiple of the mesh) -> its per-device frame shards, each on its
    device of the "data" axis."""
    return shard_frames(mesh, x, "data")


def row_windows(x, n_shards: int, local: int, extra: int) -> list:
    """Shard k's rows ``[k * local, k * local + local + extra)`` of ``x``
    (a tensor, array, list or FrameChunk whose length is at least
    ``n_shards * local + extra``): its contiguous frames plus the ``extra``
    rows after them that a temporal stencil reads. For a stencil (0, 1)
    an interior shard's extra row is its successor's first frame, as
    ``mesh.halo_exchange_1`` gives it; the last shard's is the chunk's
    own decoded halo row (the stream edge is clamped at decode)."""
    out = []
    for k in range(n_shards):
        a = k * local
        if isinstance(x, FrameChunk):
            out.append(x.slice_rows(a, local + extra))
        else:
            out.append(x[a:a + local + extra])
    return out


def gather_rows(parts: list, device: torch.device):
    """Concatenate the shards' rows, in order, on ``device``."""
    first = parts[0]
    if isinstance(first, FrameChunk):
        flat = torch.cat([move(p, device).flat for p in parts], dim=0)
        return first._like(flat)
    if isinstance(first, tuple):
        return tuple(gather_rows([p[i] for p in parts], device)
                     for i in range(len(first)))
    if isinstance(first, list):
        return [el for p in parts for el in p]
    return torch.cat([torch.as_tensor(p).to(device, non_blocking=True)
                      for p in parts], dim=0)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def host_job_slice(n_jobs: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> range:
    """The contiguous job slice owned by this process (inter-host data
    parallelism; replaces the reference's master/worker dispatch). The
    index and count default to ``RANK`` and ``WORLD_SIZE`` (0 and 1 when
    unset), as ``jax.process_index()``/``process_count()`` give them."""
    pi = _env_int("RANK", 0) if process_index is None else process_index
    pc = _env_int("WORLD_SIZE", 1) if process_count is None \
        else process_count
    if pc < 1 or not 0 <= pi < pc:
        raise ValueError(f"host_job_slice: process {pi} of {pc}")
    per = -(-n_jobs // pc)
    return range(min(pi * per, n_jobs), min((pi + 1) * per, n_jobs))


def split_batch(fn, states: list, x: torch.Tensor, mesh: Mesh):
    """``fn(state, rows)`` over contiguous row slices of ``x``, slice k on
    the mesh's k-th device with ``states[k]``, that device's copy of the
    weights -> the rows (a tensor, or a tuple of them) in order on
    ``x``'s device. For a net whose row i reads input row i alone (the
    face nets over a compacted crop batch, ops/faces.py); no host sync.

    The slices are at most one row apart in length and hold two rows or
    more (fewer slices than devices when the batch is small): a one-row
    batch takes the matrix-vector path of a net's linear layers, which
    rounds otherwise than the batched product (FaceNet's embeddings by
    1.3e-7 on the CPU), and costs its device a whole forward for one
    crop."""
    devs = mesh.device_list()
    if len(states) != len(devs):
        raise ValueError(f"split_batch: {len(states)} weight copies for "
                         f"{len(devs)} devices")
    n = max(1, min(len(devs), len(x) // 2))
    parts = [fn(s, move(rows, d)) for s, d, rows in
             zip(states, devs, torch.tensor_split(x, n))]
    return gather_rows(parts, x.device)
