"""Tensor-parallel (tp) inference for the model zoo.

The reference has no model parallelism — its nets are small per-frame CNNs
scheduled data-parallel (SURVEY §2j). The JAX package (its
parallel/model_sharding.py) places each large weight with a
``NamedSharding`` over a ``model`` axis and lets GSPMD insert the
collectives: its rule shards the largest divisible trailing axis, which
in flax's HWIO and ``[in, out]`` layouts is the output channels —
column-parallel in Megatron terms.

The port keeps that meaning in torch's layouts, where the output channels
lead (OIHW, ``[out, in]``): every weight of ``min_size`` elements or more
whose output channels divide the model axis is split along them, one
block per device of the axis; smaller ones (biases, norms) are
replicated. ``tp_apply`` runs a forward with each such convolution or
linear layer computed block by block, each on its own device, and the
activations concatenated along the channel axis on the row's device (the
all-gather). A ``TorchFunctionMode`` sees every ``conv2d``/``linear``
whose weight is a split one; the forward itself is the model's own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .mesh import Mesh, local_devices

_CONV = torch.nn.functional.conv2d    # the builtin torch.conv2d
_LINEAR = torch.nn.functional.linear  # the builtin torch._C._nn.linear


def _spec_for(shape, n_model: int, min_size: int) -> Tuple:
    """The partition spec of a torch weight: ``("model", None, ...)``
    (output channels, axis 0, split over the model axis) when it has at
    least ``min_size`` elements and its output channels divide the axis,
    else ``()`` (replicated)."""
    shape = tuple(shape)
    if int(np.prod(shape)) < min_size or n_model <= 1 or not shape:
        return ()
    if shape[0] % n_model == 0 and shape[0] >= n_model:
        return ("model",) + (None,) * (len(shape) - 1)
    return ()


class ColumnShards:
    """A weight split along its output channels: ``blocks[d][j]`` is block
    j on device ``mesh[d, j]`` (each data row holds a copy of the model
    axis's blocks). ``shape`` is the whole weight's."""

    def __init__(self, weight: torch.Tensor, mesh: Mesh):
        self.shape = tuple(weight.shape)
        n = int(mesh.shape["model"])
        local = self.shape[0] // n
        self.blocks = [[weight[j * local:(j + 1) * local].to(
            mesh.devices[d, j]) for j in range(n)]
            for d in range(mesh.devices.shape[0])]


def _grid(mesh: Mesh) -> Mesh:
    """``mesh`` as a (data, model) grid (a model-only mesh is one row)."""
    if mesh.axis_names == ("data", "model"):
        return mesh
    if mesh.axis_names == ("model",):
        return Mesh(mesh.devices.reshape(1, -1), ("data", "model"))
    raise ValueError(f"tensor parallelism needs a 'model' axis (and an "
                     f"optional leading 'data' axis): {mesh.axis_names}")


def shard_params(state: Dict[str, Any], mesh: Mesh,
                 min_size: int = 1 << 16) -> Dict[str, Any]:
    """A state_dict with every weight that ``_spec_for`` splits replaced by
    its ``ColumnShards``; the rest are left as they are (replicated: moved
    to each row's device when the forward runs)."""
    grid = _grid(mesh)
    n_model = int(grid.shape["model"])
    out = {}
    for k, v in state.items():
        v = torch.as_tensor(v)
        out[k] = ColumnShards(v, grid) \
            if _spec_for(v.shape, n_model, min_size) else v
    return out


class _ColumnParallel(TorchFunctionMode):
    """Computes each conv2d/linear whose weight is a placeholder of a
    ``ColumnShards`` block by block on data row ``row``'s devices."""

    def __init__(self, shards: Dict[int, ColumnShards], row: int):
        super().__init__()
        self.shards = shards
        self.row = row

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        conv = func is _CONV
        if conv or func is _LINEAR:
            args = list(args)
            w = args[1] if len(args) > 1 else kwargs.get("weight")
            sh = self.shards.get(id(w))
            if sh is not None:
                return self._column(func, conv, args, kwargs, sh)
        return func(*args, **kwargs)

    def _column(self, func, conv, args, kwargs, sh: ColumnShards):
        x = args[0]
        bias = args[2] if len(args) > 2 else kwargs.pop("bias", None)
        rest = args[3:]
        blocks = sh.blocks[self.row]
        groups = (rest[3] if len(rest) > 3 else kwargs.get("groups", 1)) \
            if conv else 1
        if groups != 1:
            # a grouped convolution's blocks do not map onto whole groups:
            # the layer runs whole on the row's device
            w = torch.cat([b.to(x.device) for b in blocks], dim=0)
            return func(x, w, bias, *rest, **kwargs)
        parts = []
        lo = 0
        for w in blocks:
            hi = lo + w.shape[0]
            b = None if bias is None else bias[lo:hi].to(w.device)
            parts.append(func(x.to(w.device, non_blocking=True), w, b,
                              *rest, **kwargs).to(x.device,
                                                  non_blocking=True))
            lo = hi
        return torch.cat(parts, dim=1 if conv else -1)


def tp_apply(apply_fn: Callable, variables: Dict[str, Any], mesh: Mesh,
             data_parallel: bool = True) -> Callable:
    """-> ``fn(x, *args)`` running ``apply_fn(state, x, *args)``
    tensor-parallel over the mesh, ``variables`` from ``shard_params``.
    The batch axis splits over ``data`` when asked (and divisible), a
    slice per data row; the output comes back on ``x``'s device."""
    grid = _grid(mesh)
    n_data = int(grid.shape["data"])
    placeholders = {}
    for k, v in variables.items():
        if isinstance(v, ColumnShards):
            placeholders[k] = torch.empty(v.shape, device="meta")

    def row_state(d: int):
        home = grid.devices[d, 0]
        state = {k: placeholders[k] if k in placeholders
                 else v.to(home) for k, v in variables.items()}
        shards = {id(placeholders[k]): variables[k] for k in placeholders}
        return home, state, shards

    rows = [row_state(d) for d in range(n_data)]

    def run(x, *args):
        x = torch.as_tensor(x)
        split = data_parallel and n_data > 1 and x.shape[0] % n_data == 0
        xs = x.chunk(n_data) if split else [x]
        outs = []
        for d, xd in enumerate(xs):
            home, state, shards = rows[d]
            with _ColumnParallel(shards, d):
                outs.append(apply_fn(state, xd.to(home), *args))
        return _cat_rows(outs, x.device)

    return run


def _cat_rows(outs: List, device: torch.device):
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_cat_rows([o[i] for o in outs], device)
                             for i in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs], dim=0)


def tp_model(name: str, mesh: Optional[Mesh] = None,
             weights_path: Optional[str] = None,
             min_size: int = 1 << 16, device=None):
    """A registry model (``ops/nn_generic.py``'s names) -> (sharded state,
    tp ``run(x)``) over ``mesh`` (default: one data row over every local
    device of ``device``'s type, a maximal model axis)."""
    from ..ops.faces import _MODELS, _get_params
    from ..ops.nn_generic import get_model

    if mesh is None:
        devs = local_devices(device)
        grid = np.empty((1, len(devs)), dtype=object)
        for i, d in enumerate(devs):
            grid[0, i] = d
        mesh = Mesh(grid, ("data", "model"))
    model, apply_fn = get_model(name)
    state = _get_params(model, weights_path, device=mesh.devices.flat[0])
    # a net that folds its weights before its forward (FaceNet) splits the
    # folded ones: the split layers are the ones its forward runs
    fold = getattr(_MODELS.get(model), "fold", None)
    sharded = shard_params(state if fold is None else fold(state), mesh,
                           min_size=min_size)
    return sharded, tp_apply(apply_fn, sharded, mesh)
