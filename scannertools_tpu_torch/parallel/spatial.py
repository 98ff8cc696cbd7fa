"""Spatial parallelism (sp): a frame's row axis sharded over a mesh.

The reference's unit of parallelism never goes below one frame (SURVEY
§2j — io/work packets slice the *stream*). The JAX package (its
parallel/spatial.py) shards H over chips for frames too large for one
chip's activation working set, with conv halos exchanged by ``ppermute``.
Here each row slab is a tensor on its mesh device; the halo rows are
copies from the neighbouring slabs, and the outputs are gathered in order
on the input's device.

Correctness contract: for a stack of SAME-padded convolutions whose total
receptive field is <= ``halo`` rows per side, halo exchange + crop
reproduces the unsharded output bit for bit —
  * interior shard boundaries see their true neighbour rows, so the
    cropped interior outputs match the global conv exactly;
  * at the global top/bottom edges the halo rows lie *outside* the image.
    SAME padding zero-fills them at EVERY layer, not just the first, so
    ``fn`` receives a ``row_mask`` ([padded_rows] bool, True = inside the
    image) or the global row index and must multiply each layer's input
    by the mask — that re-creates the layer-wise zero padding exactly.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from .mesh import Mesh


def _slabs(x: torch.Tensor, n: int, mesh: Mesh, axis: str,
           row_axis: int) -> List[torch.Tensor]:
    local = x.shape[row_axis] // n
    return [x.narrow(row_axis, k * local, local).to(d, non_blocking=True)
            for k, d in enumerate(mesh.axis_devices(axis))]


def halo_exchange_rows(shards: List[torch.Tensor], halo: int,
                       row_axis: int = 1) -> List[torch.Tensor]:
    """Pad each row slab with ``halo`` rows from each neighbour, copied to
    its device (zero-filled at the global top/bottom edges, i.e.
    SAME-conv padding). ``shards``: the slabs in row order, each
    ``[..., rows_local, ...]`` with the row axis at ``row_axis``."""
    n = len(shards)
    out = []
    for k, x in enumerate(shards):
        local = x.shape[row_axis]
        if k == 0:
            above = torch.zeros_like(x.narrow(row_axis, 0, halo))
        else:
            prev = shards[k - 1]
            above = prev.narrow(row_axis, prev.shape[row_axis] - halo,
                                halo).to(x.device, non_blocking=True)
        if k == n - 1:
            below = torch.zeros_like(x.narrow(row_axis, local - halo, halo))
        else:
            below = shards[k + 1].narrow(row_axis, 0, halo).to(
                x.device, non_blocking=True)
        out.append(torch.cat([above, x, below], dim=row_axis))
    return out


def _check_rows(rows: int, n: int, halo: int) -> None:
    if rows % n != 0 or rows // n < halo:
        raise ValueError(
            f"rows={rows} must divide mesh axis {n} with local shard "
            f">= halo={halo}")


def _run_halo(fn, x: torch.Tensor, halo: int, mesh: Mesh, axis: str,
              row_axis: int, mask: bool) -> torch.Tensor:
    n = int(mesh.shape[axis])
    rows = int(x.shape[row_axis])
    _check_rows(rows, n, halo)
    local = rows // n
    padded = halo_exchange_rows(_slabs(x, n, mesh, axis, row_axis), halo,
                                row_axis)
    outs = []
    for k, p in enumerate(padded):
        g = (k * local + torch.arange(local + 2 * halo, device=p.device)
             - halo).to(torch.int32)
        y = fn(p, (g >= 0) & (g < rows) if mask else g)
        outs.append(y.narrow(row_axis, halo, y.shape[row_axis] - 2 * halo)
                    .to(x.device, non_blocking=True))
    return torch.cat(outs, dim=row_axis)


def spatial_apply_traced(fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                         x: torch.Tensor, halo: int, mesh: Mesh,
                         axis: str = "sp", row_axis: int = 1
                         ) -> torch.Tensor:
    """The executor's form (the JAX package's runs inside a jitted
    segment): ``fn(padded, row_gidx)`` receives each halo-padded slab on
    its device and the GLOBAL row index of every padded row (int32, < 0 or
    >= rows outside the image — ``fn`` derives masks or border logic from
    it). It must return the same padded row count; the halos are cropped
    and the slabs gathered on ``x``'s device."""
    return _run_halo(fn, x, halo, mesh, axis, row_axis, mask=False)


def spatial_apply_pointwise(fn: Callable[[torch.Tensor], torch.Tensor],
                            x: torch.Tensor, mesh: Mesh, axis: str = "sp",
                            row_axis: int = 1) -> torch.Tensor:
    """Row-shard a row-POINTWISE op (halo 0): ``fn`` on each row slab on
    its device, the outputs gathered in row order on ``x``'s device.
    Exact for any ``fn`` whose output row i depends only on input row i
    (color conversions, per-pixel arithmetic, temporal stencils along
    other axes). Callers fall back unsharded when rows don't divide the
    axis (``ctx.sp_mesh`` returns None)."""
    n = int(mesh.shape[axis])
    rows = int(x.shape[row_axis])
    if rows % n != 0:
        raise ValueError(f"rows={rows} must divide mesh axis {n}")
    return torch.cat([fn(s).to(x.device, non_blocking=True)
                      for s in _slabs(x, n, mesh, axis, row_axis)],
                     dim=row_axis)


def spatial_apply(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  x: torch.Tensor, halo: int, mesh: Mesh,
                  axis: str = "data", row_axis: int = 1) -> torch.Tensor:
    """Run ``fn(padded, row_mask)`` (a SAME-padded conv stack, receptive
    field <= ``halo`` rows a side, row-count-preserving, multiplying each
    layer's input by ``row_mask`` — see the module docstring) with ``x``'s
    row axis sharded over ``mesh[axis]``. Returns the full output on
    ``x``'s device. ``x.shape[row_axis]`` must divide by the axis size and
    each local shard must be >= ``halo`` rows (one-hop exchange)."""
    return _run_halo(fn, torch.as_tensor(x), halo, mesh, axis, row_axis,
                     mask=True)
