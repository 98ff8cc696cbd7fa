"""Numerics shared by the ops and the models: the JAX package's arithmetic
as jitted XLA computes it, reproduced in torch.

  * a division by a constant is a product with the constant's float32
    reciprocal (``div``): that is what the JAX package computes under
    ``jax.jit`` (XLA's algebraic simplifier rewrites ``x / c``), and what
    PyTorch's CUDA division by a Python scalar computes, while its CPU
    division divides. ``jnp.mean`` is jitted too, so means are sums times
    the count's reciprocal (``mean``);
  * resizing uses the weights ``jax.image.resize`` computes (half-pixel
    centres, edge weights renormalised, Keys cubic with a = -0.5; torch's
    ``bicubic`` uses -0.75 and ``nearest`` is not half-pixel), applied as
    taps along one axis at a time (``resize_hw``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def recip(d: float) -> float:
    """The float32 reciprocal of ``d``, as XLA folds it."""
    return float(np.float32(1) / np.float32(d))


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` for a constant ``d``, as jitted XLA computes it on every
    device (see the module docstring)."""
    return x * recip(d)


def mean(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum times the count's float32 reciprocal."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    return div(x.sum(dim=dims, keepdim=keepdim), float(n))


# ------------------------------------------------------------------ resizing


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.)
    out = np.where(x >= 1., ((np.float32(-0.5) * x + np.float32(2.5)) * x
                             - np.float32(4.)) * x + np.float32(2.), out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


@functools.lru_cache(maxsize=256)
def _resize_taps(n_in: int, n_out: int, method: str, device: torch.device):
    """-> (index, weight) on ``device``: [K, n_out] int64 and float32, the
    inputs of nonzero weight of each output position in increasing order
    (padded with weight 0). The weights are those of
    ``jax.image.resize(..., antialias=False)`` (jax/_src/image/scale.py
    compute_weight_mat), computed in float32 in its order."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv_scale = np.float32(1. / (n_out / n_in))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    w = kernel(np.abs(sample[None, :]
                      - np.arange(n_in, dtype=np.float32)[:, None]))
    total = np.zeros(n_out, np.float32)
    for i in range(n_in):  # the column sums, in input order
        total += w[i]
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0)).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, np.float32(0))
    k = max(1, int((w != 0).sum(axis=0).max()))
    index = np.zeros((k, n_out), np.int64)
    weight = np.zeros((k, n_out), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(w[:, o])
        index[:len(nz), o] = nz
        weight[:len(nz), o] = w[nz, o]
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(weight).to(device))


def _resize_axis(x: torch.Tensor, dim: int, n_out: int,
                 method: str) -> torch.Tensor:
    index, weight = _resize_taps(x.shape[dim], n_out, method, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = None
    for k in range(index.shape[0]):
        term = x.index_select(dim, index[k]) * weight[k].view(shape)
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int,
                   device: torch.device) -> torch.Tensor:
    """jax/_src/image/scale.py _resize_nearest: half-pixel centres,
    floor((i + 0.5) * n_in / n_out) in float32, the division by n_out a
    product with its reciprocal as under ``jax.jit``."""
    pos = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
           * np.float32(n_in) * np.float32(recip(n_out)))
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def resize_hw(x: torch.Tensor, h_dim: int, th: int, tw: int,
              method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, ..., method, antialias=False)`` of the two
    adjacent axes ``h_dim`` and ``h_dim + 1`` to (th, tw); method "linear",
    "cubic" or "nearest". Axes of unchanged size are left alone, as JAX
    skips them. JAX contracts both weight matrices in one einsum, whose
    path takes the cheaper axis first; so does this."""
    w_dim = h_dim + 1
    h, w = x.shape[h_dim], x.shape[w_dim]
    axes = [(d, n) for d, n in ((h_dim, th), (w_dim, tw))
            if x.shape[d] != n]
    if method == "nearest":
        for d, n in axes:
            x = x.index_select(d, _nearest_index(x.shape[d], n, x.device))
        return x
    # opt_einsum's cost of each order, over numel(x) / (h * w)
    if len(axes) == 2 and tw * h * (w + th) < th * w * (h + tw):
        axes.reverse()
    for d, n in axes:
        x = _resize_axis(x, d, n, method)
    return x
