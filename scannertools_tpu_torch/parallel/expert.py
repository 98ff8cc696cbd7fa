"""Expert parallelism (ep): a routed mixture-of-experts layer, on one
device or one expert group per device over an ``expert`` mesh axis.

The reference has nothing like this (its nets are fixed per-frame CNNs,
SURVEY §2j); the JAX package (scannertools_tpu's parallel/expert.py) adds
it for conditional-compute heads over face/pose embeddings. The
computation, with the same routing, capacity and drop semantics on one
device or many:

  * top-1 routing produces a one-hot dispatch mask [T, E];
  * tokens are dispatched to per-expert slots with a capacity bound C,
    their position the token's rank among that expert's tokens (a float
    cumulative sum, as the JAX package computes it), giving a dense [E, C,
    F] batch;
  * each expert's two-layer FFN runs over its slots (two products batched
    over the experts), and the combine is the transposed dispatch
    product.

Tokens over capacity are DROPPED (their combine weight is zero). The
products are ``torch.einsum``, as the JAX package computes them outside
any Pallas kernel. Sharded (``moe_apply``): the
routing runs once on the input's device, each device of the axis holds
E/n experts and runs their FFN over its ``[E/n, C, F]`` slots, and the
combine is the sum of the devices' partial outputs on the input's device
(the JAX package's ``psum``). Under top-1 routing a token's output is one
slot's, so the partial sums add exact zeros; the routing and the dropped
rows are the same as on one device, and the values agree to within the
order in which a batched product over E/n experts (not E) may add.
"""

from __future__ import annotations

import math
import types
from typing import Dict, Tuple

import numpy as np
import torch

_KEYS = ("router", "w1", "w2")


def _he_normal(shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """He-normal as ``jax.nn.initializers.he_normal`` draws it: a normal
    truncated at two standard deviations, scaled to variance 2 / fan_in,
    fan_in the second-to-last axis times the leading ones."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def init_moe_params(seed: int, n_experts: int, d_model: int,
                    d_hidden: int) -> Dict[str, torch.Tensor]:
    """Router + E two-layer FFN experts, stacked on a leading expert axis,
    He-normal from a ``torch.Generator`` seeded with ``seed`` (not the JAX
    package's values)."""
    gen = torch.Generator().manual_seed(seed)
    return {"router": _he_normal((d_model, n_experts), gen),
            "w1": _he_normal((n_experts, d_model, d_hidden), gen),
            "w2": _he_normal((n_experts, d_hidden, d_model), gen)}


def _dispatch_mask(logits: torch.Tensor, capacity: int) -> torch.Tensor:
    """Top-1 routing -> combine [T, E, C] with a static per-expert
    capacity. Position within an expert's slot list is the token's rank
    among that expert's tokens (cumsum order); ranks >= C are dropped."""
    t, e = logits.shape
    expert = torch.argmax(logits, dim=-1)                       # [T]
    gate = torch.softmax(logits, dim=-1)[torch.arange(t), expert]
    onehot = torch.nn.functional.one_hot(expert, e).to(logits.dtype)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot          # rank
    keep = (pos < capacity) & (onehot > 0)
    # jax.nn.one_hot: a rank >= C (or below 0) gives a zero row
    slot = (pos.to(torch.int64)[..., None]
            == torch.arange(capacity, device=logits.device)).to(logits.dtype)
    return slot * keep.to(logits.dtype)[..., None] * gate[:, None, None]


def capacity_for(tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    """The default per-expert capacity: max(1, int(factor * T / E))."""
    return max(1, int(capacity_factor * tokens / n_experts))


def moe_reference(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  capacity_factor: float = 2.0,
                  capacity: int = 0) -> torch.Tensor:
    """Top-1 MoE FFN on one device: ``x`` [T, F] -> [T, F].

    ``capacity`` pins the per-expert slot count directly (callers wanting
    chunking-independent drop behavior derive it from a fixed reference
    batch instead of the per-chunk T)."""
    n_experts = int(params["w1"].shape[0])
    if capacity <= 0:
        capacity = capacity_for(int(x.shape[0]), n_experts, capacity_factor)
    logits = x @ params["router"]
    combine = _dispatch_mask(logits, capacity)                  # [T, E, C]
    dispatched = torch.einsum("tec,tf->ecf",
                              (combine > 0).to(x.dtype), x)     # [E, C, F]
    y = _expert_ffn(dispatched, params["w1"], params["w2"])
    return torch.einsum("tec,ecf->tf", combine, y)


def _expert_ffn(dispatched: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """Each expert's two-layer FFN over its [C, F] slots -> [E, C, F], as
    two products batched over the experts."""
    h = torch.relu(torch.einsum("ecf,efh->ech", dispatched, w1))
    return torch.einsum("ech,ehf->ecf", h, w2)


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              mesh, axis: str = "expert", capacity_factor: float = 2.0,
              capacity: int = 0) -> torch.Tensor:
    """Expert-parallel top-1 MoE FFN: ``x`` [T, F] -> [T, F] on ``x``'s
    device. Each device of ``mesh[axis]`` takes its contiguous E/n experts'
    weights and runs their FFN over its ``[E/n, C, F]`` slots; the router
    stays on ``x``'s device and the partial outputs are summed there.
    Identical routing, capacity and drop semantics to ``moe_reference``.
    One function stands for the JAX package's ``moe_apply`` (jitted) and
    ``moe_apply_traced`` (inside a jitted segment), and its ``_moe_body``:
    nothing here is traced."""
    E = int(params["w1"].shape[0])
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if E % n != 0:
        raise ValueError(f"n_experts={E} must divide mesh axis {n}")
    if capacity <= 0:
        capacity = capacity_for(int(x.shape[0]), E, capacity_factor)
    e_local = E // n
    combine = _dispatch_mask(x @ params["router"].to(x.device), capacity)
    out = None
    for d, dev in enumerate(devs):
        sl = slice(d * e_local, (d + 1) * e_local)
        mine = combine[:, sl].to(dev, non_blocking=True)       # [T, e, C]
        xd = x.to(dev, non_blocking=True)
        dispatched = torch.einsum("tec,tf->ecf", (mine > 0).to(xd.dtype),
                                  xd)                           # [e, C, F]
        y = _expert_ffn(dispatched,
                        params["w1"][sl].to(dev, non_blocking=True),
                        params["w2"][sl].to(dev, non_blocking=True))
        part = torch.einsum("tec,ecf->tf", mine, y).to(x.device,
                                                       non_blocking=True)
        out = part if out is None else out + part  # the psum
    return out


def _from_flax(tree, dims=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_moe_params`` tree (numpy or npz-loaded) ->
    the same tree of tensors; ``dims`` (E, F, H), where given, must match
    its shapes."""
    out = {k: torch.from_numpy(np.array(tree[k], np.float32)) for k in _KEYS}
    if dims is not None:
        e, f, h = dims
        want = {"router": (f, e), "w1": (e, f, h), "w2": (e, h, f)}
        got = {k: tuple(v.shape) for k, v in out.items()}
        if got != want:
            raise ValueError(f"MoE weights have shapes {got}, the op's "
                             f"n_experts, d_model, d_hidden want {want}")
    return out


# the experts as the ops' weight loader sees a model; its ``arch`` is (E,
# F, H)
MOE = types.SimpleNamespace(
    init_params=lambda seed, dims: init_moe_params(seed, *dims),
    from_flax=_from_flax,
    to_flax=lambda params: {k: params[k].detach().cpu().numpy()
                            for k in _KEYS})
