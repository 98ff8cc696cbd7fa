"""Pipeline-parallel (pp) inference over a ``pipe`` mesh axis.

The reference has no pipeline parallelism — its scalable axis is frames
(SURVEY §2j). The JAX package (its parallel/pipeline_parallel.py) places
one *stage* of a uniform stage chain per chip and streams microbatches
through it on the GPipe schedule, as one ``lax.scan`` of M + S - 1 ticks
with a ``ppermute`` hand-off per tick.

Here the same schedule runs from the host: at tick t, stage s works on
microbatch t - s (when 0 <= t - s < M) on its own device with its own
stage's parameters, and hands its activation to stage s + 1 as a copy to
that device. Only the last stage records outputs, which are stacked on
the input's device. Launches are asynchronous, so on distinct devices the
stages of one tick overlap; on one device they run in turn. The bubble is
(S - 1)/(M + S - 1), the GPipe bound; correctness holds for any M >= 1.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from .mesh import Mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def stack_stage_params(per_stage: list) -> Any:
    """Stack S per-stage trees (dicts of tensors of identical shapes)
    along a new leading stage axis — the layout ``pipeline_apply`` splits
    one stage per device."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage], dim=0)


def _check_stages(stacked_params, n_stages: int, axis: str) -> None:
    for path, leaf in _leaves(stacked_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked_params leaf {path} has leading (stage) axis "
                f"{leaf.shape[0]} but mesh axis '{axis}' has {n_stages} "
                f"devices — splitting it k-per-device would apply only "
                f"every k-th stage; stack exactly S={n_stages} stages "
                "(stack_stage_params)")


def _gpipe(stage_fn, stage_params: List[Any], xs: torch.Tensor,
           devs: List[torch.device]) -> torch.Tensor:
    S, M = len(devs), int(xs.shape[0])
    outs: Dict[int, torch.Tensor] = {}
    buf: List = [None] * S
    for t in range(M + S - 1):
        nxt: List = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            cur = xs[m].to(devs[0], non_blocking=True) if s == 0 else buf[s]
            h = stage_fn(stage_params[s], cur)
            if s == S - 1:
                outs[m] = h.to(xs.device, non_blocking=True)
            else:  # the hand-off: a copy to the next stage's device
                nxt[s + 1] = h.to(devs[s + 1], non_blocking=True)
        buf = nxt
    return torch.stack([outs[m] for m in range(M)], dim=0)


def pipeline_apply_traced(stage_fn: Callable[[Any, torch.Tensor],
                                             torch.Tensor],
                          stacked_params: Any, x: torch.Tensor, mesh: Mesh,
                          axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through S chained stages, one stage per device.

    Args:
      stage_fn: ``(params_i, h) -> h`` — one stage's forward. Must preserve
        the hidden shape/dtype (uniform-width chain; project in/out inside
        the first/last stage).
      stacked_params: tree whose leaves have leading axis S =
        ``mesh.shape[axis]`` (see ``stack_stage_params``); stage s's slice
        goes to the axis's device s.
      x: ``[M, B, ...]`` — M microbatches.

    Returns ``[M, B, ...]`` outputs after all S stages, on ``x``'s device.
    The executor's form (the JAX package's composes into a jitted
    segment); ``pipeline_apply`` is the same schedule.
    """
    devs = mesh.axis_devices(axis)
    S = len(devs)
    _check_stages(stacked_params, S, axis)
    stage_params = [_tree_map(lambda p, s=s: p[s].to(devs[s],
                                                      non_blocking=True),
                              stacked_params) for s in range(S)]
    return _gpipe(stage_fn, stage_params, torch.as_tensor(x), devs)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh: Mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """``pipeline_apply_traced`` as a stand-alone call (the JAX package
    jits it; here both are the same host-driven schedule)."""
    return pipeline_apply_traced(stage_fn, stacked_params, x, mesh, axis)


def sequential_reference(stage_fn, stacked_params, x: torch.Tensor
                         ) -> torch.Tensor:
    """Unsharded golden: fold every stage over every microbatch."""
    S = next(_leaves(stacked_params))[1].shape[0]
    out = []
    for m in range(x.shape[0]):
        h = x[m]
        for i in range(S):
            h = stage_fn(_tree_map(lambda p, i=i: p[i], stacked_params), h)
        out.append(h)
    return torch.stack(out, dim=0)
