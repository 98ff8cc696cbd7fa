"""Op registry — the TPU-native replacement for the reference's C++
``REGISTER_OP/REGISTER_KERNEL`` macros and ``register_python_op``.

Reference parity: scanner/api/op.h registration surface as used by e.g.
histogram_kernel_cpu.cpp:52-57 (batched), optical_flow_kernel_cpu.cpp:51-58
(stenciled), tracker.py:12 (bounded_state), montage_kernel_cpu.cpp:109-115
(unbounded_state), shot_detection.py:11 (batch=10**7 i.e. whole-stream).

TPU-native design: instead of registering kernel *classes* that the engine
instantiates per worker, an op is a pure function over a frame-chunk array
``[T, ...]``. Ops declare one of four kinds:

  device        ``fn(ctx, *chunks, **params) -> tensor(s)`` on the device;
                adjacent device ops run as one segment, in order.
  host          ``fn(ctx, *chunks, **params)`` over numpy on the host
                (decode-adjacent or inherently-host work).
  stateful      sequential carry across frames/chunks:
                ``fn(ctx, state, *chunks, **params) -> (state, outputs)``.
                The executor runs these per-stream in order (the analog of
                bounded/unbounded state forcing sequential scheduling).
  whole_stream  the executor accumulates every element of the stream and
                calls the op once (shot boundaries' batch=10**7 analog).

``stencil=(lo, hi)`` declares a temporal halo: the op receives frames
``[i+lo, i+hi]`` for each output row i, i.e. a chunk extended by ``hi-lo``
frames, and must emit exactly T rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable
    kind: str = "device"  # device | host | stateful | whole_stream
    stencil: Tuple[int, int] = (0, 0)
    outputs: Tuple[str, ...] = ("array_f32",)  # column type names
    init_state: Optional[Callable] = None  # stateful ops: ctx -> state
    variadic_outputs: bool = False
    # Device ops with model weights: ``aux(ctx, params) -> tree of
    # arrays``. The executor resolves the tree once per executor (cached by
    # op name + params) and moves its leaves to the device once. The op fn
    # then receives it as its second argument:
    # ``fn(ctx, aux, *chunks, **params)``.
    aux: Optional[Callable] = None
    # Host ops that want device values passed through unconverted (e.g. the
    # OpenPose decode launches a nested crop program against the
    # already-uploaded FrameChunk instead of pulling frames to the host).
    device_inputs: bool = False
    # Compact sink encoding (VERDICT r4 #5): the name of an op param that
    # selects a float16 output encoding tolerable for STORAGE (the serde
    # upcasts on load). When set, the executor steers the param to
    # "float16" for nodes whose output feeds only sinks — unless the user
    # passed the param explicitly or PerfParams(sink_dtype="float32").
    compact_sink: Optional[str] = None

    @property
    def n_outputs(self) -> int:
        return len(self.outputs)

    @property
    def halo(self) -> int:
        return self.stencil[1] - self.stencil[0]


_OPS: Dict[str, OpDef] = {}
_COMPOSITES: Dict[str, Callable] = {}


def register_op(
    name: str,
    *,
    kind: str = "device",
    stencil: Tuple[int, int] = (0, 0),
    outputs: Sequence[str] = ("array_f32",),
    init_state: Optional[Callable] = None,
    aux: Optional[Callable] = None,
    device_inputs: bool = False,
    compact_sink: Optional[str] = None,
):
    """Decorator registering an op implementation under ``name``.

    Mirrors REGISTER_OP(name).frame_input(...).output(...) plus
    REGISTER_KERNEL(...).batch() in one declaration.
    """

    assert kind in ("device", "host", "stateful", "whole_stream"), kind

    def deco(fn: Callable) -> Callable:
        _OPS[name] = OpDef(
            name=name,
            fn=fn,
            kind=kind,
            stencil=tuple(stencil),
            outputs=tuple(outputs),
            init_state=init_state,
            aux=aux,
            device_inputs=device_inputs,
            compact_sink=compact_sink,
        )
        return fn

    return deco


def register_composite(name: str):
    """Register a *composite* op: a graph-construction macro that expands
    ``sc.ops.<name>(...)`` into a small sub-graph of primitive ops (the
    TPU-native split of each reference NN kernel into a device-kind forward
    + a host decode stage; reference contract: every kernel lives inside the
    engine's placement/parallelism regime, caffe_kernel_cpu.cpp:10-13).

    ``build_fn(inputs: Dict[str, NodeOutput], params: dict, device) ->
    Node | NodeOutput`` constructs and returns the expansion's result node.
    """

    def deco(build_fn: Callable) -> Callable:
        _COMPOSITES[name] = build_fn
        return build_fn

    return deco


def get_composite(name: str) -> Optional[Callable]:
    return _COMPOSITES.get(name)


def register_python_op(
    name: Optional[str] = None,
    batch: int = 1,
    stencil: Optional[Sequence[int]] = None,
    bounded_state: Optional[int] = None,
    unbounded_state: bool = False,
    outputs: Sequence[str] = ("object",),
    device_sets=None,  # accepted for API parity, ignored (no per-op placement)
):
    """User-facing python-op registration (reference scannerpy.register_python_op,
    used in tests/test_all.py:50-61 DecodeCap and sql tests AddOne/AddAll).

    The wrapped function receives ``(ctx, *element_lists)`` — lists of host
    elements, one list per input column, length T — and returns a list (or
    tuple of lists) of T output elements. ``batch`` is accepted for parity;
    chunking is controlled by PerfParams in this framework. A huge ``batch``
    (>= 10**6, the reference idiom) marks the op whole-stream.
    """

    def deco(fn_or_cls):
        op_name = name or getattr(fn_or_cls, "__name__", None)
        kind = "host"
        init_state = None
        stc = (0, 0)
        if stencil is not None:
            stc = (min(stencil), max(stencil))
        if bounded_state is not None or unbounded_state:
            kind = "stateful"
        if batch >= 10**6:
            kind = "whole_stream"

        if isinstance(fn_or_cls, type):
            # Kernel-class style (reference scannerpy.Kernel lifecycle):
            # fetch_resources/setup_with_resources/execute/reset/close.
            cls = fn_or_cls

            def host_fn(ctx, *element_lists, **params):
                inst = ctx.kernel_instance(cls, params)
                return inst.execute(*element_lists)

            if kind == "stateful":
                def stateful_fn(ctx, state, *element_lists, **params):
                    inst = state or ctx.kernel_instance(cls, params, cached=False)
                    out = inst.execute(*element_lists)
                    return inst, out

                _OPS[op_name] = OpDef(
                    op_name, stateful_fn, kind="stateful", stencil=stc,
                    outputs=tuple(outputs), init_state=lambda ctx: None,
                )
            else:
                _OPS[op_name] = OpDef(
                    op_name, host_fn, kind=kind, stencil=stc, outputs=tuple(outputs)
                )
            return cls

        fn = fn_or_cls
        _OPS[op_name] = OpDef(
            op_name, fn, kind=kind, stencil=stc,
            outputs=tuple(outputs), init_state=init_state,
        )
        return fn

    return deco


def get_op(name: str) -> OpDef:
    if name not in _OPS:
        raise KeyError(
            f"unknown op {name!r}; registered: {sorted(_OPS)}"
        )
    return _OPS[name]


def has_op(name: str) -> bool:
    return name in _OPS or name in _COMPOSITES


def all_ops() -> Dict[str, OpDef]:
    return dict(_OPS)
