"""Pipeline graph IR.

Reference parity: the scannerpy op graph — ``sc.io.Input`` → ``sc.ops.X(...)``
→ ``sc.io.Output`` with ``sc.streams.Gather/Range/Stride`` sampling
(reference scannertools/tests/test_all.py:38-47,150-177). In the reference
this graph is serialized to protos and shipped over gRPC to the Scanner
master; here it is a small host-side IR that the executor lowers to jitted
JAX programs per frame-chunk (see runtime/executor.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union


class NodeOutput:
    """A (node, column-index) edge endpoint. ``sc.ops.X(...)`` returns one of
    these per output column (or the node itself when single-output, which is
    implicitly column 0)."""

    def __init__(self, node: "Node", index: int):
        self.node = node
        self.index = index

    def __repr__(self):
        return f"{self.node!r}[{self.index}]"


class Node:
    _counter = [0]

    def __init__(self, kind: str, name: str):
        self.kind = kind  # 'input' | 'sample' | 'op' | 'output'
        self.name = name
        self.id = Node._counter[0]
        Node._counter[0] += 1
        self.inputs: Dict[str, NodeOutput] = {}
        self.params: Dict[str, Any] = {}

    def __getitem__(self, i: int) -> NodeOutput:
        # bounded for op nodes so `a, b = sc.ops.TwoOutputOp(...)` unpacks
        if self.kind == "op":
            from .registry import get_op

            if i >= get_op(self.name).n_outputs:
                raise IndexError(i)
        return NodeOutput(self, i)

    def out(self, i: int = 0) -> NodeOutput:
        return NodeOutput(self, i)

    def __repr__(self):
        return f"<{self.kind}:{self.name}#{self.id}>"


class InputNode(Node):
    def __init__(self, streams: Sequence[Any]):
        super().__init__("input", "Input")
        self.streams = list(streams)  # one StoredStream per job


class SampleNode(Node):
    """Row-selection on a stream: Gather/Range/Stride.

    Reference: sc.streams.* (tests/test_all.py:41,167,183). ``per_job`` holds
    one sampling spec per job (the reference passes a list of per-stream args).
    """

    def __init__(self, src: NodeOutput, mode: str, per_job: List[Any]):
        super().__init__("sample", f"Sample/{mode}")
        self.inputs["input"] = src
        self.mode = mode
        self.per_job = per_job

    def indices(self, job: int, n_rows: int) -> List[int]:
        spec = self.per_job[job] if job < len(self.per_job) else self.per_job[-1]
        if self.mode == "gather":
            return [i for i in spec if 0 <= i < n_rows]
        if self.mode == "range":
            start, end = spec
            return list(range(max(0, start), min(end, n_rows)))
        if self.mode == "stride":
            return list(range(0, n_rows, spec))
        if self.mode == "strided_range":
            start, end, stride = spec
            return list(range(max(0, start), min(end, n_rows), stride))
        raise ValueError(self.mode)


class OpNode(Node):
    def __init__(self, op_name: str, inputs: Dict[str, NodeOutput],
                 params: Dict[str, Any], device: Optional[str] = None):
        super().__init__("op", op_name)
        self.inputs = inputs
        self.params = params
        # None = default accelerator; "cpu" = force the JAX CPU backend
        # (reference per-op device=DeviceType.CPU; tests/test_all.py:141-147)
        self.device = device


class OutputNode(Node):
    def __init__(self, cols: Sequence[NodeOutput], streams: Sequence[Any],
                 col_names: Optional[Sequence[str]] = None):
        super().__init__("output", "Output")
        self.columns = list(cols)
        for i, c in enumerate(self.columns):
            self.inputs[f"col{i}"] = c
        self.streams = list(streams)  # one sink stream per job (per job x col)
        self.col_names = list(col_names) if col_names else None


def as_output(x: Union[Node, NodeOutput]) -> NodeOutput:
    if isinstance(x, NodeOutput):
        return x
    if isinstance(x, Node):
        return NodeOutput(x, 0)
    raise TypeError(f"expected Node/NodeOutput, got {type(x)}")


def toposort(output: OutputNode) -> List[Node]:
    """Topological order of all nodes reachable from ``output``."""
    order: List[Node] = []
    seen = set()

    def visit(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        for e in n.inputs.values():
            visit(e.node)
        order.append(n)

    visit(output)
    return order


def find_source(node: Node) -> InputNode:
    """The unique InputNode feeding ``node`` (multi-source graphs run each
    source-aligned branch; v1 supports a single source per graph)."""
    sources = [n for n in toposort_any(node) if isinstance(n, InputNode)]
    if len(sources) != 1:
        raise ValueError(f"expected exactly 1 Input upstream, found {len(sources)}")
    return sources[0]


def toposort_any(node: Node) -> List[Node]:
    order: List[Node] = []
    seen = set()

    def visit(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        for e in n.inputs.values():
            visit(e.node)
        order.append(n)

    visit(node)
    return order
