"""Execution-context flags shared between the executor and op kernels.

The JAX package's ``utils/flags.py``: the executor sets both while it runs
a device segment shard by shard over its data mesh (runtime/executor.py),
and ops read them to pick their sharded form (ops/histogram.py runs
``hist_rgb`` on each shard's own device). An op declared ``inner_split``
runs whole with ``current_mesh`` and ``shard_states`` set, and splits its
net's batch over the mesh itself (ops/faces.py)."""

import contextvars

# True while the executor runs a device segment over a multi-device data
# mesh, each shard's rows on its own device.
sharded_mode = contextvars.ContextVar("sharded_mode", default=False)

# The active data mesh during sharded execution (parallel/mesh.Mesh, axis
# "data" over the frame axis), set alongside sharded_mode.
current_mesh = contextvars.ContextVar("current_mesh", default=None)

# The op's weights (its aux tree) on each device of current_mesh, in mesh
# order, set while an ``inner_split`` op runs whole over a data mesh.
shard_states = contextvars.ContextVar("shard_states", default=None)
