"""Parallel forms of the port's ops. One device only so far: the
single-device parts of expert parallelism (``expert.py``); the meshes and
their sharded forms wait for the multi-device port."""
