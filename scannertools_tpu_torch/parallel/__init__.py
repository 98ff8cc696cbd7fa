"""Parallel forms of the port's ops and its job layer: device meshes
(``mesh.py``), the frame-sharded data mesh and static multi-host slicing
(``sharded.py``), spatial, pipeline, tensor and expert parallelism
(``spatial.py``, ``pipeline_parallel.py``, ``model_sharding.py``,
``expert.py``), the multi-device dry run (``dryrun.py``), claims
(``workqueue.py``) and worker recycling (``recycling.py``). A mesh is a
named grid of torch devices held by one process; its collectives are
copies between devices."""
