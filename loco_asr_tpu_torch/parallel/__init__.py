"""Training steps on one device or sharded over a (data, fsdp, tensor) mesh
of ranks: ``train.py``, with ``mesh.py``, ``collectives.py``,
``partition.py``, ``tensor_parallel.py``, ``launch.py`` and ``dryrun.py``."""
