"""opengemini-tpu on PyTorch and CUDA: the port of ``opengemini_tpu``.

A second package beside the JAX reference, mirroring its module paths
one for one. This slice covers line protocol and columnar ingest into
the memtable, InfluxQL aggregate queries through the grid and bucket
batches, and the /ping, /write and /query HTTP routes. Host code is
copied from the reference with its imports rewritten; device code is
PyTorch, and the three aggregation kernels the reference wrote in Pallas
are CUDA C++ under ``csrc/`` (``ops/cuda_segment.py`` builds and binds
them). The package imports ``torch`` and numpy, never ``jax`` and
nothing of ``opengemini_tpu``.

Entry points (``storage.engine.Engine``, ``query.executor.Executor``,
``server.http.HttpService``) run on the CUDA card unless the caller
passes ``device="cpu"``; without CUDA the default raises.
"""

__version__ = "0.1.0"
