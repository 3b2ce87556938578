"""opengemini-tpu on PyTorch and CUDA: the port of ``opengemini_tpu``.

A second package beside the JAX reference, mirroring its module paths
one for one. It covers line protocol and columnar ingest through the
WAL into the memtable, flushes into TSF files and a mergeset series
index that either package reopens, InfluxQL aggregate queries through
the grid and bucket batches (a cold scan of device-profile files ships
the encoded blocks to the card and decodes them there), and the /ping,
/write and /query HTTP routes. Host code is copied from the reference
with its imports rewritten; device code is PyTorch, and the six kernels
the reference wrote in Pallas are CUDA C++ under ``csrc/``
(``ops/cuda_segment.py`` builds and binds them). The package imports
``torch`` and numpy, never ``jax`` and nothing of ``opengemini_tpu``.

Entry points (``storage.engine.Engine``, ``query.executor.Executor``,
``server.http.HttpService``) run on the CUDA card unless the caller
passes ``device="cpu"``; without CUDA the default raises.
"""

__version__ = "0.1.0"
