"""Process-wide device-mesh configuration.

The port of ``opengemini_tpu/parallel/runtime.py``. When a mesh is set
(the ``[device]`` section of the ts-server config, server/app.py, or a
test), the executor's aggregate batches go multi-shard: the dense
layouts (models/grid.py, models/ragged.py) split their independent row
axes over the mesh's shards and launch their kernels once per shard, the
tiled PromQL kernels (ops/prom.py ShardedTiled) split their series axis
the same way, and AggBatch's general path computes per-shard partials
and merges them (parallel/distributed.py ``build_batch_agg``). With no
mesh, everything runs on the engine's one device exactly as before.

Every mesh assignment bumps a process-wide EPOCH. Long-lived caches of
sharded tensors (a frozen batch's sharded grid, the colcache device
tier) key on ``mesh_epoch()``, so a hot config reload that swaps the
mesh mid-process never serves shards laid out for a dead mesh: they
reshard or rebuild on their next use.
"""

from __future__ import annotations

_mesh = None
_mesh_epoch = 0


def set_mesh(mesh) -> None:
    global _mesh, _mesh_epoch
    if mesh is not _mesh:
        _mesh_epoch += 1
    _mesh = mesh


def get_mesh():
    return _mesh


def mesh_epoch() -> int:
    """Identity token of the CURRENT mesh assignment. Caches holding
    sharded tensors store it and treat a mismatch as stale."""
    return _mesh_epoch
