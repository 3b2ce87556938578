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

The WORLD is this process's place in a mesh across processes (the
``[device] coordinator-address``, ``num-processes`` and ``process-id``
keys, server/app.py ``_init_distributed``): its rank, the number of
processes and the ``torch.distributed`` process group the merges run
their collectives on. The model is the reference's multi-controller
SPMD: every process serves the same data with the same writes, holds
only its own shards' rows on its own cards, and runs every mesh program
in the same order as the others, so that every rank issues the same
collectives in the same order. ``mesh_program()`` holds a process-wide
lock around one query's mesh programs while a world is set: two queries
of one process never interleave their collectives. Every rank applies
the same ``[device]`` section, so every rank bumps its epoch on a mesh
change.
"""

from __future__ import annotations

import contextlib
import threading

_mesh = None
_mesh_epoch = 0
_world = None
_mesh_lock = threading.RLock()


class World:
    """This process's place among the processes of one mesh: ``rank``
    of ``size``, the process ``group`` its collectives run on, the
    ``backend`` ("nccl" on the card, "gloo" on the CPU) and the
    ``device`` the collectives' buffers live on (the process's card
    under NCCL, the CPU under gloo)."""

    __slots__ = ("rank", "size", "group", "backend", "device")

    def __init__(self, rank: int, size: int, group, backend: str, device):
        self.rank = int(rank)
        self.size = int(size)
        self.group = group
        self.backend = backend
        self.device = device

    def __repr__(self) -> str:
        return (f"World(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


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


def set_world(world: World | None) -> None:
    global _world
    _world = world


def get_world() -> World | None:
    return _world


def mesh_program():
    """A context that holds the process-wide mesh lock while a world is
    set (re-entrant: a query's nested mesh programs take it again), and
    nothing without one."""
    if _world is None:
        return contextlib.nullcontext()
    return _mesh_lock
