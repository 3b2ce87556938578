"""Object-storage tiering service (reference: lib/fileops obs cold tier
behind the hierarchical mover): shard groups older than the threshold
are offloaded wholesale into the object store and hydrate back lazily
when a query touches their time range.

The port of ``opengemini_tpu/services/obstier.py``, whole, with its
imports rewritten.
"""

from __future__ import annotations

import time as _time

from opengemini_tpu_torch.services.base import Service, logger


class ObsTierService(Service):
    name = "obstier"

    def __init__(self, engine, age_ns: int, interval_s: float = 3600.0):
        super().__init__(interval_s)
        self.engine = engine
        self.age_ns = age_ns

    def handle(self, now_ns: int | None = None) -> int:
        if now_ns is None:
            now_ns = _time.time_ns()
        moved = 0
        with self.engine._lock:
            candidates = [
                key for key, sh in self.engine._shards.items()
                if sh.tmax <= now_ns - self.age_ns
            ]
        for db, rp, start in candidates:
            try:
                if self.engine.offload_shard(db, rp, start):
                    moved += 1
                    logger.info("offloaded %s/%s/%d to object store",
                                db, rp, start)
            except Exception:  # noqa: BLE001
                logger.exception("offload of %s/%s/%d failed", db, rp, start)
        return moved
