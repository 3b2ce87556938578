"""Retention enforcement service.

The port of ``opengemini_tpu/services/retention.py``: each tick drops
the shards whose whole range is past their retention policy's duration
(``Engine.drop_expired_shards``; closing a shard releases its
decoded-column cache entries) and runs the deferred purge of DROP
MEASUREMENT's marks.
"""

from __future__ import annotations

from opengemini_tpu_torch.services.base import Service


class RetentionService(Service):
    name = "retention"

    def __init__(self, engine, interval_s: float = 1800.0):
        super().__init__(interval_s)
        self.engine = engine

    def handle(self, now_ns: int | None = None) -> None:
        self.engine.drop_expired_shards(now_ns)
        # the deferred half of DROP MEASUREMENT (mark-delete semantics)
        self.engine.purge_dropped_measurements()
