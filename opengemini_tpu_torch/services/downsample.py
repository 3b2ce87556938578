"""Downsample service.

The port of ``opengemini_tpu/services/downsample.py``: each tick
rewrites the shards past a downsample policy's age at its coarser
resolution (``Engine.run_downsample``; storage/downsample.py runs float
fields as one device batch each on the engine's device). Ticks are
governed: they pause under interactive load and IO alarms.
"""

from __future__ import annotations

from opengemini_tpu_torch.services.base import Service


class DownsampleService(Service):
    name = "downsample"
    governed = True

    def __init__(self, engine, interval_s: float = 3600.0):
        super().__init__(interval_s)
        self.engine = engine

    def handle(self, now_ns: int | None = None) -> int:
        return self.engine.run_downsample(now_ns)
