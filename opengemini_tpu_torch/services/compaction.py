"""Background compaction: a service that merges the immutable files of
every shard on a tick.

The port of ``opengemini_tpu/services/compaction.py``. Each tick drains
the leveled merges of every shard (``Shard.compact_level``), then the
merges of time-overlapping files (``compact_out_of_order``), and backs
both with a full merge once a shard holds more than 8 x fanout files.
Every merge swaps the shard's file set, which drops the retired files'
decoded-column cache entries (storage/shard.py), so a manual
``compact()`` and a tick are covered alike. Ticks are governed: they
pause under interactive load and IO alarms (services/base.py).
"""

from __future__ import annotations

import time

from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS


class CompactionService(Service):
    name = "compaction"
    governed = True

    def __init__(self, engine, interval_s: float = 600.0, max_files: int = 4):
        super().__init__(interval_s)
        self.engine = engine
        self.max_files = max_files

    def handle(self) -> int:
        n = 0
        fanout = max(2, self.max_files)
        t0 = time.perf_counter_ns()
        for shard in self.engine.all_shards():
            try:
                # leveled: every mergeable run this tick, each merge
                # O(run), not O(shard)
                while shard.compact_level(fanout=fanout):
                    n += 1
                    _STATS.incr("compaction", "leveled_merges")
                # late data leaves overlapping files that leveled runs
                # may never pick up
                while (shard.has_time_overlap()
                       and shard.compact_out_of_order(max_files=fanout)):
                    n += 1
                    _STATS.incr("compaction", "out_of_order_merges")
                # mixed levels can still let the count run away
                if shard.file_count() > 8 * fanout:
                    if shard.compact(max_files=fanout):
                        n += 1
                        _STATS.incr("compaction", "full_merges")
            except Exception:  # noqa: BLE001 — one shard never stops a tick
                logger.exception("compaction of %s failed", shard.path)
        if n:
            _STATS.incr("compaction", "tick_ns", time.perf_counter_ns() - t0)
        return n
