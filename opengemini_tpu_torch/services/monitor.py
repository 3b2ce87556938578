"""Self-monitoring service: statistics pushed into the `_internal`
database plus ogt_*-named self-writes into `_monitor`.

The port of ``opengemini_tpu/services/monitor.py``, whole (reference:
lib/statisticsPusher pushing to file/http/_internal, and the ts-monitor
agent that makes the store queryable about itself).

Each tick:
  * `_internal`: one point per registry module with every counter as an
    INT field (the original expvar-shaped push).
  * `_monitor`: the /metrics view written back as line-protocol rows —
    measurement `ogt` carrying every scalar gauge under its exported
    `ogt_<module>_<key>` name, and one measurement per histogram family
    (`ogt_<name>`) with p50/p99/count/sum fields, labels as tags.
    Dashboards query the DB about itself with the same names a real
    Prometheus scrapes from GET /metrics.
"""

from __future__ import annotations

import time as _time

from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.services.base import Service
from opengemini_tpu_torch.utils.stats import (GLOBAL as STATS, _RENAMES,
                                              _san, histograms_snapshot,
                                              snapshot_percentile)

INTERNAL_DB = "_internal"
MONITOR_DB = "_monitor"


class MonitorService(Service):
    name = "monitor"

    def __init__(self, engine, interval_s: float = 10.0, hostname: str = "localhost"):
        super().__init__(interval_s)
        self.engine = engine
        self.hostname = hostname

    def handle(self) -> None:
        snap = STATS.snapshot()
        if not snap:
            return
        now = _time.time_ns()
        self._push_internal(snap, now)
        self._push_monitor(snap, now)

    def _push_internal(self, snap: dict, now: int) -> None:
        if INTERNAL_DB not in self.engine.databases:
            self.engine.create_database(INTERNAL_DB)
        points = []
        for module, vals in snap.items():
            fields = {k: (FieldType.INT, int(v)) for k, v in vals.items()}
            if fields:
                points.append(
                    (module, (("hostname", self.hostname),), now, fields)
                )
        if points:
            self.engine.write_rows(INTERNAL_DB, points)

    def _push_monitor(self, snap: dict, now: int) -> None:
        if MONITOR_DB not in self.engine.databases:
            self.engine.create_database(MONITOR_DB)
        host_tag = (("hostname", self.hostname),)
        gauges = {}
        for module, vals in snap.items():
            for key, v in vals.items():
                if not isinstance(v, (int, float)):
                    continue
                renamed = _RENAMES.get((module, key))
                name = renamed[0] if renamed else _san(
                    f"ogt_{module}_{key}")
                gauges[name] = (FieldType.INT, int(v))
        points = []
        if gauges:
            points.append(("ogt", host_tag, now, gauges))
        for name, labels, hsnap in histograms_snapshot():
            if not hsnap["count"]:
                continue
            tags = host_tag + tuple(
                (str(k), str(v)) for k, v in labels)
            # p50/p99 in the family's own unit (seconds for latency
            # families, raw bytes for the devobs transfer sizes); the
            # sum field is named by unit so dashboards can't misread a
            # byte total as seconds
            seconds = hsnap.get("unit", "seconds") == "seconds"
            fields = {
                "p50": (FieldType.FLOAT, snapshot_percentile(hsnap, 50)),
                "p99": (FieldType.FLOAT, snapshot_percentile(hsnap, 99)),
                "count": (FieldType.INT, hsnap["count"]),
            }
            if seconds:
                fields["sum_seconds"] = (FieldType.FLOAT,
                                         hsnap["sum_ns"] / 1e9)
            else:
                fields["sum_bytes"] = (FieldType.INT, hsnap["sum_ns"])
            points.append((_san(f"ogt_{name}"), tags, now, fields))
        if points:
            self.engine.write_rows(MONITOR_DB, points)
