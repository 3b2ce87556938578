"""Slow-query capture: a bounded ring of the most recent queries that
crossed the OGT_SLOW_QUERY_MS threshold, each record carrying the
statement, the database (the governor's tenant), the per-stage timings,
the span tree (when tracing is armed) and the governor's ledger at
completion.

The port of ``opengemini_tpu/utils/slowlog.py``, whole, with a plain
``threading.Lock``. Served at /debug/slow and tuned through
/debug/ctrl?mod=obs (server/http.py); the executor and the PromQL
engine note every finished query.

Pass-through: with OGT_SLOW_QUERY_MS unset, note() is one attribute
check per query.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from opengemini_tpu_torch.utils import lockdep


def _env_float(name: str):
    v = os.environ.get(name, "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


class SlowLog:
    def __init__(self) -> None:
        self._lock = lockdep.Lock()
        self.threshold_ms = _env_float("OGT_SLOW_QUERY_MS")  # None = off
        try:
            self.max_records = max(
                1, int(os.environ.get("OGT_SLOW_LOG_MAX", "") or 64))
        except ValueError:
            self.max_records = 64
        self._ring: deque[dict] = deque(maxlen=self.max_records)
        self.captured = 0  # total ever captured (ring evicts oldest)

    def enabled(self) -> bool:
        return self.threshold_ms is not None

    def configure(self, slow_ms: float | None = ...,
                  slow_max: int | None = None) -> None:
        """Runtime tuning (/debug/ctrl?mod=obs).  slow_ms=None disables;
        the ... sentinel leaves the threshold untouched.  Shrinking
        slow_max drops the OLDEST records (deque maxlen semantics)."""
        with self._lock:
            if slow_ms is not ...:
                self.threshold_ms = slow_ms
            if slow_max is not None and slow_max >= 1:
                if slow_max != self.max_records:
                    self.max_records = slow_max
                    self._ring = deque(self._ring, maxlen=slow_max)

    def note(self, qid, text: str, db: str, duration_ms: float,
             trace=None, stages: dict | None = None,
             extra: dict | None = None) -> bool:
        """Record one finished query if it crossed the threshold.
        `trace` is the (finished) tracing.Trace or None; `stages` the
        querytracker per-stage ns map (colcache/rollup/admission_wait
        attribution rides along even with span trees off)."""
        thresh = self.threshold_ms
        if thresh is None or duration_ms < thresh:
            return False
        from opengemini_tpu_torch.utils.querytracker import redact

        rec = {
            "qid": qid,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
            "duration_ms": round(duration_ms, 3),
            "statement": redact(text),
            "database": db,
            "tenant": db,  # the governor's tenant identity is the db
            "stages_ms": {
                name: round(ns / 1e6, 3)
                for name, ns in (stages or {}).items()
            },
            "trace": trace.to_dict() if trace is not None else None,
        }
        try:
            # the ledger at completion: which component held the memory
            # while this query was slow (empty dict pass-through when
            # the governor is disabled)
            from opengemini_tpu_torch.utils.governor import GOVERNOR

            if GOVERNOR.enabled():
                rec["governor"] = GOVERNOR.describe()
        except Exception:  # noqa: BLE001 — observability must not raise
            pass
        if extra:
            rec.update(extra)
        with self._lock:
            self._ring.append(rec)
            self.captured += 1
        from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

        STATS.incr("slowlog", "captured")
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "threshold_ms": self.threshold_ms,
                "max_records": self.max_records,
                "captured": self.captured,
                "records": list(self._ring),
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


GLOBAL = SlowLog()
