"""Running-query registry: the per-query stage attribution.

The part of ``opengemini_tpu/utils/querytracker.py`` that the
decoded-column cache uses (storage/colcache.py attributes its lookup and
fill time to the running query): each executing query registers an id
bound to its thread, and ``add_stage_ns`` adds stage time to it while
it runs. ``snapshot`` lists the running queries with their stages in ms.

Not in this port yet (ROADMAP A4.2): SHOW QUERIES, KILL QUERY and the
cancellation points, the live span tree per query and the offload
routes.
"""

from __future__ import annotations

import re
import threading
import time

# password literals are redacted before query text is kept
_PASSWORD_RE = re.compile(
    r"(?i)(WITH\s+PASSWORD\s+|SET\s+PASSWORD\s+FOR\s+[^=]+=\s*)'(?:[^'\\]|\\.)*'"
)


def redact(text: str) -> str:
    return _PASSWORD_RE.sub(lambda m: m.group(1) + "'[REDACTED]'", text)


class QueryTracker:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 1
        self._running: dict[int, dict] = {}
        self._local = threading.local()

    def register(self, text: str, db: str) -> int:
        with self._lock:
            qid = self._next
            self._next += 1
            self._running[qid] = {"query": redact(text), "database": db,
                                  "started": time.monotonic()}
        self._local.qid = qid
        return qid

    def unregister(self, qid: int) -> None:
        with self._lock:
            self._running.pop(qid, None)
        self._local.qid = None

    def current_qid(self) -> int | None:
        """The query id bound to the calling thread (None off-query)."""
        return getattr(self._local, "qid", None)

    def bind(self, qid: int | None) -> None:
        """Adopt a query id on a helper thread."""
        self._local.qid = qid

    def add_stage_ns(self, qid: int | None, name: str, ns: int) -> None:
        """Attribute stage time to a running query; a no-op off-query or
        after the query unregistered."""
        if qid is None or ns <= 0:
            return
        with self._lock:
            info = self._running.get(qid)
            if info is not None:
                stages = info.setdefault("stages", {})
                stages[name] = stages.get(name, 0) + ns

    def snapshot(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            return [{
                "qid": qid, "query": info["query"],
                "database": info["database"],
                "duration_ms": int((now - info["started"]) * 1000),
                "stages": {name: ns // 1_000_000
                           for name, ns in info.get("stages", {}).items()},
            } for qid, info in sorted(self._running.items())]


# process-wide registry
GLOBAL = QueryTracker()
