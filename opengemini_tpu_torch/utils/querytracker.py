"""Running-query registry with kill support.

The port of ``opengemini_tpu/utils/querytracker.py``, whole (reference:
the query task manager, lib/util/lifted/influx/query executor.go task
manager + app/ts-store/transport/query/manager.go:130 Kill): every
executing query is registered with an id; SHOW QUERIES lists them, KILL
QUERY marks one killed and execution aborts at the next cancellation
point (scan loops check between series, slices, subquery chunks and
device batch dispatches). A check runs on the host only: a kernel
already launched finishes, and the query stops before the next one.
The resource governor (utils/governor.py) sets the admission hook at
import; the HTTP service (server/http.py) points the durability hook at
its engine's ledger (storage/engine.py ``durability_snapshot``), and a
closed engine detaches it.
"""

from __future__ import annotations

import re
import threading
import time

from opengemini_tpu_torch.utils import lockdep

# redact password literals before storing query text (the reference
# renders [REDACTED] in SHOW QUERIES/logs for these statements)
_PASSWORD_RE = re.compile(
    r"(?i)(WITH\s+PASSWORD\s+|SET\s+PASSWORD\s+FOR\s+[^=]+=\s*)'(?:[^'\\]|\\.)*'"
)


def redact(text: str) -> str:
    return _PASSWORD_RE.sub(lambda m: m.group(1) + "'[REDACTED]'", text)


class QueryKilled(Exception):
    def __init__(self, qid: int):
        super().__init__(f"query {qid} killed")
        self.qid = qid


class QueryTracker:
    def __init__(self) -> None:
        self._lock = lockdep.Lock()
        self._next = 1
        self._running: dict[int, dict] = {}
        self._killed: set[int] = set()
        self._local = threading.local()
        # optional () -> dict hook (engine.durability_snapshot): the
        # monitoring view pairs in-flight queries with the live
        # acked-vs-durable ledger so an operator sees loss the moment a
        # query would observe it
        self._durability_provider = None
        # optional () -> dict hook (governor.admission_snapshot): pairs
        # the running queries with the admission queue/slot state
        self._admission_provider = None

    def register(self, text: str, db: str) -> int:
        with self._lock:
            qid = self._next
            self._next += 1
            self._running[qid] = {
                "query": redact(text), "database": db,
                "started": time.monotonic(),
            }
        self._local.qid = qid
        return qid

    def unregister(self, qid: int) -> None:
        with self._lock:
            self._running.pop(qid, None)
            self._killed.discard(qid)
        self._local.qid = None

    def kill(self, qid: int) -> bool:
        with self._lock:
            if qid not in self._running:
                return False
            self._killed.add(qid)
            return True

    def check(self) -> None:
        """Cancellation point: raises when the CURRENT thread's query was
        killed. Cheap (one set lookup), called between scan units."""
        self.raise_if_killed(self.current_qid())

    def current_qid(self) -> int | None:
        """The query id bound to the calling thread (None off-query)."""
        return getattr(self._local, "qid", None)

    def bind(self, qid: int | None) -> None:
        """Adopt a query id on a helper thread (scan-pool / prefetch
        workers) so check() fires there too. Helper threads bind fresh
        per task; the binding dies with the thread's next bind."""
        self._local.qid = qid

    def is_killed(self, qid: int | None) -> bool:
        return qid is not None and qid in self._killed

    def set_trace(self, qid: int | None, trace) -> None:
        """Bind a live span tree (utils/tracing.Trace) to a running
        query: /debug/queries renders it in place and /debug/trace?qid=
        serves it before the query finishes."""
        if qid is None:
            return
        with self._lock:
            info = self._running.get(qid)
            if info is not None:
                info["trace"] = trace

    def trace_of(self, qid: int | None):
        if qid is None:
            return None
        with self._lock:
            info = self._running.get(qid)
            return info.get("trace") if info else None

    def stages_of(self, qid: int | None) -> dict:
        """Copy of the per-stage ns attribution for one running query
        (the slow-log grabs it just before unregister)."""
        if qid is None:
            return {}
        with self._lock:
            info = self._running.get(qid)
            return dict(info.get("stages", ())) if info else {}

    def add_stage_ns(self, qid: int | None, name: str, ns: int) -> None:
        """Attribute stage time (e.g. the decoded-column cache's lookup /
        fill work, storage/colcache.py) to a running query so SHOW
        QUERIES-style snapshots expose where a long query spends its
        time.  No-op off-query or after the query unregistered; helper
        threads (scan pool) bind the owning qid per task."""
        if qid is None or ns <= 0:
            return
        with self._lock:
            info = self._running.get(qid)
            if info is not None:
                stages = info.setdefault("stages", {})
                stages[name] = stages.get(name, 0) + ns

    def note_route(self, qid: int | None, stage: str, route: str) -> None:
        """Record the offload planner's chosen route (host/device/mesh)
        for one stage of a running query — /debug/queries shows WHERE a
        query ran next to where it spent its time.  No-op off-query."""
        if qid is None:
            return
        with self._lock:
            info = self._running.get(qid)
            if info is not None:
                info.setdefault("routes", {})[stage] = route

    def raise_if_killed(self, qid: int | None) -> None:
        """check() for threads that carry the qid explicitly instead of
        thread-locally (scan-pool decode workers)."""
        if self.is_killed(qid):
            raise QueryKilled(qid)

    def snapshot(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            out = []
            for qid, info in sorted(self._running.items()):
                entry = {
                    "qid": qid,
                    "query": info["query"],
                    "database": info["database"],
                    "duration_ms": int((now - info["started"]) * 1000),
                    "status": "killed" if qid in self._killed else "running",
                    # per-stage attribution (colcache etc.), ms
                    "stages": {
                        name: ns // 1_000_000
                        for name, ns in info.get("stages", {}).items()
                    },
                }
                routes = info.get("routes")
                if routes:
                    # offload planner route per stage (query/offload.py)
                    entry["routes"] = dict(routes)
                trace = info.get("trace")
                if trace is not None:
                    # the stitched (so-far) span tree, rendered in place:
                    # /debug/queries is where an operator first looks
                    # when a cluster query is slow RIGHT NOW
                    entry["trace_id"] = trace.trace_id
                    entry["trace"] = trace.render()
                out.append(entry)
            return out

    def set_durability_provider(self, fn) -> None:
        """fn() -> engine.durability_snapshot()-shaped dict (None to
        detach — e.g. the owning engine closed)."""
        self._durability_provider = fn

    def detach_durability_provider(self, fn) -> None:
        """Detach ONLY if `fn` is still the attached provider — a closed
        engine must not yank a newer engine's hook (bound-method equality
        compares __self__ and __func__)."""
        if self._durability_provider == fn:
            self._durability_provider = None

    def set_admission_provider(self, fn) -> None:
        """fn() -> governor.admission_snapshot()-shaped dict (None to
        detach)."""
        self._admission_provider = fn

    def full_snapshot(self) -> dict:
        """Monitoring snapshot: running queries plus `durability` and
        `admission` sections from the registered providers (empty dicts
        when unattached or failing — monitoring must never raise)."""
        durability: dict = {}
        fn = self._durability_provider
        if fn is not None:
            try:
                durability = fn()
            except Exception:  # noqa: BLE001 — see docstring
                durability = {}
        admission: dict = {}
        fn = self._admission_provider
        if fn is not None:
            try:
                admission = fn()
            except Exception:  # noqa: BLE001 — see docstring
                admission = {}
        return {"queries": self.snapshot(), "durability": durability,
                "admission": admission}


# process-wide tracker (like the reference's per-node query manager)
GLOBAL = QueryTracker()
