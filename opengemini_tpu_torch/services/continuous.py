"""Continuous query scheduler.

The port of ``opengemini_tpu/services/continuous.py``. In a cluster
whose data is routed only the raft meta leader runs CQs (each node's CQ
reads the whole cluster, so every runner would write every result row
again); without routing every node runs its own. On each tick every CQ
whose next window has
closed runs its SELECT ... INTO over the newly closed GROUP BY time
windows through the executor (query/subquery.py's SELECT INTO, the grid
and its kernels on the engine's device). A CQ takes a background
admission slot from the resource governor and, governed, a query
tracker entry; a shed run keeps its ``last_run_ns`` so the window is
retried on the next tick. One failing CQ never starves the others.

The three continuous tiers: streams (services/stream.py) fold
accumulable aggregates at ingest and never re-read storage; CQs
(here) re-read storage for each closed window and run any InfluxQL;
rollups (storage/rollup.py) keep mergeable cells incrementally and
splice them into dashboard reads.
"""

from __future__ import annotations

import copy
import logging
import time as _time

from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.services.base import Service
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.sql.parser import parse_one
from opengemini_tpu_torch.utils.governor import GOVERNOR, AdmissionRejected
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER

logger = logging.getLogger("opengemini_tpu_torch.services.cq")


class ContinuousQueryService(Service):
    name = "continuousquery"
    # a CQ is a real query (scan + aggregate + write-back), not a
    # watchdog: pause it while interactive occupancy is high, like
    # compaction/downsample
    governed = True

    def __init__(self, engine, executor, interval_s: float = 10.0,
                 meta_store=None):
        super().__init__(interval_s)
        self.engine = engine
        self.executor = executor
        # the lease: with data routing, only the meta leader runs CQs
        self.meta_store = meta_store

    def handle(self, now_ns: int | None = None) -> int:
        if (self.meta_store is not None
                and getattr(self.executor, "router", None) is not None
                and not self.meta_store.is_leader()):
            return 0
        if now_ns is None:
            now_ns = _time.time_ns()
        ran = 0
        dirty = False
        for db_name, db in list(self.engine.databases.items()):
            for cq in list(db.continuous_queries.values()):
                try:
                    if self._run_cq(db_name, cq, now_ns):
                        ran += 1
                        dirty = True
                except Exception:  # noqa: BLE001 — one bad CQ never starves the rest
                    logger.exception("CQ %s.%s failed", db_name, cq.name)
        if dirty:
            self.engine.save_cq_state()
        return ran

    def _run_cq(self, db: str, cq, now_ns: int) -> bool:
        stmt = parse_one(cq.select_text)
        if not isinstance(stmt, ast.SelectStatement) or stmt.group_by_time is None:
            return False
        every = stmt.group_by_time.every_ns
        offset = stmt.group_by_time.offset_ns
        run_every = cq.resample_every_ns or every
        # windows that have fully closed since the last run; influx defaults
        # FOR to max(EVERY, interval) so EVERY > interval misses no windows
        end = int(winmod.window_start(now_ns, every, offset))
        lookback = cq.resample_for_ns or max(run_every, every)
        start = max(
            end - lookback,
            int(winmod.window_start(cq.last_run_ns, every, offset)) if cq.last_run_ns else end - lookback,
        )
        if end <= start or (cq.last_run_ns and now_ns - cq.last_run_ns < run_every):
            return False
        bounded = _with_time_bounds(stmt, start, end)
        # a CQ takes a (background-priority) admission slot and a
        # tracker qid like any client query: without these it would
        # bypass the governor's occupancy accounting AND the
        # reservation overdraft-kill (qid=None skips it), letting a
        # heavy CQ blow the memory ceiling while client traffic is
        # being shed.  AdmissionRejected skips the run; last_run_ns
        # stays put so the window is retried next tick.
        try:
            token = GOVERNOR.admit(kind="background")
        except AdmissionRejected:
            return False
        qid = None
        try:
            if GOVERNOR.enabled():
                # tracker registration only when governed: pass-through
                # must keep /debug/queries (and every other observable)
                # bit-identical to the pre-governor tree
                qid = TRACKER.register(cq.select_text, db)
            self.executor.execute_statement(bounded, db, now_ns)
        finally:
            if qid is not None:
                TRACKER.unregister(qid)
            token.release()
        cq.last_run_ns = now_ns
        return True


def _with_time_bounds(stmt: ast.SelectStatement, start_ns: int, end_ns: int):
    """AND the CQ's WHERE with [start, end) — the window injection the
    reference does when materializing CQ runs."""
    bound = ast.BinaryExpr(
        "AND",
        ast.BinaryExpr(">=", ast.VarRef("time"), ast.IntegerLiteral(start_ns)),
        ast.BinaryExpr("<", ast.VarRef("time"), ast.IntegerLiteral(end_ns)),
    )
    cond = bound if stmt.condition is None else ast.BinaryExpr("AND", stmt.condition, bound)
    out = copy.copy(stmt)
    out.condition = cond
    return out
