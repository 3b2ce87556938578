"""Stream engine: window aggregation at ingest.

The port of ``opengemini_tpu/services/stream.py``, whole, with plain
``threading`` locks. Registered stream tasks fold arriving points into
open time windows as they are written (``Engine.add_write_observer``);
a window flushes to the target measurement once closed plus the task's
DELAY. A stream never re-scans storage: its state lives in memory,
keyed by (window, group tags), and is lost on restart; a point later
than DELAY is dropped, not re-folded. Aggregates: the accumulable ones,
count/sum/min/max/mean. Flush ticks are governed (services/base.py);
the ingest-side fold stays on the write path.
"""

from __future__ import annotations

import threading
import time as _time

from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.sql.parser import parse_one
from opengemini_tpu_torch.utils import lockdep

ACCUMULABLE = {"count", "sum", "min", "max", "mean"}


class _TaskState:
    def __init__(self, db: str, task, stmt: ast.SelectStatement):
        self.db = db
        self.task = task
        self.stmt = stmt
        self.source = stmt.sources[0].name
        self.every = stmt.group_by_time.every_ns
        self.offset = stmt.group_by_time.offset_ns
        self.group_tags = list(stmt.group_by_tags)
        # (out_name, agg, field)
        self.aggs = []
        for f in stmt.fields:
            e = f.expr
            while isinstance(e, ast.ParenExpr):
                e = e.expr
            if not isinstance(e, ast.Call) or e.name not in ACCUMULABLE:
                raise ValueError(
                    f"stream supports only {sorted(ACCUMULABLE)} aggregates"
                )
            arg = e.args[0] if e.args else None
            if not isinstance(arg, ast.VarRef):
                raise ValueError("stream aggregate needs a field argument")
            self.aggs.append((f.alias or e.name, e.name, arg.name))
        # (window_start, tag tuple) -> {out_name: accum}
        self.windows: dict[tuple, dict] = {}
        # windows ending at/before this were already flushed; late points
        # beyond DELAY are dropped, never re-aggregated (a partial re-open
        # would overwrite the complete aggregate in the target)
        self.watermark_ns = -(2**62)


def validate_stream_select(stmt: ast.SelectStatement) -> None:
    """CREATE STREAM validation: accumulable aggs, single measurement
    source, target != source (a self-feeding stream would loop)."""
    if len(stmt.sources) != 1 or not isinstance(stmt.sources[0], ast.Measurement):
        raise ValueError("stream requires exactly one measurement source")
    src = stmt.sources[0]
    if not src.name:
        raise ValueError("stream source must be a named measurement")
    if src.database or src.rp:
        raise ValueError("stream source must be an unqualified measurement "
                         "in the stream's own database")
    if stmt.condition is not None:
        raise ValueError("stream WHERE conditions are not supported yet")
    if stmt.into.name == src.name:
        raise ValueError("stream target must differ from its source")
    # reuse the task-state constructor for aggregate validation
    _TaskState("", _ValidateTask(), stmt)


class _ValidateTask:
    name = "validate"
    delay_ns = 0
    select_text = ""


class StreamService(Service):
    name = "stream"
    # low-priority: window-flush ticks acquire a governor background
    # token and pause under interactive load / IO alarms
    # (utils/governor.py); ingest-side fold stays on the write path
    governed = True

    def __init__(self, engine, interval_s: float = 5.0):
        super().__init__(interval_s)
        self.engine = engine
        self._lock = lockdep.Lock()
        self._flushing = threading.local()
        self._states: dict[tuple[str, str], _TaskState] = {}
        engine.add_write_observer(self.on_write)

    # -- ingest hook -----------------------------------------------------

    def on_write(self, db: str, rp: str | None, points: list) -> None:
        d = self.engine.databases.get(db)
        if d is None or not d.streams:
            return
        with self.engine._lock:  # consistent snapshot vs CREATE/DROP STREAM
            tasks = list(d.streams.values())
        skip = getattr(self._flushing, "tasks", ())
        with self._lock:
            for task in tasks:
                if (db, task.name) in skip:
                    continue  # this stream's own flush output
                st = self._state(db, task)
                if st is None:
                    continue
                for mst, tags, t, fields in points:
                    if mst != st.source:
                        continue
                    wstart = int(winmod.window_start(t, st.every, st.offset))
                    if wstart + st.every <= st.watermark_ns:
                        continue  # late beyond DELAY: drop (reference behavior)
                    tagd = dict(tags)
                    key_tags = tuple(tagd.get(k, "") for k in st.group_tags)
                    acc = st.windows.setdefault((wstart, key_tags), {})
                    for out_name, agg, field in st.aggs:
                        entry = fields.get(field)
                        if entry is None:
                            continue
                        ftype, val = entry
                        if ftype == FieldType.STRING:
                            continue
                        _accumulate(acc, out_name, agg, float(val))

    def _state(self, db: str, task) -> _TaskState | None:
        key = (db, task.name)
        st = self._states.get(key)
        if st is None or st.task is not task:
            try:
                stmt = parse_one(task.select_text)
                st = _TaskState(db, task, stmt)
                self._states[key] = st
            except Exception:  # noqa: BLE001
                logger.exception("stream %s.%s has a bad select", db, task.name)
                return None
        return st

    # -- flush -----------------------------------------------------------

    def handle(self, now_ns: int | None = None) -> int:
        if now_ns is None:
            now_ns = _time.time_ns()
        flushed = 0
        with self._lock:
            states = list(self._states.values())
        for st in states:
            flushed += self._flush_state(st, now_ns)
        # drop states for dropped streams
        with self._lock:
            for key in list(self._states):
                db, name = key
                d = self.engine.databases.get(db)
                if d is None or name not in d.streams:
                    del self._states[key]
        return flushed

    def _flush_state(self, st: _TaskState, now_ns: int) -> int:
        cutoff = now_ns - st.task.delay_ns
        points = []
        with self._lock:
            st.watermark_ns = max(st.watermark_ns, cutoff)
            done = [
                k for k in st.windows if k[0] + st.every <= cutoff
            ]
            for k in done:
                wstart, key_tags = k
                acc = st.windows.pop(k)
                fields = {}
                for out_name, agg, _field in st.aggs:
                    v = _finalize(acc, out_name, agg)
                    if v is None:
                        continue
                    if agg == "count":
                        fields[out_name] = (FieldType.INT, int(v))
                    else:
                        fields[out_name] = (FieldType.FLOAT, float(v))
                if fields:
                    tags = tuple(
                        (tk, tv) for tk, tv in zip(st.group_tags, key_tags) if tv
                    )
                    points.append((st.stmt.into.name, tags, wstart, fields))
        if not points:
            return 0
        tgt_db = st.stmt.into.database or st.db
        # mark this task while writing so its own flush output can never
        # feed back into it (even via a db-qualified target)
        self._flushing.tasks = getattr(self._flushing, "tasks", set())
        self._flushing.tasks.add((st.db, st.task.name))
        try:
            self.engine.write_rows(tgt_db, points, rp=st.stmt.into.rp or None)
        finally:
            self._flushing.tasks.discard((st.db, st.task.name))
        return len(points)


def _accumulate(acc: dict, out_name: str, agg: str, val: float) -> None:
    cur = acc.get(out_name)
    if agg == "count":
        acc[out_name] = (cur or 0) + 1
    elif agg == "sum":
        acc[out_name] = (cur or 0.0) + val
    elif agg == "min":
        acc[out_name] = val if cur is None else min(cur, val)
    elif agg == "max":
        acc[out_name] = val if cur is None else max(cur, val)
    elif agg == "mean":
        s, c = cur or (0.0, 0)
        acc[out_name] = (s + val, c + 1)


def _finalize(acc: dict, out_name: str, agg: str):
    cur = acc.get(out_name)
    if cur is None:
        return None
    if agg == "mean":
        s, c = cur
        return s / c if c else None
    return cur
