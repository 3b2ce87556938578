"""Hierarchical query tracing: the spans behind EXPLAIN ANALYZE and the
``query_stages`` counters of /debug/vars.

The port of ``opengemini_tpu/utils/tracing.py`` for one node. A Trace is
a tree of Spans, each carrying (span_id, parent_id, start wall-ns,
elapsed perf-ns) and its fields; ``Trace.render`` gives
the indented lines EXPLAIN ANALYZE answers with. Every span that
finishes — in a Trace, or under the NoopTrace that queries run with
otherwise — adds its time to the statistics registry through
``record_stage`` (``query_stages/<name>_ns`` and ``<name>_count``, and
a ``query_stage_seconds`` histogram per stage), so /debug/vars shows
where every query's time went, not only an analyzed one's.

Cost: with OGT_TRACE unset or 0 queries run under NoopTrace — no Span
objects, no ids, one perf_counter_ns pair per stage. OGT_TRACE=1 arms a
per-query tree (``trace_enabled``), kept in a bounded ring of finished
traces (``note_finished``, ``recent_traces``, ``get_trace``).

Not in this port yet: the cross-node half (``start_remote``,
``start_remote_activated``, ``ship_subtree``, ``Trace.ctx`` and
``Trace.graft``, and a span's node), which stitches a replica's subtree
into the coordinator's tree; the port runs on one node.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager

from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS
from opengemini_tpu_torch.utils.stats import observe_ns as _observe_ns

# per-query span-tree capture (OGT_TRACE=1), read through trace_enabled()
_TRACE_ON = os.environ.get("OGT_TRACE", "") in ("1", "true")

# finished traces kept for lookup by query id (bounded; newest wins)
_RECENT_MAX = 256
_RECENT: dict[object, dict] = {}
_RECENT_LOCK = threading.Lock()

_ACTIVE = threading.local()


def trace_enabled() -> bool:
    return _TRACE_ON


def set_trace_enabled(on: bool) -> None:
    global _TRACE_ON
    _TRACE_ON = bool(on)


def _new_id() -> str:
    return f"{random.getrandbits(64):016x}"


class Span:
    __slots__ = ("name", "span_id", "parent_id", "fields", "children",
                 "start_ns", "elapsed_ns", "_t0")

    def __init__(self, name: str, span_id: str, parent_id: str):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.fields: list[tuple[str, object]] = []
        self.children: list[Span] = []
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        self.elapsed_ns = 0

    def add_field(self, key: str, value) -> None:
        self.fields.append((key, value))

    def finish(self) -> None:
        self.elapsed_ns = time.perf_counter_ns() - self._t0

    def to_dict(self) -> dict:
        return {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns, "elapsed_ns": self.elapsed_ns,
            "fields": [[k, v] for k, v in self.fields],
            "children": [c.to_dict() for c in self.children],
        }


class Trace:
    def __init__(self, name: str):
        self.trace_id = _new_id()
        self.root = Span(name, _new_id(), "")
        self._stack = [self.root]

    @contextmanager
    def span(self, name: str):
        s = Span(name, _new_id(), self._stack[-1].span_id)
        self._stack[-1].children.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.finish()
            self._stack.pop()
            record_stage(name, s.elapsed_ns)

    def add_field(self, key: str, value) -> None:
        self._stack[-1].add_field(key, value)

    def finish(self) -> None:
        self.root.finish()

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "root": self.root.to_dict()}

    def render(self) -> list[str]:
        """Indented tree lines (the EXPLAIN ANALYZE payload)."""
        lines: list[str] = []

        def walk(span: Span, depth: int):
            pad = "    " * depth
            lines.append(f"{pad}{span.name}: {_fmt_ns(span.elapsed_ns)}")
            for k, v in span.fields:
                lines.append(f"{pad}    {k}: {v}")
            for c in span.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return lines


# -- thread-local activation -------------------------------------------------
# The executor binds its per-query Trace here so callees reach it
# without a trace parameter in every signature. Worker threads (scan
# pool) never inherit the binding.


@contextmanager
def activate(trace):
    prev = getattr(_ACTIVE, "trace", None)
    _ACTIVE.trace = trace
    try:
        yield trace
    finally:
        _ACTIVE.trace = prev


def current():
    """The calling thread's active Trace, or NOOP."""
    t = getattr(_ACTIVE, "trace", None)
    return t if t is not None else NOOP


# -- finished-trace ring -------------------------------------------------------


def note_finished(qid, trace: Trace, meta: dict | None = None) -> None:
    """Keep a finished trace for lookup (bounded ring, oldest evicted).
    `qid` may be None; the entry is then addressable by trace_id only."""
    doc = {"qid": qid, "trace_id": trace.trace_id,
           "name": trace.root.name,
           "elapsed_ms": round(trace.root.elapsed_ns / 1e6, 3),
           "trace": trace.to_dict()}
    if meta:
        doc.update(meta)
    key = qid if qid is not None else trace.trace_id
    with _RECENT_LOCK:
        _RECENT.pop(key, None)
        _RECENT[key] = doc
        while len(_RECENT) > _RECENT_MAX:
            _RECENT.pop(next(iter(_RECENT)))


def recent_traces() -> list[dict]:
    """Newest-first summaries (no tree) of the kept traces."""
    with _RECENT_LOCK:
        docs = list(_RECENT.values())
    return [{k: v for k, v in d.items() if k != "trace"}
            for d in reversed(docs)]


def get_trace(qid=None, trace_id: str | None = None) -> dict | None:
    with _RECENT_LOCK:
        if qid is not None:
            return _RECENT.get(qid)
        if trace_id is not None:
            for d in _RECENT.values():
                if d["trace_id"] == trace_id:
                    return d
    return None


def clear_recent() -> None:
    """Forget the kept traces (/debug/ctrl?mod=obs&clear=1)."""
    with _RECENT_LOCK:
        _RECENT.clear()


# -- cumulative stage statistics ---------------------------------------------


def record_stage(name: str, elapsed_ns: int) -> None:
    """Add one stage's time to the registry (``query_stages``) and, for
    the fixed stage names (no space; "select: <mst>" is dynamic), to its
    latency histogram."""
    _STATS.incr("query_stages", f"{name}_ns", elapsed_ns)
    _STATS.incr("query_stages", f"{name}_count")
    if " " not in name:
        _observe_ns("query_stage_seconds", elapsed_ns, stage=name)


class NoopTrace:
    """The stand-in when no tree is kept: the executor calls trace
    methods unconditionally, and stage times still reach the registry
    (one perf_counter_ns pair per stage)."""

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield _NOOP_SPAN
        finally:
            record_stage(name, time.perf_counter_ns() - t0)

    def add_field(self, key: str, value) -> None:
        pass

    def finish(self) -> None:
        pass


class _NoopSpan:
    def add_field(self, key: str, value) -> None:
        pass


_NOOP_SPAN = _NoopSpan()
NOOP = NoopTrace()


def _fmt_ns(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.3f}s"
    if ns >= 1_000_000:
        return f"{ns / 1e6:.3f}ms"
    if ns >= 1_000:
        return f"{ns / 1e3:.1f}µs"
    return f"{ns}ns"
