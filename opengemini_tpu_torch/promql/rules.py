"""Continuous PromQL rule engine: recording + alerting rules as
incremental tile maintenance.

The port of ``opengemini_tpu/promql/rules.py``, whole, its locks
``utils/lockdep``'s as the reference's. The fold and merge stay host
numpy float64, as the reference keeps them; the matcher probes
(promql/engine.py ``_match_sids``) and the fallback leg
(``PromEngine.query_instant``) run on the engine's device. In a
data-routed cluster only the meta leader's service ticks
(services/rules.py).

Reference: the Prometheus rule manager (rules/manager.go — groups on an
interval, recording rules written back as series, alert rules with
``for``-duration pending→firing state machines), rebuilt on the tiled
range-vector engine's ms lattice (ops/prom.py, TiLT arXiv:2301.12030):
instead of re-scanning every rule's full window each tick, the group
keeps PER-TILE partial records per matched series and the ingest path
marks tiles dirty (storage/engine.py calls ``note_write_*`` PRE-apply,
the write-ahead-mark contract of storage/rollup.py), so a tick refolds
only dirtied/new tiles and answers every rule window from a merged tile
prefix — O(new tiles), not O(window × rules).  Taurus (arXiv:2506.20010)
makes the same mergeable-cell argument for maintenance near the data.

Division of labor across the three continuous tiers (see also
services/stream.py and services/continuous.py):

  * StreamService — ingest-time fold of InfluxQL accumulable aggregates
    into in-memory window cells; never re-reads storage.
  * ContinuousQueryService — scheduled SELECT ... INTO re-reading
    storage for closed windows; arbitrary InfluxQL, no incrementality.
  * RuleManager (this module) — PromQL rule fleets over *incrementally
    maintained* tile state, with a full-rescan fallback for expressions
    the tile algebra cannot express.

Correctness contract: every tick's incremental answer is BITWISE
identical to a from-scratch evaluation (fold every window tile off one
full scan, merge identically) — ``OGT_RULES_VERIFY=1`` asserts it on
every tick (bench/loadgen/tests run with it on).  That contract pins the
fold/merge arithmetic to host numpy float64 in a canonical series order;
the matcher probes still ride the columnar label tier (index/labels.py)
and the full-rescan fallback leg evaluates through the ordinary
planner-routed engine kernels (query/offload.py decides host/device/
mesh), with fold timings fed to the planner's observations.

Durability (the rules-state dir ``<root>/rules/<db>/<group>.json``):
group config, the last-evaluated watermark, pending/firing alert state
and per-rule fire/resolve counts persist with the rollup state-save
pattern (tmp + fsync + rename, version-skippable snapshots).  A tick
CLAIMS its eval time durably *before* evaluating (failpoint
``rules-mark-before-eval`` sits on that edge); alert transitions and the
watermark land in one final fsync — so a crash anywhere mid-tick either
re-evaluates the tick from scratch (fires counted once, recording
write-back is last-write-wins idempotent) or has already recorded the
transition: never a double-fire, never a silently un-fired alert.

``OGT_RULES=0`` disables the subsystem: no manager is constructed, the
engine's ``rules_hook`` stays None and every write/query path is
bit-identical to the pre-rules tree (one ``is None`` check).
"""

from __future__ import annotations

import json
import math
import os
import time as _time
from contextlib import contextmanager

import numpy as np

from opengemini_tpu_torch.ops import prom as promops
from opengemini_tpu_torch.promql import parser as pp
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.failpoint import inject as _fp
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS
from opengemini_tpu_torch.utils.stats import observe_ns as _observe_ns

NS = 1_000_000_000
MS_NS = 1_000_000  # ns per ms

_MAX_DIRTY = 4096  # beyond this a selector collapses to full re-dirty


def enabled_by_env() -> bool:
    return os.environ.get("OGT_RULES", "1") != "0"


def default_interval_s() -> float:
    return float(os.environ.get("OGT_RULES_INTERVAL_S", "") or 15.0)


def default_lateness_s() -> float:
    return float(os.environ.get("OGT_RULES_LATENESS_S", "") or 0.0)


def verify_enabled() -> bool:
    return os.environ.get("OGT_RULES_VERIFY", "0") == "1"


def max_window_tiles() -> int:
    return int(os.environ.get("OGT_RULES_MAX_TILES", "") or 4096)


class RuleError(ValueError):
    pass


# -- expression compiler ------------------------------------------------------

_OVER_TIME_MAP = {
    "sum_over_time": "sum", "count_over_time": "count",
    "avg_over_time": "avg", "min_over_time": "min",
    "max_over_time": "max", "stddev_over_time": "stddev",
    "stdvar_over_time": "stdvar", "last_over_time": "last",
    "present_over_time": "present",
}
_RANGE_FUNCS = {"rate": "rate", "increase": "increase", "delta": "delta",
                "changes": "changes", "resets": "resets",
                **_OVER_TIME_MAP}
_CMP_OPS = {">": np.greater, "<": np.less, ">=": np.greater_equal,
            "<=": np.less_equal, "==": np.equal, "!=": np.not_equal}
_AGG_OPS = {"sum", "avg", "min", "max", "count"}


class _Compiled:
    """The tile-eligible normal form of a rule expression:

        [agg_op by/without (...)] func(metric{matchers}[w]) [cmp literal]

    with func answerable from merged tile partials (ops/prom.py
    PARTIAL_* sets).  Anything else keeps ``tiled=False`` and the rule
    evaluates through the engine's full rescan each tick."""

    __slots__ = ("tiled", "metric", "matchers", "window_s", "func",
                 "agg_op", "agg_grouping", "agg_without",
                 "cmp_op", "cmp_thr", "cmp_flip")

    def __init__(self):
        self.tiled = False
        self.metric = ""
        self.matchers: list = []
        self.window_s = 0.0
        self.func = ""
        self.agg_op: str | None = None
        self.agg_grouping: list[str] = []
        self.agg_without = False
        self.cmp_op: str | None = None
        self.cmp_thr = 0.0
        self.cmp_flip = False  # literal was on the LHS

    @property
    def window_ms(self) -> int:
        return int(round(self.window_s * 1000.0))


def compile_expr(text: str) -> _Compiled:
    """Parse + shape-match.  Raises on a parse error (a rule that can
    never evaluate must be rejected at declare time); an unmatched but
    valid shape compiles to the fallback."""
    node = pp.parse(text)
    c = _Compiled()
    if isinstance(node, pp.BinaryOp) and node.op in _CMP_OPS \
            and not node.bool_mod:
        if isinstance(node.rhs, pp.NumberLit):
            c.cmp_op, c.cmp_thr = node.op, float(node.rhs.val)
            node = node.lhs
        elif isinstance(node.lhs, pp.NumberLit):
            c.cmp_op, c.cmp_thr = node.op, float(node.lhs.val)
            c.cmp_flip = True
            node = node.rhs
    if isinstance(node, pp.Aggregation) and node.op in _AGG_OPS \
            and node.param is None:
        c.agg_op = node.op
        c.agg_grouping = list(node.grouping)
        c.agg_without = bool(node.without)
        node = node.expr
    if not (isinstance(node, pp.FunctionCall)
            and node.name in _RANGE_FUNCS and len(node.args) == 1
            and isinstance(node.args[0], pp.MatrixSelector)):
        return c
    ms = node.args[0]
    vs = ms.vector
    if not vs.metric or vs.offset_s != 0:
        return c
    w_ms = ms.range_s * 1000.0
    if w_ms <= 0 or w_ms != round(w_ms):
        return c  # sub-ms window edges can't land on an ms lattice
    c.tiled = True
    c.metric = vs.metric
    c.matchers = list(vs.matchers)
    c.window_s = ms.range_s
    c.func = _RANGE_FUNCS[node.name]
    return c


# -- rule model ---------------------------------------------------------------

class Rule:
    """One rule in a group.  kind 'recording' writes its result vector
    back as series named `name`; kind 'alerting' drives a for-duration
    pending→firing state machine keyed by output label set."""

    def __init__(self, name: str, expr: str, kind: str = "recording",
                 labels: dict | None = None, for_s: float = 0.0,
                 annotations: dict | None = None):
        if kind not in ("recording", "alerting"):
            raise RuleError(f"unknown rule kind {kind!r}")
        if not name:
            raise RuleError("rule name required")
        if kind == "recording" and not name.replace("_", "").replace(
                ":", "").isalnum():
            raise RuleError(f"invalid recording rule metric name {name!r}")
        self.name = name
        self.expr = expr
        self.kind = kind
        self.labels = dict(labels or {})
        self.for_s = float(for_s)
        self.annotations = dict(annotations or {})
        self.compiled = compile_expr(expr)

    def to_json(self) -> dict:
        return {"name": self.name, "expr": self.expr, "kind": self.kind,
                "labels": self.labels, "for_s": self.for_s,
                "annotations": self.annotations}

    @classmethod
    def from_json(cls, j: dict) -> "Rule":
        return cls(j["name"], j["expr"], j.get("kind", "recording"),
                   j.get("labels"), j.get("for_s", 0.0),
                   j.get("annotations"))


def _sel_sig(metric: str, matchers) -> tuple:
    return (metric, tuple(sorted((m.name, m.op, m.value)
                                 for m in matchers)))


class _SelState:
    """Per-(group, selector) incremental tile state: a series registry
    (accretion-ordered, with a cached canonical sort for deterministic
    aggregation) plus {tile_idx: partial record} for every computed
    non-empty tile and the `covered` set distinguishing computed-empty
    from never-computed."""

    def __init__(self, metric: str, matchers):
        self.vs = pp.VectorSelector(metric=metric, matchers=list(matchers))
        self.metric = metric
        self.key2row: dict[tuple, int] = {}
        self.keys: list[tuple] = []
        self.labels: list[dict] = []
        self.tiles: dict[int, dict] = {}
        self.covered: set[int] = set()
        self.dirty: set[int] = set()
        self.dirty_all = True  # bootstrap: first tick folds the window
        self._canon: np.ndarray | None = None

    @property
    def n_series(self) -> int:
        return len(self.keys)

    def canon_order(self) -> np.ndarray:
        """Registry rows sorted by series key — the canonical reduction
        order both evaluation legs share (bit-identity needs ONE order,
        and the incremental registry accretes in arrival order)."""
        if self._canon is None or len(self._canon) != len(self.keys):
            self._canon = np.array(
                sorted(range(len(self.keys)), key=lambda i: self.keys[i]),
                dtype=np.int64)
        return self._canon

    def intern_rows(self, labels: list[dict]) -> np.ndarray:
        rows = np.empty(len(labels), np.int64)
        for i, tags in enumerate(labels):
            key = tuple(sorted(tags.items()))
            row = self.key2row.get(key)
            if row is None:
                row = len(self.keys)
                self.key2row[key] = row
                self.keys.append(key)
                self.labels.append(dict(tags))
                self._canon = None
            rows[i] = row
        return rows

    def rec_view(self, tile: int) -> dict | None:
        """The tile's record padded to the CURRENT registry size (tiles
        folded before a series appeared stay stored at their old size)."""
        rec = self.tiles.get(tile)
        if rec is None:
            return None
        S = self.n_series
        have = len(rec["n"])
        if have == S:
            return rec
        out = promops.empty_tile_partials(S)
        for f, _fill in promops.TILE_PARTIAL_FIELDS:
            out[f][:have] = rec[f]
        self.tiles[tile] = out
        return out


class RuleGroup:
    """Rules sharing one evaluation interval, one ms lattice (g = gcd of
    the interval and every tiled window), and one durable state file."""

    def __init__(self, db: str, name: str, interval_s: float,
                 lateness_s: float, state_path: str):
        if interval_s <= 0:
            raise RuleError("group interval must be positive")
        self.db = db
        self.name = name
        self.interval_s = float(interval_s)
        self.lateness_s = float(lateness_s)
        self.state_path = state_path
        self.rules: list[Rule] = []
        # serializes ticks (and ctrl-forced ticks) per group; the
        # manager-wide lock is never held across a storage scan
        self.m_lock = lockdep.Lock()
        self.io_lock = lockdep.Lock()
        self.ver = 0
        self._saved_ver = -1
        self.g_ms = max(1, int(round(self.interval_s * 1000.0)))
        self.last_eval_ns: int | None = None
        self.claimed_ns: int | None = None
        # rule name -> {key_json: {"state","active_since_ns","fired_at_ns",
        #               "value"}}
        self.alerts: dict[str, dict] = {}
        self.fires: dict[str, int] = {}
        self.resolves: dict[str, int] = {}
        self.last_tick_ms = 0.0
        self.last_results: dict[str, dict] = {}  # in-memory, per tick
        self.last_e_tile: int | None = None
        self._sels: dict[tuple, _SelState] = {}
        # (lo_ms, hi_ms] spans of writes between note_write_* and
        # write_done: tiles overlapping one stay dirty this tick (a fold
        # scanning mid-apply rows would clear a mark the rows need)
        self.inflight: list[tuple[int, int]] = []

    # -- lattice / shape -------------------------------------------------

    def interval_ms(self) -> int:
        return max(1, int(round(self.interval_s * 1000.0)))

    def relattice(self) -> None:
        """g = gcd(interval, tiled windows); windows whose tile count
        would blow the budget demote to the rescan fallback."""
        g = self.interval_ms()
        for r in self.rules:
            if r.compiled.tiled:
                g = math.gcd(g, r.compiled.window_ms)
        cap = max_window_tiles()
        for r in self.rules:
            if r.compiled.tiled and r.compiled.window_ms // g > cap:
                r.compiled.tiled = False
        self.g_ms = g
        self._sels = {}
        for r in self.rules:
            c = r.compiled
            if not c.tiled:
                continue
            sig = _sel_sig(c.metric, c.matchers)
            if sig not in self._sels:
                self._sels[sig] = _SelState(c.metric, c.matchers)
        # lattice moved: all cached tiles are keyed on the old g
        for s in self._sels.values():
            s.dirty_all = True

    def sel_for(self, c: _Compiled) -> _SelState:
        return self._sels[_sel_sig(c.metric, c.matchers)]

    def max_window_tiles_of(self, sel: _SelState) -> int:
        wt = 0
        for r in self.rules:
            c = r.compiled
            if c.tiled and self.sel_for(c) is sel:
                wt = max(wt, c.window_ms // self.g_ms)
        return wt

    def watched_metrics(self) -> set[str]:
        return {s.metric for s in self._sels.values()}

    # -- durable state ---------------------------------------------------

    def snapshot(self) -> tuple:
        self.ver += 1
        return (self.ver, json.dumps({
            "name": self.name, "db": self.db,
            "interval_s": self.interval_s, "lateness_s": self.lateness_s,
            "rules": [r.to_json() for r in self.rules],
            "last_eval_ns": self.last_eval_ns,
            "claimed_ns": self.claimed_ns,
            "alerts": self.alerts,
            "fires": self.fires, "resolves": self.resolves,
        }))

    def save(self, snap: tuple) -> None:
        ver, payload = snap
        with self.io_lock:
            if ver <= self._saved_ver:
                return  # a newer snapshot is already durable
            os.makedirs(os.path.dirname(self.state_path), exist_ok=True)
            tmp = self.state_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            self._saved_ver = ver

    @classmethod
    def load(cls, path: str) -> "RuleGroup | None":
        try:
            with open(path, encoding="utf-8") as f:
                j = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            g = cls(j["db"], j["name"], j["interval_s"],
                    j.get("lateness_s", 0.0), path)
            for rj in j.get("rules", []):
                g.rules.append(Rule.from_json(rj))
        except (KeyError, RuleError):
            return None
        g.last_eval_ns = j.get("last_eval_ns")
        g.claimed_ns = j.get("claimed_ns")
        g.alerts = j.get("alerts", {})
        g.fires = {k: int(v) for k, v in j.get("fires", {}).items()}
        g.resolves = {k: int(v) for k, v in j.get("resolves", {}).items()}
        g.relattice()
        return g


@contextmanager
def _stage(name: str):
    t0 = _time.perf_counter_ns()
    try:
        yield
    finally:
        ns = _time.perf_counter_ns() - t0
        tracing.record_stage(name, ns)
        TRACKER.add_stage_ns(TRACKER.current_qid(), name, ns)


def _overlaps(inflight, lo_ms: int, hi_ms: int) -> bool:
    return any(a < hi_ms and lo_ms < b for a, b in inflight)


class RuleManager:
    """Owns every rule group of one engine: the write-path dirty hook
    (engine.rules_hook), the governed tick (services/rules.py), the
    durable alert/watermark state, and the /api/v1/rules surfaces."""

    def __init__(self, engine, prom=None):
        from opengemini_tpu_torch.promql.engine import PromEngine

        self.engine = engine
        self.prom = prom if prom is not None else PromEngine(engine)
        self._lock = lockdep.mark_hot(lockdep.RLock(), "rules.manager_lock")
        self._groups: dict[tuple[str, str], RuleGroup] = {}
        self._watched: dict[str, set[str]] = {}  # db -> metric names
        self._closed = False
        self._load_all()
        engine.rules_hook = self
        self._stats_provider = self._gauges
        STATS.register_provider("rules", self._stats_provider)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            groups = list(self._groups.values())
        for g in groups:
            with g.m_lock:
                g.save(g.snapshot())
        STATS.unregister_provider("rules", self._stats_provider)
        if getattr(self.engine, "rules_hook", None) is self:
            self.engine.rules_hook = None

    # -- config ----------------------------------------------------------

    def _dir(self, db: str) -> str:
        return os.path.join(self.engine.root, "rules", db)

    def _load_all(self) -> None:
        root = os.path.join(self.engine.root, "rules")
        if not os.path.isdir(root):
            return
        for db in sorted(os.listdir(root)):
            dbdir = os.path.join(root, db)
            if not os.path.isdir(dbdir):
                continue
            for fn in sorted(os.listdir(dbdir)):
                if not fn.endswith(".json"):
                    continue
                g = RuleGroup.load(os.path.join(dbdir, fn))
                if g is not None:
                    self._groups[(g.db, g.name)] = g
        self._rebuild_watched()

    def _rebuild_watched(self) -> None:
        watched: dict[str, set[str]] = {}
        for (db, _n), g in self._groups.items():
            watched.setdefault(db, set()).update(g.watched_metrics())
        self._watched = watched

    def declare_group(self, db: str, name: str,
                      interval_s: float | None = None,
                      lateness_s: float | None = None) -> RuleGroup:
        if db not in self.engine.databases:
            raise RuleError(f"database {db!r} does not exist")
        with self._lock:
            g = self._groups.get((db, name))
            if g is None:
                g = RuleGroup(
                    db, name,
                    interval_s if interval_s is not None
                    else default_interval_s(),
                    lateness_s if lateness_s is not None
                    else default_lateness_s(),
                    os.path.join(self._dir(db), f"{name}.json"))
                self._groups[(db, name)] = g
            elif interval_s is not None or lateness_s is not None:
                if interval_s is not None:
                    g.interval_s = float(interval_s)
                if lateness_s is not None:
                    g.lateness_s = float(lateness_s)
                g.relattice()
            self._rebuild_watched()
        with g.m_lock:
            g.save(g.snapshot())
        return g

    def add_rule(self, db: str, group: str, rule: Rule,
                 interval_s: float | None = None,
                 lateness_s: float | None = None) -> RuleGroup:
        return self.add_rules(db, group, [rule], interval_s, lateness_s)

    def add_rules(self, db: str, group: str, rules: list,
                  interval_s: float | None = None,
                  lateness_s: float | None = None) -> RuleGroup:
        """Batch declare: one relattice + one state fsync for the whole
        list (a fleet declare is one durable write, not thousands)."""
        g = self.declare_group(db, group, interval_s, lateness_s)
        with self._lock:
            names = {r.name for r in rules}
            g.rules = [r for r in g.rules
                       if r.name not in names] + list(rules)
            g.relattice()
            self._rebuild_watched()
        with g.m_lock:
            g.save(g.snapshot())
        return g

    def drop_rule(self, db: str, group: str, name: str) -> None:
        with self._lock:
            g = self._groups.get((db, group))
            if g is None:
                raise RuleError(f"unknown rule group {db}.{group}")
            before = len(g.rules)
            g.rules = [r for r in g.rules if r.name != name]
            if len(g.rules) == before:
                raise RuleError(f"unknown rule {name!r} in {db}.{group}")
            g.alerts.pop(name, None)
            g.relattice()
            self._rebuild_watched()
        with g.m_lock:
            g.save(g.snapshot())

    def drop_group(self, db: str, group: str) -> None:
        with self._lock:
            g = self._groups.pop((db, group), None)
            self._rebuild_watched()
        if g is None:
            raise RuleError(f"unknown rule group {db}.{group}")
        try:
            os.remove(g.state_path)
        except OSError:
            pass

    def drop_db_state(self, db: str) -> None:
        """DROP DATABASE cleanup (mirrors rollup.drop_db_state)."""
        import shutil

        with self._lock:
            for key in [k for k in self._groups if k[0] == db]:
                self._groups.pop(key)
            self._rebuild_watched()
        shutil.rmtree(self._dir(db), ignore_errors=True)

    def groups_for(self, db: str | None = None) -> list[RuleGroup]:
        with self._lock:
            return [g for (d, _n), g in sorted(self._groups.items())
                    if db is None or d == db]

    def dbs_with_groups(self) -> list[str]:
        with self._lock:
            return sorted({d for d, _n in self._groups})

    def invalidate(self, db: str, group: str | None = None) -> int:
        """Drop every cached tile of the matching groups so the next
        tick refolds whole windows from storage — the forced from-
        scratch leg bench/loadgen measure the incremental path against
        (and the repair hammer if tile state is ever suspect)."""
        n = 0
        with self._lock:
            for (d, name), g in self._groups.items():
                if d != db or (group is not None and name != group):
                    continue
                for sel in g._sels.values():
                    sel.dirty_all = True
                    n += 1
        return n

    # -- write-path dirty marking (engine.rules_hook) --------------------

    def note_write_points(self, db: str, rp: str | None, points):
        watched = self._watched.get(db)
        if not watched:
            return None
        by_mst: dict[str, list[int]] = {}
        for p in points:
            if p[0] in watched:
                by_mst.setdefault(p[0], []).append(p[2])
        if not by_mst:
            return None
        spans = {m: (min(ts), max(ts)) for m, ts in by_mst.items()}
        return self._note_spans(db, spans)

    def note_write_columnar(self, db: str, rp: str | None, batch):
        watched = self._watched.get(db)
        if not watched:
            return None
        hit = [(i, m) for i, m in enumerate(batch.measurements)
               if m in watched]
        if not hit:
            return None
        row_mst = batch.row_mst()
        spans: dict[str, tuple[int, int]] = {}
        for mid, m in hit:
            ts = batch.ts[row_mst == mid]
            if len(ts):
                spans[m] = (int(ts.min()), int(ts.max()))
        if not spans:
            return None
        return self._note_spans(db, spans)

    def _note_spans(self, db: str, spans: dict[str, tuple[int, int]]):
        """Write-ahead mark: dirty the touched tiles of every watching
        selector and register the span in flight BEFORE the rows apply
        (storage/rollup.py note contract); the engine's write_done
        releases the floor once the rows are readable."""
        token: list = []
        with self._lock:
            for g in self._groups.values():
                if g.db != db:
                    continue
                marked = False
                for sel in g._sels.values():
                    span = spans.get(sel.metric)
                    if span is None:
                        continue
                    lo_t = int((span[0] // MS_NS - 1) // g.g_ms)
                    hi_t = int((span[1] // MS_NS + g.g_ms - 1) // g.g_ms) + 1
                    if hi_t - lo_t > _MAX_DIRTY \
                            or len(sel.dirty) > _MAX_DIRTY:
                        sel.dirty_all = True
                    else:
                        sel.dirty.update(range(lo_t, hi_t))
                    marked = True
                if marked:
                    span_lo = min(s[0] for m, s in spans.items()
                                  if any(sel.metric == m
                                         for sel in g._sels.values()))
                    span_hi = max(s[1] for m, s in spans.items()
                                  if any(sel.metric == m
                                         for sel in g._sels.values()))
                    ent = (span_lo // MS_NS, span_hi // MS_NS + 1)
                    g.inflight.append(ent)
                    token.append((g, ent))
                    STATS.incr("rules", "dirty_marks")
        return token or None

    def write_done(self, token) -> None:
        with self._lock:
            for g, ent in token:
                try:
                    g.inflight.remove(ent)
                except ValueError:
                    pass

    # -- evaluation ------------------------------------------------------

    def tick(self, now_ns: int | None = None, db: str | None = None,
             stop=None) -> int:
        """Evaluate every group whose next lattice eval time has
        arrived.  Returns the number of groups evaluated."""
        if now_ns is None:
            now_ns = _time.time_ns()
        ran = 0
        for g in self.groups_for(db):
            if stop is not None and stop.is_set():
                break
            if self.tick_group(g, now_ns):
                ran += 1
        return ran

    def eval_time(self, g: RuleGroup, now_ns: int) -> int:
        interval_ns = int(round(g.interval_s * NS))
        return ((now_ns - int(round(g.lateness_s * NS)))
                // interval_ns * interval_ns)

    def tick_group(self, g: RuleGroup, now_ns: int) -> bool:
        te_ns = self.eval_time(g, now_ns)
        if te_ns <= (g.last_eval_ns or 0) or not g.rules:
            return False
        with g.m_lock:
            # re-check under the tick lock (ctrl tick racing the service)
            if te_ns <= (g.last_eval_ns or 0):
                return False
            t0 = _time.perf_counter_ns()
            qid = TRACKER.register(f"rules {g.db}.{g.name}", g.db)
            try:
                self._tick_locked(g, te_ns)
            finally:
                dur_ns = _time.perf_counter_ns() - t0
                g.last_tick_ms = dur_ns / 1e6
                _observe_ns("rules_tick_seconds", dur_ns)
                from opengemini_tpu_torch.utils.slowlog import GLOBAL as SLOWLOG

                if SLOWLOG.enabled():
                    SLOWLOG.note(qid, f"rules {g.db}.{g.name}", g.db,
                                 dur_ns / 1e6,
                                 stages=TRACKER.stages_of(qid),
                                 extra={"kind": "rules"})
                TRACKER.unregister(qid)
        STATS.incr("rules", "ticks")
        return True

    def _tick_locked(self, g: RuleGroup, te_ns: int) -> None:
        # -- mark: durably claim the tick BEFORE evaluating.  A crash
        # past this point re-runs the same te (last_eval unmoved), and
        # alert transitions/fire counts only land in the final save — so
        # the re-run cannot double-count, and recording write-back is
        # last-write-wins idempotent.
        with _stage("rules_mark"):
            g.claimed_ns = te_ns
            g.save(g.snapshot())
        _fp("rules-mark-before-eval")

        te_ms = te_ns // MS_NS
        e_tile = te_ms // g.g_ms
        with self._lock:
            inflight = list(g.inflight)

        # -- fold: refold dirty/new tiles per selector (one storage scan
        # per coalesced run), matcher probes through the label tier
        claimed: list[tuple[_SelState, set[int]]] = []
        lagged = False
        try:
            with _stage("rules_fold"):
                for sel in g._sels.values():
                    wt = g.max_window_tiles_of(sel)
                    if wt == 0:
                        continue
                    lo_needed = int(e_tile - wt)
                    needed = set(range(lo_needed, int(e_tile)))
                    with self._lock:
                        if sel.dirty_all:
                            sel.dirty_all = False
                            sel.tiles.clear()
                            sel.covered.clear()
                        todo = (needed - sel.covered) | (sel.dirty & needed)
                        live = {t for t in todo if not _overlaps(
                            inflight, t * g.g_ms, (t + 1) * g.g_ms)}
                        if live != todo:
                            lagged = True
                        sel.dirty -= live
                        claimed.append((sel, live))
                        # evict tiles behind every window
                        for t in [t for t in sel.covered if t < lo_needed]:
                            sel.covered.discard(t)
                            sel.tiles.pop(t, None)
                        sel.dirty = {t for t in sel.dirty if t >= lo_needed}
                    if live:
                        self._fold_tiles(g, sel, live)
                        STATS.incr("rules", "tiles_folded", len(live))
            claimed = []
        finally:
            if claimed:  # aborted mid-fold: the marks go back
                with self._lock:
                    for sel, live in claimed:
                        sel.dirty |= live

        # -- merge + eval: answer every rule from merged tile prefixes
        # (canonical series order), fallback rules through the engine.
        # The memo shares one merge+answer across every rule with the
        # same (selector, func, window) — the fleet economy: thousands
        # of threshold rules over one selector cost ONE merge per tick.
        results: dict[str, dict] = {}
        memo: dict = {}
        with _stage("rules_merge"):
            for r in g.rules:
                if r.compiled.tiled:
                    results[r.name] = self._eval_tiled(g, r, e_tile,
                                                       memo=memo)
                else:
                    results[r.name] = self._eval_fallback(g, r, te_ns)
        g.last_results = results
        g.last_e_tile = int(e_tile)

        # -- verify: the from-scratch leg must agree bit-for-bit
        if verify_enabled():
            with _stage("rules_verify"):
                if lagged or inflight:
                    # a mid-apply write makes the two legs read
                    # different storage states: not a counterexample
                    STATS.incr("rules", "verify_skips")
                else:
                    self._verify(g, e_tile, results)
                    STATS.incr("rules", "verify_ticks")

        # -- effects: recording write-back + alert transitions
        with _stage("rules_write"):
            points = []
            vf = self.prom.value_field
            for r in g.rules:
                if r.kind != "recording":
                    continue
                for key, val in sorted(results[r.name].items()):
                    tags = dict(key)
                    tags.update(r.labels)
                    points.append((r.name,
                                   tuple(sorted(tags.items())),
                                   te_ns,
                                   {vf: (FieldType.FLOAT, float(val))}))
            if points:
                self.engine.write_rows(g.db, points)
                STATS.incr("rules", "series_written", len(points))
        with _stage("rules_alerts"):
            for r in g.rules:
                if r.kind == "alerting":
                    self._advance_alerts(g, r, results[r.name], te_ns)

        # -- final mark: watermark + alert state in ONE durable save
        g.last_eval_ns = te_ns
        g.claimed_ns = None
        g.save(g.snapshot())

    def _collect(self, sel: _SelState, db: str, lo_ms: int, hi_ms: int):
        """(labels, t_ms, v, lens) for the selector over (lo_ms, hi_ms]
        — the engine's run-encoded collection (bulk decode + label-tier
        matcher probes)."""
        got = self.prom._collect_series(
            sel.vs, lo_ms * MS_NS + 1, hi_ms * MS_NS + 1, db)
        return got[:4]

    def _fold_tiles(self, g: RuleGroup, sel: _SelState,
                    tiles: set[int]) -> None:
        from opengemini_tpu_torch.query import offload

        runs: list[list[int]] = []
        for t in sorted(tiles):
            if runs and runs[-1][1] == t:
                runs[-1][1] = t + 1
            else:
                runs.append([t, t + 1])
        for lo_t, hi_t in runs:
            t0 = _time.perf_counter_ns()
            labels, t_ms, v, lens = self._collect(
                sel, g.db, lo_t * g.g_ms, hi_t * g.g_ms)
            rows = sel.intern_rows(labels)
            recs = promops.fold_tile_partials(
                t_ms, v, lens, 0, g.g_ms, lo_t, hi_t)
            S = sel.n_series
            with self._lock:
                for t in range(lo_t, hi_t):
                    sel.covered.add(t)
                    rec = recs.get(t)
                    if rec is None:
                        sel.tiles.pop(t, None)
                        continue
                    full = promops.empty_tile_partials(S)
                    for f, _fill in promops.TILE_PARTIAL_FIELDS:
                        full[f][rows] = rec[f]
                    sel.tiles[t] = full
            # host-pinned fold (the bitwise contract needs a
            # deterministic reduction order); the planner still sees its
            # cost so /debug/offload attributes rule maintenance
            offload.GLOBAL.observe(
                "rules_fold", (S, hi_t - lo_t), "host",
                (_time.perf_counter_ns() - t0) / 1e9)

    def _eval_tiled(self, g: RuleGroup, r: Rule, e_tile: int,
                    sel: _SelState | None = None,
                    tile_of=None, memo: dict | None = None) -> dict:
        """{output label key: value} for one tiled rule at eval tile
        `e_tile`.  `sel`/`tile_of` override the group's cached state for
        the verify leg (same arithmetic, fresh tiles).  `memo` shares
        the merged-window answer across rules with the same (selector,
        func, window) within one tick — aggregation/threshold layers
        stay per-rule."""
        c = r.compiled
        if sel is None:
            sel = g.sel_for(c)
        if tile_of is None:
            tile_of = sel.rec_view
        wt = c.window_ms // g.g_ms
        S = sel.n_series
        mkey = (id(sel), c.func, c.window_ms)
        # two memo layers: the merged-window answer per (selector, func,
        # window), and the pre-threshold output vector per (that + agg
        # shape) — a fleet of threshold rules differing only in the
        # literal shares everything up to the final comparison
        okey = (id(sel), c.func, c.window_ms, c.agg_op,
                tuple(c.agg_grouping), c.agg_without)
        pre = memo.get(okey) if memo is not None else None
        if pre is None:
            got = memo.get(mkey) if memo is not None else None
            if got is not None:
                values, valid = got
            else:
                merged = promops.merge_tile_partials(
                    [tile_of(int(t))
                     for t in range(e_tile - wt, e_tile)], S)
                ws_ms = (e_tile - wt) * g.g_ms
                we_ms = e_tile * g.g_ms
                values, valid = promops.partials_answer(
                    merged, c.func, ws_ms, we_ms)
                if memo is not None:
                    memo[mkey] = (values, valid)
            order = sel.canon_order()
            pre = {}
            if c.agg_op is None:
                for i in order:
                    if valid[i]:
                        pre[sel.keys[i]] = float(values[i])
            else:
                groups: dict[tuple, list[int]] = {}
                for i in order:
                    if not valid[i]:
                        continue
                    tags = sel.labels[i]
                    if c.agg_without:
                        key = tuple(sorted(
                            (k, v) for k, v in tags.items()
                            if k not in c.agg_grouping))
                    else:
                        key = tuple(sorted(
                            (k, tags[k])
                            for k in c.agg_grouping if k in tags))
                    groups.setdefault(key, []).append(int(i))
                for key in sorted(groups):
                    vals = values[np.array(groups[key], np.int64)]
                    if c.agg_op == "sum":
                        pre[key] = float(np.sum(vals))
                    elif c.agg_op == "avg":
                        pre[key] = float(np.sum(vals) / len(vals))
                    elif c.agg_op == "min":
                        pre[key] = float(np.min(vals))
                    elif c.agg_op == "max":
                        pre[key] = float(np.max(vals))
                    else:  # count
                        pre[key] = float(len(vals))
            if memo is not None:
                memo[okey] = pre
        out: dict[tuple, float] = dict(pre)
        if c.cmp_op is not None:
            fn = _CMP_OPS[c.cmp_op]
            if c.cmp_flip:
                out = {k: v for k, v in out.items()
                       if bool(fn(c.cmp_thr, v))}
            else:
                out = {k: v for k, v in out.items()
                       if bool(fn(v, c.cmp_thr))}
        return out

    def _eval_fallback(self, g: RuleGroup, r: Rule, te_ns: int) -> dict:
        """Full evaluation through the engine for tile-ineligible
        expressions — planner-routed kernels, label-tier matching, the
        works."""
        STATS.incr("rules", "fallback_evals")
        res = self.prom.query_instant(r.expr, te_ns / 1e9, g.db)
        out: dict[tuple, float] = {}
        if res.get("resultType") != "vector":
            return out
        for s in res["result"]:
            labels = {k: v for k, v in s["metric"].items()
                      if k != "__name__"}
            out[tuple(sorted(labels.items()))] = float(s["value"][1])
        return out

    def verify_last_tick(self, g: RuleGroup) -> bool:
        """Re-run the from-scratch leg against the last tick's retained
        results (bench/loadgen: assert bit-identity on a measured tick
        without paying the verify rescan INSIDE the timed tick).
        Raises on mismatch; False when no tick has run yet."""
        if g.last_e_tile is None:
            return False
        with g.m_lock:
            self._verify(g, g.last_e_tile, g.last_results)
        return True

    def _verify(self, g: RuleGroup, e_tile: int, got: dict) -> None:
        """The from-scratch leg: fold EVERY window tile off one full
        scan per selector, merge with the same arithmetic, compare
        bitwise.  A mismatch is a maintenance bug — raise loudly."""
        fresh: dict[int, tuple] = {}
        for sig, sel in g._sels.items():
            wt = g.max_window_tiles_of(sel)
            if wt == 0:
                continue
            lo_t = int(e_tile - wt)
            f_sel = _SelState(sel.metric, sel.vs.matchers)
            f_sel.dirty_all = False
            labels, t_ms, v, lens = self._collect(
                f_sel, g.db, lo_t * g.g_ms, int(e_tile) * g.g_ms)
            rows = f_sel.intern_rows(labels)
            recs = promops.fold_tile_partials(
                t_ms, v, lens, 0, g.g_ms, lo_t, int(e_tile))
            S = f_sel.n_series
            for t, rec in recs.items():
                full = promops.empty_tile_partials(S)
                for f, _fill in promops.TILE_PARTIAL_FIELDS:
                    full[f][rows] = rec[f]
                f_sel.tiles[t] = full
                f_sel.covered.add(t)
            fresh[id(sel)] = (f_sel,)
        memo: dict = {}
        for r in g.rules:
            if not r.compiled.tiled:
                continue
            sel = g.sel_for(r.compiled)
            f_sel = fresh[id(sel)][0]
            want = self._eval_tiled(g, r, e_tile, sel=f_sel,
                                    tile_of=f_sel.rec_view, memo=memo)
            have = got[r.name]
            same = have.keys() == want.keys() and all(
                have[k] == want[k]
                or (math.isnan(have[k]) and math.isnan(want[k]))
                for k in want)
            if not same:
                STATS.incr("rules", "verify_failures")
                raise RuntimeError(
                    f"rules verify mismatch for {g.db}.{g.name}/{r.name}: "
                    f"incremental {have!r} != rescan {want!r}")

    # -- alert state machine ---------------------------------------------

    def _advance_alerts(self, g: RuleGroup, r: Rule, result: dict,
                        te_ns: int) -> None:
        """pending→firing→resolved per output label set.  Transitions
        mutate IN-MEMORY state here; they become observable (and
        counted) only at the tick's final fsync — the no-double-fire
        edge."""
        st = g.alerts.setdefault(r.name, {})
        for_ns = int(round(r.for_s * NS))
        active_keys = set()
        for key, val in result.items():
            labels = dict(key)
            labels["alertname"] = r.name
            labels.update(r.labels)
            kjson = json.dumps(sorted(labels.items()))
            active_keys.add(kjson)
            ent = st.get(kjson)
            if ent is None:
                ent = st[kjson] = {
                    "state": "pending", "active_since_ns": te_ns,
                    "fired_at_ns": None, "value": val,
                    "labels": labels}
            ent["value"] = val
            if ent["state"] == "pending" \
                    and te_ns - ent["active_since_ns"] >= for_ns:
                ent["state"] = "firing"
                ent["fired_at_ns"] = te_ns
                g.fires[r.name] = g.fires.get(r.name, 0) + 1
                STATS.incr("rules", "alerts_fired")
        for kjson in [k for k in st if k not in active_keys]:
            if st[kjson]["state"] == "firing":
                g.resolves[r.name] = g.resolves.get(r.name, 0) + 1
                STATS.incr("rules", "alerts_resolved")
            del st[kjson]

    # -- surfaces --------------------------------------------------------

    def status(self) -> dict:
        out = {}
        for g in self.groups_for():
            with self._lock:
                dirty = sum(len(s.dirty) for s in g._sels.values())
                tiles = sum(len(s.tiles) for s in g._sels.values())
                series = sum(s.n_series for s in g._sels.values())
            out[f"{g.db}.{g.name}"] = {
                "interval_s": g.interval_s,
                "lateness_s": g.lateness_s,
                "g_ms": g.g_ms,
                "rules": [
                    {"name": r.name, "kind": r.kind,
                     "tiled": r.compiled.tiled} for r in g.rules],
                "last_eval_ns": g.last_eval_ns,
                "claimed_ns": g.claimed_ns,
                "last_tick_ms": round(g.last_tick_ms, 3),
                "dirty_tiles": dirty,
                "cached_tiles": tiles,
                "tracked_series": series,
                "alerts_firing": sum(
                    1 for rs in g.alerts.values()
                    for e in rs.values() if e["state"] == "firing"),
                "alerts_pending": sum(
                    1 for rs in g.alerts.values()
                    for e in rs.values() if e["state"] == "pending"),
                "fires": dict(g.fires),
                "resolves": dict(g.resolves),
            }
        return out

    def rules_api(self) -> dict:
        """GET /api/v1/rules payload (prometheus rules endpoint)."""
        groups = []
        for g in self.groups_for():
            rules = []
            for r in g.rules:
                j = {"name": r.name, "query": r.expr, "health": "ok",
                     "labels": r.labels,
                     "evaluationTime": g.last_tick_ms / 1e3,
                     "type": "recording" if r.kind == "recording"
                     else "alerting"}
                if r.kind == "alerting":
                    ents = list(g.alerts.get(r.name, {}).values())
                    j["duration"] = r.for_s
                    j["annotations"] = r.annotations
                    j["state"] = (
                        "firing" if any(e["state"] == "firing"
                                        for e in ents)
                        else "pending" if ents else "inactive")
                    j["alerts"] = [self._alert_json(e) for e in ents]
                rules.append(j)
            groups.append({
                "name": g.name, "file": g.db,
                "interval": g.interval_s, "rules": rules,
                "lastEvaluation": (
                    None if g.last_eval_ns is None
                    else g.last_eval_ns / 1e9)})
        return {"groups": groups}

    def alerts_api(self) -> dict:
        """GET /api/v1/alerts payload: every pending/firing alert."""
        alerts = []
        for g in self.groups_for():
            for r in g.rules:
                for e in g.alerts.get(r.name, {}).values():
                    alerts.append(self._alert_json(e, r))
        return {"alerts": alerts}

    @staticmethod
    def _alert_json(e: dict, r: Rule | None = None) -> dict:
        j = {"labels": e.get("labels", {}),
             "state": e["state"],
             "activeAt": e["active_since_ns"] / 1e9,
             "value": str(e["value"])}
        if e.get("fired_at_ns"):
            j["firedAt"] = e["fired_at_ns"] / 1e9
        if r is not None:
            j["annotations"] = r.annotations
        return j

    def _gauges(self) -> dict:
        with self._lock:
            groups = list(self._groups.values())
        firing = pending = dirty = 0
        for g in groups:
            for rs in g.alerts.values():
                for e in rs.values():
                    if e["state"] == "firing":
                        firing += 1
                    else:
                        pending += 1
            dirty += sum(len(s.dirty) for s in g._sels.values())
        return {
            "groups": len(groups),
            "rules_total": sum(len(g.rules) for g in groups),
            "alerts_firing": firing,
            "alerts_pending": pending,
            "dirty_tiles": dirty,
        }
