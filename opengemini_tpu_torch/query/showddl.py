"""SHOW and DDL statement execution (an Executor mixin).

The port of ``opengemini_tpu/query/showddl.py`` for the schema and
metadata statements: the statement dispatch (``execute_statement``),
SHOW DATABASES, MEASUREMENTS, TAG KEYS, TAG VALUES, FIELD KEYS, SERIES,
SERIES [EXACT] CARDINALITY, MEASUREMENT CARDINALITY, RETENTION POLICIES,
SHARDS and QUERIES (the running queries of utils/querytracker.py), KILL
QUERY; CREATE DATABASE (with ``WITH ...``) and DROP DATABASE;
CREATE, ALTER and DROP RETENTION POLICY; CREATE MEASUREMENT (accepted,
the engine is schema-on-write), DROP MEASUREMENT (a mark: SELECT and
the metadata SHOWs hide the measurement, SHOW SERIES keeps its series
until a purge, as in the reference), and DELETE and DROP SERIES (the
shards' delete rewrite, storage/shard.py ``delete_data``; DROP SERIES
refuses a time condition, and neither takes a field condition; a
delete re-dirties the rollup windows it overlaps); CREATE, SHOW and
DROP CONTINUOUS QUERY, STREAM (validated by services/stream.py) and
DOWNSAMPLE (the reference's per-type aggregate allow-list, levels and
TTL checks).

The port is single-node, so the reference's raft replication of DDL
(``_replicate_ddl``, ``_check_fsm_db``) becomes the local engine call.
Every other statement of the reference answers a "not supported by this
port yet" error naming the ROADMAP item that owns it (``_NOT_PORTED``):
subscriptions and models (A7.2); users, grants and SHOW CLUSTER (A8);
SHOW STATS and SHOW DIAGNOSTICS (A9). UNION statements run
through query/join.py's ``execute_union``.
"""

from __future__ import annotations

import os
import re

from opengemini_tpu_torch.ingest.line_protocol import series_key
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.query.qhelpers import (
    NS, QueryError, _fmt_duration, _series, _series_result,
)
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.services.stream import validate_stream_select
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.storage.engine import (
    ContinuousQuery, DownsamplePolicy, StreamTask,
)
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

_MIN_RP_DURATION_NS = 3600 * NS

# the metadata SHOWs this module answers (_show)
_SHOW_STMTS = (
    ast.ShowDatabases, ast.ShowMeasurements, ast.ShowTagKeys,
    ast.ShowTagValues, ast.ShowFieldKeys, ast.ShowSeries,
    ast.ShowSeriesExactCardinality, ast.ShowRetentionPolicies,
    ast.ShowShards, ast.ShowMeasurementCardinality,
    ast.ShowSeriesCardinality,
)

# statement type -> the ROADMAP item that ports it
_NOT_PORTED = {
    ast.CreateSubscription: "A7.2",
    ast.DropSubscription: "A7.2",
    ast.ShowSubscriptions: "A7.2",
    ast.CreateModel: "A7.2",
    ast.ShowModels: "A7.2",
    ast.DropModel: "A7.2",
    ast.CreateUser: "A8",
    ast.DropUser: "A8",
    ast.SetPassword: "A8",
    ast.GrantStatement: "A8",
    ast.RevokeStatement: "A8",
    ast.ShowUsers: "A8",
    ast.ShowGrants: "A8",
    ast.ShowCluster: "A8",
    ast.ShowStats: "A9",
    ast.ShowDiagnostics: "A9",
}


def _check_rp_min_duration(duration_ns: int | None) -> None:
    """Influx rejects retention durations below 1h (0 = INF is allowed):
    'retention policy duration must be at least 1h0m0s'."""
    if duration_ns and duration_ns < _MIN_RP_DURATION_NS:
        raise QueryError(
            "retention policy duration must be at least 1h0m0s")


class ShowDdlMixin:
    # the aggregates the downsample rewrite can run per field type:
    # integers stay on the exact host int64 path (sum/min/max/first/
    # last) or give a float (mean/stddev/median); count, count_distinct,
    # spread and percentile would fail at rewrite time for INT fields,
    # and percentile lacks its parameter in every path
    _DOWNSAMPLE_AGGS = {
        "float": {"sum", "count", "mean", "min", "max", "first", "last",
                  "spread", "stddev", "median"},
        "integer": {"sum", "mean", "min", "max", "first", "last",
                    "stddev", "median"},
        "boolean": {"first", "last"},
    }

    def execute_statement(self, stmt, db: str, now_ns: int) -> dict:
        if isinstance(stmt, ast.SelectStatement):
            STATS.incr("executor", "selects")
            res = self._select(stmt, db, now_ns)
            if not stmt.ascending and res.get("series"):
                # ORDER BY time DESC reverses the SERIES order too, once,
                # at the statement boundary: _select recurses for
                # subqueries and CTEs and must not reverse twice
                res = dict(res, series=list(reversed(res["series"])))
            return res
        if isinstance(stmt, ast.UnionStatement):
            from opengemini_tpu_torch.query import join as joinmod

            STATS.incr("executor", "selects")
            return joinmod.execute_union(self, stmt, db, now_ns)
        if isinstance(stmt, ast.ExplainStatement):
            return self._explain(stmt, db, now_ns)
        if isinstance(stmt, _SHOW_STMTS):
            # the index and metadata reads of a SHOW, one query stage
            with tracing.current().span("show"):
                return self._show(stmt, db)
        if isinstance(stmt, ast.CreateMeasurement):
            return {}  # schema-on-write engine: accept and record nothing
        if isinstance(stmt, ast.CreateDatabase):
            self.engine.create_database(stmt.name)
            if stmt.has_rp_clause:
                self.engine.create_retention_policy(
                    stmt.name, stmt.rp_name or "autogen", stmt.duration_ns,
                    stmt.shard_duration_ns, default=True)
            return {}
        if isinstance(stmt, ast.DropDatabase):
            self.engine.drop_database(stmt.name)
            return {}
        if isinstance(stmt, ast.CreateRetentionPolicy):
            tgt = stmt.database or db
            _check_rp_min_duration(stmt.duration_ns)
            self.engine.create_retention_policy(
                tgt, stmt.name, stmt.duration_ns, stmt.shard_duration_ns,
                stmt.default)
            return {}
        if isinstance(stmt, ast.AlterRetentionPolicy):
            _check_rp_min_duration(stmt.duration_ns)
            try:
                self.engine.alter_retention_policy(
                    stmt.database or db, stmt.name, stmt.duration_ns,
                    stmt.shard_duration_ns, stmt.default)
            except ValueError as e:
                raise QueryError(str(e)) from None
            return {}
        if isinstance(stmt, ast.DropRetentionPolicy):
            self.engine.drop_retention_policy(stmt.database or db, stmt.name)
            return {}
        if isinstance(stmt, ast.DropMeasurement):
            # mark + deferred purge (the reference's MarkMeasurementDelete)
            self.engine.mark_measurement_delete(db, stmt.name)
            return {}
        if isinstance(stmt, (ast.DeleteSeries, ast.DropSeries)):
            return self._delete(stmt, db, now_ns)
        if isinstance(stmt, ast.ShowQueries):
            rows = [
                [q["qid"], q["query"], q["database"],
                 f"{q['duration_ms']}ms", q["status"]]
                for q in TRACKER.snapshot()
            ]
            return _series_result(
                "", None, ["qid", "query", "database", "duration", "status"],
                rows)
        if isinstance(stmt, ast.KillQuery):
            if not TRACKER.kill(stmt.qid):
                raise QueryError(f"no such query: {stmt.qid}")
            return {}
        if isinstance(stmt, ast.CreateContinuousQuery):
            tgt = stmt.database or db
            self.engine.create_continuous_query(tgt, ContinuousQuery(
                stmt.name, stmt.select_text,
                stmt.resample_every_ns, stmt.resample_for_ns))
            return {}
        if isinstance(stmt, ast.DropContinuousQuery):
            self.engine.drop_continuous_query(stmt.database or db, stmt.name)
            return {}
        if isinstance(stmt, ast.ShowContinuousQueries):
            series = []
            for name in sorted(self.engine.databases):
                d = self.engine.databases[name]
                rows = [[cq.name, cq.select_text]
                        for cq in d.continuous_queries.values()]
                series.append(_series(name, None, ["name", "query"], rows))
            return {"series": series} if series else {}
        if isinstance(stmt, ast.CreateStream):
            try:
                validate_stream_select(stmt.select)
            except ValueError as e:
                raise QueryError(str(e)) from None
            self.engine.create_stream(db, StreamTask(
                stmt.name, stmt.select_text, stmt.delay_ns))
            return {}
        if isinstance(stmt, ast.DropStream):
            self.engine.drop_stream(db, stmt.name)
            return {}
        if isinstance(stmt, ast.ShowStreams):
            series = []
            for name in sorted(self.engine.databases):
                d = self.engine.databases[name]
                rows = [[st.name, st.select_text] for st in d.streams.values()]
                series.append(_series(name, None, ["name", "query"], rows))
            return {"series": series} if series else {}
        if isinstance(stmt, ast.CreateDownsample):
            return self._create_downsample(stmt, db)
        if isinstance(stmt, ast.DropDownsample):
            self.engine.drop_downsample_policies(stmt.database or db,
                                                 stmt.rp or None)
            return {}
        if isinstance(stmt, ast.ShowDownsamples):
            return self._show_downsamples(stmt, db)
        item = _NOT_PORTED.get(type(stmt))
        if item is not None:
            raise QueryError(f"{type(stmt).__name__} is not supported by "
                             f"this port yet (ROADMAP {item})")
        raise QueryError(f"unsupported statement: {type(stmt).__name__}")

    def _delete(self, stmt, db: str, now_ns: int) -> dict:
        """DELETE FROM m WHERE ... (a time range and tag filters) and
        DROP SERIES FROM m WHERE ... (whole series)."""
        if not stmt.measurement:
            raise QueryError("DELETE/DROP SERIES requires FROM <measurement>")
        is_drop_series = isinstance(stmt, ast.DropSeries)
        shards = self._all_shards_db(db)
        # tag keys of every shard: a shard without the measurement must
        # not read its tags as fields and fail with earlier shards
        # already rewritten
        tag_keys: set[str] = set()
        for sh in shards:
            tag_keys.update(sh.index.tag_keys(stmt.measurement))
        sc = cond.split(stmt.condition, tag_keys, now_ns)
        if sc.has_row_filter:
            raise QueryError(
                "DELETE conditions may only reference time and tags")
        has_time = sc.tmin != cond.MIN_TIME or sc.tmax != cond.MAX_TIME
        if is_drop_series and has_time:
            # influx refuses time bounds here rather than over-delete
            raise QueryError("DROP SERIES does not support time conditions")
        for sh in shards:
            sids = (cond.eval_tag_expr(sc.tag_expr, sh.index,
                                       stmt.measurement)
                    if sc.tag_expr is not None else None)
            if sids is not None and not sids:
                continue
            if is_drop_series or not has_time:
                sh.delete_data(stmt.measurement, sids)
            else:
                sh.delete_data(
                    stmt.measurement, sids,
                    None if sc.tmin == cond.MIN_TIME else sc.tmin,
                    None if sc.tmax == cond.MAX_TIME else sc.tmax)
        if self.engine.rollup_mgr is not None:
            # re-dirty the deleted span so maintenance re-folds it (and
            # zero-fills the series it emptied): a clean-looking rollup
            # window must never serve deleted rows
            self.engine.rollup_mgr.note_delete(
                db, stmt.measurement,
                None if not has_time or sc.tmin == cond.MIN_TIME else sc.tmin,
                None if not has_time or sc.tmax == cond.MAX_TIME else sc.tmax)
        return {}

    def _create_downsample(self, stmt, db: str) -> dict:
        """CREATE DOWNSAMPLE: level i rewrites the shards older than
        SAMPLEINTERVAL[i] at TIMEINTERVAL[i] resolution."""
        tgt = stmt.database or db
        if not stmt.rp:
            raise QueryError("CREATE DOWNSAMPLE requires ON [db.]rp")
        samples, times = stmt.sample_intervals, stmt.time_intervals
        if len(samples) != len(times):
            raise QueryError(
                "SAMPLEINTERVAL and TIMEINTERVAL must have the same "
                f"number of levels ({len(samples)} vs {len(times)})")
        for i in range(len(samples)):
            if times[i] <= 0 or samples[i] <= 0:
                raise QueryError("downsample intervals must be positive")
            if times[i] >= samples[i]:
                raise QueryError(
                    f"TIMEINTERVAL {_fmt_duration(times[i])} must be finer "
                    f"than SAMPLEINTERVAL {_fmt_duration(samples[i])}")
            if i and (samples[i] <= samples[i - 1]
                      or times[i] <= times[i - 1]):
                raise QueryError("downsample levels must be ascending")
        if stmt.ttl_ns and samples and stmt.ttl_ns < samples[-1]:
            raise QueryError("TTL must cover the last SAMPLEINTERVAL")
        for tname, agg in stmt.type_aggs.items():
            allowed = self._DOWNSAMPLE_AGGS.get(tname)
            if allowed is None:
                raise QueryError(f"unknown downsample field type: {tname!r}")
            if agg not in allowed:
                raise QueryError(
                    f"downsample aggregate {agg!r} is not supported for "
                    f"{tname} fields (one of: {', '.join(sorted(allowed))})")
            aggmod.get(agg)  # registry sanity; the allow-list is a subset
        d = self.engine.databases.get(tgt)
        if d is None:
            raise QueryError(f"database not found: {tgt}")
        if stmt.rp not in d.rps:
            raise QueryError(f"retention policy not found: {tgt}.{stmt.rp}")
        if d.downsample.get(stmt.rp):
            raise QueryError(f"downsample already exists on {tgt}.{stmt.rp}")
        policies = [
            DownsamplePolicy(samples[i], times[i], dict(stmt.type_aggs))
            for i in range(len(samples))
        ]
        self.engine.set_downsample_policies(tgt, stmt.rp, policies,
                                            ttl_ns=stmt.ttl_ns)
        return {}

    def _show_downsamples(self, stmt, db: str) -> dict:
        tgt = stmt.database or db
        d = self.engine.databases.get(tgt)
        if d is None:
            raise QueryError(f"database not found: {tgt}")
        rows = []
        for rp in sorted(d.downsample):
            for p in d.downsample[rp]:
                aggs = ",".join(f"{t}({a})"
                                for t, a in sorted(p.field_aggs.items()))
                rows.append([rp, aggs, _fmt_duration(p.age_ns),
                             _fmt_duration(p.every_ns)])
        series = _series(tgt, None,
                         ["rpName", "aggs", "sampleInterval", "timeInterval"],
                         rows)
        return {"series": [series]}

    # -- metadata SHOWs -----------------------------------------------------

    def _show(self, stmt, db: str) -> dict:
        if isinstance(stmt, ast.ShowDatabases):
            return _series_result("databases", None, ["name"],
                                  [[n] for n in self.engine.database_names()])
        if isinstance(stmt, ast.ShowMeasurements):
            return self._show_measurements(stmt, db)
        if isinstance(stmt, ast.ShowTagKeys):
            return self._show_tag_keys(stmt, db)
        if isinstance(stmt, ast.ShowTagValues):
            return self._show_tag_values(stmt, db)
        if isinstance(stmt, ast.ShowFieldKeys):
            return self._show_field_keys(stmt, db)
        if isinstance(stmt, ast.ShowSeries):
            return self._show_series(stmt, db)
        if isinstance(stmt, ast.ShowSeriesExactCardinality):
            return self._show_series_exact_cardinality(stmt, db)
        if isinstance(stmt, ast.ShowRetentionPolicies):
            return self._show_rps(stmt, db)
        if isinstance(stmt, ast.ShowShards):
            return self._show_shards()
        if isinstance(stmt, ast.ShowMeasurementCardinality):
            cdb = stmt.database or db
            names: set[str] = set()
            for sh in self._all_shards_db(cdb):
                names.update(
                    m for m in sh.measurements() if self._visible(cdb, m))
            return _series_result("", None, ["count"], [[len(names)]])
        return self._show_series_cardinality(stmt, db)

    def _all_shards_db(self, db: str):
        return self.engine.shards_for_range(db, None, cond.MIN_TIME,
                                            cond.MAX_TIME)

    def _visible(self, db: str, mst: str) -> bool:
        """False for mark-deleted measurements (hidden from SELECT and the
        metadata SHOWs; SHOW SERIES still lists their series until the
        purge, as the reference's suite asserts)."""
        return not self.engine.is_measurement_dropped(db, mst)

    def _show_measurements(self, stmt, db) -> dict:
        db = stmt.database or db
        names: set[str] = set()
        for sh in self._all_shards_db(db):
            names.update(m for m in sh.measurements() if self._visible(db, m))
        if stmt.regex:
            rx = re.compile(stmt.regex)
            names = {n for n in names if rx.search(n)}
        if not names:
            return {}
        return _series_result("measurements", None, ["name"],
                              [[n] for n in sorted(names)])

    @staticmethod
    def _mst_match(stmt, mst: str) -> bool:
        if stmt.measurement:
            return mst == stmt.measurement
        if getattr(stmt, "measurement_regex", ""):
            return re.search(stmt.measurement_regex, mst) is not None
        return True

    @staticmethod
    def _matching_sids(sh, mst: str, condition) -> set[int]:
        """Series of `mst` in shard `sh` matching the tag predicates of
        `condition`. Time predicates are ignored (SHOW filters series,
        not points); a predicate on a key that is no tag of the
        measurement matches nothing, as in the reference."""
        sids = sh.index.series_ids(mst)
        if condition is not None:
            tag_keys = set(sh.index.tag_keys(mst))
            sc = cond.split(condition, tag_keys, 0)
            if sc.has_row_filter:
                return set()
            if sc.tag_expr is not None:
                sids = sids & cond.eval_tag_expr(sc.tag_expr, sh.index, mst)
        return sids

    def _show_tag_keys(self, stmt, db) -> dict:
        db = stmt.database or db
        per_mst: dict[str, set] = {}
        for sh in self._all_shards_db(db):
            for mst in sh.measurements():
                if not self._mst_match(stmt, mst) or not self._visible(db, mst):
                    continue
                if stmt.condition is not None:
                    for sid in self._matching_sids(sh, mst, stmt.condition):
                        _, tags = sh.index.series_entry(sid)
                        per_mst.setdefault(mst, set()).update(
                            k for k, _ in tags)
                else:
                    per_mst.setdefault(mst, set()).update(
                        sh.index.tag_keys(mst))
        series = [
            _series(m, None, ["tagKey"], [[k] for k in sorted(keys)])
            for m, keys in sorted(per_mst.items())
            if keys
        ]
        return {"series": series} if series else {}

    @staticmethod
    def _split_value_predicates(expr):
        """Split a SHOW TAG VALUES condition into (series condition,
        [output-value predicates]): influx lets WHERE name the output
        `value` column. Only top-level AND conjuncts split; anything else
        stays a series condition."""
        preds: list = []

        def walk(e):
            if isinstance(e, ast.ParenExpr):
                return walk(e.expr)
            if isinstance(e, ast.BinaryExpr):
                if e.op.upper() == "AND":
                    lhs = walk(e.lhs)
                    rhs = walk(e.rhs)
                    if lhs is None:
                        return rhs
                    if rhs is None:
                        return lhs
                    return ast.BinaryExpr("AND", lhs, rhs)
                lv = e.lhs
                if isinstance(lv, ast.ParenExpr):
                    lv = lv.expr
                if (isinstance(lv, ast.VarRef) and lv.name == "value"
                        and e.op in ("=", "!=", "=~", "!~")
                        and isinstance(e.rhs,
                                       (ast.StringLiteral, ast.RegexLiteral))):
                    preds.append((e.op, e.rhs))
                    return None
            return e

        return walk(expr), preds

    @staticmethod
    def _value_pred_ok(v: str, preds) -> bool:
        for op, rhs in preds:
            if op == "=" and v != rhs.val:
                return False
            if op == "!=" and v == rhs.val:
                return False
            if op in ("=~", "!~"):
                hit = re.search(rhs.pattern, v) is not None
                if (op == "=~") != hit:
                    return False
        return True

    def _show_tag_values(self, stmt, db) -> dict:
        db = stmt.database or db
        key_rx = re.compile(stmt.key_regex) if stmt.key_regex else None
        series_cond, value_preds = self._split_value_predicates(
            stmt.condition)
        per_mst: dict[str, set] = {}
        for sh in self._all_shards_db(db):
            for mst in sh.measurements():
                if not self._mst_match(stmt, mst) or not self._visible(db, mst):
                    continue
                wanted = [
                    k for k in sh.index.tag_keys(mst)
                    if (k in stmt.keys)
                    or (key_rx is not None and key_rx.search(k))
                ]
                if not wanted:
                    continue
                if series_cond is None:
                    # no series filter: the inverted index answers
                    # directly, never a walk over the series
                    bucket = per_mst.setdefault(mst, set())
                    for k in wanted:
                        for v in sh.index.tag_values(mst, k):
                            bucket.add((k, v))
                    continue
                for sid in self._matching_sids(sh, mst, series_cond):
                    _, tags = sh.index.series_entry(sid)
                    for k, v in tags:
                        if k in wanted:
                            per_mst.setdefault(mst, set()).add((k, v))
        series = []
        for mst, pairs in sorted(per_mst.items()):
            if value_preds:
                pairs = {(k, v) for k, v in pairs
                         if self._value_pred_ok(v, value_preds)}
            uniq = sorted(pairs, reverse=stmt.order_desc)
            if stmt.offset:
                uniq = uniq[stmt.offset:]
            if stmt.limit:
                uniq = uniq[:stmt.limit]
            if uniq:
                series.append(_series(mst, None, ["key", "value"],
                                      [list(p) for p in uniq]))
        return {"series": series} if series else {}

    def _show_field_keys(self, stmt, db) -> dict:
        db = stmt.database or db
        per_mst: dict[str, dict] = {}
        for sh in self._all_shards_db(db):
            for mst in sh.measurements():
                if not self._mst_match(stmt, mst) or not self._visible(db, mst):
                    continue
                per_mst.setdefault(mst, {}).update(sh.schema(mst))
        type_names = {
            FieldType.FLOAT: "float",
            FieldType.INT: "integer",
            FieldType.BOOL: "boolean",
            FieldType.STRING: "string",
        }
        series = []
        for mst, sch in sorted(per_mst.items()):
            rows = [[k, type_names[t]] for k, t in sorted(sch.items())]
            series.append(_series(mst, None, ["fieldKey", "fieldType"], rows))
        return {"series": series} if series else {}

    def _show_series(self, stmt, db) -> dict:
        db = stmt.database or db
        keys: set[str] = set()
        for sh in self._all_shards_db(db):
            for mst in sh.measurements():
                if not self._mst_match(stmt, mst):
                    continue
                for sid in self._matching_sids(sh, mst, stmt.condition):
                    m, tags = sh.index.series_entry(sid)
                    keys.add(series_key(m, tags))
        if not keys:
            return {}
        return _series_result("", None, ["key"], [[k] for k in sorted(keys)])

    def _show_series_exact_cardinality(self, stmt, db) -> dict:
        """Per-measurement exact distinct-series count."""
        db = stmt.database or db
        per_mst: dict[str, set] = {}
        for sh in self._all_shards_db(db):
            for mst in sh.measurements():
                if not self._mst_match(stmt, mst):
                    continue
                bucket = per_mst.setdefault(mst, set())
                for sid in self._matching_sids(sh, mst, stmt.condition):
                    m, tags = sh.index.series_entry(sid)
                    bucket.add(series_key(m, tags))
        series = [
            _series(m, None, ["count"], [[len(keys)]])
            for m, keys in sorted(per_mst.items())
            if keys
        ]
        return {"series": series} if series else {}

    def _show_series_cardinality(self, stmt, db) -> dict:
        """One row per shard-group time range: startTime, endTime and the
        distinct series there."""
        by_range: dict[tuple[int, int], set] = {}
        for sh in self._all_shards_db(stmt.database or db):
            bucket = by_range.setdefault((sh.tmin, sh.tmax), set())
            for m, tags in sh.index.iter_series_entries():
                bucket.add(series_key(m, tags))
        rows = [
            [cond.format_rfc3339(lo), cond.format_rfc3339(hi), len(keys)]
            for (lo, hi), keys in sorted(by_range.items())
            if keys
        ]
        if not rows:
            return {}
        return _series_result("", None, ["startTime", "endTime", "count"],
                              rows)

    def _show_rps(self, stmt, db) -> dict:
        db = stmt.database or db
        d = self.engine.databases.get(db)
        if d is None:
            raise QueryError(f"database not found: {db}")
        rows = [
            [rp.name, _fmt_duration(rp.duration_ns),
             _fmt_duration(rp.shard_duration_ns), 1, rp.name == d.default_rp]
            for rp in d.rps.values()
        ]
        return _series_result(
            "", None,
            ["name", "duration", "shardGroupDuration", "replicaN", "default"],
            rows)

    def _show_shards(self) -> dict:
        rows = [
            [sdb, rp, start, sh.tmin, sh.tmax, sh.file_count(),
             "cold" if os.path.islink(sh.path) else "hot"]
            for (sdb, rp, start), sh in self.engine.shard_items()
        ]
        return _series_result(
            "shards", None,
            ["database", "retention_policy", "shard_group", "start_time",
             "end_time", "files", "tier"],
            rows)
