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
TTL checks); CREATE, SHOW and DROP SUBSCRIPTION (http(s) destinations
only; services/subscriber.py forwards the writes) and MODEL (CREATE
MODEL fits services/castor.py's detector on its SELECT's values and
keeps it in the engine's model store; ``detect(field, '<model>')``
scores against it).

CREATE, DROP and SET PASSWORD of users, GRANT, REVOKE, SHOW USERS and
SHOW GRANTS act on the executor's ``users`` (meta/users.py); SHOW
CLUSTER lists the meta members and the data nodes with the router's
failure view. Clustered (``meta_store`` set), the database, retention
policy, CQ, stream, subscription, downsample, model and user DDL is
proposed through the raft meta store on its leader (``_replicate_ddl``,
``_user_ddl``; a follower answers "not the meta leader") and reaches
each node's engine through the store's listener; single-node it is the
local call. SHOW STATS lists every statistics module (utils/stats.py)
as a series of (statistic, value) rows; SHOW DIAGNOSTICS the system
(the reference's rows, with ``torch`` where it has ``jax`` and the
engine's device type as ``backend``) and, with strict replication, its
groups. UNION statements run through query/join.py's
``execute_union``.
"""

from __future__ import annotations

import os
import re

import numpy as np

from opengemini_tpu_torch.ingest.line_protocol import series_key
from opengemini_tpu_torch.meta.users import AuthError, UserStore
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.query.qhelpers import (
    NS, QueryError, _fmt_duration, _series, _series_result,
)
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.services import castor
from opengemini_tpu_torch.services.stream import validate_stream_select
from opengemini_tpu_torch.services.subscriber import Subscription
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.storage.engine import (
    ContinuousQuery, DownsamplePolicy, StreamTask, _auto_shard_duration,
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

    # -- the meta plane ------------------------------------------------------

    def _replicate_ddl(self, cmd: dict) -> bool:
        """Propose a DDL command through the raft meta store when
        clustered: True when proposed and applied (the engine change
        arrives through the store's listener), False single-node (the
        caller makes the local call). A follower raises."""
        if self.meta_store is None:
            return False
        self._require_leader()
        if not self.meta_store.propose_and_wait(cmd):
            raise QueryError("meta proposal failed (no quorum?)")
        return True

    def _check_fsm_db(self, name: str) -> None:
        """Clustered: the leader's FSM must hold the database before a
        db-scoped command is proposed (the FSM ignores an unknown one).
        Leadership first: a lagging follower redirects, never answers
        "not found" from its stale FSM."""
        if self.meta_store is None:
            return
        self._require_leader()
        if name not in self.meta_store.fsm.databases:
            raise QueryError(f"database not found: {name}")

    def _require_leader(self) -> None:
        if self.meta_store is not None and not self.meta_store.is_leader():
            leader = self.meta_store.leader_hint() or "unknown"
            raise QueryError(
                f"not the meta leader; retry against node {leader!r}")

    def _require_user(self, name: str) -> None:
        if name not in self.users.users:
            raise AuthError(f"user not found: {name}")

    def _user_ddl(self, validate_fn, cmd_fn) -> bool:
        """Replicated user DDL: leadership first, then validation and the
        proposal under one lock (check-then-propose across HTTP threads
        would overwrite credentials). False single-node."""
        if self.meta_store is None:
            return False
        with self._user_ddl_lock:
            self._require_leader()
            validate_fn()
            if not self.meta_store.propose_and_wait(cmd_fn()):
                raise QueryError("meta proposal failed (no quorum?)")
        return True

    def _show_cluster(self) -> dict:
        """SHOW CLUSTER: the meta members (leader or follower) and the
        registered data nodes with the router's failure view (the quorum
        view over the local probe)."""
        rows = []
        if self.meta_store is None:
            rows.append(["local", "", "meta,data", "leader", ""])
        else:
            leader = self.meta_store.leader_hint()
            members = self.meta_store.meta_members()
            for nid in sorted(members):
                status = "leader" if nid == leader else "follower"
                rows.append([nid, members[nid], "meta", status, ""])
            router = self.router
            health = getattr(router, "health", {}) if router else {}
            shared = getattr(router, "shared_health", {}) if router else {}
            down_since = getattr(router, "down_since", {}) if router else {}
            for nid, info in sorted(self.meta_store.fsm.nodes.items()):
                status = "registered"
                if nid in shared:
                    status = "up" if shared[nid] else "down"
                elif nid in health:
                    status = "up" if health[nid] else "down"
                since = down_since.get(nid)
                rows.append([nid, info.get("addr", ""),
                             info.get("role", "data"), status,
                             cond.format_rfc3339(int(since * 1e9))
                             if since else ""])
        return {"series": [_series(
            "cluster", None, ["id", "addr", "role", "status", "down_since"],
            rows)]}

    def _user_statement(self, stmt) -> dict:
        """CREATE/DROP USER, SET PASSWORD, GRANT, REVOKE, SHOW USERS and
        SHOW GRANTS (credentials hashed at the proposal, so a snapshot
        rebuilds every replica's store)."""
        if isinstance(stmt, ast.CreateUser):
            def _validate_create():
                if stmt.name in self.users.users:
                    raise AuthError(f"user already exists: {stmt.name}")

            def _cmd_create():
                salt, pw_hash = UserStore.make_credentials(stmt.password)
                return {"op": "create_user", "name": stmt.name,
                        "salt": salt, "hash": pw_hash, "admin": stmt.admin}

            if not self._user_ddl(_validate_create, _cmd_create):
                self.users.create(stmt.name, stmt.password, stmt.admin)
            return {}
        if isinstance(stmt, ast.DropUser):
            if not self._user_ddl(
                    lambda: self._require_user(stmt.name),
                    lambda: {"op": "drop_user", "name": stmt.name}):
                self.users.drop(stmt.name)
            return {}
        if isinstance(stmt, ast.SetPassword):
            def _cmd_setpw():
                salt, pw_hash = UserStore.make_credentials(stmt.password)
                return {"op": "set_password", "name": stmt.name,
                        "salt": salt, "hash": pw_hash}

            if not self._user_ddl(lambda: self._require_user(stmt.name),
                                  _cmd_setpw):
                self.users.set_password(stmt.name, stmt.password)
            return {}
        if isinstance(stmt, ast.GrantStatement):
            admin_grant = not stmt.database and stmt.privilege == "ALL"
            cmd = ({"op": "grant_admin", "user": stmt.user, "admin": True}
                   if admin_grant
                   else {"op": "grant", "user": stmt.user,
                         "db": stmt.database, "privilege": stmt.privilege})
            if not self._user_ddl(lambda: self._require_user(stmt.user),
                                  lambda: cmd):
                if admin_grant:
                    self.users.grant_admin(stmt.user)
                else:
                    self.users.grant(stmt.user, stmt.database,
                                     stmt.privilege)
            return {}
        if isinstance(stmt, ast.RevokeStatement):
            admin_revoke = not stmt.database and stmt.privilege == "ALL"
            cmd = ({"op": "grant_admin", "user": stmt.user, "admin": False}
                   if admin_revoke
                   else {"op": "revoke", "user": stmt.user,
                         "db": stmt.database})
            if not self._user_ddl(lambda: self._require_user(stmt.user),
                                  lambda: cmd):
                if admin_revoke:
                    self.users.grant_admin(stmt.user, admin=False)
                else:
                    self.users.revoke(stmt.user, stmt.database)
            return {}
        if isinstance(stmt, ast.ShowUsers):
            rows = [[u.name, u.admin] for u in self.users.users.values()]
            return _series_result("", None, ["user", "admin"], sorted(rows))
        u = self.users.users.get(stmt.user)  # ShowGrants
        if u is None:
            raise QueryError(f"user not found: {stmt.user}")
        rows = [[db_, p] for db_, p in sorted(u.privileges.items())]
        return _series_result("", None, ["database", "privilege"], rows)

    def execute_statement(self, stmt, db: str, now_ns: int,
                          user=None) -> dict:
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
                return self._show(stmt, db, user)
        if isinstance(stmt, ast.CreateMeasurement):
            return {}  # schema-on-write engine: accept and record nothing
        if isinstance(stmt, ast.CreateDatabase):
            if not self._replicate_ddl({"op": "create_database",
                                        "name": stmt.name}):
                self.engine.create_database(stmt.name)
            if stmt.has_rp_clause:
                rp_name = stmt.rp_name or "autogen"
                cmd = {"op": "create_rp", "db": stmt.name, "name": rp_name,
                       "duration_ns": stmt.duration_ns,
                       "shard_duration_ns": stmt.shard_duration_ns,
                       "default": True}
                if not self._replicate_ddl(cmd):
                    self.engine.create_retention_policy(
                        stmt.name, rp_name, stmt.duration_ns,
                        stmt.shard_duration_ns, default=True)
            return {}
        if isinstance(stmt, ast.DropDatabase):
            if not self._replicate_ddl({"op": "drop_database",
                                        "name": stmt.name}):
                self.engine.drop_database(stmt.name)
            return {}
        if isinstance(stmt, ast.CreateRetentionPolicy):
            tgt = stmt.database or db
            self._check_fsm_db(tgt)
            _check_rp_min_duration(stmt.duration_ns)
            cmd = {"op": "create_rp", "db": tgt, "name": stmt.name,
                   "duration_ns": stmt.duration_ns,
                   "shard_duration_ns": stmt.shard_duration_ns,
                   "default": stmt.default}
            if not self._replicate_ddl(cmd):
                self.engine.create_retention_policy(
                    tgt, stmt.name, stmt.duration_ns, stmt.shard_duration_ns,
                    stmt.default)
            return {}
        if isinstance(stmt, ast.AlterRetentionPolicy):
            tgt = stmt.database or db
            self._check_fsm_db(tgt)
            _check_rp_min_duration(stmt.duration_ns)
            if self.meta_store is not None:
                self._check_fsm_alter(tgt, stmt)
            cmd = {"op": "alter_rp", "db": tgt, "name": stmt.name,
                   "duration_ns": stmt.duration_ns,
                   "shard_duration_ns": stmt.shard_duration_ns,
                   "default": stmt.default}
            if not self._replicate_ddl(cmd):
                try:
                    self.engine.alter_retention_policy(
                        tgt, stmt.name, stmt.duration_ns,
                        stmt.shard_duration_ns, stmt.default)
                except ValueError as e:
                    raise QueryError(str(e)) from None
            return {}
        if isinstance(stmt, ast.DropRetentionPolicy):
            cmd = {"op": "drop_rp", "db": stmt.database or db,
                   "name": stmt.name}
            if not self._replicate_ddl(cmd):
                self.engine.drop_retention_policy(stmt.database or db,
                                                  stmt.name)
            return {}
        if isinstance(stmt, (ast.CreateUser, ast.DropUser, ast.SetPassword,
                             ast.GrantStatement, ast.RevokeStatement,
                             ast.ShowUsers, ast.ShowGrants)):
            return self._user_statement(stmt)
        if isinstance(stmt, ast.ShowCluster):
            return self._show_cluster()
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
            self._check_fsm_db(tgt)
            cq = ContinuousQuery(stmt.name, stmt.select_text,
                                 stmt.resample_every_ns,
                                 stmt.resample_for_ns)
            if not self._replicate_ddl({"op": "create_cq", "db": tgt,
                                        "cq": cq.to_json()}):
                self.engine.create_continuous_query(tgt, cq)
            return {}
        if isinstance(stmt, ast.DropContinuousQuery):
            tgt = stmt.database or db
            if not self._replicate_ddl({"op": "drop_cq", "db": tgt,
                                        "name": stmt.name}):
                self.engine.drop_continuous_query(tgt, stmt.name)
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
            self._check_fsm_db(db)
            task = StreamTask(stmt.name, stmt.select_text, stmt.delay_ns)
            if not self._replicate_ddl({"op": "create_stream", "db": db,
                                        "task": task.to_json()}):
                self.engine.create_stream(db, task)
            return {}
        if isinstance(stmt, ast.DropStream):
            if not self._replicate_ddl({"op": "drop_stream", "db": db,
                                        "name": stmt.name}):
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
            tgt = stmt.database or db
            cmd = {"op": "drop_downsample", "db": tgt, "rp": stmt.rp or None}
            if not self._replicate_ddl(cmd):
                self.engine.drop_downsample_policies(tgt, stmt.rp or None)
            return {}
        if isinstance(stmt, ast.ShowDownsamples):
            return self._show_downsamples(stmt, db)
        if isinstance(stmt, ast.CreateSubscription):
            if not stmt.destinations:
                raise QueryError(
                    "subscription requires at least one destination")
            for dest in stmt.destinations:
                if not dest.startswith(("http://", "https://")):
                    raise QueryError(
                        "subscription destination must be an http(s) "
                        f"URL: {dest!r}")
            tgt = stmt.database or db
            self._check_fsm_db(tgt)
            sub = Subscription(stmt.name, stmt.mode, stmt.destinations)
            if not self._replicate_ddl({"op": "create_subscription",
                                        "db": tgt, "sub": sub.to_json()}):
                self.engine.create_subscription(tgt, sub)
            return {}
        if isinstance(stmt, ast.DropSubscription):
            tgt = stmt.database or db
            if not self._replicate_ddl({"op": "drop_subscription", "db": tgt,
                                        "name": stmt.name}):
                self.engine.drop_subscription(tgt, stmt.name)
            return {}
        if isinstance(stmt, ast.ShowSubscriptions):
            series = []
            for name in sorted(self.engine.databases):
                d = self.engine.databases[name]
                rows = [[s.name, s.mode, ", ".join(s.destinations)]
                        for s in d.subscriptions.values()]
                series.append(_series(name, None,
                                      ["name", "mode", "destinations"], rows))
            return {"series": series} if series else {}
        if isinstance(stmt, (ast.CreateModel, ast.ShowModels, ast.DropModel)):
            return self._model_ddl(stmt, db, now_ns)
        if isinstance(stmt, ast.ShowStats):
            series = []
            for module, vals in sorted(STATS.snapshot().items()):
                rows = [[k, v] for k, v in sorted(vals.items())]
                series.append(_series(module, None, ["statistic", "value"],
                                      rows))
            return {"series": series} if series else {}
        if isinstance(stmt, ast.ShowDiagnostics):
            return self._show_diagnostics()
        raise QueryError(f"unsupported statement: {type(stmt).__name__}")

    def _show_diagnostics(self) -> dict:
        import platform
        import sys as _sys

        from opengemini_tpu_torch import __version__
        from opengemini_tpu_torch.device import runtime_rows

        rows = [
            ["version", __version__],
            ["python", _sys.version.split()[0]],
            *runtime_rows(self.engine.device),
            ["platform", platform.platform()],
            ["data_dir", self.engine.root],
        ]
        out = [_series("system", None, ["name", "value"], rows)]
        router = getattr(self, "router", None)
        dr = getattr(router, "datarep", None) if router else None
        if dr is not None:
            grows = dr.group_status()
            out.append(_series(
                "replication_groups", None,
                ["group", "members", "state", "leader", "log_len",
                 "applied"], grows or [["(none yet)", "", "", "", 0, 0]]))
        return {"series": out}

    def _model_ddl(self, stmt, db: str, now_ns: int) -> dict:
        """CREATE MODEL fits a detector on its SELECT's numeric values
        (services/castor.py ``fit``) and saves the artifact; SHOW MODELS
        lists them; DROP MODEL removes one."""
        if isinstance(stmt, ast.CreateModel):
            if stmt.name.lower() in castor.ALGORITHMS:
                raise QueryError(
                    f"model name {stmt.name!r} shadows a built-in algorithm")
            if stmt.name.lower() in castor._UDFS:
                raise QueryError(
                    f"model name {stmt.name!r} shadows a loaded UDF")
            if (not stmt.name or "/" in stmt.name
                    or stmt.name.startswith(".")):
                raise QueryError(f"bad model name {stmt.name!r}")
            res = self._select(stmt.select, db, now_ns)
            vals: list[float] = []
            for series in res.get("series", []):
                for row in series.get("values", []):
                    for v in row[1:]:
                        if isinstance(v, (int, float)) and not isinstance(
                                v, bool):
                            vals.append(float(v))
            try:
                doc = castor.fit(stmt.algorithm, np.asarray(vals),
                                 stmt.threshold)
            except ValueError as e:
                raise QueryError(str(e)) from e
            doc["name"] = stmt.name
            doc["source"] = stmt.select_text
            # clustered, the fitted artifact replicates like other DDL
            if not self._replicate_ddl(
                    {"op": "save_model", "name": stmt.name, "doc": doc}):
                self.engine.models.save(stmt.name, doc)
            return {}
        if isinstance(stmt, ast.ShowModels):
            rows = []
            for name in self.engine.models.names():
                m = self.engine.models.get(name) or {}
                rows.append([
                    name, m.get("algorithm", ""), m.get("threshold"),
                    m.get("trained_rows", 0),
                    cond.format_rfc3339(int(m.get("fitted_at", 0)) * NS),
                ])
            if not rows:
                return {}
            return _series_result(
                "models", None,
                ["name", "algorithm", "threshold", "trainedRows", "fittedAt"],
                rows)
        if stmt.name not in self.engine.models.names():
            raise QueryError(f"model not found: {stmt.name}")
        if not self._replicate_ddl({"op": "drop_model", "name": stmt.name}):
            self.engine.models.drop(stmt.name)
        return {}

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
        self._check_fsm_db(tgt)
        if self.meta_store is not None:
            fsm_db = self.meta_store.fsm.databases[tgt]
            if stmt.rp not in fsm_db.get("rps", {}):
                raise QueryError(
                    f"retention policy not found: {tgt}.{stmt.rp}")
            if stmt.rp in fsm_db.get("downsample", {}):
                raise QueryError(
                    f"downsample already exists on {tgt}.{stmt.rp}")
            d = None
        else:
            d = self.engine.databases.get(tgt)
            if d is None:
                raise QueryError(f"database not found: {tgt}")
            if stmt.rp not in d.rps:
                raise QueryError(
                    f"retention policy not found: {tgt}.{stmt.rp}")
        if d is not None and d.downsample.get(stmt.rp):
            raise QueryError(f"downsample already exists on {tgt}.{stmt.rp}")
        policies = [
            DownsamplePolicy(samples[i], times[i], dict(stmt.type_aggs))
            for i in range(len(samples))
        ]
        cmd = {"op": "add_downsample", "db": tgt, "rp": stmt.rp,
               "ttl_ns": stmt.ttl_ns,
               "policies": [p.to_json() for p in policies]}
        if not self._replicate_ddl(cmd):
            self.engine.set_downsample_policies(tgt, stmt.rp, policies,
                                                ttl_ns=stmt.ttl_ns)
        return {}

    def _check_fsm_alter(self, tgt: str, stmt) -> None:
        """Clustered ALTER RETENTION POLICY: validate against the FSM
        before proposing (a bad alter would apply as a silent no-op)."""
        fsm_db = self.meta_store.fsm.databases[tgt]
        rp = fsm_db.get("rps", {}).get(stmt.name)
        if rp is None:
            raise QueryError(f"retention policy not found: {stmt.name}")
        cur_dur = rp.get("duration_ns", 0)
        new_dur = cur_dur if stmt.duration_ns is None else stmt.duration_ns
        new_sd = stmt.shard_duration_ns
        if new_sd is None:
            # the FSM keeps None when CREATE RP had no SHARD DURATION: the
            # engine computed one, mirrored here
            new_sd = rp.get("shard_duration_ns") or _auto_shard_duration(
                cur_dur)
        elif not new_sd:  # an explicit 0 recomputes the layout
            new_sd = _auto_shard_duration(new_dur)
        if new_dur and new_dur < new_sd:
            raise QueryError("retention policy duration must be greater "
                             "than the shard duration")

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

    def _show(self, stmt, db: str, user=None) -> dict:
        if isinstance(stmt, ast.ShowDatabases):
            names = self.engine.database_names()
            if self.auth_enabled and user is not None and not user.admin:
                names = [n for n in names if user.privileges.get(n)]
            return _series_result("databases", None, ["name"],
                                  [[n] for n in names])
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
        if self.router is not None:
            try:
                names.update(self.router.remote_measurements(db, None))
            except Exception as e:  # noqa: BLE001
                raise QueryError(str(e)) from e
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
