"""Statement executor: AST -> scan -> device reduce -> InfluxDB JSON rows.

The port of ``opengemini_tpu/query/executor.py``: ``execute`` ->
``execute_statement`` (query/showddl.py, with the SHOW and DDL
statements) -> ``_select`` -> ``_select_measurement``, which sends each
SELECT down the path ``qhelpers._classify_select`` names: the raw
projection and the host functions (query/hostpath.py, numpy on the
host), or the device aggregates (``_scan_context`` -> ``_select_agg_run``
-> ``_scan_monolithic`` -> ``_render_agg``, with ``pick_batch`` routing
exactly as the JAX package does). ``compare()``, several sources of a
raw select (one merged series), constant columns and aggregates over
``time`` run as in the reference. EXPLAIN names the same path.
Subqueries (``FROM (SELECT ...)``, query/subquery.py), CTEs (``WITH``),
``IN (SELECT ...)``, SELECT INTO and aggregates over several sources (a
``SELECT *`` subquery over all of them) run as in the reference, and so
do joins and unions (query/join.py).

A GROUP BY time() aggregate goes through the incremental result cache
(query/resultcache.py: windows whose shards took no write since they
were cached are served from it, and only the stale windows are scanned;
``OGT_RESULT_CACHE=0`` turns it off, read at query time). A scan whose
chunk metadata estimates ``SLICE_THRESHOLD_ROWS`` rows or more runs in
window-aligned slices (``_scan_sliced``): each slice decodes into its
own batches, runs its kernels and frees its device buffers before the
next slice decodes, and the slices' windows are placed into one answer
(``_stitch_sliced``: each window is computed in one slice only, so the
answer is the single scan's; a mean or stddev sums in its slice batch's
shape and may differ from it in the last bits). A whole-range
count/sum/mean without a field filter takes the pre-aggregation path
(``_scan_preagg``): a series whose chunks lie inside the range and need
no merge adds their stored counts and sums without a decode, and the
other series take the bulk decode of any scan. Every scan
unit and device batch dispatch is a KILL QUERY cancellation point
(utils/querytracker.py). Without GROUP BY time, the conjunctive
``match()`` terms of the WHERE prune the series through the shards'
text sidecars (qhelpers ``_prune_text_sids``). A scan that meets a
damaged file fails as a statement error (``FileQuarantined``; the file
is quarantined, and a retry answers from the others).

Every query takes an admission slot from the resource governor
(utils/governor.py ``admit``; ``AdmissionRejected`` propagates, and
/query answers it with 503) and, governed, reserves its scan's estimated
bytes (qhelpers ``estimate_scan_bytes``); a finished query is noted in
the slow log (utils/slowlog.py). Both are pass-through while the
governor and the slow log are off. A GROUP BY time() aggregate over a
declared rollup is spliced (query/rollupplan.py, a ``rollup`` span and
stage): its clean windows below the watermark come from rollup rows,
inside the result cache's stale set, and only the rest is scanned.

Clustered (``Executor.router``, a parallel/cluster.py ``DataRouter``),
the shard list is the local one plus the peers': an aggregate whose
calls all merge (query/partials.py ``MERGEABLE`` and
``MULTISET_MERGEABLE``) pushes down, each peer computing its
per-(group, window) partials on its own device (``select_meta`` then
``select_partials``, merged under a ``remote_partials`` span), retried
against a fresh live set when a peer dies between the two rounds and
taken by the raw column exchange when a peer cannot serve partials;
everything else reads the peers' columns over /internal/scan
(``RemoteShard``) and aggregates here. With a replication factor above
1 each shard group is read once, from its primary among the live nodes.
The result cache, the rollup splice, the device tier and slices stay
local-only. With ``auth_enabled`` every statement is authorized against
``users`` (meta/users.py; ``_authorize``), and DDL replicates through
``meta_store`` (meta/service.py) when one is set.

Every stage of an aggregate SELECT runs in a span (utils/tracing.py):
``select: <mst>`` around ``map_shards`` (shard mapping and series
groups), ``scan`` (reads into the batches), ``colcache`` (the
decoded-column cache's counter deltas over the scan, when the cache is
on), ``device_compute`` (batch freeze, transfers, kernels and the copy
back; on a CUDA device it ends with a synchronize, so the device time
lands here and not in the next stage; with devobs armed it carries the
span's compiles, transfer bytes and compile wall) and ``render`` (the
JSON rows). A SELECT or EXPLAIN while the engine's reads are switched
off (``read_disabled``, /debug/ctrl?mod=disableread) answers the
statement error "reads are disabled (syscontrol)".
Their times reach ``/debug/vars`` ``query_stages`` for every query, with
stages that no span draws: ``request`` (the HTTP request's headers and
parameters, in server/http.py), ``parse`` (the SQL text, here), ``plan``
(an aggregate's batches, cache, rollup and slice plans between
``map_shards`` and ``scan``) and ``encode`` (the answer's JSON, in
server/http.py). EXPLAIN ANALYZE renders the span tree of one query.

The device comes from the engine (``Engine(root, device=...)``) and is
passed explicitly through ``pick_batch`` to every batch.

Results use the influx wire shape:
    {"results": [{"statement_id": 0, "series": [
        {"name": ..., "tags": {...}, "columns": [...], "values": [[...]]}]}]}
Times in values are int ns; the HTTP layer formats RFC3339/epoch.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import re
import threading
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from opengemini_tpu_torch.meta.users import AuthError as _AuthError
from opengemini_tpu_torch.meta.users import UserStore
from opengemini_tpu_torch.models import grid as _grid
from opengemini_tpu_torch.models import ragged, templates
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.parallel import cluster as pcluster
from opengemini_tpu_torch.parallel import runtime
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.query.hostpath import HostPathMixin
from opengemini_tpu_torch.query.qhelpers import (
    MAX_SELECT_BUCKETS, NS, QueryError, _add_record_to_batches, _apply_fill,
    _call_param_value, _calls_in, _classify_select,
    _data_time_range, _default_field_name, _eval_output_expr,
    _expand_call_wildcards, _has_call_wildcard, _has_in_subquery,
    _merge_multi_source, _needs_string_host_path, _prune_text_sids,
    _resolve_call, _selector_aux_plan,
    _series_needs_merged_decode, _series_result, _strip_expr,
    estimate_scan_bytes,
)
from opengemini_tpu_torch.query import resultcache as rcache
from opengemini_tpu_torch.query import rollupplan as rplan
from opengemini_tpu_torch.query import tablefunc as tfmod
from opengemini_tpu_torch.query.showddl import ShowDdlMixin
from opengemini_tpu_torch.query.subquery import SubqueryMixin
from opengemini_tpu_torch.record import (
    EncodedColumn, FieldType, FieldTypeConflict, concat_encoded_columns)
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.sql.parser import parse
from opengemini_tpu_torch.storage import colcache as colcache_mod
from opengemini_tpu_torch.storage.engine import WriteError
from opengemini_tpu_torch.storage.shard import FileQuarantined
from opengemini_tpu_torch.storage.tsf import CorruptFile
from opengemini_tpu_torch.utils import devobs, tracing
from opengemini_tpu_torch.utils.governor import GOVERNOR
from opengemini_tpu_torch.utils.slowlog import GLOBAL as SLOWLOG
from opengemini_tpu_torch.utils.querytracker import (
    GLOBAL as TRACKER, QueryKilled, redact as _redact)
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


@dataclass
class ScanContext:
    """Output of the shared select prologue (_scan_context)."""

    sc: object
    shards: list
    tmin: int
    tmax: int
    schema: dict
    tag_keys: set
    group_time: object
    aligned: int
    W: int
    group_tags: list
    group_keys: list
    scan_plan: list
    live: list | None = None  # the cluster's live set, pinned by the peers


# sliced-scan tuning: slice when the estimated scan exceeds this many
# rows; each slice targets this many rows (bounds the dense grid well
# under the grid's cell cap). The environment names are the JAX
# package's, so both packages slice alike under one environment.
SLICE_THRESHOLD_ROWS = int(os.environ.get("OGTPU_SLICE_THRESHOLD", "0")) \
    or 24_000_000
SLICE_TARGET_ROWS = int(os.environ.get("OGTPU_SLICE_TARGET", "0")) \
    or 2_000_000


def _plan_scan_slices(shards, mst, scan_plan, aligned, every_ns, W,
                      tmin, tmax):
    """Window-aligned slice plan [(w0, W_s, lo, hi)] covering
    [tmin, tmax), or None when the scan is small enough to run in one
    pass. Row counts come from chunk metadata (no decode): a chunk that
    straddles the range counts whole, so a packed chunk holding its
    series' whole span counts every row of it."""
    total_rows = 0
    total_chunks = 0
    for sh in shards:
        r, c = sh.approx_rows(mst, tmin, tmax)
        total_rows += r
        total_chunks += c
    if total_rows < SLICE_THRESHOLD_ROWS:
        return None
    rows_per_window = max(total_rows // W, 1)
    # plain target-based width: the decoded-column cache's host tier
    # amortizes adjacent slices' re-decodes of a straddling chunk, while
    # wider slices pay grid assembly and merge costs
    W_s = max(int(SLICE_TARGET_ROWS // rows_per_window), 1)
    if W_s >= W:
        return None
    n_slices = -(-W // W_s)
    if total_chunks * n_slices > max(total_rows // 64, 65536):
        # every slice re-sweeps the chunk metadata: with many tiny
        # chunks that sweep would dominate the decode it saves
        return None
    plan = []
    w0 = 0
    while w0 < W:
        ws = min(W_s, W - w0)
        lo = aligned + w0 * every_ns
        hi = aligned + (w0 + ws) * every_ns
        plan.append((w0, ws, max(lo, tmin), min(hi, tmax)))
        w0 += ws
    return plan


def _stitch_sliced(sliced_out, call, num_groups, W, num_segments):
    """Combine the per-slice outputs of one aggregate into the global
    segment arrays. Window-aligned slices make every (group, window)
    segment live in exactly one slice, so stitching is pure placement —
    no cross-slice combine for ANY per-window aggregate. sel is not
    stitched: selector timestamps are only consulted without GROUP BY
    time(), and slicing requires GROUP BY time()."""
    out = counts = None
    for w0, W_s, outs, _info in sliced_out:
        got = outs.get(id(call))
        if got is None:
            continue  # the slice had no rows of this field
        o, c = got
        if out is None:
            out = np.zeros(num_segments, dtype=o.dtype)
            counts = np.zeros(num_segments, dtype=c.dtype)
        out.reshape(num_groups, W)[:, w0:w0 + W_s] = \
            o.reshape(num_groups, W_s)
        counts.reshape(num_groups, W)[:, w0:w0 + W_s] = \
            c.reshape(num_groups, W_s)
    if out is None:
        out = np.zeros(num_segments, dtype=np.float64)
        counts = np.zeros(num_segments, dtype=np.int64)
    return out, None, counts


def _device_scan_token(db, rp, mst, sc, group_time, group_tags, all_tags,
                       tmin, tmax, aligned, W, dtype, scan_ranges, shards):
    """Scan signature for the decoded-column cache's device tier: all
    that determines a GridBatch's assembled (values, mask) grids — the
    statement's non-time shape, the resolved time geometry, the scanned
    ranges and every shard's (path, data_version). data_version moves
    on every write, not on flush or compaction, whose merged reads are
    bit-identical. The condition subtrees enter by their dataclass
    repr, which is deterministic."""
    sigs = sorted((sh.path, sh.data_version) for sh in shards)
    return repr((
        db, rp or "", mst, repr(sc.tag_expr), repr(sc.field_expr),
        repr(sc.mixed_expr), bool(sc.mixed_series_level),
        group_time.every_ns, group_time.offset_ns, list(group_tags),
        bool(all_tags), tmin, tmax, aligned, W, str(dtype),
        [list(r) for r in scan_ranges], sigs,
    ))


def pick_batch(schema, agg_names, field: str, dtype, device, grid_ctx=None):
    """Batch implementation for one field given the aggregate names that
    will run on it, on `device`. With a GROUP BY time() context
    (`grid_ctx` = (W, every_ns)), dense-capable aggregates try the
    regular-grid batch first (models/grid.py, with its own fallback when
    the data is not constant-stride); otherwise they use the bucketed
    batch (models/ragged.py); rank-based ones (percentile/median/
    count_distinct) keep the scatter AggBatch. Int sum/mean stay exact on
    the host (IntExactBatch)."""
    if (
        schema.get(field) == FieldType.INT
        and all(n in ragged.INT_EXACT_AGGS for n in agg_names)
        and any(n in ("sum", "mean") for n in agg_names)
    ):
        return ragged.IntExactBatch()
    if (
        grid_ctx is not None
        and schema.get(field) in (FieldType.FLOAT, FieldType.INT)
        and all(n in _grid.GRID_AGGS for n in agg_names)
    ):
        return _grid.GridBatch(dtype, grid_ctx[0], grid_ctx[1], device)
    if all(n in ragged.DENSE_AGGS for n in agg_names):
        return ragged.BucketedBatch(dtype, device)
    return templates.AggBatch(dtype, device)


_READONLY_STMTS = (
    ast.SelectStatement,
    ast.UnionStatement,
    ast.ShowDatabases,
    ast.ShowMeasurements,
    ast.ShowTagKeys,
    ast.ShowTagValues,
    ast.ShowFieldKeys,
    ast.ShowSeries,
    ast.ShowRetentionPolicies,
    ast.ShowContinuousQueries,
    ast.ShowUsers,
    ast.ShowGrants,
    ast.ShowMeasurementCardinality,
    ast.ShowSeriesCardinality,
    ast.ShowSeriesExactCardinality,
    ast.ShowShards,
    ast.ShowStats,
    ast.ShowDiagnostics,
    ast.ShowStreams,
    ast.ShowSubscriptions,
    ast.ShowQueries,
    ast.ShowModels,
)


def _is_readonly(stmt) -> bool:
    """May `stmt` run from a GET? SELECT without INTO, EXPLAIN of one,
    and the SHOW statements (influx 1.x requires POST for the rest)."""
    if isinstance(stmt, ast.ExplainStatement):
        # EXPLAIN ANALYZE executes the inner select: INTO would mutate
        return stmt.select is None or stmt.select.into is None
    if not isinstance(stmt, _READONLY_STMTS):
        return False
    return not (isinstance(stmt, ast.SelectStatement)
                and stmt.into is not None)


class _ScanStager:
    """Batched column materialization for the per-series scan tail:
    accumulates per-record column views and flushes ONE contiguous array
    set per field, preserving the row order of the serial path. Record
    boundaries are forwarded to batches that want them (GridBatch run
    detection)."""

    def __init__(self, needed_fields, dtype, batches, aligned,
                 time_segs=None, time_vals=None):
        self.needed_fields = needed_fields
        self.dtype = dtype
        self.batches = batches
        self.aligned = aligned
        # aggregates over `time`: the rows' segments and times, kept
        # when the caller passes lists for them
        self.time_segs = time_segs
        self.time_vals = time_vals
        self._recs: list[tuple] = []  # [(times, seg, sid)]
        self._per_field: dict[str, list] = {f: [] for f in needed_fields}

    def add(self, rec, seg, fmask, sid):
        if self.time_segs is not None:
            m = fmask if fmask is not None else slice(None)
            self.time_segs.append(seg[m])
            self.time_vals.append(rec.times[m])
        ri = len(self._recs)
        self._recs.append((rec.times, seg, sid))
        for fname in self.needed_fields:
            col = rec.columns.get(fname)
            if col is None:
                continue
            m = col.valid if fmask is None else (col.valid & fmask)
            if col.ftype == FieldType.STRING:
                vals = None  # count-only payload: zeros at flush
            elif (isinstance(col, EncodedColumn)
                    and hasattr(self.batches[fname], "add_encoded")):
                # still-attached raw blocks: flush composes one encoded
                # column per field for the grid freeze to route
                vals = col
            else:
                vals = col.values
            self._per_field[fname].append((ri, vals, m))

    def _gather(self, rec_idx):
        times = np.concatenate([self._recs[i][0] for i in rec_idx])
        seg = np.concatenate([self._recs[i][1] for i in rec_idx])
        sids = np.concatenate([
            np.full(len(self._recs[i][0]), self._recs[i][2], np.int64)
            for i in rec_idx])
        lens = np.asarray(
            [len(self._recs[i][0]) for i in rec_idx], np.int64)
        return times, seg, sids, times - self.aligned, np.cumsum(lens)[:-1]

    def flush(self):
        shared = None
        all_idx = list(range(len(self._recs)))
        for fname, entries in self._per_field.items():
            if not entries:
                continue
            batch = self.batches[fname]
            rec_idx = [e[0] for e in entries]
            if rec_idx == all_idx:
                if shared is None:
                    shared = self._gather(all_idx)
                times, seg, sids, rel, bounds = shared
            else:
                times, seg, sids, rel, bounds = self._gather(rec_idx)
            mask = np.concatenate([e[2] for e in entries])
            if all(isinstance(v, EncodedColumn) for _ri, v, _m in entries):
                # every record kept its raw blocks: compose ONE encoded
                # row-run view for the whole flush (past the run cap it
                # takes the copying path below)
                merged = concat_encoded_columns(
                    [v for _ri, v, _m in entries], entries[0][1].ftype)
                if merged is not None:
                    batch.add_encoded(merged, rel, seg, mask, times,
                                      sids=sids, boundaries=bounds)
                    self._per_field[fname] = []
                    continue
            parts = [
                np.zeros(len(self._recs[ri][0]), dtype=self.dtype)
                if v is None
                else (v.values if isinstance(v, EncodedColumn) else v)
                for ri, v, _m in entries
            ]
            vals = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if not isinstance(batch, ragged.IntExactBatch):
                vals = vals.astype(self.dtype)
            if getattr(batch, "accepts_boundaries", False):
                batch.add(vals, rel, seg, mask, times, sids=sids,
                          boundaries=bounds)
            else:
                batch.add(vals, rel, seg, mask, times, sids=sids)
            self._per_field[fname] = []
        self._recs = []


class Executor(ShowDdlMixin, SubqueryMixin, HostPathMixin):
    def __init__(self, engine, users=None, auth_enabled: bool = False,
                 meta_store=None):
        self.engine = engine
        self.device = engine.device
        self.users = users if users is not None else UserStore(
            os.path.join(engine.root, "users.json"))
        self.auth_enabled = auth_enabled
        # clustered: database, RP and user DDL replicates through raft
        self.meta_store = meta_store
        # the cluster's data plane (parallel/cluster.DataRouter), or None
        self.router = None
        # leader-side user DDL: check-then-propose must not race across
        # HTTP threads (a second CREATE USER would replace credentials)
        self._user_ddl_lock = lockdep.Lock()
        # incremental GROUP BY time() result cache (query/resultcache.py)
        self._inc_cache = rcache.IncrementalCache()
        # per-thread stack of the CTE names being expanded (cycle check)
        self._cte_state = threading.local()

    def execute(self, text: str, db: str = "", now_ns: int | None = None,
                read_only: bool = False, user=None) -> dict:
        """read_only=True (HTTP GET) rejects mutating statements. `user`
        is the authenticated user when auth is on (privilege checks)."""
        if now_ns is None:
            now_ns = _time.time_ns()
        t0 = _time.perf_counter_ns()
        try:
            stmts = parse(text)
        except ValueError as e:
            return {"results": [{"statement_id": 0,
                                 "error": f"error parsing query: {e}"}]}
        finally:
            # a query stage outside the statements' spans, as is
            # server/http.py's "encode"
            tracing.record_stage("parse", _time.perf_counter_ns() - t0)
        STATS.incr("executor", "queries")
        # admission control: may raise AdmissionRejected, which /query
        # answers with 503 and Retry-After (not a statement error).
        # t1 before admit(): a query that waited in the admission queue
        # is slow by that wait, and the slow log must see it
        t1 = _time.perf_counter_ns()
        token = GOVERNOR.admit()
        qid = None
        trace = None
        try:
            qid = TRACKER.register(text, db)
            if token.waited_ns:
                # the admission wait is a query stage like any other
                TRACKER.add_stage_ns(qid, "admission_wait", token.waited_ns)
                tracing.record_stage("admission_wait", token.waited_ns)
            if tracing.trace_enabled():
                # per-query span tree (OGT_TRACE=1), activated
                # thread-locally so _select adopts it, and bound to the
                # running query for /debug/queries and /debug/trace
                trace = tracing.Trace("query")
                trace.root.add_field("statement", _redact(text))
                trace.root.add_field("database", db)
                TRACKER.set_trace(qid, trace)
            # on a rank of a mesh across processes, one query's mesh
            # programs reach the collectives at a time
            with runtime.mesh_program(), (
                    tracing.activate(trace) if trace is not None
                    else contextlib.nullcontext()):
                return self._execute_statements(stmts, db, now_ns,
                                                read_only, user)
        finally:
            dur_ns = _time.perf_counter_ns() - t1
            if trace is not None:
                trace.finish()
                tracing.note_finished(qid, trace, {"database": db})
            if SLOWLOG.enabled():
                # before unregister: the stage map lives on the entry
                SLOWLOG.note(qid, text, db, dur_ns / 1e6, trace=trace,
                             stages=TRACKER.stages_of(qid))
            if qid is not None:
                TRACKER.unregister(qid)
            token.release()

    def _execute_statements(self, stmts, db: str, now_ns: int,
                            read_only: bool, user=None) -> dict:
        results = []
        for i, stmt in enumerate(stmts):
            try:
                # a killed query must not run its REMAINING statements
                # either (the next one might be destructive DDL)
                TRACKER.check()
                if read_only and not _is_readonly(stmt):
                    raise QueryError(
                        f"{type(stmt).__name__} queries must be sent via POST")
                if self.auth_enabled:
                    if len(self.users) == 0:
                        # bootstrap: only creating the first admin is open
                        if not (isinstance(stmt, ast.CreateUser)
                                and stmt.admin):
                            raise _AuthError(
                                "create an admin user first: CREATE USER "
                                "<name> WITH PASSWORD '<pw>' WITH ALL "
                                "PRIVILEGES")
                    else:
                        self._authorize(stmt, user, db)
                if self.engine.read_disabled and isinstance(
                        stmt, (ast.SelectStatement, ast.ExplainStatement)):
                    raise QueryError("reads are disabled (syscontrol)")
                res = self.execute_statement(stmt, db, now_ns, user=user)
            except (QueryError, cond.ConditionError, KeyError, ValueError,
                    re.error, FieldTypeConflict, WriteError,
                    QueryKilled, FileQuarantined) as e:
                # FileQuarantined too: the query that found the damage
                # fails as a statement error (the file is out of the read
                # set already; a retry answers without it). _AuthError is
                # not caught: it surfaces as HTTP 401/403
                res = {"error": str(e)}
            res["statement_id"] = i
            results.append(res)
        return {"results": results}

    def _authorize(self, stmt, user, db: str) -> None:
        """Privilege checks: READ for selects and SHOWs, WRITE for SELECT
        INTO, admin for DDL and user management; SET PASSWORD for
        oneself."""
        if user is None:
            raise _AuthError("authorization required")
        if user.admin:
            return
        if isinstance(stmt, ast.SetPassword) and stmt.name == user.name:
            return
        if isinstance(stmt, ast.ShowDatabases):
            return  # any user; the rows are filtered to their databases
        select = None
        if isinstance(stmt, ast.ExplainStatement):
            select = stmt.select
        elif isinstance(stmt, ast.SelectStatement):
            select = stmt
        elif isinstance(stmt, ast.UnionStatement):
            for sel in stmt.selects:
                self._authorize(sel, user, db)
            return
        if select is not None:
            # READ on every source database (per-source overrides and
            # subquery sources too); WRITE on the INTO target's, checked
            # on the SELECT whether bare or under EXPLAIN ANALYZE
            for sdb in sorted(self._select_source_dbs(select, db)):
                if not user.can("READ", sdb):
                    raise _AuthError(
                        f"user {user.name!r} lacks READ on {sdb!r}")
            if select.into is not None:
                tdb = select.into.database or db
                if not user.can("WRITE", tdb):
                    raise _AuthError(
                        f"user {user.name!r} lacks WRITE on {tdb!r}")
            return
        if isinstance(
            stmt,
            (ast.ShowMeasurements, ast.ShowTagKeys, ast.ShowTagValues,
             ast.ShowFieldKeys, ast.ShowSeries, ast.ShowRetentionPolicies,
             ast.ShowContinuousQueries, ast.ShowMeasurementCardinality,
             ast.ShowSeriesCardinality, ast.ShowSeriesExactCardinality),
        ):
            if user.can("READ", getattr(stmt, "database", "") or db):
                return
            raise _AuthError(f"user {user.name!r} lacks READ on {db!r}")
        raise _AuthError(
            f"user {user.name!r} is not authorized (admin required)")

    @staticmethod
    def _select_source_dbs(select, default_db: str) -> set:
        """Every database a SELECT reads from, subqueries included."""
        dbs = set()
        seen: set[int] = set()

        def walk(s):
            if s is None or id(s) in seen:
                return
            seen.add(id(s))
            if isinstance(s, ast.UnionStatement):
                for sel in s.selects:
                    walk(sel)
                return
            if not s.sources:
                dbs.add(default_db)
            for src in s.sources:
                walk_src(src, s)
            walk_cond(s.condition)

        def walk_src(src, owner):
            if isinstance(src, ast.SubQuery):
                walk(src.stmt)
            elif isinstance(src, ast.JoinSource):
                walk_src(src.left, owner)
                walk_src(src.right, owner)
            elif owner.ctes and src.name in owner.ctes:
                walk(owner.ctes[src.name])
            else:
                dbs.add(src.database or default_db)

        def walk_cond(e):
            if e is None:
                return
            if isinstance(e, ast.InSubquery):
                walk(e.stmt)
            elif isinstance(e, ast.BinaryExpr):
                walk_cond(e.lhs)
                walk_cond(e.rhs)
            elif isinstance(e, (ast.ParenExpr, ast.UnaryExpr)):
                walk_cond(e.expr)

        walk(select)
        return dbs

    def _explain(self, stmt: ast.ExplainStatement, db: str,
                 now_ns: int) -> dict:
        """EXPLAIN [ANALYZE] SELECT. ANALYZE runs the select under its own
        Trace and answers the rendered span tree; EXPLAIN describes the
        plan without executing it (with the same checks as _select, so
        it never hides a missing database)."""
        sel = stmt.select
        if stmt.analyze:
            trace = tracing.Trace("EXPLAIN ANALYZE")
            with tracing.activate(trace):
                self._select(sel, db, now_ns, trace=trace)
            trace.finish()
            return _series_result("", None, ["EXPLAIN ANALYZE"],
                                  [[line] for line in trace.render()])
        lines = []
        path = {
            "raw": "RAW SCAN (host merge)",
            "device": "DEVICE SEGMENTED REDUCTION (jit plan template)",
            "host": "HOST FUNCTION PIPELINE",
        }[_classify_select(sel)]
        for src in sel.sources:
            if not isinstance(src, ast.Measurement):
                raise QueryError("subqueries are not supported yet")
            src_db = src.database or db
            if not src_db:
                raise QueryError("database name required")
            if src_db not in self.engine.databases:
                raise QueryError(f"database not found: {src_db}")
            for mst in self._resolve_measurements(src, src_db):
                ctx = self._scan_context(sel, src_db, src.rp or None, mst,
                                         now_ns)
                lines.append(f"QUERY PLAN for {mst}: {path}")
                if ctx is None:
                    lines.append("    no matching shards/series")
                    continue
                lines.append(f"    shards: {len(ctx.shards)}")
                lines.append(f"    series: {len(ctx.scan_plan)}")
                lines.append(
                    f"    groups: {len(ctx.group_keys)}  windows: {ctx.W}")
                lines.append(
                    f"    time range: [{ctx.tmin}, {ctx.tmax})  "
                    f"segments: {len(ctx.group_keys) * ctx.W}")
        return _series_result("", None, ["QUERY PLAN"],
                              [[line] for line in lines])

    def _select(self, stmt: ast.SelectStatement, db: str, now_ns: int,
                trace=tracing.NOOP) -> dict:
        if trace is tracing.NOOP:
            # the per-query tree execute() activated (OGT_TRACE=1);
            # EXPLAIN ANALYZE passes its own
            trace = tracing.current()
        stmt = self._rewrite_in_subqueries(stmt, db, now_ns)
        if stmt is None:
            return {}  # IN (empty subquery result): no rows can match
        if len(stmt.fields) == 1:
            only = _strip_expr(stmt.fields[0].expr)
            if isinstance(only, ast.Call) and only.name == "compare":
                return self._select_compare(stmt, only, db, now_ns)
            if isinstance(only, ast.Call) and only.name in tfmod.TABLE_FUNCTIONS:
                return self._select_table_function(stmt, only, db, now_ns)
        # constant (string-literal) columns: allowed only WITH an alias
        # and only beside at least one variable field
        n_const = 0
        for f in stmt.fields:
            if isinstance(_strip_expr(f.expr), ast.StringLiteral):
                if not f.alias:
                    raise QueryError("field must contain at least one variable")
                n_const += 1
        if n_const == len(stmt.fields):
            return {}  # only constants: empty result, no error
        multi = self._multi_source_plan(stmt, db)
        if multi == "rewrite":
            # aggregates over several sources run on the UNION of their
            # rows (reference: count(age) FROM mst,mst1 is one combined
            # count): the same select over a raw SELECT * subquery that
            # spans every source
            inner = ast.SelectStatement(
                fields=[ast.Field(expr=ast.Wildcard())],
                sources=list(stmt.sources),
                ctes=stmt.ctes,
            )
            outer = copy.copy(stmt)
            outer.sources = [ast.SubQuery(inner)]
            return self._select(outer, db, now_ns, trace)
        all_series = []
        for src in stmt.sources:
            if isinstance(src, ast.JoinSource):
                from opengemini_tpu_torch.query import join as joinmod

                all_series.extend(
                    joinmod.select_join(self, stmt, src, db, now_ns))
                continue
            if (isinstance(src, ast.Measurement) and stmt.ctes
                    and src.name in stmt.ctes):
                all_series.extend(
                    self._select_cte(stmt, src, db, now_ns, trace))
                continue
            if isinstance(src, ast.SubQuery):
                all_series.extend(
                    self._select_from_subquery(stmt, src, db, now_ns, trace))
                continue
            src_db = src.database or db
            if not src_db:
                raise QueryError("database name required")
            if src_db not in self.engine.databases:
                raise QueryError(f"database not found: {src_db}")
            for mst in self._resolve_measurements(src, src_db):
                with trace.span(f"select: {mst}"):
                    all_series.extend(self._select_measurement(
                        stmt, src_db, src.rp or None, mst, now_ns, trace))
        if multi == "merge":
            all_series = _merge_multi_source(all_series, stmt)
        if stmt.soffset:
            all_series = all_series[stmt.soffset:]
        if stmt.slimit:
            all_series = all_series[: stmt.slimit]
        if stmt.into is not None:
            written = self._write_into(stmt.into, db, all_series)
            return _series_result("result", None, ["time", "written"],
                                  [[0, written]])
        if not all_series:
            return {}
        return {"series": all_series}

    def _multi_source_plan(self, stmt, db: str) -> str | None:
        """How a multi-source FROM combines: None for one effective
        source (or joins and CTE names, which combine by their own
        machinery), "merge" for a raw projection (each source runs, and
        the output series merge by tag set into one named 'm,n'),
        "rewrite" for aggregates (the union of rows, through a
        subquery). A subquery counts as one source."""
        srcs = stmt.sources
        if any(isinstance(s, ast.JoinSource) for s in srcs):
            return None
        if any(isinstance(s, ast.Measurement) and stmt.ctes
               and s.name in stmt.ctes for s in srcs):
            return None
        n_effective = 0
        for s in srcs:
            if isinstance(s, ast.SubQuery):
                n_effective += 1
            elif isinstance(s, ast.Measurement):
                if s.regex:
                    try:
                        n_effective += len(
                            self._resolve_measurements(s, s.database or db))
                    except Exception:  # noqa: BLE001 — errors surface later
                        n_effective += 1
                else:
                    n_effective += 1
        if n_effective <= 1:
            return None
        if _classify_select(stmt) == "raw":
            return "merge"
        if len(srcs) <= 1:
            # one regex source with aggregates keeps a series per
            # measurement (influx); only explicit sources union rows
            return None
        return "rewrite"

    def _select_cte(self, stmt, src: ast.Measurement, db: str, now_ns: int,
                    trace=tracing.NOOP) -> list[dict]:
        """FROM <cte-name>: execute the WITH binding as a subquery, with
        cycle detection (reference error text: CTE_Query expectations)."""
        name = src.name
        active = getattr(self._cte_state, "active", None)
        if active is None:
            active = self._cte_state.active = set()
        if name in active:
            raise QueryError(
                f"Unsupported feature: recursive call to itself {name}")
        active.add(name)
        try:
            sub = ast.SubQuery(stmt.ctes[name], alias=src.alias or name)
            return self._select_from_subquery(stmt, sub, db, now_ns, trace)
        finally:
            active.discard(name)


    def _rewrite_in_subqueries(self, stmt, db: str, now_ns: int):
        """Replace `<ref> IN (SELECT ...)` predicates with OR-chains of
        equalities against the subquery's first output column.  Returns
        None when an IN set is empty (the predicate can never match)."""
        if stmt.condition is None or not _has_in_subquery(stmt.condition):
            return stmt
        empty = []

        def resolve(e, under_or=False):
            if isinstance(e, ast.InSubquery):
                # CTE refs inside the IN-subquery resolve with cycle checks
                res = self._select(e.stmt, db, now_ns)
                values = []
                seen = set()
                for s in res.get("series", []):
                    for row in s.get("values", []):
                        if len(row) < 2 or row[1] is None:
                            continue
                        if row[1] not in seen:
                            seen.add(row[1])
                            values.append(row[1])
                if not values:
                    if under_or:
                        # an always-false leaf under OR must not erase the
                        # other branch; no representable false leaf exists
                        # in the condition machinery yet
                        raise QueryError(
                            "IN (empty subquery result) under OR is not supported")
                    empty.append(True)
                    return e
                out = None
                for v in values:
                    if isinstance(v, bool):
                        lit = ast.BooleanLiteral(v)
                    elif isinstance(v, (int,)):
                        lit = ast.IntegerLiteral(v)
                    elif isinstance(v, float):
                        lit = ast.NumberLiteral(v)
                    else:
                        lit = ast.StringLiteral(str(v))
                    eq = ast.BinaryExpr("=", e.ref, lit)
                    out = eq if out is None else ast.BinaryExpr("OR", out, eq)
                return out
            if isinstance(e, ast.BinaryExpr):
                sub_or = under_or or e.op.upper() == "OR"
                return ast.BinaryExpr(
                    e.op, resolve(e.lhs, sub_or), resolve(e.rhs, sub_or))
            if isinstance(e, ast.ParenExpr):
                return ast.ParenExpr(resolve(e.expr, under_or))
            if isinstance(e, ast.UnaryExpr):
                return ast.UnaryExpr(e.op, resolve(e.expr, True))
            return e

        new_cond = resolve(stmt.condition)
        if empty:
            return None
        stmt = copy.copy(stmt)
        stmt.condition = new_cond
        return stmt

    def _select_compare(self, stmt, call, db: str, now_ns: int) -> dict:
        """compare(ref, off...): evaluate the source over the WHERE range
        and over each range shifted back by `off` seconds (or a duration),
        align rows by (tags, time+off), and emit ref1..refN plus
        ref1/refK ratio columns (reference: openGemini compare UDF,
        TestServer_Query_Compare_Functions)."""
        if len(call.args) < 2:
            raise QueryError(
                "invalid number of arguments for compare, expected more "
                f"than one arguments, got {len(call.args)}")
        ref_e = _strip_expr(call.args[0])
        if not isinstance(ref_e, ast.VarRef):
            raise QueryError("compare() first argument must be a column")
        ref = ref_e.name
        offsets = []
        for a in call.args[1:]:
            v = _call_param_value(a)
            # bare integers are seconds; durations come in as ns
            offsets.append(int(v) * NS if isinstance(v, int) and
                           not isinstance(_strip_expr(a), ast.DurationLiteral)
                           else int(v))
        if not stmt.sources:
            raise QueryError("compare() requires a FROM source")
        src = stmt.sources[0]
        if isinstance(src, ast.SubQuery):
            inner = src.stmt
        elif isinstance(src, ast.Measurement):
            # raw field compare: first(field) over the range
            inner = ast.SelectStatement(
                fields=[ast.Field(ast.Call("first", (ast.VarRef(ref),)),
                                  alias=ref)],
                sources=[src],
            )
            inner.ctes = stmt.ctes
        else:
            raise QueryError("compare() source must be a measurement or subquery")

        sc = cond.split(stmt.condition, set(), now_ns)
        if sc.tmin == cond.MIN_TIME or sc.tmax == cond.MAX_TIME:
            raise QueryError("compare() requires an explicit time range")

        runs = []
        for off in [0] + offsets:
            bound = ast.BinaryExpr(
                "AND",
                ast.BinaryExpr(">=", ast.VarRef("time"),
                               ast.IntegerLiteral(sc.tmin - off)),
                ast.BinaryExpr("<", ast.VarRef("time"),
                               ast.IntegerLiteral(sc.tmax - off)),
            )
            run_inner = copy.copy(inner)
            gt = getattr(run_inner, "group_by_time", None)
            if gt is not None and not gt.offset_ns:
                # openGemini anchors compare() windows at the (shifted)
                # RANGE START, not the epoch grid: the reference output
                # rows carry tmin-aligned times
                # (TestServer_Query_Compare_Functions#10). A NON-ZERO
                # user GROUP BY time offset is respected; an explicit 0s
                # offset is indistinguishable from the default in the AST
                # and re-anchors too (InfluxQL treats the forms
                # identically).
                run_inner.group_by_time = dataclasses.replace(
                    gt, offset_ns=(sc.tmin - off) % gt.every_ns)
            run_stmt = ast.SelectStatement(
                fields=[ast.Field(ast.VarRef(ref))],
                sources=[ast.SubQuery(run_inner)],
                condition=bound,
                group_by_all_tags=True,
            )
            run_stmt.ctes = stmt.ctes
            res = self._select(run_stmt, db, now_ns)
            data: dict[tuple, dict[int, object]] = {}
            name = "compare"
            for ser in res.get("series", []):
                name = ser.get("name", name)
                key = tuple(sorted((ser.get("tags") or {}).items()))
                bucket = data.setdefault(key, {})
                ci = ser["columns"].index(ref) if ref in ser["columns"] else 1
                for row in ser["values"]:
                    if row[ci] is not None:
                        bucket[row[0] + off] = row[ci]
            runs.append((name, data))

        src_name = runs[0][0] if runs else "compare"
        all_keys = sorted({k for _n, d in runs for k in d})
        k_runs = len(runs)
        columns = (["time"] + [f"{ref}{i+1}" for i in range(k_runs)]
                   + [f"{ref}1/{ref}{i+1}" for i in range(1, k_runs)])
        out_series = []
        for key in all_keys:
            times = sorted({t for _n, d in runs for t in d.get(key, {})})
            rows = []
            for t in times:
                vals = [d.get(key, {}).get(t) for _n, d in runs]
                ratios = []
                for i in range(1, k_runs):
                    a, b = vals[0], vals[i]
                    ratios.append(
                        a / b if a is not None and b not in (None, 0) else None)
                rows.append([t] + vals + ratios)
            if not rows:
                continue
            series = {"name": src_name, "columns": columns, "values": rows}
            if key:
                series["tags"] = dict(key)
            out_series.append(series)
        return {"series": out_series} if out_series else {}

    def _resolve_measurements(self, src: ast.Measurement, db: str) -> list[str]:
        if src.name:
            return [src.name]
        rx = re.compile(src.regex)
        names = set()
        for sh in self.engine.shards_for_range(db, src.rp or None,
                                               cond.MIN_TIME, cond.MAX_TIME):
            names.update(m for m in sh.measurements() if rx.search(m))
        if self.router is not None:
            try:
                remote = self.router.remote_measurements(db, src.rp or None)
            except Exception as e:  # noqa: BLE001
                raise QueryError(str(e)) from e
            names.update(m for m in remote if rx.search(m))
        return sorted(names)

    def _measurement_schema(self, db, rp, mst) -> dict:
        schema: dict = {}
        for sh in self.engine.shards_for_range(db, rp, cond.MIN_TIME,
                                               cond.MAX_TIME):
            schema.update(sh.schema(mst))
        return schema

    def _select_measurement(self, stmt, db, rp, mst, now_ns,
                            trace=tracing.NOOP) -> list[dict]:
        if _has_call_wildcard(stmt):
            stmt = _expand_call_wildcards(
                stmt, self._measurement_schema(db, rp, mst))
        if len(stmt.fields) == 1:
            only = _strip_expr(stmt.fields[0].expr)
            if isinstance(only, ast.Call) and only.name == "percentile_approx":
                return self._select_percentile_approx(
                    stmt, db, rp, mst, now_ns, only)
        aux_plan = _selector_aux_plan(stmt)
        if aux_plan is not None:
            return self._select_selector_aux(stmt, db, rp, mst, now_ns,
                                             aux_plan)
        kind = _classify_select(stmt)
        if kind == "device" and _needs_string_host_path(
                stmt, lambda: self._measurement_schema(db, rp, mst)):
            # first/last/... over STRING fields: the device batches are
            # numeric; the host path computes them exactly
            kind = "host"
        if kind == "raw":
            return self._select_raw(stmt, db, rp, mst, now_ns)
        if kind == "device":
            return self._select_agg(stmt, db, rp, mst, now_ns, trace)
        return self._select_host(stmt, db, rp, mst, now_ns)

    # -- shared scan planning ----------------------------------------------

    def _all_shards_with_remote(self, db, rp, mst, condition, now_ns,
                                remote_mode="raw"):
        """The local shards and, clustered, the peers' data. remote_mode
        "raw": RemoteShard row proxies (the column exchange); "meta": one
        MetaShard with the peers' tag keys, schema and extent, the rows
        arriving later as partials (the pushdown). Returns (shards,
        live node list | None)."""
        shards = self.engine.shards_for_range(db, rp, cond.MIN_TIME,
                                              cond.MAX_TIME)
        live = None
        if self.router is not None:
            pre = cond.split(condition, set(), now_ns)
            try:
                if remote_mode == "meta":
                    meta, live = self.router.select_meta(
                        db, rp, mst, pre.tmin, pre.tmax)
                    remote = []
                    if meta is not None and meta["dmin"] is not None:
                        remote = [pcluster.MetaShard(
                            mst, meta["tag_keys"], meta["schema"],
                            meta["dmin"], meta["dmax"])]
                else:
                    remote, live = self.router.scan_shards(
                        db, rp, mst, pre.tmin, pre.tmax)
            except pcluster.PartialsUnavailable:
                # a live peer refused the metadata round: the pushdown
                # driver falls back to the raw column exchange
                raise
            except Exception as e:  # noqa: BLE001 — partial data is wrong
                raise QueryError(str(e)) from e
            if self.router.rf > 1:
                # replicated groups: keep those this node is primary for
                # among the live set, or replicas would count twice
                shards = [sh for sh in shards
                          if self.router.is_primary(db, rp, sh.tmin, live)]
            shards = shards + remote
        return shards, live

    def _scan_context(self, stmt, db, rp, mst, now_ns, remote_mode="raw"):
        """Shared prologue: schema/tag keys, WHERE split, shard mapping,
        data-driven range clamp, window grid, group construction. Returns
        None when nothing matches."""
        if self.engine.is_measurement_dropped(db, mst):
            return None  # mark-deleted: hidden from SELECT before a purge
        shards_all, live = self._all_shards_with_remote(
            db, rp, mst, stmt.condition, now_ns, remote_mode)
        tag_keys: set[str] = set()
        schema: dict[str, FieldType] = {}
        for sh in shards_all:
            tag_keys.update(sh.index.tag_keys(mst))
            schema.update(sh.schema(mst))
        if not schema and stmt.group_by_all_tags:
            raise QueryError("measurement not found")
        sc = cond.split(stmt.condition, tag_keys, now_ns)
        tmin, tmax = sc.tmin, sc.tmax
        explicit_tmin = tmin != cond.MIN_TIME
        explicit_tmax = tmax != cond.MAX_TIME
        shards = [sh for sh in shards_all if sh.tmax > tmin and sh.tmin < tmax]
        if not shards:
            return None
        # data-driven clamp of an unbounded range (influx uses epoch 0/now)
        if not explicit_tmin or not explicit_tmax:
            dmin, dmax = _data_time_range(shards, mst)
            if dmin is None:
                return None
            if not explicit_tmin:
                tmin = dmin
            if not explicit_tmax:
                tmax = dmax + 1
        if tmax <= tmin:
            return None
        group_time = stmt.group_by_time
        if group_time:
            aligned = int(winmod.window_start(tmin, group_time.every_ns,
                                              group_time.offset_ns))
            every = group_time.every_ns
            if not explicit_tmax and stmt.limit and stmt.ascending:
                want = stmt.offset + stmt.limit
                tmax = max(tmax, min(now_ns, aligned + want * every))
            W = winmod.num_windows(tmin, tmax, every, group_time.offset_ns)
            if W > MAX_SELECT_BUCKETS:
                raise QueryError(
                    f"GROUP BY time({every}ns) would create {W} buckets "
                    f"(max {MAX_SELECT_BUCKETS})")
        else:
            # output timestamp of whole-range aggregates: the explicit WHERE
            # lower bound, else epoch 0
            aligned = tmin if explicit_tmin else 0
            W = 1
        group_tags = self._group_tags(stmt, shards, mst)
        gid_of: dict[tuple, int] = {}
        group_keys: list[tuple] = []
        scan_plan = []  # (shard, sid, gid)
        # GROUP BY time emits fill rows even for series with no matching
        # row, so pruning would change the series set: the text index
        # prunes un-windowed scans only
        match_terms = ([] if group_time
                       else cond.conjunctive_match_terms(sc.field_expr))
        # /*+ full_series|specific_series */: the WHERE names whole
        # series, so mixed tag/field trees are evaluated per series and
        # skip their row filter
        hinted = bool({"full_series", "specific_series"}
                      & set(getattr(stmt, "hints", ())))
        exact_tags = (
            cond.exact_series_tags(stmt.condition, tag_keys)
            if "full_series" in getattr(stmt, "hints", ()) else None
        ) or None  # no tag equalities: the hint pins nothing
        for sh in shards:
            sids = cond.eval_tag_sids(sc.tag_expr, sh.index, mst,
                                      self.device)
            if sc.mixed_expr is not None and sids.size:
                prune = (cond.series_only_arr if hinted
                         else cond.tag_superset_arr)
                sids = np.intersect1d(
                    sids, prune(sc.mixed_expr, sh.index, mst, sc.tag_keys,
                                self.device),
                    assume_unique=True)
            if exact_tags is not None and sids.size:
                keep = [s for s in sids.tolist()
                        if sh.index.tags_of(s) == exact_tags]
                sids = np.asarray(keep, np.int64)
            sids = _prune_text_sids(sh, mst, sids, match_terms)
            for sid in sids.tolist():
                tags = sh.index.tags_of(sid)
                key = tuple(tags.get(k, "") for k in group_tags)
                gid = gid_of.get(key)
                if gid is None:
                    gid = len(group_keys)
                    gid_of[key] = gid
                    group_keys.append(key)
                scan_plan.append((sh, sid, gid))
        if hinted:
            sc.mixed_series_level = True  # consumed at the series level
        if not scan_plan and not (remote_mode == "meta" and live is not None):
            # a clustered "meta" scan goes on with an empty local plan:
            # the groups may exist only as the peers' partials
            return None
        return ScanContext(sc, shards, tmin, tmax, schema, tag_keys,
                           group_time, aligned, W, group_tags, group_keys,
                           scan_plan, live)

    # -- aggregate path -----------------------------------------------------

    def _select_agg(self, stmt, db, rp, mst, now_ns,
                    trace=tracing.NOOP) -> list[dict]:
        """An aggregate SELECT, pushed down to the peers when clustered
        and every call merges from partials."""
        from opengemini_tpu_torch.query import partials as pmod

        aggs = []  # (call, spec, params, field_name)
        for f in stmt.fields:
            for call in _calls_in(f.expr):
                spec, params, field_name = _resolve_call(call)
                aggs.append((call, spec, params, field_name))
        pushdown = (
            self.router is not None
            # getattr: a stub router without the full surface keeps the
            # raw column exchange
            and getattr(self.router, "has_peers", lambda: False)()
            and all(spec.name in pmod.MERGEABLE
                    or spec.name in pmod.MULTISET_MERGEABLE
                    for _c, spec, _p, _f in aggs)
            and not any(f.lower() == "time" for _c, _s, _p, f in aggs)
        )
        attempts = max(self.router.rf, 1) if pushdown else 1
        for attempt in range(attempts):
            try:
                return self._select_agg_run(stmt, db, rp, mst, now_ns, aggs,
                                            pushdown, trace)
            except pcluster.PartialsUnavailable:
                # a live peer cannot serve partials: the raw exchange can
                return self._select_agg_run(stmt, db, rp, mst, now_ns, aggs,
                                            False, trace)
            except pcluster.PartialsRetry as e:
                # a peer died mid-query: the primaries moved, so the whole
                # plan (live set, local primary filter) is stale
                if attempt == attempts - 1:
                    raise QueryError(str(e)) from e
        raise AssertionError("unreachable")

    def _select_agg_run(self, stmt, db, rp, mst, now_ns, aggs,
                        pushdown=False, trace=tracing.NOOP) -> list[dict]:
        with trace.span("map_shards") as sp:
            ctx = self._scan_context(
                stmt, db, rp, mst, now_ns,
                remote_mode="meta" if pushdown else "raw")
            if ctx is not None:
                sp.add_field("shards", len(ctx.shards))
                sp.add_field("series", len(ctx.scan_plan))
                sp.add_field("groups x windows",
                             f"{len(ctx.group_keys)} x {ctx.W}")
        if ctx is None:
            return []
        # the "plan" stage: from here to the scan, less the rollup splice
        # (a span of its own): batches, cache, rollup and slice plans
        t_plan = _time.perf_counter_ns()
        rollup_ns = 0
        sc, shards = ctx.sc, ctx.shards
        tmin, tmax = ctx.tmin, ctx.tmax
        group_time, aligned, W = ctx.group_time, ctx.aligned, ctx.W
        group_keys = ctx.group_keys
        schema = ctx.schema
        num_groups = len(group_keys)
        num_segments = num_groups * W

        # aggregates over the `time` pseudo-field (count/first/last/min/
        # max of row timestamps) are computed on the host from the
        # scanned row times
        time_aggs = [a for a in aggs if a[3].lower() == "time"]
        for _c, spec, _p, _f in time_aggs:
            if spec.name not in ("count", "first", "last", "min", "max"):
                raise QueryError(f"{spec.name}(time) is not supported")
        aggs = [a for a in aggs if a[3].lower() != "time"]
        # influx: COUNT/COUNT(DISTINCT ...) over a TAG answers a constant 0
        tag_count_aggs = [
            a for a in aggs
            if a[1].name in ("count", "count_distinct")
            and a[3] not in schema and a[3] in sc.tag_keys
        ]
        aggs = [a for a in aggs if a not in tag_count_aggs]

        needed_fields = sorted({a[3] for a in aggs})
        read_fields = sorted(set(needed_fields)
                             | set(cond.row_filter_refs(sc)))
        if time_aggs and not read_fields:
            read_fields = None  # time-only aggregates: read every field

        dtype = templates.compute_dtype()
        per_field_aggs: dict[str, list] = {}
        for _call, spec, _params, fname in aggs:
            per_field_aggs.setdefault(fname, []).append(spec.name)
        grid_ctx = (W, group_time.every_ns) if group_time else None
        batches: dict[str, object] = {
            f: pick_batch(schema, per_field_aggs[f], f, dtype, self.device,
                          grid_ctx)
            for f in needed_fields
        }

        # incremental result cache (reference inc_agg_transform +
        # lib/resultcache): GROUP BY time() windows whose shards took no
        # writes since the last execution are served from cached
        # (value, count) cells; only the stale windows are scanned
        cache_plan = None
        if (
            group_time is not None
            and W >= 1
            and aggs  # tag-count-only statements have nothing to cache
            # OGT_RESULT_CACHE=0 opts out (A/B runs must see every
            # execution, not one per panel)
            and os.environ.get("OGT_RESULT_CACHE", "1") not in ("", "0")
            and self.router is None
            and ctx.live is None
            and not time_aggs
            and len(group_keys) <= 20_000  # cache growth gate
            and W <= 16_384  # > _MAX_WINDOWS would evict itself every run
        ):
            fp = rcache.fingerprint(
                db, rp, mst, sc, group_time, ctx.group_tags,
                stmt.group_by_all_tags,
                [(spec.name, params, fname)
                 for _c, spec, params, fname in aggs],
            )
            cache_plan = rcache.CachePlan(
                self._inc_cache, fp, shards, aligned,
                group_time.every_ns, W, len(aggs), tmin, tmax)
        full_hit = cache_plan is not None and not cache_plan.scan_ranges
        scan_ranges = [(tmin, tmax)]
        if cache_plan is not None and cache_plan.scan_ranges:
            # disjoint stale runs: a now()-relative dashboard query scans
            # only its partial edge windows and the written windows
            scan_ranges = [
                (max(tmin, lo), min(tmax, hi))
                for lo, hi in cache_plan.scan_ranges
            ]

        # the rollup splice (storage/rollup.py, query/rollupplan.py):
        # windows below the watermark and not dirty come from rollup
        # cells, and the raw scan shrinks to the live tail and the
        # re-dirtied windows. Inside the result cache's stale set, so
        # both compose; nothing runs here while no spec is declared
        rollup_plan = None
        if (
            not full_hit
            and group_time is not None
            and aggs
            and not time_aggs
            and self.router is None
            and ctx.live is None
            and self.engine.rollup_mgr is not None
        ):
            rollup_plan = rplan.try_plan(
                self.engine.rollup_mgr, db, rp, mst, sc, ctx, aggs,
                schema, cache_plan, tmin, tmax)
        if rollup_plan is not None:
            with trace.span("rollup") as sp:
                t0_rollup = _time.perf_counter_ns()
                rollup_plan.fetch()
                rollup_ns = _time.perf_counter_ns() - t0_rollup
                TRACKER.add_stage_ns(
                    TRACKER.current_qid(), "rollup", rollup_ns)
                sp.add_field("windows_spliced", len(rollup_plan.serve))
                sp.add_field("rollup_rows", rollup_plan.rows_read)
            if rollup_plan.serve:
                scan_ranges = rollup_plan.scan_ranges
            else:
                rollup_plan = None
        # no raw scan at all: every window comes from the result cache
        # and/or the rollup splice
        no_scan = full_hit or (rollup_plan is not None and not scan_ranges)

        for call, spec, params, field_name in aggs:
            if schema.get(field_name) == FieldType.STRING and \
                    spec.name not in ("count", "mean", "stddev"):
                raise QueryError(
                    f"{spec.name}() is not supported on string field "
                    f"{field_name!r}")
        # selector ordering uses an int32 (hi, lo) split of rel ns
        if tmax - aligned >= (1 << 61):
            raise QueryError(
                "time range too large (over ~73 years) for aggregation")

        # pre-aggregation (reference: immutable/pre_aggregation.go block
        # skipping): for a whole-range count/sum/mean with no field
        # filter, chunks wholly inside the range contribute their stored
        # (count, sum) WITHOUT a decode or a transfer. Safe only when the
        # series' sources cannot overlap (no memtable rows in range,
        # non-overlapping, unpacked chunks: _series_needs_merged_decode)
        pre_eligible = (
            not group_time
            and not time_aggs
            and not sc.has_row_filter
            and all(spec.name in ("count", "sum", "mean")
                    for _c, spec, _p, _f in aggs)
            and all(getattr(sh, "supports_preagg", False) for sh in shards)
        )
        # pre-agg accumulators: int64 for INT fields (stored sums are
        # exact Python ints), float64 otherwise
        pre_count = (
            {f: np.zeros(num_segments, np.int64) for f in needed_fields}
            if pre_eligible else {}
        )
        pre_sum = (
            {f: np.zeros(num_segments, np.int64
                         if schema.get(f) == FieldType.INT else np.float64)
             for f in needed_fields}
            if pre_eligible else {}
        )
        sum_fields = {f for _c, spec, _p, f in aggs if spec.name != "count"}
        pre_used = False
        sliced_out = None

        # the device tier of the decoded-column cache: a deterministic
        # local GROUP BY time() scan signs its grid buffers so identical
        # scans reuse them (a sliced scan signs each slice). Under a
        # device mesh the retained grid is sharded (models/grid.py puts
        # the cold grid straight into the mesh's layout), so a warm mesh
        # scan copies nothing to the shards
        device_token = None
        if (group_time is not None and self.router is None
                and ctx.live is None
                and colcache_mod.GLOBAL.device_enabled()):
            device_token = _device_scan_token(
                db, rp, mst, sc, group_time, ctx.group_tags,
                stmt.group_by_all_tags, tmin, tmax, aligned, W, dtype,
                scan_ranges, shards)
            for f, b in batches.items():
                if hasattr(b, "device_cache_token"):
                    b.device_cache_token = f"{device_token}|{f}"

        # window-aligned time slicing bounds host and device memory
        # (reference analogue: the record-plan batch reader streams
        # chunks, engine/record_plan.go:75)
        slice_plan = None
        if (
            group_time is not None
            and not time_aggs
            and not pre_eligible
            and not no_scan
            and self.router is None
            and ctx.live is None
            and W >= 8
        ):
            slice_plan = _plan_scan_slices(
                shards, mst, ctx.scan_plan, aligned, group_time.every_ns, W,
                tmin, tmax)

        cc_before = (colcache_mod.GLOBAL.counters()
                     if colcache_mod.GLOBAL.enabled() else None)
        time_segs: list[np.ndarray] | None = [] if time_aggs else None
        time_vals: list[np.ndarray] = []
        # the scan's working-set reservation: the chunk-metadata estimate
        # is charged against the governor's ledger for the scan; one
        # that would overdraw it kills this query (a statement error)
        reservation = contextlib.nullcontext()
        if GOVERNOR.enabled() and not no_scan:
            est = estimate_scan_bytes(
                shards, mst, tmin, tmax,
                len(read_fields) if read_fields is not None
                else len(schema) or 1)
            reservation = GOVERNOR.scan_reservation(
                TRACKER.current_qid(), est)
        tracing.record_stage(
            "plan", _time.perf_counter_ns() - t_plan - rollup_ns)
        with reservation, trace.span("scan") as scan_span:
            if no_scan:
                rows_scanned = 0
            elif slice_plan is not None:
                rows_scanned, sliced_out = self._scan_sliced(
                    slice_plan, ctx.scan_plan, scan_ranges, sc, mst,
                    group_time, needed_fields, read_fields, dtype, schema,
                    per_field_aggs, aggs, num_groups, device_token)
            else:
                rows_scanned, pre_used = self._scan_monolithic(
                    ctx.scan_plan, scan_ranges, sc, mst, group_time, tmin,
                    W, needed_fields, read_fields, dtype, aligned, batches,
                    time_segs, time_vals, pre_eligible, pre_count, pre_sum,
                    sum_fields, tmax)
            scan_span.add_field("rows", rows_scanned)
            if slice_plan is not None:
                scan_span.add_field("slices", len(slice_plan))
        STATS.incr("executor", "rows_scanned", rows_scanned)
        if cc_before is not None:
            # the cache's share of the scan: deltas of the process-wide
            # counters (concurrent queries can bleed in)
            cc_after = colcache_mod.GLOBAL.counters()
            with trace.span("colcache") as sp:
                for key in ("hits", "misses", "device_hits",
                            "device_misses"):
                    sp.add_field(key, cc_after[key] - cc_before[key])
                sp.add_field("time_ms", round(
                    (cc_after["time_ns"] - cc_before["time_ns"]) / 1e6, 3))
                sp.add_field("bytes_resident", cc_after["bytes"])
                sp.add_field("device_bytes", cc_after["device_bytes"])

        agg_results = {}  # id(call) -> (values, sel, counts, spec, fname, times)
        dv_before = devobs.span_snapshot() if devobs.enabled() else None
        with trace.span("device_compute") as sp:
            for call, spec, params, field_name in aggs:
                TRACKER.check()  # kill between device batch dispatches
                batch = batches[field_name]
                if no_scan:
                    # every window served from the cache: no scan, no
                    # device work
                    dt = (np.int64 if isinstance(batch, ragged.IntExactBatch)
                          and spec.name in ("sum", "count") else np.float64)
                    agg_results[id(call)] = (
                        np.zeros(num_segments, dt), None,
                        np.zeros(num_segments, np.int64), spec,
                        field_name, None)
                    continue
                if sliced_out is not None:
                    out, sel, counts = _stitch_sliced(
                        sliced_out, call, num_groups, W, num_segments)
                elif group_time and getattr(batch, "supports_want_sel",
                                            False):
                    # GROUP BY time(): selector timestamps are never
                    # consulted (window start renders instead), so skip
                    # the selector index kernels
                    out, sel, counts = batch.run(spec, num_segments, params,
                                                 want_sel=False)
                else:
                    out, sel, counts = batch.run(spec, num_segments, params)
                if spec.name == "percentile" and params:
                    # influx: rank floor(n*q/100+0.5)-1 < 0 yields NO row
                    qv = float(params[0])
                    ok = np.floor(counts * qv / 100.0 + 0.5) >= 1
                    if not ok.all():
                        counts = np.where(ok, counts, 0)
                if spec.name == "stddev" and \
                        schema.get(field_name) == FieldType.STRING:
                    out = np.where(counts > 0, np.nan, out)
                if pre_used:
                    # combine the device partials with the pre-agg
                    # contributions
                    pc = pre_count[field_name]
                    ps = pre_sum[field_name]
                    if spec.name == "count":
                        out = out + pc
                    elif spec.name == "sum":
                        out = out + ps
                    else:  # mean = (dev_sum + pre_sum) / (dev_cnt + pre_cnt)
                        dev_sum, _s, _c = batch.run(aggmod.get("sum"),
                                                    num_segments)
                        total_c = counts + pc
                        out = (dev_sum + ps) / np.maximum(total_c, 1)
                    counts = counts + pc.astype(counts.dtype)
                agg_results[id(call)] = (out, sel, counts, spec, field_name,
                                         None)
            for call, spec, _params, field_name in tag_count_aggs:
                out = np.zeros(num_segments, np.int64)
                counts = np.ones(num_segments, np.int64)  # rows render as 0
                agg_results[id(call)] = (out, None, counts, spec, field_name,
                                         None)
            if time_aggs:
                seg_all = (np.concatenate(time_segs) if time_segs
                           else np.empty(0, np.int32))
                t_all = (np.concatenate(time_vals) if time_vals
                         else np.empty(0, np.int64))
                tcounts = np.bincount(
                    seg_all, minlength=num_segments).astype(np.int64)
            for call, spec, _params, _f in time_aggs:
                if spec.name == "count":
                    tout = tcounts
                elif spec.name in ("last", "max"):
                    tout = np.full(num_segments, np.iinfo(np.int64).min,
                                   np.int64)
                    np.maximum.at(tout, seg_all, t_all)
                else:  # first/min
                    tout = np.full(num_segments, np.iinfo(np.int64).max,
                                   np.int64)
                    np.minimum.at(tout, seg_all, t_all)
                spec2 = dataclasses.replace(spec, int_output=True)
                agg_results[id(call)] = (tout, None, tcounts, spec2, "time",
                                         tout)
            if self.device.type == "cuda":
                # launches return before the card finishes: end the span
                # when the device work has, so its time does not land in
                # render
                torch.cuda.synchronize(self.device)
            sp.add_field("aggregates", len(aggs))
            sp.add_field("segments", num_segments)
            if sliced_out is not None:
                sp.add_field("batch_rows", {
                    f: sum(info[f][0] for _w0, _ws, _o, info in sliced_out)
                    for f in needed_fields})
                sp.add_field("layouts", {
                    f: "sliced[" + ",".join(sorted(
                        {info[f][1] for _w0, _ws, _o, info in sliced_out}
                        or {"empty"})) + "]"
                    for f in needed_fields})
            else:
                sp.add_field("batch_rows",
                             {f: b.n for f, b in batches.items()})
                # which layout ran per field (a GridBatch may have
                # fallen back, or not run at all on a full cache hit)
                sp.add_field("layouts",
                             {f: b.layout_name() for f, b in batches.items()})
            STATS.incr("executor", "device_batches", len(aggs))
            if dv_before is not None:
                # devobs deltas (armed): the compiles and transfer bytes
                # of this span; concurrent queries can bleed in, the
                # per-query times land in the device_* tracker stages
                dv_after = devobs.span_snapshot()
                for key in ("compiles", "h2d_bytes", "d2h_bytes",
                            "reshard_bytes"):
                    sp.add_field(key, dv_after[key] - dv_before[key])
                sp.add_field("compile_wall_ms", round(
                    dv_after["compile_wall_ms"]
                    - dv_before["compile_wall_ms"], 3))
        if pushdown and ctx.live is not None and any(
                isinstance(sh, pcluster.MetaShard) for sh in shards):
            # the pushdown: the peers computed the same grid over their
            # shards; merge their O(groups x windows) partial arrays
            group_keys = list(group_keys)
            self._merge_peer_partials(
                db, rp, mst, ctx, sc, aligned, W, group_time, group_keys,
                per_field_aggs, agg_results, aggs, batches, trace)
        if rollup_plan is not None:
            # before the cache merge: the cache persists the spliced
            # windows (they sit in its stale set) from these arrays
            group_keys = rollup_plan.merge(agg_results, aggs,
                                           list(group_keys))
        if cache_plan is not None:
            with trace.span("inc_cache"):
                group_keys = cache_plan.merge(agg_results, aggs,
                                              list(group_keys))
        with trace.span("render"):
            return self._render_agg(stmt, mst, ctx.group_tags, group_keys,
                                    aligned, W, agg_results, batches, schema)

    def _merge_peer_partials(self, db, rp, mst, ctx, sc, aligned, W,
                             group_time, group_keys, per_field_aggs,
                             agg_results, aggs, batches, trace) -> None:
        """The remote_partials round: send the coordinator's plan to the
        live peers, graft their span subtrees, and fold their partials
        into agg_results (group_keys gains the peers' own groups)."""
        from opengemini_tpu_torch.query import partials as pmod
        from opengemini_tpu_torch.sql import astjson

        with trace.span("remote_partials") as sp:
            req = {
                "db": db, "rp": rp, "mst": mst,
                "tmin": ctx.tmin, "tmax": ctx.tmax, "aligned": aligned,
                "every_ns": group_time.every_ns if group_time else 0,
                "offset_ns": group_time.offset_ns if group_time else 0,
                "W": W, "group_tags": ctx.group_tags,
                "aggs": per_field_aggs,
                "tag_expr": astjson.to_json(sc.tag_expr),
                "field_expr": astjson.to_json(sc.field_expr),
                "mixed_expr": astjson.to_json(sc.mixed_expr),
                "mixed_series_level": sc.mixed_series_level,
                # the coordinator's tag keys: a peer evaluates mixed trees
                # against the same classification (a tag its own index
                # lacks still injects as an empty string)
                "tag_keys": sorted(sc.tag_keys),
            }
            peer_docs = self.router.select_partials(req, ctx.live)
            for doc in peer_docs:
                # each peer's subtree (shipped in its partials header)
                # under this span: the wire ctx fixed its parentage
                trace.graft(doc.pop("trace", None))
            if peer_docs:
                pmod.merge_remote_partials(
                    agg_results, aggs, batches, group_keys, W, peer_docs,
                    ctx.group_tags)
            sp.add_field("peers", len(peer_docs))

    def _scan_monolithic(self, scan_plan, scan_ranges, sc, mst, group_time,
                         tmin, W, needed_fields, read_fields, dtype, aligned,
                         batches, time_segs=None, time_vals=None,
                         pre_eligible=False, pre_count=None, pre_sum=None,
                         sum_fields=(), tmax=None) -> tuple[int, bool]:
        """Decode every series in range into `batches`: one bulk read per
        shard when many series are scanned, else per-series reads staged
        into one contiguous add per field. With `time_segs` (aggregates
        over time) each row's segment and time are kept there and in
        `time_vals`. With `pre_eligible` every series tries the
        pre-aggregation path first, and the series it does not serve
        (packed or overlapping chunks, memtable rows) take the bulk or
        staged decode below like any scan. (The reference decodes each
        of those with its own read_series; at 4000 series, whose chunks
        are all packed, that decodes every packed chunk once per series
        it holds: the same answers, at several times the cost.) Returns
        (rows scanned, whether any series took the pre-agg path)."""
        rows_scanned = 0
        pre_used = False
        if pre_eligible:
            decode_plan = []
            for sh, sid, gid in scan_plan:
                TRACKER.check()  # KILL QUERY cancellation point
                handled, got_rows = self._scan_preagg(
                    sh, mst, sid, gid, tmin, tmax, needed_fields, batches,
                    pre_count, pre_sum, dtype, aligned, sum_fields)
                if handled:
                    pre_used = True
                    rows_scanned += got_rows
                else:
                    decode_plan.append((sh, sid, gid))
            scan_plan = decode_plan
        by_shard: dict[int, tuple] = {}
        for sh, sid, gid in scan_plan:
            by_shard.setdefault(id(sh), (sh, []))[1].append((sid, gid))
        remaining_plan = []
        for sh, pairs in by_shard.values():
            # a peer's RemoteShard has no bulk read: per series
            if len(pairs) < 64 or not hasattr(sh, "read_series_bulk"):
                remaining_plan.extend((sh, sid, gid) for sid, gid in pairs)
                continue
            sid_list = np.asarray([p[0] for p in pairs], np.int64)
            gid_list = np.asarray([p[1] for p in pairs], np.int64)
            o = np.argsort(sid_list)
            sid_sorted, gid_sorted = sid_list[o], gid_list[o]
            for rlo, rhi in scan_ranges:
                TRACKER.check()  # KILL QUERY cancellation point
                sid_arr, rec = sh.read_series_bulk(
                    mst, sid_sorted, rlo, rhi, fields=read_fields)
                if len(rec) == 0:
                    continue
                rows_scanned += len(rec)
                fmask = (cond.eval_row_filter(sc, rec, sid_arr=sid_arr,
                                              index=sh.index)
                         if sc.has_row_filter else None)
                gid_rows = gid_sorted[np.searchsorted(sid_sorted,
                                                      sid_arr)]
                if group_time:
                    widx, _ = winmod.window_index(
                        rec.times, tmin, group_time.every_ns,
                        group_time.offset_ns)
                    seg = (gid_rows * W + widx.astype(np.int64)
                           ).astype(np.int32)
                else:
                    seg = gid_rows.astype(np.int32)
                if time_segs is not None:
                    m = fmask if fmask is not None else slice(None)
                    time_segs.append(seg[m])
                    time_vals.append(rec.times[m])
                _add_record_to_batches(rec, seg, aligned, needed_fields,
                                       batches, dtype, fmask,
                                       sids=sid_arr)
        # per-series tail: stage rows and materialize ONE contiguous
        # array set per field at the end
        stager = (_ScanStager(needed_fields, dtype, batches, aligned,
                              time_segs, time_vals)
                  if remaining_plan else None)
        for sh, sid, gid in remaining_plan:
            TRACKER.check()  # KILL QUERY cancellation point
            for rlo, rhi in scan_ranges:
                rec = sh.read_series(mst, sid, rlo, rhi, fields=read_fields)
                if len(rec) == 0:
                    continue
                rows_scanned += len(rec)
                fmask = (cond.eval_row_filter(sc, rec,
                                              tags=sh.index.tags_of(sid))
                         if sc.has_row_filter else None)
                if group_time:
                    widx, _ = winmod.window_index(
                        rec.times, tmin, group_time.every_ns,
                        group_time.offset_ns)
                    seg = (gid * W + widx.astype(np.int64)).astype(np.int32)
                else:
                    seg = np.full(len(rec), gid, dtype=np.int32)
                stager.add(rec, seg, fmask, sid)
        if stager is not None:
            stager.flush()
        return rows_scanned, pre_used

    def _scan_sliced(self, slice_plan, scan_plan, scan_ranges, sc, mst,
                     group_time, needed_fields, read_fields, dtype, schema,
                     per_field_aggs, aggs, num_groups, device_token=None
                     ) -> tuple[int, list]:
        """Window-aligned sliced scan: each slice decodes into its own
        batch set, then its aggregates run (a batch's ``run`` returns
        host arrays, so the slice's kernels finish before the next slice
        decodes) and the slice's batches, with their device buffers, are
        dropped. Returns (rows_scanned, [(w0, W_s, {id(call): (out,
        counts)}, {field: (rows, layout)})]). Overlapping one slice's
        kernels with the next slice's decode (the reference's
        ``prefetch``) is not ported."""
        rows_scanned = 0
        out = []
        STATS.incr("executor", "sliced_scans")
        for (w0, W_s, lo, hi) in slice_plan:
            TRACKER.check()
            ranges = [(max(lo, rlo), min(hi, rhi))
                      for rlo, rhi in scan_ranges
                      if max(lo, rlo) < min(hi, rhi)]
            if not ranges:
                continue
            sbatches = {
                f: pick_batch(schema, per_field_aggs[f], f, dtype,
                              self.device, (W_s, group_time.every_ns))
                for f in needed_fields
            }
            if device_token is not None:
                # per-slice signature: same scan, distinct window span
                for f, b in sbatches.items():
                    if hasattr(b, "device_cache_token"):
                        b.device_cache_token = f"{device_token}|{f}|{w0}:{W_s}"
            got, _pre = self._scan_monolithic(
                scan_plan, ranges, sc, mst, group_time, lo, W_s,
                needed_fields, read_fields, dtype, lo, sbatches)
            rows_scanned += got
            outs = {}
            for call, spec, params, fname in aggs:
                b = sbatches[fname]
                if b.n == 0:
                    continue
                TRACKER.check()
                if getattr(b, "supports_want_sel", False):
                    o, _sel, c = b.run(spec, num_groups * W_s, params,
                                       want_sel=False)
                else:
                    o, _sel, c = b.run(spec, num_groups * W_s, params)
                outs[id(call)] = (o, c)
            info = {f: (b.n, b.layout_name()) for f, b in sbatches.items()}
            out.append((w0, W_s, outs, info))
            del sbatches  # the slice's device buffers go before the next
        return rows_scanned, out

    def _scan_preagg(self, sh, mst, sid, gid, tmin, tmax, needed_fields,
                     batches, pre_count, pre_sum, dtype, aligned,
                     sum_fields) -> tuple[bool, int]:
        """Try the pre-agg path for one series. Returns (handled, rows):
        handled=False -> the caller decodes the series as usual. No side
        effects until the whole series validates."""
        needs_merge, srcs = _series_needs_merged_decode(sh, mst, sid, tmin,
                                                        tmax)
        if needs_merge:
            return False, 0  # dedup required: decode via read_series
        if not srcs:
            return True, 0  # nothing in range at all
        # validate: every fully covered chunk must carry a sum for the
        # fields that need one (bool/string columns store count-only
        # pre-agg)
        contrib: list[tuple[str, int, float | None]] = []
        full_rows = 0
        partials = []
        for r, c in srcs:
            if tmin <= c.tmin and c.tmax < tmax:
                for fname in needed_fields:
                    loc = c.cols.get(fname)
                    if loc is None:
                        continue
                    pre = loc["pre"]
                    if not pre.count:
                        continue
                    if fname in sum_fields and pre.vsum is None:
                        return False, 0
                    contrib.append((fname, pre.count, pre.vsum))
                full_rows += c.rows
            else:
                partials.append((r, c))
        for fname, cnt, vsum in contrib:
            pre_count[fname][gid] += cnt
            if vsum is not None:
                pre_sum[fname][gid] += vsum
        rows = full_rows
        for r, c in partials:
            try:
                rec = r.read_chunk(
                    mst, c, needed_fields).slice_time(tmin, tmax)
            except CorruptFile as e:
                # media damage on the pre-agg decode: quarantine through
                # the owning shard (raises FileQuarantined)
                sh.note_corrupt(e)
            if not len(rec):
                continue
            rows += len(rec)
            seg = np.full(len(rec), gid, dtype=np.int32)
            _add_record_to_batches(rec, seg, aligned, needed_fields, batches,
                                   dtype, None, sids=sid)
        return True, rows

    def _group_tags(self, stmt, shards, mst) -> list[str]:
        if stmt.group_by_all_tags:
            keys: set[str] = set()
            for sh in shards:
                keys.update(sh.index.tag_keys(mst))
            return sorted(keys)
        return list(stmt.group_by_tags)

    def _render_agg(self, stmt, mst, group_tags, group_keys, aligned, W,
                    agg_results, batches, schema) -> list[dict]:
        group_time = stmt.group_by_time
        every = group_time.every_ns if group_time else 0

        columns = ["time"]
        col_exprs = []
        used_names: dict[str, int] = {}
        for f in stmt.fields:
            e = _strip_expr(f.expr)
            if isinstance(e, ast.VarRef) and e.name.lower() == "time":
                continue  # explicit `time` is always column 0
            name = f.alias or _default_field_name(f.expr)
            k = used_names.get(name, 0)
            used_names[name] = k + 1
            if k:
                name = f"{name}_{k}"
            columns.append(name)
            col_exprs.append(f.expr)

        # a single selector call without GROUP BY time(): the result time
        # is the selected point's own timestamp
        single_selector = None
        if not group_time and len(col_exprs) == 1:
            calls = _calls_in(col_exprs[0])
            if len(calls) == 1:
                entry = agg_results.get(id(calls[0]))
                if entry and entry[3].is_selector:
                    single_selector = entry

        host_times = (
            batches[single_selector[4]].host_times()
            if single_selector is not None and single_selector[5] is None
            else None
        )
        count_idx = tuple(
            i for i, e in enumerate(col_exprs)
            if isinstance(_strip_expr(e), ast.Call)
            and _strip_expr(e).name in ("count", "count_distinct")
        )
        out_series = []
        order = sorted(range(len(group_keys)), key=lambda g: group_keys[g])
        for g in order:
            key = group_keys[g]
            rows = []
            for w in range(W):
                seg = g * W + w
                t_out = (aligned + w * every if group_time
                         else (aligned if aligned else 0))
                vals = []
                any_present = False
                for expr in col_exprs:
                    v, present = _eval_output_expr(expr, agg_results, seg,
                                                   schema)
                    any_present = any_present or present
                    vals.append(v)
                if single_selector is not None:
                    out, sel, counts, spec, fname, times_abs = single_selector
                    if counts[seg] > 0:
                        t_out = (int(times_abs[seg]) if times_abs is not None
                                 else int(host_times[sel[seg]]))
                rows.append((t_out, vals, any_present))
            if not any(p for _t, _v, p in rows):
                # zero matching points in the whole range: no series at all
                continue
            rows = _apply_fill(rows, stmt, columns, count_idx)
            if not stmt.ascending:
                rows.reverse()
            if stmt.offset:
                rows = rows[stmt.offset:]
            if stmt.limit:
                rows = rows[: stmt.limit]
            if not rows:
                continue
            series = {
                "name": mst,
                "columns": columns,
                "values": [[t] + v for t, v, _p in rows],
            }
            if group_tags:
                series["tags"] = dict(zip(group_tags, key))
            out_series.append(series)
        return out_series
