"""FROM (SELECT ...) handling (an Executor mixin): subquery
materialization, direct projections, chunked inner scans and SELECT
INTO writes.

The port of ``opengemini_tpu/query/subquery.py`` (reference: the
subquery builders in engine/executor/select.go). The inner result
materializes into a throw-away ``Engine`` (the spill engine) on the
caller's device, and the outer select runs on it through the port's own
``Executor``, so the inner and the outer aggregates both go through
``pick_batch`` and the device kernels. The chunk loop checks for KILL
QUERY before each chunk, and a killed query closes and removes its
spill engine on the way out. Clustered, SELECT INTO's rows go through
the router's ``routed_write`` to their shard groups' owners, as any
write does.
"""

from __future__ import annotations

import contextlib
import copy
import os
import tempfile

from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.query import functions as fnmod
from opengemini_tpu_torch.query.qhelpers import (
    QueryError, _call_wildcard_inner, _calls_in, _classify_select,
    _inner_source_name, _strip_expr,
)
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


# chunked inner evaluation: estimated inner scans above the threshold
# evaluate window-aligned time chunks into the spill engine one at a
# time, bounding the JSON intermediate (reference: streaming
# subquery_transform.go). The cap is the loud guard for non-chunkable
# shapes (reference analogue: max-select-point). The environment names
# are the JAX package's, so both packages answer alike under one
# environment.
SUBQUERY_CHUNK_ROWS = int(os.environ.get(
    "OGTPU_SUBQUERY_CHUNK_ROWS", "0")) or 5_000_000
SUBQUERY_CHUNK_TARGET = int(os.environ.get(
    "OGTPU_SUBQUERY_CHUNK_TARGET", "0")) or 2_000_000
SUBQUERY_MAX_ROWS = int(os.environ.get(
    "OGTPU_SUBQUERY_MAX_ROWS", "50000000"))


def _subquery_chunk_safe(inner) -> bool:
    """True when evaluating `inner` over disjoint window-aligned time
    chunks produces the same rows as one evaluation: no global
    limits, no cross-window sequence transforms, no fill that reaches
    across windows, plain measurement sources."""
    if not isinstance(inner, ast.SelectStatement):
        return False
    if inner.limit or inner.offset or inner.slimit or inner.soffset:
        return False
    if inner.fill_option not in (None, "null", "none"):
        return False  # fill(previous/linear) crosses chunk edges and
        # fill(<number>) emits rows per KNOWN series — series discovery
        # is chunk-dependent, so numeric fill must evaluate single-shot
    if not all(isinstance(s, ast.Measurement) for s in inner.sources):
        return False
    calls = []
    for f in inner.fields:
        calls.extend(_calls_in(f.expr))
    if not calls:
        return True  # raw projection: rows are window-independent
    if inner.group_by_time is None:
        return False  # whole-range aggregate: cannot split
    for c in calls:
        if c.name in fnmod.TRANSFORMS or c.name == "sliding_window":
            return False  # sequence transforms need neighboring windows
    return True


def _row_fields(cols: list, vals) -> dict:
    """Result-row values -> typed field dict (shared by the subquery
    materializer and SELECT INTO — the two paths must classify python
    values into FieldTypes identically)."""
    fields = {}
    for name, v in zip(cols, vals):
        if v is None:
            continue
        if isinstance(v, bool):
            fields[name] = (FieldType.BOOL, v)
        elif isinstance(v, int):
            fields[name] = (FieldType.INT, v)
        elif isinstance(v, float):
            fields[name] = (FieldType.FLOAT, v)
        else:
            fields[name] = (FieldType.STRING, str(v))
    return fields


def _materialize_into(tmp_engine, mst_name: str, series_list,
                      spent: int = 0) -> int:
    """Write one inner-result batch into the spill engine. Points at the
    same (tags, time) MERGE their fields — multi-source inners
    legitimately emit one row per source at the same timestamp with
    disjoint columns, and the engine's point-level LWW would otherwise
    drop all but the last (TestServer_Query_MultiMeasurements#4/#5).
    Returns the cumulative row count; beyond SUBQUERY_MAX_ROWS the
    materialization fails loudly instead of exhausting memory/disk."""
    by_key: dict[tuple, dict] = {}
    key_order: list[tuple] = []
    for series in series_list:
        tags = tuple(sorted(series.get("tags", {}).items()))
        cols = series["columns"][1:]
        for row in series["values"]:
            fields = _row_fields(cols, row[1:])
            if fields:
                pkey = (tags, row[0])
                got = by_key.get(pkey)
                if got is None:
                    by_key[pkey] = fields
                    key_order.append(pkey)
                else:
                    got.update(fields)
    spent += len(key_order)
    if SUBQUERY_MAX_ROWS and spent > SUBQUERY_MAX_ROWS:
        raise QueryError(
            f"subquery materialized more than {SUBQUERY_MAX_ROWS} rows; "
            "narrow the inner time range (OGTPU_SUBQUERY_MAX_ROWS)")
    points = [
        (mst_name, tags, t, by_key[(tags, t)])
        for tags, t in key_order
    ]
    if points:
        tmp_engine.write_rows("sub", points)
    return spent


class SubqueryMixin:
    def _project_union(self, stmt, inner_res) -> list[dict] | None:
        """Raw column projection over a union subquery result; returns None
        when the outer statement needs real execution (aggregates, WHERE,
        grouping) and must fall back to materialization."""
        if (stmt.condition is not None or stmt.group_by_tags
                or stmt.group_by_all_tags or stmt.group_by_time):
            return None
        for f in stmt.fields:
            e = _strip_expr(f.expr)
            if not isinstance(e, (ast.VarRef, ast.Wildcard)):
                return None
        series = inner_res.get("series", [])
        if not series:
            return []
        src = series[0]
        cols_in = src["columns"]
        names, idxs = [], []
        for f in stmt.fields:
            e = _strip_expr(f.expr)
            if isinstance(e, ast.Wildcard):
                for i, c in enumerate(cols_in[1:], start=1):
                    names.append(c)
                    idxs.append(i)
            else:
                if e.name.lower() == "time":
                    continue  # always column 0
                names.append(f.alias or e.name)
                idxs.append(cols_in.index(e.name) if e.name in cols_in else -1)
        rows = [
            [row[0]] + [row[i] if i >= 0 else None for i in idxs]
            for row in src["values"]
        ]
        if not stmt.ascending:
            rows.reverse()
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit:
            rows = rows[: stmt.limit]
        return [{"name": src["name"], "columns": ["time"] + names, "values": rows}]

    def _project_dimensioned(self, stmt, series_list: list[dict],
                             dims: list[str], name: str):
        """Bare projection over a dimensioned subquery: one output series,
        dim tags as leading columns, inner rows (incl. all-null ones) in
        series order. Returns None when the outer needs real execution."""
        if (stmt.condition is not None or stmt.group_by_tags
                or stmt.group_by_all_tags or stmt.group_by_time
                or not series_list):
            return None
        for f in stmt.fields:
            if not isinstance(_strip_expr(f.expr), (ast.VarRef, ast.Wildcard)):
                return None
        cols_in = series_list[0]["columns"]
        names, sources = [], []  # source: ("dim", key) | ("col", idx)
        for f in stmt.fields:
            e = _strip_expr(f.expr)
            if isinstance(e, ast.Wildcard):
                for d in dims:
                    names.append(d)
                    sources.append(("dim", d))
                for i, c in enumerate(cols_in[1:], start=1):
                    names.append(c)
                    sources.append(("col", i))
            elif e.name.lower() == "time":
                continue
            elif e.name in dims:
                names.append(f.alias or e.name)
                sources.append(("dim", e.name))
            else:
                names.append(f.alias or e.name)
                sources.append(
                    ("col", cols_in.index(e.name))
                    if e.name in cols_in else ("col", -1))
        rows = []
        for s in series_list:
            tags = s.get("tags", {})
            for row in s["values"]:
                out = [row[0]]
                for kind, ref in sources:
                    if kind == "dim":
                        out.append(tags.get(ref))
                    else:
                        out.append(row[ref] if ref >= 0 else None)
                rows.append(out)
        if not stmt.ascending:
            rows.reverse()
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit:
            rows = rows[: stmt.limit]
        return [{"name": name, "columns": ["time"] + names, "values": rows}]

    def _write_into(self, target: ast.Measurement, db: str, series_list: list[dict]) -> int:
        """SELECT INTO: write result rows into the target measurement
        (reference: into clause handling in statement_executor.go). Rows go
        through the structured write path (WAL'd, schema-checked) — never
        through line-protocol text, so arbitrary tag/field content is safe."""
        tgt_db = target.database or db
        if tgt_db not in self.engine.databases:
            raise QueryError(f"database not found: {tgt_db}")
        points = []
        for series in series_list:
            base_tags = dict(series.get("tags", {}))
            cols = series["columns"][1:]
            # top/bottom(field, tag, N) columns marked as tags write back
            # as TAGS (reference TestServer_Query_TopBottomWriteTags)
            tag_cols = set(series.get("_tag_cols", ()))
            tag_idx = [(i, c) for i, c in enumerate(cols) if c in tag_cols]
            if not tag_idx:
                # the common path: one tag tuple per series, never per row
                tags_t = tuple(sorted(base_tags.items()))
                for row in series["values"]:
                    fields = _row_fields(cols, row[1:])
                    if fields:
                        points.append((target.name, tags_t, row[0], fields))
                continue
            field_idx = [i for i, c in enumerate(cols) if c not in tag_cols]
            for row in series["values"]:
                vals = row[1:]
                fields = _row_fields([cols[i] for i in field_idx],
                                     [vals[i] for i in field_idx])
                if fields:
                    tags = dict(base_tags)
                    for i, c in tag_idx:
                        if vals[i] is not None:
                            tags[c] = str(vals[i])
                    points.append((target.name,
                                   tuple(sorted(tags.items())),
                                   row[0], fields))
        if not points:
            return 0
        if self.router is not None:
            # INTO rows go to their shard groups' owners like any write:
            # rows kept only here would count twice in merged scans
            from opengemini_tpu_torch.parallel.cluster import RemoteScanError

            try:
                return self.router.routed_write(
                    tgt_db, target.rp or None, points)
            except (OSError, RemoteScanError) as e:
                raise QueryError(f"INTO forward failed: {e}") from e
        return self.engine.write_rows(tgt_db, points, rp=target.rp or None)

    def _select_from_subquery(self, stmt, src: ast.SubQuery, db: str,
                              now_ns: int, trace=tracing.NOOP) -> list[dict]:
        """FROM (SELECT ...): the inner result materializes into a
        throw-away engine (tags stay tags, columns become fields), then the
        outer statement runs against it. Reference: subquery builders in
        engine/executor/select.go; correctness-first materialization here,
        streaming later."""
        inner = src.stmt
        inner_has_wild = False
        if isinstance(inner, ast.SelectStatement):
            inner_has_wild = any(
                isinstance(_strip_expr(f.expr), ast.Wildcard)
                or _call_wildcard_inner(_strip_expr(f.expr)) is not None
                for f in inner.fields
            )
            if _classify_select(inner) == "raw" and not (
                inner.group_by_tags or inner.group_by_all_tags
            ):
                # influx propagates series tags through subqueries: a raw
                # inner select must emit per-series output, never one
                # merged series
                inner = copy.copy(inner)
                inner.group_by_all_tags = True
            elif (
                stmt.group_by_tags
                and not inner.group_by_tags
                and not inner.group_by_all_tags
            ):
                # influx subqueries INHERIT the outer GROUP BY dimensions:
                # an inner call (top/agg) computes per outer group and its
                # output series carry those tags
                # (TestServer_SubQuery_Top_Min#0)
                inner = copy.copy(inner)
                inner.group_by_tags = list(stmt.group_by_tags)
        # push the outer time range into the inner select so the inner scan
        # (and the materialization below) covers only the needed window
        if isinstance(inner, ast.UnionStatement):
            pass  # union bodies materialize whole (no time pushdown yet)
        else:
            try:
                sc_outer = cond.split(stmt.condition, set(), now_ns)
                if sc_outer.tmin != cond.MIN_TIME or sc_outer.tmax != cond.MAX_TIME:
                    bound = ast.BinaryExpr(
                        "AND",
                        ast.BinaryExpr(">=", ast.VarRef("time"),
                                       ast.IntegerLiteral(sc_outer.tmin)),
                        ast.BinaryExpr("<", ast.VarRef("time"),
                                       ast.IntegerLiteral(sc_outer.tmax)),
                    )
                    inner = copy.copy(inner)
                    inner.condition = (
                        bound if inner.condition is None
                        else ast.BinaryExpr("AND", inner.condition, bound)
                    )
            except cond.ConditionError:
                pass  # un-splittable outer condition: no pushdown
        chunk_plan = None
        if (
            not isinstance(inner, ast.UnionStatement)
            and _subquery_chunk_safe(inner)
            # a bare outer projection takes the _project_* fast paths on
            # the full inner result — chunking would bypass them
            and not (stmt.condition is None and not stmt.group_by_tags
                     and not stmt.group_by_all_tags
                     and not stmt.group_by_time
                     and all(isinstance(_strip_expr(f.expr),
                                        (ast.VarRef, ast.Wildcard))
                             for f in stmt.fields))
        ):
            chunk_plan = self._plan_subquery_chunks(inner, db, now_ns)
        if chunk_plan is not None:
            return self._run_subquery_chunked(
                stmt, src, inner, inner_has_wild, chunk_plan, db, now_ns,
                trace)
        with trace.span("subquery"):
            if isinstance(inner, ast.UnionStatement):
                from opengemini_tpu_torch.query import join as joinmod

                inner_res = joinmod.execute_union(self, inner, db, now_ns)
                # a raw projection over a union must NOT round-trip through
                # the point materializer: union rows legitimately repeat
                # (series, time) pairs, which the engine would LWW-dedup
                proj = self._project_union(stmt, inner_res)
                if proj is not None:
                    return proj
            else:
                inner_res = self._select(inner, db, now_ns, trace)
        series_list = inner_res.get("series", [])
        if (
            not isinstance(inner, ast.UnionStatement)
            and len(series_list) == 1
            and not series_list[0].get("tags")
        ):
            # single untagged inner series + bare outer projection: project
            # directly so all-null computed rows survive (the materializer
            # cannot represent a row whose only field is null —
            # TestServer_Query_SubqueryMath#0)
            proj = self._project_union(stmt, inner_res)
            if proj is not None:
                return proj
        if (
            not isinstance(inner, ast.UnionStatement)
            and isinstance(src.stmt, ast.SelectStatement)
            and src.stmt.group_by_tags
        ):
            # dimensioned inner (explicit GROUP BY tags): a bare outer
            # projection flattens series into one with the dims as columns,
            # null rows preserved (TestServer_Query_Sliding_Window #8/#9)
            proj = self._project_dimensioned(
                stmt, series_list, list(src.stmt.group_by_tags),
                _inner_source_name(inner))
            if proj is not None:
                return proj
        mst_name = _inner_source_name(inner)
        with self._spill_engine() as tmp_engine:
            _materialize_into(tmp_engine, mst_name, series_list)
            return self._run_outer_on(
                tmp_engine, stmt, src, inner_has_wild, mst_name,
                now_ns, trace)

    @contextlib.contextmanager
    def _spill_engine(self):
        """A throw-away Engine with database "sub" in a temporary
        directory, on the caller's device; closed and removed on every
        path out, errors included."""
        from opengemini_tpu_torch.storage.engine import Engine

        with tempfile.TemporaryDirectory(prefix="ogtpu-sub-") as tmp:
            tmp_engine = Engine(tmp, device=self.engine.device,
                                sync_wal=False)
            try:
                tmp_engine.create_database("sub")
                yield tmp_engine
            finally:
                tmp_engine.close()

    def _run_outer_on(self, tmp_engine, stmt, src, inner_has_wild,
                      mst_name, now_ns, trace):
        """Run the outer statement against the spill engine holding the
        materialized inner rows."""
        outer = copy.copy(stmt)
        outer.sources = [ast.Measurement(name=mst_name)]
        outer.into = None  # INTO applies once, in the caller
        # the source is now a materialized measurement: it must not
        # re-resolve as a CTE name against the throw-away engine
        outer.ctes = None
        # influx wildcard-over-subquery expands to the inner's
        # ORIGINAL output columns: explicit inner fields stay
        # fields-only; an inner wildcard (bare or inside a call)
        # lets the outer wildcard inline propagated tags. Inner
        # EXPLICIT GROUP BY tags are output dimensions — the outer
        # wildcard includes them as columns
        # (TestServer_Query_SubqueryForLogicalOptimize#5)
        outer._from_subquery = not inner_has_wild
        if isinstance(src.stmt, ast.SelectStatement):
            outer._subquery_dims = list(src.stmt.group_by_tags)
        # a flattenable plain-projection inner (bare field renames,
        # no grouping) donates its explicit time bounds to the
        # outer statement — the reference's subquery flattening
        # makes the outer render window start at the inner tmin
        # (SubqueryForLogicalOptimize#2); non-flattenable inners
        # (computed projections) keep epoch-0 rendering (#4)
        if (
            isinstance(src.stmt, ast.SelectStatement)
            and src.stmt.fields
            and all(isinstance(_strip_expr(f.expr), ast.VarRef)
                    for f in src.stmt.fields)
            and not src.stmt.group_by_tags
            and not src.stmt.group_by_all_tags
            and src.stmt.group_by_time is None
            and src.stmt.condition is not None
        ):
            try:
                sc_in = cond.split(src.stmt.condition, set(), now_ns)
                sc_out = cond.split(stmt.condition, set(), now_ns)
                if (
                    sc_out.tmin == cond.MIN_TIME
                    and sc_out.tmax == cond.MAX_TIME
                    and (sc_in.tmin != cond.MIN_TIME
                         or sc_in.tmax != cond.MAX_TIME)
                ):
                    bound = ast.BinaryExpr(
                        "AND",
                        ast.BinaryExpr(
                            ">=", ast.VarRef("time"),
                            ast.IntegerLiteral(sc_in.tmin)),
                        ast.BinaryExpr(
                            "<", ast.VarRef("time"),
                            ast.IntegerLiteral(sc_in.tmax)),
                    )
                    outer.condition = (
                        bound if outer.condition is None
                        else ast.BinaryExpr(
                            "AND", outer.condition, bound)
                    )
            except cond.ConditionError:
                pass
        from opengemini_tpu_torch.query.executor import Executor

        sub_ex = Executor(tmp_engine)
        res = sub_ex._select(outer, "sub", now_ns, trace)
        return res.get("series", [])

    def _plan_subquery_chunks(self, inner, db: str, now_ns: int):
        """[(lo, hi)] window-aligned chunk ranges when the estimated
        inner scan is big enough to bound, else None. The estimate comes
        from chunk metadata (same planner as the sliced scan)."""
        try:
            tag_keys = set()
            sc = cond.split(inner.condition, tag_keys, now_ns)
        except cond.ConditionError:
            return None
        tmin, tmax = sc.tmin, sc.tmax
        if tmin == cond.MIN_TIME or tmax == cond.MAX_TIME:
            return None  # unbounded range: nothing to split against
        total = 0
        for msrc in inner.sources:
            sdb = msrc.database or db
            shards = self.engine.shards_for_range(
                sdb, msrc.rp or None, tmin, tmax)
            for sh in shards:
                approx = getattr(sh, "approx_rows", None)
                if approx is None:
                    # remote shard: no cheap estimate — chunking is
                    # bypassed and only the row cap bounds the
                    # materialization. Record it so an OOM-adjacent
                    # incident is diagnosable.
                    STATS.incr("executor", "subquery_chunking_bypassed")
                    return None
                r, _c = approx(msrc.name, tmin, tmax)
                total += r
        if total < SUBQUERY_CHUNK_ROWS:
            return None
        n_chunks = min(-(-total // SUBQUERY_CHUNK_TARGET), 256)
        if n_chunks < 2:
            return None
        gt = inner.group_by_time
        if gt is not None:
            aligned = int(winmod.window_start(
                tmin, gt.every_ns, gt.offset_ns))
            W = winmod.num_windows(tmin, tmax, gt.every_ns, gt.offset_ns)
            per = -(-W // n_chunks)
            if per < 1 or per >= W:
                return None
            bounds = [aligned + i * per * gt.every_ns
                      for i in range(1, n_chunks)]
        else:
            span = tmax - tmin
            bounds = [tmin + span * i // n_chunks
                      for i in range(1, n_chunks)]
        edges = [tmin] + [b for b in bounds if tmin < b < tmax] + [tmax]
        return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)
                if edges[i] < edges[i + 1]]

    def _run_subquery_chunked(self, stmt, src, inner, inner_has_wild,
                              chunk_plan, db, now_ns, trace):
        """Evaluate the inner select chunk-by-chunk into one spill
        engine, then run the outer once. Peak memory is one chunk's
        JSON intermediate; the spill engine flushes to TSF as it grows
        (reference: streaming subquery_transform.go)."""
        mst_name = _inner_source_name(inner)
        with self._spill_engine() as tmp_engine:
            with trace.span("subquery(chunked)") as sp:
                sp.add_field("chunks", len(chunk_plan))
                spent = 0
                for lo, hi in chunk_plan:
                    TRACKER.check()
                    part = copy.copy(inner)
                    bound = ast.BinaryExpr(
                        "AND",
                        ast.BinaryExpr(">=", ast.VarRef("time"),
                                       ast.IntegerLiteral(lo)),
                        ast.BinaryExpr("<", ast.VarRef("time"),
                                       ast.IntegerLiteral(hi)),
                    )
                    part.condition = (
                        bound if part.condition is None
                        else ast.BinaryExpr("AND", part.condition, bound))
                    part_res = self._select(part, db, now_ns, trace)
                    spent = _materialize_into(
                        tmp_engine, mst_name, part_res.get("series", []),
                        spent)
            return self._run_outer_on(
                tmp_engine, stmt, src, inner_has_wild, mst_name, now_ns,
                trace)
