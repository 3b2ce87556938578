"""Host-evaluated select paths (an Executor mixin): raw projection,
transform and multi-row functions, selectors with auxiliary columns,
top/bottom with companions, count/first/last over strings and
aggregates over time.

The port of ``opengemini_tpu/query/hostpath.py``. As in the reference
it is numpy on the host: stored columns decode on the host through the
native codecs (``record.EncodedColumn.values`` over
``storage/encoding.decode_value_blocks``), and no column of this path is
copied to the device, and the decode runs on the scan pool's threads.
The raw projection reads a shard's series of one select in one bulk
read when there are many of them (as the aggregate scan does), takes
only the rows LIMIT and OFFSET can keep, and builds its rows
column-wise (numpy ``tolist``) instead of point by point, with the
reference's answers; its stages are ``map_shards``, ``scan`` and
``render``, those of the other host paths ``map_shards`` and
``host_compute``.

A raw select over a subquery's spill engine lists the inner select's
explicit GROUP BY tags as wildcard columns and keeps the inner series
order when it is not grouped (``_from_subquery`` and ``_subquery_dims``,
set by query/subquery.py).

``percentile_approx`` answers from query/sketch.py's histogram sketch
(chunk histograms where a series' chunks allow it, decoded values
elsewhere), and a table function (``rca``, query/tablefunc.py) runs over
the raw rows of its measurement. Every read loop is a KILL QUERY
cancellation point (``TRACKER.check()``). A raw select's conjunctive
``match()`` terms prune its series through the shards' text sidecars
(qhelpers ``_prune_text_sids``); a damaged file met by a chunk read is
quarantined through its shard (``FileQuarantined``).

Not in this port yet: fitted ``detect`` models (ROADMAP A7.2); remote
shards (ROADMAP A8: the shard list is the local one).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.query import functions as fnmod
from opengemini_tpu_torch.record import EncodedColumn, FieldType
from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.storage import scanpool
from opengemini_tpu_torch.storage.tsf import CorruptFile
from opengemini_tpu_torch.utils import tracing
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.query.qhelpers import (
    QueryError, _apply_fill, _calls_in, _call_param_value,
    _check_host_field_type, _default_field_name, _eval_aux_expr,
    _eval_scalar_cols, _eval_scalar_row, _prune_text_sids, _pyval,
    _render_cell, _resolve_host_call, _scalar_refs, _selector_pick, _series,
    _series_needs_merged_decode, _strip_expr,
)


def _is_time_field(f) -> bool:
    """Explicit `SELECT time, ...` — always column 0, never a real
    projection/companion (the one definition all three call sites
    share)."""
    e = _strip_expr(f.expr)
    return isinstance(e, ast.VarRef) and e.name.lower() == "time"


def _pycol(values: np.ndarray, valid: np.ndarray, ftype) -> list:
    """One column of raw rows as Python values: ``_pyval`` of each valid
    entry, None elsewhere (and for non-finite floats), in one pass per
    column."""
    if ftype == FieldType.FLOAT:
        v = values.astype(np.float64)
        out = v.tolist()
        bad = ~valid | ~np.isfinite(v)
    elif ftype == FieldType.INT:
        out = values.astype(np.int64).tolist()
        bad = ~valid
    elif ftype == FieldType.BOOL:
        out = values.astype(np.bool_).tolist()
        bad = ~valid
    else:
        out = [v if isinstance(v, str) else str(v) for v in values.tolist()]
        bad = ~valid
    for i in np.flatnonzero(bad).tolist():
        out[i] = None
    return out


def _eval_host_output(e, bt, col_maps, call_plan_idx):
    """Evaluate a call-math output expression at one window: leaves are
    host-call plan columns (absent -> null, which poisons the expression
    like influx), numeric literals, and +-*/% with null-on-zero-divide."""
    e = _strip_expr(e)
    if isinstance(e, ast.Call):
        entry = col_maps[call_plan_idx[id(e)]].get(bt)
        if entry is None:
            return None, False
        return entry[0], True
    if isinstance(e, (ast.IntegerLiteral, ast.NumberLiteral)):
        return e.val, False
    if isinstance(e, ast.DurationLiteral):
        return e.val_ns, False
    if isinstance(e, ast.UnaryExpr) and e.op == "-":
        v, p = _eval_host_output(e.expr, bt, col_maps, call_plan_idx)
        return (None if v is None else -v), p
    if isinstance(e, ast.BinaryExpr):
        lv, lp = _eval_host_output(e.lhs, bt, col_maps, call_plan_idx)
        rv, rp = _eval_host_output(e.rhs, bt, col_maps, call_plan_idx)
        present = lp or rp
        if lv is None or rv is None:
            return None, present
        try:
            if e.op == "+":
                return lv + rv, present
            if e.op == "-":
                return lv - rv, present
            if e.op == "*":
                return lv * rv, present
            if e.op == "/":
                return (None if rv == 0 else lv / rv), present
            if e.op == "%":
                return (None if rv == 0 else lv % rv), present
        except TypeError:
            return None, present
    raise QueryError(
        "unsupported expression in host-path SELECT (functions, numbers "
        "and +-*/% only)")


# a shard scanned for this many series of one raw select reads them in
# one bulk read (each packed chunk decodes once), as the aggregate scan
# does (executor._scan_monolithic)
_BULK_SERIES = 64


def _decode_on_pool(columns) -> None:
    """Decode the still-encoded blocks under `columns` on the scan pool
    (the native codecs release the GIL), one job per root column, so the
    host decode of a wide select runs on every core."""
    units = {id(r): r for c in columns
             if isinstance(c, EncodedColumn) and not c.is_decoded
             for r in c.roots() if not r.is_decoded}
    jobs = [lambda r=r: r.values for r in units.values()]
    for _ in scanpool.map_ordered(jobs, [8 * len(r) for r in units.values()]):
        pass


def _raw_columns(rec, columns, src_of, const_cols, expr_cols, tag_only):
    """The output columns of a raw select over `rec` (one series, or a
    shard's bulk read of many), and the rows where a selected field is
    present (tag-only selects: any field at all). A column is ("arr",
    values, valid, ftype), ("lit", constant) or ("tag", name): a tag
    value, or null where the series has no such tag."""
    _decode_on_pool(rec.columns.values())
    present = np.zeros(len(rec), dtype=bool)
    cols = []
    for name in columns[1:]:
        if name in const_cols:
            cols.append(("lit", const_cols[name]))
            continue
        ref = src_of[name]
        if ref in expr_cols:
            vals, valid, touched = _eval_scalar_cols(expr_cols[ref], rec)
            cols.append(("arr", vals, valid, FieldType.FLOAT))
            present |= touched
            continue
        col = rec.columns.get(ref)
        if col is not None:
            cols.append(("arr", col.values, col.valid, col.ftype))
            present |= col.valid
        else:
            cols.append(("tag", ref))
    if tag_only:
        for col in rec.columns.values():
            present |= col.valid
    return cols, present


def _raw_take(times, emit, cols, tags, lo, hi, keep, ascending):
    """One series' emitted rows, rows [lo, hi) of the arrays, as (times,
    columns); None when it emits none. With `keep` (LIMIT plus OFFSET)
    only the first `keep` rows in the statement's order are taken: the
    rest can never reach the answer."""
    sel = np.flatnonzero(emit[lo:hi])
    if keep is not None and len(sel) > keep and bool(
            (np.diff(times[lo:hi]) >= 0).all()):
        sel = sel[:keep] if ascending else sel[-keep:]
    if not len(sel):
        return None
    idx = sel + lo
    out = []
    for kind, *payload in cols:
        if kind == "arr":
            values, valid, ftype = payload
            out.append(("arr", values[idx], valid[idx], ftype))
        elif kind == "tag":
            v = tags.get(payload[0])
            out.append(("lit", v if isinstance(v, str) else None))
        else:
            v = payload[0]
            out.append(("lit", v if isinstance(v, str) else None))
    return times[idx], out


def _raw_bulk(sh, entries, mst, sc, read_fields, spec, keep, ascending):
    """{(id(sh), sid): rows} of a raw select's series in shard `sh`
    (`entries` = [(sid, tags)]) from one bulk read: the row filter, the
    columns and their host decode run once over all of them, and each
    series takes its rows out of the shared arrays."""
    sids = np.asarray(sorted(sid for sid, _t in entries), np.int64)
    sid_arr, rec = sh.read_series_bulk(mst, sids, sc.tmin, sc.tmax,
                                       fields=read_fields)
    if len(rec) == 0:
        return {}
    fmask = (cond.eval_row_filter(sc, rec, sid_arr=sid_arr, index=sh.index)
             if sc.has_row_filter else np.ones(len(rec), dtype=bool))
    cols, present = _raw_columns(rec, *spec)
    emit = fmask & present
    los = np.searchsorted(sid_arr, sids, side="left")
    his = np.searchsorted(sid_arr, sids, side="right")
    where = {int(s): (int(lo), int(hi)) for s, lo, hi in zip(sids, los, his)}
    out = {}
    for sid, tags in entries:
        lo, hi = where[sid]
        if hi > lo:
            out[(id(sh), sid)] = _raw_take(rec.times, emit, cols, tags, lo,
                                           hi, keep, ascending)
    return out


class HostPathMixin:
    def _select_percentile_approx(self, stmt, db, rp, mst, now_ns, call) -> list[dict]:
        """percentile_approx(field, q): served from the per-chunk histogram
        sketches in TSF pre-agg metadata — covered chunks contribute their
        histograms with NO data decode (reference: OGSketch, persisted).
        Memtable rows, partially-covered and histogram-less chunks decode
        and bin exactly, and so does every series whose chunks are packed
        (``_series_needs_merged_decode``). Error: within one chunk-histogram
        bin width (chunk_range/32) for sketch-served mass, one global bin
        width (range/256) for directly-binned rows."""
        from opengemini_tpu_torch.query.sketch import HistSketch

        if stmt.group_by_time is not None:
            raise QueryError("percentile_approx() does not support GROUP BY time yet")
        if len(call.args) != 2:
            raise QueryError("percentile_approx() takes (field, q)")
        fld = _strip_expr(call.args[0])
        if not isinstance(fld, ast.VarRef):
            raise QueryError("percentile_approx() field must be a field name")
        qv = float(_call_param_value(call.args[1]))
        if not (0 <= qv <= 100):
            raise QueryError("percentile_approx() q must be between 0 and 100")
        fname = fld.name
        ctx = self._scan_context(stmt, db, rp, mst, now_ns)
        if ctx is None:
            return []
        if ctx.schema.get(fname) not in (FieldType.FLOAT, FieldType.INT):
            raise QueryError("percentile_approx() requires a numeric field")
        if ctx.sc.has_row_filter:
            raise QueryError("percentile_approx() does not support field filters")
        tmin, tmax = ctx.tmin, ctx.tmax

        # pass 1: per group, chunk hists (zero decode) or decoded values;
        # any dedup risk (overlapping chunks / memtable rows) falls the
        # whole series back to the merged read_series view
        plans: dict[int, list] = {}  # gid -> [(kind, payload)]
        bounds: dict[int, list] = {}

        def _add_vals(gid, vals):
            vals = vals[np.isfinite(vals)]  # nan/inf points never bin
            if not len(vals):
                return
            plans.setdefault(gid, []).append(("values", vals))
            b = bounds.setdefault(gid, [np.inf, -np.inf])
            b[0] = min(b[0], float(vals.min()))
            b[1] = max(b[1], float(vals.max()))

        # the series that need the merged view, read in one bulk read per
        # shard where there are many (the reference reads each on its
        # own: the same rows, but a packed chunk decodes once per series
        # it holds); the sketch then takes them in scan-plan order
        probes = []
        merged: dict[int, tuple] = {}
        for sh, sid, gid in ctx.scan_plan:
            TRACKER.check()  # KILL QUERY cancellation point
            needs_merge, srcs = _series_needs_merged_decode(
                sh, mst, sid, tmin, tmax)
            probes.append((sh, sid, gid, needs_merge, srcs))
            if needs_merge:
                merged.setdefault(id(sh), (sh, []))[1].append(sid)
        bulk: dict[tuple, np.ndarray] = {}
        bulk_shards = set()
        for sh, sids in merged.values():
            if len(sids) < _BULK_SERIES:
                continue
            TRACKER.check()
            bulk_shards.add(id(sh))
            sids = np.asarray(sorted(sids), np.int64)
            sid_arr, rec = sh.read_series_bulk(mst, sids, tmin, tmax,
                                               fields=[fname])
            col = rec.columns.get(fname)
            if col is None or not len(rec):
                continue
            vals, valid = col.values, col.valid
            los = np.searchsorted(sid_arr, sids, side="left")
            his = np.searchsorted(sid_arr, sids, side="right")
            for sid, lo, hi in zip(sids.tolist(), los, his):
                if hi > lo:
                    bulk[(id(sh), sid)] = vals[lo:hi][valid[lo:hi]].astype(
                        np.float64)

        for sh, sid, gid, needs_merge, srcs in probes:
            if needs_merge:
                if id(sh) in bulk_shards:
                    got = bulk.get((id(sh), sid))
                    if got is not None:
                        _add_vals(gid, got)
                    continue
                rec = sh.read_series(mst, sid, tmin, tmax, fields=[fname])
                col = rec.columns.get(fname)
                if col is not None and len(rec):
                    _add_vals(gid, col.values[col.valid].astype(np.float64))
                continue
            for r, c in srcs:
                loc = c.cols.get(fname)
                pre = loc["pre"] if loc else None
                covered = tmin <= c.tmin and c.tmax < tmax
                if covered and pre is not None and pre.count and pre.hist is not None:
                    plans.setdefault(gid, []).append(("hist", pre))
                    b = bounds.setdefault(gid, [np.inf, -np.inf])
                    b[0] = min(b[0], pre.vmin)
                    b[1] = max(b[1], pre.vmax)
                else:
                    try:
                        rec = r.read_chunk(
                            mst, c, [fname]).slice_time(tmin, tmax)
                    except CorruptFile as e:
                        sh.note_corrupt(e)  # raises FileQuarantined
                    col = rec.columns.get(fname)
                    if col is not None and len(rec):
                        _add_vals(gid, col.values[col.valid].astype(np.float64))

        name = stmt.fields[0].alias or "percentile_approx"
        out_series = []
        order = sorted(range(len(ctx.group_keys)), key=lambda g: ctx.group_keys[g])
        t0 = ctx.aligned if ctx.aligned else 0
        for g in order:
            entries = plans.get(g)
            if not entries:
                continue
            lo, hi = bounds[g]
            sk = HistSketch(lo, hi)
            for kind, payload in entries:
                if kind == "hist":
                    sk.add_chunk_hist(payload.vmin, payload.vmax, payload.hist)
                else:
                    sk.add_values(payload)
            v = sk.percentile(qv)
            if v is None:
                continue
            rows = [[t0, v]]
            if not stmt.ascending:
                rows.reverse()
            rows = rows[stmt.offset :]
            if stmt.limit:
                rows = rows[: stmt.limit]
            if not rows:
                continue
            series = {"name": mst, "columns": ["time", name], "values": rows}
            if ctx.group_tags:
                series["tags"] = dict(zip(ctx.group_tags, ctx.group_keys[g]))
            out_series.append(series)
        return out_series

    # -- selector + auxiliary columns (host path) ----------------------------


    def _select_selector_aux(self, stmt, db, rp, mst, now_ns, plan) -> list[dict]:
        """One selector call + bare/arithmetic auxiliary columns: the
        selector picks rows, aux columns are read from the selected rows
        (reference: aux fields in the cursor iterators, call iterator
        top/bottom transforms).  time = the selected point's timestamp,
        except 1-row selectors under GROUP BY time, which emit the window
        start (matching the reference's output tables)."""
        sel_call, aux_fields = plan
        sel_name = sel_call.name
        sel_field = _strip_expr(sel_call.args[0]).name
        n_rows = 1
        if sel_name in ("top", "bottom"):
            if len(sel_call.args) != 2:
                raise QueryError(f"{sel_name}() takes (field, N)")
            n_rows = int(_call_param_value(sel_call.args[1]))
            if n_rows <= 0:
                raise QueryError(f"{sel_name}() N must be positive")
        pctl = None
        if sel_name == "percentile":
            if len(sel_call.args) != 2:
                raise QueryError("percentile() takes (field, p)")
            pctl = float(_call_param_value(sel_call.args[1]))

        trace = tracing.current()
        with trace.span("map_shards"):
            ctx = self._scan_context(stmt, db, rp, mst, now_ns)
        if ctx is None:
            return []
        with trace.span("host_compute"):
            return self._selector_aux_rows(stmt, ctx, mst, sel_call,
                                           aux_fields, n_rows, pctl)

    def _selector_aux_rows(self, stmt, ctx, mst, sel_call, aux_fields,
                           n_rows, pctl) -> list[dict]:
        sel_name = sel_call.name
        sel_field = _strip_expr(sel_call.args[0]).name
        sc, schema = ctx.sc, ctx.schema
        tmin, tmax = ctx.tmin, ctx.tmax
        group_time, aligned, W = ctx.group_time, ctx.aligned, ctx.W
        every = group_time.every_ns if group_time else 0

        if (schema.get(sel_field) == FieldType.STRING
                and sel_name not in ("first", "last")):
            raise QueryError(
                f"{sel_name}() is not supported on string field {sel_field!r}")

        # output columns: drop explicit bare `time` refs (always col 0)
        columns = ["time"]
        col_plans = []  # ("sel",) | ("aux", expr)
        used_names: dict[str, int] = {}
        for f in stmt.fields:
            e = _strip_expr(f.expr)
            if isinstance(e, ast.VarRef) and e.name.lower() == "time":
                continue
            name = f.alias or _default_field_name(e)
            k = used_names.get(name, 0)
            used_names[name] = k + 1
            if k:
                name = f"{name}_{k}"
            columns.append(name)
            if isinstance(e, ast.Call):
                col_plans.append(("sel",))
            else:
                col_plans.append(("aux", e))

        aux_field_names = [n for n in aux_fields if n in schema]
        read_fields = sorted({sel_field, *aux_field_names}
                             | cond.row_filter_refs(sc))

        groups: dict[int, list] = {}
        for sh, sid, gid in ctx.scan_plan:
            groups.setdefault(gid, []).append((sh, sid))

        out_series = []
        for gid in sorted(groups, key=lambda g: ctx.group_keys[g]):
            key = ctx.group_keys[gid]
            # gather rows of every member series: time, selector value,
            # aux field columns, per-row tag values
            t_list, v_list = [], []
            aux_cols: dict[str, list] = {n: [] for n in aux_field_names}
            aux_valid: dict[str, list] = {n: [] for n in aux_field_names}
            tag_cols: dict[str, list] = {}
            tag_names = {
                n for n in aux_fields if n not in schema
            }
            for n in tag_names:
                tag_cols[n] = []
            for sh, sid in groups[gid]:
                TRACKER.check()  # KILL QUERY cancellation point
                rec = sh.read_series(mst, sid, tmin, tmax, fields=read_fields)
                col = rec.columns.get(sel_field)
                if col is None or len(rec) == 0:
                    continue
                m = col.valid.copy()
                if sc.has_row_filter:
                    m &= cond.eval_row_filter(sc, rec,
                                              tags=sh.index.tags_of(sid))
                if not m.any():
                    continue
                t_list.append(rec.times[m])
                v_list.append(col.values[m])
                nsel = int(m.sum())
                for n in aux_field_names:
                    ac = rec.columns.get(n)
                    if ac is None:
                        aux_cols[n].append(np.full(nsel, np.nan))
                        aux_valid[n].append(np.zeros(nsel, bool))
                    else:
                        aux_cols[n].append(np.asarray(ac.values)[m])
                        aux_valid[n].append(np.asarray(ac.valid)[m])
                _, tags = sh.index.series_entry(sid)
                tagd = dict(tags)
                for n in tag_names:
                    tag_cols[n].append([tagd.get(n)] * nsel)
            if not t_list:
                continue
            t = np.concatenate(t_list)
            v = np.concatenate(v_list)
            order = np.argsort(t, kind="stable")
            t, v = t[order], v[order]
            aux_arr = {
                n: (np.concatenate(aux_cols[n])[order],
                    np.concatenate(aux_valid[n])[order])
                for n in aux_field_names
            }
            tag_arr = {
                n: [x for chunk in tag_cols[n] for x in chunk]
                for n in tag_names
            }
            for n, vals in tag_arr.items():
                tag_arr[n] = [vals[i] for i in order]

            if group_time:
                bounds = np.searchsorted(
                    t, [aligned + w * every for w in range(W + 1)]
                )
                windows = [
                    (aligned + w * every, slice(bounds[w], bounds[w + 1]))
                    for w in range(W)
                ]
            else:
                windows = [(aligned, slice(None))]

            rows = []
            for t_out, sl in windows:
                tw, vw = t[sl], v[sl]
                base = sl.start or 0
                if len(vw) == 0:
                    if n_rows == 1 and sel_name not in ("top", "bottom"):
                        rows.append((t_out, [None] * (len(columns) - 1), False))
                    continue
                idxs = _selector_pick(sel_name, tw, vw, n_rows, pctl)
                for i in idxs:
                    ri = base + int(i)
                    vals = []
                    for cp in col_plans:
                        if cp[0] == "sel":
                            vals.append(_render_cell(
                                v[ri], schema.get(sel_field), sel_name))
                        else:
                            vals.append(_eval_aux_expr(
                                cp[1], ri, aux_arr, tag_arr, schema))
                    t_row = (
                        t_out
                        if (group_time and n_rows == 1
                            and sel_name not in ("top", "bottom"))
                        else int(t[ri])
                    )
                    rows.append((t_row, vals, True))
            if n_rows == 1 and sel_name not in ("top", "bottom"):
                rows = _apply_fill(rows, stmt, columns)
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
                "values": [[tr] + vv for tr, vv, _p in rows],
            }
            if ctx.group_tags:
                series["tags"] = dict(zip(ctx.group_tags, key))
            out_series.append(series)
        return out_series


    def _select_top_companions(self, stmt, ctx, multi_plan, mst) -> list[dict]:
        """top()/bottom() with companion projections: select rows by the
        call, then evaluate every other projection against the SELECTED
        source rows (wildcards expand to fields+tags; scalar math follows
        the raw-path null rules). Reference: the reference's top/bottom
        transform keeps auxiliary columns from the winning rows
        (TestServer_Query_For_BugList#2, TestServer_SubQuery_Top_Min#0)."""
        sel_name, call_name, sel_field, params = multi_plan
        sc, schema, tag_keys = ctx.sc, ctx.schema, ctx.tag_keys
        group_time, aligned, W = ctx.group_time, ctx.aligned, ctx.W

        cols = []  # (output name, spec)
        for f in stmt.fields:
            if _is_time_field(f):
                continue  # explicit time is column 0, not a companion
            e = _strip_expr(f.expr)
            if isinstance(e, ast.Call):
                cols.append((f.alias or _default_field_name(e), ("top",)))
            elif isinstance(e, ast.Wildcard):
                for n in sorted(set(schema) | tag_keys):
                    if n in schema:
                        cols.append((n, ("field", n)))
                    else:
                        cols.append((n, ("tag", n)))
            elif isinstance(e, ast.VarRef):
                kind = ("tag", e.name) if e.name in tag_keys and \
                    e.name not in schema else ("field", e.name)
                cols.append((f.alias or e.name, kind))
            else:
                cols.append((f.alias or _default_field_name(f.expr),
                             ("expr", e)))
        need_fields = {sel_field}
        for _n, spec in cols:
            if spec[0] == "field":
                need_fields.add(spec[1])
            elif spec[0] == "expr":
                need_fields |= _scalar_refs(spec[1])
        read_fields = sorted((need_fields | cond.row_filter_refs(sc))
                             & set(schema))

        groups: dict[tuple, list] = {}
        for sh, sid, gid in ctx.scan_plan:
            groups.setdefault(ctx.group_keys[gid], []).append((sh, sid))

        out_series = []
        for key in sorted(groups):
            times_l, topv_l, rowcols_l, tags_l = [], [], [], []
            for sh, sid in groups[key]:
                TRACKER.check()  # KILL QUERY cancellation point
                rec = sh.read_series(mst, sid, ctx.tmin, ctx.tmax,
                                     fields=read_fields)
                col = rec.columns.get(sel_field)
                if col is None or len(rec) == 0:
                    continue
                m = col.valid.copy()
                if sc.has_row_filter:
                    m &= cond.eval_row_filter(
                        sc, rec, tags=sh.index.tags_of(sid))
                if not m.any():
                    continue
                times_l.append(rec.times[m])
                topv_l.append(col.values[m].astype(np.float64))
                per = {}
                for fname in read_fields:
                    c2 = rec.columns.get(fname)
                    if c2 is not None:
                        per[fname] = (c2.values[m], c2.valid[m], c2.ftype)
                rowcols_l.append(per)
                tags_l.append((sh.index.tags_of(sid), int(m.sum())))
            if not times_l:
                continue
            t = np.concatenate(times_l)
            v = np.concatenate(topv_l)
            src_i = np.concatenate([
                np.full(n, i, np.int32)
                for i, (_tg, n) in enumerate(tags_l)
            ])
            off_i = np.concatenate([
                np.arange(n, dtype=np.int64) for _tg, n in tags_l
            ])
            order = np.argsort(t, kind="stable")
            t, v, src_i, off_i = t[order], v[order], src_i[order], off_i[order]

            def window_bounds():
                if not group_time:
                    return [slice(None)]
                bs = np.searchsorted(
                    t, [aligned + w * group_time.every_ns for w in range(W + 1)])
                return [slice(bs[w], bs[w + 1]) for w in range(W)]

            def row_value(spec, si, oi):
                per = rowcols_l[si]
                if spec[0] == "tag":
                    return tags_l[si][0].get(spec[1])
                if spec[0] == "field":
                    got = per.get(spec[1])
                    if got is None or not got[1][oi]:
                        return None
                    return _pyval(got[0][oi], got[2])
                return _eval_scalar_row(spec[1], per, tags_l[si][0], oi)

            rows = []
            for sl in window_bounds():
                idx = fnmod.select_top_bottom_idx(
                    call_name, t[sl], v[sl], params)
                base = sl.start or 0
                for i in idx:
                    gi = base + int(i)
                    row = [int(t[gi])]
                    for _n, spec in cols:
                        if spec[0] == "top":
                            row.append(_pyval(v[gi], schema.get(sel_field)))
                        else:
                            row.append(
                                row_value(spec, int(src_i[gi]), int(off_i[gi])))
                    rows.append(row)
            if not stmt.ascending:
                rows.reverse()
            if stmt.offset:
                rows = rows[stmt.offset:]
            if stmt.limit:
                rows = rows[: stmt.limit]
            if not rows:
                continue
            series = {"name": mst, "columns": ["time"] + [n for n, _s in cols],
                      "values": rows}
            if ctx.group_tags:
                series["tags"] = dict(zip(ctx.group_tags, key))
            out_series.append(series)
        return out_series

    # -- host function path (transforms, mode/integral/top/bottom/...) ------


    def _select_host(self, stmt, db, rp, mst, now_ns) -> list[dict]:
        """General host path for calls outside the device aggregate set
        (reference: sql-side transform processors, SURVEY.md §2.3)."""
        trace = tracing.current()
        with trace.span("map_shards"):
            ctx = self._scan_context(stmt, db, rp, mst, now_ns)
        if ctx is None:
            return []
        with trace.span("host_compute"):
            return self._host_rows(stmt, ctx, mst)

    def _host_rows(self, stmt, ctx, mst) -> list[dict]:
        sc, schema = ctx.sc, ctx.schema
        tmin, tmax = ctx.tmin, ctx.tmax
        group_time, aligned, W = ctx.group_time, ctx.aligned, ctx.W
        group_tags = ctx.group_tags
        if group_time:
            window_times = [aligned + w * group_time.every_ns for w in range(W)]
        else:
            window_times = [aligned]
        groups: dict[tuple, list] = {}
        for sh, sid, gid in ctx.scan_plan:
            groups.setdefault(ctx.group_keys[gid], []).append((sh, sid))

        # top/bottom with companion columns (wildcards, fields, math):
        # detected before plan resolution — companions are not calls
        if len(stmt.fields) > 1:
            tb = [
                _strip_expr(f.expr) for f in stmt.fields
                if isinstance(_strip_expr(f.expr), ast.Call)
                and _strip_expr(f.expr).name.lower() in ("top", "bottom")
            ]
            if len(tb) == 1 and all(
                not isinstance(_strip_expr(f.expr), ast.Call)
                or _strip_expr(f.expr) is tb[0]
                for f in stmt.fields
            ):
                e = tb[0]
                _kind, call_name, field, params, _inner = _resolve_host_call(
                    e, group_time)
                if len(params) == 2 and isinstance(params[1], tuple):
                    # companion columns would silently ignore the
                    # per-tag selection — refuse loudly
                    raise QueryError(
                        f"{call_name}(field, tag..., N) cannot be "
                        "combined with other columns")
                name = next(
                    (f.alias for f in stmt.fields
                     if _strip_expr(f.expr) is e and f.alias),
                    _default_field_name(e))
                return self._select_top_companions(
                    stmt, ctx, (name, call_name, field, params), mst)

        # resolve output columns
        plans = []  # (name, kind, call_name, field, params, inner_agg|None)
        multi_plan = None
        outputs = []  # (name, plan_index | ast expr for call math)
        call_plan_idx: dict[int, int] = {}  # id(call) -> plans index

        def _plan_call(e: ast.Call) -> int:
            kind, call_name, field, params, inner = _resolve_host_call(
                e, group_time)
            _check_host_field_type(
                inner[0] if kind == "sliding" and inner else call_name,
                field, schema)
            if kind == "multi":
                raise QueryError(
                    f"{call_name}() cannot be combined with other "
                    "expressions")
            plans.append((None, kind, call_name, field, params, inner))
            call_plan_idx[id(e)] = len(plans) - 1
            return len(plans) - 1

        for f in stmt.fields:
            if _is_time_field(f):
                continue  # explicit `time` is always column 0
            e = _strip_expr(f.expr)
            if not isinstance(e, ast.Call):
                # scalar math over host calls: `4 * mode(v)`,
                # `sum(v) / elapsed(sum(v), 1m)` — every leaf call gets
                # its own plan, the expression evaluates per window
                # (reference: sql-side binary-expr materialize transform)
                calls = _calls_in(f.expr)
                if not calls:
                    raise QueryError(
                        "host-path expressions need at least one function")
                for c in calls:
                    _plan_call(c)
                outputs.append((f.alias or _default_field_name(f.expr),
                                f.expr))
                continue
            name = f.alias or _default_field_name(e)
            kind, call_name, field, params, inner = _resolve_host_call(e, group_time)
            _check_host_field_type(
                inner[0] if kind == "sliding" and inner else call_name,
                field, schema)
            if kind == "multi":
                if sum(1 for f2 in stmt.fields
                       if not _is_time_field(f2)) > 1:
                    raise QueryError(f"{call_name}() must be the only field")
                if call_name == "distinct" and field in sc.tag_keys \
                        and field not in schema:
                    # influx: DISTINCT over a tag is not a field selection
                    raise QueryError(
                        "statement must have at least one field in "
                        "select clause")
                multi_plan = (name, call_name, field, params)
            else:
                plans.append((name, kind, call_name, field, params, inner))
                outputs.append((name, len(plans) - 1))

        out_series = []
        for key in sorted(groups):
            rows_by_field: dict[str, tuple[np.ndarray, np.ndarray]] = {}

            def field_rows(fname: str):
                got = rows_by_field.get(fname)
                if got is not None:
                    return got
                ts_list, vs_list = [], []
                for sh, sid in groups[key]:
                    TRACKER.check()  # KILL QUERY cancellation point
                    rec = sh.read_series(
                        mst, sid, tmin, tmax,
                        fields=[fname] + sorted(cond.row_filter_refs(sc)))
                    col = rec.columns.get(fname)
                    if col is None or len(rec) == 0:
                        continue
                    m = col.valid.copy()
                    if sc.has_row_filter:
                        m &= cond.eval_row_filter(
                            sc, rec, tags=sh.index.tags_of(sid))
                    ts_list.append(rec.times[m])
                    vs_list.append(col.values[m])
                if not ts_list:
                    got = (np.empty(0, np.int64), np.empty(0))
                else:
                    t = np.concatenate(ts_list)
                    v = np.concatenate(vs_list)
                    order = np.argsort(t, kind="stable")
                    got = (t[order], v[order])
                rows_by_field[fname] = got
                return got

            def window_slices(t: np.ndarray):
                if not group_time:
                    return [(window_times[0], slice(None))]
                bounds = np.searchsorted(
                    t, [aligned + w * group_time.every_ns for w in range(W + 1)]
                )
                return [
                    (window_times[w], slice(bounds[w], bounds[w + 1]))
                    for w in range(W)
                ]

            if multi_plan is not None and len(multi_plan[3]) == 2 and \
                    multi_plan[1] in ("top", "bottom") and \
                    isinstance(multi_plan[3][1], tuple):
                series = self._multi_top_tags(
                    stmt, multi_plan, groups[key], mst, tmin, tmax, sc,
                    window_slices)
                if series is not None:
                    if group_tags:
                        series["tags"] = dict(zip(group_tags, key))
                    out_series.append(series)
                continue

            if multi_plan is not None:
                name, call_name, fname, params = multi_plan
                t, v = field_rows(fname)
                rows = []
                for wt, sl in window_slices(t):
                    for rt, rv in fnmod.multi_row(
                            call_name, t[sl], v[sl], params):
                        rows.append([rt if rt is not None else wt, rv])
                if not stmt.ascending:
                    rows.reverse()
                if stmt.offset:
                    rows = rows[stmt.offset :]
                if stmt.limit:
                    rows = rows[: stmt.limit]
                if not rows:
                    continue
                series = {"name": mst, "columns": ["time", name], "values": rows}
                if group_tags:
                    series["tags"] = dict(zip(group_tags, key))
                out_series.append(series)
                continue

            # single raw transform: emit rows directly — dict keying would
            # collapse rows when two series in the group share a timestamp
            if (len(plans) == 1 and plans[0][1] == "transform_raw"
                    and len(outputs) == 1
                    and isinstance(outputs[0][1], int)):
                # bare transform only: a call-math output (e.g.
                # difference(v) * 2) must go through the expression
                # evaluator below, not this direct-emit path
                name, _kind, call_name, fname, params, _inner = plans[0]
                t, v = field_rows(fname)
                if not stmt.ascending:
                    # ORDER BY time DESC: the transform runs over the
                    # DESC-ordered sequence (reference Null_Aggregate desc
                    # difference cases — sign and row times follow the
                    # reversed walk, not a reversed asc result)
                    t_out, v_out = fnmod.transform(
                        call_name, t[::-1], v[::-1], params
                    )
                else:
                    t_out, v_out = fnmod.transform(call_name, t, v, params)
                rows = [
                    (int(tt), [fnmod.py_value(vv)], True)
                    for tt, vv in zip(t_out, v_out)
                ]
                if stmt.offset:
                    rows = rows[stmt.offset :]
                if stmt.limit:
                    rows = rows[: stmt.limit]
                if not rows:
                    continue
                series = {
                    "name": mst,
                    "columns": ["time", name],
                    "values": [[t0] + vv for t0, vv, _p in rows],
                }
                if group_tags:
                    series["tags"] = dict(zip(group_tags, key))
                out_series.append(series)
                continue

            col_maps: list[dict] = []  # per plan: {time: value}
            has_plain_agg = False
            sliding_grid: list | None = None
            for name, kind, call_name, fname, params, inner in plans:
                t, v = field_rows(fname)
                if kind == "agg":
                    has_plain_agg = True
                    m: dict = {}
                    if (call_name in ("count", "count_distinct")
                            and fname not in schema
                            and fname in sc.tag_keys):
                        # influx: COUNT(DISTINCT <tag>) answers 0, not an
                        # empty result (tags are not countable fields)
                        m[window_times[0]] = (0, None)
                    elif (call_name == "median"
                          and schema.get(fname) == FieldType.STRING):
                        # influx: MEDIAN over strings renders a null row
                        m[window_times[0]] = (None, None)
                    else:
                        for wt, sl in window_slices(t):
                            val, sel_t = fnmod.host_agg(
                                call_name, t[sl], v[sl], params)
                            if val is not None:
                                m[wt] = (val, sel_t)
                    col_maps.append(m)
                elif kind == "sliding":
                    n = int(params[0])
                    slices = window_slices(t)
                    m = {}
                    sliding_grid = [wt for wt, _sl in slices[: max(len(slices) - n + 1, 0)]]
                    for i in range(0, len(slices) - n + 1):
                        lo = slices[i][1].start or 0
                        hi = slices[i + n - 1][1].stop
                        val, _sel = fnmod.host_agg(
                            inner[0], t[lo:hi], v[lo:hi], inner[1])
                        if val is not None:
                            m[slices[i][0]] = (val, None)
                    col_maps.append(m)
                elif kind == "transform_raw":
                    t_out, v_out = fnmod.transform(call_name, t, v, params)
                    col_maps.append({int(tt): (vv.item() if hasattr(vv, "item") else vv, None)
                                     for tt, vv in zip(t_out, v_out)})
                else:  # transform over inner aggregate windows
                    seq_t, seq_v = [], []
                    for wt, sl in window_slices(t):
                        val, _sel = fnmod.host_agg(inner[0], t[sl], v[sl], inner[1])
                        if val is not None:
                            seq_t.append(wt)
                            seq_v.append(val)
                    t_out, v_out = fnmod.transform(
                        call_name, np.asarray(seq_t, np.int64), np.asarray(seq_v), params
                    )
                    col_maps.append({int(tt): (float(vv), None) for tt, vv in zip(t_out, v_out)})

            if has_plain_agg and group_time:
                # transforms may emit times outside the window grid
                # (holt_winters forecasts) — union them in, never drop
                extra = {t for m in col_maps for t in m} - set(window_times)
                base_times = sorted(set(window_times) | extra)
            elif sliding_grid is not None:
                # sliding windows emit every output slot; empties fill null
                base_times = sliding_grid
            else:
                seen = sorted({t for m in col_maps for t in m})
                base_times = seen
            rows = []
            col_names = [name for name, _src in outputs]
            for bt in base_times:
                vals = []
                present = False
                for _name, src in outputs:
                    if isinstance(src, int):
                        entry = col_maps[src].get(bt)
                        if entry is None:
                            vals.append(None)
                        else:
                            vals.append(entry[0])
                            present = True
                    else:  # call-math expression over plan columns
                        v, p = _eval_host_output(
                            src, bt, col_maps, call_plan_idx)
                        vals.append(v)
                        present = present or p
                # single BARE selector-time semantics: a selector inside
                # math is an aggregate (influx strips the sample time)
                t_render = bt
                if (len(plans) == 1 and not group_time
                        and len(outputs) == 1
                        and isinstance(outputs[0][1], int)):
                    entry = col_maps[0].get(bt)
                    if entry and entry[1] is not None:
                        t_render = entry[1]
                rows.append((t_render, vals, present))
            rows = _apply_fill(rows, stmt, ["time"] + col_names)
            if not stmt.ascending:
                rows.reverse()
            if stmt.offset:
                rows = rows[stmt.offset :]
            if stmt.limit:
                rows = rows[: stmt.limit]
            if not rows:
                continue
            series = {
                "name": mst,
                "columns": ["time"] + col_names,
                "values": [[t] + v for t, v, _p in rows],
            }
            if group_tags:
                series["tags"] = dict(zip(group_tags, key))
            out_series.append(series)
        return out_series

    def _multi_top_tags(self, stmt, multi_plan, shard_sids, mst, tmin,
                        tmax, sc, window_slices):
        """top/bottom(field, tag..., N): per window, each DISTINCT tag
        combination contributes its best point, and the best N
        combinations emit (time-ascending). The tag columns ride along —
        and INTO writes them back as TAGS, not fields (reference:
        TestServer_Query_TopBottomWriteTags)."""
        name, call_name, fname, (n_take, tagkeys) = multi_plan
        want_top = call_name == "top"
        ts_list, vs_list, ci_list = [], [], []
        combos: list[tuple] = []
        combo_idx: dict[tuple, int] = {}
        filter_fields = [fname] + sorted(cond.row_filter_refs(sc))
        for sh, sid in shard_sids:
            TRACKER.check()  # KILL QUERY cancellation point
            rec = sh.read_series(mst, sid, tmin, tmax, fields=filter_fields)
            col = rec.columns.get(fname)
            if col is None or len(rec) == 0:
                continue
            m = col.valid.copy()
            if sc.has_row_filter:
                m &= cond.eval_row_filter(sc, rec, tags=sh.index.tags_of(sid))
            if not m.any():
                continue
            tags = sh.index.tags_of(sid)
            combo = tuple(tags.get(k, "") for k in tagkeys)
            ci = combo_idx.get(combo)
            if ci is None:
                ci = combo_idx[combo] = len(combos)
                combos.append(combo)
            ts_list.append(rec.times[m])
            vs_list.append(col.values[m])  # native dtype: int64 stays exact
            ci_list.append(np.full(int(m.sum()), ci, np.int64))
        if not ts_list:
            return None
        t = np.concatenate(ts_list)
        v = np.concatenate(vs_list)
        ci = np.concatenate(ci_list)
        order = np.argsort(t, kind="stable")
        t, v, ci = t[order], v[order], ci[order]
        rows = []
        for wt, sl in window_slices(t):
            tw, vw, cw = t[sl], v[sl], ci[sl]
            if not len(tw):
                continue
            best: dict[int, tuple] = {}  # combo -> (value, time)
            for i in range(len(tw)):
                cur = best.get(int(cw[i]))
                better = cur is None or (
                    (vw[i] > cur[0]) if want_top else (vw[i] < cur[0]))
                # value ties keep the EARLIEST point (time-sorted walk:
                # first seen wins)
                if better:
                    best[int(cw[i])] = (vw[i], int(tw[i]))
            ranked = sorted(
                best.items(),
                key=lambda kv: ((-kv[1][0]) if want_top else kv[1][0],
                                kv[1][1]))[:n_take]
            picked = sorted(ranked, key=lambda kv: kv[1][1])  # time asc
            for combo_i, (val, t_ns) in picked:
                rows.append([t_ns, fnmod.py_value(val)]
                            + list(combos[combo_i]))
        if not stmt.ascending:
            rows.reverse()
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit:
            rows = rows[: stmt.limit]
        if not rows:
            return None
        series = {"name": mst, "columns": ["time", name] + list(tagkeys),
                  "values": rows}
        if stmt.into is not None:
            # INTO must write the tag columns back as TAGS
            series["_tag_cols"] = list(tagkeys)
        return series

    # -- raw path -----------------------------------------------------------


    def _select_table_function(self, stmt, call, db: str, now_ns: int) -> dict:
        """SELECT <table_function>('<params json>') FROM m WHERE time ...
        (reference: LogicalTableFunction, logic_plan.go:3863; the one
        production operator is rca, table_function_factory.go:26). The
        measurement's raw rows in the time range are the function input;
        the result is one row holding the output graph as JSON."""
        from opengemini_tpu_torch.query import tablefunc as tfmod

        if len(call.args) != 1:
            raise QueryError(f"{call.name}() takes one string argument")
        arg = _strip_expr(call.args[0])
        if not isinstance(arg, ast.StringLiteral):
            raise QueryError(f"{call.name}() parameter must be a quoted string")
        raw_stmt = dataclasses.replace(
            stmt, fields=[ast.Field(expr=ast.Wildcard())],
            group_by_all_tags=True, limit=0, offset=0,
        )
        rows: list[dict] = []
        for src in stmt.sources:
            if not isinstance(src, ast.Measurement):
                raise QueryError(f"{call.name}() requires a measurement source")
            src_db = src.database or db
            for series in self._select_raw(raw_stmt, src_db, src.rp or None,
                                           src.name, now_ns):
                tags = series.get("tags") or {}
                cols = series["columns"]
                for vals in series["values"]:
                    row = dict(tags)
                    for c, v in zip(cols, vals):
                        if v is not None:
                            row[c] = v
                    rows.append(row)
        try:
            graph = tfmod.TABLE_FUNCTIONS[call.name](rows, arg.val)
        except tfmod.TableFunctionError as e:
            raise QueryError(str(e)) from None
        name = stmt.sources[0].name if stmt.sources else call.name
        return {"series": [_series(name, None, [call.name],
                                   [[json.dumps(graph, sort_keys=True)]])]}

    def _select_raw(self, stmt, db, rp, mst, now_ns) -> list[dict]:
        trace = tracing.current()
        with trace.span("map_shards"):
            if self.engine.is_measurement_dropped(db, mst):
                return []  # mark-deleted: hidden from SELECT pre-purge
            shards_all = self.engine.shards_for_range(
                db, rp, cond.MIN_TIME, cond.MAX_TIME)
            tag_keys: set[str] = set()
            schema: dict[str, FieldType] = {}
            for sh in shards_all:
                tag_keys.update(sh.index.tag_keys(mst))
                schema.update(sh.schema(mst))
            if not schema:
                if stmt.group_by_all_tags:
                    # GROUP BY * requires the measurement's tag keys from
                    # meta: a missing measurement is an error there, not
                    # an empty result (reference meta.Measurement ->
                    # ErrMeasurementNotFound; TestServer_Query_Where_Fields)
                    raise QueryError("measurement not found")
                return []
            sc = cond.split(stmt.condition, tag_keys, now_ns)
            shards = [sh for sh in shards_all
                      if sh.tmax > sc.tmin and sh.tmin < sc.tmax]
            if not shards:
                return []

            # output columns: * expands to fields + tags, except tags
            # consumed by GROUP BY (explicit or *), which surface in the
            # series tags dict (influx wildcard semantics)
            if stmt.group_by_all_tags:
                grouped_tags = tag_keys
            elif getattr(stmt, "_from_subquery", False):
                # the inner select's explicit GROUP BY tags are output
                # dimensions of the subquery: the wildcard lists them
                grouped_tags = tag_keys - set(
                    getattr(stmt, "_subquery_dims", ()))
            else:
                grouped_tags = set(stmt.group_by_tags)
            names: list[tuple] = []  # (output name, kind, payload)
            for f in stmt.fields:
                e = _strip_expr(f.expr)
                if isinstance(e, ast.Wildcard):
                    names.extend(
                        (n, "ref", n) for n in
                        sorted(set(schema) | (tag_keys - grouped_tags)))
                elif isinstance(e, ast.StringLiteral):
                    # constant column (validated to carry an alias upstream)
                    names.append((f.alias or _default_field_name(f.expr),
                                  "const", e.val))
                elif (
                    isinstance(e, (ast.BinaryExpr, ast.UnaryExpr))
                    and not _calls_in(e)
                ):
                    # scalar field math (`f1 + f2 + f3`, `100 - age`): null
                    # unless every referenced field is present on the row;
                    # rows where ANY referenced field exists still emit
                    # (reference TestServer_Query_SubqueryMath)
                    names.append(
                        (f.alias or _default_field_name(f.expr), "expr", e))
                else:
                    src_name = e.name if isinstance(e, ast.VarRef) else ""
                    names.append((f.alias or _default_field_name(f.expr),
                                  "ref", src_name))
            # duplicate output names get _N suffixes, all columns kept —
            # `SELECT value, * FROM m` yields value, ..., value_1 (influx
            # duplicate-column naming; TestServer_Query_Wildcards#4). const/
            # expr lookups key by the FINAL (suffixed) name so colliding
            # aliases stay wired to their own payloads.
            used: dict[str, int] = {}
            out_cols = []  # (final name, source ref)
            const_cols: dict[str, str] = {}  # final name -> literal value
            expr_cols: dict[str, object] = {}  # final name -> scalar expr AST
            for n, kind, payload in names:
                k = used.get(n, 0)
                used[n] = k + 1
                final = f"{n}_{k}" if k else n
                if kind == "const":
                    const_cols[final] = payload
                    out_cols.append((final, final))
                elif kind == "expr":
                    expr_cols[final] = payload
                    out_cols.append((final, final))
                else:
                    out_cols.append((final, payload or n))
            columns = ["time"] + [n for n, _s in out_cols]
            src_of = {n: s_ for n, s_ in out_cols}

            group_tags = self._group_tags(stmt, shards, mst)
            groups: dict[tuple, list] = {}
            match_terms = cond.conjunctive_match_terms(sc.field_expr)
            hinted = bool({"full_series", "specific_series"}
                          & set(getattr(stmt, "hints", ())))
            exact_tags = (
                cond.exact_series_tags(stmt.condition, tag_keys)
                if "full_series" in getattr(stmt, "hints", ()) else None
            ) or None  # no tag equalities -> the hint pins nothing
            for sh in shards:
                sids = cond.eval_tag_expr(sc.tag_expr, sh.index, mst)
                if sc.mixed_expr is not None:
                    if hinted:
                        sids &= cond.series_only_sids(
                            sc.mixed_expr, sh.index, mst, sc.tag_keys)
                    else:
                        sids &= cond.tag_superset_sids(
                            sc.mixed_expr, sh.index, mst, sc.tag_keys)
                if exact_tags is not None:
                    sids = {s for s in sids
                            if sh.index.tags_of(s) == exact_tags}
                sids = _prune_text_sids(sh, mst, sids, match_terms)
                for sid in sorted(sids):
                    tags = sh.index.tags_of(sid)
                    key = tuple(tags.get(k, "") for k in group_tags)
                    groups.setdefault(key, []).append((sh, sid, tags))
            if hinted:
                sc.mixed_series_level = True  # consumed at the series level

            # project only needed columns: selected fields + filter refs +
            # scalar-math operand fields
            filter_refs = cond.row_filter_refs(sc)
            expr_refs: set[str] = set()
            for e in expr_cols.values():
                expr_refs |= _scalar_refs(e)
            read_fields = sorted(
                ({src_of[c] for c in columns[1:] if src_of[c] in schema}
                 | set(filter_refs) | expr_refs) & set(schema)
            )
            # tag-only selects (e.g. SELECT "name" FROM m, openGemini
            # semantics): a row exists wherever ANY field is set, so read
            # every field for presence
            tag_only = not read_fields and any(
                src_of[c] in tag_keys for c in columns[1:])
            if tag_only:
                read_fields = None
        # LIMIT/OFFSET cut the time-merged stream of all series (below):
        # a series can give it at most offset+limit rows, its first ones
        # in the statement's order, so only those are gathered
        keep = stmt.offset + stmt.limit if stmt.limit else None
        # a name that is both a field and a tag resolves per series (the
        # series' own record decides), so it keeps the per-series reads
        bulk_ok = not any(src_of[c] in schema and src_of[c] in tag_keys
                          for c in columns[1:])
        spec = (columns, src_of, const_cols, expr_cols, tag_only)
        with trace.span("scan"):
            by_shard: dict[int, tuple] = {}
            for key in groups:
                for sh, sid, tags in groups[key]:
                    by_shard.setdefault(id(sh), (sh, []))[1].append(
                        (sid, tags))
            parts: dict[tuple, tuple] = {}
            for sh, entries in by_shard.values():
                TRACKER.check()  # KILL QUERY cancellation point
                if bulk_ok and len(entries) >= _BULK_SERIES:
                    parts.update(_raw_bulk(sh, entries, mst, sc,
                                           read_fields, spec, keep,
                                           stmt.ascending))
                    continue
                for sid, tags in entries:
                    TRACKER.check()  # KILL QUERY cancellation point
                    rec = sh.read_series(mst, sid, sc.tmin, sc.tmax,
                                         fields=read_fields)
                    if len(rec) == 0:
                        continue
                    fmask = (cond.eval_row_filter(sc, rec, tags=tags)
                             if sc.has_row_filter
                             else np.ones(len(rec), dtype=bool))
                    cols, present = _raw_columns(rec, *spec)
                    parts[(id(sh), sid)] = _raw_take(
                        rec.times, fmask & present, cols, tags, 0, len(rec),
                        keep, stmt.ascending)
            gathered = [
                (key, [parts[(id(sh), sid)] for sh, sid, _t in groups[key]
                       if parts.get((id(sh), sid)) is not None])
                for key in sorted(groups)]
        with trace.span("render"):
            return self._raw_render(stmt, mst, columns, group_tags,
                                    gathered)

    @staticmethod
    def _raw_render(stmt, mst, columns, group_tags, gathered) -> list[dict]:
        """The gathered series as Python rows, per group sorted by time,
        then LIMIT/OFFSET over the time-merged stream."""
        out_series = []
        for key, parts in gathered:
            rows: list[list] = []
            for times, cols in parts:
                n = len(times)
                py = [times.tolist()]
                for kind, *payload in cols:
                    if kind == "lit":
                        py.append([payload[0]] * n)
                    else:
                        py.append(_pycol(*payload))
                rows.extend(map(list, zip(*py)))
            if not rows:
                continue
            if getattr(stmt, "_subquery_dims", None) and not group_tags:
                # an ungrouped select over a dimensioned subquery keeps
                # the inner series order (rows per series, ascending in
                # each; reference SubqueryForLogicalOptimize#5)
                if not stmt.ascending:
                    rows.reverse()
            else:
                rows.sort(key=lambda r: r[0], reverse=not stmt.ascending)
            series = {"name": mst, "columns": columns, "values": rows}
            if group_tags:
                series["tags"] = dict(zip(group_tags, key))
            out_series.append(series)
        if stmt.offset or stmt.limit:
            # LIMIT/OFFSET apply GLOBALLY over the time-merged row stream,
            # not per series (reference TestServer_Query_LimitAndOffset:
            # `group by tennant limit 1` returns one row total); series
            # left empty by the slice are omitted entirely
            flat = []
            for si, s in enumerate(out_series):
                flat.extend((row[0], si, row) for row in s["values"])
            flat.sort(key=lambda e: (e[0], e[1]), reverse=not stmt.ascending)
            if stmt.offset:
                flat = flat[stmt.offset:]
            if stmt.limit:
                flat = flat[: stmt.limit]
            kept: dict[int, list] = {}
            for _t, si, row in flat:
                kept.setdefault(si, []).append(row)
            out_series = [
                dict(s, values=kept[si])
                for si, s in enumerate(out_series)
                if si in kept
            ]
        return out_series


