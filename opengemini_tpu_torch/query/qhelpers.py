"""Shared helpers of the executor family: AST utilities, host scalar
evaluation, call resolution, output naming and evaluation, fill and
render primitives, the data-driven time range, the scan-to-batch step
and the QueryError type.

The port of ``opengemini_tpu/query/qhelpers.py``. ``_classify_select``
and ``_is_device_call`` are the one place that decides whether a SELECT
runs raw, on the device or on the host, for the executor and EXPLAIN
alike. ``_series_needs_merged_decode`` is the dedup probe of the
pre-aggregation and sketch paths: a series whose chunks are packed
(PACK_MIN_SERIES or more series in one flush), overlap each other or
meet memtable rows takes the merged decode. ``_prune_text_sids`` cuts a
select's candidate series to those the shards' text sidecars say may
match its conjunctive ``match()`` terms. ``estimate_scan_bytes`` is the
scan reservation the resource governor charges before a scan
dispatches (utils/governor.py).
"""

from __future__ import annotations

import math

import numpy as np

from opengemini_tpu_torch.models import ragged
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.query import functions as fnmod
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.sql import ast

NS = 1_000_000_000
MAX_SELECT_BUCKETS = 1_000_000  # influx max-select-buckets guard


class QueryError(Exception):
    pass


# host calls safe on string columns (python-object values end-to-end)
_STRING_OK_HOST = {"count", "count_distinct", "mode", "first", "last",
                   "distinct", "elapsed", "absent",
                   "median"}  # median(string) renders a null row (influx)


def _prune_text_sids(sh, mst, sids, match_terms):
    """Intersect candidate series with the persisted text index for
    every conjunctive match() term. Conservative: memtable rows are
    unindexed, so their series always survive; a shard with a file
    that has no sidecar prunes nothing."""
    if not match_terms or len(sids) == 0:
        return sids
    lookup = getattr(sh, "text_match_sids", None)
    if lookup is None:
        return sids
    # frozen flush snapshots are unindexed like the live memtable
    mem_sids = sh.mem_sids_for(mst)
    as_arr = isinstance(sids, np.ndarray)
    for fld, tok in match_terms:
        got = lookup(mst, fld, tok)
        if got is None:
            return sids  # a file without a sidecar: cannot prune safely
        keep = got | mem_sids
        if as_arr:
            # sorted-array candidates: a membership mask keeps the order
            mask = np.fromiter((s in keep for s in sids.tolist()),
                               np.bool_, len(sids))
            sids = sids[mask]
        else:
            sids = sids & keep
        if len(sids) == 0:
            break
    return sids


def _check_host_field_type(call_name: str, field: str, schema: dict) -> None:
    if schema.get(field) == FieldType.STRING and call_name not in _STRING_OK_HOST:
        raise QueryError(f"{call_name}() is not supported on string field {field!r}")


def _add_record_to_batches(rec, seg, aligned, needed_fields, batches, dtype,
                           fmask, sids=None):
    """Shared scan step: one record's columns into the per-field device
    batches (string columns become count-only zero payloads; int-exact
    host batches receive the raw int64 values uncast). `sids` (scalar or
    per-row array) carries series identity for the grid batch's
    constant-stride run detection."""
    rel = rec.times - aligned  # int64 ns; (hi, lo)-split on add()
    for fname in needed_fields:
        col = rec.columns.get(fname)
        if col is None:
            continue
        batch = batches[fname]
        m = col.valid
        if fmask is not None:
            m = m & fmask
        if (getattr(col, "blocks", None) is not None
                and hasattr(batch, "add_encoded")):
            # record.EncodedColumn into a device-decode-capable batch:
            # keep the raw block payloads attached — the grid freeze can
            # ship them to the card and decode fused with the window
            # reduce (ops/device_decode.py); host consumers decode
            # lazily, bit-identically
            batch.add_encoded(col, rel, seg, m, rec.times, sids=sids)
            continue
        if isinstance(batch, ragged.IntExactBatch):
            vals = col.values  # int64 end-to-end, no float cast
        elif col.ftype == FieldType.STRING:
            vals = np.zeros(len(rec), dtype=dtype)  # count-only path
        else:
            vals = col.values.astype(dtype)
        batch.add(vals, rel, seg, m, rec.times, sids=sids)


def _merge_multi_source(all_series: list[dict], stmt) -> list[dict]:
    """Union the per-source output series of a multi-source raw SELECT
    into combined series per tagset: name = sorted comma-join of source
    names, columns = union (sorted when the projection used a wildcard),
    rows time-ordered. Rows stay distinct even at equal timestamps —
    each source's row keeps its identity (Constant_Column#0); aggregate
    statements union rows upstream via the subquery rewrite instead
    (reference TestServer_Query_MultiMeasurements)."""
    wildcard = any(
        isinstance(_strip_expr(f.expr), ast.Wildcard) for f in stmt.fields
    )
    groups: dict[tuple, dict] = {}
    order: list[tuple] = []
    for s in all_series:
        key = tuple(sorted((s.get("tags") or {}).items()))
        g = groups.get(key)
        if g is None:
            groups[key] = g = {"names": set(), "columns": ["time"],
                               "rows": [], "tags": s.get("tags")}
            order.append(key)
        g["names"].add(s["name"])
        cols = s["columns"]
        for c in cols[1:]:
            if c not in g["columns"]:
                g["columns"].append(c)
        for row in s["values"]:
            g["rows"].append((row[0], dict(zip(cols[1:], row[1:]))))
    out = []
    for key in order:
        g = groups[key]
        if wildcard:
            g["columns"] = ["time"] + sorted(g["columns"][1:])
        g["rows"].sort(key=lambda r: r[0], reverse=not stmt.ascending)
        merged = g["rows"]
        name = ",".join(sorted(g["names"]))
        values = [
            [t] + [cv.get(c) for c in g["columns"][1:]] for t, cv in merged
        ]
        series = {"name": name, "columns": g["columns"], "values": values}
        if g["tags"]:
            series["tags"] = g["tags"]
        out.append(series)
    return out


def _inner_source_name(stmt, _depth: int = 0) -> str:
    """Influx keeps the innermost measurement name for subquery output
    (CTE references resolve to their body's innermost source; a union
    body names itself after its sorted side names)."""
    if _depth > 16:
        return "subquery"
    if isinstance(stmt, ast.UnionStatement):
        parts: set[str] = set()
        for sel in stmt.selects:
            n = _inner_source_name(sel, _depth + 1)
            if n != "subquery":
                parts.update(n.split(","))
        return ",".join(sorted(parts)) if parts else "subquery"
    # multiple sources name the output after the sorted union of their
    # innermost names (reference: "mst,mst1" in TestServer_Query_
    # MultiMeasurements)
    parts2: set[str] = set()
    for src in stmt.sources:
        if isinstance(src, ast.SubQuery):
            n = _inner_source_name(src.stmt, _depth + 1)
        elif isinstance(src, ast.Measurement) and src.name:
            if stmt.ctes and src.name in stmt.ctes:
                n = _inner_source_name(stmt.ctes[src.name], _depth + 1)
            else:
                n = src.name
        else:
            continue
        if n != "subquery":
            parts2.update(n.split(","))
    return ",".join(sorted(parts2)) if parts2 else "subquery"


def _series(name, tags, columns, values):
    s = {"name": name, "columns": columns, "values": values}
    if tags:
        s["tags"] = tags
    if not name:
        del s["name"]
    return s


def _series_result(name, tags, columns, values) -> dict:
    return {"series": [_series(name, tags, columns, values)]}


def _strip_expr(e):
    while isinstance(e, ast.ParenExpr):
        e = e.expr
    return e


def _collect_calls(fields) -> list[ast.Call]:
    out = []
    for f in fields:
        out.extend(_calls_in(f.expr))
    return out


def _eval_scalar_row(e, per: dict, tags: dict, oi: int):
    """One-row scalar-math evaluation over companion columns (`per` maps
    field -> (values, valid, ftype)). None propagates through every op."""
    e = _strip_expr(e)
    if isinstance(e, ast.VarRef):
        got = per.get(e.name)
        if got is None or not got[1][oi]:
            return None
        try:
            return float(got[0][oi])
        except (TypeError, ValueError):
            return None
    if isinstance(e, (ast.NumberLiteral, ast.IntegerLiteral,
                      ast.DurationLiteral)):
        return float(e.val)
    if isinstance(e, ast.UnaryExpr):
        v = _eval_scalar_row(e.expr, per, tags, oi)
        if v is None:
            return None
        return -v if e.op == "-" else v
    if isinstance(e, ast.BinaryExpr):
        lv = _eval_scalar_row(e.lhs, per, tags, oi)
        rv = _eval_scalar_row(e.rhs, per, tags, oi)
        if lv is None or rv is None:
            return None
        if e.op == "+":
            return lv + rv
        if e.op == "-":
            return lv - rv
        if e.op == "*":
            return lv * rv
        if e.op == "/":
            return lv / rv if rv else None
        if e.op == "%":
            return lv % rv if rv else None
    return None


def _scalar_refs(e) -> set[str]:
    """Field names referenced by a scalar-math projection expression."""
    e = _strip_expr(e)
    if isinstance(e, ast.VarRef):
        return {e.name}
    if isinstance(e, ast.BinaryExpr):
        return _scalar_refs(e.lhs) | _scalar_refs(e.rhs)
    if isinstance(e, ast.UnaryExpr):
        return _scalar_refs(e.expr)
    return set()


def _eval_scalar_cols(e, rec):
    """Vectorized scalar-math projection over one record.

    Returns (values f64, valid, touched): `valid` requires EVERY operand
    field present (influx null-propagation — `f1 + f2` is null when either
    side is), `touched` is true where ANY referenced field is present (the
    row still emits with a null value, TestServer_Query_SubqueryMath#0).
    """
    n = len(rec)
    e = _strip_expr(e)
    if isinstance(e, ast.VarRef):
        col = rec.columns.get(e.name)
        if col is None or col.ftype == FieldType.STRING:
            z = np.zeros(n, bool)
            return np.zeros(n), z, z.copy()
        vals = np.where(col.valid, col.values.astype(np.float64), 0.0)
        return vals, col.valid.copy(), col.valid.copy()
    if isinstance(e, (ast.NumberLiteral, ast.IntegerLiteral,
                      ast.DurationLiteral)):
        ones = np.ones(n, bool)
        return np.full(n, float(e.val)), ones, np.zeros(n, bool)
    if isinstance(e, ast.UnaryExpr):
        vals, valid, touched = _eval_scalar_cols(e.expr, rec)
        return (-vals if e.op == "-" else vals), valid, touched
    if isinstance(e, ast.BinaryExpr):
        lv, lok, lt = _eval_scalar_cols(e.lhs, rec)
        rv, rok, rt = _eval_scalar_cols(e.rhs, rec)
        valid = lok & rok
        touched = lt | rt
        with np.errstate(all="ignore"):
            if e.op == "+":
                out = lv + rv
            elif e.op == "-":
                out = lv - rv
            elif e.op == "*":
                out = lv * rv
            elif e.op == "/":
                valid = valid & (rv != 0)  # x/0 is null (influx)
                out = np.divide(lv, np.where(rv != 0, rv, 1.0))
            elif e.op == "%":
                valid = valid & (rv != 0)
                out = np.mod(lv, np.where(rv != 0, rv, 1.0))
            else:
                z = np.zeros(n, bool)
                return np.zeros(n), z, touched
        return out, valid, touched
    z = np.zeros(n, bool)
    return np.zeros(n), z, z.copy()


def _calls_in(e) -> list[ast.Call]:
    e = _strip_expr(e)
    if isinstance(e, ast.Call):
        return [e]
    if isinstance(e, ast.BinaryExpr):
        return _calls_in(e.lhs) + _calls_in(e.rhs)
    if isinstance(e, ast.UnaryExpr):
        return _calls_in(e.expr)
    return []


# wildcard-in-call expansion: these functions expand `f(*)` over numeric
# fields only (math is meaningless on strings/bools); everything else
# expands over every field (reference: influxql RewriteFields)
_NUMERIC_ONLY_WILDCARD = {
    "difference", "non_negative_difference", "derivative",
    "non_negative_derivative", "moving_average", "cumulative_sum", "sum",
    "mean", "median", "stddev", "spread", "percentile",
    "percentile_ogsketch", "integral",
    "max", "min", "top", "bottom", "sample",
    "rate", "irate", "regr_slope",
}


def _call_wildcard_inner(e):
    """f(*) -> (f, None); f(g(*), ...) -> (f, g). None when no wildcard."""
    if not (isinstance(e, ast.Call) and e.args):
        return None
    a0 = _strip_expr(e.args[0])
    if isinstance(a0, ast.Wildcard):
        return e, None
    if isinstance(a0, ast.Call) and a0.args and isinstance(
            _strip_expr(a0.args[0]), ast.Wildcard):
        return e, a0
    return None


def _has_call_wildcard(stmt) -> bool:
    return any(
        _call_wildcard_inner(_strip_expr(f.expr)) is not None
        for f in stmt.fields
    )


def _expand_call_wildcards(stmt, schema):
    """Rewrite `SELECT f(*) ...` into one call per matching field, each
    aliased `f_<field>` (reference: influxql.RewriteFields wildcard
    expansion)."""
    import copy

    new_fields = []
    for f in stmt.fields:
        e = _strip_expr(f.expr)
        hit = _call_wildcard_inner(e)
        if hit is None:
            new_fields.append(f)
            continue
        outer, inner = hit
        base = _default_field_name(outer)
        type_call = (inner or outer).name
        for fld in sorted(schema):
            ft = schema[fld]
            if type_call in ("max", "min"):
                if ft == FieldType.STRING:
                    continue  # max/min(*): numeric + bool
            elif type_call in _NUMERIC_ONLY_WILDCARD and ft not in (
                    FieldType.FLOAT, FieldType.INT):
                continue
            if inner is None:
                call = ast.Call(
                    outer.name, (ast.VarRef(fld),) + tuple(outer.args[1:]))
            else:
                new_inner = ast.Call(
                    inner.name, (ast.VarRef(fld),) + tuple(inner.args[1:]))
                call = ast.Call(
                    outer.name, (new_inner,) + tuple(outer.args[1:]))
            new_fields.append(ast.Field(call, alias=f"{base}_{fld}"))
    out = copy.copy(stmt)
    out.fields = new_fields
    return out


def _needs_string_host_path(stmt, schema_fn) -> bool:
    """schema_fn is called lazily — the shard-schema sweep only runs when a
    call could actually involve a string field."""
    candidates = []
    for call in _collect_calls(stmt.fields):
        if not call.args or call.name not in _STRING_OK_HOST or call.name == "count":
            continue
        a = _strip_expr(call.args[0])
        if isinstance(a, ast.VarRef):
            candidates.append(a.name)
    if not candidates:
        return False
    schema = schema_fn()
    return any(schema.get(n) == FieldType.STRING for n in candidates)


_AUX_SELECTORS = {"first", "last", "max", "min", "top", "bottom", "percentile"}


def _selector_aux_plan(stmt: ast.SelectStatement):
    """Detect `SELECT <selector>(f, ...), aux...`: exactly one call, a
    selector, with at least one auxiliary (non-call, non-`time`) column.
    Returns (call, aux_field_names) or None."""
    calls = _collect_calls(stmt.fields)
    if len(calls) != 1 or calls[0].name not in _AUX_SELECTORS:
        return None
    call = calls[0]
    if not call.args or not isinstance(_strip_expr(call.args[0]), ast.VarRef):
        return None
    aux_names: list[str] = []
    has_aux = False
    for f in stmt.fields:
        e = _strip_expr(f.expr)
        if isinstance(e, ast.Call):
            continue
        if isinstance(e, ast.VarRef) and e.name.lower() == "time":
            continue
        refs = _collect_varrefs(e)
        if refs is None:
            return None  # something we cannot evaluate per-row
        aux_names.extend(refs)
        has_aux = True
    if not has_aux:
        return None
    return call, sorted(set(aux_names))


def _collect_varrefs(e) -> list[str] | None:
    """Field/tag names referenced by a per-row arithmetic expr, or None
    if the expr contains anything other than refs/literals/arithmetic."""
    e = _strip_expr(e)
    if isinstance(e, ast.VarRef):
        return [e.name]
    if isinstance(e, (ast.NumberLiteral, ast.IntegerLiteral)):
        return []
    if isinstance(e, ast.UnaryExpr):
        return _collect_varrefs(e.expr)
    if isinstance(e, ast.BinaryExpr):
        l, r = _collect_varrefs(e.lhs), _collect_varrefs(e.rhs)
        if l is None or r is None:
            return None
        return l + r
    return None


def _selector_pick(sel_name: str, tw, vw, n_rows: int, pctl) -> list[int]:
    """Row indices (into the window slice) a selector picks; output order
    is time-ascending for multi-row selectors."""
    if sel_name == "first":
        return [0]
    if sel_name == "last":
        return [len(vw) - 1]
    if sel_name == "max":
        return [int(np.argmax(vw))]
    if sel_name == "min":
        return [int(np.argmin(vw))]
    if sel_name == "percentile":
        order = np.argsort(vw, kind="stable")
        i = int(math.floor(len(vw) * pctl / 100.0 + 0.5)) - 1
        if i < 0 or i >= len(vw):
            return []
        return [int(order[i])]
    # top/bottom: n best by value (ties -> earliest), output time-ascending
    keys = -vw if sel_name == "top" else vw
    order = np.lexsort((np.arange(len(vw)), keys))[:n_rows]
    return sorted(int(i) for i in order)


def _render_cell(v, ftype, call_name: str):
    if ftype == FieldType.STRING:
        return None if v is None else str(v)
    if ftype == FieldType.INT:
        return int(v)
    if ftype == FieldType.BOOL:
        return bool(round(float(v)))
    fv = float(v)
    if math.isnan(fv) or math.isinf(fv):
        return None
    return fv


def _eval_aux_expr(e, ri: int, aux_arr, tag_arr, schema):
    """Evaluate one auxiliary column at selected row `ri`."""
    e = _strip_expr(e)
    if isinstance(e, ast.VarRef):
        if e.name in aux_arr:
            vals, valid = aux_arr[e.name]
            if not valid[ri]:
                return None
            return _render_cell(vals[ri], schema.get(e.name), "aux")
        if e.name in tag_arr:
            return tag_arr[e.name][ri]
        return None
    if isinstance(e, (ast.NumberLiteral, ast.IntegerLiteral)):
        return e.val
    if isinstance(e, ast.UnaryExpr) and e.op == "-":
        v = _eval_aux_expr(e.expr, ri, aux_arr, tag_arr, schema)
        return None if v is None else -v
    if isinstance(e, ast.BinaryExpr):
        lv = _eval_aux_expr(e.lhs, ri, aux_arr, tag_arr, schema)
        rv = _eval_aux_expr(e.rhs, ri, aux_arr, tag_arr, schema)
        if lv is None or rv is None or isinstance(lv, str) or isinstance(rv, str):
            return None
        try:
            if e.op == "+":
                return lv + rv
            if e.op == "-":
                return lv - rv
            if e.op == "*":
                return lv * rv
            if e.op == "/":
                return lv / rv if rv != 0 else None
            if e.op == "%":
                return lv % rv if rv != 0 else None
        except TypeError:
            return None
    raise QueryError(f"unsupported auxiliary expression: {e}")


def _has_in_subquery(e) -> bool:
    if isinstance(e, ast.InSubquery):
        return True
    if isinstance(e, ast.BinaryExpr):
        return _has_in_subquery(e.lhs) or _has_in_subquery(e.rhs)
    if isinstance(e, (ast.ParenExpr, ast.UnaryExpr)):
        return _has_in_subquery(e.expr)
    return False


def _classify_select(stmt: ast.SelectStatement) -> str:
    """'raw' | 'device' | 'host' — the single source of truth for which
    execution path a SELECT takes (used by execution AND EXPLAIN)."""
    calls = _collect_calls(stmt.fields)
    if not calls:
        return "raw"
    if all(_is_device_call(c) for c in calls):
        if (stmt.group_by_time is None and len(calls) == 1
                and calls[0].name == "percentile"):
            # a SINGLE bare percentile is a SELECTOR: the row carries
            # the selected sample's own timestamp, which the device
            # kernel does not surface (server_test.go Selectors).
            # Combined with other aggregates the time is epoch anyway —
            # keep the device/pushdown path then.
            return "host"
        return "device"
    return "host"


def _is_device_call(call: ast.Call) -> bool:
    if call.name == "count" and call.args:
        inner = _strip_expr(call.args[0])
        if isinstance(inner, ast.Call) and inner.name == "distinct":
            return True
    if call.name in aggmod.REGISTRY:
        # device aggs take a bare field ref (string fields route to count
        # validation inside _select_agg)
        return bool(call.args) and isinstance(_strip_expr(call.args[0]), ast.VarRef)
    return False


def _call_param_value(arg) -> float | int:
    a = _strip_expr(arg)
    if isinstance(a, ast.UnaryExpr) and a.op == "-":
        return -_call_param_value(a.expr)
    if isinstance(a, ast.IntegerLiteral):
        return a.val
    if isinstance(a, ast.NumberLiteral):
        return a.val
    if isinstance(a, ast.DurationLiteral):
        return a.val_ns
    raise QueryError("function parameter must be a number or duration")


def _call_param_any(arg):
    a = _strip_expr(arg)
    if isinstance(a, ast.StringLiteral):
        return a.val
    return _call_param_value(arg)


def _resolve_host_call(call: ast.Call, group_time):
    """-> (kind, call_name, field, params, inner) where kind is
    'agg' | 'transform_raw' | 'transform_agg' | 'multi' | 'sliding'."""
    name = call.name
    if name == "sliding_window":
        # sliding_window(agg(f), N): agg over N consecutive GROUP BY time
        # windows, emitted at each window start (reference:
        # TestServer_Query_Sliding_Window_Aggregate)
        if len(call.args) != 2:
            raise QueryError("sliding_window() takes (aggregate, N)")
        if group_time is None:
            raise QueryError("sliding_window() requires GROUP BY time(...)")
        inner_e = _strip_expr(call.args[0])
        if not isinstance(inner_e, ast.Call):
            raise QueryError("sliding_window() argument must be an aggregate")
        n = int(_call_param_value(call.args[1]))
        if n < 1:
            raise QueryError("sliding_window() N must be >= 1")
        ikind, iname, ifield, iparams, _ = _resolve_host_call(inner_e, group_time)
        if ikind != "agg":
            raise QueryError("sliding_window() argument must be an aggregate")
        return "sliding", name, ifield, (n,), (iname, iparams)
    if name in fnmod.TRANSFORMS:
        if not call.args:
            raise QueryError(f"{name}() requires an argument")
        inner_e = _strip_expr(call.args[0])
        if name == "difference":
            # difference(f[, 'front'|'behind'|'absolute'])
            params = tuple(_call_param_any(a) for a in call.args[1:])
            if params and params[0] not in ("front", "behind", "absolute"):
                raise QueryError(
                    "difference() mode must be 'front', 'behind' or 'absolute'")
        else:
            params = tuple(_call_param_value(a) for a in call.args[1:])
        _check_host_arity(name, params)
        if isinstance(inner_e, ast.Call):
            if group_time is None:
                raise QueryError(
                    f"{name}() over an aggregate requires GROUP BY time(...)"
                )
            ikind, iname, ifield, iparams, _ = _resolve_host_call(inner_e, group_time)
            if ikind != "agg":
                raise QueryError(f"{name}() argument must be a field or aggregate")
            return "transform_agg", name, ifield, params, (iname, iparams)
        if isinstance(inner_e, ast.VarRef):
            if name.startswith("holt_winters"):
                raise QueryError(
                    "holt_winters() requires an aggregate argument with "
                    "GROUP BY time(...)"
                )
            if group_time is not None:
                raise QueryError(
                    f"{name}() over raw points cannot use GROUP BY time(...) — "
                    "wrap the field in an aggregate"
                )
            return "transform_raw", name, inner_e.name, params, None
        raise QueryError(f"{name}() argument must be a field or aggregate")
    if name in fnmod.MULTI_ROW:
        if not call.args:
            raise QueryError(f"{name}() requires a field argument")
        fld = _strip_expr(call.args[0])
        if not isinstance(fld, ast.VarRef):
            raise QueryError(f"{name}() argument must be a field")
        if name in ("top", "bottom") and len(call.args) > 2:
            # top(field, tag..., N): best N values from DISTINCT tag
            # combinations, one per combination (influx parser.go
            # parseCall top/bottom tag-key form)
            mids = [_strip_expr(a) for a in call.args[1:-1]]
            if all(isinstance(m, ast.VarRef) for m in mids):
                n = int(_call_param_value(call.args[-1]))
                if n < 1:
                    raise QueryError(f"{name}() N must be >= 1")
                return ("multi", name, fld.name,
                        (n, tuple(m.name for m in mids)), None)
        if name == "detect":
            # detect(field, 'algorithm'[, threshold]): string only in slot 0
            params = []
            for i, a in enumerate(call.args[1:]):
                params.append(_call_param_any(a) if i == 0 else _call_param_value(a))
            params = tuple(params)
            if params and not isinstance(params[0], str):
                raise QueryError("detect() algorithm must be a quoted string")
        else:
            params = tuple(_call_param_value(a) for a in call.args[1:])
        _check_host_arity(name, params)
        return "multi", name, fld.name, params, None
    if name == "count" and call.args and isinstance(_strip_expr(call.args[0]), ast.Call):
        inner = _strip_expr(call.args[0])
        if inner.name == "distinct":
            fld = _strip_expr(inner.args[0])
            return "agg", "count_distinct", fld.name, (), None
    if name in fnmod.HOST_AGGS:
        if not call.args or not isinstance(_strip_expr(call.args[0]), ast.VarRef):
            raise QueryError(f"{name}() requires a field argument")
        params = tuple(_call_param_value(a) for a in call.args[1:])
        _check_host_arity(name, params)
        return "agg", name, _strip_expr(call.args[0]).name, params, None
    raise QueryError(f"unsupported function: {name}")


# (min required params, max allowed params) per host call with parameters
_HOST_ARITY = {
    "percentile": (1, 1),
    "percentile_ogsketch": (1, 1),
    "moving_average": (1, 1),
    "top": (1, 1),
    "bottom": (1, 1),
    "sample": (1, 1),
    "distinct": (0, 0),
    "detect": (0, 2),
    "holt_winters": (1, 2),
    "holt_winters_with_fit": (1, 2),
    "difference": (0, 1),
    "non_negative_difference": (0, 0),
    "cumulative_sum": (0, 0),
}


def _check_host_arity(name: str, params: tuple) -> None:
    if name in ("percentile", "percentile_ogsketch") and params:
        q = params[0]
        if not (isinstance(q, (int, float)) and 0 <= q <= 100):
            raise QueryError(f"{name}() N must be between 0 and 100")
    lo, hi = _HOST_ARITY.get(name, (0, 1))
    if not (lo <= len(params) <= hi):
        raise QueryError(f"{name}() takes {lo + 1} to {hi + 1} arguments")
    if name == "moving_average" and params and int(params[0]) < 1:
        raise QueryError("moving_average() window must be >= 1")
    if name.startswith("holt_winters") and params:
        n = int(params[0])
        if not (1 <= n <= 10_000):
            raise QueryError("holt_winters() N must be between 1 and 10000")
        if len(params) > 1 and not (0 <= int(params[1]) <= 10_000):
            raise QueryError("holt_winters() seasonal period must be 0..10000")


def _resolve_call(call: ast.Call):
    """-> (AggSpec, params, field_name)."""
    name = call.name
    args = call.args
    if name == "count" and args and isinstance(_strip_expr(args[0]), ast.Call):
        inner = _strip_expr(args[0])
        if inner.name == "distinct":
            spec = aggmod.get("count_distinct")
            fld = _call_field(inner)
            return spec, (), fld
    if name == "percentile":
        if len(args) != 2:
            raise QueryError("percentile() takes (field, N)")
        q = _strip_expr(args[1])
        if isinstance(q, (ast.IntegerLiteral, ast.NumberLiteral)):
            qv = float(q.val)
        else:
            raise QueryError("percentile() N must be a number")
        return aggmod.get("percentile"), (qv,), _call_field(call)
    spec = aggmod.get(name)  # KeyError -> surfaced as query error
    return spec, (), _call_field(call)


def _call_field(call: ast.Call) -> str:
    if not call.args:
        raise QueryError(f"{call.name}() requires a field argument")
    a = _strip_expr(call.args[0])
    if isinstance(a, ast.VarRef):
        return a.name
    if isinstance(a, ast.Wildcard):
        raise QueryError(f"{call.name}(*) is not supported yet")
    raise QueryError(f"{call.name}() argument must be a field")


def _default_field_name(e) -> str:
    e = _strip_expr(e)
    if isinstance(e, ast.Call):
        if e.name == "count" and e.args:
            inner = _strip_expr(e.args[0])
            if isinstance(inner, ast.Call) and inner.name == "distinct":
                return "count"
        return e.name
    if isinstance(e, ast.VarRef):
        return e.name
    if isinstance(e, ast.BinaryExpr):
        calls = _calls_in(e)
        if calls:
            return "_".join(c.name for c in calls)
        refs = sorted({r for r in cond.field_filter_refs(e)})
        return "_".join(refs) if refs else "expr"
    return "expr"


def _eval_output_expr(expr, agg_results, seg, schema):
    """Evaluate one output column at segment `seg`. Returns (value, present)."""
    expr = _strip_expr(expr)
    if isinstance(expr, ast.Call):
        entry = agg_results.get(id(expr))
        if entry is None:
            raise QueryError(f"unplanned call {expr.name}")
        out, sel, counts, spec, fname, _times = entry
        if counts[seg] == 0:
            return None, False
        # single-sample stddev renders 0 (reference NewStdDevReduce,
        # engine/executor/agg_func.go, returns 0 with isNil=false for n==1)
        v = out[seg]
        ftype = schema.get(fname)
        if spec.int_output:
            return int(v), True
        if ftype == FieldType.INT and spec.name in ("sum", "min", "max", "first", "last", "spread"):
            # int64-exact path yields integer arrays: never round-trip
            # through float (2^53 cliff)
            if isinstance(v, np.integer):
                return int(v), True
            return int(round(float(v))), True
        if ftype == FieldType.BOOL and spec.name in ("first", "last", "min", "max"):
            return bool(round(float(v))), True
        fv = float(v)
        if math.isnan(fv) or math.isinf(fv):
            return None, True
        return fv, True
    if isinstance(expr, (ast.NumberLiteral, ast.IntegerLiteral)):
        return expr.val, False
    if isinstance(expr, ast.UnaryExpr) and expr.op == "-":
        v, p = _eval_output_expr(expr.expr, agg_results, seg, schema)
        return (None if v is None else -v), p
    if isinstance(expr, ast.BinaryExpr):
        lv, lp = _eval_output_expr(expr.lhs, agg_results, seg, schema)
        rv, rp = _eval_output_expr(expr.rhs, agg_results, seg, schema)
        present = lp or rp
        if lv is None or rv is None:
            return None, present
        try:
            if expr.op == "+":
                return lv + rv, present
            if expr.op == "-":
                return lv - rv, present
            if expr.op == "*":
                return lv * rv, present
            if expr.op == "/":
                return (lv / rv if rv != 0 else None), present
            if expr.op == "%":
                return (lv % rv if rv != 0 else None), present
        except TypeError:
            return None, present
    raise QueryError(f"unsupported output expression: {expr}")


def _apply_fill(rows, stmt, columns, count_idx: tuple = ()):
    """rows: [(t, vals, any_present)] per window, ascending. Influx fill
    semantics (reference: engine/executor fill_transform.go). count_idx:
    value indices holding bare count()/count(distinct) results — under
    the default null fill those render 0 for empty windows
    (TestServer_Query_Fill#6)."""
    fill = stmt.fill_option
    if not stmt.group_by_time:
        return [(t, v, p) for t, v, p in rows if p]
    if fill == "none":
        return [(t, v, p) for t, v, p in rows if p]
    if fill == "null" and count_idx:
        out = []
        for t, vals, p in rows:
            vals = [0 if (i in count_idx and v is None) else v
                    for i, v in enumerate(vals)]
            out.append((t, vals, p))
        rows = out
    if fill == "number":
        out = []
        for t, vals, p in rows:
            vals = [stmt.fill_value if v is None else v for v in vals]
            out.append((t, vals, p))
        return out
    if fill == "previous":
        prev = [None] * (len(columns) - 1)
        out = []
        for t, vals, p in rows:
            vals = [prev[i] if v is None else v for i, v in enumerate(vals)]
            prev = vals
            out.append((t, vals, p))
        return out
    if fill == "linear":
        ncols = len(columns) - 1
        arr = [[v for v in vals] for _t, vals, _p in rows]
        for ci in range(ncols):
            col = [r[ci] for r in arr]
            col = _linear_fill(col)
            for ri, v in enumerate(col):
                arr[ri][ci] = v
        return [(rows[i][0], arr[i], rows[i][2]) for i in range(len(rows))]
    return rows  # "null"


def _linear_fill(col):
    n = len(col)
    known = [i for i, v in enumerate(col) if v is not None]
    if len(known) < 2:
        return col
    out = list(col)
    for a, b in zip(known, known[1:]):
        if b - a > 1:
            va, vb = col[a], col[b]
            for i in range(a + 1, b):
                out[i] = va + (vb - va) * (i - a) / (b - a)
    return out


def _pyval(v, ftype):
    if ftype == FieldType.FLOAT:
        fv = float(v)
        # non-finite floats marshal as JSON null (influx semantics; a bare
        # NaN/Infinity literal is not valid strict JSON and breaks clients)
        return fv if math.isfinite(fv) else None
    if ftype == FieldType.INT:
        return int(v)
    if ftype == FieldType.BOOL:
        return bool(v)
    return v if isinstance(v, str) else str(v)


def _series_needs_merged_decode(sh, mst, sid, tmin, tmax):
    """Dedup-risk check shared by the pre-agg and sketch fast paths: a
    series needs the merged read_series view when memtable rows overlap
    the range or its chunks overlap each other (last-write-wins dedup).
    Returns (needs_merge, chunk_sources)."""
    if not getattr(sh, "supports_preagg", False):
        # a shard without chunk metadata: always the merged view
        # (returning (False, []) would silently drop its data)
        return True, None
    if sh.mem_overlaps_range(sid, tmin, tmax):
        return True, None
    srcs = sh.file_chunks(mst, {sid}, tmin, tmax)
    if any(c.packed for _r, c in srcs):
        # packed chunks hold many series: their pre-agg is chunk-wide, so
        # per-series fast paths must take the merged decode
        return True, None
    metas = sorted((c for _r, c in srcs), key=lambda c: c.tmin)
    for a, b in zip(metas, metas[1:]):
        if b.tmin <= a.tmax:
            return True, None
    return False, srcs


def _shard_mem_time_range(sh):
    """(min, max) of a shard's in-memory rows, frozen flush snapshots
    included; a peer's stand-in (parallel/cluster.py) carries its data
    extent as ``mem``."""
    f = getattr(sh, "mem_time_range", None)
    return f() if f is not None else (sh.mem.min_time, sh.mem.max_time)


def _data_time_range(shards, mst):
    """(min, max) ns over the shards' rows: chunk metadata of the files,
    then the memtables."""
    dmin = dmax = None
    for sh in shards:
        for _r, c in sh.file_chunks(mst):
            dmin = c.tmin if dmin is None else min(dmin, c.tmin)
            dmax = c.tmax if dmax is None else max(dmax, c.tmax)
        m_lo, m_hi = _shard_mem_time_range(sh)
        if m_lo is not None:
            dmin = m_lo if dmin is None else min(dmin, m_lo)
            dmax = m_hi if dmax is None else max(dmax, m_hi)
    return dmin, dmax


def _fmt_duration(ns: int) -> str:
    if ns == 0:
        return "0s"
    h, rem = divmod(ns // NS, 3600)
    m, s = divmod(rem, 60)
    return f"{h}h{m}m{s}s"


def estimate_scan_bytes(shards, mst: str, tmin: int, tmax: int,
                        n_fields: int | None) -> int:
    """Estimated decoded working set of a scan, from chunk metadata and
    memtable row counts alone (no decode): the per-query reservation
    the resource governor charges against its ledger before the scan
    dispatches. 9 bytes per cell, as scanpool.est_chunk_bytes."""
    cols = (n_fields if n_fields else 1) + 2
    total_rows = 0
    for sh in shards:
        approx = getattr(sh, "approx_rows", None)
        if approx is None:
            continue
        r, _c = approx(mst, tmin, tmax)
        total_rows += r
    return total_rows * 9 * cols
