"""Helpers of the aggregate SELECT path, split out of the executor.

The port of the parts of ``opengemini_tpu/query/qhelpers.py`` that the
aggregate path uses: call resolution, output naming and evaluation, fill,
the data-driven time range and the scan-to-batch step.
"""

from __future__ import annotations

import math

import numpy as np

from opengemini_tpu_torch.models import ragged
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.query import condition as cond
from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.sql import ast

MAX_SELECT_BUCKETS = 1_000_000  # influx max-select-buckets guard

class QueryError(Exception):
    pass


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

def _data_time_range(shards, mst):
    """(min, max) ns over the shards' rows: chunk metadata of the files,
    then the memtables."""
    dmin = dmax = None
    for sh in shards:
        for _r, c in sh.file_chunks(mst):
            dmin = c.tmin if dmin is None else min(dmin, c.tmin)
            dmax = c.tmax if dmax is None else max(dmax, c.tmax)
        m_lo, m_hi = sh.mem_time_range()
        if m_lo is not None:
            dmin = m_lo if dmin is None else min(dmin, m_lo)
            dmax = m_hi if dmax is None else max(dmax, m_hi)
    return dmin, dmax


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


# host calls safe on string columns (python-object values end-to-end)
_STRING_OK_HOST = {"count", "count_distinct", "mode", "first", "last",
                   "distinct", "elapsed", "absent",
                   "median"}  # median(string) renders a null row (influx)


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
