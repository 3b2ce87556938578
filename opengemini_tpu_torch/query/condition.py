"""WHERE-clause decomposition: time range, tag filter, field filter.

Reference: the reference splits conditions during plan building
(influxql.ConditionExpr / getTimeRange in lifted influx/query); here the
split is explicit: the AND-tree is walked once, each leaf classified as a
time bound (-> scan range), a tag comparison (-> inverted-index sid set),
or a field comparison (-> vectorized numpy row mask applied before device
transfer). ``match(field, 'token')`` is a field filter
(native/textindex.match_token); ``conjunctive_match_terms`` names the
match() terms that may prune series through the shards' text sidecars.
"""

from __future__ import annotations

import datetime as _dt
import re

import numpy as np

from opengemini_tpu_torch.sql import ast

MIN_TIME = -(2**63) + 1
MAX_TIME = 2**63 - 1


class ConditionError(ValueError):
    pass


class SplitCondition:
    """tmin inclusive, tmax exclusive (ns); tag_expr / field_expr /
    mixed_expr are AST subtrees or None. mixed_expr holds conjuncts whose
    subtree references BOTH tags and fields (e.g. `tag = 'x' OR field > 1`
    or `tag != field`): tags can only prune a sid SUPERSET for it
    (tag_superset_sids); the exact answer needs per-row evaluation with
    the series' tag values injected as columns (eval_row_filter)."""

    def __init__(self, tmin, tmax, tag_expr, field_expr, mixed_expr=None,
                 tag_keys=frozenset()):
        self.tmin = tmin
        self.tmax = tmax
        self.tag_expr = tag_expr
        self.field_expr = field_expr
        self.mixed_expr = mixed_expr
        self.tag_keys = tag_keys
        # /*+ full_series|specific_series */: mixed_expr was consumed as a
        # series-level filter (series_only_sids) — no per-row evaluation.
        # A flag rather than nulling mixed_expr: remote peers still need
        # the expression to apply the same series-level filter.
        self.mixed_series_level = False

    @property
    def has_row_filter(self) -> bool:
        return self.field_expr is not None or (
            self.mixed_expr is not None and not self.mixed_series_level)


def split(cond, tag_keys: set[str], now_ns: int) -> SplitCondition:
    tmin, tmax = MIN_TIME, MAX_TIME
    tag_parts: list = []
    field_parts: list = []
    mixed_parts: list = []

    def walk(e):
        nonlocal tmin, tmax
        e = _strip(e)
        if e is None:
            return
        if isinstance(e, ast.BinaryExpr) and e.op == "AND":
            walk(e.lhs)
            walk(e.rhs)
            return
        if _is_time_cond(e):
            lo, hi = _time_bounds(e, now_ns)
            tmin = max(tmin, lo)
            tmax = min(tmax, hi)
            return
        refs = _collect_refs(e)
        if "time" in refs or "Time" in refs:
            # influx rejects OR'd time conditions; silently dropping them
            # would return wrong rows
            raise ConditionError(
                "time conditions must be AND-ed at the top level of WHERE"
            )
        if refs and refs <= tag_keys:
            tag_parts.append(e)
        elif refs and not (refs & tag_keys):
            field_parts.append(e)
        elif not refs:
            field_parts.append(e)  # constant condition
        else:
            # subtree mixing tags and fields (reference evaluates arbitrary
            # condition trees, lib/binaryfilterfunc functions.go:143)
            mixed_parts.append(e)

    walk(cond)
    return SplitCondition(
        tmin, tmax, _and_join(tag_parts), _and_join(field_parts),
        _and_join(mixed_parts), frozenset(tag_keys),
    )


def _and_join(parts: list):
    if not parts:
        return None
    e = parts[0]
    for p in parts[1:]:
        e = ast.BinaryExpr("AND", e, p)
    return e


def _strip(e):
    while isinstance(e, ast.ParenExpr):
        e = e.expr
    return e


def _is_time_cond(e) -> bool:
    if not isinstance(e, ast.BinaryExpr):
        return False
    lhs, rhs = _strip(e.lhs), _strip(e.rhs)
    return (isinstance(lhs, ast.VarRef) and lhs.name.lower() == "time") or (
        isinstance(rhs, ast.VarRef) and rhs.name.lower() == "time"
    )


def _collect_refs(e) -> set[str]:
    out: set[str] = set()

    def walk(x):
        x = _strip(x)
        if isinstance(x, ast.VarRef):
            out.add(x.name)
        elif isinstance(x, ast.BinaryExpr):
            walk(x.lhs)
            walk(x.rhs)
        elif isinstance(x, ast.UnaryExpr):
            walk(x.expr)
        elif isinstance(x, ast.Call):
            for a in x.args:
                walk(a)

    walk(e)
    return out


def _time_bounds(e: ast.BinaryExpr, now_ns: int) -> tuple[int, int]:
    lhs, rhs = _strip(e.lhs), _strip(e.rhs)
    op = e.op
    if isinstance(rhs, ast.VarRef) and rhs.name.lower() == "time":
        # flip: lit OP time  ->  time OP' lit
        lhs, rhs = rhs, lhs
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    t = eval_time_expr(rhs, now_ns)
    if op == ">":
        return (t + 1, MAX_TIME)
    if op == ">=":
        return (t, MAX_TIME)
    if op == "<":
        return (MIN_TIME, t)
    if op == "<=":
        return (MIN_TIME, t + 1)
    if op == "=":
        return (t, t + 1)
    raise ConditionError(f"unsupported time operator {op!r}")


def eval_time_expr(e, now_ns: int) -> int:
    """Evaluate a time-valued expression: now(), literals, +/- arithmetic."""
    e = _strip(e)
    if isinstance(e, ast.Call) and e.name == "now":
        return now_ns
    if isinstance(e, ast.IntegerLiteral):
        return e.val  # bare integers in time context are ns
    if isinstance(e, ast.NumberLiteral):
        return int(e.val)
    if isinstance(e, ast.DurationLiteral):
        return e.val_ns
    if isinstance(e, ast.StringLiteral):
        return parse_rfc3339(e.val)
    if isinstance(e, ast.UnaryExpr) and e.op == "-":
        return -eval_time_expr(e.expr, now_ns)
    if isinstance(e, ast.BinaryExpr) and e.op in ("+", "-"):
        a = eval_time_expr(e.lhs, now_ns)
        b = eval_time_expr(e.rhs, now_ns)
        return a + b if e.op == "+" else a - b
    raise ConditionError(f"cannot evaluate time expression: {e}")


_TIME_FORMATS = [
    "%Y-%m-%dT%H:%M:%S.%fZ",
    "%Y-%m-%dT%H:%M:%SZ",
    "%Y-%m-%d %H:%M:%S.%f",
    "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%d",
]


def parse_rfc3339(s: str) -> int:
    # strptime %f caps at microseconds; peel off a 7-9 digit fraction so
    # ns-precision literals ('...T00:00:00.000000001Z') parse exactly
    frac_ns = 0
    m = re.match(r"^(.*T\d\d:\d\d:\d\d)\.(\d{7,9})(Z|[+-].*)$", s)
    if m:
        digits = m.group(2)
        frac_ns = int(digits.ljust(9, "0"))
        s = m.group(1) + m.group(3)
    for fmt in _TIME_FORMATS:
        try:
            dt = _dt.datetime.strptime(s, fmt).replace(tzinfo=_dt.timezone.utc)
            return (int(dt.timestamp()) * 1_000_000_000 + dt.microsecond * 1000
                    + frac_ns)
        except ValueError:
            continue
    raise ConditionError(f"bad time string {s!r}")


def format_rfc3339(t_ns: int) -> str:
    dt = _dt.datetime.fromtimestamp(t_ns // 1_000_000_000, tz=_dt.timezone.utc)
    frac = t_ns % 1_000_000_000
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if frac == 0:
        return base + "Z"
    s = f"{frac:09d}".rstrip("0")
    return f"{base}.{s}Z"


# -- tag filter -> sid sets --------------------------------------------------


def eval_tag_expr(expr, index, measurement: str) -> set[int]:
    """Evaluate a tags-only filter to a set of series ids via the inverted
    index (reference: engine/index/tsi/search.go tag filter search)."""
    expr = _strip(expr)
    if expr is None:
        return index.series_ids(measurement)
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return eval_tag_expr(expr.lhs, index, measurement) & eval_tag_expr(
                expr.rhs, index, measurement
            )
        if expr.op == "OR":
            return eval_tag_expr(expr.lhs, index, measurement) | eval_tag_expr(
                expr.rhs, index, measurement
            )
        lhs, rhs = _strip(expr.lhs), _strip(expr.rhs)
        if isinstance(rhs, ast.VarRef) and not isinstance(lhs, ast.VarRef):
            lhs, rhs = rhs, lhs
        if not isinstance(lhs, ast.VarRef):
            raise ConditionError(f"bad tag condition: {expr}")
        key = lhs.name
        if expr.op in ("=", "!=", "<>"):
            if isinstance(rhs, ast.VarRef):
                # tag-to-tag comparison (reference: `tennant = tennant`
                # matches everything, Where_With_Tags#17); distinct tags
                # compare per series
                all_sids = index.series_ids(measurement)
                if key == rhs.name:
                    return set(all_sids) if expr.op == "=" else set()
                out = set()
                for sid in all_sids:
                    tags = index.tags_of(sid)
                    same = tags.get(key) == tags.get(rhs.name)
                    if same == (expr.op == "="):
                        out.add(sid)
                return out
            if not isinstance(rhs, ast.StringLiteral):
                # tag vs non-string literal matches nothing — a typed
                # mismatch, not a statement error (reference
                # TagFilter#0: `where tag1=1` returns empty)
                return (
                    set() if expr.op == "="
                    else set(index.series_ids(measurement))
                )
            if expr.op == "=":
                return index.match_eq(measurement, key, rhs.val)
            return index.match_neq(measurement, key, rhs.val)
        if expr.op in ("=~", "!~"):
            if not isinstance(rhs, ast.RegexLiteral):
                raise ConditionError("regex comparison requires a regex")
            return index.match_regex(measurement, key, rhs.pattern, negate=expr.op == "!~")
    raise ConditionError(f"unsupported tag filter: {expr}")


def _as_sid_arr(sids) -> np.ndarray:
    """A set-returning walk result as the sorted int64 array the
    columnar composition path works in."""
    if isinstance(sids, np.ndarray):
        return sids
    if not sids:
        return np.empty(0, np.int64)
    return np.fromiter(sorted(sids), np.int64, len(sids))


def eval_tag_sids(expr, index, measurement: str,
                  device=None) -> np.ndarray:
    """eval_tag_expr over sorted int64 sid arrays: the columnar label
    tier (index.labels) answers leaves with posting arrays and AND/OR
    compose with np.intersect1d/union1d — no per-leaf Python set
    materialization. With the tier knob-disabled the set walk runs and
    the result converts; same sids either way. `device` is where a
    regex leaf's LUT gather may route (None: host only)."""
    from opengemini_tpu_torch.index import labels as _labels

    tier = _labels.tier_for(index)
    if tier is None:
        return _as_sid_arr(eval_tag_expr(expr, index, measurement))
    return _eval_tag_arr(expr, tier.snapshot(measurement), device)


def _eval_tag_arr(expr, snap, device=None) -> np.ndarray:
    expr = _strip(expr)
    if expr is None:
        return snap.sids
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            lhs = _eval_tag_arr(expr.lhs, snap, device)
            if lhs.size == 0:
                return lhs
            return np.intersect1d(lhs, _eval_tag_arr(expr.rhs, snap, device),
                                  assume_unique=True)
        if expr.op == "OR":
            return np.union1d(_eval_tag_arr(expr.lhs, snap, device),
                              _eval_tag_arr(expr.rhs, snap, device))
        lhs, rhs = _strip(expr.lhs), _strip(expr.rhs)
        if isinstance(rhs, ast.VarRef) and not isinstance(lhs, ast.VarRef):
            lhs, rhs = rhs, lhs
        if not isinstance(lhs, ast.VarRef):
            raise ConditionError(f"bad tag condition: {expr}")
        key = lhs.name
        if expr.op in ("=", "!=", "<>"):
            if isinstance(rhs, ast.VarRef):
                return snap.match_tag_compare(key, rhs.name,
                                              expr.op == "=")
            if not isinstance(rhs, ast.StringLiteral):
                # typed mismatch matches nothing (see eval_tag_expr)
                return (np.empty(0, np.int64) if expr.op == "="
                        else snap.sids)
            if expr.op == "=":
                return snap.match_eq(key, rhs.val)
            return snap.match_neq(key, rhs.val)
        if expr.op in ("=~", "!~"):
            if not isinstance(rhs, ast.RegexLiteral):
                raise ConditionError("regex comparison requires a regex")
            return snap.match_regex(key, rhs.pattern,
                                    negate=expr.op == "!~", device=device)
    raise ConditionError(f"unsupported tag filter: {expr}")


def tag_superset_arr(expr, index, measurement: str,
                     tag_keys: set[str], device=None) -> np.ndarray:
    """tag_superset_sids over sorted sid arrays (same widening rules)."""
    from opengemini_tpu_torch.index import labels as _labels

    tier = _labels.tier_for(index)
    if tier is None:
        return _as_sid_arr(
            tag_superset_sids(expr, index, measurement, tag_keys))
    return _superset_arr(expr, tier.snapshot(measurement), tag_keys, device)


def _superset_arr(expr, snap, tag_keys: set[str],
                  device=None) -> np.ndarray:
    expr = _strip(expr)
    if expr is None:
        return snap.sids
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return np.intersect1d(
                _superset_arr(expr.lhs, snap, tag_keys, device),
                _superset_arr(expr.rhs, snap, tag_keys, device),
                assume_unique=True)
        if expr.op == "OR":
            return np.union1d(_superset_arr(expr.lhs, snap, tag_keys, device),
                              _superset_arr(expr.rhs, snap, tag_keys, device))
    refs = _collect_refs(expr)
    if refs and refs <= tag_keys and isinstance(expr, ast.BinaryExpr):
        lhs, rhs = _strip(expr.lhs), _strip(expr.rhs)
        for side in (lhs, rhs):
            if isinstance(side, ast.StringLiteral) and side.val == "" \
                    and expr.op == "=":
                return snap.sids
            if isinstance(side, ast.RegexLiteral) and expr.op == "=~" \
                    and re.search(side.pattern, ""):
                return snap.sids
        try:
            return _eval_tag_arr(expr, snap, device)
        except ConditionError:
            return snap.sids
    return snap.sids


def series_only_arr(expr, index, measurement: str,
                    tag_keys: set[str], device=None) -> np.ndarray:
    """series_only_sids over sorted sid arrays (field leaves are empty)."""
    from opengemini_tpu_torch.index import labels as _labels

    tier = _labels.tier_for(index)
    if tier is None:
        return _as_sid_arr(
            series_only_sids(expr, index, measurement, tag_keys))
    return _series_only_arr(expr, tier.snapshot(measurement), tag_keys,
                            device)


def _series_only_arr(expr, snap, tag_keys: set[str],
                     device=None) -> np.ndarray:
    expr = _strip(expr)
    if expr is None:
        return snap.sids
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return np.intersect1d(
                _series_only_arr(expr.lhs, snap, tag_keys, device),
                _series_only_arr(expr.rhs, snap, tag_keys, device),
                assume_unique=True)
        if expr.op == "OR":
            return np.union1d(
                _series_only_arr(expr.lhs, snap, tag_keys, device),
                _series_only_arr(expr.rhs, snap, tag_keys, device))
    refs = _collect_refs(expr)
    if refs and refs <= tag_keys:
        try:
            return _eval_tag_arr(expr, snap, device)
        except ConditionError:
            return np.empty(0, np.int64)
    return np.empty(0, np.int64)  # field leaves identify no series


def tag_superset_sids(expr, index, measurement: str, tag_keys: set[str]) -> set[int]:
    """SOUND sid superset for a mixed tag/field tree: every sid that could
    possibly satisfy the condition on some row. Field leaves (and any leaf
    the index cannot answer conservatively) widen to all sids; tag leaves
    use the inverted index. Used to prune the scan before the exact
    per-row evaluation (eval_row_filter)."""
    expr = _strip(expr)
    all_sids = index.series_ids(measurement)
    if expr is None:
        return set(all_sids)
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return tag_superset_sids(expr.lhs, index, measurement, tag_keys) & \
                tag_superset_sids(expr.rhs, index, measurement, tag_keys)
        if expr.op == "OR":
            return tag_superset_sids(expr.lhs, index, measurement, tag_keys) | \
                tag_superset_sids(expr.rhs, index, measurement, tag_keys)
    refs = _collect_refs(expr)
    if refs and refs <= tag_keys and isinstance(expr, ast.BinaryExpr):
        # widen when the leaf can match series MISSING the tag (which the
        # index has no posting for): `tag = ''` and regexes matching ''
        lhs, rhs = _strip(expr.lhs), _strip(expr.rhs)
        for side in (lhs, rhs):
            if isinstance(side, ast.StringLiteral) and side.val == "" \
                    and expr.op == "=":
                return set(all_sids)
            if isinstance(side, ast.RegexLiteral) and expr.op == "=~" \
                    and re.search(side.pattern, ""):
                return set(all_sids)
        try:
            return eval_tag_expr(expr, index, measurement)
        except ConditionError:
            return set(all_sids)
    return set(all_sids)


def series_only_sids(expr, index, measurement: str, tag_keys: set[str]) -> set[int]:
    """Series-level evaluation for /*+ full_series */ and
    /*+ specific_series */ hints (reference: hybrid store reader's
    series-keyed scan): the condition identifies whole series, so field
    leaves evaluate FALSE and the tag tree selects sids directly."""
    expr = _strip(expr)
    if expr is None:
        return set(index.series_ids(measurement))
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return series_only_sids(expr.lhs, index, measurement, tag_keys) & \
                series_only_sids(expr.rhs, index, measurement, tag_keys)
        if expr.op == "OR":
            return series_only_sids(expr.lhs, index, measurement, tag_keys) | \
                series_only_sids(expr.rhs, index, measurement, tag_keys)
    refs = _collect_refs(expr)
    if refs and refs <= tag_keys:
        try:
            return eval_tag_expr(expr, index, measurement)
        except ConditionError:
            return set()
    return set()  # field leaves identify no series


# -- field filter -> numpy mask ----------------------------------------------


def field_filter_refs(expr) -> set[str]:
    return _collect_refs(expr)


def row_filter_refs(sc: "SplitCondition") -> set[str]:
    """Storage FIELD names the row filters read: field_expr refs plus the
    non-tag refs of mixed_expr (tag refs come from the index, not chunks)."""
    refs = set()
    if sc.field_expr is not None:
        refs |= _collect_refs(sc.field_expr)
    if sc.mixed_expr is not None and not sc.mixed_series_level:
        refs |= _collect_refs(sc.mixed_expr) - set(sc.tag_keys)
    return refs


def _with_tag_columns(rec, tag_refs, tags=None, sid_arr=None, index=None):
    """Record plus the series' tag values as broadcast string columns.
    Missing tags inject as '' (influx: an absent tag compares as the
    empty string at row level). `tags` serves the per-series case;
    (sid_arr, index) the bulk case (per-row lookup via the sid column)."""
    from opengemini_tpu_torch.record import Column, FieldType, Record

    n = len(rec)
    cols = dict(rec.columns)
    for key in tag_refs:
        if tags is not None:
            vals = np.full(n, tags.get(key, ""), dtype=object)
        else:
            uniq = np.unique(sid_arr)
            lut = {int(s): index.tags_of(int(s)).get(key, "") for s in uniq}
            vals = np.array([lut[int(s)] for s in sid_arr], dtype=object)
        cols[key] = Column(FieldType.STRING, vals, np.ones(n, dtype=np.bool_))
    return Record(rec.times, cols)


def eval_row_filter(sc: "SplitCondition", rec, tags=None, sid_arr=None,
                    index=None) -> np.ndarray:
    """Combined per-row mask: field_expr AND mixed_expr (the latter with
    the series' tags injected as columns). Callers pass `tags` (per-series
    scans) or `sid_arr` + `index` (bulk scans)."""
    if sc.field_expr is not None:
        m = eval_field_expr(sc.field_expr, rec)
    else:
        m = np.ones(len(rec), dtype=np.bool_)
    if sc.mixed_expr is not None and not sc.mixed_series_level:
        tag_refs = _collect_refs(sc.mixed_expr) & set(sc.tag_keys)
        rec2 = _with_tag_columns(rec, tag_refs, tags, sid_arr, index)
        m = m & eval_field_expr(sc.mixed_expr, rec2)
    return m


def eval_field_expr(expr, record) -> np.ndarray:
    """Vectorized row mask for a fields-only filter over a Record. Null
    (invalid) values compare false, like the reference's cond functions
    (lib/binaryfilterfunc functions.go:143)."""
    n = len(record)
    expr = _strip(expr)
    if expr is None:
        return np.ones(n, dtype=np.bool_)
    if isinstance(expr, ast.BinaryExpr):
        if expr.op == "AND":
            return eval_field_expr(expr.lhs, record) & eval_field_expr(expr.rhs, record)
        if expr.op == "OR":
            return eval_field_expr(expr.lhs, record) | eval_field_expr(expr.rhs, record)
        lhs, rhs = _strip(expr.lhs), _strip(expr.rhs)
        op = expr.op
        if isinstance(rhs, ast.VarRef) and not isinstance(lhs, ast.VarRef):
            lhs, rhs = rhs, lhs
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if isinstance(lhs, ast.VarRef) and isinstance(rhs, ast.VarRef):
            # column vs column (tag-vs-field compares arrive here with the
            # tag injected as a string column — eval_row_filter)
            a = record.columns.get(lhs.name)
            b = record.columns.get(rhs.name)
            if a is None or b is None:
                return np.zeros(n, dtype=np.bool_)
            if (a.values.dtype == object) != (b.values.dtype == object):
                return np.zeros(n, dtype=np.bool_)  # typed mismatch
            av, bv = a.values, b.values
            if av.dtype == object:
                # ordered compares on object arrays choke on None at
                # invalid rows; the mask below discards them anyway
                av = np.where(a.valid, av, "")
                bv = np.where(b.valid, bv, "")
            with np.errstate(invalid="ignore"):
                if op == "=":
                    m = av == bv
                elif op in ("!=", "<>"):
                    m = av != bv
                elif op == "<":
                    m = av < bv
                elif op == "<=":
                    m = av <= bv
                elif op == ">":
                    m = av > bv
                elif op == ">=":
                    m = av >= bv
                else:
                    raise ConditionError(f"unsupported field operator {op!r}")
            return np.asarray(m, dtype=np.bool_) & a.valid & b.valid
        if isinstance(lhs, ast.VarRef):
            col = record.columns.get(lhs.name)
            if col is None:
                return np.zeros(n, dtype=np.bool_)
            if isinstance(rhs, ast.RegexLiteral):
                rx = re.compile(rhs.pattern)
                vals = np.array(
                    [bool(rx.search(v)) if isinstance(v, str) else False for v in col.values]
                )
                m = vals if op == "=~" else ~vals
                return m & col.valid
            lit = _literal_value(rhs)
            vals = col.values
            if isinstance(lit, str) != (col.values.dtype == object):
                return np.zeros(n, dtype=np.bool_)
            with np.errstate(invalid="ignore"):
                if op == "=":
                    m = vals == lit
                elif op in ("!=", "<>"):
                    m = vals != lit
                elif op == "<":
                    m = vals < lit
                elif op == "<=":
                    m = vals <= lit
                elif op == ">":
                    m = vals > lit
                elif op == ">=":
                    m = vals >= lit
                else:
                    raise ConditionError(f"unsupported field operator {op!r}")
            return np.asarray(m, dtype=np.bool_) & col.valid
    if isinstance(expr, ast.BooleanLiteral):
        return np.full(n, expr.val, dtype=np.bool_)
    if isinstance(expr, ast.Call) and expr.name == "match":
        # full-text token match over a string field
        from opengemini_tpu_torch.native.textindex import match_token

        if len(expr.args) != 2:
            raise ConditionError("match() takes (field, 'token')")
        fld = _strip(expr.args[0])
        tok = _strip(expr.args[1])
        if (not isinstance(fld, ast.VarRef)
                or not isinstance(tok, ast.StringLiteral)):
            raise ConditionError("match() takes (field, 'token')")
        col = record.columns.get(fld.name)
        if col is None:
            return np.zeros(n, dtype=np.bool_)
        return match_token(col.values, col.valid, tok.val)
    raise ConditionError(f"unsupported field filter: {expr}")


def conjunctive_match_terms(expr) -> list[tuple[str, str]]:
    """(field, token) pairs of the match() calls that are top-level
    conjuncts of the field filter: only those may prune series (a match
    under an OR constrains nothing on its own)."""
    expr = _strip(expr)
    if expr is None:
        return []
    if isinstance(expr, ast.BinaryExpr) and expr.op == "AND":
        return (conjunctive_match_terms(expr.lhs)
                + conjunctive_match_terms(expr.rhs))
    if (isinstance(expr, ast.Call) and expr.name == "match"
            and len(expr.args) == 2):
        fld, tok = _strip(expr.args[0]), _strip(expr.args[1])
        if isinstance(fld, ast.VarRef) and isinstance(tok, ast.StringLiteral):
            return [(fld.name, tok.val)]
    return []


def _literal_value(e):
    e = _strip(e)
    if isinstance(e, ast.NumberLiteral):
        return e.val
    if isinstance(e, ast.IntegerLiteral):
        return e.val
    if isinstance(e, ast.StringLiteral):
        return e.val
    if isinstance(e, ast.BooleanLiteral):
        return e.val
    if isinstance(e, ast.UnaryExpr) and e.op == "-":
        return -_literal_value(e.expr)
    raise ConditionError(f"expected literal, got {e}")


def exact_series_tags(expr, tag_keys) -> dict:
    """All tag-equality pairs appearing anywhere in a condition tree.

    The /*+ full_series */ contract (reference influxql FullSeriesQuery,
    parser.go:37): the collected pairs form the EXACT series key — a
    series carrying additional tags does not match even where the
    predicate itself holds (TestServer_Query_FullSeries: host=server01
    selects cpu,host=server01 but not cpu,host=server01,region=uswest).
    Non-tag terms (field predicates, OR branches) contribute pairs but
    never widen the match.
    """
    pairs: dict[str, str] = {}

    def walk(e):
        e = _strip(e)
        if isinstance(e, ast.BinaryExpr):
            if e.op in ("AND", "OR"):
                walk(e.lhs)
                walk(e.rhs)
                return
            lhs, rhs = _strip(e.lhs), _strip(e.rhs)
            if (
                e.op == "="
                and isinstance(lhs, ast.VarRef)
                and lhs.name in tag_keys
                and isinstance(rhs, ast.StringLiteral)
            ):
                pairs[lhs.name] = rhs.val

    if expr is not None:
        walk(expr)
    return pairs
