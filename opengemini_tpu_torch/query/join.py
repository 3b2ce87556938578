"""JOIN and UNION execution over raw row sets.

The port of ``opengemini_tpu/query/join.py``: every join side and every
union side is a select of the port's executor, so their aggregates run
on the engine's device like any other. Reference:
engine/executor/logic_plan.go:3679 (LogicalJoin),
sort_merge_join_transform.go / hash_join_transform.go, join_rule.go
(MatchSortMergeJoin: join keys within the GROUP BY subset), and the
behavior tables in tests/server_test.go (TestServer_Join_Table,
TestServer_HashJoin_Table, TestServer_Union_Table).

Model (validated against the reference's expected outputs):
  - each side evaluates as a raw per-series row set with tags preserved;
  - rows join per ON-tag-key equality, optionally requiring equal
    timestamps when the ON clause contains `l.time = r.time`;
  - the LEFT side drives in (time, series) order: inner/left/outer/full
    emit the left row's timestamp, right joins emit the matched right
    row's timestamp; unmatched non-driving rows append afterwards in
    (key, row) order;
  - `outer join` null-fills the missing side, `full join` zero-fills
    numeric columns (observed reference behavior);
  - `select *` expands each side's fields plus any tags not consumed by
    the outer GROUP BY, qualified `label.name`, alphabetically.
"""

from __future__ import annotations

import copy

from opengemini_tpu_torch.query.qhelpers import (
    QueryError, _classify_select, _inner_source_name, _strip_expr,
)
from opengemini_tpu_torch.sql import ast

__all__ = ["select_join", "execute_union", "JoinError"]


class JoinError(ValueError):
    pass


def _source_label(src) -> str:
    alias = getattr(src, "alias", "")
    if alias:
        return alias
    if isinstance(src, ast.Measurement) and src.name:
        return src.name
    raise JoinError("join sources need a name or alias")


def _side_rows(executor, src, db: str, now_ns: int, condition, ctes):
    """Evaluate one join side into (label, series_list) where each series
    is {'tags': dict, 'columns': [names], 'rows': [[t, v...], ...]}."""
    label = _source_label(src)
    if isinstance(src, ast.Measurement):
        inner_src = ast.Measurement(
            name=src.name, regex=src.regex, database=src.database, rp=src.rp
        )
    else:
        stmt = copy.copy(src.stmt)
        if not stmt.group_by_tags and not stmt.group_by_all_tags:
            # raw subquery sides must keep series tags for the ON keys
            stmt = copy.copy(stmt)
            stmt.group_by_all_tags = True
        inner_src = ast.SubQuery(stmt)
    inner = ast.SelectStatement(
        fields=[ast.Field(ast.Wildcard())],
        sources=[inner_src],
        condition=condition,
        group_by_all_tags=True,
    )
    inner.ctes = ctes
    res = executor._select(inner, db, now_ns)
    series = []
    for s in res.get("series", []):
        series.append({
            "tags": s.get("tags", {}) or {},
            "columns": s["columns"][1:],  # strip time
            "rows": s["values"],
        })
    series.sort(key=lambda s: tuple(sorted(s["tags"].items())))
    return label, series


def _parse_on(on, llabel: str, rlabel: str):
    """ON conjunction -> ([(ltag, rtag)], time_eq). Only tag equality and
    l.time = r.time are supported (reference MatchSortMergeJoin rule 1)."""
    pairs: list[tuple[str, str]] = []
    time_eq = False

    def strip(e):
        while isinstance(e, ast.ParenExpr):
            e = e.expr
        return e

    def walk(e):
        nonlocal time_eq
        e = strip(e)
        if isinstance(e, ast.BinaryExpr) and e.op == "AND":
            walk(e.lhs)
            walk(e.rhs)
            return
        if not (isinstance(e, ast.BinaryExpr) and e.op == "="):
            raise JoinError("join ON supports only equality conditions")
        l, r = strip(e.lhs), strip(e.rhs)
        if not (isinstance(l, ast.VarRef) and isinstance(r, ast.VarRef)):
            raise JoinError("join ON operands must be column references")
        lname, rname = l.name, r.name
        if not (lname.startswith(llabel + ".") and rname.startswith(rlabel + ".")):
            # allow reversed order r.x = l.x
            if rname.startswith(llabel + ".") and lname.startswith(rlabel + "."):
                lname, rname = rname, lname
            else:
                raise JoinError(
                    f"join ON references must qualify {llabel!r} and {rlabel!r}")
        lkey = lname[len(llabel) + 1:]
        rkey = rname[len(rlabel) + 1:]
        if lkey.lower() == "time" and rkey.lower() == "time":
            time_eq = True
            return
        pairs.append((lkey, rkey))

    walk(on)
    if not pairs:
        raise JoinError("join ON requires at least one tag equality")
    return pairs, time_eq


def _split_where(condition, llabel: str, rlabel: str):
    """Split the outer WHERE's top-level AND terms per join side: time-only
    terms go to both, `label.x`-qualified terms to their side (prefix
    stripped), anything else is rejected — pushing a one-side field
    predicate to the other side would zero it out."""
    if condition is None:
        return None, None
    terms: list = []

    def flatten_and(e):
        while isinstance(e, ast.ParenExpr):
            e = e.expr
        if isinstance(e, ast.BinaryExpr) and e.op.upper() == "AND":
            flatten_and(e.lhs)
            flatten_and(e.rhs)
        else:
            terms.append(e)

    flatten_and(condition)

    def refs_of(e, acc):
        if isinstance(e, ast.VarRef):
            acc.append(e.name)
        elif isinstance(e, ast.BinaryExpr):
            refs_of(e.lhs, acc)
            refs_of(e.rhs, acc)
        elif isinstance(e, (ast.ParenExpr, ast.UnaryExpr)):
            refs_of(e.expr, acc)

    def strip_label(e, label):
        if isinstance(e, ast.VarRef) and e.name.startswith(label + "."):
            return ast.VarRef(e.name[len(label) + 1:])
        if isinstance(e, ast.BinaryExpr):
            return ast.BinaryExpr(
                e.op, strip_label(e.lhs, label), strip_label(e.rhs, label))
        if isinstance(e, ast.ParenExpr):
            return ast.ParenExpr(strip_label(e.expr, label))
        if isinstance(e, ast.UnaryExpr):
            return ast.UnaryExpr(e.op, strip_label(e.expr, label))
        return e

    lterms, rterms = [], []
    for t in terms:
        acc: list[str] = []
        refs_of(t, acc)
        non_time = [r for r in acc if r.lower() != "time"]
        if not non_time:
            lterms.append(t)
            rterms.append(t)
        elif all(r.startswith(llabel + ".") for r in non_time):
            lterms.append(strip_label(t, llabel))
        elif all(r.startswith(rlabel + ".") for r in non_time):
            rterms.append(strip_label(t, rlabel))
        else:
            raise JoinError(
                "join WHERE predicates must qualify one side "
                f"({llabel!r} or {rlabel!r}) or reference time only")

    def conj(ts):
        out = None
        for t in ts:
            out = t if out is None else ast.BinaryExpr("AND", out, t)
        return out

    return conj(lterms), conj(rterms)


def _flatten(series):
    """[(t, tags, {field: val}, series_idx)] in (time, series) order."""
    out = []
    for si, s in enumerate(series):
        cols = s["columns"]
        for row in s["rows"]:
            t = row[0]
            out.append((t, s["tags"], dict(zip(cols, row[1:])), si))
    out.sort(key=lambda r: (r[0], r[3]))
    return out


def _side_columns(series) -> list[str]:
    cols: set[str] = set()
    tags: set[str] = set()
    for s in series:
        cols.update(s["columns"])
        tags.update(s["tags"].keys())
    return sorted(cols), sorted(tags)


def select_join(executor, stmt, join_src, db: str, now_ns: int) -> list[dict]:
    if isinstance(join_src.left, ast.JoinSource) or isinstance(
            join_src.right, ast.JoinSource):
        raise QueryError("cascading joins are not supported yet")
    for f in stmt.fields:
        e = _strip_expr(f.expr)
        if isinstance(e, ast.Call):
            raise QueryError("aggregates over joins are not supported yet")

    llabel = _source_label(join_src.left)
    rlabel = _source_label(join_src.right)
    try:
        lcond, rcond = _split_where(stmt.condition, llabel, rlabel)
        pairs, time_eq = _parse_on(join_src.on, llabel, rlabel)
    except JoinError as e:
        raise QueryError(str(e)) from None
    llabel, lseries = _side_rows(
        executor, join_src.left, db, now_ns, lcond, stmt.ctes)
    rlabel, rseries = _side_rows(
        executor, join_src.right, db, now_ns, rcond, stmt.ctes)
    kind = join_src.kind

    lrows = _flatten(lseries)
    rrows = _flatten(rseries)
    lfields, ltags = _side_columns(lseries)
    rfields, rtags = _side_columns(rseries)

    # ON keys must be tags: a FIELD key would silently degrade to "" on
    # every row and produce a cartesian product
    for lt, rt in pairs:
        if lt in lfields and lt not in ltags:
            raise QueryError(f"join ON key {lt!r} is a field of {llabel!r}; "
                             "joins support tag keys only")
        if rt in rfields and rt not in rtags:
            raise QueryError(f"join ON key {rt!r} is a field of {rlabel!r}; "
                             "joins support tag keys only")

    def lkey(tags):
        return tuple(tags.get(lt, "") for lt, _ in pairs)

    def rkey(tags):
        return tuple(tags.get(rt, "") for _, rt in pairs)

    rindex: dict[tuple, list[int]] = {}
    for i, (t, tags, vals, si) in enumerate(rrows):
        rindex.setdefault(rkey(tags), []).append(i)

    matched_right: set[int] = set()
    # out rows: (out_time, drive_tags, ltags, lvals, rtags, rvals)
    out_rows = []
    for t, tags, vals, _si in lrows:
        key = lkey(tags)
        cands = rindex.get(key, [])
        if time_eq:
            cands = [i for i in cands if rrows[i][0] == t]
        if cands:
            for i in cands:
                matched_right.add(i)
                rt, rtg, rvals, _ = rrows[i]
                out_time = rt if kind == "right" else t
                out_rows.append((out_time, tags, tags, vals, rtg, rvals))
        else:
            if kind in ("left", "outer", "full"):
                out_rows.append((t, tags, tags, vals, None, None))
            # inner/right: unmatched left dropped
    if kind in ("right", "outer", "full"):
        unmatched = [i for i in range(len(rrows)) if i not in matched_right]
        unmatched.sort(key=lambda i: (rkey(rrows[i][1]), i))
        for i in unmatched:
            rt, rtg, rvals, _ = rrows[i]
            out_rows.append((rt, rtg, None, None, rtg, rvals))

    # ---- output columns ----
    group_tags = list(stmt.group_by_tags)
    out_name = f"{llabel},{rlabel}"

    def expand_side(label, fields, tags):
        names = set(fields) | {t for t in tags if t not in group_tags}
        return [(label, n) for n in sorted(names)]

    col_plan: list[tuple[str, str]] = []  # (side_label, name) per column
    columns = ["time"]
    for f in stmt.fields:
        e = _strip_expr(f.expr)
        if isinstance(e, ast.Wildcard):
            for side in (expand_side(llabel, lfields, ltags)
                         + expand_side(rlabel, rfields, rtags)):
                col_plan.append(side)
                columns.append(f"{side[0]}.{side[1]}")
        elif isinstance(e, ast.VarRef):
            name = e.name
            if name.endswith(".*"):
                lab = name[:-2]
                if lab == llabel:
                    sides = expand_side(llabel, lfields, ltags)
                elif lab == rlabel:
                    sides = expand_side(rlabel, rfields, rtags)
                else:
                    raise QueryError(f"unknown join side {lab!r}")
                for side in sides:
                    col_plan.append(side)
                    columns.append(f"{side[0]}.{side[1]}")
                continue
            if "." in name:
                lab, _, fldname = name.partition(".")
                if lab not in (llabel, rlabel):
                    raise QueryError(f"unknown join side {lab!r} in {name!r}")
            else:
                lab = llabel if name in lfields or name in ltags else rlabel
                fldname = name
            col_plan.append((lab, fldname))
            columns.append(f.alias or f"{lab}.{fldname}")
        else:
            raise QueryError(
                "join select supports fields, qualified refs and * only")

    # numeric columns for full-join zero fill (computed once per side)
    def _numeric_map(series):
        out: dict[str, bool] = {}
        for s in series:
            for ci, name in enumerate(s["columns"]):
                if out.get(name):
                    continue
                for row in s["rows"]:
                    v = row[ci + 1]
                    if v is not None:
                        out[name] = (isinstance(v, (int, float))
                                     and not isinstance(v, bool))
                        break
        return out

    numeric_l = _numeric_map(lseries)
    numeric_r = _numeric_map(rseries)

    def is_numeric(lab, name):
        return (numeric_l if lab == llabel else numeric_r).get(name, False)

    def cell(lab, name, tags, vals):
        if vals is None:
            if kind == "full" and is_numeric(lab, name):
                return 0
            return None
        if name in vals:
            return vals[name]
        if tags is not None:
            side_tags = ltags if lab == llabel else rtags
            if name in side_tags:
                return tags.get(name, "")
        return None

    # ---- group + render ----
    grouped: dict[tuple, list] = {}
    for out_time, dtags, ltg, lvals, rtg, rvals in out_rows:
        gkey = tuple(dtags.get(t, "") for t in group_tags)
        row = [out_time]
        for lab, name in col_plan:
            if lab == llabel:
                row.append(cell(lab, name, ltg, lvals))
            else:
                row.append(cell(lab, name, rtg, rvals))
        grouped.setdefault(gkey, []).append(row)

    out_series = []
    for gkey in sorted(grouped):
        rows = grouped[gkey]
        if not stmt.ascending:
            rows = list(reversed(rows))
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit:
            rows = rows[: stmt.limit]
        if not rows:
            continue
        series = {"name": out_name, "columns": columns, "values": rows}
        if group_tags:
            series["tags"] = dict(zip(group_tags, gkey))
        out_series.append(series)
    return out_series


# ---------------------------------------------------------------------------
# UNION


def _type_class(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    return "string"


def _col_types(cols, rows):
    types = {}
    for ci, c in enumerate(cols):
        if c == "time":
            continue
        for _nm, row in rows:
            tc = _type_class(row[ci])
            if tc is not None:
                types[c] = tc
                break
    return types


def _eval_union_side(executor, s, db: str, now_ns: int):
    """Terminal union side -> (cols, [(side_name, row)]).

    Layout per side (observed reference union tables): time, the side's
    own output columns, its GROUP BY tags (sorted), then remaining tags
    (sorted).  Tag columns materialize only for wildcard selects — an
    explicit field list never grows tag columns."""
    name = _inner_source_name(s)
    has_wild = any(
        isinstance(_strip_expr(f.expr), ast.Wildcard) for f in s.fields
    )
    run_stmt = s
    if has_wild and _classify_select(s) == "raw" and not s.group_by_all_tags:
        run_stmt = copy.copy(s)
        run_stmt.group_by_all_tags = True
    res = executor._select(run_stmt, db, now_ns)
    series = res.get("series", [])
    if not series:
        return None
    base_cols = series[0]["columns"]
    group_tags = sorted(s.group_by_tags)
    rows = []
    tag_cols: list[str] = []
    if has_wild:
        all_tags = sorted({k for ser in series for k in (ser.get("tags") or {})})
        tag_cols = group_tags + [t for t in all_tags if t not in group_tags]
    cols = list(base_cols) + tag_cols
    for ser in series:
        if ser["columns"] != base_cols:
            raise JoinError("union sides must produce uniform columns")
        tags = ser.get("tags") or {}
        extra = [tags.get(t, "") for t in tag_cols]
        for row in ser["values"]:
            rows.append((name, list(row) + extra))
    # within a side, rows order by (time, values in alphabetical column
    # order) — the reference's observed union row order
    order_ix = [0] + sorted(range(1, len(cols)), key=lambda i: cols[i])

    def _key(item):
        _nm, row = item
        return tuple(
            (0, row[i]) if row[i] is not None else (1, "")
            for i in order_ix
        )

    rows.sort(key=_key)
    return cols, rows


def execute_union(executor, stmt, db: str, now_ns: int) -> dict:
    def eval_unit(s):
        if isinstance(s, ast.UnionStatement):
            return _fold_union(executor, s, db, now_ns)
        try:
            return _eval_union_side(executor, s, db, now_ns)
        except JoinError as e:
            raise QueryError(str(e)) from None

    def _fold_union(executor, ustmt, db, now_ns):
        units = [eval_unit(s) for s in ustmt.selects]
        acc = None
        for unit, (all_, by_name) in zip(units, [(True, False)] + ustmt.combines):
            if unit is None:
                continue
            cols, rows = unit
            types = _col_types(cols, rows)
            if acc is None:
                acc_cols, acc_rows, acc_types = list(cols), list(rows), types
                acc = True
                continue
            if by_name:
                for c, tc in types.items():
                    if c in acc_types and acc_types[c] != tc:
                        raise QueryError(
                            "columns with same name must have the same data "
                            "type when using union by name/union all by name")
                merged = ["time"] + sorted((set(acc_cols) | set(cols)) - {"time"})
                old_ix = [acc_cols.index(c) if c in acc_cols else None for c in merged]
                new_ix = [cols.index(c) if c in cols else None for c in merged]
                acc_rows = [
                    (nm, [row[i] if i is not None else None for i in old_ix])
                    for nm, row in acc_rows
                ]
                acc_rows += [
                    (nm, [row[i] if i is not None else None for i in new_ix])
                    for nm, row in rows
                ]
                acc_cols = merged
                acc_types.update(types)
            else:
                if len(cols) != len(acc_cols):
                    raise QueryError(
                        "union/union all can only apply to expressions with "
                        "the same number of result columns")
                for ci in range(len(acc_cols)):
                    tc_old = acc_types.get(acc_cols[ci])
                    tc_new = types.get(cols[ci])
                    if tc_old and tc_new and tc_old != tc_new:
                        raise QueryError(
                            "columns in the same index position must have the "
                            "same data type when using union/union all")
                acc_rows += [(nm, list(row)) for nm, row in rows]
            if not all_:
                seen, dedup = set(), []
                for nm, row in acc_rows:
                    k = tuple(row)
                    if k not in seen:
                        seen.add(k)
                        dedup.append((nm, row))
                acc_rows = dedup
        if acc is None:
            return None
        return acc_cols, acc_rows

    folded = _fold_union(executor, stmt, db, now_ns)
    if folded is None:
        return {}
    cols, rows = folded
    # final columns sort alphabetically (time first); values were already
    # name-mapped during the fold
    order_ix = [0] + sorted(range(1, len(cols)), key=lambda i: cols[i])
    cols = [cols[i] for i in order_ix]
    rows = [(nm, [row[i] for i in order_ix]) for nm, row in rows]
    # block-sort rows by source name (stable within a side), matching the
    # reference's sorted compound series name
    rows.sort(key=lambda nr: nr[0])
    names = sorted({nm for nm, _ in rows})
    name = ",".join(names) if names else "union"
    return {"series": [{"name": name,
                        "columns": cols,
                        "values": [row for _nm, row in rows]}]}
