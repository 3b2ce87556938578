"""Planner splice over materialized rollups (storage/rollup.py).

The port of ``opengemini_tpu/query/rollupplan.py``, whole. For an
eligible ``GROUP BY time(T)`` aggregate (T a multiple of a declared
rollup's interval, the grid on the rollup's boundaries, a tags-only
WHERE, every aggregate derivable from rollup cells: count, sum, min,
max, mean = s/c, percentile from the spec's sketches) the executor
builds a RollupPlan: windows wholly below the rollup's durable
watermark and not dirty are answered from rollup rows; the rest (the
live tail, re-dirtied late windows, partial edge windows) stays a raw
scan through the grid on the engine's device. The plan only ever serves
windows the incremental result cache (query/resultcache.py) classified
stale, and ``merge`` runs before the cache's merge, so the cache
persists the spliced cells from the same arrays.
"""

from __future__ import annotations

import base64

import numpy as np

from opengemini_tpu_torch.query.sketch import RollupSketch
from opengemini_tpu_torch.storage import rollup as rmod
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


def try_plan(mgr, db, rp, mst, sc, ctx, aggs, schema, cache_plan,
             tmin, tmax):
    """Build a RollupPlan or return None (query ineligible / nothing
    servable).  Cheap when no spec matches: two dict lookups."""
    if mgr is None or not mgr.read_enabled:
        return None
    group_time = ctx.group_time
    if group_time is None or not aggs:
        return None
    if sc.field_expr is not None or sc.mixed_expr is not None:
        return None  # row-level filters are not derivable from cells
    spec = mgr.spec_for(db, rp, mst, group_time.every_ns, ctx.aligned)
    if spec is None:
        return None
    for _call, aspec, _params, fname in aggs:
        if aspec.name == "percentile":
            if not spec.sketch:
                return None
        elif aspec.name not in rmod.DERIVABLE:
            return None
        if spec.fields is not None and fname not in spec.fields:
            return None
    plan = RollupPlan(mgr, db, spec, sc, ctx, aggs, tmin, tmax, cache_plan)
    if not plan.serve:
        STATS.incr("rollup", "splice_misses")
        return None
    return plan


class RollupPlan:
    def __init__(self, mgr, db, spec, sc, ctx, aggs, tmin, tmax,
                 cache_plan):
        self.mgr = mgr
        self.db = db
        self.spec = spec
        self.sc = sc
        self.aggs = aggs
        self.group_tags = ctx.group_tags
        self.aligned = ctx.aligned
        self.every = ctx.group_time.every_ns
        self.W = ctx.W
        self.tmin = tmin
        self.tmax = tmax
        self.rows_read = 0
        wstarts = [self.aligned + w * self.every for w in range(self.W)]
        partial = {
            w for w in range(self.W)
            if wstarts[w] < tmin or wstarts[w] + self.every > tmax
        }
        candidate = (set(cache_plan.stale) if cache_plan is not None
                     else set(range(self.W)))
        self.candidate = candidate
        wm, dirty = mgr.serve_view(db, spec)
        # map each dirty rollup window into its containing QUERY window
        # once (the dirty set is bounded; probing every sub-window of
        # every query window would be O(W * T/interval))
        span_hi = self.aligned + self.W * self.every
        dirty_qw = {
            int((s - self.aligned) // self.every)
            for s in dirty if self.aligned <= s < span_hi
        }
        serve = set()
        for w in candidate - partial:
            if wstarts[w] + self.every > wm or w in dirty_qw:
                continue
            serve.add(w)
        self.wstarts = wstarts
        self.serve = serve
        # {w: {group_key: [(value, count) per agg]}}
        self.cells: dict[int, dict[tuple, list]] = {}

    @property
    def scan_ranges(self):
        """Disjoint [lo, hi) raw ranges covering the candidate windows
        the rollup does NOT serve, clamped to the query bounds ([] =
        fully spliced, no raw scan at all)."""
        runs = []
        for w in sorted(self.candidate - self.serve):
            ws = self.wstarts[w]
            we = ws + self.every
            if runs and runs[-1][1] == ws:
                runs[-1][1] = we
            else:
                runs.append([ws, we])
        return [(max(self.tmin, lo), min(self.tmax, hi))
                for lo, hi in runs if max(self.tmin, lo) < min(self.tmax, hi)]

    # -- cell fetch -----------------------------------------------------------

    def fetch(self) -> int:
        """Read the rollup rows of the served windows and finalize the
        (group, window) aggregate cells, as arrays over (rollup group,
        window): one ``ufunc.at`` per field and statistic over every row
        read, in the rows' order (the reference accumulates record by
        record, a Python loop per cell; the cells are the same). A window
        whose cells cannot answer an aggregate (a percentile over cells
        written before the spec kept sketches) falls out of the serve set
        here, before the raw scan ranges are taken, so it rejoins the
        raw tail."""
        runs = []
        for w in sorted(self.serve):
            ws = self.wstarts[w]
            if runs and runs[-1][1] == ws:
                runs[-1][1] = ws + self.every
            else:
                runs.append([ws, ws + self.every])
        fields = sorted({a[3] for a in self.aggs})
        recs = self.mgr.read_recs(self.db, self.spec, runs, fields,
                                  tag_expr=self.sc.tag_expr)
        self.rows_read = sum(len(r) for _t, r in recs)
        need_sketch = any(a[1].name == "percentile" for a in self.aggs)
        W = self.W
        serve_mask = np.zeros(W, np.bool_)
        serve_mask[sorted(self.serve)] = True
        # the rollup groups in the order the rows meet them
        gid: dict[tuple, int] = {}
        gkeys: list[tuple] = []
        flat_parts, ok_parts = [], []
        for tags, rec in recs:
            tagd = dict(tags)
            gkey = tuple(tagd.get(k, "") for k in self.group_tags)
            g = gid.get(gkey)
            if g is None:
                g = gid[gkey] = len(gkeys)
                gkeys.append(gkey)
            widx = ((rec.times - self.aligned) // self.every).astype(
                np.int64)
            inside = (widx >= 0) & (widx < W)
            ok = np.zeros(len(widx), np.bool_)
            ok[inside] = serve_mask[widx[inside]]
            flat_parts.append(g * W + np.where(inside, widx, 0))
            ok_parts.append(ok)
        G = len(gkeys)
        self.gkeys = gkeys
        # per field: [cnt, sum, mn, mx] over (G * W), None where absent,
        # and {(g, w): sketch}
        self.acc: dict[str, list] = {
            fname: self._cells(self._rows(recs, fname, flat_parts, ok_parts,
                                          need_sketch), G)
            for fname in fields}
        have = np.zeros(G * W, np.bool_)
        for acc in self.acc.values():
            have |= acc[0] > 0
        # the (group, window) cells and each aggregate's (value, count)
        self.cell = have.reshape(G, W)
        self.values: list[tuple] = []
        bad: set[int] = set()
        for _call, aspec, params, fname in self.aggs:
            self.values.append(self._finalize(aspec, params,
                                              self.acc.get(fname), G, bad))
        if bad:
            self.serve -= bad
            self.cell[:, sorted(bad)] = False
        STATS.incr("rollup", "splice_hits")
        STATS.incr("rollup", "splice_windows", len(self.serve))
        STATS.incr("rollup", "splice_raw_windows",
                   len(self.candidate - self.serve))
        return self.rows_read

    @staticmethod
    def _rows(recs, fname, flat_parts, ok_parts, need_sketch):
        """One field's served rows: their (group, window) cell index and
        count, and per statistic the cells and values it carries, in the
        rows' order."""
        idx, cvals = [], []
        stats: dict[str, list] = {rmod.S_: [], rmod.MN_: [], rmod.MX_: []}
        sk_rows = []
        for (tags, rec), flat, ok in zip(recs, flat_parts, ok_parts):
            c_col = rec.columns.get(rmod.C_ + fname)
            if c_col is None:
                continue
            m = ok & c_col.valid & (c_col.values > 0)
            if not m.any():
                continue
            idx.append(flat[m])
            cvals.append(c_col.values[m].astype(np.int64))
            for prefix in stats:
                col = rec.columns.get(prefix + fname)
                if col is None:
                    continue
                vm = m & col.valid
                if vm.any():
                    stats[prefix].append((flat[vm], col.values[vm]))
            if need_sketch:
                col = rec.columns.get(rmod.SK_ + fname)
                if col is not None:
                    for i in np.flatnonzero(m & col.valid).tolist():
                        sk_rows.append((int(flat[i]), col.values[i]))
        return idx, cvals, stats, sk_rows

    def _cells(self, rows, G):
        """[cnt, sum, mn, mx, sketches] over (G * W) of one field, the
        statistics None where no row carried them."""
        idx, cvals, stats, sk_rows = rows
        n = G * self.W
        cnt = np.zeros(n, np.int64)
        if idx:
            np.add.at(cnt, np.concatenate(idx), np.concatenate(cvals))
        out = [cnt]
        for prefix, combine in ((rmod.S_, "sum"), (rmod.MN_, "min"),
                                (rmod.MX_, "max")):
            parts = stats[prefix]
            if not parts:
                out.append(None)
                continue
            vals = np.concatenate([v for _f, v in parts])
            where = np.concatenate([f for f, _v in parts])
            if combine == "sum":
                init = 0
            elif vals.dtype.kind in "iu":
                init = (np.iinfo(np.int64).max if combine == "min"
                        else np.iinfo(np.int64).min)
            else:
                init = np.inf if combine == "min" else -np.inf
            arr = np.full(n, init, vals.dtype)
            {"sum": np.add, "min": np.minimum,
             "max": np.maximum}[combine].at(arr, where, vals)
            out.append(arr)
        held: dict[int, object] = {}
        for flat, b64 in sk_rows:
            if not b64:
                continue
            sk = RollupSketch.deserialize(base64.b64decode(b64))
            if flat in held:
                held[flat].merge(sk)
            else:
                held[flat] = sk
        out.append(held)
        return out

    def _finalize(self, aspec, params, acc, G, bad):
        """One aggregate's (values, counts) over (G, W): (0, 0) where the
        field has no cell."""
        W = self.W
        n = G * W
        if acc is None:
            return np.zeros(n, np.int64), np.zeros(n, np.int64)
        cnt, tot, mn, mx, held = acc
        has = cnt > 0
        counts = np.where(has, cnt, 0)
        name = aspec.name
        if name == "count":
            vals = counts.copy()
        elif name == "sum":
            vals = (np.where(has, tot, 0) if tot is not None
                    else np.zeros(n, np.int64))
        elif name in ("min", "max"):
            arr = mn if name == "min" else mx
            vals = (np.where(has, arr, 0) if arr is not None
                    else np.zeros(n, np.float64))
            if arr is not None and arr.dtype.kind == "f":
                vals = np.where(has, arr, 0.0)
        elif name == "mean":
            if tot is None:
                vals = np.zeros(n, np.float64)
            else:
                safe = np.where(has, cnt, 1)
                vals = np.where(has, tot.astype(np.float64) / safe, 0.0)
                if tot.dtype.kind in "iu":
                    # an int sum past 2^53 divides exactly, as Python does
                    big = np.flatnonzero(has & (np.abs(tot) >= 1 << 53))
                    for k in big.tolist():
                        vals[k] = int(tot[k]) / int(cnt[k])
        else:  # percentile
            vals = np.zeros(n, np.float64)
            qv = float(params[0]) if params else 0.0
            for k in np.flatnonzero(has & self.cell.reshape(-1)).tolist():
                sk = held.get(k)
                if sk is None:
                    bad.add(k % W)  # cells predate sketches: raw-scan it
                    counts[k] = 0
                    continue
                v = sk.percentile(qv)
                # influx: rank < 1 emits no row for the window, as the
                # executor zeroes device counts
                if v is None:
                    counts[k] = 0
                else:
                    vals[k] = v
        return vals, counts

    # -- merge into the computed arrays ---------------------------------------

    def merge(self, agg_results, aggs, group_keys):
        """Overwrite the served windows' cells into the aggregate arrays
        (extending group_keys with rollup-only groups, in the order the
        reference appends them: by first served window, then by the
        order the rows met them) — the same contract as
        resultcache.CachePlan.merge, which runs after this and persists
        the spliced windows under raw freshness signatures."""
        W = self.W
        gid_of = {k: i for i, k in enumerate(group_keys)}
        cell = self.cell  # (G_r, W), served windows only
        firsts = []
        for g, key in enumerate(self.gkeys):
            if key in gid_of:
                continue
            ws = np.flatnonzero(cell[g])
            if len(ws):
                firsts.append((int(ws[0]), g))
        for _w, g in sorted(firsts):
            gid_of[self.gkeys[g]] = len(group_keys)
            group_keys.append(self.gkeys[g])
        G = len(group_keys)
        n_seg = G * W
        gr, wr = np.nonzero(cell)
        if len(self.gkeys):
            to_global = np.array([gid_of.get(k, -1) for k in self.gkeys],
                                 np.int64)
        else:
            to_global = np.zeros(0, np.int64)
        segs = to_global[gr] * W + wr
        src = gr * W + wr
        for ai, (call, _spec, _params, _fname) in enumerate(aggs):
            out, _sel, counts, spec_, fname_, _times = agg_results[id(call)]
            out = np.asarray(out)
            new_out = np.zeros(n_seg, dtype=out.dtype)
            new_cnt = np.zeros(n_seg, dtype=np.int64)
            old_G = len(out) // W if W else 0
            if len(out):
                new_out.reshape(G, W)[:old_G] = out.reshape(old_G, W)
                new_cnt.reshape(G, W)[:old_G] = np.asarray(
                    counts).reshape(old_G, W)
            vals, cnts = self.values[ai]
            if len(segs):
                v = vals[src]
                if new_out.dtype.kind in "iu":
                    new_out[segs] = (v if v.dtype.kind in "iu"
                                     else np.trunc(v)).astype(new_out.dtype)
                else:
                    new_out[segs] = v.astype(np.float64)
                new_cnt[segs] = cnts[src]
            agg_results[id(call)] = (new_out, None, new_cnt, spec_,
                                     fname_, None)
        return group_keys
