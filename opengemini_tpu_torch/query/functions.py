"""Host-side function machinery: transforms and host-only aggregators.

The port of ``opengemini_tpu/query/functions.py``: transforms
(difference, derivative, non_negative_*, cumulative_sum,
moving_average, elapsed, holt_winters), the host aggregators (mode,
integral, median, rate, irate, absent, regr_slope and the device set's
host forms) and the multi-row calls (top, bottom, sample, distinct).
Pure numpy on the host, as in the reference: the device path
(models/templates.py) runs the hot aggregates, and any SELECT holding a
call outside that set evaluates here per (group, window) over
time-sorted rows. ``percentile_ogsketch`` runs on query/sketch.py's
centroid sketch.

Not in this port yet: ``detect`` (it needs ``services/castor``, ROADMAP
A7.2), which raises a "not supported by this port yet" error.
"""

from __future__ import annotations

import math

import numpy as np

NS = 1_000_000_000


def py_value(v):
    """numpy scalar -> python value; strings pass through. Non-finite
    floats become None: every caller feeds JSON row output, where a bare
    NaN/Infinity literal is not strict JSON (influx marshals null)."""
    out = v.item() if hasattr(v, "item") else v
    if isinstance(out, float) and not math.isfinite(out):
        return None
    return out

# transforms: f(times, values) -> (out_times, out_values); applied per
# series-group over raw points, or over the window-aggregated sequence
TRANSFORMS = {
    "derivative",
    "non_negative_derivative",
    "difference",
    "non_negative_difference",
    "cumulative_sum",
    "moving_average",
    "elapsed",
    "holt_winters",
    "holt_winters_with_fit",
}

# host aggregators: one value per (group, window)
HOST_AGGS = {"mode", "integral", "sum", "count", "mean", "min", "max",
             "first", "last", "spread", "stddev", "median", "percentile",
             "percentile_ogsketch", "count_distinct", "rate", "irate",
             "absent", "regr_slope"}

# multi-row selectors: several output rows per group
MULTI_ROW = {"top", "bottom", "sample", "distinct", "detect"}


def _dedup_duplicate_times(times: np.ndarray, values: np.ndarray):
    """Collapse runs of equal timestamps to one point (several series can
    share an instant in a merged raw sequence). The reference
    difference/derivative iterators keep the first point per distinct
    timestamp and skip the rest (agg_iterator.gen.go
    FloatDifferenceItem.AppendItemFastFunc: `if st == times[i] {continue}`);
    its merge heap breaks time ties arbitrarily (merge_transform.go
    HeapItems.Less is non-strict on equal keys), and the acceptance output
    (TestServer_difference_derivative_time_duplicate) has the smallest
    value winning — made deterministic here."""
    if len(times) < 2:
        return times, values
    change = np.empty(len(times), bool)
    change[0] = True
    np.not_equal(times[1:], times[:-1], out=change[1:])
    if change.all():
        return times, values
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(times))
    keep = np.array([s + int(np.argmin(values[s:e]))
                     for s, e in zip(starts, ends)])
    return times[keep], values[keep]


# transforms whose reference iterators skip duplicate timestamps
_DEDUP_TRANSFORMS = {
    "difference", "non_negative_difference",
    "derivative", "non_negative_derivative",
}


def transform(name: str, times: np.ndarray, values: np.ndarray, params: tuple):
    """Apply a transform over one (time-sorted) sequence; None values must
    already be removed. Returns (times, values)."""
    if len(times) == 0:
        return times, values
    if name in _DEDUP_TRANSFORMS:
        times, values = _dedup_duplicate_times(times, values)
    if name in ("derivative", "non_negative_derivative"):
        unit_ns = params[0] if params else NS
        if len(times) < 2:
            return times[:0], values[:0]
        dv = np.diff(values)
        dt = np.diff(times)
        dt = np.where(dt == 0, 1, dt)
        out = dv / (dt / unit_ns)
        t_out = times[1:]
        if name == "non_negative_derivative":
            keep = out >= 0
            return t_out[keep], out[keep]
        return t_out, out
    if name in ("difference", "non_negative_difference"):
        if len(times) < 2:
            return times[:0], values[:0]
        out = np.diff(values)  # 'behind' (default): v[i] - v[i-1]
        mode = params[0] if params and isinstance(params[0], str) else "behind"
        if mode == "front":
            out = -out
        elif mode == "absolute":
            out = np.abs(out)
        t_out = times[1:]
        if name == "non_negative_difference":
            keep = out >= 0
            return t_out[keep], out[keep]
        return t_out, out
    if name == "cumulative_sum":
        return times, np.cumsum(values)
    if name == "moving_average":
        n = int(params[0]) if params else 2
        if n < 1 or len(values) < n:
            return times[:0], values[:0]
        kernel = np.ones(n) / n
        out = np.convolve(values, kernel, mode="valid")
        return times[n - 1 :], out
    if name == "elapsed":
        unit_ns = params[0] if params else 1  # default ns
        if len(times) < 2:
            return times[:0], values[:0]
        return times[1:], (np.diff(times) // unit_ns).astype(np.int64)
    if name in ("holt_winters", "holt_winters_with_fit"):
        n_forecast = int(params[0]) if params else 1
        season = int(params[1]) if len(params) > 1 else 0
        return holt_winters(times, np.asarray(values, np.float64), n_forecast,
                            season, name.endswith("_with_fit"))
    raise ValueError(f"unsupported transform {name!r}")


def host_agg(name: str, times: np.ndarray, values: np.ndarray, params: tuple):
    """One aggregate value over one window's points; returns (value, time_ns
    | None). None value means null."""
    if len(values) == 0:
        return None, None
    if name == "count":
        return int(len(values)), None
    if name == "sum":
        return values.sum().item(), None
    if name == "mean":
        return float(values.mean()), None
    if name == "min":
        i = int(np.argmin(values))
        return py_value(values[i]), int(times[i])
    if name == "max":
        i = int(np.argmax(values))
        return py_value(values[i]), int(times[i])
    if name == "first":
        return py_value(values[0]), int(times[0])
    if name == "last":
        return py_value(values[-1]), int(times[-1])
    if name == "spread":
        return (values.max() - values.min()).item(), None
    if name == "stddev":
        if len(values) < 2:
            return None, None
        return float(values.std(ddof=1)), None
    if name == "median":
        return float(np.median(values)), None
    if name == "percentile":
        # percentile is a SELECTOR in influx: it returns an actual sample,
        # and without GROUP BY time() the row carries that sample's OWN
        # timestamp (server_test.go Selectors 'percentile'); earliest
        # point wins a value tie
        q = params[0]
        # influx nearest-rank: floor(n*q/100 + 0.5) - 1; an index below 0
        # means NO qualifying sample (nil), not the minimum
        # (FloatPercentileReduceSlice)
        rank = int(np.floor(q / 100.0 * len(values) + 0.5)) - 1
        if rank < 0 or rank >= len(values):
            return None, None
        order = np.argsort(values, kind="stable")
        i = int(order[rank])
        hits = np.flatnonzero(values == values[i])
        sel_t = int(times[hits[np.argmin(times[hits])]]) if len(hits) \
            else int(times[i])
        return py_value(values[i]), sel_t
    if name == "percentile_ogsketch":
        # centroid-sketch quantile (reference percentile_ogsketch,
        # call_processor.go:41): O(compression) memory per window however
        # many rows feed it, mergeable across nodes (query/sketch.py)
        from opengemini_tpu_torch.query.sketch import OGSketch

        q = params[0]
        sk = OGSketch()
        sk.insert(np.asarray(values, np.float64))
        out = sk.quantile(q / 100.0)
        return (None if math.isnan(out) else float(out)), None
    if name == "count_distinct":
        return int(len(np.unique(values))), None
    if name == "mode":
        # most frequent; ties -> smallest value (influx semantics)
        uniq, counts = np.unique(values, return_counts=True)
        return py_value(uniq[np.argmax(counts)]), None
    if name == "integral":
        unit_ns = params[0] if params else NS
        if len(values) < 2:
            return 0.0, None
        dt = np.diff(times) / unit_ns
        areas = (values[1:] + values[:-1]) / 2 * dt
        return float(areas.sum()), None
    if name == "rate":
        # (last - first) / elapsed-seconds (openGemini InfluxQL rate,
        # TestServer_Query_Null_Aggregate#22)
        if len(values) < 2 or times[-1] == times[0]:
            return None, None
        dt_s = (int(times[-1]) - int(times[0])) / NS
        return float((values[-1] - values[0]) / dt_s), None
    if name == "irate":
        # slope of the LAST sample pair (Null_Aggregate#23)
        if len(values) < 2 or times[-1] == times[-2]:
            return None, None
        dt_s = (int(times[-1]) - int(times[-2])) / NS
        return float((values[-1] - values[-2]) / dt_s), None
    if name == "absent":
        return 1, None  # any data in range -> 1 (Null_Aggregate#24)
    if name == "regr_slope":
        # least-squares slope against the SAMPLE ORDINAL, not wall time
        # (verified against Null_Aggregate#32: gaps in the time axis do
        # not stretch the x spacing)
        if len(values) < 2:
            return None, None
        x = np.arange(len(values), dtype=np.float64)
        v = values.astype(np.float64)
        xc = x - x.mean()
        return float((xc * (v - v.mean())).sum() / (xc * xc).sum()), None
    raise ValueError(f"unsupported host aggregate {name!r}")


def holt_winters(times: np.ndarray, values: np.ndarray, n_forecast: int,
                 season: int, with_fit: bool):
    """Influx holt_winters(agg, N, S): triple (or double, S=0) exponential
    smoothing fitted by SSE grid search, forecasting N points at the
    sequence's stride (reference: engine/executor holt_winters transform).
    Returns (times, values) — fitted values + forecasts when with_fit,
    else the N forecasts only."""
    n = len(values)
    if n < max(2, 2 * max(season, 1)):
        return times[:0], values[:0]
    stride = int(np.median(np.diff(times))) if n > 1 else NS

    def sse_and_fit(alpha, beta, gamma):
        alpha = float(np.clip(alpha, 1e-3, 1 - 1e-3))
        beta = float(np.clip(beta, 1e-3, 1 - 1e-3))
        gamma = float(np.clip(gamma, 1e-3, 1 - 1e-3))
        level = values[0]
        trend = values[1] - values[0]
        seas = (
            values[:season] - values[:season].mean() if season else None
        )
        fit = np.empty(n)
        for i in range(n):
            s_i = seas[i % season] if season else 0.0
            fit[i] = level + trend + s_i
            err_base = values[i] - s_i
            new_level = alpha * err_base + (1 - alpha) * (level + trend)
            trend = beta * (new_level - level) + (1 - beta) * trend
            if season:
                seas[i % season] = gamma * (values[i] - new_level) + (1 - gamma) * s_i
            level = new_level
        resid = fit - values
        return float(resid @ resid), fit, level, trend, seas

    # Nelder-Mead like the reference (scipy when present: ~100 SSE evals
    # instead of a 1000-point grid); coarse grid fallback otherwise
    best = None
    try:
        from scipy.optimize import minimize

        x0 = [0.5, 0.1, 0.1] if season else [0.5, 0.1]

        def objective(x):
            a, b = x[0], x[1]
            g = x[2] if season else 0.0
            return sse_and_fit(a, b, g)[0]

        res = minimize(objective, x0, method="Nelder-Mead",
                       options={"maxfev": 200, "xatol": 1e-3, "fatol": 1e-6})
        a, b = res.x[0], res.x[1]
        g = res.x[2] if season else 0.0
        best = sse_and_fit(a, b, g)
    except ImportError:  # pragma: no cover
        grid = np.linspace(0.1, 0.9, 5)
        gammas = grid if season else [0.0]
        for a in grid:
            for b in grid:
                for g in gammas:
                    cand = sse_and_fit(a, b, g)
                    if best is None or cand[0] < best[0]:
                        best = cand
    _, fit, level, trend, seas = best
    f_times = times[-1] + stride * np.arange(1, n_forecast + 1)
    f_vals = np.array([
        level + (k + 1) * trend + (seas[(n + k) % season] if season else 0.0)
        for k in range(n_forecast)
    ])
    if with_fit:
        return (
            np.concatenate([times, f_times]),
            np.concatenate([fit, f_vals]),
        )
    return f_times, f_vals


def select_top_bottom_idx(name: str, times: np.ndarray, values: np.ndarray,
                          params: tuple) -> np.ndarray:
    """Row indices selected by top()/bottom(): extreme value first, value
    ties take the OLDEST timestamp (influx rule), output ordered by time.
    Exposed separately so companion-column projections can fetch other
    fields of the selected rows (reference TestServer_Query_For_BugList#2:
    `SELECT TOP(f, 2), *`)."""
    n = int(params[0]) if params else 1
    n = min(n, len(values))
    order = (np.lexsort((times, -values)) if name == "top"
             else np.lexsort((times, values)))
    idx = order[:n]
    return idx[np.argsort(times[idx], kind="stable")]


def multi_row(name: str, times: np.ndarray, values: np.ndarray, params: tuple,
              rng: np.random.Generator | None = None, models=None):
    """top/bottom/sample/distinct: list of (time_ns, value) output rows."""
    if len(values) == 0:
        return []
    if name in ("top", "bottom"):
        idx = select_top_bottom_idx(name, times, values, params)
        return [(int(times[i]), values[i].item()) for i in idx]
    if name == "sample":
        n = int(params[0]) if params else 1
        n = min(n, len(values))
        rng = rng or np.random.default_rng()
        idx = np.sort(rng.choice(len(values), size=n, replace=False))
        return [(int(times[i]), values[i].item()) for i in idx]
    if name == "distinct":
        # influx returns distinct values in FIRST-APPEARANCE order, with
        # the window time (server_test.go AggregateSelectors 'distinct')
        uniq, idx = np.unique(values, return_index=True)
        order = np.argsort(idx)
        return [(None, py_value(uniq[i])) for i in order]
    if name == "detect":
        raise ValueError("detect() is not supported by this port yet "
                         "(services/castor, ROADMAP A7.2)")
    raise ValueError(f"unsupported multi-row call {name!r}")
