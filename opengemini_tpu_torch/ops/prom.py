"""PromQL range-vector functions: tiled interval reductions + dense kernels.

The port of ``opengemini_tpu/ops/prom.py``, with the mesh-sharded tiled
kernels (``ShardedTiled``: the series axis split over a device mesh's
shards) and the rule engine's tile partials (bottom of the module: host numpy
float64, as the reference keeps them). Reference: the
store-side prom cursors + reducers (engine/prom_range_vector_cursor.go,
prom_function_reducers.go:633) which walk samples per series per step.

Two generations live here:

  * The TILED engine (TilePlan / TiledPrepared, bottom of the module —
    the production path): time-interval-centric batch operators in the
    TiLT style (arXiv:2301.12030). Window edges define a ms tile
    lattice, samples bucket by integer arithmetic, and every
    (series, step) window answers from cumulative tile prefixes plus two
    boundary refinements — O(1) per window, no searchsorted, no dense
    membership tensors. The host prepares the time structure in numpy;
    the kernel methods run one code path over an array namespace: HOST
    (numpy, the host route) or TorchXP (torch on a device, the device
    route).

  * The DENSE kernels (top of the module): torch functions over padded
    (num_series, max_samples) tensors on one device, row-wise
    searchsorted window bounds, chunked (S, chunk, N) membership tensors
    for the non-prefix-able forms. They serve the window grids the tile
    lattice cannot express (sub-ms edges, over-budget tile counts),
    quantile/mad/holt_winters and the instant selector.

Semantics follow Prometheus exactly (promql/functions.go extrapolatedRate):
  - counter resets: correction[i] = v[i-1] if v[i] < v[i-1], restricted
    to sample pairs fully inside the window
  - extrapolation to window bounds, limited to 1.1x average sample
    interval, and clamped to zero-crossing for counters.

All timestamps here are int64 milliseconds (prom's unit) on the HOST;
kernels see float seconds relative to a base — callers produce them via
`prepare_matrix_runs` (dense) or `prepare_tiled`. Every gather index is
clamped into its row before it reaches torch (an out-of-range index on
the card is a device-side assert, not an error).
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def torch_dtype(dt) -> torch.dtype:
    """A numpy dtype (or a torch dtype) as the torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return _NP_TO_TORCH[np.dtype(dt)]


def prepare_matrix_runs(t_ms_all, v_all, lens, dtype=np.float32):
    """Padded (S, N) matrices from run-encoded input: one concatenated
    (times_ms, values) pair with per-series lengths, filled by ONE flat
    scatter. Returns (times_s f64 relative to base_ms, +inf padded;
    values; counts int32; base_ms)."""
    lens = np.asarray(lens, np.int64)
    S = len(lens)
    n_max = max(1, int(lens.max()) if S else 1)
    times = np.full((S, n_max), np.inf, dtype=np.float64)
    # v_all None = still-encoded values (TiledPrepared enc mode): only
    # the time/count structure is prepared; the value matrix fills
    # lazily (host route) or decodes on the device (ops/device_decode)
    values = None if v_all is None else np.zeros((S, n_max), dtype=dtype)
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    base_ms = 0
    if total:
        # times are ascending per series, so the global min is the min of
        # each non-empty series' first sample
        base_ms = int(t_ms_all[starts[lens > 0]].min())
        rows = np.repeat(np.arange(S, dtype=np.int64), lens)
        cols = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        flat = rows * n_max + cols
        times.reshape(-1)[flat] = (np.asarray(t_ms_all) - base_ms) / 1000.0
        if values is not None:
            values.reshape(-1)[flat] = v_all
    return times, values, lens.astype(np.int32), base_ms


def to_device(times, values, counts, device):
    """The dense kernels' inputs as tensors on `device`: (S, N) f64 times
    and values, (S,) int32 counts."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return put(times), put(values), put(counts)


# ---------------------------------------------------------------------------
# Dense kernels: torch on the tensors' device.
# ---------------------------------------------------------------------------


def _steps(x, like: torch.Tensor) -> torch.Tensor:
    """Step edges (K,) as a float64 tensor on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype,
                           device=like.device)


def window_bounds(times, counts, step_starts, step_ends):
    """Per (series, step) first/last sample indices inside (start, end].

    times: (S, N) seconds; step_starts/step_ends: (K,) seconds.
    Returns (first_idx, last_idx, has_samples) each (S, K).
    Prom windows are left-OPEN right-CLOSED: (t-w, t].
    """
    first_idx = _searchsorted_rows(times, _steps(step_starts, times),
                                   "right")
    last_idx = _searchsorted_rows(times, _steps(step_ends, times),
                                  "right") - 1
    has = (last_idx >= first_idx) & (first_idx < counts[:, None])
    return first_idx, last_idx, has


def _searchsorted_rows(times, keys, side):
    """Row-wise searchsorted of the (K,) keys in every +inf-padded
    sorted row of `times`: (S, K) int64."""
    s_dim = times.shape[0]
    return torch.searchsorted(
        times.contiguous(), keys[None, :].expand(s_dim, -1).contiguous(),
        right=(side == "right"))


def _gather_rows(mat, idx):
    return torch.gather(mat, 1, idx.clamp(0, mat.shape[1] - 1))


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def reset_corrections(values, counts):
    """Per-series prefix sum of counter-reset corrections:
    C[i] = sum_{j<=i} (v[j-1] if v[j] < v[j-1] else 0). (S, N)."""
    prev = torch.cat([values[:, :1], values[:, :-1]], dim=1)
    drop = torch.where(values < prev, prev, 0.0)
    drop[:, 0] = 0
    n = values.shape[1]
    valid = _arange(n, values)[None, :] < counts[:, None]
    return torch.cumsum(torch.where(valid, drop, 0.0), dim=1)


def extrapolated_rate(
    times, values, counts, step_starts, step_ends,
    window_s: float, is_counter: bool, is_rate: bool,
):
    """Prometheus extrapolatedRate for every (series, step).

    Returns (out (S, K), valid (S, K)); valid requires >= 2 samples in the
    window (prom semantics).
    """
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    safe_first = first_idx.clamp(0, times.shape[1] - 1)
    safe_last = last_idx.clamp(0, times.shape[1] - 1)
    t_first = _gather_rows(times, safe_first)
    t_last = _gather_rows(times, safe_last)
    v_first = _gather_rows(values, safe_first)
    v_last = _gather_rows(values, safe_last)
    n_samples = last_idx - first_idx + 1
    valid = has & (n_samples >= 2)

    delta = v_last - v_first
    if is_counter:
        cum = reset_corrections(values, counts)
        c_first = _gather_rows(cum, safe_first)
        c_last = _gather_rows(cum, safe_last)
        delta = delta + (c_last - c_first)

    # prom extrapolation (promql/functions.go extrapolatedRate)
    sampled_interval = t_last - t_first
    sampled_interval = torch.where(sampled_interval <= 0, 1.0,
                                   sampled_interval)
    avg_interval = sampled_interval / (n_samples - 1).clamp_min(1).to(
        times.dtype)
    dur_to_start = t_first - step_starts[None, :]
    dur_to_end = step_ends[None, :] - t_last
    extrap_threshold = avg_interval * 1.1
    dur_to_start = torch.where(dur_to_start > extrap_threshold,
                               avg_interval / 2, dur_to_start)
    dur_to_end = torch.where(dur_to_end > extrap_threshold,
                             avg_interval / 2, dur_to_end)
    if is_counter:
        # a counter cannot extrapolate below zero (prom applies this only
        # for delta > 0 AND v_first >= 0, promql/functions.go)
        dur_zero = torch.where(
            (delta > 0) & (v_first >= 0),
            sampled_interval * (v_first / _maximum(delta, 1e-30)),
            float("inf"),
        )
        dur_to_start = torch.minimum(dur_to_start, dur_zero)
    extrapolated = sampled_interval + dur_to_start + dur_to_end
    out = delta.to(times.dtype) * (extrapolated / sampled_interval)
    if is_rate:
        out = out / window_s
    return out, valid


def _maximum(a: torch.Tensor, b) -> torch.Tensor:
    """np.maximum with a scalar operand (NaN propagates, as there)."""
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                            device=a.device))


def over_time(times, values, counts, step_starts, step_ends, func: str):
    """xxx_over_time functions: avg/min/max/sum/count/last. (S, K).

    sum/avg/count/last use the O(S*K) prefix-sum+gather scheme (no dense
    (S, K, N) tensor). min/max have no prefix form; they use a dense
    window-membership tensor computed in step CHUNKS so peak memory stays
    bounded at S * 256 * N booleans.
    """
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    n = times.shape[1]
    dt = values.dtype
    if func in ("sum", "avg", "count", "last"):
        if func == "last":
            safe_last = last_idx.clamp(0, n - 1)
            return _gather_rows(values, safe_last), has
        valid_cols = _arange(n, values)[None, :] < counts[:, None]
        csum = torch.cumsum(torch.where(valid_cols, values, 0.0), dim=1)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
        safe_f = first_idx.clamp(0, n)
        safe_l1 = (last_idx + 1).clamp(0, n)
        wsum = _gather_rows(csum, safe_l1) - _gather_rows(csum, safe_f)
        wcnt = (last_idx - first_idx + 1).to(dt)
        wcnt = torch.where(has, wcnt, 0.0)
        if func == "count":
            return wcnt, has
        if func == "sum":
            return torch.where(has, wsum, 0.0), has
        return torch.where(has, wsum, 0.0) / _maximum(wcnt, 1), has
    if func in ("stddev", "stdvar"):
        # population variance over window samples (prom
        # funcStddevOverTime) via prefix sums, centered on the per-series
        # mean first: raw v^2 prefix sums over large-magnitude samples
        # cancel catastrophically in the window difference
        valid_cols = _arange(n, values)[None, :] < counts[:, None]
        vz_raw = torch.where(valid_cols, values, 0.0)
        series_n = counts.clamp_min(1).to(dt)[:, None]
        center = vz_raw.sum(dim=1, keepdim=True) / series_n
        vz = torch.where(valid_cols, values - center, 0.0)
        c1 = torch.cumsum(vz, dim=1)
        c2 = torch.cumsum(vz * vz, dim=1)
        zcol = torch.zeros_like(c1[:, :1])
        c1 = torch.cat([zcol, c1], dim=1)
        c2 = torch.cat([zcol, c2], dim=1)
        safe_f = first_idx.clamp(0, n)
        safe_l1 = (last_idx + 1).clamp(0, n)
        ws = _gather_rows(c1, safe_l1) - _gather_rows(c1, safe_f)
        wss = _gather_rows(c2, safe_l1) - _gather_rows(c2, safe_f)
        wcnt = torch.where(has, last_idx - first_idx + 1, 0).to(dt)
        denom = _maximum(wcnt, 1)
        mean = ws / denom
        var = _maximum(wss / denom - mean * mean, 0)
        out = var if func == "stdvar" else torch.sqrt(var)
        return torch.where(has, out, 0.0), has
    if func == "present":
        return torch.where(has, 1.0, 0.0).to(dt), has
    if func in ("min", "max"):
        k = step_starts.shape[0]
        chunk = 256
        outs = []
        fill = float("inf") if func == "min" else float("-inf")
        for c0 in range(0, k, chunk):
            in_win, v = _window_tensor(times, values, counts, first_idx,
                                       last_idx, c0, chunk)
            masked = torch.where(in_win, v, fill)
            outs.append(torch.amin(masked, dim=2) if func == "min"
                        else torch.amax(masked, dim=2))
        return torch.cat(outs, dim=1), has
    raise ValueError(f"unsupported over_time func {func!r}")


def _window_tensor(times, values, counts, first_idx, last_idx, c0, chunk):
    """Masked (S, C, N) membership view for one step chunk: (in_win, v)."""
    n = values.shape[1]
    fi = first_idx[:, c0:c0 + chunk, None]
    li = last_idx[:, c0:c0 + chunk, None]
    col = _arange(n, values)[None, None, :]
    in_win = (col >= fi) & (col <= li) & (col < counts[:, None, None])
    return in_win, values[:, None, :]


def _nanquantile(a: torch.Tensor, q: float, keepdim: bool = False):
    """Linear-interpolated quantile over the last axis with NaN cells
    left out (all-NaN rows give NaN): the squash-NaN sort, clamped
    ranks and weights of the JAX package's ``jnp.nanquantile``, in the
    same order of operations."""
    a = torch.sort(a, dim=-1).values  # NaN sorts last
    counts = (~torch.isnan(a)).sum(dim=-1, keepdim=True).to(a.dtype)
    qq = q * (counts - 1)
    low = torch.floor(qq)
    high = torch.ceil(qq)
    high_weight = qq - low
    low_weight = 1 - high_weight
    low = torch.clamp_min(torch.minimum(low, counts - 1), 0)
    high = torch.clamp_min(torch.minimum(high, counts - 1), 0)
    low_value = torch.gather(a, -1, low.to(torch.int64))
    high_value = torch.gather(a, -1, high.to(torch.int64))
    out = low_value * low_weight + high_value * high_weight
    return out if keepdim else out.squeeze(-1)


def quantile_over_time(times, values, counts, step_starts, step_ends,
                       q: float):
    """phi-quantile with linear interpolation over window samples (prom
    funcQuantileOverTime). Dense chunked like min/max; NaN-padded windows
    keep the masked samples out."""
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    k = step_starts.shape[0]
    chunk = 256
    outs = []
    qc = min(max(float(q), 0.0), 1.0)
    for c0 in range(0, k, chunk):
        in_win, v = _window_tensor(times, values, counts, first_idx,
                                   last_idx, c0, chunk)
        vw = torch.where(in_win, v, float("nan"))
        outs.append(_nanquantile(vw, qc))
    out = torch.cat(outs, dim=1)
    if q < 0:
        out = torch.full_like(out, float("-inf"))
    elif q > 1:
        out = torch.full_like(out, float("inf"))
    return out, has


def mad_over_time(times, values, counts, step_starts, step_ends):
    """median(|v - median(v)|) over window samples (prom mad_over_time)."""
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    k = step_starts.shape[0]
    chunk = 128  # two dense passes live at once
    outs = []
    for c0 in range(0, k, chunk):
        in_win, v = _window_tensor(times, values, counts, first_idx,
                                   last_idx, c0, chunk)
        vw = torch.where(in_win, v, float("nan"))
        med = _nanquantile(vw, 0.5, keepdim=True)
        outs.append(_nanquantile(torch.abs(vw - med), 0.5))
    return torch.cat(outs, dim=1), has


def linear_regression(times, values, counts, step_starts, step_ends):
    """Per-(series, step) least-squares over window samples, centered at
    the window END (the prom eval time): returns (slope per second,
    intercept at eval time, has_2plus). deriv() is the slope;
    predict_linear(v, d) = intercept + slope * d
    (prom promql/functions.go linearRegression)."""
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    k = step_starts.shape[0]
    chunk = 128
    slopes, intercepts = [], []
    for c0 in range(0, k, chunk):
        in_win, v = _window_tensor(times, values, counts, first_idx,
                                   last_idx, c0, chunk)
        t_rel = times[:, None, :] - step_ends[None, c0:c0 + chunk, None]
        tw = torch.where(in_win, t_rel, 0.0)
        vw = torch.where(in_win, v, 0.0)
        cnt = in_win.sum(dim=2).to(values.dtype)
        denom_n = _maximum(cnt, 1)
        st = tw.sum(dim=2)
        sv = vw.sum(dim=2)
        stt = (tw * tw).sum(dim=2)
        stv = (tw * vw).sum(dim=2)
        cov = stv - st * sv / denom_n
        var = stt - st * st / denom_n
        slope = cov / torch.where(var == 0, 1.0, var)
        slope = torch.where(var == 0, 0.0, slope)
        intercept = sv / denom_n - slope * (st / denom_n)
        slopes.append(slope)
        intercepts.append(intercept)
    first_t = _gather_rows(times, first_idx.clamp(0, times.shape[1] - 1))
    last_t = _gather_rows(times, last_idx.clamp(0, times.shape[1] - 1))
    has2 = has & (last_t > first_t)
    return (torch.cat(slopes, dim=1), torch.cat(intercepts, dim=1), has2)


def holt_winters_window(times, values, counts, step_starts, step_ends,
                        sf: float, tf: float):
    """Prom double exponential smoothing per window
    (funcHoltWinters/double_exponential_smoothing): sequential over the
    window's samples — a loop over the sample axis carrying
    (level, trend) per (series, step), masked to each window's members,
    with the reference scan's order of operations. Windows with <2
    samples yield no result."""
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    n = values.shape[1]
    k = step_starts.shape[0]
    chunk = 128
    outs, valids = [], []
    for c0 in range(0, k, chunk):
        in_win, _v = _window_tensor(times, values, counts, first_idx,
                                    last_idx, c0, chunk)
        shape = in_win[:, :, 0].shape  # (S, C)
        # prom recurrence (funcDoubleExponentialSmoothing): sample 0
        # seeds the level; sample 1 seeds the trend then smooths with
        # it; sample j>=2 first updates the trend from the two PREVIOUS
        # levels, then smooths. Result = final level.
        z = torch.zeros(shape, dtype=values.dtype, device=values.device)
        s_prev, s_curr, b = z, z, z
        seen = torch.zeros(shape, dtype=torch.int32, device=values.device)
        for i in range(n):
            x = values[:, i][:, None].expand(shape)
            m = in_win[:, :, i]
            is_first = m & (seen == 0)
            is_second = m & (seen == 1)
            later = m & (seen >= 2)
            b_new = torch.where(later, tf * (s_curr - s_prev)
                                + (1 - tf) * b, b)
            b_new = torch.where(is_second, x - s_curr, b_new)
            smooth = sf * x + (1 - sf) * (s_curr + b_new)
            upd = is_second | later
            new_s_prev = torch.where(upd, s_curr, s_prev)
            new_s_curr = torch.where(upd, smooth,
                                     torch.where(is_first, x, s_curr))
            s_prev, s_curr, b = new_s_prev, new_s_curr, b_new
            seen = seen + m.to(torch.int32)
        outs.append(s_curr)
        valids.append(seen >= 2)
    return (torch.cat(outs, dim=1), has & torch.cat(valids, dim=1))


def changes_resets(times, values, counts, step_starts, step_ends,
                   kind: str):
    """changes()/resets() per (series, step): transitions between
    consecutive in-window samples, via prefix sums of per-pair indicators
    (prom promql/functions.go funcChanges/funcResets)."""
    step_starts = _steps(step_starts, times)
    step_ends = _steps(step_ends, times)
    first_idx, last_idx, has = window_bounds(times, counts, step_starts,
                                             step_ends)
    n = values.shape[1]
    prev = torch.cat([values[:, :1], values[:, :-1]], dim=1)
    if kind == "changes":
        ind = (values != prev).to(values.dtype)
    else:  # resets
        ind = (values < prev).to(values.dtype)
    ind[:, 0] = 0
    valid_cols = _arange(n, values)[None, :] < counts[:, None]
    cum = torch.cumsum(torch.where(valid_cols, ind, 0.0), dim=1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)  # (S, N+1)
    safe_f = (first_idx + 1).clamp(0, n)  # pairs with i in (first, last]
    safe_l1 = (last_idx + 1).clamp(0, n)
    out = _gather_rows(cum, safe_l1) - _gather_rows(cum, safe_f)
    valid = has & (last_idx >= first_idx)
    return torch.where(valid, out, 0.0), valid


def instant_rate(times, values, counts, starts, ends, per_second: bool):
    """irate/idelta from the last two samples in each (series, step)
    window (prom funcIrate/funcIdelta). Dense fallback form (searchsorted
    bounds); the tiled form lives on TiledPrepared.instant_rate."""
    first_idx, last_idx, has = window_bounds(times, counts, starts, ends)
    n = times.shape[1]
    prev_idx = (last_idx - 1).clamp(0, n - 1)
    safe_last = last_idx.clamp(0, n - 1)
    valid = has & (last_idx - first_idx >= 1)
    v_last = _gather_rows(values, safe_last)
    v_prev = _gather_rows(values, prev_idx)
    t_last = _gather_rows(times, safe_last)
    t_prev = _gather_rows(times, prev_idx)
    dv = v_last - v_prev
    if per_second:
        dv = torch.where(dv < 0, v_last, dv)  # counter reset
        dt = _maximum(t_last - t_prev, 1e-9)
        return dv / dt, valid
    return dv, valid


def instant_values(times, values, counts, eval_times,
                   lookback_s: float = 300.0):
    """Instant vector selection: latest sample within [t - lookback, t].
    Returns (vals (S, K), valid (S, K)) — prom staleness semantics (without
    explicit staleness markers, which the influx data model doesn't carry).
    """
    eval_times = _steps(eval_times, times)
    idx = _searchsorted_rows(times, eval_times, "right") - 1
    safe = idx.clamp(0, times.shape[1] - 1)
    t_at = _gather_rows(times, safe)
    v_at = _gather_rows(values, safe)
    valid = (idx >= 0) & (t_at >= eval_times[None, :] - lookback_s) & (
        idx < counts[:, None]
    )
    return v_at, valid


# ---------------------------------------------------------------------------
# Array namespaces of the tiled kernels: HOST is numpy (the host route,
# the JAX package's numpy code path as it is), TorchXP runs the same calls
# on a torch device (the device route). The kernel methods below are
# written once against these.
# ---------------------------------------------------------------------------


class _HostXP:
    """numpy, the host route."""

    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    sqrt = staticmethod(np.sqrt)
    arange = staticmethod(np.arange)
    clip = staticmethod(np.clip)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return np.take_along_axis(a, idx, axis=axis)

    @staticmethod
    def flat_take(mat, idx):
        return mat.reshape(-1)[idx]

    @staticmethod
    def zeros(shape, dtype):
        return np.zeros(shape, dtype=dtype)

    @staticmethod
    def full(shape, fill, dtype):
        return np.full(shape, fill, dtype=dtype)

    @staticmethod
    def scalar(v, dtype):
        return np.asarray(v, dtype=dtype)

    @staticmethod
    def cumsum(x, axis):
        return np.cumsum(x, axis=axis)

    @staticmethod
    def concatenate(xs, axis):
        return np.concatenate(xs, axis=axis)

    @staticmethod
    def sum(x, axis, keepdims=False):
        return x.sum(axis=axis, keepdims=keepdims)

    @staticmethod
    def amin(x, axis):
        return x.min(axis=axis)

    @staticmethod
    def amax(x, axis):
        return x.max(axis=axis)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)

    @staticmethod
    def cum_extreme(x, axis, want_min, reverse):
        op = np.minimum if want_min else np.maximum
        if reverse:
            x = np.flip(x, axis=axis)
        out = op.accumulate(x, axis=axis)
        return np.flip(out, axis=axis) if reverse else out

    @staticmethod
    def extreme_fill(dtype, want_min):
        ndt = np.dtype(dtype)
        if np.issubdtype(ndt, np.floating):
            return ndt.type(np.inf if want_min else -np.inf)
        info = np.iinfo(ndt)
        return ndt.type(info.max if want_min else info.min)


HOST = _HostXP()


class TorchXP:
    """The same calls as HOST, in torch on `device` (the device route).
    Gathers clamp their indices into range: on the card an out-of-range
    index is a device-side assert."""

    def __init__(self, device):
        self.device = torch.device(device)

    where = staticmethod(torch.where)

    def maximum(self, a, b):
        return _maximum(a, b) if not isinstance(b, torch.Tensor) \
            else torch.maximum(a, b)

    def minimum(self, a, b):
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return torch.minimum(a, b)

    sqrt = staticmethod(torch.sqrt)

    def arange(self, n):
        return torch.arange(n, device=self.device)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def take_along_axis(a, idx, axis):
        # numpy broadcasts a (1, K) index over the rows; gather does not
        shape = [idx.shape[d] if d == axis else a.shape[d]
                 for d in range(a.dim())]
        idx = idx.to(torch.int64).clamp(0, a.shape[axis] - 1).expand(shape)
        return torch.gather(a, axis, idx)

    @staticmethod
    def flat_take(mat, idx):
        return mat.reshape(-1)[idx]

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=torch_dtype(dtype),
                           device=self.device)

    def full(self, shape, fill, dtype):
        return torch.full(shape, float(fill), dtype=torch_dtype(dtype),
                          device=self.device)

    def scalar(self, v, dtype):
        return torch.tensor(v, dtype=torch_dtype(dtype), device=self.device)

    @staticmethod
    def cumsum(x, axis):
        return torch.cumsum(x, dim=axis)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def sum(x, axis, keepdims=False):
        return x.sum(dim=axis, keepdim=keepdims)

    @staticmethod
    def amin(x, axis):
        return torch.amin(x, dim=axis)

    @staticmethod
    def amax(x, axis):
        return torch.amax(x, dim=axis)

    @staticmethod
    def astype(x, dtype):
        return x.to(torch_dtype(dtype))

    @staticmethod
    def cum_extreme(x, axis, want_min, reverse):
        fn = torch.cummin if want_min else torch.cummax
        if reverse:
            x = torch.flip(x, dims=(axis,))
        out = fn(x, dim=axis).values
        return torch.flip(out, dims=(axis,)) if reverse else out

    @staticmethod
    def extreme_fill(dtype, want_min):
        dt = torch_dtype(dtype)
        if dt.is_floating_point:
            return float("inf") if want_min else float("-inf")
        info = torch.iinfo(dt)
        return info.max if want_min else info.min


def namespace(xp, device=None):
    """The array namespace of a route: ``numpy`` is the host route,
    ``torch`` the device route on `device`."""
    if xp is np:
        return HOST
    if xp is torch:
        if device is None:
            raise ValueError("the device route needs a device")
        return TorchXP(device)
    raise TypeError(f"unknown array namespace {xp!r}")


# ---------------------------------------------------------------------------
# Time-centric tiled range-vector engine (TiLT, arXiv:2301.12030).
#
#   1. All window edges of one range query live on a millisecond lattice;
#      g = gcd of the edge spacings defines a fixed grid of
#      left-open/right-closed time tiles (t0 + i*g, t0 + (i+1)*g], so every
#      window (s, e] is an EXACT union of w/g consecutive tiles.
#   2. Samples bucket onto tiles by integer arithmetic on their ms
#      timestamps ((t - t0 - 1) // g — no searchsorted anywhere), giving
#      per-(series, tile) sample-count prefixes; the first/last sample
#      index of ANY window is a prefix lookup at its edge tiles.
#   3. Per-(series, tile) partials (sum, sum-of-squares, min, max,
#      counter-reset drops, change/reset pair indicators) are masked
#      reductions over a compact gather of ONLY the tiles any window
#      covers.
#   4. Every window then answers from cumulative tile prefixes
#      (ops/segment.py tile_window_sums / tile_sliding_extreme) plus two
#      boundary refinements: the pair quantities subtract the one pair
#      that straddles the window start, and first/last values gather at
#      the prefix-resolved sample indices.
# ---------------------------------------------------------------------------

_MS_PER_S = 1000


class TilePlan:
    """Time-tile grid for one range query: all window edges on the
    anchor + i*g_ms lattice. Built host-side by plan_tiles (None when the
    query is ineligible and must take the dense fallback path)."""

    __slots__ = ("g_ms", "anchor_ms", "num_tiles", "a_idx", "b_idx",
                 "win_tiles", "cov", "tile2c", "ca", "cb", "window_s")

    def __init__(self, g_ms, anchor_ms, num_tiles, a_idx, b_idx, win_tiles,
                 cov, tile2c, ca, cb, window_s):
        self.g_ms = g_ms
        self.anchor_ms = anchor_ms
        self.num_tiles = num_tiles
        self.a_idx = a_idx      # (K,) start-edge tile index per window
        self.b_idx = b_idx      # (K,) end-edge tile index per window
        self.win_tiles = win_tiles  # tiles per window (w == win_tiles * g)
        self.cov = cov          # sorted covered tile ids, (C,)
        self.tile2c = tile2c    # tile id -> compact position (or -1)
        self.ca = ca            # (K,) compact start position per window
        self.cb = cb            # (K,) compact end position (exclusive)
        self.window_s = window_s


def plan_tiles(starts_s, ends_s, tmin_ms: int, tmax_ms: int,
               max_tiles: int) -> "TilePlan | None":
    """Tile grid for windows (starts_s[k], ends_s[k]] (seconds, shared
    width). Returns None when ineligible: edges off the ms lattice,
    non-constant width, or a grid larger than max_tiles (the dense path
    stays correct for those)."""
    starts_s = np.asarray(starts_s, np.float64)
    ends_s = np.asarray(ends_s, np.float64)
    if starts_s.size == 0 or not (
            np.isfinite(starts_s).all() and np.isfinite(ends_s).all()):
        return None
    s_ms = np.rint(starts_s * _MS_PER_S)
    e_ms = np.rint(ends_s * _MS_PER_S)
    # edges must be exactly on the ms lattice (sub-ms windows keep the
    # float-comparison fallback: quantizing them would MOVE a boundary)
    if (np.abs(s_ms - starts_s * _MS_PER_S).max() > 1e-6
            or np.abs(e_ms - ends_s * _MS_PER_S).max() > 1e-6):
        return None
    s_ms = s_ms.astype(np.int64)
    e_ms = e_ms.astype(np.int64)
    w_ms = e_ms - s_ms
    if (w_ms != w_ms[0]).any() or w_ms[0] <= 0:
        return None
    edges = np.unique(np.concatenate([s_ms, e_ms]))
    g_ms = (int(np.gcd.reduce(np.diff(edges))) if len(edges) > 1
            else int(w_ms[0]))
    anchor_ms = int(edges[0])
    if tmin_ms <= anchor_ms:
        # every sample must land at tile index >= 0: pull the anchor back
        # onto the lattice point strictly below the earliest sample
        anchor_ms -= ((anchor_ms - tmin_ms) // g_ms + 1) * g_ms
    a_idx = ((s_ms - anchor_ms) // g_ms).astype(np.int64)
    b_idx = ((e_ms - anchor_ms) // g_ms).astype(np.int64)
    num_tiles = int(max(int(b_idx.max()),
                        (max(tmax_ms, anchor_ms + 1) - anchor_ms - 1)
                        // g_ms + 1)) + 1
    if num_tiles > max_tiles:
        return None
    win_tiles = int(w_ms[0]) // g_ms
    # covered-tile union by interval marking — O(num_tiles), never
    # materializing per-window tile lists
    mark = np.zeros(num_tiles + 1, np.int64)
    np.add.at(mark, a_idx, 1)
    np.add.at(mark, b_idx, -1)
    cov = np.flatnonzero(np.cumsum(mark[:-1]) > 0)
    tile2c = np.full(num_tiles + 1, -1, np.int64)
    tile2c[cov] = np.arange(len(cov))
    ca = tile2c[a_idx]
    cb = tile2c[b_idx - 1] + 1
    return TilePlan(g_ms, anchor_ms, num_tiles, a_idx, b_idx, win_tiles,
                    cov, tile2c, ca.astype(np.int32), cb.astype(np.int32),
                    float(w_ms[0]) / _MS_PER_S)


# the prepared arrays the kernel methods read; the device route uploads
# each on its first use (one copy per prepared query)
_KERNEL_ARRAYS = frozenset((
    "times", "counts", "safe_f", "safe_l", "safe_fm1", "safe_lm1", "fmask",
    "has1", "has2", "n_samp", "t_first", "t_last", "t_lm1", "starts_rel",
    "ends_rel", "ownmask", "pairmask", "gidx", "ca2", "cb2"))


class _DeviceArrays:
    """The prepared arrays on a device, uploaded on first use (site
    ``prom-tiles`` of devobs.note_transfer)."""

    def __init__(self, prep: "TiledPrepared", device):
        self._prep = prep
        self._device = device

    def __getattr__(self, name: str):
        if name not in _KERNEL_ARRAYS:
            raise AttributeError(name)
        from opengemini_tpu_torch.utils import devobs

        host = np.ascontiguousarray(getattr(self._prep, name))
        dev = torch.from_numpy(host).to(self._device)
        devobs.note_transfer("h2d", "prom-tiles", int(host.nbytes))
        setattr(self, name, dev)
        return dev


class TiledPrepared:
    """Prepared tiled state for one (series set, window grid) pair.

    Built once per query on the host from run-encoded samples (integer ms
    timestamps); every kernel method then answers all (series, step)
    windows in O(1) per window. A kernel method's `xp` selects the route:
    numpy answers on the host, torch on `device`."""

    def __init__(self, plan: TilePlan, t_ms_all, v_all, lens,
                 dtype=np.float64, max_gather_cols: int | None = None,
                 enc=None, device=None):
        lens = np.asarray(lens, np.int64)
        t_ms_all = np.asarray(t_ms_all, np.int64)
        self.plan = plan
        self.device = None if device is None else torch.device(device)
        # enc = (ftype, blocks, segments, slices): the value column is
        # on-disk encoded blocks (device-decode cold path) — v_all may
        # then be None and the (S, N) value matrix decodes on the DEVICE
        # (_values_for -> ops/device_decode.decode_rows_matrix) or
        # materializes lazily on the host (_host_values, bit-identical)
        self._enc = enc if v_all is None else None
        self._dev_values = None
        self._dev_arrays = None
        self.dtype = np.dtype(dtype)
        S = len(lens)
        N = max(1, int(lens.max()) if S else 1)
        self.S, self.N = S, N
        self.K = len(plan.a_idx)
        self.k_real = self.K
        total = int(lens.sum())
        # padded (S, N) matrices: the one flat-scatter fill shared with
        # the dense path (same +inf/zero padding and base_ms contract)
        self.times, self.values, self.counts, self.base_ms = (
            prepare_matrix_runs(t_ms_all, v_all, lens, dtype=self.dtype))

        # -- integer-arithmetic tile bucketing (no searchsorted) --
        from opengemini_tpu_torch.ops.window import tile_index

        T = plan.num_tiles
        tid = np.clip(tile_index(t_ms_all, plan.anchor_ms, plan.g_ms),
                      0, T - 1)
        if total:
            rows = np.repeat(np.arange(S, dtype=np.int64), lens)
            # int32 throughout: counts and prefixes are bounded by N <
            # 2^31, and these (S, T) arrays are the prepare path's
            # dominant allocation
            cnt = np.bincount(rows * T + tid,
                              minlength=S * T).reshape(S, T).astype(np.int32)
        else:
            cnt = np.zeros((S, T), np.int32)
        tile_cum = np.zeros((S, T + 1), np.int32)
        np.cumsum(cnt, axis=1, out=tile_cum[:, 1:])
        # first/last sample index per window: prefix lookups at edge tiles
        first_idx = tile_cum[:, plan.a_idx]
        last_idx = tile_cum[:, plan.b_idx] - 1
        self.first_idx = first_idx.astype(np.int64)
        self.last_idx = last_idx.astype(np.int64)
        n_samp = last_idx - first_idx + 1
        self.has1 = n_samp >= 1
        self.has2 = n_samp >= 2
        self.n_samp = n_samp.astype(self.dtype)
        lim = np.maximum(lens, 1)[:, None] - 1
        self.safe_f = np.clip(first_idx, 0, lim).astype(np.int32)
        self.safe_l = np.clip(last_idx, 0, lim).astype(np.int32)
        self.safe_fm1 = np.clip(first_idx - 1, 0, lim).astype(np.int32)
        self.safe_lm1 = np.clip(last_idx - 1, 0, lim).astype(np.int32)
        self.fmask = first_idx >= 1  # the straddling boundary pair exists
        self.t_first = np.take_along_axis(
            self.times, self.safe_f, axis=1).astype(self.dtype)
        self.t_last = np.take_along_axis(
            self.times, self.safe_l, axis=1).astype(self.dtype)
        self.t_lm1 = np.take_along_axis(
            self.times, self.safe_lm1, axis=1).astype(self.dtype)

        # -- compact covered-tile gather layout --
        cov = plan.cov
        C = len(cov)
        cnt_cov = cnt[:, cov]
        pmax = int(cnt_cov.max()) if total else 0
        self.occupancy = pmax
        budget = (max_gather_cols if max_gather_cols is not None
                  else 8 * N + 64)
        if C * (pmax + 1) > max(budget, 64):
            raise TileBudgetExceeded(
                f"gather layout {C}x{pmax + 1} over budget {budget}")
        # slot 0 = the sample BEFORE the tile's first (any tile — pair
        # quantities need the previous sample wherever it lives); slots
        # 1..pmax = the tile's own samples
        tile_start = tile_cum[:, cov]  # (S, C) first sample ordinal in tile
        gidx_local = (tile_start[:, :, None]
                      + np.arange(-1, pmax)[None, None, :])
        own_valid = (np.arange(pmax)[None, None, :] < cnt_cov[:, :, None])
        prev_valid = tile_start > 0
        self.gmask = np.concatenate(
            [prev_valid[:, :, None], own_valid], axis=2)
        gidx_local = np.clip(gidx_local, 0, lim[:, :, None])
        self.gidx = (np.arange(S, dtype=np.int64)[:, None, None] * N
                     + gidx_local).astype(np.int64)
        self.C, self.pmax = C, pmax
        # (1, K): take_along_axis broadcasts the non-gather dim, so the
        # per-series copy would be S redundant rows of the same indices
        self.ca2 = plan.ca[None, :].astype(np.int32)
        self.cb2 = plan.cb[None, :].astype(np.int32)
        self.pairmask = self.gmask[:, :, 1:] & self.gmask[:, :, :-1]
        self.ownmask = self.gmask[:, :, 1:]
        # window edges, base-relative seconds, kernel dtype
        self.starts_rel = ((np.rint(np.asarray(plan.a_idx) * plan.g_ms
                                    + plan.anchor_ms) - self.base_ms)
                           / 1000.0).astype(self.dtype)
        self.ends_rel = ((np.rint(np.asarray(plan.b_idx) * plan.g_ms
                                  + plan.anchor_ms) - self.base_ms)
                         / 1000.0).astype(self.dtype)

    # -- kernel building blocks ------------------------------------------

    def _xp(self, xp):
        return namespace(xp, self.device)

    def _arrays(self, X):
        """The prepared arrays in X's array type: self on the host, their
        device copies (uploaded on first use) on the device route."""
        if X is HOST:
            return self
        if self._dev_arrays is None or self._dev_arrays._device != X.device:
            self._dev_arrays = _DeviceArrays(self, X.device)
        return self._dev_arrays

    def _host_values(self):
        """The (S, N) value matrix on the host, materializing a
        still-encoded column lazily (decode + the same flat scatter
        prepare_matrix_runs does — bit-identical to the eager path)."""
        if self.values is None:
            from opengemini_tpu_torch.ops import device_decode

            v_all = device_decode.materialize_enc(self._enc)
            values = np.zeros((self.S, self.N), dtype=self.dtype)
            lens = np.asarray(self.counts, np.int64)
            starts = np.cumsum(lens) - lens
            rows = np.repeat(np.arange(self.S, dtype=np.int64), lens)
            cols = np.arange(int(lens.sum()), dtype=np.int64) \
                - np.repeat(starts, lens)
            values.reshape(-1)[rows * self.N + cols] = v_all
            self.values = values
        return self.values

    def _values_for(self, X):
        """The prepared value matrix in X's array type (one cached device
        copy on the device route). A still-encoded column decodes ON the
        device — the transfer carries the raw block payloads instead of
        the padded f64 matrix — unless the decode's cost gate or block
        checks keep it on the host."""
        if X is HOST:
            return self._host_values()
        dev = self._dev_values
        if dev is None:
            import time as _time

            from opengemini_tpu_torch.utils import devobs

            if self.values is None:
                from opengemini_tpu_torch.ops import device_decode

                dev = device_decode.decode_rows_matrix(
                    self._enc, (self.S, self.N), self.dtype, X.device)
                if dev is not None:
                    devobs.LEDGER.register(
                        "prom_dev_values", int(dev.numel()
                                               * dev.element_size()),
                        label="tiled-values-decoded", anchor=self)
                    self._dev_values = dev
                    return dev
            mat = self._host_values()
            t0 = _time.perf_counter_ns()
            dev = torch.from_numpy(mat).to(X.device)
            devobs.note_transfer(
                "h2d", "prom-values", int(mat.nbytes),
                (_time.perf_counter_ns() - t0) / 1e9)
            devobs.LEDGER.register(
                "prom_dev_values", int(mat.nbytes),
                label="tiled-values", anchor=self)
            self._dev_values = dev
        return dev

    def _vals(self, X, A):
        v = self._values_for(X)
        vg = self._gather_tiles(X, A, v)
        v_first = X.take_along_axis(v, A.safe_f, axis=1)
        v_last = X.take_along_axis(v, A.safe_l, axis=1)
        return v, vg, v_first, v_last

    @staticmethod
    def _gather_tiles(X, A, mat):
        """(S, C, pmax+1) covered-tile gather of a (S, N) matrix: one
        flat take (gidx is in range by construction)."""
        return X.flat_take(mat, A.gidx)

    @staticmethod
    def _window_sums(X, A, tile_vals):
        from opengemini_tpu_torch.ops import segment as seg

        return seg.tile_window_sums(tile_vals, A.ca2, A.cb2, xp=X)


    # -- kernels ----------------------------------------------------------

    def rate(self, xp=np, *, is_counter: bool, is_rate: bool):
        """rate/increase/delta over every (series, step) window:
        tile-prefix counter-reset corrections + first/last gathers,
        prom extrapolatedRate semantics (identical formulas to
        extrapolated_rate above)."""
        X = self._xp(xp)
        A = self._arrays(X)
        v, vg, v_first, v_last = self._vals(X, A)
        delta = v_last - v_first
        if is_counter:
            drop = X.where((vg[:, :, 1:] < vg[:, :, :-1]) & A.pairmask,
                           vg[:, :, :-1], X.zeros((), vg.dtype))
            corr = self._window_sums(X, A, X.sum(drop, 2))
            # boundary refinement: the tile diff counts the one pair that
            # straddles the window start (its earlier sample sits at
            # first_idx - 1, OUTSIDE the window) — subtract it
            v_fm1 = X.take_along_axis(v, A.safe_fm1, axis=1)
            drop_f = X.where((v_first < v_fm1) & A.fmask, v_fm1,
                             X.zeros((), v_first.dtype))
            delta = delta + (corr - drop_f)
        valid = A.has2
        sampled = A.t_last - A.t_first
        sampled = X.where(sampled <= 0, 1.0, sampled)
        avg_int = sampled / X.maximum(A.n_samp - 1, 1)
        d2s = A.t_first - A.starts_rel[None, :]
        d2e = A.ends_rel[None, :] - A.t_last
        thr = avg_int * 1.1
        d2s = X.where(d2s > thr, avg_int / 2, d2s)
        d2e = X.where(d2e > thr, avg_int / 2, d2e)
        if is_counter:
            dz = X.where((delta > 0) & (v_first >= 0),
                         sampled * (v_first / X.maximum(delta, 1e-30)),
                         X.scalar(np.inf, sampled.dtype))
            d2s = X.minimum(d2s, dz)
        out = delta * ((sampled + d2s + d2e) / sampled)
        if is_rate:
            out = out / self.plan.window_s
        return out, valid

    def instant_rate(self, xp=np, *, per_second: bool):
        """irate/idelta: last two samples per window, prefix-resolved."""
        X = self._xp(xp)
        A = self._arrays(X)
        v = self._values_for(X)
        v_last = X.take_along_axis(v, A.safe_l, axis=1)
        v_prev = X.take_along_axis(v, A.safe_lm1, axis=1)
        valid = A.has2
        dv = v_last - v_prev
        if per_second:
            dv = X.where(dv < 0, v_last, dv)  # counter reset
            dt = X.maximum(A.t_last - A.t_lm1, 1e-9)
            return dv / dt, valid
        return dv, valid

    def over_time(self, xp=np, *, func: str):
        """sum/count/avg/last/present/stddev/stdvar/min/max _over_time.

        Prefix-able forms answer from cumulative tile sums; min/max from
        the fixed-length sliding-extreme over tile partials — no dense
        (S, chunk, N) membership tensor anywhere."""
        X = self._xp(xp)
        A = self._arrays(X)
        has = A.has1
        wcnt = X.where(has, A.n_samp, X.zeros((), A.n_samp.dtype))
        if func == "count":
            return wcnt, has
        if func == "present":
            return X.where(has, X.scalar(1, self.dtype), 0), has
        if func == "last":
            return X.take_along_axis(self._values_for(X), A.safe_l,
                                     axis=1), has
        v, vg, _vf, _vl = self._vals(X, A)
        if func in ("sum", "avg"):
            vz = X.where(A.ownmask, vg[:, :, 1:], X.zeros((), vg.dtype))
            wsum = self._window_sums(X, A, X.sum(vz, 2))
            if func == "sum":
                return X.where(has, wsum, X.zeros((), wsum.dtype)), has
            return (X.where(has, wsum, X.zeros((), wsum.dtype))
                    / X.maximum(wcnt, 1)), has
        if func in ("stddev", "stdvar"):
            # center on the per-series mean first (see over_time above:
            # raw v^2 prefixes cancel catastrophically for large
            # magnitudes)
            valid_cols = X.arange(self.N)[None, :] < A.counts[:, None]
            series_n = X.astype(X.maximum(A.counts, 1),
                                self.dtype)[:, None]
            vz_raw = X.where(valid_cols, v, X.zeros((), v.dtype))
            center = X.sum(vz_raw, 1, keepdims=True) / series_n
            vc = X.where(A.ownmask, vg[:, :, 1:] - center[:, :, None],
                         X.zeros((), vg.dtype))
            ws = self._window_sums(X, A, X.sum(vc, 2))
            wss = self._window_sums(X, A, X.sum(vc * vc, 2))
            denom = X.maximum(wcnt, 1)
            mean = ws / denom
            var = X.maximum(wss / denom - mean * mean, 0)
            out = var if func == "stdvar" else X.sqrt(var)
            return X.where(has, out, X.zeros((), out.dtype)), has
        if func in ("min", "max"):
            from opengemini_tpu_torch.ops import segment as seg

            want_min = func == "min"
            fill = self.dtype.type(np.inf if want_min else -np.inf)
            if self.pmax == 0:  # no samples in any covered tile
                tile_ext = X.full((self.S, self.C), fill, dtype=self.dtype)
            elif want_min:
                tile_ext = X.amin(X.where(A.ownmask, vg[:, :, 1:], fill), 2)
            else:
                tile_ext = X.amax(X.where(A.ownmask, vg[:, :, 1:], fill), 2)
            out = seg.tile_sliding_extreme(
                tile_ext, self.plan.win_tiles, A.ca2, want_min, xp=X)
            return out, has
        raise ValueError(f"unsupported over_time func {func!r}")

    def changes_resets(self, xp=np, *, kind: str):
        """changes()/resets(): pair-indicator tile sums + the straddling
        boundary-pair refinement (same shape as the rate correction)."""
        X = self._xp(xp)
        A = self._arrays(X)
        v, vg, v_first, _vl = self._vals(X, A)
        cur, prev = vg[:, :, 1:], vg[:, :, :-1]
        if kind == "changes":
            ind = (cur != prev) & A.pairmask
        else:
            ind = (cur < prev) & A.pairmask
        wind = self._window_sums(X, A, X.sum(X.astype(ind, self.dtype), 2))
        v_fm1 = X.take_along_axis(v, A.safe_fm1, axis=1)
        if kind == "changes":
            bnd = (v_first != v_fm1) & A.fmask
        else:
            bnd = (v_first < v_fm1) & A.fmask
        out = wind - X.astype(bnd, self.dtype)
        valid = A.has1
        return X.where(valid, out, X.zeros((), out.dtype)), valid

    def linear_regression(self, xp=np):
        """Least-squares slope/intercept per window centered at the window
        end (prom linearRegression), from tile partials of {v, t, t^2, tv}
        — the O(S*chunk*N) dense pass becomes four prefix lookups."""
        X = self._xp(xp)
        A = self._arrays(X)
        _v, vg, _vf, _vl = self._vals(X, A)
        tg = X.astype(self._gather_tiles(X, A, A.times)[:, :, 1:],
                      self.dtype)
        z = X.zeros((), vg.dtype)
        vz = X.where(A.ownmask, vg[:, :, 1:], z)
        tz = X.where(A.ownmask, tg, z)
        sv = self._window_sums(X, A, X.sum(vz, 2))
        st_abs = self._window_sums(X, A, X.sum(tz, 2))
        stt_abs = self._window_sums(X, A, X.sum(tz * tz, 2))
        stv_abs = self._window_sums(X, A, X.sum(tz * vz, 2))
        e = A.ends_rel[None, :]
        cnt = X.where(A.has1, A.n_samp, 0)
        denom_n = X.maximum(cnt, 1)
        st = st_abs - e * cnt
        stt = stt_abs - 2 * e * st_abs + e * e * cnt
        stv = stv_abs - e * sv
        cov = stv - st * sv / denom_n
        var = stt - st * st / denom_n
        slope = cov / X.where(var == 0, 1.0, var)
        slope = X.where(var == 0, 0.0, slope)
        intercept = sv / denom_n - slope * (st / denom_n)
        has2 = A.has2 & (A.t_last > A.t_first)
        return slope, intercept, has2

    def sharded(self, mesh) -> "ShardedTiled":
        """The mesh view of this prepared state (cached per mesh: one
        sharding transfer per query however many kernels run)."""
        cached = getattr(self, "_sharded_view", None)
        if cached is not None and cached[0] is mesh:
            return cached[1]
        view = ShardedTiled(self, mesh)
        self._sharded_view = (mesh, view)
        return view


# ---------------------------------------------------------------------------
# Multi-shard tiled kernels: series-axis sharding over a device mesh.
#
# Every TiledPrepared array is either per-series (leading axis S: the
# values/times matrices, the covered-tile gather and its masks, the
# per-window prefix lookups and boundary gathers) or per-window (the
# compact range positions ca/cb and the window edges). Series are
# independent — no kernel combines two series rows — so splitting the S
# axis over the shards partitions every kernel with no merge: each shard
# runs the unmodified kernel method on its rows, on its device, once the
# flat covered-tile gather is rebased to the shard's rows.
# ---------------------------------------------------------------------------

# per-series arrays (leading axis S: split over the shards)
_TILED_SHARD_ATTRS = (
    "values", "counts", "times", "ownmask", "pairmask", "fmask",
    "has1", "has2", "n_samp", "safe_f", "safe_l", "safe_fm1", "safe_lm1",
    "t_first", "t_last", "t_lm1",
)
# per-window arrays (whole on every shard: each shard answers all K
# windows of its own series rows)
_TILED_REPL_ATTRS = ("ca2", "cb2", "starts_rel", "ends_rel")


class _ShardArrays:
    """One shard's kernel arrays on its device (what _DeviceArrays is on
    one device)."""

    def __init__(self, device, arrays: dict):
        self._device = device
        self.__dict__.update(arrays)


class ShardedTiled:
    """Mesh execution of one TiledPrepared: per-series arrays split over
    the shards (rows padded to a multiple of mesh.size; padding rows
    carry all-False masks, answer as empty windows and are sliced off by
    the caller), per-window arrays on every shard. Each kernel method
    runs TiledPrepared's on every local shard and concatenates the
    shards' (rows, K) outputs on the first local shard's device:
    (S_pad, K), which the caller slices to [:prep.S, :prep.k_real].
    Across processes each rank runs its own shards and the outputs come
    back whole on every rank through the mesh's all_gather
    (distributed.Sharded.gather)."""

    def __init__(self, prep: TiledPrepared, mesh):
        from opengemini_tpu_torch.parallel import distributed, runtime
        from opengemini_tpu_torch.utils import devobs

        self.prep = prep
        self.mesh = mesh
        n_dev = mesh.size
        self.S_pad = max(1, (prep.S + n_dev - 1) // n_dev * n_dev)
        rows_per = self.S_pad // n_dev
        # the covered-tile gather rebased from (S, N)-flat to the
        # shard's (rows_per, N)-flat positions
        row = np.arange(prep.S, dtype=np.int64)
        gidx = (prep.gidx - (row - row % rows_per)[:, None, None] * prep.N)
        series = {name: (prep._host_values() if name == "values"
                         else getattr(prep, name))
                  for name in _TILED_SHARD_ATTRS}
        series["gidx"] = gidx
        sharded = distributed.shard_leading_axis(
            mesh, *series.values(), xfer_site="prom-shard")
        self.arrays = dict(zip(series.keys(), sharded))
        repl = {name: np.ascontiguousarray(getattr(prep, name))
                for name in _TILED_REPL_ATTRS}
        self._views = []
        nbytes = sum(a.nbytes for a in self.arrays.values())
        for i, dev in enumerate(mesh.local_devices):
            arrays = {name: a.parts[i] for name, a in self.arrays.items()}
            for name, host in repl.items():
                arrays[name] = torch.from_numpy(host).to(dev)
                nbytes += int(host.nbytes)
            view = object.__new__(TiledPrepared)
            view.__dict__.update({
                "plan": prep.plan, "dtype": prep.dtype, "S": rows_per,
                "N": prep.N, "K": prep.K, "k_real": prep.k_real,
                "C": prep.C, "pmax": prep.pmax, "device": dev,
                "values": None, "_enc": None,
                "_dev_values": arrays["values"],
                "_dev_arrays": _ShardArrays(dev, arrays)})
            self._views.append(view)
        devobs.LEDGER.register(
            "prom_sharded", nbytes, mesh_epoch=runtime.mesh_epoch(),
            label="sharded-tiled", anchor=self)

    def _run(self, kernel: str, **opts):
        from opengemini_tpu_torch.parallel import distributed

        outs = [getattr(TiledPrepared, kernel)(view, torch, **opts)
                for view in self._views]
        return tuple(
            distributed.Sharded(self.mesh, [o[j] for o in outs]).gather()
            for j in range(len(outs[0])))

    def rate(self, *, is_counter: bool, is_rate: bool):
        return self._run("rate", is_counter=is_counter, is_rate=is_rate)

    def instant_rate(self, *, per_second: bool):
        return self._run("instant_rate", per_second=per_second)

    def over_time(self, *, func: str):
        return self._run("over_time", func=func)

    def changes_resets(self, *, kind: str):
        return self._run("changes_resets", kind=kind)

    def linear_regression(self):
        return self._run("linear_regression")


class TileBudgetExceeded(ValueError):
    """Raised by TiledPrepared when the compact gather layout would exceed
    its memory budget (pathological occupancy skew); callers take the
    dense kernels."""


def prepare_tiled(plan: TilePlan, t_ms_all, v_all, lens, dtype=np.float64,
                  max_gather_cols: int | None = None, enc=None,
                  device=None):
    """TiledPrepared or None (budget exceeded -> dense kernels)."""
    try:
        return TiledPrepared(plan, t_ms_all, v_all, lens, dtype=dtype,
                             max_gather_cols=max_gather_cols, enc=enc,
                             device=device)
    except TileBudgetExceeded:
        return None


# -- incremental tile-state tier (promql/rules.py) ----------------------------
#
# The continuous rule engine maintains PER-TILE partials as durable-ish
# STATE between ticks instead of recomputing them per query: each tile of
# the group's ms lattice carries one mergeable record per series, the
# ingest path dirties tiles, and a tick refolds only the dirtied tiles
# (fold_tile_partials) before answering every rule window from a
# left-to-right merge of its covering tiles (merge_tile_partials +
# partials_answer).  The record is the TiLT partial (arXiv:2301.12030)
# the batch engine above computes transiently, plus the boundary-pair
# inputs (first/last sample) that let cross-tile merges reconstruct the
# straddling reset/change corrections exactly.
#
# All arithmetic here is HOST numpy float64 on purpose: the rule engine's
# acceptance contract is BITWISE identity between the incremental leg
# (merge cached + refolded tiles) and the from-scratch leg (fold every
# tile off one full-window scan, merge identically), which holds only
# under a deterministic reduction order.  Device/mesh routing still
# happens per group — for the matcher probe (label tier) and for the
# full-rescan fallback leg, which evaluates through the ordinary planner-
# routed engine kernels.

# field -> fill value for an EMPTY (series, tile) cell; merge order is
# the tuple order
TILE_PARTIAL_FIELDS = (
    ("n", 0.0), ("sum", 0.0), ("sumsq", 0.0),
    ("mn", np.inf), ("mx", -np.inf),
    ("t_first", 0.0), ("v_first", 0.0), ("t_last", 0.0), ("v_last", 0.0),
    ("drop", 0.0), ("changes", 0.0), ("resets", 0.0),
)

# range-vector functions the partial record answers exactly (everything
# else takes the rule engine's full-rescan fallback through the engine)
PARTIAL_RATE_FUNCS = frozenset({"rate", "increase", "delta"})
PARTIAL_OVER_TIME = frozenset({
    "sum", "count", "avg", "min", "max", "stddev", "stdvar", "last",
    "present"})
PARTIAL_PAIR_FUNCS = frozenset({"changes", "resets"})


def empty_tile_partials(n_series: int) -> dict:
    """One tile's record columns for `n_series` series, all empty."""
    return {f: np.full(n_series, fill, np.float64)
            for f, fill in TILE_PARTIAL_FIELDS}


def fold_tile_partials(t_ms_all, v_all, lens, anchor_ms: int, g_ms: int,
                       lo_tile: int, hi_tile: int) -> dict[int, dict]:
    """Fold run-encoded samples into per-tile partial records.

    Input is the engine's run-encoded collection (concatenated int64 ms
    timestamps + float64 values with per-series lengths, ascending per
    series); only samples landing in lattice tiles [lo_tile, hi_tile)
    contribute.  Returns {tile_idx: {field: (S,) float64}} holding ONLY
    tiles that received at least one sample — absent means empty, so the
    caller can overlay the result onto cached state.

    Pair quantities (drop/changes/resets) count sample pairs fully INSIDE
    one tile; pairs straddling tiles are reconstructed at merge time from
    (v_last, v_first) of consecutive non-empty tiles, which is exact
    because tiles partition the time axis and samples are time-ordered.
    """
    from opengemini_tpu_torch.ops.window import tile_index

    lens = np.asarray(lens, np.int64)
    S = len(lens)
    t_ms_all = np.asarray(t_ms_all, np.int64)
    v_all = np.asarray(v_all, np.float64)
    if t_ms_all.size == 0:
        return {}
    tid = tile_index(t_ms_all, anchor_ms, g_ms)
    rows = np.repeat(np.arange(S, dtype=np.int64), lens)
    keep = (tid >= lo_tile) & (tid < hi_tile)
    span = hi_tile - lo_tile
    # rows are blockwise-ascending and t (hence tid) ascends per series,
    # so key is globally non-decreasing: segment reductions are plain
    # reduceat over change points — no sort, no hashing
    key = rows * span + (tid - lo_tile)
    # pair columns BEFORE masking: a pair exists when sample i-1 and i
    # share a (series, tile) cell
    same = np.zeros(len(key), bool)
    if len(key) > 1:
        same[1:] = key[1:] == key[:-1]
    prev_v = np.empty_like(v_all)
    prev_v[0] = 0.0
    prev_v[1:] = v_all[:-1]
    p_reset = same & (v_all < prev_v)
    p_drop = np.where(p_reset, prev_v, 0.0)
    p_change = (same & (v_all != prev_v)).astype(np.float64)
    if not keep.all():
        key = key[keep]
        t_k = t_ms_all[keep]
        v_k = v_all[keep]
        p_drop = p_drop[keep]
        p_change = p_change[keep]
        p_resets = p_reset[keep].astype(np.float64)
    else:
        t_k = t_ms_all
        v_k = v_all
        p_resets = p_reset.astype(np.float64)
    if key.size == 0:
        return {}
    starts = np.flatnonzero(np.diff(key)) + 1
    starts = np.concatenate([[0], starts])
    seg_key = key[starts]
    seg_n = np.diff(np.concatenate([starts, [key.size]]))
    seg_sum = np.add.reduceat(v_k, starts)
    seg_sumsq = np.add.reduceat(v_k * v_k, starts)
    seg_mn = np.minimum.reduceat(v_k, starts)
    seg_mx = np.maximum.reduceat(v_k, starts)
    seg_drop = np.add.reduceat(p_drop, starts)
    seg_changes = np.add.reduceat(p_change, starts)
    seg_resets = np.add.reduceat(p_resets, starts)
    ends = starts + seg_n - 1
    out: dict[int, dict] = {}
    seg_row = seg_key // span
    seg_tile = seg_key % span + lo_tile
    for tile in np.unique(seg_tile):
        sel = seg_tile == tile
        r = seg_row[sel]
        rec = empty_tile_partials(S)
        rec["n"][r] = seg_n[sel]
        rec["sum"][r] = seg_sum[sel]
        rec["sumsq"][r] = seg_sumsq[sel]
        rec["mn"][r] = seg_mn[sel]
        rec["mx"][r] = seg_mx[sel]
        rec["t_first"][r] = t_k[starts[sel]]
        rec["v_first"][r] = v_k[starts[sel]]
        rec["t_last"][r] = t_k[ends[sel]]
        rec["v_last"][r] = v_k[ends[sel]]
        rec["drop"][r] = seg_drop[sel]
        rec["changes"][r] = seg_changes[sel]
        rec["resets"][r] = seg_resets[sel]
        out[int(tile)] = rec
    return out


def merge_tile_partials(tiles: list[dict | None], n_series: int) -> dict:
    """Left-to-right merge of per-tile records into one window record.

    `tiles` lists the window's covering tiles in time order (None =
    empty tile).  Boundary pairs between consecutive NON-EMPTY tiles add
    the straddling reset/change corrections the per-tile fold could not
    see.  Deterministic (same tile order -> same bits), which is the
    incremental-vs-rescan identity contract."""
    m = empty_tile_partials(n_series)
    for rec in tiles:
        if rec is None:
            continue
        t_has = rec["n"] > 0
        if not t_has.any():
            continue
        m_has = m["n"] > 0
        both = m_has & t_has
        bd_reset = both & (rec["v_first"] < m["v_last"])
        m["drop"] += np.where(bd_reset, m["v_last"], 0.0) \
            + np.where(t_has, rec["drop"], 0.0)
        m["resets"] += bd_reset + np.where(t_has, rec["resets"], 0.0)
        m["changes"] += (both & (rec["v_first"] != m["v_last"])) \
            + np.where(t_has, rec["changes"], 0.0)
        m["n"] += np.where(t_has, rec["n"], 0.0)
        m["sum"] += np.where(t_has, rec["sum"], 0.0)
        m["sumsq"] += np.where(t_has, rec["sumsq"], 0.0)
        m["mn"] = np.where(t_has, np.minimum(m["mn"], rec["mn"]), m["mn"])
        m["mx"] = np.where(t_has, np.maximum(m["mx"], rec["mx"]), m["mx"])
        first = t_has & ~m_has
        m["t_first"] = np.where(first, rec["t_first"], m["t_first"])
        m["v_first"] = np.where(first, rec["v_first"], m["v_first"])
        m["t_last"] = np.where(t_has, rec["t_last"], m["t_last"])
        m["v_last"] = np.where(t_has, rec["v_last"], m["v_last"])
    return m


def partials_answer(m: dict, func: str, ws_ms: int, we_ms: int):
    """(values, valid) for one rule window from a merged record.

    Same semantics as the batch kernels above: extrapolatedRate with the
    1.1x-average-interval clamp and counter zero-crossing for
    rate/increase/delta, pair counts for changes/resets, moment algebra
    for the *_over_time forms (stddev/stdvar from sum/sumsq — adequate
    for monitoring magnitudes; the engine's per-query centered form is
    not reachable from mergeable per-tile state)."""
    n = m["n"]
    has1 = n >= 1
    if func == "count":
        return np.where(has1, n, 0.0), has1
    if func == "present":
        return np.where(has1, 1.0, 0.0), has1
    if func == "last":
        return m["v_last"], has1
    if func == "sum":
        return np.where(has1, m["sum"], 0.0), has1
    if func == "avg":
        return m["sum"] / np.maximum(n, 1.0), has1
    if func == "min":
        return m["mn"], has1
    if func == "max":
        return m["mx"], has1
    if func in ("stddev", "stdvar"):
        denom = np.maximum(n, 1.0)
        mean = m["sum"] / denom
        var = np.maximum(m["sumsq"] / denom - mean * mean, 0.0)
        return (var if func == "stdvar" else np.sqrt(var)), has1
    if func in ("changes", "resets"):
        out = m["changes"] if func == "changes" else m["resets"]
        return np.where(has1, out, 0.0), has1
    if func in PARTIAL_RATE_FUNCS:
        is_counter = func in ("rate", "increase")
        valid = n >= 2
        delta = m["v_last"] - m["v_first"]
        if is_counter:
            delta = delta + m["drop"]
        # int64 ms differences -> exact float seconds (the batch path's
        # base-relative precision argument, with the window start as base)
        sampled = (m["t_last"] - m["t_first"]) / 1000.0
        sampled = np.where(sampled <= 0, 1.0, sampled)
        avg_int = sampled / np.maximum(n - 1, 1.0)
        d2s = (m["t_first"] - ws_ms) / 1000.0
        d2e = (we_ms - m["t_last"]) / 1000.0
        thr = avg_int * 1.1
        d2s = np.where(d2s > thr, avg_int / 2, d2s)
        d2e = np.where(d2e > thr, avg_int / 2, d2e)
        if is_counter:
            dz = np.where((delta > 0) & (m["v_first"] >= 0),
                          sampled * (m["v_first"] / np.maximum(delta, 1e-30)),
                          np.inf)
            d2s = np.minimum(d2s, dz)
        out = delta * ((sampled + d2s + d2e) / sampled)
        if func == "rate":
            out = out / ((we_ms - ws_ms) / 1000.0)
        return out, valid
    raise ValueError(f"unsupported partials func {func!r}")
