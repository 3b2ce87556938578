"""Masked segmented reductions in PyTorch.

The port of ``opengemini_tpu/ops/segment.py``. Each aggregate over
(series-group, time-window) segments is a masked segmented reduction
with segment id ``group_id * num_windows + window_id``. The scatter
forms below (``index_add_`` / ``scatter_reduce_`` / sorts) serve the
general ``AggBatch`` path (rank aggregates); the dense layouts of the
main path are ``grid_window_agg_t`` here (the plain version of the CUDA
grid kernel in ``ops/cuda_segment.py``) and the bucket matrices of
``models/ragged.py``.

Null semantics: ``mask`` False rows contribute nothing; empty segments
give count 0, sum 0, min +inf, max -inf (the JAX package's identities).
Every function takes tensors on one device and returns tensors there;
``num_segments`` is a Python int.
"""

from __future__ import annotations

import torch

_BIG_I32 = 2**31 - 1


def _type_max(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _type_min(dtype: torch.dtype):
    if dtype.is_floating_point:
        return -float("inf")
    return torch.iinfo(dtype).min


def _seg_reduce(data, seg_ids, num_segments: int, reduce: str, fill):
    out = torch.full((num_segments,), fill, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, seg_ids.long(), data, reduce=reduce,
                               include_self=True)


def _smin(data, seg_ids, num_segments):
    return _seg_reduce(data, seg_ids, num_segments, "amin",
                       _type_max(data.dtype))


def _smax(data, seg_ids, num_segments):
    return _seg_reduce(data, seg_ids, num_segments, "amax",
                       _type_min(data.dtype))


def seg_sum(values, seg_ids, num_segments: int, mask):
    data = torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids.long(), data)


def seg_count(seg_ids, num_segments: int, mask):
    out = torch.zeros(num_segments, dtype=torch.int32, device=mask.device)
    return out.index_add_(0, seg_ids.long(), mask.to(torch.int32))


def seg_min(values, seg_ids, num_segments: int, mask):
    data = torch.where(mask, values, torch.full_like(
        values, _type_max(values.dtype)))
    return _smin(data, seg_ids, num_segments)


def seg_max(values, seg_ids, num_segments: int, mask):
    data = torch.where(mask, values, torch.full_like(
        values, _type_min(values.dtype)))
    return _smax(data, seg_ids, num_segments)


def seg_mean(values, seg_ids, num_segments: int, mask):
    s = seg_sum(values, seg_ids, num_segments, mask)
    c = seg_count(seg_ids, num_segments, mask)
    return s / c.clamp(min=1).to(s.dtype)


def seg_sumsq(values, seg_ids, num_segments: int, mask):
    return seg_sum(values * values, seg_ids, num_segments, mask)


def seg_stddev(values, seg_ids, num_segments: int, mask):
    """Sample stddev, n-1 denominator, two-pass (mean, then squared
    deviations) like the JAX package."""
    mean = seg_mean(values, seg_ids, num_segments, mask)
    dev = values - mean[seg_ids.long()]
    ssd = seg_sum(dev * dev, seg_ids, num_segments, mask)
    c = seg_count(seg_ids, num_segments, mask).to(values.dtype)
    var = ssd / (c - 1).clamp(min=1)
    return torch.sqrt(var.clamp(min=0))


def seg_first(values, rel_hi, rel_lo, seg_ids, num_segments: int, mask):
    """(value, row_idx) of the earliest valid row per segment; exact-time
    ties take the larger value, then scan order."""
    return _seg_extreme_by_time(values, rel_hi, rel_lo, seg_ids,
                                num_segments, mask, latest=False)


def seg_last(values, rel_hi, rel_lo, seg_ids, num_segments: int, mask):
    return _seg_extreme_by_time(values, rel_hi, rel_lo, seg_ids,
                                num_segments, mask, latest=True)


def _seg_extreme_by_time(values, rel_hi, rel_lo, seg_ids, num_segments,
                         mask, latest):
    n = values.shape[0]
    seg = seg_ids.long()
    idx = torch.arange(n, dtype=torch.int32, device=values.device)
    big = torch.tensor(_BIG_I32, dtype=torch.int32, device=values.device)
    if latest:
        hi_ext = _smax(torch.where(mask, rel_hi, -big), seg, num_segments)
        cand = mask & (rel_hi == hi_ext[seg])
        lo_ext = _smax(torch.where(cand, rel_lo, -big), seg, num_segments)
    else:
        hi_ext = _smin(torch.where(mask, rel_hi, big), seg, num_segments)
        cand = mask & (rel_hi == hi_ext[seg])
        lo_ext = _smin(torch.where(cand, rel_lo, big), seg, num_segments)
    cand = cand & (rel_lo == lo_ext[seg])
    v_ext = _smax(torch.where(cand, values, torch.full_like(
        values, _type_min(values.dtype))), seg, num_segments)
    cand = cand & (values == v_ext[seg])
    sel = _smin(torch.where(cand, idx, big), seg, num_segments)
    safe = sel.clamp(0, n - 1).long()
    return values[safe], sel


def seg_min_selector(values, rel_hi, rel_lo, seg_ids, num_segments: int,
                     mask):
    """min() as a selector: also the row index of the selected point;
    value ties break by earliest timestamp, then scan order."""
    return _seg_extreme_by_value(values, rel_hi, rel_lo, seg_ids,
                                 num_segments, mask, want_max=False)


def seg_max_selector(values, rel_hi, rel_lo, seg_ids, num_segments: int,
                     mask):
    return _seg_extreme_by_value(values, rel_hi, rel_lo, seg_ids,
                                 num_segments, mask, want_max=True)


def _seg_extreme_by_value(values, rel_hi, rel_lo, seg_ids, num_segments,
                          mask, want_max):
    n = values.shape[0]
    seg = seg_ids.long()
    idx = torch.arange(n, dtype=torch.int32, device=values.device)
    big = torch.tensor(_BIG_I32, dtype=torch.int32, device=values.device)
    if want_max:
        v_ext = seg_max(values, seg, num_segments, mask)
    else:
        v_ext = seg_min(values, seg, num_segments, mask)
    cand = mask & (values == v_ext[seg])
    hi_best = _smin(torch.where(cand, rel_hi, big), seg, num_segments)
    cand = cand & (rel_hi == hi_best[seg])
    lo_best = _smin(torch.where(cand, rel_lo, big), seg, num_segments)
    cand = cand & (rel_lo == lo_best[seg])
    sel = _smin(torch.where(cand, idx, big), seg, num_segments)
    return v_ext, sel


def _sort_by_segment(values, seg_ids, num_segments, mask):
    """Rows sorted by (segment, value) with invalid rows pushed into a
    trailing dummy segment. Returns (sorted_values, sorted_seg, counts,
    starts)."""
    sort_seg = torch.where(mask, seg_ids.long(),
                           torch.full_like(seg_ids.long(), num_segments))
    order = torch.sort(values, stable=True).indices
    order = order[torch.sort(sort_seg[order], stable=True).indices]
    counts = seg_count(seg_ids, num_segments, mask)
    starts = torch.cumsum(counts, 0) - counts
    return values[order], sort_seg[order], counts, starts


def seg_percentile(values, seg_ids, num_segments: int, mask, q: float):
    """Nearest-rank percentile per segment: rank = floor(n*q/100 + 0.5)."""
    n = values.shape[0]
    sorted_vals, _, counts, starts = _sort_by_segment(
        values, seg_ids, num_segments, mask)
    rank = torch.floor(q / 100.0 * counts.to(torch.float64) + 0.5).to(
        torch.int64)
    rank = torch.minimum((rank - 1).clamp(min=0),
                         (counts.to(torch.int64) - 1).clamp(min=0))
    sel = (starts.to(torch.int64) + rank).clamp(0, n - 1)
    return sorted_vals[sel]


def seg_median(values, seg_ids, num_segments: int, mask):
    """Middle value, or the mean of the two middles for even counts."""
    n = values.shape[0]
    sorted_vals, _, counts, starts = _sort_by_segment(
        values, seg_ids, num_segments, mask)
    counts = counts.to(torch.int64)
    starts = starts.to(torch.int64)
    lo = starts + ((counts - 1) // 2).clamp(min=0)
    hi = starts + (counts // 2).clamp(min=0)
    lo_v = sorted_vals[lo.clamp(0, n - 1)]
    hi_v = sorted_vals[hi.clamp(0, n - 1)]
    return (lo_v + hi_v) / 2


def seg_count_distinct(values, seg_ids, num_segments: int, mask):
    """count(distinct(field)): sort by (seg, value), count run heads."""
    sv, ss, _, _ = _sort_by_segment(values, seg_ids, num_segments, mask)
    head = torch.ones_like(ss, dtype=torch.int32)
    same = (ss[1:] == ss[:-1]) & (sv[1:] == sv[:-1])
    head[1:] = torch.where(same, 0, 1).to(torch.int32)
    head = torch.where(ss < num_segments, head, 0).to(torch.int32)
    out = torch.zeros(num_segments, dtype=torch.int32, device=values.device)
    return out.index_add_(0, ss.clamp(0, num_segments - 1), head)


def grid_window_agg_t(values_t, mask_t):
    """Regular-grid window reduce over (num_series, samples_per_window,
    num_windows): every per-window stat reduces axis 1. Plain version of
    the CUDA kernel ``cuda_segment.grid_window_agg``. Returns a dict of
    (num_series, num_windows) tensors."""
    zero = torch.zeros((), dtype=values_t.dtype, device=values_t.device)
    inf = torch.tensor(float("inf"), dtype=values_t.dtype,
                       device=values_t.device)
    cnt = mask_t.sum(dim=1, dtype=torch.int32)
    s = torch.where(mask_t, values_t, zero).sum(dim=1)
    mn = torch.where(mask_t, values_t, inf).amin(dim=1)
    mx = torch.where(mask_t, values_t, -inf).amax(dim=1)
    mean = s / cnt.clamp(min=1).to(s.dtype)
    return {"sum": s, "count": cnt, "mean": mean, "min": mn, "max": mx}


# ---------------------------------------------------------------------------
# Tiled interval reductions (time-centric batch operators, TiLT
# arXiv:2301.12030): per-(series, tile) partials answered per window from
# cumulative tile prefixes. Shared by the PromQL range-vector engine
# (ops/prom.py TiledPrepared): every window is an exact union of
# left-open/right-closed time tiles, so these helpers replace per-window
# sample walks with O(1) prefix lookups. `xp` is one of ops/prom.py's
# array namespaces: HOST (numpy) or a TorchXP on a device.
# ---------------------------------------------------------------------------


def tile_window_sums(tile_vals, ca, cb, xp):
    """Per-window sums over contiguous compact-tile ranges [ca, cb) from
    ONE cumulative pass over the tile partials.

    tile_vals: (S, C) per-(series, tile) partial sums; ca/cb: (S, K) or
    (1, K) int compact positions (cb exclusive). Returns (S, K)."""
    s_dim = tile_vals.shape[0]
    cc = xp.cumsum(tile_vals, axis=1)
    cc = xp.concatenate(
        [xp.zeros((s_dim, 1), dtype=tile_vals.dtype), cc], axis=1)
    return (xp.take_along_axis(cc, cb, axis=1)
            - xp.take_along_axis(cc, ca, axis=1))


def tile_sliding_extreme(tile_vals, win_tiles: int, start_pos,
                         want_min: bool, xp):
    """min/max over EXACTLY win_tiles consecutive tiles starting at compact
    position start_pos (S, K): the fixed-length sliding-extreme trick —
    block the tile axis at the window length, scan each block prefix-from-
    left and suffix-from-right, and any length-L range [i, i+L) spans at
    most two blocks, so its extreme is suffix_at(i) combined with
    prefix_at(i+L-1). O(C) build, O(1) per window."""
    s_dim, c_dim = tile_vals.shape
    fill = xp.extreme_fill(tile_vals.dtype, want_min)
    ln = max(int(win_tiles), 1)
    blocks = (c_dim + ln - 1) // ln
    pad = blocks * ln - c_dim
    x = xp.concatenate(
        [tile_vals, xp.full((s_dim, pad), fill, dtype=tile_vals.dtype)],
        axis=1) if pad else tile_vals
    x3 = x.reshape(s_dim, blocks, ln)
    suf = xp.cum_extreme(x3, 2, want_min, reverse=True)
    pre = xp.cum_extreme(x3, 2, want_min, reverse=False)
    suf = suf.reshape(s_dim, blocks * ln)
    pre = pre.reshape(s_dim, blocks * ln)
    hi = xp.clip(start_pos + (ln - 1), 0, blocks * ln - 1)
    lo = xp.clip(start_pos, 0, blocks * ln - 1)
    a = xp.take_along_axis(suf, lo, axis=1)
    b = xp.take_along_axis(pre, hi, axis=1)
    return xp.minimum(a, b) if want_min else xp.maximum(a, b)
