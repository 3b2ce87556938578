"""Aggregate function registry: InfluxQL call name -> device reduction.

The declarative replacement for the reference's call-processor dispatch
(engine/executor/call_processor.go + agg_func.go): each entry knows how to
compute per-segment outputs from a masked device batch and how the executor
should render results.

Contract: fn(values, rel_hi, rel_lo, seg_ids, num_segments, mask, *params)
    -> (out_values, sel_idx | None)
(rel_hi, rel_lo) is the exact int32 pair encoding of the row's ns time
relative to the batch base (rel >> 30, rel & (2^30-1)) used for device-side
ordering; `sel_idx` (selectors only) is the batch row index of the selected
point, which the executor resolves against its host-side int64 ns times for
exact output timestamps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from opengemini_tpu_torch.ops import segment as seg


@dataclass(frozen=True)
class AggSpec:
    name: str
    fn: Callable
    is_selector: bool = False  # returns the selected point's own row index
    int_output: bool = False  # count-like: always rendered as int
    params: tuple = field(default_factory=tuple)  # e.g. percentile q


def _wrap_plain(f):
    def run(values, rel_hi, rel_lo, seg_ids, num_segments, mask, *params):
        return f(values, seg_ids, num_segments, mask, *params), None

    return run


def _count(values, rel_hi, rel_lo, seg_ids, n, mask):
    return seg.seg_count(seg_ids, n, mask), None


def _spread(values, rel_hi, rel_lo, seg_ids, n, mask):
    mx = seg.seg_max(values, seg_ids, n, mask)
    mn = seg.seg_min(values, seg_ids, n, mask)
    return mx - mn, None


def _min_sel(values, rel_hi, rel_lo, seg_ids, n, mask):
    return seg.seg_min_selector(values, rel_hi, rel_lo, seg_ids, n, mask)


def _max_sel(values, rel_hi, rel_lo, seg_ids, n, mask):
    return seg.seg_max_selector(values, rel_hi, rel_lo, seg_ids, n, mask)


def _first(values, rel_hi, rel_lo, seg_ids, n, mask):
    return seg.seg_first(values, rel_hi, rel_lo, seg_ids, n, mask)


def _last(values, rel_hi, rel_lo, seg_ids, n, mask):
    return seg.seg_last(values, rel_hi, rel_lo, seg_ids, n, mask)


REGISTRY: dict[str, AggSpec] = {
    "count": AggSpec("count", _count, int_output=True),
    "sum": AggSpec("sum", _wrap_plain(seg.seg_sum)),
    "mean": AggSpec("mean", _wrap_plain(seg.seg_mean)),
    "min": AggSpec("min", _min_sel, is_selector=True),
    "max": AggSpec("max", _max_sel, is_selector=True),
    "first": AggSpec("first", _first, is_selector=True),
    "last": AggSpec("last", _last, is_selector=True),
    "spread": AggSpec("spread", _spread),
    "stddev": AggSpec("stddev", _wrap_plain(seg.seg_stddev)),
    "median": AggSpec("median", _wrap_plain(seg.seg_median)),
    "percentile": AggSpec("percentile", _wrap_plain(seg.seg_percentile)),
    "count_distinct": AggSpec(
        "count_distinct", _wrap_plain(seg.seg_count_distinct), int_output=True
    ),
}


def get(name: str) -> AggSpec:
    spec = REGISTRY.get(name.lower())
    if spec is None:
        raise KeyError(f"unsupported aggregate function: {name}")
    return spec
