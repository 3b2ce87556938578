"""Shard downsampling: rewrite a shard's rows at a coarser time
resolution.

The port of ``opengemini_tpu/storage/downsample.py``. The rows of a
measurement become, per field, one batch of segmented window reductions
(series x window segments): float fields (and any field whose aggregate
yields a float) run as a ``templates.AggBatch`` on the device the caller
names (the engine's, ``Engine.run_downsample``). Integer fields whose
aggregate keeps the integer type (sum, min, max, first, last) take the
exact host int64 path (``_host_int_agg``): the port computes in f64,
whose 2^53 is not int64's 2^63, so a destructive rewrite must not pass
integers through it.

Per-field aggregate: ``field_aggs[name]``, else the type's entry
(``float``, ``integer``, ``boolean``: the SQL surface's
``float(mean)``), else by type: float->mean, int->sum, bool->last.
String fields are dropped. Rows carry the window start time; empty
windows produce no row.
"""

from __future__ import annotations

import time as _time

import numpy as np

from opengemini_tpu_torch.device import resolve_device
from opengemini_tpu_torch.models import templates
from opengemini_tpu_torch.ops import aggregates as aggmod
from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.record import Column, FieldType, Record
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

DEFAULT_TYPE_AGGS = {
    FieldType.FLOAT: "mean",
    FieldType.INT: "sum",
    FieldType.BOOL: "last",
}


def _host_int_agg(agg: str, values, valid, seg64, out, counts) -> None:
    """Exact int64 windowed aggregate for one series, accumulated in place
    (rows are time-sorted, so first/last per window are positional)."""
    idx = np.flatnonzero(valid)
    if len(idx) == 0:
        return
    segs = seg64[idx]
    vals = values[idx].astype(np.int64)
    if agg == "sum":
        np.add.at(out, segs, vals)
    elif agg == "min":
        # initialize untouched windows to the identity before minimum
        first_seen = np.unique(segs[counts[segs] == 0])
        out[first_seen] = np.iinfo(np.int64).max
        np.minimum.at(out, segs, vals)
    elif agg == "max":
        first_seen = np.unique(segs[counts[segs] == 0])
        out[first_seen] = np.iinfo(np.int64).min
        np.maximum.at(out, segs, vals)
    elif agg == "first":
        uniq, first_pos = np.unique(segs, return_index=True)
        untouched = counts[uniq] == 0
        out[uniq[untouched]] = vals[first_pos[untouched]]
    elif agg == "last":
        uniq, first_pos_rev = np.unique(segs[::-1], return_index=True)
        out[uniq] = vals[len(vals) - 1 - first_pos_rev]
    else:
        raise ValueError(f"host int agg does not support {agg!r}")
    np.add.at(counts, segs, 1)


def downsample_records(
    series: dict[int, Record],
    schema: dict[str, FieldType],
    tmin: int,
    tmax: int,
    every_ns: int,
    field_aggs: dict[str, str] | None = None,
    device=None,
) -> tuple[dict[int, Record], dict[str, FieldType]]:
    """sid -> Record in, downsampled sid -> Record out (+ new schema).
    The device batches run on `device` (CUDA when None).

    Output rows carry the window START time (influx GROUP BY time
    convention); empty windows produce no rows.
    """
    t_start = _time.perf_counter_ns()
    field_aggs = field_aggs or {}
    aligned = int(winmod.window_start(tmin, every_ns))
    W = winmod.num_windows(aligned, tmax, every_ns)
    if W <= 0 or not series:
        return {}, dict(schema)
    sids = sorted(series)
    sid_ord = {sid: i for i, sid in enumerate(sids)}
    num_segments = len(sids) * W
    dtype = templates.compute_dtype()

    out_schema: dict[str, FieldType] = {}
    plan: dict[str, tuple] = {}  # field -> (spec, out_type)
    for name, ftype in schema.items():
        if ftype == FieldType.STRING:
            continue
        # lookup order: exact field name, then type name (the SQL surface's
        # `float(mean)` / `integer(sum)` ops map per-type — reference
        # CreateDownSampleStatement Ops), then the type default
        tname = {FieldType.FLOAT: "float", FieldType.INT: "integer",
                 FieldType.BOOL: "boolean"}.get(ftype, "")
        agg_name = (field_aggs.get(name) or field_aggs.get(tname)
                    or DEFAULT_TYPE_AGGS[ftype])
        spec = aggmod.get(agg_name)
        if spec.int_output:  # count-like
            out_type = FieldType.INT
        elif agg_name in ("mean", "stddev", "median", "percentile"):
            out_type = FieldType.FLOAT
        else:  # sum/min/max/first/last/spread preserve the input type
            out_type = ftype
        plan[name] = (spec, out_type)
        out_schema[name] = out_type

    # INT fields with type-preserving aggs go through an exact host int64
    # path: the f64 device dtype would silently corrupt integers > 2^53 in
    # a destructive rewrite. Float/derived fields use the device batch.
    host_fields = {
        name
        for name, (spec, out_type) in plan.items()
        if out_type == FieldType.INT and schema.get(name) == FieldType.INT
    }
    device = resolve_device(device)
    batches = {name: templates.AggBatch(dtype, device)
               for name in plan if name not in host_fields}
    host_results: dict[str, tuple[np.ndarray, np.ndarray]] = {
        name: (np.zeros(num_segments, np.int64), np.zeros(num_segments, np.int64))
        for name in host_fields
    }
    for sid in sids:
        rec = series[sid]
        if len(rec) == 0:
            continue
        widx, _ = winmod.window_index(rec.times, aligned, every_ns)
        seg64 = sid_ord[sid] * W + widx.astype(np.int64)
        seg = seg64.astype(np.int32)
        rel = rec.times - aligned
        for name, (spec, _ot) in plan.items():
            col = rec.columns.get(name)
            if col is None:
                continue
            if name in host_fields:
                out, counts = host_results[name]
                _host_int_agg(
                    spec.name, col.values, col.valid, seg64, out, counts
                )
            else:
                batches[name].add(col.values.astype(dtype), rel, seg, col.valid, rec.times)

    results = {}
    for name, (spec, _ot) in plan.items():
        if name in host_fields:
            results[name] = host_results[name]
        else:
            if getattr(batches[name], "supports_want_sel", False):
                # selector row indices are never consulted here (window
                # times render) — skip the selector lex-scan kernels
                out, _sel, counts = batches[name].run(
                    spec, num_segments, spec.params, want_sel=False)
            else:
                out, _sel, counts = batches[name].run(
                    spec, num_segments, spec.params)
            results[name] = (out, counts)

    window_times = aligned + np.arange(W, dtype=np.int64) * every_ns
    out_records: dict[int, Record] = {}
    for sid in sids:
        o = sid_ord[sid]
        row_mask = np.zeros(W, dtype=bool)
        for name in plan:
            _out, counts = results[name]
            row_mask |= counts[o * W : (o + 1) * W] > 0
        if not row_mask.any():
            continue
        times = window_times[row_mask]
        cols = {}
        for name, (spec, out_type) in plan.items():
            out, counts = results[name]
            seg_slice = slice(o * W, (o + 1) * W)
            vals = out[seg_slice][row_mask]
            valid = counts[seg_slice][row_mask] > 0
            if out_type == FieldType.INT:
                if vals.dtype != np.int64:  # device-computed count etc.
                    vals = np.round(vals).astype(np.int64)
            elif out_type == FieldType.BOOL:
                vals = vals.astype(np.bool_)
            else:
                vals = vals.astype(np.float64)
            cols[name] = Column(out_type, vals, valid)
        out_records[sid] = Record(times, cols)
    # aggregate compute time, distinct from the downsample_encode_ns /
    # downsample_write_ns split the TSF writer records (/debug/vars):
    # together they attribute a slow rewrite to compute vs encode vs IO
    _STATS.incr("downsample", "compute_ns",
                _time.perf_counter_ns() - t_start)
    _STATS.incr("downsample", "rows_out",
                sum(len(r) for r in out_records.values()))
    return out_records, out_schema
