"""OTLP metrics ingest (ExportMetricsServiceRequest subset).

Schema (opentelemetry-proto, metrics/v1 + common/v1):
    ExportMetricsServiceRequest { repeated ResourceMetrics resource_metrics = 1; }
    ResourceMetrics { Resource resource = 1; repeated ScopeMetrics scope_metrics = 2; }
    Resource        { repeated KeyValue attributes = 1; }
    ScopeMetrics    { repeated Metric metrics = 2; }
    Metric          { string name = 1; ... Gauge gauge = 5; Sum sum = 7;
                      Histogram histogram = 9; Summary summary = 11; }
    Gauge/Sum       { repeated NumberDataPoint data_points = 1; }
    Histogram       { repeated HistogramDataPoint data_points = 1; }
    NumberDataPoint { repeated KeyValue attributes = 7;
                      fixed64 time_unix_nano = 3;
                      double as_double = 4; sfixed64 as_int = 6; }
    HistogramDataPoint { repeated KeyValue attributes = 9;
                      fixed64 time_unix_nano = 3; fixed64 count = 4;
                      double sum = 5; repeated double bucket_counts(pack) = 6;
                      repeated double explicit_bounds(pack) = 7; }
    KeyValue        { string key = 1; AnyValue value = 2; }
    AnyValue        { string_value=1 | bool_value=2 | int_value=3 |
                      double_value=4 | ... }

Mapping (reference lib/opentelemetry via otel2influx, handler_otlp.go):
metric name -> measurement; resource + datapoint attributes -> tags;
gauge datapoints -> field `gauge`, sum -> `counter`, histogram ->
`count`/`sum` fields plus one `bucket` series per bound (le tag) —
the prometheus-style schema the query layer already understands.
"""

from __future__ import annotations

import struct

from opengemini_tpu_torch.ingest import protowire as pw
from opengemini_tpu_torch.record import FieldType


def _any_value(buf: bytes):
    for fnum, wt, val in pw.fields(buf):
        if fnum == 1:
            return val.decode("utf-8", "replace")
        if fnum == 2:
            return "true" if val else "false"
        if fnum == 3:
            return str(pw.as_int64(val))
        if fnum == 4:
            return repr(pw.as_double(wt, val))
    return ""


def _attributes(bufs: list[bytes]) -> list[tuple[str, str]]:
    out = []
    for buf in bufs:
        key, value = "", ""
        for fnum, _wt, val in pw.fields(buf):
            if fnum == 1:
                key = val.decode("utf-8", "replace")
            elif fnum == 2:
                value = _any_value(val)
        if key:
            out.append((key, value))
    return out


def _number_point(buf: bytes):
    """-> (attrs, t_ns, value) of one NumberDataPoint."""
    attrs, t_ns, value = [], 0, None
    for fnum, wt, val in pw.fields(buf):
        if fnum == 7:
            attrs.append(val)
        elif fnum == 3:
            t_ns = val
        elif fnum == 4:
            value = pw.as_double(wt, val)
        elif fnum == 6:
            value = float(struct.unpack("<q", struct.pack("<Q", val))[0])
    return _attributes(attrs), t_ns, value


def _histogram_point(buf: bytes):
    attrs, t_ns = [], 0
    count = None
    hsum = None
    bucket_counts: list[int] = []
    bounds: list[float] = []
    for fnum, wt, val in pw.fields(buf):
        if fnum == 9:
            attrs.append(val)
        elif fnum == 3:
            t_ns = val
        elif fnum == 4:
            count = val if wt == 0 else int(val)
        elif fnum == 5:
            hsum = pw.as_double(wt, val)
        elif fnum == 6:  # packed fixed64 counts
            bucket_counts = [
                struct.unpack_from("<Q", val, i)[0]
                for i in range(0, len(val), 8)
            ]
        elif fnum == 7:  # packed doubles
            bounds = [
                struct.unpack_from("<d", val, i)[0]
                for i in range(0, len(val), 8)
            ]
    return _attributes(attrs), t_ns, count, hsum, bucket_counts, bounds


def decode_metrics_request(body: bytes) -> list:
    """-> engine points [(measurement, tags_tuple, t_ns, fields_dict)]."""
    points = []
    for f1, _w1, rm in pw.fields(body):
        if f1 != 1:
            continue
        resource_attrs: list[tuple[str, str]] = []
        scope_bufs = []
        for f2, _w2, val in pw.fields(rm):
            if f2 == 1:  # Resource
                for f3, _w3, rv in pw.fields(val):
                    if f3 == 1:
                        resource_attrs.extend(_attributes([rv]))
            elif f2 == 2:
                scope_bufs.append(val)
        for sm in scope_bufs:
            for f3, _w3, metric in pw.fields(sm):
                if f3 != 2:
                    continue
                name = ""
                gauges, sums, hists = [], [], []
                for f4, _w4, val in pw.fields(metric):
                    if f4 == 1:
                        name = val.decode("utf-8", "replace")
                    elif f4 == 5:  # Gauge
                        gauges += [v for fn, _w, v in pw.fields(val) if fn == 1]
                    elif f4 == 7:  # Sum
                        sums += [v for fn, _w, v in pw.fields(val) if fn == 1]
                    elif f4 == 9:  # Histogram
                        hists += [v for fn, _w, v in pw.fields(val) if fn == 1]
                if not name:
                    continue

                def tags_of(attrs):
                    merged = dict(resource_attrs)
                    merged.update(attrs)
                    return tuple(sorted(merged.items()))

                for buf, field in ((b, "gauge") for b in gauges):
                    attrs, t_ns, v = _number_point(buf)
                    if v is not None:
                        points.append((name, tags_of(attrs), t_ns,
                                       {field: (FieldType.FLOAT, v)}))
                for buf in sums:
                    attrs, t_ns, v = _number_point(buf)
                    if v is not None:
                        points.append((name, tags_of(attrs), t_ns,
                                       {"counter": (FieldType.FLOAT, v)}))
                for buf in hists:
                    attrs, t_ns, count, hsum, bcounts, bounds = \
                        _histogram_point(buf)
                    flds = {}
                    if count is not None:
                        flds["count"] = (FieldType.FLOAT, float(count))
                    if hsum is not None:
                        flds["sum"] = (FieldType.FLOAT, hsum)
                    if flds:
                        points.append((name, tags_of(attrs), t_ns, flds))
                    cum = 0
                    for i, bc in enumerate(bcounts):
                        cum += bc
                        le = (repr(bounds[i]) if i < len(bounds) else "+Inf")
                        tags = tags_of(attrs + [("le", le)])
                        points.append((name, tags, t_ns,
                                       {"bucket": (FieldType.FLOAT, float(cum))}))
    return points
