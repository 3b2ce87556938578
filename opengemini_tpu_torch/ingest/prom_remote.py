"""Prometheus remote write/read protobuf codecs.

Schema (prompb, stable since prometheus 2.x):
    WriteRequest { repeated TimeSeries timeseries = 1; }
    TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
    Label        { string name = 1; string value = 2; }
    Sample       { double value = 1; int64 timestamp = 2; }  # ms

    ReadRequest  { repeated Query queries = 1; }
    Query        { int64 start_timestamp_ms = 1; int64 end_timestamp_ms = 2;
                   repeated LabelMatcher matchers = 3; }
    LabelMatcher { Type type = 1 (EQ/NEQ/RE/NRE); string name = 2;
                   string value = 3; }
    ReadResponse { repeated QueryResult results = 1; }
    QueryResult  { repeated TimeSeries timeseries = 1; }

Mapping (reference handler_prom_util.go timeSeries2Rows): __name__ label
is the measurement, remaining labels are tags, the sample value lands in
the float field `value`, timestamps convert ms -> ns.
"""

from __future__ import annotations

import struct

from opengemini_tpu_torch.ingest import protowire as pw
from opengemini_tpu_torch.record import FieldType

DEFAULT_MEASUREMENT = "prom_metric_not_specified"
VALUE_FIELD = "value"
MS = 1_000_000


def _decode_label(buf: bytes) -> tuple[str, str]:
    name = value = ""
    for fnum, _wt, val in pw.fields(buf):
        if fnum == 1:
            name = val.decode("utf-8")
        elif fnum == 2:
            value = val.decode("utf-8")
    return name, value


def decode_write_request(body: bytes) -> list:
    """-> engine points [(measurement, tags_tuple, t_ns, {field: (type, v)})]."""
    points = []
    for fnum, _wt, ts_buf in pw.fields(body):
        if fnum != 1:
            continue
        labels = []
        samples = []
        for f2, wt2, val in pw.fields(ts_buf):
            if f2 == 1:
                labels.append(_decode_label(val))
            elif f2 == 2:
                v = t_ms = None
                for f3, wt3, sval in pw.fields(val):
                    if f3 == 1:
                        v = pw.as_double(wt3, sval)
                    elif f3 == 2:
                        t_ms = pw.as_int64(sval)
                if v is not None and t_ms is not None:
                    samples.append((t_ms, v))
        mst = DEFAULT_MEASUREMENT
        tags = []
        for name, value in labels:
            if name == "__name__":
                mst = value
            else:
                tags.append((name, value))
        tags_t = tuple(sorted(tags))
        for t_ms, v in samples:
            points.append(
                (mst, tags_t, t_ms * MS, {VALUE_FIELD: (FieldType.FLOAT, v)})
            )
    return points


def decode_read_request(body: bytes) -> list[dict]:
    """-> [{start_ms, end_ms, matchers: [(op, name, value)]}] where op is
    '=', '!=', '=~' or '!~'."""
    ops = {0: "=", 1: "!=", 2: "=~", 3: "!~"}
    queries = []
    for fnum, _wt, qbuf in pw.fields(body):
        if fnum != 1:
            continue
        q = {"start_ms": 0, "end_ms": 0, "matchers": []}
        for f2, _wt2, val in pw.fields(qbuf):
            if f2 == 1:
                q["start_ms"] = pw.as_int64(val)
            elif f2 == 2:
                q["end_ms"] = pw.as_int64(val)
            elif f2 == 3:
                mtype, name, value = 0, "", ""
                for f3, _wt3, mval in pw.fields(val):
                    if f3 == 1:
                        mtype = mval
                    elif f3 == 2:
                        name = mval.decode("utf-8")
                    elif f3 == 3:
                        value = mval.decode("utf-8")
                q["matchers"].append((ops.get(mtype, "="), name, value))
        queries.append(q)
    return queries


# -- encoding (remote read responses) ---------------------------------------


def _emit_len(fnum: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_read_response(results: list) -> bytes:
    """results: [[(labels_dict, [(t_ms, value)])]] — one entry per query."""
    out = bytearray()
    for series_list in results:
        qr = bytearray()
        for labels, samples in series_list:
            ts = bytearray()
            for name in sorted(labels):
                label_msg = (_emit_len(1, name.encode("utf-8"))
                             + _emit_len(2, labels[name].encode("utf-8")))
                ts += _emit_len(1, label_msg)
            for t_ms, v in samples:
                sample_msg = (
                    _varint((1 << 3) | 1) + struct.pack("<d", v)
                    + _varint((2 << 3) | 0) + _varint(t_ms & ((1 << 64) - 1))
                )
                ts += _emit_len(2, sample_msg)
            qr += _emit_len(1, bytes(ts))
        out += _emit_len(1, bytes(qr))
    return bytes(out)
