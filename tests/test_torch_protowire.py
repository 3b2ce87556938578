"""The port's protobuf wire reader, snappy block codec, Prometheus remote
write/read codecs and OTLP metrics decoder against the JAX package's, on
the same bytes: every decoded point, query and byte must be equal, and a
truncated or malformed body must raise the same error class with the
same message in both.

The encoders below build the request bodies (prompb WriteRequest and
ReadRequest, OTLP ExportMetricsServiceRequest); the HTTP tests import
them too."""

import struct

import numpy as np
import pytest

from opengemini_tpu.ingest import otlp as jotlp
from opengemini_tpu.ingest import prom_remote as jpr
from opengemini_tpu.ingest import protowire as jpw
from opengemini_tpu_torch.ingest import otlp as totlp
from opengemini_tpu_torch.ingest import prom_remote as tpr
from opengemini_tpu_torch.ingest import protowire as tpw

BASE_MS = 1_700_000_000_000


# -- encoders -----------------------------------------------------------------


def varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_len(fnum: int, payload: bytes) -> bytes:
    return varint((fnum << 3) | 2) + varint(len(payload)) + payload


def pb_double(fnum: int, v: float) -> bytes:
    return varint((fnum << 3) | 1) + struct.pack("<d", v)


def pb_fixed64(fnum: int, v: int) -> bytes:
    return varint((fnum << 3) | 1) + struct.pack("<Q", v)


def pb_varint(fnum: int, v: int) -> bytes:
    return varint(fnum << 3) + varint(v)


def write_request(series) -> bytes:
    """series: [(labels dict, [(t_ms, value)])] -> prompb WriteRequest."""
    out = b""
    for labels, samples in series:
        ts = b""
        for n, v in labels.items():
            ts += pb_len(1, pb_len(1, n.encode()) + pb_len(2, v.encode()))
        for t_ms, val in samples:
            ts += pb_len(2, pb_double(1, val) + pb_varint(2, t_ms))
        out += pb_len(1, ts)
    return out


def read_request(queries) -> bytes:
    """queries: [(start_ms, end_ms, [(type 0-3, name, value)])]."""
    out = b""
    for start, end, matchers in queries:
        q = pb_varint(1, start) + pb_varint(2, end)
        for mtype, name, value in matchers:
            q += pb_len(3, pb_varint(1, mtype) + pb_len(2, name.encode())
                        + pb_len(3, value.encode()))
        out += pb_len(1, q)
    return out


def _kv(key: str, any_value: bytes) -> bytes:
    return pb_len(1, key.encode()) + pb_len(2, any_value)


def otlp_request(resource: dict, metrics) -> bytes:
    """metrics: [(name, kind 'gauge'|'sum'|'hist', [point dict])]; a point
    holds attrs, t_ns and value (an int value goes as_int), or count,
    sum, counts and bounds for a histogram."""
    mbufs = b""
    for name, kind, points in metrics:
        body = b""
        for p in points:
            attrs = b"".join(
                pb_len(7 if kind != "hist" else 9,
                       _kv(k, pb_len(1, v.encode())))
                for k, v in p.get("attrs", {}).items())
            if kind == "hist":
                dp = (attrs + pb_fixed64(3, p["t_ns"])
                      + pb_fixed64(4, p["count"]) + pb_double(5, p["sum"])
                      + pb_len(6, b"".join(struct.pack("<Q", c)
                                           for c in p["counts"]))
                      + pb_len(7, b"".join(struct.pack("<d", b)
                                           for b in p["bounds"])))
            elif isinstance(p["value"], int):
                dp = attrs + pb_fixed64(3, p["t_ns"]) + pb_fixed64(
                    6, p["value"] & ((1 << 64) - 1))
            else:
                dp = attrs + pb_fixed64(3, p["t_ns"]) + pb_double(
                    4, p["value"])
            body += pb_len(1, dp)
        fnum = {"gauge": 5, "sum": 7, "hist": 9}[kind]
        mbufs += pb_len(2, pb_len(1, name.encode()) + pb_len(fnum, body))
    res = b"".join(pb_len(1, _kv(k, pb_len(1, v.encode())))
                   for k, v in resource.items())
    return pb_len(1, pb_len(1, res) + pb_len(2, mbufs))


# -- helpers --------------------------------------------------------------------


def _norm(x):
    """Floats as their bit patterns (NaN equals NaN), enums as ints."""
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    if isinstance(x, int):
        return int(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _outcome(fn, *args):
    """(True, value) or (False, (error class name, message))."""
    try:
        return True, _norm(fn(*args))
    except Exception as e:  # noqa: BLE001 — the class is what we compare
        return False, (type(e).__name__, str(e))


def _same(jfn, tfn, *args):
    got, want = _outcome(tfn, *args), _outcome(jfn, *args)
    assert got == want, (got, want)
    return got


def _random_series(rng, n_series=12, n_samples=30):
    out = []
    for i in range(n_series):
        labels = {"__name__": f"m{i % 3}", "host": f"h{i}",
                  "region": f"r{i % 4}"}
        if i % 5 == 0:
            labels.pop("region")
        t = BASE_MS + np.cumsum(rng.integers(1, 20_000, n_samples))
        v = rng.normal(0, 1e6, n_samples)
        v[rng.random(n_samples) < 0.05] = np.nan
        v[rng.random(n_samples) < 0.02] = np.inf
        out.append((labels, [(int(a), float(b)) for a, b in zip(t, v)]))
    out.append(({"job": "nameless"}, [(BASE_MS, 1.0)]))
    return out


# -- snappy ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 59, 60, 61, 255, 256, 65_536, 70_001])
def test_snappy_literal_roundtrip(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    comp = tpw.snappy_compress_literal(data)
    assert comp == jpw.snappy_compress_literal(data)
    assert _same(jpw.snappy_uncompress, tpw.snappy_uncompress, comp) == (
        True, data)


def test_snappy_copies_match():
    # a hand-made stream: literal "abcd", copy1 (len 4, off 4), copy2
    # (len 8, off 8), copy4 (len 4, off 4)
    lit = bytes([(4 - 1) << 2]) + b"abcd"
    copy1 = bytes([0x01 | ((4 - 4) << 2), 4])
    copy2 = bytes([0x02 | ((8 - 1) << 2)]) + struct.pack("<H", 8)
    copy4 = bytes([0x03 | ((4 - 1) << 2)]) + struct.pack("<I", 4)
    stream = varint(20) + lit + copy1 + copy2 + copy4
    ok, out = _same(jpw.snappy_uncompress, tpw.snappy_uncompress, stream)
    assert ok and out == b"abcd" * 5


@pytest.mark.parametrize("body", [
    b"",
    b"\x80",                              # truncated length varint
    varint(10) + bytes([(9 << 2)]) + b"abc",  # truncated literal
    varint(4) + bytes([0x01]),            # truncated copy1
    varint(4) + bytes([0x02, 0]),         # truncated copy2
    varint(4) + bytes([0x03, 0, 0]),      # truncated copy4
    varint(8) + bytes([0x01 | (4 << 2), 9]),  # copy before any output
    varint(9) + bytes([(3 << 2)]) + b"abcd",  # length mismatch
    varint(1) + bytes([0xF0]),            # long literal, length missing
    b"\xff" * 11,                         # varint too long
])
def test_snappy_malformed_same_error(body):
    _same(jpw.snappy_uncompress, tpw.snappy_uncompress, body)


# -- the wire reader --------------------------------------------------------------


@pytest.mark.parametrize("buf", [
    pb_varint(1, 300) + pb_len(2, b"xyz") + pb_double(3, 2.5)
    + varint((4 << 3) | 5) + b"\x01\x02\x03\x04",
    varint((1 << 3) | 1) + b"\x00\x01",    # truncated fixed64
    varint((1 << 3) | 5) + b"\x00",        # truncated fixed32
    pb_len(1, b"abc")[:-1],               # truncated bytes field
    varint((1 << 3) | 3),                 # unsupported wire type
    varint(1 << 3) + b"\x80\x80",          # truncated varint
])
def test_fields_same_or_same_error(buf):
    _same(lambda b: list(jpw.fields(b)), lambda b: list(tpw.fields(b)), buf)


def test_scalar_helpers():
    for v in (0, 1, 2**63, 2**64 - 1, 12345):
        assert tpw.as_int64(v) == jpw.as_int64(v)
        assert tpw.as_sint64(v) == jpw.as_sint64(v)
    raw = struct.unpack("<Q", struct.pack("<d", -3.25))[0]
    assert tpw.as_double(1, raw) == jpw.as_double(1, raw)
    _same(jpw.as_double, tpw.as_double, 0, 5)


# -- prompb ---------------------------------------------------------------------


def test_write_request_decodes_alike():
    body = write_request(_random_series(np.random.default_rng(3)))
    ok, got = _same(jpr.decode_write_request, tpr.decode_write_request, body)
    assert ok and len(got) == 12 * 30 + 1
    # the name-less series lands in the reference's default measurement
    assert got[-1][0] == tpr.DEFAULT_MEASUREMENT == jpr.DEFAULT_MEASUREMENT
    assert tpr.VALUE_FIELD == jpr.VALUE_FIELD == "value"


def test_read_request_and_response_alike():
    body = read_request([
        (BASE_MS, BASE_MS + 60_000, [(0, "__name__", "m1"),
                                      (1, "host", "h2"),
                                      (2, "region", "r.*"),
                                      (3, "dc", "x|y"), (7, "odd", "op")]),
        (0, 1, []),
    ])
    ok, queries = _same(jpr.decode_read_request, tpr.decode_read_request,
                        body)
    assert ok and queries[0]["matchers"][4][0] == "="
    results = [[({"__name__": "m1", "host": "h1"},
                 [(BASE_MS, 1.5), (BASE_MS + 1, float("nan")),
                  (-5, float("-inf"))])], []]
    assert tpr.encode_read_response(results) == \
        jpr.encode_read_response(results)


@pytest.mark.parametrize("cut", [1, 3, 7, 20, -1])
def test_prompb_truncated_same_error(cut):
    body = write_request(_random_series(np.random.default_rng(5), 2, 3))
    _same(jpr.decode_write_request, tpr.decode_write_request, body[:cut])
    rbody = read_request([(1, 2, [(0, "__name__", "m")])])
    _same(jpr.decode_read_request, tpr.decode_read_request, rbody[:cut])


def test_prompb_bad_utf8_same_error():
    bad = pb_len(1, pb_len(1, pb_len(1, b"\xff\xfe") + pb_len(2, b"v")))
    _same(jpr.decode_write_request, tpr.decode_write_request, bad)


# -- OTLP -----------------------------------------------------------------------


def _otlp_body():
    t0 = BASE_MS * 1_000_000
    return otlp_request({"service": "svc1", "dc": "a"}, [
        ("cpu_temp", "gauge", [
            {"attrs": {"host": "h1"}, "t_ns": t0, "value": 42.5},
            {"attrs": {"host": "h2", "dc": "b"}, "t_ns": t0 + 1,
             "value": -7},
        ]),
        ("bytes_total", "sum", [{"attrs": {}, "t_ns": t0, "value": 1e18}]),
        ("latency", "hist", [{"attrs": {"route": "/q"}, "t_ns": t0,
                              "count": 6, "sum": 1.75,
                              "counts": [1, 2, 3], "bounds": [0.1, 0.5]}]),
        ("", "gauge", [{"t_ns": t0, "value": 1.0}]),
    ])


def test_otlp_decodes_alike():
    ok, got = _same(jotlp.decode_metrics_request,
                    totlp.decode_metrics_request, _otlp_body())
    assert ok and len(got) == 2 + 1 + 1 + 3


@pytest.mark.parametrize("cut", [2, 9, 40, -3])
def test_otlp_truncated_same_error(cut):
    _same(jotlp.decode_metrics_request, totlp.decode_metrics_request,
          _otlp_body()[:cut])
