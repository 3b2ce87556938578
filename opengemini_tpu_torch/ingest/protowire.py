"""Minimal protobuf wire-format reader + snappy block decompressor.

The remote-write and OTLP ingest paths need to DECODE two well-known
protobuf schemas (prometheus WriteRequest, OTLP ExportMetricsService
Request) and snappy-framed bodies.  The image has no python-snappy and
codegen would pin us to vendored .proto files, so both are implemented
directly against the stable wire formats:
  - protobuf encoding: https://protobuf.dev/programming-guides/encoding/
  - snappy block format: google/snappy format_description.txt
(reference consumes github.com/golang/snappy + gogo protobuf:
lib/util/lifted/influx/httpd/handler_prom.go:33).
"""

from __future__ import annotations

import struct


class WireError(ValueError):
    pass


def read_varint(buf: bytes, off: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if off >= len(buf):
            raise WireError("truncated varint")
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message body.
    value: int for varint(0)/fixed64(1)/fixed32(5), bytes for len(2)."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = read_varint(buf, off)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, off = read_varint(buf, off)
        elif wt == 1:
            if off + 8 > n:
                raise WireError("truncated fixed64")
            (val,) = struct.unpack_from("<Q", buf, off)
            off += 8
        elif wt == 2:
            ln, off = read_varint(buf, off)
            if off + ln > n:
                raise WireError("truncated bytes field")
            val = buf[off:off + ln]
            off += ln
        elif wt == 5:
            if off + 4 > n:
                raise WireError("truncated fixed32")
            (val,) = struct.unpack_from("<I", buf, off)
            off += 4
        else:
            raise WireError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def as_double(wt: int, val) -> float:
    if wt == 1:
        return struct.unpack("<d", struct.pack("<Q", val))[0]
    raise WireError("expected fixed64 double")


def as_sint64(val: int) -> int:
    """zigzag-decoded varint."""
    return (val >> 1) ^ -(val & 1)


def as_int64(val: int) -> int:
    """two's-complement varint (protobuf int64)."""
    return val - (1 << 64) if val >= (1 << 63) else val


# ---------------------------------------------------------------------------
# snappy block format (decompression only)


def snappy_compress_literal(data: bytes) -> bytes:
    """Valid snappy block encoding that stores everything as literals
    (no back-references).  Fine for responses: correctness over ratio."""
    out = bytearray()
    # uncompressed length varint
    v = len(data)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    off = 0
    n = len(data)
    while off < n:
        chunk = min(n - off, 1 << 24)
        ln = chunk - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out.append(ln)
        elif ln < (1 << 16):
            out.append(61 << 2)
            out += ln.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += ln.to_bytes(3, "little")
        out += data[off:off + chunk]
        off += chunk
    return bytes(out)


def snappy_uncompress(data: bytes) -> bytes:
    """Decompress a raw snappy block (the format prometheus remote write
    bodies use — NOT the framing/stream format)."""
    if not data:
        return b""
    ulen, off = read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while off < n:
        tag = data[off]
        off += 1
        ttype = tag & 3
        if ttype == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if off + extra > n:
                    raise WireError("truncated literal length")
                ln = int.from_bytes(data[off:off + extra], "little")
                off += extra
            ln += 1
            if off + ln > n:
                raise WireError("truncated literal")
            out += data[off:off + ln]
            off += ln
            continue
        if ttype == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            if off >= n:
                raise WireError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[off]
            off += 1
        elif ttype == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            if off + 2 > n:
                raise WireError("truncated copy2")
            offset = int.from_bytes(data[off:off + 2], "little")
            off += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            if off + 4 > n:
                raise WireError("truncated copy4")
            offset = int.from_bytes(data[off:off + 4], "little")
            off += 4
        if offset == 0 or offset > len(out):
            raise WireError("bad copy offset")
        # overlapping copies are legal and the common RLE idiom
        start = len(out) - offset
        for i in range(ln):
            out.append(out[start + i])
    if len(out) != ulen:
        raise WireError(f"snappy length mismatch: {len(out)} != {ulen}")
    return bytes(out)
