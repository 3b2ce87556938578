"""Binary TSF chunk-meta codec (format v2).

The port of ``opengemini_tpu/storage/chunkmeta.py`` (the codec is pure
Python and the format shared, so it is a copy).

Reference: engine/immutable/chunk_meta_codec.go — the reference encodes
chunk metadata as packed binary so meta decode cost and memory stay flat
as chunk counts grow; the round-1 zlib-JSON meta decoded every value
into Python objects.  This codec writes the same logical content as the
JSON form in a length-prefixed binary layout and decodes with struct /
frombuffer, no JSON tree.

Layout (all little-endian; str = u16 len + utf8):
  u32 n_measurements
  per measurement:
    str name
    u16 n_fields; per field: str name, u8 ftype
    u32 n_chunks
    per chunk:
      u8 flags (bit0: packed, bit1: has sparse)
      if packed: u64 smin, u64 smax, u64 sid_off, u32 sid_len,
                 [u32 n_sparse; per entry u64 sid, u32 row]
      else:      u64 sid
      u32 rows; i64 tmin; i64 tmax; u64 time_off; u32 time_len
      u16 n_cols
      per col:
        u16 field_index
        u64 v_off, u32 v_len
        u8 has_mask; if set: u64 m_off, u32 m_len
        pre-agg: u32 count; u8 has_minmaxsum;
                 if set: f64 vmin, f64 vmax, f64 vsum
                 u8 n_hist; u32 hist[n_hist]

Pre-agg note: INT columns carry exact int sums in the JSON form; the
binary form stores f64 (2^53 cliff). Columns whose |vsum| exceeds 2^53
set has_minmaxsum=2 and append the three values as decimal strings,
keeping int-exactness.
"""

from __future__ import annotations

import struct

_EXACT_LIMIT = 1 << 53


def _pstr(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += struct.pack("<H", len(b))
    out += b


def _rstr(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off:off + n].decode("utf-8"), off + n


def encode_meta(meta: dict) -> bytes:
    """meta: the TSFWriter JSON-shaped dict
    {mst: {"schema": {field: int}, "chunks": [chunk json]}} -> bytes."""
    out = bytearray()
    out += struct.pack("<I", len(meta))
    for mst, m in meta.items():
        _pstr(out, mst)
        fields = list(m["schema"].items())
        findex = {name: i for i, (name, _t) in enumerate(fields)}
        out += struct.pack("<H", len(fields))
        for name, ftype in fields:
            _pstr(out, name)
            out += struct.pack("<B", int(ftype))
        chunks = m["chunks"]
        out += struct.pack("<I", len(chunks))
        for c in chunks:
            packed = bool(c.get("packed"))
            sparse = c.get("sparse") or []
            flags = (1 if packed else 0) | (2 if sparse else 0)
            out += struct.pack("<B", flags)
            if packed:
                out += struct.pack("<QQQI", c["smin"], c["smax"],
                                   c["sids"][0], c["sids"][1])
                if sparse:
                    out += struct.pack("<I", len(sparse))
                    for s_, row in sparse:
                        out += struct.pack("<QI", s_, row)
            else:
                out += struct.pack("<Q", c["sid"])
            out += struct.pack("<IqqQI", c["rows"], c["tmin"], c["tmax"],
                               c["time"][0], c["time"][1])
            cols = c["cols"]
            out += struct.pack("<H", len(cols))
            for name, cc in cols.items():
                out += struct.pack("<H", findex[name])
                out += struct.pack("<QI", cc["v"][0], cc["v"][1])
                if cc["m"]:
                    out += struct.pack("<BQI", 1, cc["m"][0], cc["m"][1])
                else:
                    out += struct.pack("<B", 0)
                count, vmin, vmax, vsum, hist = cc["pre"]
                out += struct.pack("<I", count)
                if vmin is None:
                    out += struct.pack("<B", 0)
                elif (isinstance(vsum, int)
                      and (abs(vsum) > _EXACT_LIMIT
                           or abs(int(vmin)) > _EXACT_LIMIT
                           or abs(int(vmax)) > _EXACT_LIMIT)):
                    out += struct.pack("<B", 2)
                    _pstr(out, repr(vmin))
                    _pstr(out, repr(vmax))
                    _pstr(out, repr(vsum))
                else:
                    out += struct.pack("<Bddd", 1, float(vmin), float(vmax),
                                       float(vsum))
                    # int columns round-trip exactly below 2^53; flag the
                    # intness so decode restores int type
                    out += struct.pack(
                        "<B", 1 if isinstance(vsum, int) else 0)
                hist = hist or []
                out += struct.pack("<B", len(hist))
                for h in hist:
                    out += struct.pack("<I", h)
    return bytes(out)


def decode_meta(buf: bytes) -> dict:
    """bytes -> the same JSON-shaped dict encode_meta consumed."""
    off = 0
    (n_msts,) = struct.unpack_from("<I", buf, off)
    off += 4
    meta: dict = {}
    for _ in range(n_msts):
        mst, off = _rstr(buf, off)
        (n_fields,) = struct.unpack_from("<H", buf, off)
        off += 2
        fields = []
        schema = {}
        for _ in range(n_fields):
            name, off = _rstr(buf, off)
            (ftype,) = struct.unpack_from("<B", buf, off)
            off += 1
            fields.append(name)
            schema[name] = ftype
        (n_chunks,) = struct.unpack_from("<I", buf, off)
        off += 4
        chunks = []
        for _ in range(n_chunks):
            (flags,) = struct.unpack_from("<B", buf, off)
            off += 1
            c: dict = {}
            if flags & 1:
                smin, smax, s_off, s_len = struct.unpack_from("<QQQI", buf, off)
                off += 28
                c["packed"] = 1
                c["smin"], c["smax"] = smin, smax
                c["sids"] = [s_off, s_len]
                sparse = []
                if flags & 2:
                    (n_sp,) = struct.unpack_from("<I", buf, off)
                    off += 4
                    for _ in range(n_sp):
                        s_, row = struct.unpack_from("<QI", buf, off)
                        off += 12
                        sparse.append([s_, row])
                c["sparse"] = sparse
            else:
                (c["sid"],) = struct.unpack_from("<Q", buf, off)
                off += 8
            rows, tmin, tmax, t_off, t_len = struct.unpack_from(
                "<IqqQI", buf, off)
            off += 32
            c.update(rows=rows, tmin=tmin, tmax=tmax, time=[t_off, t_len])
            (n_cols,) = struct.unpack_from("<H", buf, off)
            off += 2
            cols = {}
            for _ in range(n_cols):
                (fi,) = struct.unpack_from("<H", buf, off)
                off += 2
                v_off, v_len = struct.unpack_from("<QI", buf, off)
                off += 12
                (has_mask,) = struct.unpack_from("<B", buf, off)
                off += 1
                mloc = None
                if has_mask:
                    m_off, m_len = struct.unpack_from("<QI", buf, off)
                    off += 12
                    mloc = [m_off, m_len]
                (count,) = struct.unpack_from("<I", buf, off)
                off += 4
                (pre_kind,) = struct.unpack_from("<B", buf, off)
                off += 1
                vmin = vmax = vsum = None
                if pre_kind == 1:
                    vmin, vmax, vsum = struct.unpack_from("<ddd", buf, off)
                    off += 24
                    (is_int,) = struct.unpack_from("<B", buf, off)
                    off += 1
                    if is_int:
                        vmin, vmax, vsum = int(vmin), int(vmax), int(vsum)
                elif pre_kind == 2:
                    s1, off = _rstr(buf, off)
                    s2, off = _rstr(buf, off)
                    s3, off = _rstr(buf, off)
                    vmin, vmax, vsum = int(s1), int(s2), int(s3)
                (n_hist,) = struct.unpack_from("<B", buf, off)
                off += 1
                hist = None
                if n_hist:
                    hist = list(struct.unpack_from(f"<{n_hist}I", buf, off))
                    off += 4 * n_hist
                cols[fields[fi]] = {
                    "v": [v_off, v_len], "m": mloc,
                    "pre": [count, vmin, vmax, vsum, hist],
                }
            c["cols"] = cols
            chunks.append(c)
        meta[mst] = {"schema": schema, "chunks": chunks}
    return meta
