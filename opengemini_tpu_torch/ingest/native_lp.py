"""The native line-protocol parser and the columnar form of a write.

The port of ``opengemini_tpu/ingest/native_lp.py``: ``parse_columnar``
is a ctypes binding over the repository's ``native/lineproto.cpp`` (the
/write hot path, ``Engine.write_lines``), which parses a body into a
``ColumnarBatch``: numpy value and validity arrays per (measurement,
field), a deduplicated table of canonical series keys, and int64
timestamps, so the storage layer appends whole slabs. The port builds
the library with g++ into ``build/native/`` at first use
(``native.load_lineproto``); unlike the reference, which falls back to
the Python parser when the library is missing, a failed build raises.
``parse_columnar`` returns None only where the reference's does for a
built library: a batch the exact Python parser must take (escape
sequences, '_' digit separators, pathological widths).

``LineWriter`` goes the other way: it writes a batch's rows back as
line-protocol text (native/lpformat.cpp, the port's own), which is what
the bulk load (``convert.load_columnar``) logs to the WAL, as a parsed
write logs the text it parsed.
"""

from __future__ import annotations

import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from opengemini_tpu_torch import native
from opengemini_tpu_torch.ingest.line_protocol import (
    PRECISIONS, ParseError, _esc_key,
)
from opengemini_tpu_torch.record import FieldType


class _LpBatch(ctypes.Structure):
    """ogt_lp_parse's result (native/lineproto.cpp ``LpBatch``)."""

    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("ts", ctypes.POINTER(ctypes.c_int64)),
        ("series_ref", ctypes.POINTER(ctypes.c_int32)),
        ("n_series", ctypes.c_int64),
        ("skey_off", ctypes.POINTER(ctypes.c_int64)),
        ("skey_arena", ctypes.POINTER(ctypes.c_char)),
        ("series_mst", ctypes.POINTER(ctypes.c_int32)),
        ("n_msts", ctypes.c_int32),
        ("mst_off", ctypes.POINTER(ctypes.c_int64)),
        ("mst_arena", ctypes.POINTER(ctypes.c_char)),
        ("n_cols", ctypes.c_int32),
        ("col_name_off", ctypes.POINTER(ctypes.c_int64)),
        ("col_name_arena", ctypes.POINTER(ctypes.c_char)),
        ("col_mst", ctypes.POINTER(ctypes.c_int32)),
        ("col_type", ctypes.POINTER(ctypes.c_int8)),
        ("col_vals", ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))),
        ("col_valid", ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))),
        ("str_arena", ctypes.POINTER(ctypes.c_char)),
        ("str_arena_len", ctypes.c_int64),
        ("status", ctypes.c_int32),
        ("err_line", ctypes.c_int64),
        ("err_msg", ctypes.c_char * 240),
    ]


class ColumnarBatch:
    """One parsed /write body in columnar form.

    ts[i], series_ref[i] describe row i; series_keys[series_ref[i]] is its
    canonical series key (identical bytes to line_protocol.series_key).
    cols is [(mst_id, field_name, FieldType, values, valid)] where values
    and valid are dense over ALL rows (rows of other measurements are
    simply invalid).
    """

    __slots__ = ("ts", "series_ref", "series_keys", "series_mst",
                 "measurements", "cols")

    def __init__(self, ts, series_ref, series_keys, series_mst,
                 measurements, cols):
        self.ts = ts
        self.series_ref = series_ref
        self.series_keys = series_keys
        self.series_mst = series_mst
        self.measurements = measurements
        self.cols = cols

    def __len__(self) -> int:
        return len(self.ts)

    def row_mst(self) -> np.ndarray:
        """Measurement id per row."""
        return self.series_mst[self.series_ref]

    def to_points(self) -> list:
        """Rebuild (measurement, tags, t_ns, fields) tuples, the shape
        the point write path takes."""
        from opengemini_tpu_torch.index.inverted import parse_series_key

        tag_cache = [None] * len(self.series_keys)

        def series_tuple(ref: int):
            cached = tag_cache[ref]
            if cached is None:
                cached = tag_cache[ref] = parse_series_key(
                    self.series_keys[ref])
            return cached

        per_row_fields: list[dict] = [dict() for _ in range(len(self.ts))]
        row_mst = self.row_mst()
        for mst_id, name, ftype, values, valid in self.cols:
            for r in np.flatnonzero(valid & (row_mst == mst_id)):
                v = values[r]
                if ftype == FieldType.FLOAT:
                    v = float(v)
                elif ftype == FieldType.INT:
                    v = int(v)
                elif ftype == FieldType.BOOL:
                    v = bool(v)
                per_row_fields[r][name] = (ftype, v)
        out = []
        for i in range(len(self.ts)):
            mst, tags = series_tuple(int(self.series_ref[i]))
            out.append((mst, tags, int(self.ts[i]), per_row_fields[i]))
        return out


def keys_read_back(keys: list) -> bool:
    """Whether one line per key parses back to exactly these keys (a
    batch's WAL entry is its line-protocol text, and the replay parses
    it). The native parser is the line parser's equal (storage/engine.py
    logs a /write body it parsed natively, and its replay parses it in
    Python)."""
    from opengemini_tpu_torch.ingest import line_protocol as lp

    if not keys:
        return True
    text = "".join(k + " value=0 0\n" for k in keys).encode()
    try:
        got = parse_columnar(text, "ns", 0)
    except lp.ParseError:
        return False
    return got is not None and got.series_keys == keys


_POINT_DTYPES = {FieldType.FLOAT: np.float64, FieldType.INT: np.int64,
                 FieldType.BOOL: np.bool_}


def points_batch(points: list):
    """Structured points (measurement, tags, t_ns, {field: (type, v)})
    as one ColumnarBatch, rows in order, for the engine's columnar write
    (Engine.write_batch, whose WAL entry is the batch's line protocol);
    None where the point path must take them: a string field, a float
    that is not finite, one field with two types, a point without a
    field, or a series key that does not read back from line protocol as
    itself."""
    from opengemini_tpu_torch.ingest.line_protocol import series_key

    keys: list[str] = []
    ref_of: dict = {}
    msts: list[str] = []
    mst_id: dict[str, int] = {}
    series_mst: list[int] = []
    refs = np.empty(len(points), np.int64)
    ts = np.empty(len(points), np.int64)
    cols: dict[tuple, list] = {}  # (mst id, name) -> [type, rows, values]
    for i, (mst, tags, t, fields) in enumerate(points):
        r = ref_of.get((mst, tags))
        if r is None:
            r = ref_of[(mst, tags)] = len(keys)
            keys.append(series_key(mst, tags))
            m = mst_id.get(mst)
            if m is None:
                m = mst_id[mst] = len(msts)
                msts.append(mst)
            series_mst.append(m)
        refs[i] = r
        ts[i] = t
        m = series_mst[r]
        if not fields:
            return None
        for name, (ftype, v) in fields.items():
            col = cols.get((m, name))
            if col is None:
                if ftype not in _POINT_DTYPES:
                    return None
                col = cols[(m, name)] = [ftype, [], []]
            elif col[0] != ftype:
                return None
            col[1].append(i)
            col[2].append(v)
    out = []
    for (m, name), (ftype, rows, vals) in cols.items():
        values = np.zeros(len(points), _POINT_DTYPES[ftype])
        valid = np.zeros(len(points), np.bool_)
        values[rows] = vals
        valid[rows] = True
        if ftype == FieldType.FLOAT and not np.isfinite(values[valid]).all():
            return None
        out.append((m, name, ftype, values, valid))
    if not keys_read_back(keys):
        return None
    return ColumnarBatch(ts, refs, keys, np.asarray(series_mst, np.int64),
                         msts, out)


def _offsets_to_strings(arena_ptr, off: np.ndarray) -> list[str]:
    if len(off) <= 1:
        return []
    blob = ctypes.string_at(arena_ptr, int(off[-1])) if off[-1] else b""
    return [blob[off[i]:off[i + 1]].decode("utf-8", errors="replace")
            for i in range(len(off) - 1)]


def _copy_arr(ptr, n: int, dtype) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer(ctypes.string_at(ptr, n * itemsize),
                         dtype=dtype).copy()


def parse_columnar(data: bytes, precision: str = "ns",
                   now_ns: int | None = None,
                   max_bytes: int = 512 << 20) -> ColumnarBatch | None:
    """Parse a line-protocol body natively. Returns None when the body
    needs the exact Python parser; raises ParseError on malformed input
    (the messages and line numbers of native/lineproto.cpp), as
    line_protocol.parse_lines does, and RuntimeError when the library
    does not build."""
    lib = native.load_lineproto()
    mult = PRECISIONS.get(precision)
    if mult is None:
        raise ValueError(f"invalid precision {precision!r}")
    if now_ns is None:
        now_ns = time.time_ns()
    if isinstance(data, str):
        data = data.encode("utf-8")
    bp = lib.ogt_lp_parse(data, len(data), mult, now_ns, max_bytes)
    if not bp:
        return None
    try:
        b = bp.contents
        if b.status == 1:  # needs the exact Python parser
            return None
        if b.status == 2:
            raise ParseError(int(b.err_line),
                             b.err_msg.decode("utf-8", errors="replace"))
        n = int(b.n_rows)
        ts = _copy_arr(b.ts, n, np.int64)
        series_ref = _copy_arr(b.series_ref, n, np.int32)
        skey_off = _copy_arr(b.skey_off, int(b.n_series) + 1, np.int64)
        series_keys = _offsets_to_strings(b.skey_arena, skey_off)
        series_mst = _copy_arr(b.series_mst, int(b.n_series), np.int32)
        mst_off = _copy_arr(b.mst_off, int(b.n_msts) + 1, np.int64)
        measurements = _offsets_to_strings(b.mst_arena, mst_off)
        name_off = _copy_arr(b.col_name_off, int(b.n_cols) + 1, np.int64)
        col_names = _offsets_to_strings(b.col_name_arena, name_off)
        col_mst = _copy_arr(b.col_mst, int(b.n_cols), np.int32)
        col_type = _copy_arr(b.col_type, int(b.n_cols), np.int8)
        str_blob = (ctypes.string_at(b.str_arena, int(b.str_arena_len))
                    if b.str_arena_len else b"")
        cols = []
        for c in range(int(b.n_cols)):
            slots = _copy_arr(b.col_vals[c], n, np.int64)
            valid = _copy_arr(b.col_valid[c], n, np.uint8).astype(np.bool_)
            t = int(col_type[c])
            if t == 1:
                values = slots.view(np.float64)
                ftype = FieldType.FLOAT
            elif t == 2:
                values = slots
                ftype = FieldType.INT
            elif t == 3:
                values = slots.astype(np.bool_)
                ftype = FieldType.BOOL
            else:
                ftype = FieldType.STRING
                values = np.empty(n, dtype=object)
                offs = (slots >> 32).astype(np.int64)
                lens = (slots & 0xFFFFFFFF).astype(np.int64)
                for r in np.flatnonzero(valid):
                    o, ln = int(offs[r]), int(lens[r])
                    values[r] = str_blob[o:o + ln].decode(
                        "utf-8", errors="replace")
            cols.append((int(col_mst[c]), col_names[c], ftype, values, valid))
        return ColumnarBatch(ts, series_ref, series_keys, series_mst,
                             measurements, cols)
    finally:
        lib.ogt_lp_free(bp)


# LineWriter.lines: formatting threads, and the fewest rows worth one
_THREADS = min(8, os.cpu_count() or 1)
_MIN_PART = 8192


def _blob(pieces: list[bytes]) -> tuple[bytes, np.ndarray]:
    off = np.zeros(len(pieces) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in pieces], out=off[1:])
    return b"".join(pieces), off


def _quoted(values, ok: np.ndarray, name: str) -> tuple[bytes, np.ndarray]:
    """A string column's valid values, each quoted and escaped as a line
    holds it, as one blob and its offsets (an invalid row's piece is
    empty). Values that need no escaping and are ASCII, as base64 text
    is, are joined in one pass; any other column goes value by value."""
    strs = np.asarray(values, dtype=object)[ok.view(np.bool_)].tolist()
    try:
        text = "".join(strs)
    except TypeError:
        text = None
    if (text is not None and text.isascii() and "\n" not in text
            and "\\" not in text and '"' not in text):
        off = np.zeros(len(ok) + 1, dtype=np.int64)
        lens = np.zeros(len(ok), dtype=np.int64)
        lens[ok.view(np.bool_)] = np.fromiter(
            map(len, strs), np.int64, len(strs)) + 2
        np.cumsum(lens, out=off[1:])
        return ('"' + '""'.join(strs) + '"').encode() if strs else b"", off
    pieces = []
    for s, o in zip(values.tolist(), ok.tolist()):
        if not o:
            pieces.append(b"")
            continue
        if "\n" in s:
            raise ValueError(f"string field {name!r} holds a newline")
        pieces.append(('"' + s.replace("\\", "\\\\")
                       .replace('"', '\\"') + '"').encode())
    return _blob(pieces)


class LineWriter:
    """Line-protocol text of a ColumnarBatch's rows, one line per row in
    ns precision, which ``line_protocol.parse_lines`` reads back to the
    same points (floats in their shortest round-trip form). A row must
    have at least one valid field; a series key or string value holding a
    newline cannot be written as a line and raises ValueError."""

    def __init__(self, batch: ColumnarBatch):
        if any("\n" in k for k in batch.series_keys):
            raise ValueError("a series key holds a newline")
        self._keys, self._key_off = _blob(
            [k.encode() for k in batch.series_keys])
        self._ts = np.ascontiguousarray(batch.ts, dtype=np.int64)
        self._ref = np.ascontiguousarray(batch.series_ref, dtype=np.int64)
        self._keep = []  # the arrays the pointers below point into
        self._str_bytes = 0  # every string value, quoted
        types, vals, valid, prefix, plen, str_off = [], [], [], [], [], []
        for _mst, name, ftype, values, ok in batch.cols:
            ok = np.ascontiguousarray(ok, dtype=np.bool_).view(np.uint8)
            off = None
            if ftype == FieldType.FLOAT:
                v = np.ascontiguousarray(values, dtype=np.float64)
            elif ftype == FieldType.INT:
                v = np.ascontiguousarray(values, dtype=np.int64)
            elif ftype == FieldType.BOOL:
                v = np.ascontiguousarray(values, dtype=np.bool_).view(
                    np.uint8)
            else:
                v, off = _quoted(values, ok, name)
                v = np.frombuffer(v, dtype=np.uint8)
                self._str_bytes += len(v)
            pre = (_esc_key(name) + "=").encode()
            self._keep += [v, ok, pre, off]
            types.append(int(ftype))
            vals.append(v.ctypes.data)
            valid.append(ok.ctypes.data)
            prefix.append(pre)
            plen.append(len(pre))
            str_off.append(None if off is None else off.ctypes.data)
        n_cols = len(types)
        self._n_cols = n_cols
        self._types = np.asarray(types, dtype=np.int32)
        self._vals = (ctypes.c_void_p * n_cols)(*vals)
        self._valid = (ctypes.c_void_p * n_cols)(*valid)
        self._prefix = (ctypes.c_char_p * n_cols)(*prefix)
        self._plen = np.asarray(plen, dtype=np.int64)
        self._str_off = (ctypes.c_void_p * n_cols)(*str_off)
        # bytes a line may take beyond its string values, with room to
        # spare for the formatter's checks: key, separators, the fields
        # (at most 25 for a number), the timestamp
        self._fixed = (int(np.diff(self._key_off).max(initial=0)) + 64
                       + int(self._plen.sum()) + 40 * n_cols)

    def lines(self, rows: np.ndarray) -> bytes:
        """The text of `rows` (indices into the batch), newline-separated.
        Large selections are formatted in parts on several threads (the
        native call releases the GIL) and joined."""
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        k = min(_THREADS, len(rows) // _MIN_PART)
        if k <= 1:
            return self._format(rows).tobytes()
        with ThreadPoolExecutor(max_workers=k) as pool:
            return b"\n".join(pool.map(self._format,
                                       np.array_split(rows, k)))

    def _format(self, rows: np.ndarray) -> np.ndarray:
        cap = len(rows) * self._fixed + self._str_bytes
        out = np.empty(max(cap, 1), dtype=np.uint8)
        got = native.load_lpformat().ogt_lp_format(
            len(rows), rows.ctypes.data, self._ts.ctypes.data,
            self._ref.ctypes.data, self._keys, self._key_off.ctypes.data,
            self._n_cols, self._types.ctypes.data, self._vals, self._valid,
            self._prefix, self._plen.ctypes.data, self._str_off,
            out.ctypes.data, cap)
        if got < 0:
            raise RuntimeError("line-protocol buffer too small")
        return out[:got]
