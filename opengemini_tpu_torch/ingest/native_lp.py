"""Columnar form of a parsed write: the container the engine's columnar
write path takes.

The port keeps its own copy of ``ColumnarBatch`` from
``opengemini_tpu/ingest/native_lp.py``; the ctypes line-protocol parser
that fills it there is not part of this slice (``convert.load_columnar``
builds batches from numpy arrays, and ``Engine.write_lines`` parses with
the Python parser). ``LineWriter`` goes the other way: it writes a
batch's rows back as line-protocol text (native/lpformat.cpp), which is
what the bulk load logs to the WAL, as the reference's columnar write
logs the text it parsed.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from opengemini_tpu_torch import native
from opengemini_tpu_torch.ingest.line_protocol import _esc_key
from opengemini_tpu_torch.record import FieldType


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


# LineWriter.lines: formatting threads, and the fewest rows worth one
_THREADS = min(8, os.cpu_count() or 1)
_MIN_PART = 8192


def _blob(pieces: list[bytes]) -> tuple[bytes, np.ndarray]:
    off = np.zeros(len(pieces) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in pieces], out=off[1:])
    return b"".join(pieces), off


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
                pieces = []
                for s, o in zip(values.tolist(), ok.tolist()):
                    if not o:
                        pieces.append(b"")
                        continue
                    if "\n" in s:
                        raise ValueError(
                            f"string field {name!r} holds a newline")
                    pieces.append(('"' + s.replace("\\", "\\\\")
                                   .replace('"', '\\"') + '"').encode())
                v, off = _blob(pieces)
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
