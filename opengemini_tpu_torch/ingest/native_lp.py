"""Columnar form of a parsed write: the container the engine's columnar
write path takes.

The port keeps its own copy of ``ColumnarBatch`` from
``opengemini_tpu/ingest/native_lp.py``; the ctypes line-protocol parser
that fills it there is not part of this slice (``convert.load_columnar``
builds batches from numpy arrays, and ``Engine.write_lines`` parses with
the Python parser).
"""

from __future__ import annotations


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
