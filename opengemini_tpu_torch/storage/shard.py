"""Shard: a time-ranged slice of one database/RP — memtable + series index.

The port of ``opengemini_tpu/storage/shard.py``, memtable only: it keeps
the point and columnar write paths (``write_points``, ``write_columnar``
/ ``_apply_columnar``), the schemas, the series index and the two scan
reads the executor uses (``read_series``, ``read_series_bulk``). The
WAL, TSF flush and read, the decoded-column cache, the scan pool and
file quarantine are not part of this slice, so a shard lives in memory.
"""

from __future__ import annotations

import threading

import numpy as np

from opengemini_tpu_torch.index.inverted import SeriesIndex
from opengemini_tpu_torch.record import FieldTypeConflict, Record, merge_bulk_parts
from opengemini_tpu_torch.storage.memtable import MemTable


class Shard:
    def __init__(self, tmin: int, tmax: int):
        self.tmin = tmin  # inclusive ns
        self.tmax = tmax  # exclusive ns
        self.index = SeriesIndex()
        # measurement -> field -> FieldType; shared with the memtable
        self.schemas: dict[str, dict] = {}
        self.mem = MemTable(self.schemas)
        self._lock = threading.RLock()

    # -- write path ---------------------------------------------------------

    def write_points(self, points: list) -> int:
        """Apply pre-parsed (measurement, tags, t_ns, fields) points in
        this shard's range. Raises FieldTypeConflict before any row
        applies."""
        with self._lock:
            self._check_types(points)
            return self._apply(points)

    def write_columnar(self, batch, rows: np.ndarray | None) -> int:
        """Apply a ColumnarBatch (ingest/native_lp.py). `rows` selects this
        shard's row indices (None = all rows). Type conflicts raise before
        any row applies."""
        with self._lock:
            self._check_columnar_types(batch, rows)
            return self._apply_columnar(batch, rows=rows)

    def _check_columnar_types(self, batch, rows) -> None:
        pending: dict[tuple[int, str], object] = {}
        for mst_id, name, ftype, _values, valid in batch.cols:
            sel = valid if rows is None else valid[rows]
            if not sel.any():
                continue
            mst = batch.measurements[mst_id]
            schema = self.schemas.get(mst, {})
            have = schema.get(name) or pending.get((mst_id, name))
            if have is None:
                pending[(mst_id, name)] = ftype
            elif have != ftype:
                raise FieldTypeConflict(name, have, ftype)

    def _resolve_sids(self, batch, refs: np.ndarray) -> np.ndarray:
        """Map unique series refs -> sids via the series index (new series
        register here). Returns an array indexed by ref."""
        sid_by_ref = np.zeros(len(batch.series_keys), np.int64)
        for ref in refs:
            sid_by_ref[ref] = self.index.get_or_create_by_key(
                batch.series_keys[int(ref)])
        return sid_by_ref

    def _apply_columnar(self, batch, rows: np.ndarray | None = None) -> int:
        """Memtable-apply the batch's selected rows (per-measurement slab
        appends). Rows outside [tmin, tmax) are filtered here."""
        ts = batch.ts if rows is None else batch.ts[rows]
        in_range = (ts >= self.tmin) & (ts < self.tmax)
        if not in_range.all():
            rows = (np.flatnonzero(in_range) if rows is None
                    else rows[in_range])
            ts = batch.ts[rows]
        if len(ts) == 0:
            return 0
        refs = batch.series_ref if rows is None else batch.series_ref[rows]
        sid_by_ref = self._resolve_sids(batch, np.unique(refs))
        sids = sid_by_ref[refs]
        row_mst = batch.series_mst[refs]
        n = 0
        for mst_id in np.unique(row_mst):
            mst = batch.measurements[int(mst_id)]
            sel = row_mst == mst_id
            all_rows = sel.all()
            idx = None if all_rows else np.flatnonzero(sel)
            cols = {}
            for c_mst, name, ftype, values, valid in batch.cols:
                if c_mst != mst_id:
                    continue
                v = values if rows is None else values[rows]
                ok = valid if rows is None else valid[rows]
                if not all_rows:
                    v, ok = v[idx], ok[idx]
                if ok.any():
                    cols[name] = (ftype, v, ok)
            m_sids = sids if all_rows else sids[idx]
            m_ts = ts if all_rows else ts[idx]
            self.mem.write_columnar(mst, m_sids, m_ts, cols)
            n += len(m_ts)
        return n

    def _check_types(self, points: list) -> None:
        pending: dict[str, dict] = {}
        for mst, _tags, _t, fields in points:
            schema = self.schemas.get(mst, {})
            batch_schema = pending.setdefault(mst, {})
            for name, (ftype, _v) in fields.items():
                have = schema.get(name) or batch_schema.get(name)
                if have is None:
                    batch_schema[name] = ftype
                elif have != ftype:
                    raise FieldTypeConflict(name, have, ftype)

    def _apply(self, points: list) -> int:
        n = 0
        for mst, tags, t, fields in points:
            sid = self.index.get_or_create(mst, tags)
            self.mem.write_row(sid, mst, t, fields)
            n += 1
        return n

    # -- read side ----------------------------------------------------------

    def mem_time_range(self) -> tuple[int | None, int | None]:
        """(min, max) ns of the memtable (None = no rows)."""
        return self.mem.min_time, self.mem.max_time

    def measurements(self) -> list[str]:
        return sorted(self.index.measurements())

    def schema(self, measurement: str) -> dict:
        return dict(self.schemas.get(measurement, {}))

    def read_series(self, measurement: str, sid: int,
                    tmin: int | None = None, tmax: int | None = None,
                    fields: list[str] | None = None) -> Record:
        """One series' rows, deduped last-wins, then time-sliced."""
        mem_rec = self.mem.record_for(sid)
        if mem_rec is None:
            return Record.empty()
        if fields is not None:
            mem_rec = Record(
                mem_rec.times,
                {k: v for k, v in mem_rec.columns.items() if k in fields})
        if tmin is not None or tmax is not None:
            lo = tmin if tmin is not None else -(2**63)
            hi = tmax if tmax is not None else 2**63 - 1
            mem_rec = mem_rec.slice_time(lo, hi)
        return mem_rec

    def read_series_bulk(self, measurement: str, sids: np.ndarray,
                         tmin: int | None = None, tmax: int | None = None,
                         fields: list[str] | None = None,
                         ) -> tuple[np.ndarray, Record]:
        """Batched multi-series read: (sid_column, record) for every
        requested series, rows grouped by sid and time-sorted within a
        sid, last-write-wins deduped."""
        sids = np.asarray(sorted(int(s) for s in sids), dtype=np.int64)
        lo_t = tmin if tmin is not None else -(2**63)
        hi_t = tmax if tmax is not None else 2**63 - 1
        parts = []
        for sid_arr, mem_rec in self.mem.bulk_parts(measurement, sids):
            if fields is not None:
                mem_rec = Record(
                    mem_rec.times,
                    {k: v for k, v in mem_rec.columns.items()
                     if k in fields})
            parts.append((sid_arr, mem_rec))
        return merge_bulk_parts(parts, lo_t, hi_t)
