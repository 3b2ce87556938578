"""Columnar memtable: per-series row builders + whole-batch column slabs.

Reference: engine/mutable/table.go:306 MemTable / MsInfo / WriteChunk.
Two write paths share one last-write-wins order:

- write_row: row-at-a-time appends (structured writes, WAL replay of
  structured entries, services) into per-sid RecordBuilders.
- write_columnar: whole numpy slabs straight from the native line-protocol
  parser (ingest hot path) — no per-row Python work at all.

Ordering contract: every slab gets a monotonically increasing rank;
builder rows are always NEWER than every slab that existed when they were
appended (they merge last), and when a new slab arrives for a sid that has
builder rows, those rows are first frozen into a slab so the total
(append-order) last-write-wins ordering is preserved exactly.
"""

from __future__ import annotations

import numpy as np

from opengemini_tpu_torch.record import (
    Column,
    FieldType,
    FieldTypeConflict,
    Record,
    RecordBuilder,
    merge_bulk_parts,
    merge_sorted_records,
)
from opengemini_tpu_torch.utils.failpoint import inject as _fp


def _series_slice(rec: Record, lo: int, hi: int) -> Record:
    """Per-series view of a (sid, time)-sorted bulk record. Columns the
    series never wrote (all-invalid in its range) are DROPPED so the
    per-series shape is identical to the row-builder path — content_digest
    and query schemas must not depend on which ingest path ran."""
    cols = {}
    for name, col in rec.columns.items():
        valid = col.valid[lo:hi]
        if valid.any():
            cols[name] = Column(col.ftype, col.values[lo:hi], valid)
    return Record(rec.times[lo:hi], cols)


class _Slab:
    """One columnar append: parallel (sids, times, columns) arrays."""

    __slots__ = ("mst", "sids", "times", "cols")

    def __init__(self, mst: str, sids: np.ndarray, times: np.ndarray,
                 cols: dict[str, Column]):
        self.mst = mst
        self.sids = sids
        self.times = times
        self.cols = cols


class MemTable:
    def __init__(self, schemas: dict[str, dict[str, FieldType]] | None = None) -> None:
        # sid -> builder
        self._builders: dict[int, RecordBuilder] = {}
        # measurement -> field -> type. SHARED with (and owned by) the shard:
        # schema outlives memtable generations, otherwise a type-changing
        # write after a flush slips through and corrupts the merge.
        self.schemas: dict[str, dict[str, FieldType]] = (
            schemas if schemas is not None else {}
        )
        # sid -> measurement
        self._sid_mst: dict[int, str] = {}
        # measurement -> [slab] in append (last-write-wins) order
        self._slabs: dict[str, list[_Slab]] = {}
        self._slab_sids: dict[str, set[int]] = {}
        # measurement -> (slab_count, (sid_sorted, Record)) cache. The
        # count guards against the LOST-ACK race: readers call
        # _consolidate WITHOUT the shard lock, so a reader that computed
        # a consolidation of N slabs can store it back AFTER a writer
        # appended slab N+1 and popped the cache — a stale entry that
        # hides the newest slab.  For reads that is transient staleness,
        # but flush consumes measurement_tables() -> _consolidate on the
        # FROZEN memtable: a stale hit there writes a TSF missing the
        # last acked batch, whose rows then vanish with the snapshot and
        # its WAL segment.  Slab lists only ever grow within a memtable
        # generation, so a count captured before compute and re-checked
        # at lookup detects every stale entry.
        self._consolidated: dict[str, tuple[int, tuple[np.ndarray, Record]]] = {}
        self.row_count = 0
        self.approx_bytes = 0
        self.min_time: int | None = None
        self.max_time: int | None = None
        # frozen = an immutable flush snapshot (shard.flush swapped a
        # fresh memtable in and encodes this one OFF the shard lock):
        # reads may come from several threads, writes must never land
        self.frozen = False

    def freeze(self) -> None:
        """Mark immutable (flush snapshot). Any later write is a bug in
        the caller's locking — fail loudly instead of corrupting the
        snapshot a concurrent flush is encoding."""
        _fp("memtable-freeze")
        self.frozen = True

    def _check_mutable(self) -> None:
        if self.frozen:
            raise RuntimeError("write to a frozen memtable (flush snapshot)")

    # -- row path -----------------------------------------------------------

    def write_row(self, sid: int, measurement: str, t: int, fields: dict) -> None:
        self._check_mutable()
        schema = self.schemas.setdefault(measurement, {})
        for name, (ftype, _v) in fields.items():
            have = schema.get(name)
            if have is None:
                schema[name] = ftype
            elif have != ftype:
                raise FieldTypeConflict(name, have, ftype)
        b = self._builders.get(sid)
        if b is None:
            b = RecordBuilder()
            self._builders[sid] = b
            self._sid_mst[sid] = measurement
        b.append_row(t, fields)
        self.row_count += 1
        self.approx_bytes += 32 + 16 * len(fields)
        if self.min_time is None or t < self.min_time:
            self.min_time = t
        if self.max_time is None or t > self.max_time:
            self.max_time = t

    # -- columnar path ------------------------------------------------------

    def write_columnar(self, measurement: str, sids: np.ndarray,
                       times: np.ndarray,
                       cols: dict[str, tuple[FieldType, np.ndarray, np.ndarray]]) -> None:
        """Append one slab: sids/times int64[n], cols name ->
        (ftype, values[n], valid[n]). Arrays are owned by the memtable
        after the call (no copies are taken)."""
        n = len(times)
        if n == 0:
            return
        self._check_mutable()
        schema = self.schemas.setdefault(measurement, {})
        for name, (ftype, _v, _ok) in cols.items():
            have = schema.get(name)
            if have is None:
                schema[name] = ftype
            elif have != ftype:
                raise FieldTypeConflict(name, have, ftype)

        # freeze builder rows of the slab's sids first: the new slab must
        # rank NEWER than them (total append order)
        touched = [int(s) for s in np.unique(sids) if int(s) in self._builders]
        for sid in touched:
            self._freeze_builder(sid)

        col_objs = {
            name: Column(ftype, values, valid)
            for name, (ftype, values, valid) in cols.items()
        }
        slab = _Slab(measurement, np.asarray(sids, np.int64),
                     np.asarray(times, np.int64), col_objs)
        self._slabs.setdefault(measurement, []).append(slab)
        sset = self._slab_sids.setdefault(measurement, set())
        new_sids = np.unique(slab.sids)
        for s in new_sids:
            si = int(s)
            sset.add(si)
            self._sid_mst.setdefault(si, measurement)
        self._consolidated.pop(measurement, None)
        self.row_count += n
        self.approx_bytes += slab.times.nbytes + slab.sids.nbytes + sum(
            (c.values.nbytes if c.values.dtype != object else 32 * n) + n
            for c in col_objs.values()
        )
        tmin = int(slab.times.min())
        tmax = int(slab.times.max())
        if self.min_time is None or tmin < self.min_time:
            self.min_time = tmin
        if self.max_time is None or tmax > self.max_time:
            self.max_time = tmax

    def _freeze_builder(self, sid: int) -> None:
        """Convert one builder's rows into a single-sid slab, preserving
        their rank in the append order."""
        b = self._builders.pop(sid)
        if len(b) == 0:
            return
        rec = b.sorted_record()
        mst = self._sid_mst[sid]
        slab = _Slab(mst, np.full(len(rec), sid, np.int64), rec.times,
                     dict(rec.columns))
        self._slabs.setdefault(mst, []).append(slab)
        self._slab_sids.setdefault(mst, set()).add(sid)
        self._consolidated.pop(mst, None)

    def _consolidate(self, measurement: str) -> tuple[np.ndarray, Record]:
        """Merged view of the measurement's slabs: rows sorted (sid, time),
        deduped last-wins across slabs. Cached until the next write; the
        cache entry records how many slabs it covers and a lookup only
        hits when that count still matches (see __init__ — a stale store
        from an unlocked reader must never mask a newer slab)."""
        slabs = self._slabs.get(measurement, [])
        n = len(slabs)  # capture BEFORE compute: racing appends miss
        cached = self._consolidated.get(measurement)
        if cached is not None and cached[0] == n:
            return cached[1]
        parts = [(s.sids, Record(s.times, s.cols)) for s in slabs[:n]]
        out = merge_bulk_parts(parts, -(2**63), 2**63 - 1)
        # a site between compute and store: a wait: action here replays
        # the interleaving the count guard above makes harmless
        _fp("memtable-consolidate-before-store")
        self._consolidated[measurement] = (n, out)
        return out

    def _slab_record(self, sid: int) -> Record | None:
        mst = self._sid_mst.get(sid)
        if mst is None or sid not in self._slab_sids.get(mst, ()):
            return None
        sid_arr, rec = self._consolidate(mst)
        lo = int(np.searchsorted(sid_arr, sid, "left"))
        hi = int(np.searchsorted(sid_arr, sid, "right"))
        if lo == hi:
            return None
        return _series_slice(rec, lo, hi)

    # -- read side ----------------------------------------------------------

    def sids_for(self, measurement: str) -> set[int]:
        """Live series ids of one measurement — O(series), no record
        builds (hot-path pruning uses this, not series_records)."""
        out = {sid for sid, m in self._sid_mst.items()
               if m == measurement and sid in self._builders}
        out |= self._slab_sids.get(measurement, set())
        return out

    def measurement_tables(self):
        """Yield (measurement, sid_arr, Record) bulk views: rows sorted by
        (sid, time), last-write-wins deduped — the flush path (and bulk
        readers) consume these without per-series dict churn."""
        msts = set(self._slabs)
        msts.update(self._sid_mst[sid] for sid in self._builders)
        for mst in sorted(msts):
            parts = []
            if self._slabs.get(mst):
                parts.append(self._consolidate(mst))
            for sid, b in self._builders.items():
                if self._sid_mst.get(sid) == mst and len(b):
                    rec = b.build()
                    parts.append((np.full(len(rec), sid, np.int64), rec))
            sid_arr, rec = merge_bulk_parts(parts, -(2**63), 2**63 - 1)
            if len(rec):
                yield mst, sid_arr, rec

    def series_records(self) -> dict[int, tuple[str, Record]]:
        """sid -> (measurement, sorted+deduped Record)."""
        out: dict[int, tuple[str, Record]] = {}
        for mst, sid_arr, rec in self.measurement_tables():
            uniq, starts = np.unique(sid_arr, return_index=True)
            ends = np.append(starts[1:], len(sid_arr))
            for sid, lo, hi in zip(uniq, starts, ends):
                out[int(sid)] = (mst, _series_slice(rec, lo, hi))
        return out

    def bulk_parts(self, measurement: str,
                   sids: np.ndarray | None = None) -> list:
        """[(sid_arr, Record)] parts for a bulk read, oldest first (slab
        consolidation first, builder rows after — builders are newer by
        the freeze rule). `sids` (sorted int64) filters rows."""
        parts = []
        if self._slabs.get(measurement):
            sid_arr, rec = self._consolidate(measurement)
            if sids is not None and len(sid_arr):
                mask = np.isin(sid_arr, sids)
                if not mask.all():
                    idx = np.flatnonzero(mask)
                    sid_arr = sid_arr[idx]
                    rec = rec.take(idx)
            if len(rec):
                parts.append((sid_arr, rec))
        if self._builders:
            sid_set = None if sids is None else set(int(s) for s in sids)
            for sid, b in self._builders.items():
                if (self._sid_mst.get(sid) == measurement and len(b)
                        and (sid_set is None or sid in sid_set)):
                    rec = b.sorted_record()
                    parts.append((np.full(len(rec), sid, np.int64), rec))
        return parts

    def record_for(self, sid: int) -> Record | None:
        srec = self._slab_record(sid)
        b = self._builders.get(sid)
        brec = (b.sorted_record()
                if b is not None and len(b) else None)
        if srec is None:
            return brec
        if brec is None:
            return srec
        # builder rows are newer than every slab (freeze rule) -> merge last
        return merge_sorted_records([srec, brec])

    @property
    def backlog_bytes(self) -> int:
        """Estimated resident bytes of this (live or frozen) memtable —
        the unit the resource governor's unified ledger and the write
        backpressure watermark account in (utils/governor.py).  Same
        estimate the flush threshold uses (approx_bytes), exposed under
        one name so every accounting site agrees."""
        return self.approx_bytes

    def __len__(self) -> int:
        return self.row_count
