"""Shard: a time-ranged slice of one database/RP — WAL + memtable +
immutable TSF files + series index.

The port of ``opengemini_tpu/storage/shard.py``: the same directory
layout (``wal.log`` and its rotated segments, ``NNNNNNNN.tsf`` files,
the mergeset series index under ``seriesidx/``), so either package
reopens a shard the other wrote. It keeps the point and columnar write
paths with their WAL logging, WAL replay (with salvage of interior
damage), the snapshot-and-swap flush into TSF files, the two scan reads
the executor uses (``read_series``, ``read_series_bulk``) over files,
frozen flush snapshots and the live memtable, which consult the
decoded-column cache (storage/colcache.py) before they dispatch a
decode, and compaction (``compact``, ``compact_level``,
``compact_out_of_order``): a merge off the shard's locks and a
revalidated swap of the file set, which drops the retired files' cache
entries.

Every write logs its rows' time range with a new ``data_version``
(``_note_mutation``; ``changed_since`` answers for a range), which the
incremental result cache keys on; flush and compaction keep both.

The data lifecycle and media damage:

- **Delete rewrite** (``delete_data``): a whole measurement, a set of
  series or a time range. It flushes, reads every measurement through
  the bulk read, writes the surviving rows into one file (and its
  sidecar), swaps the file set, retires the old files and only then bumps
  the mutation log; a full-series delete also drops the series from the
  index and an emptied schema.
- **Quarantine**: a file that fails to open (bad magic, trailer or meta
  CRC), or whose block CRC fails mid-scan (``note_corrupt``), leaves the
  read set with a durable ``<file>.tsf.quar`` marker ({"why": ...}), so
  it stays out across reopens; the scan that found it fails with
  ``FileQuarantined`` and a retry answers from the other files. A
  damaged compaction input is quarantined the same way, so the next
  compaction proceeds. ``purge_quarantined`` deletes the files, markers
  and sidecars.
- **Text-index sidecars** (``<file>.tidx``, JSON: measurement -> string
  field -> token -> sids), written by the flush, compaction and the
  delete rewrite and removed with their file; ``text_match_sids`` reads
  them to prune the series a ``match()`` term cannot hit.
- **Failpoints** (utils/failpoint.py) on the flush, compaction and
  quarantine steps, under the reference's site names.
- **Downsample rewrite** (``rewrite_downsampled``, storage/
  downsample.py): the shard's rows at a coarser resolution, swapped in
  like the delete rewrite.
- **Backlog** (``mem_backlog_bytes``): the memtables and the live WAL,
  the resource governor's write watermark input.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import threading
import time

import numpy as np

from opengemini_tpu_torch.index.mergeset import open_series_index
from opengemini_tpu_torch.ingest import line_protocol as lp
from opengemini_tpu_torch.record import (
    Column, FieldTypeConflict, Record, _zeroed, merge_bulk_parts,
    merge_sorted_records,
)
from opengemini_tpu_torch.storage import colcache, scanpool
from opengemini_tpu_torch.storage.memtable import MemTable, _series_slice
from opengemini_tpu_torch.storage.tsf import (
    PACK_MIN_SERIES, PACK_ROWS, CorruptFile, TSFReader, TSFWriter,
)
from opengemini_tpu_torch.storage.wal import WAL, WALCorruption, frame
from opengemini_tpu_torch.utils.failpoint import inject as _fp
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

# process-wide versions: see Shard.data_version and Shard.cache_ns
_DATA_VERSIONS = itertools.count(1)
_MUT_LOG_MAX = 512  # bounded mutation history; overflow = assume-changed


def _pack_entries(buffer: list) -> tuple[np.ndarray, Record]:
    """[(sid, rec)] (sid-ascending, per-rec time-sorted) -> one PK-sorted
    packed block: sid column + union-schema field columns (absent fields
    pad invalid)."""
    total = sum(len(rec) for _sid, rec in buffer)
    sids = np.concatenate(
        [np.full(len(rec), sid, np.int64) for sid, rec in buffer])
    times = np.concatenate([rec.times for _sid, rec in buffer])
    ftypes: dict[str, object] = {}
    for _sid, rec in buffer:
        for name, col in rec.columns.items():
            ftypes.setdefault(name, col.ftype)
    cols = {}
    for name, ftype in ftypes.items():
        # zero-init: garbage in invalid slots would persist into packed
        # chunks
        values = _zeroed(ftype, total)
        valid = np.zeros(total, dtype=np.bool_)
        at = 0
        for _sid, rec in buffer:
            n = len(rec)
            col = rec.columns.get(name)
            if col is not None:
                values[at:at + n] = col.values
                valid[at:at + n] = col.valid
            at += n
        cols[name] = Column(ftype, values, valid)
    return sids, Record(times, cols)


def _sid_entries(rec: Record, uniq, starts, ends):
    """(sid, per-series Record) views over one (sid, time)-sorted bulk
    table — the flush path's bridge from memtable tables to chunks."""
    for sid, lo, hi in zip(uniq, starts, ends):
        yield int(sid), _series_slice(rec, lo, hi)


def _write_measurement_chunks(w: TSFWriter, tidx: "_TextSidecar", mst: str,
                              entries, n_series: int) -> int:
    """Write one measurement's series records, and index their string
    fields into `tidx`: per-sid chunks at low cardinality, PK-sorted
    packed chunks once a flush carries >= PACK_MIN_SERIES series.
    `entries` iterates (sid, rec) in ascending sid order; packed chunks
    stream out every PACK_ROWS rows (a series never splits across two).
    Returns rows submitted to the writer."""
    rows = 0
    if n_series < PACK_MIN_SERIES:
        for sid, rec in entries:
            w.add_chunk(mst, sid, rec)
            tidx.add(mst, sid, rec)
            rows += len(rec)
        return rows
    buffer: list = []
    buffered = 0
    for sid, rec in entries:
        if len(rec) == 0:
            continue
        tidx.add(mst, sid, rec)
        buffer.append((sid, rec))
        buffered += len(rec)
        rows += len(rec)
        if buffered >= PACK_ROWS:
            sids, packed = _pack_entries(buffer)
            w.add_packed_chunk(mst, sids, packed)
            buffer, buffered = [], 0
    if buffer:
        sids, packed = _pack_entries(buffer)
        w.add_packed_chunk(mst, sids, packed)
    return rows


class FileQuarantined(Exception):
    """A read hit media damage in an immutable file: the file is
    quarantined (out of the read set, durable `.quar` marker) and this
    query failed before any wrong value was produced. The next query
    over the shard skips the file."""

    def __init__(self, path: str, why: str):
        super().__init__(
            f"file quarantined after media fault: {path}: {why}")
        self.path = path
        self.why = why


def _keep_fields(rec: Record, fields) -> Record:
    if fields is None:
        return rec
    return Record(rec.times,
                  {k: v for k, v in rec.columns.items() if k in fields})


class Shard:
    supports_preagg = True  # chunk metadata is local: pre-agg and sketches

    def __init__(self, path: str, tmin: int, tmax: int,
                 sync_wal: bool = False):
        self.path = path
        self.tmin = tmin  # inclusive ns
        self.tmax = tmax  # exclusive ns
        os.makedirs(path, exist_ok=True)
        self.index = open_series_index(path)
        # logical-content version, drawn from a process-global counter
        # so a (path, version) pair never repeats: every write bumps it
        # (the device tier of the decoded-column cache keys on it), and
        # the bounded mutation log keeps each write's time range, so the
        # incremental result cache (query/resultcache.py) drops only the
        # windows a write touched. Flush and compaction change the
        # layout, not the merged rows, and bump neither
        self.data_version = next(_DATA_VERSIONS)
        self._mut_floor = self.data_version  # history unknown at/below
        self._mutations: list[tuple[int, int, int]] = []
        # decoded-column cache namespace: a process-unique shard id
        # stamped onto every reader this shard opens, so cache keys
        # identify (shard, file, chunk) even when a recreated shard
        # reuses a path
        self.cache_ns = next(_DATA_VERSIONS)
        # measurement -> field -> FieldType; owned here so it survives
        # memtable generations and is seeded from the files on open
        self.schemas: dict[str, dict] = {}
        self.mem = MemTable(self.schemas)
        self._lock = threading.RLock()
        # flush serialization. Lock ORDER: _flush_lock before _lock —
        # flush holds _flush_lock across its off-lock encode and takes
        # _lock only to freeze and to publish
        self._flush_lock = threading.RLock()
        # snapshot-and-swap flush state: (frozen memtable, rotated WAL
        # segment | None), oldest first. Readers merge frozen snapshots
        # between the files and the live memtable until the TSF that
        # holds their rows is published. An immutable tuple replaced on
        # every change, so a reader snapshots it with one attribute read.
        self._frozen: tuple[tuple[MemTable, str | None], ...] = ()
        self._wal_seg_seq = 1
        # rotated segments found at open (crash between publish and
        # segment removal) or left by a failed flush: the next
        # successful flush removes them
        self._stale_wal_segs: list[str] = []
        self._files: list[TSFReader] = []
        self._tidx_cache: dict[str, object] = {}  # tsf path -> parsed | None
        self._next_file_seq = 1
        # media-damaged files pulled out of the read set: path -> why.
        # The `.quar` markers keep quarantine sticky across reopens; the
        # file stays on disk until purge_quarantined
        self._quarantined: dict[str, str] = {}
        self._load_files()
        for r in self._files:
            for mst in r.measurements():
                self.schemas.setdefault(mst, {}).update(r.schema(mst))
        # replay BEFORE opening the live WAL handle: salvage may rewrite
        # wal.log on disk
        self._replay_wal()
        self.wal = WAL(os.path.join(path, "wal.log"), sync=sync_wal)

    def _load_files(self) -> None:
        # crash leftovers: a .tmp that never reached its os.replace
        for f in os.listdir(self.path):
            if f.endswith((".merge", ".tmp")):
                try:
                    os.remove(os.path.join(self.path, f))
                except OSError:
                    pass
        names = sorted(f for f in os.listdir(self.path) if f.endswith(".tsf"))
        for name in names:
            # the sequence advances past every file, quarantined or not:
            # a later flush must never reuse a damaged file's name
            seq = int(name.split(".")[0])
            self._next_file_seq = max(self._next_file_seq, seq + 1)
            full = os.path.join(self.path, name)
            marker = _quar_marker(full)
            if os.path.exists(marker):
                try:
                    with open(marker, encoding="utf-8") as f:
                        why = json.load(f).get("why", "marker present")
                except (OSError, ValueError):
                    why = "marker present"
                self._quarantined[full] = why
                continue
            try:
                reader = TSFReader(full)
            except CorruptFile as e:
                # a damaged trailer, meta or magic quarantines this one
                # file; the shard opens over the rest
                self._quarantine_path(full, e.why)
                continue
            self._files.append(self._adopt(reader))

    def _adopt(self, reader: TSFReader) -> TSFReader:
        """Stamp the shard's cache namespace onto a freshly opened
        reader (a decoded-column cache key component)."""
        reader.owner_ns = self.cache_ns
        return reader

    # -- quarantine -----------------------------------------------------------

    def _write_quar_marker(self, path: str, why: str) -> None:
        """Durable `.quar` marker, written and fsynced off the shard lock
        and idempotent (concurrent detectors rewrite the same marker)."""
        _fp("quarantine-before-mark")  # detected, marker not yet durable
        marker = _quar_marker(path)
        tmp = marker + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                # wall-clock record: operator forensics only
                json.dump({"why": why, "ts": time.time()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, marker)
        except OSError:
            pass  # the marker is a convenience; in-memory state governs

    def _record_quarantined(self, path: str, why: str) -> None:
        self._quarantined[path] = why
        _STATS.incr("quarantine", "tsf_files_total")
        logging.getLogger("opengemini_tpu_torch.shard").error(
            "quarantined TSF file %s: %s", path, why)

    def _quarantine_path(self, path: str, why: str) -> None:
        """Mark and record one file quarantined with no reader to swap
        out (the open path)."""
        self._write_quar_marker(path, why)
        self._record_quarantined(path, why)

    def quarantine_file(self, path: str, why: str) -> bool:
        """Pull a damaged file out of the read set. True when this call
        quarantined it (False: already quarantined, or not this shard's
        file). Queries mid-scan keep their readers (POSIX fds survive);
        every later scan snapshot excludes the file."""
        with self._lock:
            if not any(r.path == path for r in self._files):
                return False
        # the marker before the swap, off the shard lock: detection stays
        # sticky even if the process dies mid-quarantine
        self._write_quar_marker(path, why)
        with self._lock:
            idx = next((i for i, r in enumerate(self._files)
                        if r.path == path), None)
            if idx is None:
                return False  # another detector or a retire won the race
            reader = self._files[idx]
            self._record_quarantined(path, why)
            self._files = self._files[:idx] + self._files[idx + 1:]
            self._tidx_cache.pop(path, None)
            colcache.GLOBAL.invalidate_gens([reader.gen])
            # rows vanished: cached results over the file's range must
            # not mix with post-quarantine scans
            lo = reader.tmin if reader.tmin is not None else self.tmin
            hi = reader.tmax + 1 if reader.tmax is not None else self.tmax
            self._note_mutation(lo, hi)
        return True

    def note_corrupt(self, exc: CorruptFile):
        """Read-path handler: quarantine the damaged file and fail this
        query with FileQuarantined; a retry proceeds without the file."""
        self.quarantine_file(exc.path, exc.why)
        raise FileQuarantined(exc.path, exc.why) from exc

    def quarantined(self) -> dict[str, str]:
        """{path: why} of this shard's quarantined files."""
        with self._lock:
            return dict(self._quarantined)

    def purge_quarantined(self) -> int:
        """Delete the quarantined files with their markers and sidecars.
        Returns the files purged."""
        with self._lock:
            doomed = list(self._quarantined)
            self._quarantined.clear()
        n = 0
        for path in doomed:
            for p in (path, _quar_marker(path), _tidx_path(path)):
                try:
                    os.remove(p)
                    n += p == path
                except OSError:
                    pass
        return n

    def drop_cached_columns(self) -> int:
        """Drop every decoded-column cache entry of this shard's current
        files (the close hook; file-set swaps drop the retired readers'
        entries at the swap). Returns the entries dropped."""
        return colcache.GLOBAL.invalidate_gens([r.gen for r in self._files])

    def _note_mutation(self, lo: int, hi: int) -> None:
        """Record a logical-content change over [lo, hi) ns."""
        self.data_version = next(_DATA_VERSIONS)
        self._mutations.append((self.data_version, lo, hi))
        if len(self._mutations) > _MUT_LOG_MAX:
            drop = len(self._mutations) // 2
            self._mut_floor = self._mutations[drop - 1][0]
            # REPLACE, never truncate in place: lockless readers iterate
            # their own snapshot (a shrinking list would end a reversed()
            # iterator early and hide recent mutations)
            self._mutations = self._mutations[drop:]

    def changed_since(self, version: int, lo: int, hi: int) -> bool:
        """Did any mutation newer than `version` touch [lo, hi)?
        Conservative: truncated history answers True."""
        if version < self._mut_floor:
            return True
        muts = self._mutations  # snapshot ref (list is replaced, not cut)
        for v, mlo, mhi in reversed(muts):
            if v <= version:
                break
            if mhi > lo and mlo < hi:
                return True
        return False

    def _replay_wal(self) -> None:
        wal_path = os.path.join(self.path, "wal.log")
        # rotated segments first (oldest -> newest), then the live log:
        # the append order every last-write-wins rank derives from
        for seg in WAL.segments(wal_path):
            self._stale_wal_segs.append(seg)
            seq = seg.rsplit(".", 1)[-1]
            if seq.isdigit():
                self._wal_seg_seq = max(self._wal_seg_seq, int(seq) + 1)
            self._replay_one(seg)
        self._replay_one(wal_path)

    def _replay_one(self, wal_path: str) -> None:
        try:
            for entry in WAL.replay(wal_path):
                self._replay_entry(entry)
        except WALCorruption as e:
            self._recover_wal_corruption(wal_path, e)

    def _recover_wal_corruption(self, wal_path: str, e: WALCorruption) -> None:
        """Interior WAL damage: re-apply the salvaged suffix (every frame
        after the damage holds acknowledged rows), keep the damaged log
        as a quarantine copy, and rewrite a clean log from the decodable
        frames so the recovered rows stay durable."""
        import shutil

        for entry in e.salvaged_entries():
            self._replay_entry(entry)
        qdir = os.path.join(self.path, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        qpath = os.path.join(
            qdir, os.path.basename(wal_path) + f".corrupt-{e.offset}")
        if not os.path.exists(qpath):
            shutil.copy2(wal_path, qpath)
        tmp = wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for kind, payload in (*e.clean_frames, *e.salvaged_frames):
                f.write(frame(kind, payload))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, wal_path)

    def _replay_entry(self, entry) -> None:
        if entry[0] == "lines":
            _, lines, precision, now_ns = entry
            points = lp.parse_lines(lines, precision, now_ns)
        else:
            points = entry[1]
        for mst, tags, t, fields in points:
            if self.tmin <= t < self.tmax:
                sid = self.index.get_or_create(mst, tags)
                try:
                    self.mem.write_row(sid, mst, t, fields)
                except FieldTypeConflict:
                    continue  # rejected at write time: not replayed either

    # -- write path ---------------------------------------------------------

    def write_points(self, points: list, raw_lines: bytes, precision: str,
                     now_ns: int, defer_commit: bool = False):
        """Apply pre-parsed points in this shard's range; `raw_lines` is the
        original batch logged for replay (replay re-filters by time
        range). Returns rows written, or (rows, WAL ticket) with
        `defer_commit` (the caller then owns `wal.commit`). Raises
        FieldTypeConflict BEFORE touching the WAL."""
        with self._lock:
            self._check_types(points)
            ticket = self.wal.append_lines(raw_lines, precision, now_ns)
            n = self._apply(points)
        if defer_commit:
            return n, ticket
        self.wal.commit(ticket)
        return n

    def write_points_structured(self, points: list,
                                defer_commit: bool = False):
        """Same as write_points, WAL-logged as structured points (kind 2)."""
        with self._lock:
            self._check_types(points)
            ticket = self.wal.append_points(points)
            n = self._apply(points)
        if defer_commit:
            return n, ticket
        self.wal.commit(ticket)
        return n

    def write_columnar(self, batch, rows: np.ndarray | None,
                       raw_lines: bytes, precision: str, now_ns: int,
                       defer_commit: bool = False):
        """Apply a ColumnarBatch (ingest/native_lp.py). `rows` selects this
        shard's row indices (None = all rows); `raw_lines` is their
        line-protocol text, logged for replay (the bulk load writes it
        with ingest/native_lp.LineWriter). Returns rows written, or
        (rows, WAL ticket) with `defer_commit`. Type conflicts raise
        BEFORE the WAL append."""
        with self._lock:
            self._check_columnar_types(batch, rows)
            ticket = self.wal.append_lines(raw_lines, precision, now_ns)
            n = self._apply_columnar(batch, rows=rows)
        if defer_commit:
            return n, ticket
        self.wal.commit(ticket)
        return n

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
        if len(refs) > 8:
            ref_list = [int(r) for r in refs]
            sid_by_ref[ref_list] = self.index.get_or_create_bulk(
                [batch.series_keys[r] for r in ref_list])
            return sid_by_ref
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
        self._note_mutation(int(ts.min()), int(ts.max()) + 1)
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
        if n:
            self._note_mutation(
                min(p[2] for p in points), max(p[2] for p in points) + 1)
        return n

    # -- flush --------------------------------------------------------------

    def flush(self) -> None:
        """Memtable -> new TSF file, then drop the covering WAL segment.

        Snapshot-and-swap: under the shard lock the memtable is FROZEN,
        the WAL rotates to a fresh segment and a new memtable installs.
        Encoding and the file write then run OFF the shard lock while
        readers merge the frozen snapshot between the files and the live
        memtable. The file is fsynced and atomically renamed BEFORE the
        rotated segment is removed; a crash anywhere replays the
        surviving segments over whatever was published, and
        last-write-wins dedup makes the overlap idempotent."""
        with self._flush_lock:
            with self._lock:
                if len(self.mem) == 0 and not self._frozen:
                    return
                self.index.flush()
                if len(self.mem):
                    seg = os.path.join(
                        self.path, f"wal.log.{self._wal_seg_seq:06d}")
                    self._wal_seg_seq += 1
                    seg = self.wal.rotate(seg)
                    self.mem.freeze()
                    self._frozen = self._frozen + ((self.mem, seg),)
                    self.mem = MemTable(self.schemas)
                    # frozen and rotated, still under both locks: a kill
                    # here leaves a segment and a snapshot replay recovers
                    _fp("shard-flush-after-rotate")
            # one file per frozen snapshot, oldest first (file order =
            # write order keeps last-write-wins ranking exact)
            while True:
                with self._lock:
                    if not self._frozen:
                        return
                    frozen, seg = self._frozen[0]
                    path = os.path.join(
                        self.path, f"{self._next_file_seq:08d}.tsf")
                    self._next_file_seq += 1
                self._flush_frozen(frozen, seg, path)

    def flush_if_over(self, threshold_bytes: int) -> bool:
        """Threshold-path flush: writers that all saw the same
        over-threshold memtable trigger ONE flush; non-blocking while a
        flush is already in flight."""
        if not self._flush_lock.acquire(blocking=False):
            return False
        try:
            if self.mem.approx_bytes <= threshold_bytes and not self._frozen:
                return False
            self.flush()
            return True
        finally:
            self._flush_lock.release()

    def _flush_frozen(self, frozen: MemTable, seg: str | None,
                      path: str) -> None:
        """Encode + write one frozen memtable into `path`, publish it,
        then remove the WAL segment(s) its rows came from."""
        _fp("shard-flush-before-encode")  # the off-lock encode begins
        w = TSFWriter(path)
        tidx = _TextSidecar()
        tsf_rows = 0
        try:
            for mst, sid_arr, rec in frozen.measurement_tables():
                uniq, starts = np.unique(sid_arr, return_index=True)
                ends = np.append(starts[1:], len(sid_arr))
                tsf_rows += _write_measurement_chunks(
                    w, tidx, mst, _sid_entries(rec, uniq, starts, ends),
                    n_series=len(uniq))
            # post-dedup rows can only SHRINK vs the snapshot's row count;
            # more means duplicated rows — abort before the file is durable
            if tsf_rows > frozen.row_count:
                raise RuntimeError(
                    f"flush wrote {tsf_rows} rows from a "
                    f"{frozen.row_count}-row snapshot (duplication)")
            _fp("shard-flush-before-publish")
            w.finish()
        except BaseException:
            w.abort()
            raise
        with self._lock:
            # publish + un-freeze atomically: a reader sees the rows in
            # the frozen snapshot or in the new file, never in neither
            reader = self._adopt(TSFReader(path))
            self._files.append(reader)
            self._frozen = self._frozen[1:]
            if seg is not None:
                self._stale_wal_segs.append(seg)
        _fp("shard-flush-after-publish")
        # the sidecar after the publish: a sidecar failure must not leave
        # the snapshot queued (a retry would write its rows into a second
        # file); the window without one only disables text pruning. Only
        # while our reader still owns the path: an in-place compaction
        # that replaced the file wrote the merged sidecar already
        with self._lock:
            if any(r is reader for r in self._files):
                tidx.write(path)
                self._tidx_cache.pop(path, None)
        _fp("shard-flush-before-wal-truncate")
        stale, self._stale_wal_segs = self._stale_wal_segs, []
        for p in stale:
            try:
                os.remove(p)
            except OSError:
                pass
        _fp("shard-flush-after-wal-truncate")

    # -- compaction -----------------------------------------------------------

    @staticmethod
    def _merge_readers(readers, w: TSFWriter, tidx: "_TextSidecar") -> None:
        """The merge of compact(), compact_level() and
        compact_out_of_order(): every series' chunks across `readers`
        (oldest first, so last-write-wins dedup holds), written merged
        into `w` and its text sidecar; packed chunks again at high
        cardinality."""
        per_mst: dict[str, set[int]] = {}
        for r in readers:
            for mst in r.measurements():
                sids = per_mst.setdefault(mst, set())
                for c in r.chunks(mst):
                    if c.packed:
                        sids.update(
                            int(s) for s in
                            np.unique(r.read_packed_sids(c, cache=False)))
                    else:
                        sids.add(c.sid)
        batch_sids = 65536  # sids per merge batch: bounds resident rows
        for mst in sorted(per_mst):
            sids_sorted = sorted(per_mst[mst])
            n_series = len(sids_sorted)

            def merged_entries(mst=mst, sids_sorted=sids_sorted):
                for b0 in range(0, n_series, batch_sids):
                    batch = np.asarray(sids_sorted[b0:b0 + batch_sids],
                                       np.int64)
                    batch_set = set(batch.tolist())

                    # one decode per chunk per batch (cache=False: the
                    # soon-to-be-retired readers must not pin memory),
                    # across the scan pool, yielded in file order
                    def decode(r, c):
                        if c.packed:
                            s_arr, rec = r.read_packed_bulk(
                                mst, c, None, sid_filter=batch, cache=False)
                            return (s_arr, rec) if len(rec) else None
                        rec = r.read_chunk(mst, c, cache=False)
                        return (np.full(len(rec), c.sid, np.int64), rec)

                    jobs, ests = [], []
                    for r in readers:
                        for c in r.chunks(mst):
                            if c.packed:
                                if c.smax < batch[0] or c.smin > batch[-1]:
                                    continue
                            elif c.sid not in batch_set:
                                continue
                            jobs.append(lambda r=r, c=c: decode(r, c))
                            ests.append(scanpool.est_chunk_bytes(c, None))
                    parts = [p for p in scanpool.map_ordered(jobs, ests)
                             if p is not None]
                    sid_arr, rec = merge_bulk_parts(
                        parts, -(2**63), 2**63 - 1)
                    uniq, starts = np.unique(sid_arr, return_index=True)
                    ends = np.append(starts[1:], len(sid_arr))
                    yield from _sid_entries(rec, uniq, starts, ends)

            _write_measurement_chunks(w, tidx, mst, merged_entries(),
                                      n_series=n_series)

    def file_count(self) -> int:
        with self._lock:
            return len(self._files)

    @staticmethod
    def _find_run(cur: list, run: list) -> int | None:
        """Position of `run` inside `cur`, matched by reader identity,
        contiguous and in order, or None when a member vanished. The
        compaction swap revalidates its snapshot through this."""
        if not run:
            return None
        for j, r in enumerate(cur):
            if r is run[0]:
                if (j + len(run) <= len(cur)
                        and all(cur[j + k] is run[k]
                                for k in range(1, len(run)))):
                    return j
                return None
        return None

    def _compact_offlock(self, pick, *, full: bool) -> bool:
        """Snapshot, merge off the locks, revalidated swap: the engine
        behind compact(), compact_level() and compact_out_of_order().

        `pick(files)` inspects an immutable snapshot and returns the
        contiguous run (i0, n) to merge, or None. `full=True` writes the
        run into a file under a fresh sequence number; `full=False`
        lands it at the run's first path (in place: file order, and with
        it last-write-wins rank, is kept).

        Locking: the snapshot (and a full merge's sequence number) is
        taken under `_flush_lock` and `_lock`, in that order; the merge,
        encode and fsync run with no lock held, so writes, flushes and
        queries never wait for a compaction. The output's sequence
        number is reserved before going off-lock, as a flush reserves
        its path, so a flush that publishes meanwhile takes a higher
        one and its rows outrank the merged ones on reopen. The swap
        takes both locks again and finds the run by identity: files
        published meanwhile stay after the spliced output; a vanished
        input aborts the merge (output removed, inputs untouched)."""
        with self._flush_lock, self._lock:
            files = list(self._files)
            sel = pick(files)
            if sel is None:
                return False
            i0, n = sel
            run = files[i0:i0 + n]
            if full:
                out_path = os.path.join(
                    self.path, f"{self._next_file_seq:08d}.tsf")
                self._next_file_seq += 1
            else:
                out_path = run[0].path
        # merge into a `.merge` temp off both locks: invisible to
        # queries, swept by _load_files after a crash before the swap
        tmp = out_path + ".merge"
        w = TSFWriter(tmp)
        tidx = _TextSidecar()
        try:
            self._merge_readers(run, w, tidx)
            w.finish()  # lands at tmp, fsynced
        except CorruptFile as e:
            # a damaged input: quarantine it so the next compaction (and
            # every query) proceeds without it; merging a corrupt block
            # would launder the damage past its checksum
            w.abort()
            self.note_corrupt(e)
        except BaseException:
            w.abort()
            raise
        # check the output off-lock before it may replace an input: an
        # in-place merge overwrites run[0] at the swap, so an unreadable
        # output must abort here with every input intact
        try:
            rv = TSFReader(tmp)
            try:
                for loc in rv.data_locs():
                    rv.verify_block(loc)
            finally:
                rv.close()
        except Exception:  # noqa: BLE001 — any unreadable output aborts
            _remove_quiet(tmp)
            _STATS.incr("compact", "output_verify_aborts")
            return False
        published = False
        try:
            _fp("compact-before-replace")
            with self._flush_lock, self._lock:
                j = self._find_run(self._files, run)
                if j is None:
                    # an input vanished mid-merge (quarantine, a delete
                    # rewrite): publishing could resurrect dropped rows;
                    # the next call retries over the new set
                    _STATS.incr("compact", "swap_aborts")
                    return False
                os.replace(tmp, out_path)
                _fp("compact-after-replace")
                published = True
                tidx.write(out_path)
                new_reader = self._adopt(TSFReader(out_path))
                self._files = (self._files[:j] + [new_reader]
                               + self._files[j + n:])
                self._tidx_cache = {}
                _fp("compact-before-retire")  # new set live, old not gone
                if full:
                    _retire_files(run)
                else:
                    _retire_files(run[1:])  # the old run[0] keeps its fd
                    # run[0]'s old reader was replaced in place (same
                    # path, new generation): its cached columns can
                    # never hit again and would pin budget
                    colcache.GLOBAL.invalidate_gens([run[0].gen])
            _STATS.incr("compact", "offlock_merges")
            return True
        finally:
            if not published:
                _remove_quiet(tmp)

    def compact(self, max_files: int = 1) -> bool:
        """Full merge of the immutable files into one file under a fresh
        sequence number, when there are more than `max_files`. Returns
        whether a merge happened (False for nothing to do and for a
        merge the swap aborted)."""
        def pick(files):
            if len(files) <= max_files:
                return None
            return (0, len(files))

        return self._compact_offlock(pick, full=True)

    @staticmethod
    def _file_level(path: str) -> int:
        """Size-tiered level: L0 below 1 MiB, each level 8x larger."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size < (1 << 20):
            return 0
        return 1 + int(math.log(size / (1 << 20), 8))

    def compact_level(self, fanout: int = 4) -> bool:
        """Merge one run of `fanout` consecutive same-level files into
        one, in place at the run's first file (file order, and with it
        last-write-wins across the other files, is kept): O(run) a call,
        bounded write amplification."""
        fanout = max(2, fanout)  # fanout 1 would rewrite a file in place

        def pick(files):
            if len(files) < fanout:
                return None
            levels = [self._file_level(r.path) for r in files]
            run_start = run_len = 0
            for i in range(len(levels)):
                if i > 0 and levels[i] == levels[i - 1]:
                    run_len += 1
                else:
                    run_start, run_len = i, 1
                if run_len >= fanout:
                    return (run_start, fanout)
            return None

        return self._compact_offlock(pick, full=False)

    def has_time_overlap(self) -> bool:
        """True when the time ranges of two immutable files overlap."""
        with self._lock:
            ranges = sorted((r.tmin, r.tmax) for r in self._files
                            if r.tmin is not None)
        return any(b_lo <= a_hi for (_a_lo, a_hi), (b_lo, _b_hi)
                   in zip(ranges, ranges[1:]))

    def compact_out_of_order(self, max_files: int = 4) -> bool:
        """Merge time-overlapping files whatever their level: the run
        from the first overlapping file toward its partner, at most
        `max_files` a call, in place; repeated calls converge to
        disjoint ranges."""
        def pick(files):
            if len(files) < 2:
                return None
            ranges = [(r.tmin, r.tmax) for r in files]
            for i in range(len(ranges)):
                if ranges[i][0] is None:
                    continue
                for j in range(i + 1, len(ranges)):
                    if ranges[j][0] is None:
                        continue
                    if (ranges[j][0] <= ranges[i][1]
                            and ranges[i][0] <= ranges[j][1]):
                        # contiguous: an intervening file's rows must
                        # not change rank against the merged output
                        return (i, min(j - i + 1, max(2, max_files)))
            return None

        return self._compact_offlock(pick, full=False)

    # -- downsample rewrite ---------------------------------------------------

    def rewrite_downsampled(self, every_ns: int, field_aggs: dict | None = None,
                            device=None) -> int:
        """Rewrite this shard at `every_ns` resolution (storage/
        downsample.py; its device batches run on `device`). Returns rows
        written. Flushes first, so the memtable takes part, and replaces
        the whole file set with one new file at the end, as the delete
        rewrite does (the retired files leave the decoded-column cache)."""
        from opengemini_tpu_torch.storage.downsample import downsample_records

        # _flush_lock first (the lock order): see delete_data
        with self._flush_lock, self._lock:
            self.flush()
            path = os.path.join(self.path, f"{self._next_file_seq:08d}.tsf")
            w = TSFWriter(path)
            tidx = _TextSidecar()  # stays empty: the output has no strings
            rows = 0
            # schemas change only once the new file is durable: a failed
            # rewrite must not leave them ahead of the (still raw) data
            staged_schemas: dict[str, dict] = {}
            try:
                for mst in self.measurements():
                    per_sid: dict[int, Record] = {}
                    for sid in sorted(self.index.series_ids(mst)):
                        rec = self.read_series(mst, sid)
                        if len(rec):
                            per_sid[sid] = rec
                    out, new_schema = downsample_records(
                        per_sid, self.schema(mst), self.tmin, self.tmax,
                        every_ns, field_aggs, device=device)
                    staged_schemas[mst] = new_schema
                    # the flush's layout: packed chunks from
                    # PACK_MIN_SERIES series on, per-series chunks below
                    rows += _write_measurement_chunks(
                        w, tidx, mst, ((sid, out[sid]) for sid in sorted(out)),
                        n_series=len(out))
                w.finish()
            except BaseException:
                w.abort()
                raise
            tidx.write(path)
            self.schemas.update(staged_schemas)
            self._next_file_seq += 1
            old = self._files
            self._files = [self._adopt(TSFReader(path))]
            self._tidx_cache = {}
            _retire_files(old)
            # after the swap, as in delete_data
            self._note_mutation(self.tmin, self.tmax)
            return rows

    # -- delete rewrite -------------------------------------------------------

    def delete_data(self, measurement: str, sids: set[int] | None = None,
                    tmin: int | None = None,
                    tmax: int | None = None) -> None:
        """Delete rows (a whole measurement, whole series, or a time
        range) by rewriting the immutable files without them. Flushes
        first, so the memtable takes part; every measurement is read
        through the bulk read (a packed chunk decodes once, not once per
        series) and its surviving rows are written into one file, which
        replaces the whole file set."""
        # _flush_lock first (the lock order): the inline flush re-enters
        # it, and holding it for the whole rewrite keeps a concurrent
        # flush from publishing a pre-rewrite snapshot after the swap
        with self._flush_lock, self._lock:
            self.flush()
            if measurement not in self.measurements():
                return
            if sids is not None:
                sids = set(sids) & self.index.series_ids(measurement)
                if not sids:
                    return
            doomed = (sids if sids is not None
                      else self.index.series_ids(measurement))
            lo = tmin if tmin is not None else -(2**62)
            hi = tmax if tmax is not None else 2**62
            full_series_delete = tmin is None and tmax is None
            path = os.path.join(self.path, f"{self._next_file_seq:08d}.tsf")
            w = TSFWriter(path)
            tidx = _TextSidecar()
            wrote = False
            try:
                for mst in self.measurements():
                    rows = self._delete_rewrite_measurement(
                        w, tidx, mst, doomed if mst == measurement else None,
                        full_series_delete, lo, hi)
                    wrote = wrote or rows > 0
                w.finish()
            except BaseException:
                w.abort()
                raise
            self._next_file_seq += 1
            old = self._files
            if wrote:
                tidx.write(path)
                self._files = [self._adopt(TSFReader(path))]
            else:
                os.remove(path)
                self._files = []
            self._tidx_cache = {}
            _retire_files(old)
            # the version bump after the swap: a concurrent query that
            # scanned the old files must cache under the old version, so
            # the next execution invalidates it (a bump before the swap
            # would let pre-delete rows be cached under the new version)
            self._note_mutation(
                tmin if tmin is not None else self.tmin,
                tmax if tmax is not None else self.tmax)
            if full_series_delete:
                self.index.remove_sids(set(doomed))
                if not self.index.series_ids(measurement):
                    self.schemas.pop(measurement, None)

    def _delete_rewrite_measurement(self, w: TSFWriter, tidx, mst: str,
                                    doomed, full_series_delete: bool,
                                    lo: int, hi: int) -> int:
        """Write one measurement's surviving rows into `w`: the rows in
        [lo, hi) (all of them for a full-series delete) of the series in
        `doomed` go; None deletes nothing of `mst`. Returns the rows
        written."""
        all_sids = np.asarray(sorted(self.index.series_ids(mst)), np.int64)
        if not len(all_sids):
            return 0
        sid_arr, rec = self.read_series_bulk(mst, all_sids)
        if not len(rec):
            return 0
        if doomed is not None:
            hit = np.isin(sid_arr, np.fromiter(doomed, np.int64))
            if not full_series_delete:
                hit &= (rec.times >= lo) & (rec.times < hi)
            if hit.any():
                keep = np.flatnonzero(~hit)
                sid_arr = sid_arr[keep]
                rec = Record(rec.times[keep], {
                    name: Column(col.ftype, col.values[keep],
                                 col.valid[keep])
                    for name, col in rec.columns.items()})
        if not len(rec):
            return 0
        # host arrays: the bulk read may hand back still-encoded blocks
        rec = Record(rec.times, {
            name: Column(col.ftype, col.values, col.valid)
            for name, col in rec.columns.items()})
        uniq, starts = np.unique(sid_arr, return_index=True)
        ends = np.append(starts[1:], len(sid_arr))
        return _write_measurement_chunks(
            w, tidx, mst, _sid_entries(rec, uniq, starts, ends),
            n_series=len(uniq))

    # -- read side ----------------------------------------------------------

    def _scan_state(self) -> tuple[list, list]:
        """(files, memtables oldest -> newest, live last) in ONE lock
        acquisition, consistent with a concurrent flush publish."""
        with self._lock:
            mems = [m for m, _seg in self._frozen]
            mems.append(self.mem)
            return list(self._files), mems

    def _mem_parts(self) -> list:
        return [m for m, _seg in self._frozen] + [self.mem]

    def mem_overlaps_range(self, sid: int, tmin: int, tmax: int) -> bool:
        """Does ANY in-memory part (frozen snapshots or live memtable)
        hold rows of `sid` in [tmin, tmax]? Probes each part separately,
        no merge and no lock, for the per-series pre-aggregation and
        sketch checks."""
        for m in self._mem_parts():
            rec = m.record_for(sid)
            if rec is not None and len(rec.slice_time(tmin, tmax)):
                return True
        return False

    def mem_sids_for(self, measurement: str) -> set[int]:
        """Series of `measurement` with rows in a memtable (frozen
        snapshots or the live one): unindexed by the text sidecars."""
        out: set[int] = set()
        for m in self._mem_parts():
            out |= m.sids_for(measurement)
        return out

    def mem_time_range(self) -> tuple[int | None, int | None]:
        """(min, max) ns across frozen + live memtables (None = no rows)."""
        tmin = tmax = None
        for m in self._mem_parts():
            if m.min_time is not None:
                tmin = m.min_time if tmin is None else min(tmin, m.min_time)
                tmax = m.max_time if tmax is None else max(tmax, m.max_time)
        return tmin, tmax

    def mem_backlog_bytes(self) -> int:
        """Unflushed resident bytes: the live and frozen memtables plus
        the live WAL log. No lock (one tuple read and int reads): the
        resource governor polls it on every governed /write
        (utils/governor.py; the engine sums it over its shards)."""
        return (sum(m.backlog_bytes for m in self._mem_parts())
                + self.wal.backlog_bytes)

    def measurements(self) -> list[str]:
        msts = set(self.index.measurements())
        for r in self._files:
            msts.update(r.measurements())
        return sorted(msts)

    def schema(self, measurement: str) -> dict:
        return dict(self.schemas.get(measurement, {}))

    def file_chunks(self, measurement: str, sids=None, tmin=None, tmax=None):
        """[(reader, ChunkMeta)] oldest file first — the merge order that
        makes last-write-wins correct."""
        return [(r, c) for r in self._files
                for c in r.chunks(measurement, sids, tmin, tmax)]

    def approx_rows(self, measurement: str, tmin=None, tmax=None
                    ) -> tuple[int, int]:
        """(row count, chunk count) for the measurement in the time range,
        from chunk metadata and the memtable, without a decode. Chunks
        that straddle the range's edges count whole, and so do the
        memtables (they keep no rows per measurement): the subquery's
        chunk planner needs only the order of magnitude."""
        rows = 0
        chunks = 0
        files, mems = self._scan_state()
        for r in files:
            for c in r.chunks(measurement, None, tmin, tmax):
                rows += c.rows
                chunks += 1
        return rows + sum(len(m) for m in mems), chunks

    def text_match_sids(self, mst: str, field: str, token: str):
        """Series whose persisted rows may hold `token` in `field` (a
        pruning set: rows are still filtered exactly), or None when a
        file has no sidecar (no pruning possible). Memtable rows are
        unindexed: callers union the memtable's series."""
        from opengemini_tpu_torch.native.textindex import query_grams

        if token.isascii():
            # pure-ASCII terms are whole lowercased tokens in the index
            grams = [token.lower()]
        else:
            # mixed/CJK terms prune on their non-ASCII grams only: an
            # ASCII fragment may sit inside a longer indexed token
            grams = [g for g in query_grams(token) if not g.isascii()]
        out: set[int] = set()
        # under the shard lock: a compaction swaps the file set and
        # resets the cache, and a fill outside the lock could re-insert
        # a retired file's entry
        with self._lock:
            for r in self._files:
                cached = self._tidx_cache.get(r.path, False)
                if cached is False:
                    try:
                        with open(_tidx_path(r.path), encoding="utf-8") as f:
                            cached = json.load(f)
                    except (OSError, ValueError):
                        cached = None
                    self._tidx_cache[r.path] = cached
                if cached is None:
                    return None
                toks = cached.get(mst, {}).get(field, {})
                # multi-gram terms (CJK) intersect their grams' postings
                per_file: set[int] | None = None
                for g in grams:
                    got = set(toks.get(g, []))
                    per_file = got if per_file is None else per_file & got
                out.update(per_file or ())
        return out

    def read_series(self, measurement: str, sid: int,
                    tmin: int | None = None, tmax: int | None = None,
                    fields: list[str] | None = None) -> Record:
        """Merged view of one series: immutable chunks (oldest first) +
        memtables last, deduped last-wins, then time-sliced. Eligible
        value blocks come back still encoded (record.EncodedColumn), as
        in read_series_bulk."""
        files, mems = self._scan_state()
        chunks = [(r, c) for r in files
                  for c in r.chunks(measurement, {sid}, tmin, tmax)]
        n_fields = len(fields) if fields is not None else None

        def decode(r, c):
            if c.packed:
                return r.read_packed_sid(measurement, c, sid, fields,
                                         encoded_ok=True)
            return r.read_chunk(measurement, c, fields, encoded_ok=True)

        # decoded-column cache consult before pool dispatch: fully
        # cached chunks assemble inline and never enter the pool; misses
        # fill through it, under its in-flight budget
        recs: list = [None] * len(chunks)
        jobs, ests, miss_at = [], [], []
        for i, (r, c) in enumerate(chunks):
            got = (r.read_packed_sid_if_cached(measurement, c, sid, fields)
                   if c.packed
                   else r.read_chunk_if_cached(measurement, c, fields))
            if got is not None:
                recs[i] = got
            else:
                jobs.append(lambda r=r, c=c: decode(r, c))
                ests.append(scanpool.est_chunk_bytes(c, n_fields))
                miss_at.append(i)
        try:
            for i, out in zip(miss_at, scanpool.map_ordered(jobs, ests)):
                recs[i] = out
        except CorruptFile as e:
            # media damage mid-scan: quarantine the file and fail this
            # query cleanly, never return a partial record
            self.note_corrupt(e)
        # frozen flush snapshots (oldest first) then the live memtable
        for m in mems:
            mem_rec = m.record_for(sid)
            if mem_rec is not None:
                recs.append(_keep_fields(mem_rec, fields))
        merged = merge_sorted_records(recs)
        if tmin is not None or tmax is not None:
            lo = tmin if tmin is not None else -(2**63)
            hi = tmax if tmax is not None else 2**63 - 1
            merged = merged.slice_time(lo, hi)
        return merged

    def read_series_bulk(self, measurement: str, sids: np.ndarray,
                         tmin: int | None = None, tmax: int | None = None,
                         fields: list[str] | None = None,
                         ) -> tuple[np.ndarray, Record]:
        """Batched multi-series read: (sid_column, record) for every
        requested series, rows grouped by sid and time-sorted within a
        sid, last-write-wins deduped. Packed chunks decode ONCE for all
        their series; eligible value blocks stay encoded
        (record.EncodedColumn) so the grid freeze can ship them to the
        card, and every host consumer decodes them lazily,
        bit-identically."""
        sids = np.asarray(sorted(int(s) for s in sids), dtype=np.int64)
        lo_t = tmin if tmin is not None else -(2**63)
        hi_t = tmax if tmax is not None else 2**63 - 1
        sid_set = set(int(s) for s in sids)
        files, mems = self._scan_state()
        n_fields = len(fields) if fields is not None else None

        def decode_packed(r, c):
            s_arr, rec = r.read_packed_bulk(
                measurement, c, fields, sid_filter=sids, encoded_ok=True)
            return (s_arr, rec) if len(rec) else None

        def decode_single(r, c):
            rec = r.read_chunk(measurement, c, fields, encoded_ok=True)
            return (np.full(len(rec), c.sid, np.int64), rec)

        # parts MUST stay in file order (oldest first): merge_bulk_parts
        # ranks later parts as newer for last-write-wins; map_ordered
        # yields in submission order. Fully cached chunks (the
        # decoded-column cache) assemble inline and skip the pool;
        # `slots` keeps file order
        jobs, ests, slots, miss_at = [], [], [], []
        for r in files:
            for c in r.chunks(measurement, None, tmin, tmax):
                if c.packed:
                    if not len(sids) or c.smax < sids[0] or c.smin > sids[-1]:
                        continue
                    got = r.read_packed_bulk_if_cached(
                        measurement, c, fields, sid_filter=sids)
                    if got is not None:
                        slots.append(got if len(got[1]) else None)
                        continue
                    jobs.append(lambda r=r, c=c: decode_packed(r, c))
                elif c.sid in sid_set:
                    got = r.read_chunk_if_cached(measurement, c, fields)
                    if got is not None:
                        slots.append(
                            (np.full(len(got), c.sid, np.int64), got))
                        continue
                    jobs.append(lambda r=r, c=c: decode_single(r, c))
                else:
                    continue
                miss_at.append(len(slots))
                slots.append(None)
                ests.append(scanpool.est_chunk_bytes(c, n_fields))
        try:
            for i, part in zip(miss_at, scanpool.map_ordered(jobs, ests)):
                slots[i] = part
        except CorruptFile as e:
            self.note_corrupt(e)  # see read_series
        parts = [p for p in slots if p is not None]
        for m in mems:  # frozen snapshots oldest first, live memtable last
            for sid_arr, mem_rec in m.bulk_parts(measurement, sids):
                parts.append((sid_arr, _keep_fields(mem_rec, fields)))
        return merge_bulk_parts(parts, lo_t, hi_t)

    def close(self) -> None:
        # _flush_lock first: an in-flight flush finishes before handles
        # close
        with self._flush_lock, self._lock:
            self.wal.flush()
            self.wal.close()
            self.index.flush()
            self.index.close()
            # release every decoded-column cache entry this shard
            # pinned (readers in flight keep their arrays)
            self.drop_cached_columns()
            for r in self._files:
                r.close()


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _tidx_path(tsf_path: str) -> str:
    """The text-index sidecar of a TSF file."""
    return (tsf_path[:-4] + ".tidx" if tsf_path.endswith(".tsf")
            else tsf_path + ".tidx")


def _quar_marker(tsf_path: str) -> str:
    """The durable quarantine marker of a damaged TSF file."""
    return tsf_path + ".quar"


class _TextSidecar:
    """A file's inverted text index over its string fields, built as its
    chunks are written: measurement -> field -> token -> sids, used to
    prune series before decode (rows are still filtered exactly)."""

    def __init__(self):
        self.idx: dict[str, dict[str, dict[str, set]]] = {}

    def add(self, mst: str, sid: int, rec) -> None:
        from opengemini_tpu_torch.native.textindex import tokenize
        from opengemini_tpu_torch.record import FieldType

        for name, col in rec.columns.items():
            if col.ftype != FieldType.STRING:
                continue
            toks = self.idx.setdefault(mst, {}).setdefault(name, {})
            # a series repeats its messages: tokenize each distinct one
            # once
            seen: set = set()
            for v, ok in zip(col.values, col.valid):
                if ok and isinstance(v, str) and v not in seen:
                    seen.add(v)
                    for t in set(tokenize(v)):
                        toks.setdefault(t, set()).add(sid)

    def write(self, tsf_path: str) -> None:
        p = _tidx_path(tsf_path)
        data = {
            m: {f: {t: sorted(s) for t, s in toks.items()}
                for f, toks in flds.items()}
            for m, flds in self.idx.items()
        }
        tmp = p + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, p)  # a crash before this: no sidecar, no pruning


def _retire_files(readers: list) -> None:
    """Unlink replaced immutable files (and their sidecars) without
    closing their readers: queries in flight hold (reader, chunk) pairs
    outside the shard lock, and POSIX keeps unlinked files readable
    through open fds, which close when the last reader object goes. The
    retired generations' cache entries drop here too."""
    colcache.GLOBAL.invalidate_gens([r.gen for r in readers])
    for r in readers:
        _remove_quiet(r.path)
        _remove_quiet(_tidx_path(r.path))
