"""TSF — the immutable columnar file format (TSSP analogue).

The port of ``opengemini_tpu/storage/tsf.py``. Both packages read and
write the same files. Layout (format revision 2):

    "OGTSF02\\n"                      8-byte magic
    column blocks, each SEALED: [encoded bytes][u32 crc32] — the
          per-block checksum verified on every read
          (self-describing payloads, see storage/encoding.py)
    meta: "BM02" + zlib(binary chunk meta — storage/chunkmeta.py);
          legacy zlib(JSON) still reads
    trailer: [u64 meta_off][u32 meta_len][u32 meta_crc]"OGTSFEND"

Revision 1 files ("OGTSF01\\n", CRC-less blocks) remain readable. A
flipped bit in a v2 block raises CorruptFile before any wrong value
reaches a query.

Chunks are either one series' rows for one flush (time + field columns,
validity masks, numeric pre-aggregation) or PK-sorted packed
multi-series blocks (colstore layout, see add_packed_chunk).

Decoded columns are cached: in the process-wide decoded-column cache
(storage/colcache.py) when it is enabled, keyed by (shard, file
generation, chunk, series, field), else in a per-file LRU of 16 MiB.
Bulk one-pass scans (compaction) read with ``cache=False``.

The disk-fault hooks (storage/diskfault.py) sit on the block write, the
meta write and fsync, and the open's and the blocks' reads. A
per-measurement sid bloom filter (utils/bloom.py), built from the
in-memory metadata, rejects a single-series lookup of a series the file
cannot hold before the chunk lists are touched.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import struct
import time
import zlib
from collections import OrderedDict

import numpy as np

from opengemini_tpu_torch.record import Column, EncodedColumn, FieldType, Record
from opengemini_tpu_torch.storage import (
    chunkmeta, colcache, diskfault, encodepool, encoding,
)
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.bloom import BloomFilter

MAGIC = b"OGTSF01\n"   # revision 1: CRC-less blocks (read-only legacy)
MAGIC2 = b"OGTSF02\n"  # revision 2: per-block crc32 seals (written)
END_MAGIC = b"OGTSFEND"
_TRAILER = struct.Struct("<QII")
_BLOCK_CRC = struct.Struct("<I")


HIST_BINS = 32


class PreAgg:
    """count/min/max/sum of the valid values of one numeric column chunk,
    plus a small equi-width histogram (persisted per chunk: the
    pre-aggregation path reads count and sum, percentile_approx the
    histogram)."""

    __slots__ = ("count", "vmin", "vmax", "vsum", "hist")

    def __init__(self, count: int, vmin, vmax, vsum, hist=None):
        self.count = count
        self.vmin = vmin
        self.vmax = vmax
        self.vsum = vsum
        self.hist = hist  # HIST_BINS int counts over [vmin, vmax], or None

    @classmethod
    def of(cls, col: Column) -> "PreAgg":
        if col.ftype not in (FieldType.FLOAT, FieldType.INT):
            return cls(int(col.valid.sum()), None, None, None)
        vals = col.values[col.valid]
        if len(vals) == 0:
            return cls(0, None, None, None)
        vmin = vals.min().item()
        vmax = vals.max().item()
        finite = np.isfinite(np.asarray(vals, dtype=np.float64))
        hist = None
        if finite.all() and vmax > vmin:
            hist = np.histogram(
                vals.astype(np.float64), bins=HIST_BINS, range=(vmin, vmax)
            )[0].tolist()
        return cls(len(vals), vmin, vmax, vals.sum().item(), hist)

    def to_json(self):
        return [self.count, self.vmin, self.vmax, self.vsum, self.hist]

    @classmethod
    def from_json(cls, j) -> "PreAgg":
        # older files carry 4-element pre-agg entries (no histogram)
        return cls(*j) if len(j) >= 5 else cls(*j, None)


class ChunkMeta:
    __slots__ = ("sid", "rows", "tmin", "tmax", "time_loc", "cols",
                 "smin", "smax", "sid_loc", "sparse")

    def __init__(self, sid, rows, tmin, tmax, time_loc, cols,
                 smin=None, smax=None, sid_loc=None, sparse=None):
        self.sid = sid  # None for packed (multi-series) chunks
        self.rows = rows
        self.tmin = tmin
        self.tmax = tmax
        self.time_loc = time_loc  # (off, len)
        # field -> {"v": (off,len), "m": (off,len)|None, "pre": PreAgg}
        self.cols = cols
        # packed chunks: rows sorted by (sid, time); the sid column is its
        # own block and `sparse` is the sparse primary-key index
        # [(sid, row_offset)] every SPARSE_K rows
        self.smin = smin
        self.smax = smax
        self.sid_loc = sid_loc
        self.sparse = sparse

    @property
    def packed(self) -> bool:
        return self.sid is None


# packed-chunk tuning: pack when a measurement flushes many series; the
# sparse PK index records every SPARSE_K-th row boundary
PACK_MIN_SERIES = 64
PACK_ROWS = 131072
SPARSE_K = 1024


def _col_nbytes(col: Column) -> int:
    """Encode-input size estimate of one column (pipeline backpressure)."""
    values = col.values
    if getattr(values, "dtype", None) is not None and values.dtype == object:
        nb = 32 * len(values)
    else:
        nb = int(getattr(values, "nbytes", 8 * len(values)))
    return nb + int(col.valid.nbytes)


class TSFWriter:
    """Writes one TSF file. Chunk encodes pipeline through the encode
    pool (storage/encodepool.py), draining in submission order so
    offsets — and file bytes — are identical to the serial path.

    NOT thread-safe: one writer thread owns the file."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(MAGIC2)
        self._off = len(MAGIC2)
        # mst -> {"schema": {field: int}, "chunks": [meta json]}
        self._meta: dict = {}
        self._pipe = encodepool.OrderedEncodePipe(self._write_encoded)

    def _write_block(self, buf: bytes) -> tuple[int, int]:
        """Seal + write one block: [payload][u32 crc32(payload)], the one
        place every data block passes through. Offsets and lengths cover
        the sealed bytes; `TSFReader._read` verifies and strips. The
        disk-fault hook may tear or corrupt what the media holds; the
        writer still accounts the full sealed length, as a real torn
        sector lies to the writer."""
        sealed = buf + _BLOCK_CRC.pack(zlib.crc32(buf))
        off = self._off
        out = sealed
        if diskfault.armed():
            out = diskfault.on_write(self.path, sealed,
                                     site="tsf-block-write")
        self._f.write(out)
        if len(out) != len(sealed):  # torn write: keep file offsets true
            self._f.seek(off + len(sealed))
        self._off += len(sealed)
        return (off, len(sealed))

    def _check_schema(self, m: dict, rec: Record) -> None:
        """Submit-time schema merge: a type conflict raises at the
        add_chunk call that introduced it."""
        schema = m["schema"]
        for name, col in rec.columns.items():
            have = schema.get(name)
            if have is None:
                schema[name] = int(col.ftype)
            elif have != int(col.ftype):
                raise ValueError(
                    f"field type conflict in file for {name!r}: {have} vs {int(col.ftype)}"
                )

    @staticmethod
    def _encode_job(measurement: str, sid, sids, rec: Record):
        """Pure per-chunk encode (runs on a pool worker): every buffer and
        pre-agg this chunk needs, NO offsets."""
        time_buf = encoding.encode_ints(rec.times)
        sid_buf = encoding.encode_ints(sids) if sids is not None else None
        cols = []
        for name, col in rec.columns.items():
            vbuf, mbuf = encoding.encode_column(col)
            cols.append((name, vbuf, mbuf, PreAgg.of(col).to_json()))
        return measurement, sid, sids, rec, time_buf, sid_buf, cols

    def _write_encoded(self, item) -> None:
        """Drain stage (writer thread): assign offsets, write blocks,
        append the chunk's meta entry."""
        measurement, sid, sids, rec, time_buf, sid_buf, cols = item
        m = self._meta[measurement]
        time_loc = self._write_block(time_buf)
        entry: dict = {
            "rows": len(rec),
            "time": time_loc,
        }
        if sid_buf is not None:
            entry["packed"] = 1
            entry["smin"] = int(sids[0])
            entry["smax"] = int(sids[-1])
            entry["sids"] = self._write_block(sid_buf)
            entry["sparse"] = [
                [int(sids[i]), i] for i in range(0, len(sids), SPARSE_K)]
            entry["tmin"] = int(rec.times.min())
            entry["tmax"] = int(rec.times.max())
        else:
            entry["sid"] = sid
            entry["tmin"] = int(rec.times[0])
            entry["tmax"] = int(rec.times[-1])
        out_cols = {}
        for name, vbuf, mbuf, pre in cols:
            vloc = self._write_block(vbuf)
            mloc = self._write_block(mbuf) if mbuf else None
            out_cols[name] = {"v": vloc, "m": mloc, "pre": pre}
        entry["cols"] = out_cols
        m["chunks"].append(entry)

    def add_chunk(self, measurement: str, sid: int, rec: Record) -> None:
        """rec must be time-sorted ascending and deduped, and stay
        unmutated until finish()/abort() (the encode may run
        concurrently)."""
        if len(rec) == 0:
            return
        m = self._meta.setdefault(measurement, {"schema": {}, "chunks": []})
        self._check_schema(m, rec)
        est = int(rec.times.nbytes) + sum(
            _col_nbytes(c) for c in rec.columns.values())
        self._pipe.submit(
            lambda: self._encode_job(measurement, sid, None, rec), est)

    def add_packed_chunk(self, measurement: str, sids: np.ndarray,
                         rec: Record) -> None:
        """One multi-series chunk: rows sorted by (sid, time). `sids` is
        int64, aligned with rec rows, non-decreasing; rows of one sid are
        time-sorted and deduped."""
        if len(rec) == 0:
            return
        m = self._meta.setdefault(measurement, {"schema": {}, "chunks": []})
        self._check_schema(m, rec)
        est = int(rec.times.nbytes) + int(sids.nbytes) + sum(
            _col_nbytes(c) for c in rec.columns.values())
        self._pipe.submit(
            lambda: self._encode_job(measurement, None, sids, rec), est)

    def finish(self) -> None:
        self._pipe.drain()  # every chunk lands before the meta freezes
        meta_buf = b"BM02" + zlib.compress(chunkmeta.encode_meta(self._meta), 1)
        meta_off = self._off
        tail = (meta_buf
                + _TRAILER.pack(meta_off, len(meta_buf), zlib.crc32(meta_buf))
                + END_MAGIC)
        if diskfault.armed():
            tail = diskfault.on_write(self.path, tail, site="tsf-meta-write")
        self._f.write(tail)
        self._f.flush()
        if diskfault.armed():
            diskfault.on_fsync(self.path, site="tsf-fsync")
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)  # atomic visibility

    def abort(self) -> None:
        self._pipe.abort()
        self._f.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)


# process-global file generations: a reader opened over a path that a
# compaction later rewrites in place gets a fresh number, so a
# (generation, chunk) cache key never aliases stale decoded data
_READER_GEN = itertools.count(1)


class TSFReader:
    def __init__(self, path: str):
        self.path = path
        # decoded-column cache identity (storage/colcache.py): gen is the
        # invalidation handle; owner_ns is stamped by the owning Shard
        self.gen = next(_READER_GEN)
        self.owner_ns: int | None = None
        # the per-file LRU that serves while colcache is disabled
        self._col_cache: OrderedDict = OrderedDict()
        self._cache_bytes = 0
        self._cache_lock = lockdep.Lock()
        self._f = open(path, "rb")
        try:
            self._open(path)
        except BaseException:
            self._f.close()
            raise

    def _open(self, path: str) -> None:
        self._f.seek(0, os.SEEK_END)
        size = self._f.tell()
        tail = _TRAILER.size + len(END_MAGIC)
        if size < len(MAGIC) + tail:
            raise CorruptFile(path, "too small")
        head = os.pread(self._f.fileno(), len(MAGIC), 0)
        if diskfault.armed():
            head = diskfault.on_read(path, head, site="tsf-open-read")
        if head == MAGIC2:
            self.block_crc = True  # every block carries a crc32 seal
        elif head == MAGIC:
            self.block_crc = False  # legacy: readable, nothing to verify
        else:
            raise CorruptFile(path, "bad magic")
        self._f.seek(size - tail)
        trailer = self._f.read(tail)
        if diskfault.armed():
            trailer = diskfault.on_read(path, trailer, site="tsf-open-read")
        if trailer[-len(END_MAGIC):] != END_MAGIC:
            raise CorruptFile(path, "bad end magic")
        meta_off, meta_len, meta_crc = _TRAILER.unpack(trailer[:_TRAILER.size])
        self._f.seek(meta_off)
        meta_buf = self._f.read(meta_len)
        if diskfault.armed():
            meta_buf = diskfault.on_read(path, meta_buf, site="tsf-open-read")
        if zlib.crc32(meta_buf) != meta_crc:
            raise CorruptFile(path, "meta crc mismatch")
        if meta_buf[:4] == b"BM02":
            raw = chunkmeta.decode_meta(zlib.decompress(meta_buf[4:]))
        else:
            raw = json.loads(zlib.decompress(meta_buf))
        # mst -> (schema, [ChunkMeta])
        self.meta: dict[str, tuple[dict, list[ChunkMeta]]] = {}
        self.tmin: int | None = None
        self.tmax: int | None = None
        for mst, m in raw.items():
            schema = {k: FieldType(v) for k, v in m["schema"].items()}
            chunks = []
            for c in m["chunks"]:
                cols = {
                    name: {
                        "v": tuple(cc["v"]),
                        "m": tuple(cc["m"]) if cc["m"] else None,
                        "pre": PreAgg.from_json(cc["pre"]),
                    }
                    for name, cc in c["cols"].items()
                }
                if c.get("packed"):
                    cm = ChunkMeta(
                        None, c["rows"], c["tmin"], c["tmax"],
                        tuple(c["time"]), cols,
                        smin=c["smin"], smax=c["smax"],
                        sid_loc=tuple(c["sids"]),
                        sparse=[(p0, p1) for p0, p1 in c["sparse"]],
                    )
                else:
                    cm = ChunkMeta(c["sid"], c["rows"], c["tmin"], c["tmax"],
                                   tuple(c["time"]), cols)
                chunks.append(cm)
                if self.tmin is None or cm.tmin < self.tmin:
                    self.tmin = cm.tmin
                if self.tmax is None or cm.tmax > self.tmax:
                    self.tmax = cm.tmax
            self.meta[mst] = (schema, chunks)
        # per-(mst, sid) chunk lists: single-series lookups cost O(own
        # chunks); packed chunks are listed apart and filtered by their
        # [smin, smax] span. The per-measurement sid bloom rejects a
        # series the per-sid chunks cannot hold in O(k)
        self._sid_chunks: dict[str, dict[int, list[ChunkMeta]]] = {}
        self._packed_chunks: dict[str, list[ChunkMeta]] = {}
        self._sid_bloom: dict[str, BloomFilter] = {}
        for mst, (_s, chunks) in self.meta.items():
            by_sid: dict[int, list[ChunkMeta]] = {}
            packed: list[ChunkMeta] = []
            bf = BloomFilter(len(chunks))
            for c in chunks:
                if c.packed:
                    packed.append(c)
                else:
                    bf.add(c.sid)
                    by_sid.setdefault(c.sid, []).append(c)
            self._sid_chunks[mst] = by_sid
            self._sid_bloom[mst] = bf
            self._packed_chunks[mst] = packed

    def close(self) -> None:
        self._f.close()

    def measurements(self) -> list[str]:
        return list(self.meta)

    def schema(self, measurement: str) -> dict[str, FieldType]:
        entry = self.meta.get(measurement)
        return entry[0] if entry else {}

    def chunks(
        self,
        measurement: str,
        sids: set[int] | None = None,
        tmin: int | None = None,
        tmax: int | None = None,
    ) -> list[ChunkMeta]:
        """Chunk metas matching series + time range (tmax exclusive) —
        the block-skip step."""
        entry = self.meta.get(measurement)
        if entry is None:
            return []
        packed = self._packed_chunks.get(measurement, ())
        if sids is not None and len(sids) == 1:
            sid = next(iter(sids))
            bf = self._sid_bloom.get(measurement)
            if bf is not None and sid not in bf:
                cand = ()
            else:
                cand = self._sid_chunks.get(measurement, {}).get(sid, ())
        else:
            cand = entry[1]
        out = []
        for c in cand:
            if c.packed:
                continue  # appended below with the sid-span filter
            if sids is not None and c.sid not in sids:
                continue
            if tmin is not None and c.tmax < tmin:
                continue
            if tmax is not None and c.tmin >= tmax:
                continue
            out.append(c)
        for c in packed:
            if sids is not None and not any(
                    c.smin <= s_ <= c.smax for s_ in sids):
                continue
            if tmin is not None and c.tmax < tmin:
                continue
            if tmax is not None and c.tmin >= tmax:
                continue
            out.append(c)
        return out

    def _read(self, loc: tuple[int, int]) -> bytes:
        # positioned read: concurrent query threads share this fd
        buf = os.pread(self._f.fileno(), loc[1], loc[0])
        if diskfault.armed():
            buf = diskfault.on_read(self.path, buf, site="tsf-block-read")
        if len(buf) != loc[1]:
            raise CorruptFile(
                self.path,
                f"short read at {loc[0]}: {len(buf)}/{loc[1]} bytes")
        if not self.block_crc:
            return buf  # legacy revision-1 file: no seal to verify
        payload, seal = buf[:-_BLOCK_CRC.size], buf[-_BLOCK_CRC.size:]
        if zlib.crc32(payload) != _BLOCK_CRC.unpack(seal)[0]:
            raise CorruptFile(
                self.path, f"block crc mismatch at offset {loc[0]}")
        return payload

    def read_times(self, chunk: ChunkMeta) -> np.ndarray:
        return encoding.decode_ints(self._read(chunk.time_loc))

    # decoded-column caching: hot chunks decode once, not per query.
    # Safe because TSF files are immutable and no read path mutates
    # decoded arrays in place. With the process-wide cache enabled
    # (OGT_COLCACHE_MB > 0) columns live there with explicit
    # invalidation at every file-set swap; with it disabled, the
    # per-open-file LRU below serves, bit-identically.
    _CACHE_BYTES = 16 << 20  # decoded-bytes budget per open file

    @staticmethod
    def _val_nbytes(val) -> int:
        if getattr(val, "is_decoded", True) is False:
            # still-encoded numeric column: one shared accounting rule
            # (record.EncodedColumn), never firing the lazy decode
            return val.accounted_nbytes()
        if isinstance(val, Column):
            return int(val.values.nbytes if hasattr(val.values, "nbytes")
                       else len(val.values) * 64) + int(val.valid.nbytes)
        return int(getattr(val, "nbytes", 64))

    def _colcache_key(self, chunk: ChunkMeta, name):
        # (shard id, file generation, chunk id, series, field): the sid
        # is the chunk's own for per-series chunks, None for packed
        # chunks (whose columns cache whole; a sid's rows are a binary
        # search over the cached arrays)
        return (self.owner_ns, self.gen, id(chunk), chunk.sid, name)

    def _cached_col(self, chunk: ChunkMeta, name, decode):
        """Decode-once lookup of one column of one chunk: `name` is the
        field name, None for the time column, "\\x00sids" for a packed
        chunk's sid column."""
        cc = colcache.GLOBAL
        if cc.enabled():
            key = self._colcache_key(chunk, name)
            got = cc.get(key)
            if got is not None:
                return got
            val = decode()
            cc.put(key, val)
            return val
        key = (id(chunk), name)
        with self._cache_lock:
            got = self._col_cache.get(key)
            if got is not None:
                self._col_cache.move_to_end(key)
                return got
        val = decode()
        nb = self._val_nbytes(val)
        if nb > self._CACHE_BYTES:
            return val  # a single oversized column never enters the cache
        with self._cache_lock:
            if key not in self._col_cache:
                self._col_cache[key] = val
                self._cache_bytes += nb
            self._col_cache.move_to_end(key)
            while self._cache_bytes > self._CACHE_BYTES and self._col_cache:
                _k, old = self._col_cache.popitem(last=False)
                self._cache_bytes -= self._val_nbytes(old)
        return val

    def read_chunk(self, measurement: str, chunk: ChunkMeta,
                   fields: list[str] | None = None, cache: bool = True,
                   encoded_ok: bool = False) -> Record:
        """``encoded_ok=True`` (the device-decode scans) returns numeric
        value columns whose blocks are device-decodable as still-encoded
        record.EncodedColumn: the CRC seal is verified here as always,
        the payload decode is deferred to the card (or to the column's
        lazy host decode). Times and masks always decode on the host
        (they drive window and run planning)."""
        schema = self.schema(measurement)

        def times_decode():
            return self.read_times(chunk)

        times = (self._cached_col(chunk, None, times_decode)
                 if cache else times_decode())
        cols = {}
        names = fields if fields is not None else list(chunk.cols)
        for name in names:
            loc = chunk.cols.get(name)
            if loc is None:
                continue

            def decode(loc=loc, name=name):
                vbuf = self._read(loc["v"])
                mbuf = self._read(loc["m"]) if loc["m"] else b""
                ftype = schema[name]
                if encoded_ok and ftype in (FieldType.FLOAT,
                                            FieldType.INT):
                    db = encoding.device_block(vbuf)
                    if db is not None:
                        return EncodedColumn(
                            ftype, [vbuf], encoding.decode_mask(mbuf, db.n),
                            encoding.decode_value_blocks)
                return encoding.decode_column(ftype, vbuf, mbuf)

            cols[name] = (self._cached_col(chunk, name, decode)
                          if cache else decode())
        return Record(times, cols)

    def _chunk_from_cache(self, chunk: ChunkMeta,
                          fields: list[str] | None) -> Record | None:
        """The consult-before-dispatch path: a chunk Record assembled
        purely from cached columns, or None on any miss (the caller then
        decodes through the scan pool). No IO, no decode."""
        cc = colcache.GLOBAL
        if not cc.enabled():
            return None
        t0 = time.perf_counter_ns()
        times = cc.peek(self._colcache_key(chunk, None))
        if times is None:
            return None
        cols = {}
        names = fields if fields is not None else list(chunk.cols)
        for name in names:
            if name not in chunk.cols:
                continue
            col = cc.peek(self._colcache_key(chunk, name))
            if col is None:
                return None
            cols[name] = col
        cc.count_peek(1 + len(cols), time.perf_counter_ns() - t0)
        return Record(times, cols)

    def read_chunk_if_cached(self, measurement: str, chunk: ChunkMeta,
                             fields: list[str] | None = None
                             ) -> Record | None:
        return self._chunk_from_cache(chunk, fields)

    # -- packed (PK-sorted column store) reads ------------------------------

    def read_packed_sids(self, chunk: ChunkMeta,
                         cache: bool = True) -> np.ndarray:
        """The sid column of a packed chunk (non-decreasing int64)."""
        def decode():
            return encoding.decode_ints(self._read(chunk.sid_loc))

        return (self._cached_col(chunk, "\x00sids", decode)
                if cache else decode())

    @staticmethod
    def _sid_row_range(chunk: ChunkMeta, sids: np.ndarray,
                       sid: int) -> tuple[int, int]:
        """[lo, hi) row window of one sid inside a packed chunk: the
        sparse PK index bounds the candidates, an exact binary search on
        the sid column finds the run."""
        sp = chunk.sparse or []
        entry_sids = [e[0] for e in sp]
        j = bisect.bisect_left(entry_sids, sid)
        w_lo = sp[j - 1][1] if j > 0 else 0
        k = bisect.bisect_right(entry_sids, sid)
        w_hi = sp[k][1] if k < len(sp) else chunk.rows
        win = sids[w_lo:w_hi]
        lo = w_lo + int(np.searchsorted(win, sid, "left"))
        hi = w_lo + int(np.searchsorted(win, sid, "right"))
        return lo, hi

    @staticmethod
    def _slice_rows(rec: Record, lo: int, hi: int) -> Record:
        """Row window [lo, hi) of a chunk record. Plain columns slice as
        views; EncodedColumns compose an encoded row-run view."""
        cols = {}
        for name, col in rec.columns.items():
            if isinstance(col, EncodedColumn):
                cols[name] = col.take(np.arange(lo, hi))
            else:
                cols[name] = Column(col.ftype, col.values[lo:hi],
                                    col.valid[lo:hi])
        return Record(rec.times[lo:hi], cols)

    def read_packed_sid(self, measurement: str, chunk: ChunkMeta, sid: int,
                        fields: list[str] | None = None, cache: bool = True,
                        encoded_ok: bool = False) -> Record:
        """One series' rows out of a packed chunk: the sparse PK index
        bounds the candidate row window, a binary search on the sid
        column finds the rows."""
        if sid < chunk.smin or sid > chunk.smax:
            return Record(np.empty(0, np.int64), {})
        sids = self.read_packed_sids(chunk, cache)
        lo, hi = self._sid_row_range(chunk, sids, sid)
        if lo == hi:
            return Record(np.empty(0, np.int64), {})
        rec = self.read_chunk(measurement, chunk, fields, cache,
                              encoded_ok=encoded_ok)
        return self._slice_rows(rec, lo, hi)

    def read_packed_sid_if_cached(self, measurement: str, chunk: ChunkMeta,
                                  sid: int, fields: list[str] | None = None
                                  ) -> Record | None:
        """read_packed_sid served purely from cached columns, or None on
        any miss. Out-of-span sids answer the empty record directly."""
        if sid < chunk.smin or sid > chunk.smax:
            return Record(np.empty(0, np.int64), {})
        cc = colcache.GLOBAL
        if not cc.enabled():
            return None
        sids = cc.peek(self._colcache_key(chunk, "\x00sids"))
        if sids is None:
            return None
        lo, hi = self._sid_row_range(chunk, sids, sid)
        if lo == hi:
            cc.count_peek(1)
            return Record(np.empty(0, np.int64), {})
        rec = self._chunk_from_cache(chunk, fields)
        if rec is None:
            return None
        cc.count_peek(1)  # the sid-column peek on top of the record's
        return self._slice_rows(rec, lo, hi)

    def read_packed_bulk(self, measurement: str, chunk: ChunkMeta,
                         fields: list[str] | None = None,
                         sid_filter: np.ndarray | None = None,
                         cache: bool = True, encoded_ok: bool = False,
                         ) -> tuple[np.ndarray, Record]:
        """(sids, record) of a packed chunk in ONE decode; when
        `sid_filter` (sorted int64 array) is given, rows are masked to
        those series. A filter that drops rows slices the columns, which
        host-decodes the lazy ones (bit-identically)."""
        sids = self.read_packed_sids(chunk, cache)
        rec = self.read_chunk(measurement, chunk, fields, cache,
                              encoded_ok=encoded_ok)
        return self._packed_bulk_filter(sids, rec, sid_filter)

    def read_packed_bulk_if_cached(
        self, measurement: str, chunk: ChunkMeta,
        fields: list[str] | None = None,
        sid_filter: np.ndarray | None = None,
    ) -> tuple[np.ndarray, Record] | None:
        """read_packed_bulk served purely from cached columns, or None on
        any miss (the sid filter applies per call: cached columns stay
        whole, so every sid set shares one entry)."""
        cc = colcache.GLOBAL
        if not cc.enabled():
            return None
        sids = cc.peek(self._colcache_key(chunk, "\x00sids"))
        if sids is None:
            return None
        rec = self._chunk_from_cache(chunk, fields)
        if rec is None:
            return None
        cc.count_peek(1)
        return self._packed_bulk_filter(sids, rec, sid_filter)

    @staticmethod
    def _packed_bulk_filter(sids, rec, sid_filter):
        if sid_filter is None:
            return sids, rec
        keep = np.isin(sids, sid_filter)
        if keep.all():
            return sids, rec
        return sids[keep], Record(
            rec.times[keep],
            {
                name: Column(col.ftype, col.values[keep], col.valid[keep])
                for name, col in rec.columns.items()
            },
        )

    # -- whole-file checks (compaction's output self-check) ------------------

    def data_locs(self) -> list[tuple[int, int]]:
        """Every data block (off, len) of this file in a stable order."""
        out: list[tuple[int, int]] = []
        for mst in sorted(self.meta):
            for c in self.meta[mst][1]:
                out.append(c.time_loc)
                if c.sid_loc:
                    out.append(c.sid_loc)
                for name in sorted(c.cols):
                    cc = c.cols[name]
                    out.append(cc["v"])
                    if cc["m"]:
                        out.append(cc["m"])
        return out

    def verify_block(self, loc: tuple[int, int]) -> int:
        """Read and CRC-check one block without decoding or caching it;
        returns the bytes read. Raises CorruptFile on a mismatch."""
        self._read(loc)
        return loc[1]


class CorruptFile(Exception):
    """Media-level damage detected in a TSF file (bad magic/trailer,
    meta CRC mismatch, short block read, block CRC mismatch)."""

    def __init__(self, path: str, why: str):
        super().__init__(f"corrupt TSF file {path}: {why}")
        self.path = path
        self.why = why
