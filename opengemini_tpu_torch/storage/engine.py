"""Engine: databases -> retention policies -> time-partitioned shards.

The port of ``opengemini_tpu/storage/engine.py``, reduced to this
slice. A root persists across restarts exactly as the reference lays it
out, so either package reopens a root the other wrote:

  <root>/meta.json                        databases and retention policies
  <root>/data/<db>/<rp>/<group_start>/    one shard (storage/shard.py)

Writes: ``write_lines`` (the Python line-protocol parser), ``write_rows``
(structured points) and ``load_columnar_batches`` (the bulk load behind
``convert.load_columnar``, logged as line-protocol text that
ingest/native_lp.LineWriter writes). Each logs every batch to the shard
WALs before it applies it and flushes a shard whose memtable passes
``flush_threshold_bytes`` (64 MiB by default). No path acknowledges rows
that neither a WAL nor a TSF file holds.

``Engine(root, device=None)`` holds the device every query on it runs
on: CUDA unless the caller names another (``device="cpu"`` in the
tests); without CUDA the default raises.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time

import numpy as np

from opengemini_tpu_torch.device import resolve_device
from opengemini_tpu_torch.ingest import line_protocol as lp
from opengemini_tpu_torch.ingest.native_lp import LineWriter
from opengemini_tpu_torch.storage.shard import Shard
from opengemini_tpu_torch.utils.stats import incr as _incr

NS = 1_000_000_000
DEFAULT_SHARD_DURATION = 7 * 24 * 3600 * NS  # influx 1w default for infinite RPs
# rows of a bulk load per WAL entry (and per threshold-flush check)
LOAD_ROWS = 1 << 17

# Go time.Time zero (year 1, Jan 1 — a Monday) relative to the Unix epoch:
# shard groups align with Go's Truncate, which rounds to multiples of the
# duration SINCE THE ZERO TIME, so 7d groups start on Mondays. The offset
# in ns overflows int64, so alignment uses its residue mod the duration.
_GO_ZERO_S = -62135596800  # seconds; *NS overflows int64


def _check_namespace_name(name: str, what: str) -> None:
    if not name or any(c in name for c in "|/\\\n\r\0") or name in (".", ".."):
        raise WriteError(f"invalid {what} name {name!r}")


def _go_phase_ns(dur_ns: int) -> int:
    return (_GO_ZERO_S * NS) % dur_ns  # python ints: exact, non-negative


def shard_group_start(t_ns: int, dur_ns: int) -> int:
    """Shard-group start containing t_ns: Go Truncate alignment."""
    phase = _go_phase_ns(dur_ns)
    return (t_ns - phase) // dur_ns * dur_ns + phase


class RetentionPolicy:
    def __init__(self, name: str, duration_ns: int = 0,
                 shard_duration_ns: int = DEFAULT_SHARD_DURATION):
        self.name = name
        self.duration_ns = duration_ns  # 0 = infinite
        self.shard_duration_ns = shard_duration_ns

    def to_json(self):
        return {
            "name": self.name,
            "duration_ns": self.duration_ns,
            "shard_duration_ns": self.shard_duration_ns,
        }

    @classmethod
    def from_json(cls, j):
        return cls(j["name"], j["duration_ns"], j["shard_duration_ns"])


class Database:
    def __init__(self, name: str):
        self.name = name
        self.rps: dict[str, RetentionPolicy] = {}
        self.default_rp = "autogen"
        # keys of meta.json this port does not interpret (continuous
        # queries, downsample policies, rollups, ... of a root the JAX
        # package wrote): kept as read and written back unchanged
        self.extra: dict = {}


class WriteError(Exception):
    pass


class DatabaseNotFound(WriteError):
    def __init__(self, name: str):
        super().__init__(f"database not found: {name!r}")


class Engine:
    """Single-node storage engine with embedded metadata."""

    def __init__(self, root: str, device=None, sync_wal: bool = False,
                 flush_threshold_bytes: int = 64 << 20):
        self.root = root
        self.device = resolve_device(device)
        self.sync_wal = sync_wal
        self.flush_threshold_bytes = flush_threshold_bytes
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self.databases: dict[str, Database] = {}
        self._meta_extra: dict = {}
        # (db, rp, group_start) -> Shard
        self._shards: dict[tuple[str, str, int], Shard] = {}
        self._load_meta()
        self._load_shards()

    # -- metadata -----------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.root, "meta.json")

    def _load_meta(self) -> None:
        p = self._meta_path()
        if not os.path.exists(p):
            return
        with open(p, encoding="utf-8") as f:
            j = json.load(f)
        for dbj in j.get("databases", []):
            db = Database(dbj["name"])
            db.default_rp = dbj.get("default_rp", "autogen")
            for rpj in dbj.get("rps", []):
                rp = RetentionPolicy.from_json(rpj)
                db.rps[rp.name] = rp
            db.extra = {k: v for k, v in dbj.items()
                        if k not in ("name", "default_rp", "rps")}
            self.databases[db.name] = db
        self._meta_extra = {k: v for k, v in j.items() if k != "databases"}

    def _save_meta(self) -> None:
        j = dict(self._meta_extra)
        j.setdefault("obs_shards", [])
        j["databases"] = [
            {"name": db.name, "default_rp": db.default_rp,
             "rps": [rp.to_json() for rp in db.rps.values()], **db.extra}
            for db in self.databases.values()
        ]
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(j, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())

    def create_database(self, name: str) -> None:
        _check_namespace_name(name, "database")
        with self._lock:
            if name in self.databases:
                return
            db = Database(name)
            db.rps["autogen"] = RetentionPolicy("autogen")
            self.databases[name] = db
            self._save_meta()

    # -- shards -------------------------------------------------------------

    def _shard_dir(self, db: str, rp: str, group_start: int) -> str:
        return os.path.join(self.root, "data", db, rp, str(group_start))

    def _load_shards(self) -> None:
        data_dir = os.path.join(self.root, "data")
        if not os.path.isdir(data_dir):
            return
        for db in os.listdir(data_dir):
            for rp in os.listdir(os.path.join(data_dir, db)):
                d = self.databases.get(db)
                rp_meta = d.rps.get(rp) if d else None
                dur = (rp_meta.shard_duration_ns if rp_meta
                       else DEFAULT_SHARD_DURATION)
                for g in os.listdir(os.path.join(data_dir, db, rp)):
                    start = int(g)
                    self._shards[(db, rp, start)] = Shard(
                        self._shard_dir(db, rp, start), start, start + dur,
                        self.sync_wal)

    def _get_or_create_shard(self, db: str, rp: str, t_ns: int) -> Shard:
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        rp_meta = d.rps.get(rp)
        if rp_meta is None:
            raise WriteError(f"retention policy not found: {db}.{rp}")
        dur = rp_meta.shard_duration_ns
        group_start = shard_group_start(t_ns, dur)
        key = (db, rp, group_start)
        shard = self._shards.get(key)
        if shard is None:
            shard = Shard(self._shard_dir(db, rp, group_start), group_start,
                          group_start + dur, self.sync_wal)
            self._shards[key] = shard
        return shard

    def shards_for_range(self, db: str, rp: str | None, tmin: int,
                         tmax: int) -> list[Shard]:
        """Shards overlapping [tmin, tmax) — the shard-mapping step."""
        d = self.databases.get(db)
        if d is None:
            return []
        rp = rp or d.default_rp
        with self._lock:
            items = sorted(self._shards.items(), key=lambda kv: kv[0])
        return [sh for (sdb, srp, _s), sh in items
                if sdb == db and srp == rp and sh.tmin < tmax
                and sh.tmax > tmin]

    # -- write path ---------------------------------------------------------

    def _db_rp(self, db: str, rp: str | None) -> str:
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        return rp or d.default_rp

    def write_lines(self, db: str, lines: str | bytes, precision: str = "ns",
                    rp: str | None = None, now_ns: int | None = None) -> int:
        """Parse + route + apply a line-protocol batch with the Python
        parser; every target shard logs the raw batch to its WAL first
        (replay re-filters by time range). Returns points written."""
        rp = self._db_rp(db, rp)
        if now_ns is None:
            now_ns = _time.time_ns()
        raw = lines.encode("utf-8") if isinstance(lines, str) else lines
        points = lp.parse_lines(lines, precision, now_ns)
        if not points:
            return 0
        return self._write_points(db, rp, points, lambda sh, pts: (
            sh.write_points(pts, raw, precision, now_ns, defer_commit=True)))

    def write_rows(self, db: str, points: list, rp: str | None = None) -> int:
        """Structured write path: points are (measurement, tags tuple,
        t_ns, {field: (FieldType, value)}), WAL-logged as structured
        entries."""
        rp = self._db_rp(db, rp)
        return self._write_points(db, rp, points, lambda sh, pts: (
            sh.write_points_structured(pts, defer_commit=True)))

    def _write_points(self, db: str, rp: str, points: list, write) -> int:
        tickets = []
        with self._lock:
            # group points by target shard (time routing)
            by_shard: dict[int, list] = {}
            shards: dict[int, Shard] = {}
            for p in points:
                shard = self._get_or_create_shard(db, rp, p[2])
                shards[id(shard)] = shard
                by_shard.setdefault(id(shard), []).append(p)
            n = 0
            for key, pts in by_shard.items():
                got, ticket = write(shards[key], pts)
                n += got
                tickets.append((shards[key], ticket))
        # sync-WAL commits and threshold flushes run off the engine lock
        for shard, ticket in tickets:
            shard.wal.commit(ticket)
        for shard in shards.values():
            shard.flush_if_over(self.flush_threshold_bytes)
        _incr("write/points", n)
        return n

    def _route_columnar_locked(self, db: str, rp: str, batch):
        """Yield (shard, rows) for a ColumnarBatch (vectorized Go-Truncate
        alignment). Caller holds the engine lock; target shards are
        created here if missing."""
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        rp_meta = d.rps.get(rp)
        if rp_meta is None:
            raise WriteError(f"retention policy not found: {db}.{rp}")
        dur = rp_meta.shard_duration_ns
        phase = _go_phase_ns(dur)
        groups = (batch.ts - phase) // dur * dur + phase
        uniq = np.unique(groups)
        for g in uniq:
            shard = self._get_or_create_shard(db, rp, int(g))
            rows = None if len(uniq) == 1 else np.flatnonzero(groups == g)
            yield shard, rows

    def load_columnar_batches(self, db: str, batches,
                              rp: str | None = None) -> int:
        """Bulk load: route each ColumnarBatch (ingest/native_lp.py) to
        its time shards and write it LOAD_ROWS rows at a time, each part
        logged to the shard's WAL as line protocol before it applies, and
        each followed by the threshold flush. Rows with no valid field
        are left out (a line needs one). Returns rows written."""
        rp = self._db_rp(db, rp)
        now_ns = _time.time_ns()
        n = 0
        for batch in batches:
            if len(batch) == 0:
                continue
            has_field = np.zeros(len(batch), dtype=np.bool_)
            for *_c, valid in batch.cols:
                has_field |= valid
            with self._lock:
                routed = list(self._route_columnar_locked(db, rp, batch))
                # every shard checks its types before any of them
                # applies: a rejected batch leaves nothing behind
                for shard, rows in routed:
                    shard._check_columnar_types(batch, rows)
            writer = LineWriter(batch)
            for shard, rows in routed:
                rows = np.flatnonzero(has_field) if rows is None else (
                    rows[has_field[rows]])
                for lo in range(0, len(rows), LOAD_ROWS):
                    part = rows[lo:lo + LOAD_ROWS]
                    text = writer.lines(part)
                    with self._lock:
                        got, ticket = shard.write_columnar(
                            batch, part, text, "ns", now_ns,
                            defer_commit=True)
                    # as in _write_points: off the engine lock
                    shard.wal.commit(ticket)
                    shard.flush_if_over(self.flush_threshold_bytes)
                    n += got
        _incr("write/points", n)
        return n

    def flush_all(self) -> None:
        with self._lock:
            shards = list(self._shards.values())
        for shard in shards:
            shard.flush()

    def close(self) -> None:
        with self._lock:
            for shard in self._shards.values():
                shard.close()
            self._shards.clear()
