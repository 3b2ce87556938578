"""Engine: databases -> retention policies -> time-partitioned shards.

The port of ``opengemini_tpu/storage/engine.py``, reduced to this
slice: databases with their default retention policy, shard groups by
time (Go-Truncate aligned, ``shard_group_start``), ``write_lines``
through the Python line-protocol parser, ``write_rows`` for structured
points, the columnar route (``write_columnar``) and ``shards_for_range``.
Shards live in memory (see storage/shard.py); metadata is not persisted.

``Engine(root, device=None)`` holds the device every query on it runs
on: CUDA unless the caller names another (``device="cpu"`` in the
tests); without CUDA the default raises.
"""

from __future__ import annotations

import threading
import time as _time

import numpy as np

from opengemini_tpu_torch.device import resolve_device
from opengemini_tpu_torch.ingest import line_protocol as lp
from opengemini_tpu_torch.storage.shard import Shard
from opengemini_tpu_torch.utils.stats import incr as _incr

NS = 1_000_000_000
DEFAULT_SHARD_DURATION = 7 * 24 * 3600 * NS  # influx 1w default for infinite RPs

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
    def __init__(self, name: str,
                 shard_duration_ns: int = DEFAULT_SHARD_DURATION):
        self.name = name
        self.shard_duration_ns = shard_duration_ns


class Database:
    def __init__(self, name: str):
        self.name = name
        self.rps: dict[str, RetentionPolicy] = {}
        self.default_rp = "autogen"


class WriteError(Exception):
    pass


class DatabaseNotFound(WriteError):
    def __init__(self, name: str):
        super().__init__(f"database not found: {name!r}")


class Engine:
    """Single-node in-memory storage engine with embedded metadata."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.databases: dict[str, Database] = {}
        # (db, rp, group_start) -> Shard
        self._shards: dict[tuple[str, str, int], Shard] = {}

    # -- metadata -----------------------------------------------------------

    def create_database(self, name: str) -> None:
        _check_namespace_name(name, "database")
        with self._lock:
            if name in self.databases:
                return
            db = Database(name)
            db.rps["autogen"] = RetentionPolicy("autogen")
            self.databases[name] = db

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
            shard = Shard(group_start, group_start + dur)
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
        parser. Returns points written."""
        rp = self._db_rp(db, rp)
        if now_ns is None:
            now_ns = _time.time_ns()
        points = lp.parse_lines(lines, precision, now_ns)
        if not points:
            return 0
        return self.write_rows(db, points, rp=rp)

    def write_rows(self, db: str, points: list, rp: str | None = None) -> int:
        """Structured write path: points are (measurement, tags tuple,
        t_ns, {field: (FieldType, value)})."""
        rp = self._db_rp(db, rp)
        with self._lock:
            # group points by target shard (time routing)
            by_shard: dict[int, list] = {}
            shards: dict[int, Shard] = {}
            for p in points:
                shard = self._get_or_create_shard(db, rp, p[2])
                key = id(shard)
                shards[key] = shard
                by_shard.setdefault(key, []).append(p)
            n = 0
            for key, pts in by_shard.items():
                n += shards[key].write_points(pts)
        _incr("write/points", n)
        return n

    def write_columnar(self, db: str, batch, rp: str | None = None) -> int:
        """Route a ColumnarBatch (ingest/native_lp.py) to its time shards
        and slab-write each. Returns rows written."""
        rp = self._db_rp(db, rp)
        if len(batch) == 0:
            return 0
        with self._lock:
            n = self._write_columnar_locked(db, rp, batch)
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

    def _write_columnar_locked(self, db: str, rp: str, batch) -> int:
        routed = list(self._route_columnar_locked(db, rp, batch))
        # every shard checks its types before any of them applies: a
        # rejected batch leaves nothing behind
        for shard, rows in routed:
            shard._check_columnar_types(batch, rows)
        return sum(shard.write_columnar(batch, rows) for shard, rows in routed)
