"""Engine: databases -> retention policies -> time-partitioned shards.

The port of ``opengemini_tpu/storage/engine.py``, reduced to this
slice. A root persists across restarts exactly as the reference lays it
out, so either package reopens a root the other wrote:

  <root>/meta.json                        databases and retention policies
  <root>/data/<db>/<rp>/<group_start>/    one shard (storage/shard.py)

Writes: ``write_lines`` (the native line-protocol parser,
ingest/native_lp.parse_columnar over native/lineproto.cpp, large bodies
split at line boundaries and parsed on a thread pool; the Python parser
only for a body the native one hands back), ``write_rows`` (structured
points) and ``load_columnar_batches`` (the bulk load behind
``convert.load_columnar``, logged as line-protocol text that
ingest/native_lp.LineWriter writes). Each logs every batch to the shard
WALs before it applies it and flushes a shard whose memtable passes
``flush_threshold_bytes`` (64 MiB by default). No path acknowledges rows
that neither a WAL nor a TSF file holds.

Metadata: ``create_database``, ``drop_database``, the retention
policies (``create_``, ``alter_``, ``drop_retention_policy``, with the
reference's automatic shard durations) and DROP MEASUREMENT's mark
(``mark_measurement_delete``, kept in meta.json ``dropped_msts`` as the
reference keeps it). A marked measurement is hidden from SELECT and the
metadata SHOWs until ``purge_dropped_measurements`` deletes its rows
and series (storage/shard.py ``delete_data``); a write to a database
with marks purges first, so old rows never resurface under a recreated
name.

Cluster operations: ``disk_usage`` (the balancer's load), the
two-phase migration's staging (``begin_``, ``write_``, ``commit_``,
``abort_``, ``close_`` and ``expire_staging``, ``staging_ids``: an
invisible shard under ``<root>/staging/<mig_id>`` and a durable
``<mig_id>.committed`` marker, the reference's layout) and
``drop_shard``. Every flush a write or ``flush_all`` starts goes through
``_flush_tolerating_drop``: a shard a concurrent DROP removed may fail
its flush, a live one raises.

Media damage: ``quarantine_snapshot`` lists every shard's quarantined
files (``/debug/vars`` serves it), ``purge_quarantined`` deletes them,
and the ``quarantine`` stats provider reports ``files_current``. The
meta.json save passes the disk-fault hooks (storage/diskfault.py), and
the write path has the reference's failpoints after the engine lock
drops (``engine-before-wal-commit``, ``engine-before-threshold-flush``).

The continuous tier: continuous queries (``create_``/
``drop_continuous_query``, run by services/continuous.py), streams
(``create_``/``drop_stream``; services/stream.py folds the writes it
observes through ``add_write_observer``), downsample policies
(``set_downsample_policies``; ``run_downsample`` rewrites the aged
shards on the engine's device, services/downsample.py), retention
(``drop_expired_shards``, services/retention.py) and materialized
rollups (``create_rollup``; storage/rollup.py's manager exists only
while a spec is declared and ``OGT_ROLLUP`` is not 0, and every write
path marks its late windows dirty before the rows apply). meta.json
keeps them under the reference's keys (``cqs``, ``downsample``,
``streams``, ``rollups``, ``subscriptions``: services/subscriber.py's
``Subscription``s, which ``create_``/``drop_subscription`` change); any
key this port does not interpret is kept as read and written back
unchanged. The memtable and WAL backlog is the resource governor's
``memtable`` ledger component (utils/governor.py).

The rule engine (promql/rules.py) sets ``rules_hook`` while it runs
(None keeps every write path as it is: one attribute check): every
write path marks the tiles its rows touch before they apply and
releases the mark once they are readable, as for rollups. DROP DATABASE
removes the database's rule state. ``models`` is the fitted
anomaly-detection models' store (services/castor.py ``ModelStore``,
``<root>/models/``).

The durability ledger: ``durability_snapshot`` sums every shard's
acknowledged-against-durable row counts (storage/shard.py
``DurabilityLedger``), ``durability_check`` lists the clean shards that
do not conserve rows, and the ``durability`` stats provider serves the
totals. A shard directory that hierarchical storage moved to the cold
tier (a symlink) is removed with its cold copy.

The tag-array write mode (``tag_arrays``, the reference's per-database
enableTagArray) expands ``host=[a,b]`` into one point per value: such
bodies take the Python parser, and every shard's WAL replay expands them
alike. The object-store tier (storage/objstore.py): ``offload_shard``
moves an idle group into the attached store and registers it in
``meta.json``'s ``obs_shards``; a query or a write over that range
hydrates it back (``shards_for_range``, ``_get_or_create_shard``), and
DROP DATABASE, DROP RETENTION POLICY, ``drop_shard`` and retention
delete its objects after the registry, outside the engine lock.

``Engine(root, device=None)`` holds the device every query on it runs
on: CUDA unless the caller names another (``device="cpu"`` in the
tests); without CUDA the default raises.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time as _time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from opengemini_tpu_torch.device import resolve_device
from opengemini_tpu_torch.ingest import line_protocol as lp
from opengemini_tpu_torch.ingest import native_lp
from opengemini_tpu_torch.ingest.native_lp import LineWriter
from opengemini_tpu_torch.record import FieldTypeConflict
from opengemini_tpu_torch.storage import diskfault
from opengemini_tpu_torch.storage.shard import Shard
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.failpoint import inject as _fp
from opengemini_tpu_torch.utils.governor import GOVERNOR
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

NS = 1_000_000_000
DEFAULT_SHARD_DURATION = 7 * 24 * 3600 * NS  # influx 1w default for infinite RPs
# rows of a bulk load per WAL entry (and per threshold-flush check)
LOAD_ROWS = 1 << 17

# Go time.Time zero (year 1, Jan 1 — a Monday) relative to the Unix epoch:
# shard groups align with Go's Truncate, which rounds to multiples of the
# duration SINCE THE ZERO TIME, so 7d groups start on Mondays. The offset
# in ns overflows int64, so alignment uses its residue mod the duration.
_GO_ZERO_S = -62135596800  # seconds; *NS overflows int64


# -- multi-core ingest pool ------------------------------------------------------
_INGEST_WORKERS = int(os.environ.get("OGT_INGEST_WORKERS", "0")) or (
    len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
    else (os.cpu_count() or 1))
_INGEST_SEGMENT_BYTES = 1 << 20  # split target; bodies below 2 MiB stay whole
_NEEDS_PYTHON_PARSER = object()  # _write_segmented: skip the native re-parse
_ingest_pool_obj = None
_ingest_pool_lock = lockdep.Lock()


def _ingest_pool():
    """The shared parse pool, or None on a one-core host (threads only
    add overhead when the C parser has one core to release the GIL to)."""
    global _ingest_pool_obj
    if _INGEST_WORKERS < 2:
        return None
    if _ingest_pool_obj is None:
        with _ingest_pool_lock:
            if _ingest_pool_obj is None:
                _ingest_pool_obj = ThreadPoolExecutor(
                    max_workers=_INGEST_WORKERS,
                    thread_name_prefix="ogt-ingest")
    return _ingest_pool_obj


def _split_lp_segments(raw: bytes, n: int) -> list[bytes]:
    """Split a line-protocol body into at most n segments at line
    boundaries."""
    target = max(len(raw) // n, _INGEST_SEGMENT_BYTES)
    segs, start = [], 0
    while start < len(raw) and len(segs) < n - 1:
        cut = raw.find(b"\n", start + target)
        if cut == -1:
            break
        segs.append(raw[start:cut + 1])
        start = cut + 1
    if start < len(raw):
        segs.append(raw[start:])
    return segs


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


class ContinuousQuery:
    """A registered continuous query (services/continuous.py runs it)."""

    def __init__(self, name: str, select_text: str, resample_every_ns: int = 0,
                 resample_for_ns: int = 0, last_run_ns: int = 0):
        self.name = name
        self.select_text = select_text
        self.resample_every_ns = resample_every_ns
        self.resample_for_ns = resample_for_ns
        self.last_run_ns = last_run_ns

    def to_json(self):
        return {
            "name": self.name,
            "select_text": self.select_text,
            "resample_every_ns": self.resample_every_ns,
            "resample_for_ns": self.resample_for_ns,
            "last_run_ns": self.last_run_ns,
        }

    @classmethod
    def from_json(cls, j):
        return cls(j["name"], j["select_text"], j.get("resample_every_ns", 0),
                   j.get("resample_for_ns", 0), j.get("last_run_ns", 0))


class DownsamplePolicy:
    """Shard-rewrite policy: shards older than `age_ns` are rewritten at
    `every_ns` resolution."""

    def __init__(self, age_ns: int, every_ns: int, field_aggs: dict | None = None):
        self.age_ns = age_ns
        self.every_ns = every_ns
        self.field_aggs = field_aggs or {}  # field type name -> agg name

    def to_json(self):
        return {"age_ns": self.age_ns, "every_ns": self.every_ns,
                "field_aggs": self.field_aggs}

    @classmethod
    def from_json(cls, j):
        return cls(j["age_ns"], j["every_ns"], j.get("field_aggs", {}))


class StreamTask:
    """An at-ingest window aggregation task (services/stream.py)."""

    def __init__(self, name: str, select_text: str, delay_ns: int = 0):
        self.name = name
        self.select_text = select_text
        self.delay_ns = delay_ns

    def to_json(self):
        return {"name": self.name, "select_text": self.select_text,
                "delay_ns": self.delay_ns}

    @classmethod
    def from_json(cls, j):
        return cls(j["name"], j["select_text"], j.get("delay_ns", 0))


# the keys of a database's meta.json entry this port interprets
_DB_KEYS = ("name", "default_rp", "rps", "cqs", "downsample", "streams",
            "subscriptions", "dropped_msts", "rollups")


class Database:
    def __init__(self, name: str):
        self.name = name
        self.rps: dict[str, RetentionPolicy] = {}
        self.default_rp = "autogen"
        self.continuous_queries: dict[str, ContinuousQuery] = {}
        # rp name -> [DownsamplePolicy]
        self.downsample: dict[str, list[DownsamplePolicy]] = {}
        self.streams: dict[str, StreamTask] = {}
        # services/subscriber.Subscription by name
        self.subscriptions: dict[str, object] = {}
        # declared rollups (storage/rollup.RollupSpec)
        self.rollups: dict[str, object] = {}
        # DROP MEASUREMENT marks (meta.json "dropped_msts"): hidden from
        # queries until a purge
        self.dropped_msts: set[str] = set()
        # keys of meta.json this port does not interpret: kept as read
        # and written back unchanged
        self.extra: dict = {}


class WriteError(Exception):
    pass


class DatabaseNotFound(WriteError):
    def __init__(self, name: str):
        super().__init__(f"database not found: {name!r}")


class Engine:
    """Single-node storage engine with embedded metadata."""

    def __init__(self, root: str, device=None, sync_wal: bool = False,
                 flush_threshold_bytes: int = 64 << 20,
                 tag_arrays: bool = False):
        self.root = root
        self.device = resolve_device(device)
        self.sync_wal = sync_wal
        self.flush_threshold_bytes = flush_threshold_bytes
        # expand `host=[a,b]` tag arrays (opt-in: brackets are literal
        # tag bytes when off)
        self.tag_arrays = tag_arrays
        os.makedirs(root, exist_ok=True)
        # hot: every write and query path takes it (lockdep holds no
        # blocking call inside it)
        self._lock = lockdep.mark_hot(lockdep.RLock(), "engine._lock")
        # syscontrol switches (/debug/ctrl?mod=disablewrite|disableread|
        # readonly): refuse writes, or SELECT and EXPLAIN
        self.write_disabled = False
        self.read_disabled = False
        self._write_observers: list = []
        # the object-store tier: groups offloaded to the store, hydrated
        # back when a query or a write reaches their range
        self.obs_store = None
        self.obs_shards: set[tuple[str, str, int]] = set()
        self.databases: dict[str, Database] = {}
        self._meta_extra: dict = {}
        # (db, rp, group_start) -> Shard
        self._shards: dict[tuple[str, str, int], Shard] = {}
        self._load_meta()
        self._models = None  # lazy ModelStore (services/castor.py)
        # inbound two-phase migrations: mig_id -> [db, rp, start, Shard,
        # idle clock]; a staging shard is never in _shards, so no query
        # sees its rows before the commit folds them in
        self._staging: dict[str, list] = {}
        # mig_ids whose commit is folding now (popped from _staging, the
        # marker not yet durable): a retried commit waits for the marker
        self._folding: set[str] = set()
        self._load_shards()
        # the rollup manager (storage/rollup.py): built only when a spec
        # is declared and OGT_ROLLUP is not 0; None keeps every write
        # and query path as it is (one attribute check)
        self.rollup_mgr = None
        self._maybe_init_rollups()
        # the rule engine (promql/rules.py) sets this while it runs;
        # None keeps every write path as it is (one attribute check)
        self.rules_hook = None
        # the acknowledged-against-durable gauges (/debug/vars)
        self._durability_provider = self._durability_gauges
        _STATS.register_provider("durability", self._durability_provider)
        # the quarantined-file gauge beside the shards' counters
        self._quarantine_provider = self._quarantine_gauges
        _STATS.register_provider("quarantine", self._quarantine_provider)
        # the memtable and WAL backlog joins the resource governor's
        # ledger and drives /write's backpressure (several engines sum)
        self._governor_provider = self.mem_backlog_bytes
        GOVERNOR.register_component("memtable", self._governor_provider)

    # -- metadata -----------------------------------------------------------

    @property
    def models(self):
        """Fitted anomaly-detection models (services/castor.py), kept
        under <root>/models/."""
        if self._models is None:
            from opengemini_tpu_torch.services.castor import ModelStore

            self._models = ModelStore(os.path.join(self.root, "models"))
        return self._models

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
            for cqj in dbj.get("cqs", []):
                cq = ContinuousQuery.from_json(cqj)
                db.continuous_queries[cq.name] = cq
            for rp_name, pols in dbj.get("downsample", {}).items():
                db.downsample[rp_name] = [DownsamplePolicy.from_json(p)
                                          for p in pols]
            for sj in dbj.get("streams", []):
                st = StreamTask.from_json(sj)
                db.streams[st.name] = st
            if dbj.get("subscriptions"):
                from opengemini_tpu_torch.services.subscriber import (
                    Subscription,
                )

                for sj in dbj["subscriptions"]:
                    sub = Subscription.from_json(sj)
                    db.subscriptions[sub.name] = sub
            db.dropped_msts = set(dbj.get("dropped_msts", []))
            if dbj.get("rollups"):
                from opengemini_tpu_torch.storage.rollup import RollupSpec

                for rj in dbj["rollups"]:
                    spec = RollupSpec.from_json(rj)
                    db.rollups[spec.name] = spec
            db.extra = {k: v for k, v in dbj.items() if k not in _DB_KEYS}
            self.databases[db.name] = db
        self.obs_shards = {(d, r, int(s))
                           for d, r, s in j.get("obs_shards", [])}
        self._meta_extra = {k: v for k, v in j.items()
                            if k not in ("databases", "obs_shards")}

    def _save_meta(self) -> None:
        j = {"obs_shards": sorted(list(k) for k in self.obs_shards)}
        j.update(self._meta_extra)
        # the reference's layout, key for key; the uninterpreted keys are
        # written back as read
        j["databases"] = [
            {"name": db.name, "default_rp": db.default_rp,
             "rps": [rp.to_json() for rp in db.rps.values()],
             "cqs": [cq.to_json() for cq in db.continuous_queries.values()],
             "downsample": {rp: [p.to_json() for p in pols]
                            for rp, pols in db.downsample.items()},
             "streams": [st.to_json() for st in db.streams.values()],
             "subscriptions": [s.to_json()
                               for s in db.subscriptions.values()],
             "dropped_msts": sorted(db.dropped_msts),
             "rollups": [r.to_json() for r in db.rollups.values()],
             **db.extra}
            for db in self.databases.values()
        ]
        tmp = self._meta_path() + ".tmp"
        if diskfault.armed():
            diskfault.check("write", self._meta_path(),
                            site="meta-save-write")
        # the meta fsync runs under the engine lock on purpose: DDL is
        # rare, and the lock keeps the change and its record atomic
        with lockdep.allow_blocking("engine meta save under DDL lock"), \
                open(tmp, "w", encoding="utf-8") as f:
            json.dump(j, f)
            f.flush()
            if diskfault.armed():
                diskfault.on_fsync(self._meta_path(),
                                   site="meta-save-fsync")
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

    def drop_database(self, name: str) -> None:
        with self._lock:
            if name not in self.databases:
                return
            for key in [k for k in self._shards if k[0] == name]:
                shard = self._shards.pop(key)
                shard.close()
                _remove_shard_dir(shard.path)  # follows cold-tier links
            # a recreated database must not hydrate the old offloads
            obs_purge = self._purge_obs(lambda k: k[0] == name)
            del self.databases[name]
            self._save_meta()
            shutil.rmtree(os.path.join(self.root, "data", name),
                          ignore_errors=True)
            # a recreated database must not inherit this one's rollup
            # watermarks (clean-looking windows with no rollup rows
            # would splice as empty over the new data)
            if self.rollup_mgr is not None:
                self.rollup_mgr.drop_db_state(name)
            else:
                shutil.rmtree(os.path.join(self.root, "rollup", name),
                              ignore_errors=True)
            # the same hazard for rule groups: a recreated database
            # must not inherit their watermarks and alert state
            if self.rules_hook is not None:
                self.rules_hook.drop_db_state(name)
            else:
                shutil.rmtree(os.path.join(self.root, "rules", name),
                              ignore_errors=True)
        self._delete_obs_prefixes(obs_purge)

    def drop_retention_policy(self, db: str, name: str) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None or name not in d.rps:
                return
            del d.rps[name]
            d.downsample.pop(name, None)  # policies die with their rp
            for key in [k for k in self._shards
                        if k[0] == db and k[1] == name]:
                shard = self._shards.pop(key)
                shard.close()
                _remove_shard_dir(shard.path)
            obs_purge = self._purge_obs(
                lambda k: k[0] == db and k[1] == name)
            if d.default_rp == name:
                d.default_rp = ("autogen" if "autogen" in d.rps
                                else next(iter(d.rps), "autogen"))
            self._save_meta()
        self._delete_obs_prefixes(obs_purge)

    def create_retention_policy(self, db: str, name: str, duration_ns: int,
                                shard_duration_ns: int | None = None,
                                default: bool = False) -> None:
        _check_namespace_name(name, "retention policy")
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            if not shard_duration_ns:  # absent or 0 = auto (influx meta)
                shard_duration_ns = _auto_shard_duration(duration_ns)
            d.rps[name] = RetentionPolicy(name, duration_ns, shard_duration_ns)
            if default:
                d.default_rp = name
            self._save_meta()

    def alter_retention_policy(self, db: str, name: str,
                               duration_ns: int | None = None,
                               shard_duration_ns: int | None = None,
                               default: bool = False) -> None:
        """Change an existing RP in place; None fields stay as they are.
        A new shard duration applies to shard groups created after the
        change (influx)."""
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            rp = d.rps.get(name)
            if rp is None:
                raise ValueError(f"retention policy not found: {name}")
            new_dur = rp.duration_ns if duration_ns is None else duration_ns
            if shard_duration_ns is None:
                new_sd = rp.shard_duration_ns
            else:  # explicit 0 = recompute the auto layout (influx meta)
                new_sd = shard_duration_ns or _auto_shard_duration(new_dur)
            if new_dur and new_dur < new_sd:
                # influx rejects this rather than rewrite the shard layout
                raise ValueError(
                    "retention policy duration must be greater than the "
                    "shard duration")
            rp.duration_ns = new_dur
            rp.shard_duration_ns = new_sd
            if default:
                d.default_rp = name
            self._save_meta()

    def disk_usage(self) -> dict:
        """{"total": bytes, "groups": {"db|rp|start": bytes}} of the live
        shard directories: the load the balancer compares across nodes."""
        groups: dict[str, int] = {}
        total = 0
        with self._lock:
            items = list(self._shards.items())
        for (db, rp, start), sh in items:
            n = 0
            for dirpath, _dirs, files in os.walk(os.path.realpath(sh.path)):
                for f in files:
                    try:
                        n += os.path.getsize(os.path.join(dirpath, f))
                    except OSError:
                        pass
            groups[f"{db}|{rp}|{start}"] = n
            total += n
        return {"total": total, "groups": groups}

    def database_names(self) -> list[str]:
        return sorted(self.databases)

    def mark_measurement_delete(self, db: str, mst: str) -> None:
        """DROP MEASUREMENT: mark only. SELECT and the metadata SHOWs
        hide the measurement at once; its rows and index entries stay
        until purge_dropped_measurements runs (before the next write to
        the database)."""
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        to_reset = []
        with self._lock:
            d.dropped_msts.add(mst)
            if self.rollup_mgr is not None:
                # rollups of a dropped measurement drop with it: their
                # rows under the _rollup RP go, and the watermark resets
                # so a recreated name folds from scratch
                for spec in d.rollups.values():
                    if spec.measurement == mst:
                        self._purge_rollup_target(db, spec.target)
                        to_reset.append(spec.name)
            self._save_meta()
        for name in to_reset:
            # off the engine lock: the invalidation takes the spec's
            # maintenance lock, which a fold holds while it takes the
            # engine lock (order: maintenance lock, then engine lock)
            self.rollup_mgr.invalidate(db, name)

    def is_measurement_dropped(self, db: str, mst: str) -> bool:
        d = self.databases.get(db)
        return d is not None and mst in d.dropped_msts

    def purge_dropped_measurements(self, db: str | None = None) -> int:
        """Delete the rows and series of mark-dropped measurements (of
        `db`, or of every database) and clear the marks. Returns the
        measurements purged."""
        n = 0
        with self._lock:
            for name, d in self.databases.items():
                if db is not None and name != db:
                    continue
                if not d.dropped_msts:
                    continue
                # offloaded groups hold rows too: hydrate them first, or
                # the next hydration brings the dropped rows back
                for (sdb, rp, g) in sorted(self.obs_shards):
                    if sdb == name:
                        self._hydrate_shard(sdb, rp, g)
                for mst in sorted(d.dropped_msts):
                    for (sdb, _rp, _g), sh in list(self._shards.items()):
                        if sdb == name:
                            sh.delete_data(mst)
                    n += 1
                d.dropped_msts.clear()
            if n:
                self._save_meta()
        return n

    # -- quarantine -----------------------------------------------------------

    def quarantine_snapshot(self) -> dict:
        """Every quarantined file across shards: {"files": [{shard,
        path, why}], "total": n}."""
        with self._lock:
            shards = list(self._shards.items())
        files = []
        for (db, rp, start), sh in shards:
            for path, why in sorted(sh.quarantined().items()):
                files.append({"shard": f"{db}|{rp}|{start}",
                              "path": path, "why": why})
        return {"files": files, "total": len(files)}

    def _quarantine_gauges(self) -> dict:
        with self._lock:
            shards = list(self._shards.values())
        n = sum(len(sh.quarantined()) for sh in shards)
        return {"files_current": n} if n else {}

    def purge_quarantined(self) -> int:
        """Delete the quarantined files (with their markers and
        sidecars) of every shard. Returns the files purged."""
        with self._lock:
            shards = list(self._shards.values())
        return sum(sh.purge_quarantined() for sh in shards)

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
                        self.sync_wal, tag_arrays=self.tag_arrays)

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
            if key in self.obs_shards:
                # a write into an offloaded range lands in the hydrated
                # group: a fresh shard here would be replaced by the
                # hydration later, and its rows lost
                shard = self._hydrate_shard(db, rp, group_start)
                if shard is not None:
                    return shard
            shard = Shard(self._shard_dir(db, rp, group_start), group_start,
                          group_start + dur, self.sync_wal,
                          tag_arrays=self.tag_arrays)
            self._shards[key] = shard
        return shard

    # -- two-phase migration staging (the reference's engine_ha.go) ----------

    def _staging_root(self) -> str:
        return os.path.join(self.root, "staging")

    def begin_staging(self, db: str, rp: str, group_start: int,
                      mig_id: str) -> None:
        """Open an invisible staging shard, <root>/staging/<mig_id>, for
        an inbound migration. A retried begin reuses it."""
        if not mig_id or "/" in mig_id or mig_id.startswith("."):
            raise WriteError(f"bad migration id {mig_id!r}")
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        rp_meta = d.rps.get(rp or d.default_rp)
        if rp_meta is None:
            raise WriteError(f"retention policy not found: {db}.{rp}")
        with self._lock:
            if mig_id in self._staging:
                return
            dur = rp_meta.shard_duration_ns
            sh = Shard(os.path.join(self._staging_root(), mig_id),
                       group_start, group_start + dur, self.sync_wal,
                       tag_arrays=self.tag_arrays)
            self._staging[mig_id] = [db, rp or d.default_rp, group_start, sh,
                                     _time.perf_counter()]

    def write_staging(self, mig_id: str, points: list) -> int:
        """Stage a migration's points (one columnar slab where
        ingest/native_lp.points_batch takes them)."""
        with self._lock:
            got = self._staging.get(mig_id)
            if got is None:
                raise WriteError(f"unknown migration {mig_id!r}")
            got[4] = _time.perf_counter()  # the idle clock of the TTL
            sh = got[3]
            batch = native_lp.points_batch(points) if len(points) > 1 \
                else None
            if batch is None:
                n, ticket = sh.write_points_structured(points,
                                                       defer_commit=True)
            else:  # the same rows, as one columnar slab
                n, ticket = sh.write_columnar(
                    batch, None, LineWriter(batch).lines(
                        np.arange(len(batch), dtype=np.int64)),
                    "ns", _time.time_ns(), defer_commit=True)
        # the sync-WAL wait runs off the engine lock, as a write's does
        sh.wal.commit(ticket)
        return n

    def commit_staging(self, mig_id: str) -> int:
        """Fold the staged rows into the live shard (last write wins on
        (series, time), so a re-fold adds nothing; as columnar batches
        where ingest/native_lp.points_batch takes them, the rows the
        reference's structured writes store) and discard the staging
        area; returns the rows folded. A durable committed marker
        makes a re-commit of the same id answer 0 rather than fail, and a
        re-commit that arrives while the first still folds waits for it."""
        with self._lock:
            got = self._staging.pop(mig_id, None)
            if got is not None:
                self._folding.add(mig_id)
        if got is None:
            while True:
                with self._lock:
                    inflight = mig_id in self._folding
                if not inflight:
                    break
                _time.sleep(0.05)
            if os.path.exists(self._committed_marker(mig_id)):
                return 0  # folded already; the first answer was lost
            raise WriteError(f"unknown migration {mig_id!r}")
        try:
            db, rp, _start, sh, _ts = got
            from opengemini_tpu_torch.storage.shard import (
                iter_structured_batches,
            )

            rows = 0
            for points in iter_structured_batches(sh, 20_000):
                batch = native_lp.points_batch(points) if len(points) > 1 \
                    else None
                rows += (self.write_rows(db, points, rp=rp) if batch is None
                         else self.write_batch(db, batch, rp=rp))
            # folded and in the WAL, no marker yet: a retry re-folds
            _fp("engine-staging-commit-before-marker")
            self._write_committed_marker(mig_id, rows)
            self._discard_staging_dir(sh)
        finally:
            with self._lock:
                self._folding.discard(mig_id)
        return rows

    def _committed_marker(self, mig_id: str) -> str:
        return os.path.join(self._staging_root(), mig_id + ".committed")

    def _write_committed_marker(self, mig_id: str, rows: int) -> None:
        """<mig_id>.committed, fsynced and renamed into place: the token
        of an idempotent commit, expired with the staging dirs."""
        os.makedirs(self._staging_root(), exist_ok=True)
        path = self._committed_marker(mig_id)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            # a wall stamp for an operator; the TTL reads the file's mtime
            f.write(json.dumps({"rows": rows, "ts": _time.time()}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def staging_ids(self) -> list[str]:
        """The migrations staged here now."""
        with self._lock:
            return sorted(self._staging)

    def abort_staging(self, mig_id: str) -> bool:
        """Drop a staging area; the live data was never touched."""
        with self._lock:
            got = self._staging.pop(mig_id, None)
        if got is None:
            return False
        self._discard_staging_dir(got[3])
        return True

    def close_staging(self) -> None:
        with self._lock:
            for entry in self._staging.values():
                entry[3].close()
            self._staging.clear()

    def _discard_staging_dir(self, sh) -> None:
        sh.close()
        shutil.rmtree(sh.path, ignore_errors=True)

    def expire_staging(self, ttl_s: float = 900.0) -> int:
        """Discard staging a pusher left behind: a registration idle for
        `ttl_s` (by the in-process clock of its last write), and, on
        disk, a staging dir with no registration (a restart) or a
        committed marker whose newest mtime is `ttl_s` old. Returns the
        areas dropped."""
        root = self._staging_root()
        if not os.path.isdir(root):
            return 0
        now_pc = _time.perf_counter()
        now = _time.time()  # file mtimes are wall stamps
        dropped = 0
        with self._lock:
            for name, entry in list(self._staging.items()):
                if now_pc - entry[4] >= ttl_s:
                    self._staging.pop(name, None)
                    self._discard_staging_dir(entry[3])
                    dropped += 1
            for name in os.listdir(root):
                if name in self._staging or name in self._folding:
                    continue  # a fold in flight still reads its dir
                path = os.path.join(root, name)
                if name.endswith(".committed") and os.path.isfile(path):
                    try:
                        if now - os.path.getmtime(path) >= ttl_s:
                            os.remove(path)
                    except OSError:
                        pass
                    continue
                try:
                    newest = max(
                        (os.path.getmtime(os.path.join(path, f))
                         for f in os.listdir(path)),
                        default=os.path.getmtime(path))
                except OSError:
                    continue
                if now - newest < ttl_s:
                    continue
                shutil.rmtree(path, ignore_errors=True)
                dropped += 1
        return dropped

    def drop_shard(self, db: str, rp: str, group_start: int) -> bool:
        """Remove one shard group whose data now lives on its new owners
        (a migration's last step). A write that routed rows here before
        the drop finishes its flush through _flush_tolerating_drop."""
        key = (db, rp, group_start)
        with self._lock:
            shard = self._shards.pop(key, None)
            if shard is None:
                return False
            shard.close()
            obs_purge = self._purge_obs(lambda k: k == key)
            self._save_meta()
            _remove_shard_dir(shard.path)
        self._delete_obs_prefixes(obs_purge)
        return True

    # -- the object-store tier (storage/objstore.py) -------------------------

    def attach_object_store(self, store) -> None:
        """Use `store` for offloads. A group both local and registered
        (a crash between the registry save and the local removal) keeps
        its local copy; the store copy is deleted."""
        from opengemini_tpu_torch.storage.objstore import shard_prefix

        self.obs_store = store
        with self._lock:
            stale = [k for k in self.obs_shards if k in self._shards]
        # bucket deletes are round trips: outside the engine lock
        for db, rp, start in stale:
            store.delete_prefix(shard_prefix(db, rp, start))
        with self._lock:
            for k in stale:
                self.obs_shards.discard(k)
            if stale:
                self._save_meta()

    def offload_shard(self, db: str, rp: str, group_start: int) -> bool:
        """Move one whole shard group into the object store; it hydrates
        back at the next query over its range. False when there is no
        store or no such group, or when a write landed during the upload
        (the group then stays local)."""
        from opengemini_tpu_torch.storage.objstore import shard_prefix

        if self.obs_store is None:
            return False
        key = (db, rp, group_start)
        with self._lock:
            shard = self._shards.get(key)
            if shard is None:
                return False
        # upload under the shard's flush lock only: it freezes the file
        # set while writes stay live; a write during the upload bumps
        # data_version and the swap below gives up
        with shard._flush_lock:
            shard.flush()
            with shard._lock:
                v0 = shard.data_version
            if shard.mem_backlog_bytes() != 0:
                return False  # a write raced the flush: not idle
            prefix = shard_prefix(db, rp, group_start)
            # an aborted earlier upload may have left objects here:
            # clear them, or a hydration would bring retired files back
            self.obs_store.delete_prefix(prefix)
            real = os.path.realpath(shard.path)  # a cold-tier symlink
            for dirpath, _dirs, files in os.walk(real):
                for fname in sorted(files):
                    full = os.path.join(dirpath, fname)
                    rel = os.path.relpath(full, real)
                    self.obs_store.put(f"{prefix}/{rel}", full)
        # swap: revalidate and retire under the engine lock
        with self._lock:
            if self._shards.get(key) is not shard:
                return False  # dropped or replaced during the upload
            with shard._lock:
                dirty = (shard.data_version != v0
                         or shard.mem_backlog_bytes() != 0)
            if dirty:
                return False  # the store copy is stale: stay local
            with lockdep.allow_blocking("cold-tier retire of idle shard"), \
                    shard._flush_lock, shard._lock:
                shard.wal.close()
                shard.index.close()
                shard.drop_cached_columns()
            del self._shards[key]
            # registry first: a crash before the removal leaves both
            # copies, which attach_object_store reconciles
            self.obs_shards.add(key)
            self._save_meta()
            _remove_shard_dir(shard.path)
            return True

    def _purge_obs(self, match) -> list[tuple]:
        """Unregister the offloaded groups whose key satisfies `match`.
        The caller holds the lock and saves meta, then passes the result
        to _delete_obs_prefixes with the lock released."""
        from opengemini_tpu_torch.storage.objstore import shard_prefix

        purged = []
        for key in [k for k in self.obs_shards if match(k)]:
            if self.obs_store is not None:
                purged.append((key, shard_prefix(*key)))
            self.obs_shards.discard(key)
        return purged

    def _delete_obs_prefixes(self, purged: list[tuple]) -> None:
        """Delete _purge_obs's bucket prefixes, with no engine lock held.
        A prefix that a recreated namespace registered again meanwhile
        is kept."""
        for key, prefix in purged:
            with self._lock:
                if key in self.obs_shards or key in self._shards:
                    continue
            if self.obs_store is not None:
                self.obs_store.delete_prefix(prefix)

    def _download_group(self, db: str, rp: str, group_start: int) -> None:
        """Download an offloaded group, with no engine lock held, into a
        staging directory outside data/ that swaps in whole: a torn
        download never becomes a live shard."""
        import uuid

        from opengemini_tpu_torch.storage.objstore import shard_prefix

        prefix = shard_prefix(db, rp, group_start)
        keys = self.obs_store.list(prefix)
        if not keys:
            raise WriteError(
                f"offloaded group {db}/{rp}/{group_start} has no objects "
                "in the bucket")
        tmp = os.path.join(self.root, ".hydrate-tmp",
                           f"{db}_{rp}_{group_start}.{uuid.uuid4().hex[:8]}")
        try:
            for key in keys:
                rel = key[len(prefix) + 1:]  # may be nested (seriesidx/)
                target = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(target), exist_ok=True)
                self.obs_store.get(key, target)
            dest = self._shard_dir(db, rp, group_start)
            # the loser of two concurrent hydrations drops its copy
            with self._lock:
                if (db, rp, group_start) in self._shards:
                    shutil.rmtree(tmp, ignore_errors=True)
                    return
                shutil.rmtree(dest, ignore_errors=True)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                os.replace(tmp, dest)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _install_hydrated(self, db: str, rp: str, group_start: int,
                          save: bool = True) -> Shard:
        """Open a downloaded group and register it (the caller holds the
        lock); a live shard is returned as it is. The store copy stays."""
        key = (db, rp, group_start)
        existing = self._shards.get(key)
        if existing is not None:
            self.obs_shards.discard(key)
            return existing
        dur = self.databases[db].rps[rp].shard_duration_ns
        shard = Shard(self._shard_dir(db, rp, group_start), group_start,
                      group_start + dur, self.sync_wal,
                      tag_arrays=self.tag_arrays)
        self._shards[key] = shard
        self.obs_shards.discard(key)
        if save:
            self._save_meta()
        return shard

    def _hydrate_shard(self, db: str, rp: str, group_start: int
                       ) -> Shard | None:
        """Download and install in one step (the write path, under the
        engine lock: a backfill into an offloaded group is rare)."""
        if self.obs_store is None:
            return None
        if (db, rp, group_start) in self._shards:
            return self._install_hydrated(db, rp, group_start)
        with lockdep.allow_blocking("write-path cold hydration"):
            self._download_group(db, rp, group_start)
        return self._install_hydrated(db, rp, group_start)

    def _hydrate_range(self, db: str, rp: str, tmin: int, tmax: int) -> None:
        """Hydrate the offloaded groups of (db, rp) overlapping [tmin,
        tmax): download outside the lock, install under it. A group that
        cannot be hydrated fails the query."""
        d = self.databases.get(db)
        with self._lock:
            rp_meta = d.rps.get(rp) if d else None
            dur = rp_meta.shard_duration_ns if rp_meta else 0
            todo = [k for k in sorted(self.obs_shards)
                    if k[0] == db and k[1] == rp and dur
                    and k[2] + dur > tmin and k[2] < tmax]
        for odb, orp, start in todo:
            try:
                if (odb, orp, start) not in self._shards:
                    self._download_group(odb, orp, start)
                with self._lock:
                    self._install_hydrated(odb, orp, start, save=False)
            except Exception as e:  # noqa: BLE001
                logging.getLogger("opengemini_tpu_torch.engine").exception(
                    "hydration of %s/%s/%d failed", odb, orp, start)
                # an answer without the offloaded group would be wrong
                raise WriteError(
                    f"shard {odb}/{orp}/{start} is in the object "
                    f"store and could not be hydrated: {e}") from e
        if todo:
            with self._lock:
                self._save_meta()

    def shards_for_range(self, db: str, rp: str | None, tmin: int,
                         tmax: int) -> list[Shard]:
        """Shards overlapping [tmin, tmax) — the shard-mapping step.
        Offloaded groups in range hydrate back first."""
        d = self.databases.get(db)
        if d is None:
            return []
        rp = rp or d.default_rp
        if self.obs_shards and self.obs_store is not None:
            self._hydrate_range(db, rp, tmin, tmax)
        with self._lock:
            items = sorted(self._shards.items(), key=lambda kv: kv[0])
        return [sh for (sdb, srp, _s), sh in items
                if sdb == db and srp == rp and sh.tmin < tmax
                and sh.tmax > tmin]

    def shards_of_db(self, db: str) -> list[Shard]:
        """Every shard of a database, across its retention policies."""
        with self._lock:
            items = sorted(self._shards.items(), key=lambda kv: kv[0])
        return [sh for (sdb, _rp, _s), sh in items if sdb == db]

    # -- write path ---------------------------------------------------------

    def _db_rp(self, db: str, rp: str | None) -> str:
        d = self.databases.get(db)
        if d is None:
            raise DatabaseNotFound(db)
        if d.dropped_msts:
            # a marked measurement being rewritten must not resurface its
            # old rows: purge before accepting the batch
            self.purge_dropped_measurements(db)
        return rp or d.default_rp

    def write_lines(self, db: str, lines: str | bytes, precision: str = "ns",
                    rp: str | None = None, now_ns: int | None = None) -> int:
        """Parse + route + apply a line-protocol batch; every target shard
        logs the raw batch to its WAL first (replay re-filters by time
        range). The native parser takes the body (a large one in
        segments on the ingest pool); the Python parser takes it only
        when the native one hands it back. Returns points written."""
        if self.write_disabled:
            raise WriteError("writes are disabled (syscontrol)")
        rp = self._db_rp(db, rp)
        if now_ns is None:
            now_ns = _time.time_ns()
        raw = lines.encode("utf-8") if isinstance(lines, str) else lines
        batch = None
        # a tag-array body takes the Python parser, which expands it
        if not (self.tag_arrays and b"=[" in raw):
            n = self._write_segmented(db, rp, raw, precision, now_ns)
            if n is _NEEDS_PYTHON_PARSER:
                pass  # the segments already showed the body needs it
            elif n is not None:
                return n
            else:
                batch = native_lp.parse_columnar(raw, precision, now_ns)
        if batch is not None:
            return self._write_batch(db, rp, batch, raw, precision, now_ns)
        points = lp.parse_lines(lines, precision, now_ns,
                                expand_tag_arrays=self.tag_arrays)
        if not points:
            return 0
        return self._write_points(db, rp, points, lambda sh, pts: (
            sh.write_points(pts, raw, precision, now_ns, defer_commit=True)))

    def _write_batch(self, db: str, rp: str, batch, raw: bytes,
                     precision: str, now_ns: int) -> int:
        """Apply one ColumnarBatch whose WAL entry is the line-protocol
        text `raw`: routed and slab-written under one engine lock, then
        the WAL commits and threshold flushes off it."""
        if len(batch) == 0:
            return 0
        # pre-apply: a late write's dirty mark is durable before its
        # rows are (storage/rollup.py); write_done releases the
        # in-flight fold floor
        rtok = (self.rollup_mgr.note_write_columnar(db, rp, batch)
                if self.rollup_mgr is not None else None)
        utok = None
        try:
            if self.rules_hook is not None:
                utok = self.rules_hook.note_write_columnar(db, rp, batch)
            tickets: list = []
            touched: list = []
            with self._lock:
                n = self._write_columnar_locked(
                    db, rp, batch, raw, precision, now_ns, tickets, touched)
            self._commit_and_flush(tickets, touched)
            _STATS.incr("write", "points", len(batch))
            if self._write_observers:
                self._notify_write(db, rp, batch.to_points())
            return n
        finally:
            if rtok is not None:
                self.rollup_mgr.write_done(rtok)
            if utok is not None:
                self.rules_hook.write_done(utok)

    def _write_segmented(self, db: str, rp: str, raw: bytes,
                         precision: str, now_ns: int):
        """Multi-core ingest: split a large body at line boundaries, parse
        the segments concurrently (the native parser releases the GIL),
        then apply them in order under one engine lock. Returns None when
        the body is small or the host has one core (the caller parses it
        whole), or the _NEEDS_PYTHON_PARSER sentinel when a segment
        showed the body needs the Python parser."""
        pool = _ingest_pool()
        if pool is None or len(raw) < 2 * _INGEST_SEGMENT_BYTES:
            return None
        segs = _split_lp_segments(raw, _INGEST_WORKERS)
        if len(segs) < 2:
            return None
        errs: list = []

        def parse_one(idx_seg):
            idx, seg = idx_seg
            try:
                return native_lp.parse_columnar(seg, precision, now_ns)
            except lp.ParseError as e:
                errs.append((idx, e))
                return None

        parsed = list(pool.map(parse_one, enumerate(segs)))
        if errs:
            # the first bad line of the body, not whichever worker
            # finished first
            idx, e = min(errs, key=lambda x: x[0])
            off = sum(s.count(b"\n") for s in segs[:idx])
            raise lp.ParseError(off + e.lineno, e.msg)
        if any(b is None for b in parsed):
            return _NEEDS_PYTHON_PARSER
        # cross-segment field types before anything applies: the whole
        # body is rejected with nothing stored, as a single batch is
        body_types: dict[tuple[str, str], object] = {}
        for batch in parsed:
            for mst_id, name, ftype, _values, valid in batch.cols:
                if not valid.any():
                    continue
                key = (batch.measurements[mst_id], name)
                have = body_types.get(key)
                if have is None:
                    body_types[key] = ftype
                elif have != ftype:
                    raise FieldTypeConflict(name, have, ftype)
        total = 0
        tickets: list = []
        touched: list = []
        rtoks = []
        utoks = []
        try:
            if self.rollup_mgr is not None:
                # inside the try: a mark failing for batch k still
                # releases the floors of the batches before it
                for batch in parsed:
                    if len(batch):
                        t = self.rollup_mgr.note_write_columnar(db, rp, batch)
                        if t is not None:
                            rtoks.append(t)
            if self.rules_hook is not None:
                for batch in parsed:
                    if len(batch):
                        t = self.rules_hook.note_write_columnar(db, rp, batch)
                        if t is not None:
                            utoks.append(t)
            with self._lock:
                # one lock for the whole body, every segment checked
                # against the live shard schemas before the first
                # applies; routing runs once per segment and is reused
                routed = []
                for seg, batch in zip(segs, parsed):
                    if len(batch) == 0:
                        continue
                    route = list(self._route_columnar_locked(db, rp, batch))
                    for shard, rows in route:
                        shard._check_columnar_types(batch, rows)
                    routed.append((seg, batch, route))
                for seg, batch, route in routed:
                    _STATS.incr("write", "points", len(batch))
                    for shard, rows in route:
                        got, t = shard.write_columnar(
                            batch, rows, seg, precision, now_ns,
                            defer_commit=True)
                        total += got
                        tickets.append((shard, t))
                        touched.append(shard)
            self._commit_and_flush(tickets, touched)
            if self._write_observers and total:
                # observers see the body once, after the commit
                pts: list = []
                for batch in parsed:
                    if len(batch):
                        pts.extend(batch.to_points())
                self._notify_write(db, rp, pts)
            return total
        finally:
            for t in rtoks:
                self.rollup_mgr.write_done(t)
            for t in utoks:
                self.rules_hook.write_done(t)

    def _write_columnar_locked(self, db: str, rp: str, batch, raw: bytes,
                               precision: str, now_ns: int, tickets: list,
                               touched: list) -> int:
        """Route a ColumnarBatch to its time shards and slab-write each.
        The caller holds the engine lock and finishes the deferred WAL
        commits (`tickets`) and the threshold flushes (`touched`)
        off-lock."""
        n = 0
        for shard, rows in self._route_columnar_locked(db, rp, batch):
            got, t = shard.write_columnar(
                batch, rows, raw, precision, now_ns, defer_commit=True)
            n += got
            tickets.append((shard, t))
            touched.append(shard)
        return n

    def _commit_and_flush(self, tickets: list, shards) -> None:
        """Sync-WAL commits, then threshold flushes (each shard once),
        off the engine lock."""
        # the engine lock dropped, rows applied, the ack waits on the
        # group commit: a kill here must lose no acknowledged row
        _fp("engine-before-wal-commit")
        for shard, ticket in tickets:
            shard.wal.commit(ticket)
        _fp("engine-before-threshold-flush")  # engine lock released
        self._flush_tolerating_drop(
            shards, lambda sh: sh.flush_if_over(self.flush_threshold_bytes))

    def _flush_tolerating_drop(self, shards, flush_fn) -> None:
        """Flush each distinct shard off the engine lock. A failure is
        swallowed only where a concurrent DROP (database, retention
        policy, a migrated group) removed the shard: its rows are gone
        on purpose. A live shard's failure raises."""
        seen: set[int] = set()
        for shard in shards:
            if id(shard) in seen:
                continue
            seen.add(id(shard))
            try:
                flush_fn(shard)
            except Exception:  # noqa: BLE001 — re-raised for a live shard
                with self._lock:
                    alive = any(s is shard for s in self._shards.values())
                if alive:
                    raise

    def write_rows(self, db: str, points: list, rp: str | None = None) -> int:
        """Structured write path: points are (measurement, tags tuple,
        t_ns, {field: (FieldType, value)}), WAL-logged as structured
        entries."""
        if self.write_disabled:
            raise WriteError("writes are disabled (syscontrol)")
        rp = self._db_rp(db, rp)
        return self._write_points(db, rp, points, lambda sh, pts: (
            sh.write_points_structured(pts, defer_commit=True)))

    def _write_points(self, db: str, rp: str, points: list, write) -> int:
        rtok = (self.rollup_mgr.note_write_points(db, rp, points)
                if self.rollup_mgr is not None else None)
        utok = None
        try:
            if self.rules_hook is not None:
                utok = self.rules_hook.note_write_points(db, rp, points)
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
            self._commit_and_flush(tickets, shards.values())
            _STATS.incr("write", "points", n)
            self._notify_write(db, rp, points)
            return n
        finally:
            if rtok is not None:
                self.rollup_mgr.write_done(rtok)
            if utok is not None:
                self.rules_hook.write_done(utok)

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

    def write_batch(self, db: str, batch, rp: str | None = None) -> int:
        """One decoded ColumnarBatch (ingest/native_lp.py; the
        remote-write route's, ingest/prom_remote.py ``series_batch``) as
        write_lines applies a parsed body, its WAL entry the batch's
        line-protocol text (ingest/native_lp.py ``LineWriter``). Every
        row must have a field."""
        if self.write_disabled:
            raise WriteError("writes are disabled (syscontrol)")
        rp = self._db_rp(db, rp)
        raw = LineWriter(batch).lines(np.arange(len(batch), dtype=np.int64))
        return self._write_batch(db, rp, batch, raw, "ns", _time.time_ns())

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
            rtok = (self.rollup_mgr.note_write_columnar(db, rp, batch)
                    if self.rollup_mgr is not None else None)
            utok = None
            try:
                if self.rules_hook is not None:
                    utok = self.rules_hook.note_write_columnar(db, rp, batch)
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
            finally:
                if rtok is not None:
                    self.rollup_mgr.write_done(rtok)
                if utok is not None:
                    self.rules_hook.write_done(utok)
            if self._write_observers:
                self._notify_write(db, rp, batch.to_points())
        _STATS.incr("write", "points", n)
        return n

    # -- continuous queries, streams, downsample ----------------------------

    def create_continuous_query(self, db: str, cq: ContinuousQuery) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            d.continuous_queries[cq.name] = cq
            self._save_meta()

    def drop_continuous_query(self, db: str, name: str) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d and name in d.continuous_queries:
                del d.continuous_queries[name]
                self._save_meta()

    def save_cq_state(self) -> None:
        with self._lock:
            self._save_meta()

    def create_stream(self, db: str, task: StreamTask) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            d.streams[task.name] = task
            self._save_meta()

    def drop_stream(self, db: str, name: str) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d and name in d.streams:
                del d.streams[name]
                self._save_meta()

    def create_subscription(self, db: str, sub) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            d.subscriptions[sub.name] = sub
            self._save_meta()

    def drop_subscription(self, db: str, name: str) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d and name in d.subscriptions:
                del d.subscriptions[name]
                self._save_meta()

    def add_write_observer(self, fn) -> None:
        """fn(db, rp, points) after every successful write: the stream
        engine's ingest hook."""
        self._write_observers.append(fn)

    def _notify_write(self, db: str, rp: str | None, points: list) -> None:
        for fn in list(self._write_observers):
            try:
                fn(db, rp, points)
            except Exception:  # noqa: BLE001 — observers never break ingest
                logging.getLogger("opengemini_tpu_torch.engine").exception(
                    "write observer failed")

    def add_downsample_policy(self, db: str, rp: str,
                              policy: DownsamplePolicy) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            d.downsample.setdefault(rp, []).append(policy)
            self._save_meta()

    def set_downsample_policies(self, db: str, rp: str,
                                policies: list[DownsamplePolicy],
                                ttl_ns: int = 0) -> None:
        """Replace the rp's policy set; a nonzero ttl_ns also becomes
        the rp's retention duration (CREATE DOWNSAMPLE's TTL)."""
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            if rp not in d.rps:
                raise WriteError(f"retention policy not found: {db}.{rp}")
            d.downsample[rp] = list(policies)
            if ttl_ns:
                d.rps[rp].duration_ns = ttl_ns
            self._save_meta()

    def drop_downsample_policies(self, db: str, rp: str | None = None) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                return
            if rp is None:
                d.downsample.clear()
            else:
                d.downsample.pop(rp, None)
            self._save_meta()

    def shards_due_downsample(self, now_ns: int | None = None):
        """[(shard, policy)] whose whole range has aged past a policy and
        whose resolution is still finer (a marker file per shard)."""
        if now_ns is None:
            now_ns = _time.time_ns()
        due = []
        with self._lock:
            for (db, rp, _start), shard in sorted(self._shards.items()):
                d = self.databases.get(db)
                pols = d.downsample.get(rp, []) if d else []
                best = None
                for p in pols:
                    if shard.tmax <= now_ns - p.age_ns:
                        if best is None or p.every_ns > best.every_ns:
                            best = p
                if (best is not None
                        and _downsample_level(shard.path) < best.every_ns):
                    due.append((shard, best))
        return due

    def run_downsample(self, now_ns: int | None = None) -> int:
        """Run every due downsample rewrite on the engine's device;
        returns the shards rewritten. A shard's failure (say, a retention
        drop racing it) is logged and skipped."""
        n = 0
        for shard, policy in self.shards_due_downsample(now_ns):
            try:
                shard.rewrite_downsampled(policy.every_ns, policy.field_aggs,
                                          device=self.device)
                _set_downsample_level(shard.path, policy.every_ns)
                n += 1
            except Exception:  # noqa: BLE001
                logging.getLogger("opengemini_tpu_torch.engine").exception(
                    "downsample of shard %s failed", shard.path)
        return n

    def drop_expired_shards(self, now_ns: int | None = None
                            ) -> list[tuple[str, str, int]]:
        """Retention: drop the shards whose whole range is past their
        RP's duration. Closing a shard drops its decoded-column cache
        entries."""
        if now_ns is None:
            now_ns = _time.time_ns()
        dropped = []
        with self._lock:
            for key in list(self._shards):
                db, rp, _start = key
                d = self.databases.get(db)
                rp_meta = d.rps.get(rp) if d else None
                if rp_meta is None or rp_meta.duration_ns == 0:
                    continue
                shard = self._shards[key]
                if shard.tmax <= now_ns - rp_meta.duration_ns:
                    shard.close()
                    _remove_shard_dir(shard.path)
                    del self._shards[key]
                    dropped.append(key)
            # offloaded groups age out too; their bucket deletes run
            # outside the lock below
            purged = []
            for key in sorted(self.obs_shards):
                db, rp, start = key
                d = self.databases.get(db)
                rp_meta = d.rps.get(rp) if d else None
                if rp_meta is None or rp_meta.duration_ns == 0:
                    continue
                if (start + rp_meta.shard_duration_ns
                        <= now_ns - rp_meta.duration_ns):
                    from opengemini_tpu_torch.storage.objstore import (
                        shard_prefix,
                    )

                    self.obs_shards.discard(key)
                    dropped.append(key)
                    if self.obs_store is not None:
                        purged.append((key, shard_prefix(*key)))
            if dropped:
                self._save_meta()
        self._delete_obs_prefixes(purged)
        return dropped

    # -- materialized rollups (storage/rollup.py) ---------------------------

    def _maybe_init_rollups(self) -> None:
        from opengemini_tpu_torch.storage import rollup as _rollup

        if (self.rollup_mgr is None and _rollup.enabled_by_env()
                and any(d.rollups for d in self.databases.values())):
            self.rollup_mgr = _rollup.RollupManager(self)

    def create_rollup(self, db: str, spec) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d is None:
                raise DatabaseNotFound(db)
            src_rp = spec.rp or d.default_rp
            if src_rp not in d.rps:
                raise WriteError(f"retention policy not found: {db}.{src_rp}")
            _check_namespace_name(spec.name, "rollup")
            if spec.name == spec.measurement:
                # the spec name is the target measurement: a collision
                # with the source would hide the source rows on a drop
                raise WriteError(
                    "rollup name must differ from its source measurement")
            if spec.name in d.rollups:
                # a silent replace would leave the old grid's rows and
                # watermark behind, to double-count in the splice
                raise WriteError(
                    f"rollup already exists: {db}.{spec.name} "
                    "(drop it first)")
            d.rollups[spec.name] = spec
            self._save_meta()
        self._maybe_init_rollups()

    def drop_rollup(self, db: str, name: str) -> None:
        with self._lock:
            d = self.databases.get(db)
            if d and name in d.rollups:
                spec = d.rollups.pop(name)
                # the persisted cells drop with the spec, scoped to the
                # _rollup RP
                self._purge_rollup_target(db, spec.target)
                self._save_meta()
        if self.rollup_mgr is not None:
            self.rollup_mgr.drop_state(db, name)
        else:
            # OGT_ROLLUP=0: the state file goes all the same, or a later
            # declare resurrects a stale watermark over a purged target
            try:
                os.remove(os.path.join(self.root, "rollup", db,
                                       f"{name}.json"))
            except OSError:
                pass

    def _purge_rollup_target(self, db: str, target: str) -> None:
        """Delete a rollup target's rows from the _rollup RP's shards
        only (the caller holds the engine lock)."""
        from opengemini_tpu_torch.storage.rollup import ROLLUP_RP

        for (sdb, rp, _g), sh in list(self._shards.items()):
            if sdb == db and rp == ROLLUP_RP:
                sh.delete_data(target)

    def ensure_rollup_rp(self, db: str) -> None:
        """The system RP rollup rows live under, with infinite retention
        (rollups outlive their raw source data)."""
        from opengemini_tpu_torch.storage.rollup import ROLLUP_RP

        with self._lock:
            d = self.databases.get(db)
            if d is not None and ROLLUP_RP not in d.rps:
                d.rps[ROLLUP_RP] = RetentionPolicy(
                    ROLLUP_RP, 0, DEFAULT_SHARD_DURATION)
                self._save_meta()

    def mem_backlog_bytes(self) -> int:
        """Unflushed resident bytes (memtables and live WAL logs) of
        every shard: the governor's write-backpressure input."""
        with self._lock:
            shards = list(self._shards.values())
        return sum(sh.mem_backlog_bytes() for sh in shards)

    def all_shards(self) -> list[Shard]:
        with self._lock:
            return list(self._shards.values())

    def shard_items(self) -> list[tuple[tuple[str, str, int], Shard]]:
        """[((db, rp, group_start), shard)] in key order."""
        with self._lock:
            return sorted(self._shards.items(), key=lambda kv: kv[0])

    def flush_all(self) -> None:
        with self._lock:
            shards = list(self._shards.values())
        self._flush_tolerating_drop(shards, lambda sh: sh.flush())

    # -- the durability ledger ----------------------------------------------

    def durability_snapshot(self) -> dict:
        """Every shard's acknowledged-against-durable ledger and their
        totals (storage/shard.py DurabilityLedger). Per shard, `missing`
        > 0 means acknowledged rows are in neither a memtable nor a
        published file, < 0 a snapshot published twice; the total sums
        absolute values, so a loss on one shard never cancels a double
        publish on another."""
        with self._lock:
            shards = list(self._shards.items())
        agg = {"acked": 0, "replayed": 0, "published": 0, "tsf_rows": 0,
               "mem_rows": 0, "missing": 0, "dirty_shards": 0,
               "shards": len(shards)}
        per_shard = {}
        for (db, rp, start), sh in shards:
            snap = sh.ledger_snapshot()
            per_shard[f"{db}|{rp}|{start}"] = snap
            for k in ("acked", "replayed", "published", "tsf_rows",
                      "mem_rows"):
                agg[k] += snap[k]
            agg["missing"] += abs(snap["missing"])
            agg["dirty_shards"] += 1 if snap["dirty"] else 0
        return {"totals": agg, "shards": per_shard}

    def durability_check(self, snapshot: dict | None = None) -> list[dict]:
        """The clean shards whose ledger does not conserve rows (acked +
        replayed == published + in memory); empty when healthy. Pass a
        durability_snapshot() to check exactly the state reported."""
        snap = snapshot if snapshot is not None else self.durability_snapshot()
        return [{"shard": key, **s} for key, s in snap["shards"].items()
                if not s["dirty"] and s["missing"] != 0]

    def _durability_gauges(self) -> dict:
        return self.durability_snapshot()["totals"]

    def close(self) -> None:
        _STATS.unregister_provider("durability", self._durability_provider)
        _STATS.unregister_provider("quarantine", self._quarantine_provider)
        if self.rollup_mgr is not None:
            self.rollup_mgr.close()
        GOVERNOR.unregister_component("memtable", self._governor_provider)
        # the HTTP layer may have pointed the query tracker at this
        # engine's ledger: a closed engine must neither serve frozen
        # durability state nor stay pinned in memory
        TRACKER.detach_durability_provider(self.durability_snapshot)
        with self._lock, \
                lockdep.allow_blocking("engine.close shutdown fsyncs"):
            for shard in self._shards.values():
                shard.close()
            self._shards.clear()
            for entry in self._staging.values():
                entry[3].close()
            self._staging.clear()


def _remove_shard_dir(path: str) -> None:
    """Delete a shard directory, following a cold-tier symlink
    (services/hierarchical.py): the cold copy goes too, then the link,
    so expired tiered data neither leaks nor comes back at a restart."""
    if os.path.islink(path):
        shutil.rmtree(os.path.realpath(path), ignore_errors=True)
        try:
            os.unlink(path)
        except OSError:
            pass
    else:
        shutil.rmtree(path, ignore_errors=True)


def _downsample_level(shard_path: str) -> int:
    """A shard's current resolution (0 = raw), kept in a marker file
    (the reference's layout)."""
    p = os.path.join(shard_path, "downsample.level")
    try:
        with open(p, encoding="utf-8") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def _set_downsample_level(shard_path: str, every_ns: int) -> None:
    p = os.path.join(shard_path, "downsample.level")
    with open(p, "w", encoding="utf-8") as f:
        f.write(str(every_ns))


def _auto_shard_duration(duration_ns: int) -> int:
    """Influx defaults: RP < 2d -> 1h groups, < 6mo -> 1d, else 7d."""
    day = 24 * 3600 * NS
    if duration_ns == 0:
        return 7 * day
    if duration_ns < 2 * day:
        return 3600 * NS
    if duration_ns < 180 * day:
        return day
    return 7 * day
