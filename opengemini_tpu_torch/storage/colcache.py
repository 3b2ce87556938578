"""Decoded-column cache for immutable shard chunks (host and device
tiers).

The port of ``opengemini_tpu/storage/colcache.py``. Flushed chunks are
immutable until a compaction rewrites them, which is the invariant a
decoded cache needs: a warm repeated query skips the decode (host tier)
and the host-to-device transfer (device tier) of data that has not
changed.

Two tiers, one byte-budgeted LRU each:

  host tier    decoded column arrays (or still-encoded
               record.EncodedColumns), keyed by (shard id, file
               generation, chunk id, series, field). File generations
               come from a process-global counter at TSFReader open, so
               a compaction that rewrites a file in place (same path)
               never aliases a stale entry. Misses fill through the scan
               pool, whose in-flight-bytes backpressure still bounds
               memory.
  device tier  the padded grid tensors a GridBatch (models/grid.py)
               builds on the engine's device for a GROUP BY time() scan,
               keyed by a scan signature that embeds every shard's
               (path, data_version) and the scanned ranges
               (query/executor.py ``_device_scan_token``). A write bumps
               the shard's data_version, so the signature changes; flush
               and compaction change the layout, not the merged rows, and
               keep it. A repeated identical scan skips the decode and
               the transfer, and runs kernel 3 on the retained tensors.

Invalidation — every change of chunk identity:
  flush              adds a new file (a new generation): nothing stale
  compaction         the retired readers' generations, at the file-set
                     swap (storage/shard.py ``_compact_offlock`` and
                     ``_retire_files``)
  shard close        ``Shard.close`` drops its open files' generations
Device entries need no explicit invalidation: their keys move with the
data_versions, and a stale entry ages out of the LRU. Evicting an entry
drops the cache's references to its tensors, so the caching allocator
gets the memory back once no query in flight holds them.

Knobs:
  OGT_COLCACHE_MB         host-tier budget in MiB (default 256; 0
                          disables both tiers, and the per-file reader
                          LRU of storage/tsf.py serves as before)
  OGT_COLCACHE_DEVICE=1   enables the device tier (off by default)
  OGT_COLCACHE_DEVICE_MB  device-tier budget in MiB (default: the host
                          tier's)

Counters (utils/stats.py, module "colcache"): hits, misses, fills,
evictions, invalidations, bytes, device_hits, device_misses,
device_reshards, device_reshard_drops, device_bytes, time_ns. Cache time is also attributed to the running
query (utils/querytracker.py stages) and shown in the executor's
``colcache`` span.

Every retained device entry is a row of the device-memory ledger
(utils/devobs.py ``LEDGER``, owner ``colcache_device``; armed only), kept
in step with its bytes and dropped with it.

Entries also record the device MESH they were laid out for
(parallel/runtime.py): under a mesh the cold scan puts the padded grid
straight into the sharded layout (one transfer), warm scans reuse the
sharded tensors with no transfer, and a ``runtime.set_mesh()`` change
reshards a retained entry device to device on its next use, its stale
tensors donated (parallel/distributed.py ``donate_reshard``): the entry
swaps them out, so they are freed and both layouts are never retained.
Across processes only this rank's shards are resident: a reshard moves
rows between the ranks over the process group, each rank keeps its new
shards' rows and drops the rest, and the entry's bytes become its new
local bytes.
Both tiers' resident bytes are components of the resource governor's
memory ledger (``colcache_host``, ``colcache_device``;
utils/governor.py).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.governor import GOVERNOR
from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

_DEFAULT_MB = 256


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _nbytes(val) -> int:
    """Decoded size of a cached value: a record Column or a bare array
    (object dtype, strings, estimates 64 bytes an element). Mirrors
    TSFReader._val_nbytes so both caches account alike."""
    if getattr(val, "is_decoded", True) is False:
        # still-encoded numeric column: one shared accounting rule,
        # never firing the lazy decode
        return val.accounted_nbytes()
    vals = getattr(val, "values", None)
    if vals is not None:  # Column
        if getattr(vals, "dtype", None) is not None and vals.dtype == object:
            nb = len(vals) * 64
        else:
            nb = int(getattr(vals, "nbytes", len(vals) * 64))
        return nb + int(val.valid.nbytes)
    return int(getattr(val, "nbytes", 64))


def tensor_nbytes(t) -> int:
    """Bytes a retained device tensor (or a sharded one) holds."""
    from opengemini_tpu_torch.parallel import distributed

    return distributed.nbytes_of(t)


class ColumnCache:
    """Thread-safe two-tier LRU of decoded chunk columns.

    Host values are whatever the reader decoded; they are immutable by
    the read-path contract, so entries are shared across queries without
    copies, and an invalidation only drops the cache's reference."""

    def __init__(self, budget_mb: int | None = None,
                 device: bool | None = None,
                 device_budget_mb: int | None = None):
        self._lock = lockdep.Lock()
        # serializes mesh reshards of device entries (never held with
        # _lock across the relayout itself)
        self._reshard_lock = lockdep.Lock()
        self._host: OrderedDict = OrderedDict()  # key -> (value, nbytes)
        self._by_gen: dict[int, set] = {}
        self._host_bytes = 0
        # tombstones of recently invalidated generations: a query that
        # took the file set before a swap may still be filling through
        # retired readers, and those late put()s must not re-create
        # entries no hook will ever drop
        self._retired: OrderedDict = OrderedDict()
        self._dev: OrderedDict = OrderedDict()  # token -> (entry, nbytes)
        self._dev_bytes = 0
        if budget_mb is None:
            budget_mb = max(0, _env_int("OGT_COLCACHE_MB", _DEFAULT_MB))
        if device is None:
            device = os.environ.get("OGT_COLCACHE_DEVICE", "0") not in ("", "0")
        if device_budget_mb is None:
            device_budget_mb = max(0, _env_int("OGT_COLCACHE_DEVICE_MB",
                                               budget_mb))
        self._budget = int(budget_mb) << 20
        self._dev_budget = int(device_budget_mb) << 20
        self._device = bool(device)

    # -- configuration ----------------------------------------------------

    def enabled(self) -> bool:
        return self._budget > 0

    def device_enabled(self) -> bool:
        return self._device and self._budget > 0

    def config(self) -> dict:
        """The knobs in configure()'s units (save and restore)."""
        with self._lock:
            return {"budget_mb": self._budget >> 20,
                    "device": self._device,
                    "device_budget_mb": self._dev_budget >> 20}

    def configure(self, budget_mb: int | None = None,
                  device: bool | None = None,
                  device_budget_mb: int | None = None) -> None:
        """Reconfigure at run time. Shrinking a budget evicts at once;
        disabling clears the tier. Each knob changes only when passed."""
        with self._lock:
            if budget_mb is not None:
                self._budget = int(budget_mb) << 20
            if device is not None:
                self._device = bool(device)
            if device_budget_mb is not None:
                self._dev_budget = int(device_budget_mb) << 20
            if self._budget <= 0:
                self._host.clear()
                self._by_gen.clear()
                self._host_bytes = 0
            else:
                self._evict_host_locked()
            if self._dev_budget <= 0 or not self.device_enabled():
                self._drop_dev_all_locked()
            else:
                self._evict_dev_locked()
            self._publish_locked()

    def clear(self) -> None:
        with self._lock:
            self._host.clear()
            self._by_gen.clear()
            self._host_bytes = 0
            self._drop_dev_all_locked()
            self._publish_locked()

    def _drop_dev_all_locked(self) -> None:
        for ent, _nb in self._dev.values():
            devobs.LEDGER.drop(ent.pop("_ledger", None))
        self._dev.clear()
        self._dev_bytes = 0

    # -- host tier --------------------------------------------------------

    def get(self, key):
        """Counted lookup (the fill path calls this once per column)."""
        t0 = time.perf_counter_ns()
        with self._lock:
            got = self._host.get(key)
            if got is not None:
                self._host.move_to_end(key)
        _STATS.incr("colcache", "hits" if got is not None else "misses")
        self._note_time(time.perf_counter_ns() - t0)
        return got[0] if got is not None else None

    def peek(self, key):
        """Uncounted lookup for the consult-before-dispatch path: a
        partly cached chunk falls through to the pool fill, which counts
        its own get() per column. Hits still refresh recency."""
        with self._lock:
            got = self._host.get(key)
            if got is None:
                return None
            self._host.move_to_end(key)
            return got[0]

    def count_peek(self, hits: int, time_ns: int = 0) -> None:
        """Fold a consult-before-dispatch assembly (N column peeks that
        all hit) into the counters."""
        if hits:
            _STATS.incr("colcache", "hits", hits)
        if time_ns:
            self._note_time(time_ns)

    def put(self, key, value) -> None:
        t0 = time.perf_counter_ns()
        nb = _nbytes(value)
        if nb > self._budget:
            return  # a single oversized column never enters the cache
        with self._lock:
            if self._budget <= 0 or key[1] in self._retired:
                return  # a decode racing the swap must not resurrect it
            if key not in self._host:
                self._host[key] = (value, nb)
                self._host_bytes += nb
                self._by_gen.setdefault(key[1], set()).add(key)
            self._host.move_to_end(key)
            self._evict_host_locked()
            self._publish_locked()
        _STATS.incr("colcache", "fills")
        self._note_time(time.perf_counter_ns() - t0)

    def _drop_host_locked(self, key) -> None:
        val = self._host.pop(key, None)
        if val is None:
            return
        self._host_bytes -= val[1]
        keys = self._by_gen.get(key[1])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_gen[key[1]]

    def _evict_host_locked(self) -> None:
        n = 0
        while self._host_bytes > self._budget and self._host:
            self._drop_host_locked(next(iter(self._host)))
            n += 1
        if n:
            _STATS.incr("colcache", "evictions", n)

    def invalidate_gens(self, gens) -> int:
        """Drop every host entry of the given file generations (the
        file-set-swap hook). Readers holding decoded arrays keep them;
        only the cache's references drop."""
        n = 0
        with self._lock:
            for gen in gens:
                # tombstone first (a bounded recency window: in-flight
                # decodes of the retired readers race this by at most
                # one scan)
                self._retired[gen] = None
                self._retired.move_to_end(gen)
                while len(self._retired) > 65536:
                    self._retired.popitem(last=False)
                for key in self._by_gen.pop(gen, ()):
                    got = self._host.pop(key, None)
                    if got is not None:
                        self._host_bytes -= got[1]
                        n += 1
            if n:
                self._publish_locked()
        if n:
            _STATS.incr("colcache", "invalidations", n)
        return n

    # -- device tier ------------------------------------------------------

    def device_get(self, token, shape, dtype: str, mesh=None):
        """The retained grid entry of a scan signature, or None. Shape
        and dtype are checked defensively (the signature pins them; a
        mismatch is a miss, never an error).

        ``mesh`` is the caller's CURRENT layout (the configured mesh, or
        None for one device). A hit laid out for another mesh (a
        runtime.set_mesh() since, a config reload) is resharded in place
        device to device, its stale tensors donated, so the swap never
        decodes or transfers from the host again."""
        if not self.device_enabled():
            return None
        t0 = time.perf_counter_ns()
        with self._lock:
            got = self._dev.get(token)
            if got is not None:
                self._dev.move_to_end(token)
        ent = got[0] if got is not None else None
        if ent is not None and (ent["shape"] != tuple(shape)
                                or ent["dtype"] != dtype):
            ent = None
        if ent is not None and ent.get("mesh") is not mesh:
            ent = self._device_reshard(token, ent, mesh)
        _STATS.incr("colcache",
                    "device_hits" if ent is not None else "device_misses")
        self._note_time(time.perf_counter_ns() - t0)
        return ent

    def _device_reshard(self, token, ent, mesh):
        """Relayout a retained entry onto ``mesh`` (None = one device),
        donating its stale tensors. Returns the updated entry, or None
        (dropped: a miss) when its rows cannot split evenly over the new
        mesh; the caller then rebuilds from host rows.

        Serialized by ``_reshard_lock`` and re-checked under the cache
        lock, so threads chasing one mesh swap never relayout the same
        tensors twice."""
        from opengemini_tpu_torch.parallel import distributed

        with self._reshard_lock:
            with self._lock:
                got = self._dev.get(token)
                live = got[0] if got is not None else None
                if live is not ent:
                    # replaced while we waited: usable only if the
                    # replacement already has the requested layout
                    return (live if live is not None
                            and live.get("mesh") is mesh else None)
                if ent.get("mesh") is mesh:
                    return ent  # another thread finished the swap
                arrays = [ent["vt"], ent["mt"]]
                if ent.get("imat") is not None:
                    arrays.append(ent["imat"])
            rows = ent["shape"][0]
            if mesh is not None and (rows < mesh.size or rows % mesh.size):
                with self._lock:
                    got = self._dev.get(token)
                    if got is not None and got[0] is ent:
                        del self._dev[token]
                        self._dev_bytes -= got[1]
                        devobs.LEDGER.drop(ent.pop("_ledger", None))
                        self._publish_locked()
                _STATS.incr("colcache", "device_reshard_drops")
                return None
            out = distributed.donate_reshard(
                ent["home"] if mesh is None else mesh, *arrays)
            del arrays
            with self._lock:
                ent["vt"], ent["mt"] = out[0], out[1]
                # an imat attached between the snapshot and the swap
                # carries the OLD layout: drop it (the next selector
                # query rebuilds it)
                ent["imat"] = out[2] if len(out) > 2 else None
                got = self._dev.get(token)
                if got is not None and got[0] is ent:
                    # the entry's bytes are its new layout's (across
                    # processes a rank keeps only its new shards' rows)
                    nb = sum(tensor_nbytes(t) for t in out)
                    self._dev[token] = (ent, nb)
                    self._dev_bytes += nb - got[1]
                    devobs.LEDGER.update(ent.get("_ledger"), nb)
                    self._publish_locked()
                ent["mesh"] = mesh
                devobs.LEDGER.update(ent.get("_ledger"),
                                     mesh_epoch=self._mesh_epoch(mesh))
        _STATS.incr("colcache", "device_reshards")
        return ent

    def device_put_grid(self, token, vt, mt, shape, dtype: str,
                        mesh=None) -> dict:
        """Retain freshly built grid tensors and return the entry (callers
        use the returned dict, so concurrent puts converge on one).
        ``mesh`` is the layout they were built for (None = one device);
        device_get reshards the entry when the process mesh changes."""
        ent = {"vt": vt, "mt": mt, "imat": None,
               "shape": tuple(shape), "dtype": dtype, "mesh": mesh,
               # the one device a single-device layout returns to
               "home": (vt.device if mesh is None
                        else mesh.local_devices[0])}
        nb = tensor_nbytes(vt) + tensor_nbytes(mt)
        if not self.device_enabled() or nb > self._dev_budget:
            return ent  # still usable by the caller, just not retained
        with self._lock:
            got = self._dev.get(token)
            if got is not None:
                if (got[0]["shape"] == ent["shape"]
                        and got[0]["dtype"] == ent["dtype"]
                        and got[0].get("mesh") is mesh):
                    self._dev.move_to_end(token)
                    return got[0]
                # same token, other geometry or layout: replace
                del self._dev[token]
                self._dev_bytes -= got[1]
                devobs.LEDGER.drop(got[0].pop("_ledger", None))
            self._dev[token] = (ent, nb)
            self._dev_bytes += nb
            ent["_ledger"] = devobs.LEDGER.register(
                "colcache_device", nb, mesh_epoch=self._mesh_epoch(mesh),
                label=str(token)[:120])
            self._evict_dev_locked()
            self._publish_locked()
        return ent

    @staticmethod
    def _mesh_epoch(mesh):
        """Ledger epoch stamp: the live mesh epoch for sharded entries,
        None for single-device ones (not mesh-dependent)."""
        if mesh is None:
            return None
        from opengemini_tpu_torch.parallel import runtime

        return runtime.mesh_epoch()

    def device_add_imat(self, token, ent, imat, mesh=None):
        """Attach the lazily built selector index grid to a retained
        entry and return the winning one: a thread that lost the race
        gets the attached one, whose bytes count once. ``mesh`` is the
        layout the caller built ``imat`` for: if a reshard moved the
        entry meanwhile, the caller uses its imat and it is not
        attached."""
        with self._lock:
            got = self._dev.get(token)
            if got is None or got[0] is not ent:
                # no longer retained: the caller's own use only
                if ent.get("imat") is None:
                    ent["imat"] = imat
                return ent["imat"]
            if ent.get("imat") is not None:
                return ent["imat"]
            if ent.get("mesh") is not mesh:
                return imat  # the entry was resharded since
            ent["imat"] = imat
            nb = got[1] + tensor_nbytes(imat)
            self._dev[token] = (ent, nb)
            self._dev_bytes += tensor_nbytes(imat)
            devobs.LEDGER.update(ent.get("_ledger"), nb)
            self._evict_dev_locked()
            self._publish_locked()
        return imat

    def _evict_dev_locked(self) -> None:
        n = 0
        while self._dev_bytes > self._dev_budget and self._dev:
            _k, (ent, nb) = self._dev.popitem(last=False)
            self._dev_bytes -= nb
            devobs.LEDGER.drop(ent.pop("_ledger", None))
            n += 1
        if n:
            _STATS.incr("colcache", "evictions", n)

    # -- introspection ----------------------------------------------------

    def counters(self) -> dict:
        """Counter snapshot (hit rates, the executor's per-scan delta for
        the ``colcache`` span)."""
        snap = _STATS.counters("colcache")
        with self._lock:
            snap["bytes"] = self._host_bytes
            snap["device_bytes"] = self._dev_bytes
            snap["entries"] = len(self._host)
            snap["device_entries"] = len(self._dev)
        for k in ("hits", "misses", "fills", "evictions", "invalidations",
                  "device_hits", "device_misses", "device_reshards",
                  "device_reshard_drops", "time_ns"):
            snap.setdefault(k, 0)
        return snap

    def ledger_bytes(self) -> int:
        """Host-tier resident bytes (the governor's ledger)."""
        with self._lock:
            return self._host_bytes

    def device_ledger_bytes(self) -> int:
        """Device-tier resident bytes."""
        with self._lock:
            return self._dev_bytes

    def _publish_locked(self) -> None:
        _STATS.set("colcache", "bytes", self._host_bytes)
        _STATS.set("colcache", "device_bytes", self._dev_bytes)

    @staticmethod
    def _note_time(dt_ns: int) -> None:
        _STATS.incr("colcache", "time_ns", dt_ns)
        _TRACKER.add_stage_ns(_TRACKER.current_qid(), "colcache", dt_ns)


# process-wide cache
GLOBAL = ColumnCache()

# both tiers join the resource governor's unified memory ledger
GOVERNOR.register_component("colcache_host", GLOBAL.ledger_bytes)
GOVERNOR.register_component("colcache_device", GLOBAL.device_ledger_bytes)
