"""ctypes binding for the C++ mergeset series index
(native/seriesindex.cpp): the on-disk series index both packages keep
under a shard's ``seriesidx/`` directory.

The port of ``opengemini_tpu/index/mergeset.py``. Sorted immutable
posting runs on disk plus a WAL-backed memtable live in the C++
library; regex matching stays in Python (``re`` semantics) over the
distinct tag values the library enumerates. The columnar label tier
(index/labels.py) answers the empty-value, ``!=`` and regex matches
from its snapshot, keyed on ``label_gen()`` (a per-measurement insert
generation and an index-wide removal epoch); ``OGT_LABEL_INDEX=0``
keeps every match on the walk. ``remove_sids`` drops the
series of a full-series delete (tombstones in the library). The library
is built with g++ at first use (see ``opengemini_tpu_torch.native``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import struct
import threading

import numpy as np

from opengemini_tpu_torch import native
from opengemini_tpu_torch.index.inverted import SeriesIndex, parse_series_key
from opengemini_tpu_torch.ingest.line_protocol import series_key
from opengemini_tpu_torch.utils import lockdep

_LIB = None
_lib_lock = threading.Lock()


def load():
    """The series-index library, built and bound at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lib_lock:
        if _LIB is None:
            lib = ctypes.CDLL(native.build_shared("seriesindex.cpp"))
            u64 = ctypes.c_uint64
            p = ctypes.c_void_p
            cp = ctypes.c_char_p
            u64p = ctypes.POINTER(u64)
            for name, res, args in [
                ("msi_open", p, [cp]),
                ("msi_close", None, [p]),
                ("msi_free", None, [p]),
                ("msi_insert", u64, [p, cp, u64, u64]),
                ("msi_insert_keys", u64, [p, cp, u64, u64, u64p]),
                ("msi_has_live", ctypes.c_int, [p, cp, u64]),
                ("msi_series_ids", p, [p, cp, u64, u64p]),
                ("msi_match_eq", p, [p, cp, u64, cp, u64, cp, u64, u64p]),
                ("msi_enum_field", p, [p, ctypes.c_char, cp, u64,
                                       ctypes.c_uint32, u64p, u64p]),
                ("msi_key_of", p, [p, u64, u64p]),
                ("msi_keys_of", p, [p, u64p, u64, u64p]),
                ("msi_flush", None, [p]),
                ("msi_compact", None, [p]),
                ("msi_remove_sids", None, [p, u64p, u64]),
            ]:
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _LIB = lib
    return _LIB


def _field(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _pack_series(key: str, mst: str, tags: tuple) -> bytes:
    out = [_field(key.encode()), _field(mst.encode()),
           struct.pack("<I", len(tags))]
    for k, v in tags:
        out.append(_field(k.encode()))
        out.append(_field(v.encode()))
    return b"".join(out)


def _unpack_series(blob: bytes):
    off = 0

    def field():
        nonlocal off
        (n,) = struct.unpack_from("<I", blob, off)
        off += 4
        f = blob[off:off + n]
        off += n
        return f

    key = field().decode()
    mst = field().decode()
    (ntags,) = struct.unpack_from("<I", blob, off)
    off += 4
    tags = tuple(
        (field().decode(), field().decode()) for _ in range(ntags)
    )
    return key, mst, tags


_TAGS_CACHE_MAX = 200_000


class MergesetIndex:
    """The SeriesIndex API backed by the native mergeset engine. `path`
    is a DIRECTORY (runs + wal live inside)."""

    def __init__(self, path: str):
        lib = load()
        self._lib = lib
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._h = lib.msi_open(path.encode())
        if not self._h:
            raise OSError(f"msi_open failed for {path!r}")
        self._lock = lockdep.RLock()
        # sid -> (mst, tags): bounded decode cache for the render path
        self._tags_cache: dict[int, tuple] = {}
        # series key -> sid: ingest is overwhelmingly repeat series
        self._key_cache: dict[str, int] = {}
        # label-engine invalidation protocol: per-measurement insert
        # generation + index-wide removal epoch (index.labels snapshots
        # and the tag_values cache key off label_gen())
        self._label_gens: dict[str, int] = {}
        self._label_epoch = 0
        # (measurement, key) -> (label_gen, sorted values)
        self._tagvals_cache: dict[tuple, tuple] = {}

    @contextlib.contextmanager
    def _native(self):
        """Serialized access to the live native handle: a racing close()
        can never free the handle under a reader."""
        with self._lock:
            if not self._h:
                raise OSError("series index is closed")
            yield self._h

    def label_gen(self, measurement: str) -> tuple:
        return (self._label_epoch, self._label_gens.get(measurement, 0))

    def _label_bump(self, measurement: str) -> None:
        self._label_gens[measurement] = \
            self._label_gens.get(measurement, 0) + 1

    # -- write side ---------------------------------------------------------

    def get_or_create(self, measurement: str, tags: tuple) -> int:
        key = series_key(measurement, tags)
        sid = self._key_cache.get(key)
        if sid is not None:
            return sid
        return self._insert_series(key, measurement, tags)

    def get_or_create_by_key(self, key: str) -> int:
        sid = self._key_cache.get(key)
        if sid is not None:
            return sid
        measurement, tags = parse_series_key(key)
        return self._insert_series(key, measurement, tags)

    def _insert_series(self, key: str, measurement: str, tags: tuple) -> int:
        blob = _pack_series(key, measurement, tags)
        with self._native() as h:
            sid = int(self._lib.msi_insert(h, blob, len(blob), 0))
        self._label_bump(measurement)
        if len(self._key_cache) >= _TAGS_CACHE_MAX:
            self._key_cache.clear()
        self._key_cache[key] = sid
        return sid

    def get_or_create_bulk(self, keys: list[str]) -> list[int]:
        """Batched canonical-key ingest: one native call parses and
        inserts every escape-free new key; keys with backslash escapes
        keep the per-key path."""
        out = [0] * len(keys)
        plain_i: list[int] = []
        parts: list[bytes] = []
        cache = self._key_cache
        for i, key in enumerate(keys):
            sid = cache.get(key)
            if sid is not None:
                out[i] = sid
            elif "\\" in key:
                out[i] = self.get_or_create_by_key(key)
            else:
                kb = key.encode()
                parts.append(struct.pack("<I", len(kb)) + kb)
                plain_i.append(i)
        if plain_i:
            if len(cache) + len(plain_i) >= _TAGS_CACHE_MAX:
                cache.clear()
            chunk = 32_768  # bounded lock holds for concurrent readers
            for lo in range(0, len(plain_i), chunk):
                idxs = plain_i[lo:lo + chunk]
                blob = b"".join(parts[lo:lo + chunk])
                sids = (ctypes.c_uint64 * len(idxs))()
                with self._native() as h:
                    done = int(self._lib.msi_insert_keys(
                        h, blob, len(blob), len(idxs), sids))
                if done != len(idxs):
                    raise OSError("series index batch insert failed")
                for i, sid in zip(idxs, sids):
                    out[i] = int(sid)
                    cache[keys[i]] = int(sid)
                    # plain keys carry no escapes, so the measurement is
                    # exactly the prefix before the first comma
                    self._label_bump(keys[i].split(",", 1)[0])
        return out

    def flush(self) -> None:
        with self._native() as h:
            self._lib.msi_flush(h)

    def compact(self) -> None:
        with self._native() as h:
            self._lib.msi_compact(h)

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.msi_close(self._h)
                self._h = None

    # -- read side ----------------------------------------------------------

    def _sid_buf(self, ptr, n: int) -> set[int]:
        try:
            if not n:
                return set()
            raw = ctypes.string_at(ptr, n * 8)
            return set(map(int, np.frombuffer(raw, "<u8")))
        finally:
            self._lib.msi_free(ptr)

    def series_ids(self, measurement: str) -> set[int]:
        m = measurement.encode()
        n = ctypes.c_uint64()
        with self._native() as h:
            ptr = self._lib.msi_series_ids(h, m, len(m), ctypes.byref(n))
        return self._sid_buf(ptr, int(n.value))

    def _match_eq_raw(self, measurement: str, key: str,
                      value: str) -> set[int]:
        m, k, v = measurement.encode(), key.encode(), value.encode()
        n = ctypes.c_uint64()
        with self._native() as h:
            ptr = self._lib.msi_match_eq(
                h, m, len(m), k, len(k), v, len(v), ctypes.byref(n))
        return self._sid_buf(ptr, int(n.value))

    def _with_key(self, measurement: str, key: str) -> set[int]:
        """Series carrying the tag key at all (any value, an explicit
        empty one included)."""
        out: set[int] = set()
        for v in self.tag_values(measurement, key):
            out |= self._match_eq_raw(measurement, key, v)
        return out

    def _match_eq_walk(self, measurement: str, key: str,
                       value: str) -> set[int]:
        """The walk over the native postings: the oracle the columnar
        tier is held to."""
        if value == "":
            # influx: a missing tag equals the empty string; an explicit
            # '' value stored in the index matches too
            return (self.series_ids(measurement)
                    - self._with_key(measurement, key)) | \
                self._match_eq_raw(measurement, key, "")
        return self._match_eq_raw(measurement, key, value)

    def _match_neq_walk(self, measurement: str, key: str,
                        value: str) -> set[int]:
        return self.series_ids(measurement) - self._match_eq_walk(
            measurement, key, value)

    def _tier_match(self, op: str, measurement: str, key: str,
                    value: str) -> set[int] | None:
        """The columnar tier's answer as a set (the index API's type), or
        None when the tier is switched off."""
        from opengemini_tpu_torch.index import labels

        tier = labels.tier_for(self)
        if tier is None:
            return None
        arr = labels.match_tier(tier.snapshot(measurement), op, key, value)
        return None if arr is None else set(arr.tolist())

    def match_eq(self, measurement: str, key: str, value: str) -> set[int]:
        if value == "":
            # the empty-value walk pays one native match per distinct
            # value (_with_key): one posting-tier mask replaces it
            got = self._tier_match("=", measurement, key, value)
            if got is not None:
                return got
        return self._match_eq_walk(measurement, key, value)

    def match_neq(self, measurement: str, key: str, value: str) -> set[int]:
        # the walk rebuilds the full series_ids set to subtract from
        got = self._tier_match("!=", measurement, key, value)
        if got is not None:
            return got
        return self._match_neq_walk(measurement, key, value)

    def _enum(self, kind: bytes, pfx: bytes, idx: int) -> list[str]:
        n = ctypes.c_uint64()
        blen = ctypes.c_uint64()
        with self._native() as h:
            ptr = self._lib.msi_enum_field(
                h, kind, pfx, len(pfx), idx, ctypes.byref(n),
                ctypes.byref(blen))
        try:
            raw = ctypes.string_at(ptr, blen.value)
        finally:
            self._lib.msi_free(ptr)
        out = []
        off = 0
        for _ in range(n.value):
            (ln,) = struct.unpack_from("<I", raw, off)
            off += 4
            out.append(raw[off:off + ln].decode())
            off += ln
        return out

    def tag_keys(self, measurement: str) -> list[str]:
        return sorted(self._enum(b"P", _field(measurement.encode()), 1))

    _TAGVALS_CACHE_MAX = 4096

    def tag_values(self, measurement: str, key: str) -> list[str]:
        # generation-keyed cache: a regex walk enumerates the values
        # twice for an empty-matching selector. Callers get the cached
        # list itself and never mutate it.
        gen = self.label_gen(measurement)
        got = self._tagvals_cache.get((measurement, key))
        if got is not None and got[0] == gen:
            return got[1]
        pfx = _field(measurement.encode()) + _field(key.encode())
        vals = sorted(self._enum(b"P", pfx, 2))
        if len(self._tagvals_cache) >= self._TAGVALS_CACHE_MAX:
            self._tagvals_cache.clear()
        self._tagvals_cache[(measurement, key)] = (gen, vals)
        return vals

    def match_regex(self, measurement: str, key: str, pattern: str,
                    negate: bool = False) -> set[int]:
        got = self._tier_match("!~" if negate else "=~",
                               measurement, key, pattern)
        if got is not None:
            return got
        return self._match_regex_walk(measurement, key, pattern, negate)

    def _match_regex_walk(self, measurement: str, key: str, pattern: str,
                          negate: bool = False) -> set[int]:
        rx = re.compile(pattern)
        hit: set[int] = set()
        empty_matches = bool(rx.search(""))  # missing tag is "" (influx)
        with_key: set[int] = set()
        for v in self.tag_values(measurement, key):
            if rx.search(v):
                got = self._match_eq_raw(measurement, key, v)
                hit |= got
                if empty_matches:
                    with_key |= got
            elif empty_matches:
                with_key |= self._match_eq_raw(measurement, key, v)
        if empty_matches:
            hit |= self.series_ids(measurement) - with_key
        if negate:
            return self.series_ids(measurement) - hit
        return hit

    def series_entry(self, sid: int) -> tuple[str, tuple]:
        got = self._tags_cache.get(sid)
        if got is None:
            n = ctypes.c_uint64()
            with self._native() as h:
                ptr = self._lib.msi_key_of(h, sid, ctypes.byref(n))
            try:
                raw = ctypes.string_at(ptr, n.value)
            finally:
                self._lib.msi_free(ptr)
            if not raw:
                raise KeyError(sid)
            _key, mst, tags = _unpack_series(raw)
            if len(self._tags_cache) >= _TAGS_CACHE_MAX:
                self._tags_cache.clear()
            got = self._tags_cache[sid] = (mst, tags)
        return got

    def tags_of(self, sid: int) -> dict[str, str]:
        return dict(self.series_entry(sid)[1])

    def entries_bulk(self, sids,
                     cache: bool = True) -> list[tuple[str, tuple] | None]:
        """Batch series_entry: one native call for all sids. Missing sids
        yield None. ``cache=False`` leaves the shared tags cache alone
        (label-tier builds over many series must not evict the render
        path's working set)."""
        sids = [int(s) for s in np.asarray(sids, dtype=np.uint64).tolist()]
        # answers assemble into a local map first: evicting the shared
        # cache must never drop answers for sids cached before this call
        local = {s: self._tags_cache[s] for s in sids
                 if s in self._tags_cache}
        missing = [s for s in sids if s not in local]
        if missing:
            arr = (ctypes.c_uint64 * len(missing))(*missing)
            n = ctypes.c_uint64()
            with self._native() as h:
                ptr = self._lib.msi_keys_of(h, arr, len(missing),
                                            ctypes.byref(n))
            try:
                raw = ctypes.string_at(ptr, n.value)
            finally:
                self._lib.msi_free(ptr)
            off = 0
            for sid in missing:
                (ln,) = struct.unpack_from("<I", raw, off)
                off += 4
                if ln:
                    _key, mst, tags = _unpack_series(raw[off:off + ln])
                    local[sid] = (mst, tags)
                off += ln
            if cache:
                if len(self._tags_cache) + len(missing) >= _TAGS_CACHE_MAX:
                    self._tags_cache.clear()
                self._tags_cache.update(local)
        return [local.get(s) for s in sids]

    def iter_series_entries(self):
        """(measurement, tags) of every live series, by measurement then
        sid (SHOW SERIES CARDINALITY walks it)."""
        for m in self.measurements():
            for sid in sorted(self.series_ids(m)):
                yield self.series_entry(sid)

    def measurements(self) -> list[str]:
        # a measurement whose every series was removed must not list
        out = []
        for m in self._enum(b"M", b"", 0):
            mb = m.encode()
            with self._native() as h:
                if self._lib.msi_has_live(h, mb, len(mb)):
                    out.append(m)
        return sorted(out)

    # -- deletion -------------------------------------------------------------

    def remove_sids(self, sids: set[int]) -> None:
        """Drop series from the index (a full-series delete)."""
        if not sids:
            return
        arr = (ctypes.c_uint64 * len(sids))(*sorted(sids))
        with self._native() as h:
            self._lib.msi_remove_sids(h, arr, len(sids))
        for sid in sids:
            self._tags_cache.pop(sid, None)
        self._key_cache.clear()  # deletes are rare; a full drop is fine
        # removals don't know their measurements: the index-wide epoch
        # invalidates every label-tier snapshot and tag_values entry
        self._label_epoch += 1
        self._tagvals_cache.clear()


def open_series_index(shard_path: str) -> MergesetIndex:
    """Index of a shard directory: the native mergeset engine, migrating
    a legacy ``series.log`` (the dict index's JSON log) into it once."""
    legacy_log = os.path.join(shard_path, "series.log")
    idx = MergesetIndex(os.path.join(shard_path, "seriesidx"))
    if os.path.exists(legacy_log):
        legacy = SeriesIndex(legacy_log)
        for sid, (mst, tags) in sorted(legacy.sid_to_series.items()):
            blob = _pack_series(series_key(mst, tags), mst, tags)
            idx._lib.msi_insert(idx._h, blob, len(blob), sid)
        legacy.close()
        idx.compact()
        idx.flush()
        os.replace(legacy_log, legacy_log + ".migrated")
    return idx
