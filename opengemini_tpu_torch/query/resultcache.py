"""Incremental query result cache for GROUP BY time() aggregates.

The port of ``opengemini_tpu/query/resultcache.py``, whole, its lock a
``utils/lockdep`` lock as the reference's. The executor reads the
reference's switch, ``OGT_RESULT_CACHE`` (default on; ``0`` turns it
off), at query time.

The reference serves repeated dashboard queries from cached partials with
incremental append (engine/executor/inc_agg_transform.go,
inc_hash_agg_transform.go, lib/resultcache/). Here the unit of caching is
one (group, window) cell: with GROUP BY time() the renderer never needs
selector row identities (output times are window starts), so a cached
cell is just ``(value, count)`` per aggregate — losslessly re-renderable
under any fill/limit/order, including fill(previous)/linear which the
renderer applies over the merged window sequence.

Validity is tracked per window by the (path, data_version) signature of
every shard overlapping it (storage/shard.py data_version: bumped by
writes/deletes/rewrites, not by flush/compact). Appending new points
bumps only the owning shard, so a re-executed dashboard query recomputes
only the trailing (or otherwise touched) windows and re-reads nothing
else; an untouched query answers entirely from cache with no scan and no
device work.

Keys are a time-less statement fingerprint — db/rp/measurement, the
non-time WHERE trees, the window grid (every, offset), grouping, and the
ordered aggregate list — so the same dashboard panel re-queried over a
moving range keeps hitting the same entry (windows are keyed by absolute
start time).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

# bounds: fingerprints (distinct dashboard panels) and windows per panel
_MAX_QUERIES = 64
_MAX_WINDOWS = 16384


class IncrementalCache:
    def __init__(self, max_queries: int = _MAX_QUERIES,
                 max_windows: int = _MAX_WINDOWS):
        self._store: OrderedDict[str, dict] = OrderedDict()
        self._lock = lockdep.Lock()
        self.max_queries = max_queries
        self.max_windows = max_windows

    def lookup(self, fp: str) -> dict:
        """-> {window_start: (sig, {group_key: [(value, count), ...]})}.
        Returns a shallow COPY — update() mutates/evicts the live entry
        concurrently and a plan must keep seeing the windows it
        validated."""
        with self._lock:
            got = self._store.get(fp)
            if got is None:
                return {}
            self._store.move_to_end(fp)
            return dict(got)

    def update(self, fp: str, windows: dict) -> None:
        """Merge freshly-computed windows into the fingerprint's entry."""
        with self._lock:
            entry = self._store.get(fp)
            if entry is None:
                entry = self._store[fp] = {}
            entry.update(windows)
            self._store.move_to_end(fp)
            if len(entry) > self.max_windows:
                for ws in sorted(entry)[: len(entry) - self.max_windows]:
                    del entry[ws]
            while len(self._store) > self.max_queries:
                self._store.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


def fingerprint(db, rp, mst, sc, group_time, group_tags, all_tags,
                agg_specs) -> str:
    """The time-less statement key. The condition subtrees enter by
    their dataclass repr, which is deterministic and as fine-grained
    as the reference's ``sql/astjson.to_json`` form (the port has that
    module too; executor._device_scan_token keys the same way)."""
    return repr((
        db, rp or "", mst,
        repr(sc.tag_expr), repr(sc.field_expr), repr(sc.mixed_expr),
        bool(sc.mixed_series_level),
        group_time.every_ns, group_time.offset_ns,
        list(group_tags), bool(all_tags),
        [[name, list(params), fname] for name, params, fname in agg_specs],
    ))


def window_signature(shards, ws: int, we: int) -> tuple:
    """(path, data_version) of every shard overlapping [ws, we)."""
    return tuple(sorted(
        (sh.path, sh.data_version)
        for sh in shards
        if sh.tmax > ws and sh.tmin < we
    ))


def window_fresh(cached_sig, by_path: dict, ws: int, we: int) -> bool:
    """Is a cached window still valid? The shard SET must be unchanged and
    no shard may have a mutation newer than its cached version touching
    [ws, we) — sub-shard granularity via Shard.changed_since, so a write
    into one window leaves the rest of a 7d shard's windows cached."""
    cur = {sh.path for sh in by_path.values()
           if sh.tmax > ws and sh.tmin < we}
    if {p for p, _v in cached_sig} != cur:
        return False
    for p, v in cached_sig:
        if by_path[p].changed_since(v, ws, we):
            return False
    return True


class CachePlan:
    """Per-execution cache bookkeeping for the executor's aggregate path.

    Built after the scan context; tells the executor which window range
    must actually be scanned (the stale hull) and merges cached cells with
    the fresh compute before rendering.
    """

    def __init__(self, cache: IncrementalCache, fp: str, shards, aligned: int,
                 every_ns: int, W: int, n_aggs: int, tmin: int, tmax: int):
        self.cache = cache
        self.fp = fp
        self.aligned = aligned
        self.every = every_ns
        self.W = W
        self.n_aggs = n_aggs
        self.wstarts = [aligned + w * every_ns for w in range(W)]
        self.sigs = [
            window_signature(shards, ws, ws + every_ns) for ws in self.wstarts
        ]
        # PARTIAL windows — cut by the query's time bounds — cover only a
        # slice of their range: never cached, never served (a different
        # cutoff shares the same fingerprint and window key,
        # TestServer_Query_GroupByTimeCutoffs)
        self.partial = {
            w for w in range(W)
            if self.wstarts[w] < tmin or self.wstarts[w] + every_ns > tmax
        }
        held = cache.lookup(fp)
        self.cached = held
        by_path = {sh.path: sh for sh in shards}
        stale = []
        for w in range(W):
            got = held.get(self.wstarts[w])
            if w in self.partial or got is None or not window_fresh(
                got[0], by_path, self.wstarts[w],
                self.wstarts[w] + every_ns,
            ):
                stale.append(w)
        self.stale = set(stale)
        STATS.incr("executor", "inc_cache_windows_reused", W - len(stale))
        if not stale:
            STATS.incr("executor", "inc_cache_full_hits")

    @property
    def scan_ranges(self):
        """Disjoint [lo, hi) scan ranges covering exactly the stale
        windows, or [] when everything is cached. Kept as runs (not one
        hull) so a now()-relative dashboard query — whose partial edge
        windows are always stale — still skips the cached middle."""
        if not self.stale:
            return []
        runs = []
        for w in sorted(self.stale):
            ws, we = self.wstarts[w], self.wstarts[w] + self.every
            if runs and runs[-1][1] == ws:
                runs[-1][1] = we
            else:
                runs.append([ws, we])
        return [tuple(r) for r in runs]

    def _fresh_ws(self):
        return sorted(self.stale)

    def merge(self, agg_results, aggs, group_keys):
        """Overwrite cached windows into the computed arrays (extending
        group_keys with cache-only groups), then persist the freshly
        computed hull windows. agg_results maps id(call) -> (out, sel,
        counts, spec, fname, times_abs); with GROUP BY time the renderer
        consumes only (out, counts, spec, fname)."""
        W = self.W
        gid_of = {k: i for i, k in enumerate(group_keys)}
        hull = self.stale
        for w in range(W):
            if w in hull:
                continue
            _sig, groups = self.cached[self.wstarts[w]]
            for key in groups:
                if key not in gid_of:
                    gid_of[key] = len(group_keys)
                    group_keys.append(key)
        G = len(group_keys)
        n_seg = G * W

        merged = {}
        for ai, (call, spec, params, fname) in enumerate(aggs):
            out, sel, counts, spec_, fname_, times_abs = agg_results[id(call)]
            out = np.asarray(out)
            new_out = np.zeros(n_seg, dtype=out.dtype)
            new_cnt = np.zeros(n_seg, dtype=np.int64)
            old_G = len(out) // W if W else 0
            if len(out):
                new_out.reshape(G, W)[:old_G] = out.reshape(old_G, W)
                new_cnt.reshape(G, W)[:old_G] = np.asarray(counts).reshape(
                    old_G, W)
            merged[id(call)] = (new_out, new_cnt, spec_, fname_)
        n_aggs = len(aggs)
        for w in range(W):
            if w in hull:
                continue
            _sig, groups = self.cached[self.wstarts[w]]
            if not groups:
                continue
            # vectorized per (window, agg): one fancy-index assignment
            # over all of the window's cached groups
            gids = np.fromiter((gid_of[key] for key in groups),
                               np.int64, len(groups))
            cells = np.asarray(
                [[c[1] for c in v] for v in groups.values()], np.int64)
            segs = gids * W + w
            for ai, (call, _s, _p, _f) in enumerate(aggs):
                new_out, new_cnt, _sp, _fn = merged[id(call)]
                if new_out.dtype.kind in "iu":
                    # int-exact values stay python-int end-to-end: a
                    # float64 staging array would corrupt sums > 2^53
                    new_out[segs] = np.fromiter(
                        (v[ai][0] for v in groups.values()),
                        np.int64, len(groups))
                else:
                    new_out[segs] = np.fromiter(
                        (v[ai][0] for v in groups.values()),
                        np.float64, len(groups))
                new_cnt[segs] = cells[:, ai]

        # persist the recomputed windows (never the partial edge windows;
        # only groups with data — zero cells rebuild as zeros on read, so
        # sparse windows stay cheap at high group cardinality)
        keys_by_gid = list(gid_of)  # insertion order == gid order
        outs2d = [merged[id(call)][0].reshape(G, W) for call, *_ in aggs]
        cnts2d = [merged[id(call)][1].reshape(G, W) for call, *_ in aggs]
        fresh: dict[int, tuple] = {}
        for w in self._fresh_ws():
            if w in self.partial:
                continue
            col_cnt = np.stack([c[:, w] for c in cnts2d])  # (n_aggs, G)
            col_out = np.stack([o[:, w] for o in outs2d])
            has = np.flatnonzero((col_cnt > 0).any(axis=0))
            groups = {
                keys_by_gid[g]: [
                    (col_out[ai, g].item(), int(col_cnt[ai, g]))
                    for ai in range(n_aggs)
                ]
                for g in has
            }
            fresh[self.wstarts[w]] = (self.sigs[w], groups)
        if fresh:
            self.cache.update(self.fp, fresh)

        for call, _s, _p, _f in aggs:
            new_out, new_cnt, sp, fn = merged[id(call)]
            agg_results[id(call)] = (new_out, None, new_cnt, sp, fn, None)
        return group_keys
