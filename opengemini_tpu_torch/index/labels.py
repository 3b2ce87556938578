"""Columnar label engine: per-measurement dictionary-encoded tag
columns + sorted int64 posting arrays over the durable series index.

Role of the reference's high-cardinality matcher path (tsi mergeset
search.go): answer label selectors over millions of series without one
index round-trip per distinct value. The durable index (mergeset or
dict) stays the source of truth; this tier is a lazily-built, cache-like
projection of one measurement's series:

  sids   sorted int64 array of the measurement's live series ids;
         row i of every column describes series sids[i]
  cols   tag key -> _KeyCol: the key's distinct values dictionary-
         encoded (sorted list + value->vid map) and one int32 vid per
         row, -1 where the series lacks the key

Matching is vectorized over those arrays:
  =  / != dictionary lookup + posting slice / column mask
  =~ / !~ the compiled regex runs ONCE per DISTINCT value over the
          dictionary, producing a boolean LUT; one gather of the LUT
          through the vid column yields the row mask (optionally routed
          to the caller's torch device as a scan->filter gather via the
          offload planner's ``label_match`` family)
All results are SORTED unique int64 sid arrays, so matcher composition
is np.intersect1d/union1d/setdiff1d instead of Python set algebra.

Consistency: the base index bumps a per-measurement generation counter
on insert and an index-wide epoch on removal (label_gen()); a snapshot
records the generation it was built from and rebuilds lazily when it
goes stale. Results are bit-identical to the set-returning index walk
(the oracle — tests/test_labels.py fuzzes the equivalence), including
the influx missing-tag-equals-"" rule. `OGT_LABEL_INDEX=0` disables the
tier entirely and every caller falls back to the walk.

The port of ``opengemini_tpu/index/labels.py``. The LUT gather's device
route runs on the device the caller passes (the engine's); a caller
with no device keeps the host route. With a device mesh configured
(parallel/runtime.py) the planner also weighs the "mesh" route: rows
hash-partitioned by series id over the shards, each part gathered on
its shard's device (``_gather_mesh``). A failure of a device gather
raises: the route decision is a routing rule, not a fallback.
"""

from __future__ import annotations

import os
import re
import threading
import time

import numpy as np

from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

EMPTY_SIDS = np.empty(0, np.int64)
_FNV = np.uint64(0x9E3779B97F4A7C15)  # Fibonacci hashing multiplier

# below this row count the LUT gather is memcpy-bound on the host and
# the device round-trip can never win — don't even ask the planner
_DEVICE_MIN_ROWS = 65_536

def enabled() -> bool:
    return os.environ.get("OGT_LABEL_INDEX", "1") != "0"


def _device_mode() -> str:
    """'' auto (planner decides, static host), '0' host-only,
    '1' device static."""
    return os.environ.get("OGT_LABEL_INDEX_DEVICE", "")


def tier_for(index) -> "LabelTier | None":
    """The index's columnar tier, or None when the knob is off or the
    index lacks the label_gen generation protocol (remote/meta proxies
    keep the set walk)."""
    if not enabled():
        return None
    tier = getattr(index, "_label_tier", None)
    if tier is None:
        if not hasattr(index, "label_gen"):
            return None
        tier = index._label_tier = LabelTier(index)
    return tier


class _KeyCol:
    """One tag key's dictionary-encoded column: sorted distinct values,
    value->vid map, and an int32 vid per snapshot row (-1 = series has
    no such tag). Posting arrays derive lazily from ONE stable argsort
    of the column — postings(vid) slices are sorted row indices, hence
    sorted sid arrays after gathering through the snapshot's sids."""

    __slots__ = ("values", "vid_map", "col", "n_present",
                 "_rows_sorted", "_bounds", "_values_u")

    def __init__(self, values: list[str], vid_map: dict, col: np.ndarray,
                 n_present: int):
        self.values = values
        self.vid_map = vid_map
        self.col = col
        self.n_present = n_present
        self._rows_sorted = None
        self._bounds = None
        self._values_u = None

    def values_u(self) -> np.ndarray:
        """The distinct values as a numpy unicode array (lazy; feeds the
        vectorized np.char substring prefilter for regex matchers)."""
        if self._values_u is None:
            self._values_u = np.asarray(self.values, dtype=np.str_)
        return self._values_u

    def _postings(self):
        if self._rows_sorted is None:
            pres = np.flatnonzero(self.col >= 0)
            vids = self.col[pres]
            order = np.argsort(vids, kind="stable")
            self._rows_sorted = pres[order]
            self._bounds = np.searchsorted(
                vids[order], np.arange(len(self.values) + 1))
        return self._rows_sorted, self._bounds

    def counts(self) -> np.ndarray:
        _, bounds = self._postings()
        return np.diff(bounds)

    def posting_rows(self, vid: int) -> np.ndarray:
        rows, bounds = self._postings()
        return rows[bounds[vid]:bounds[vid + 1]]


_RX_SPECIALS = frozenset("([{.*+?\\^$)|")
_RX_QUANTS = frozenset("*+?{")
_PREFILTER_MIN_VALUES = 4096  # below this a plain LUT pass is cheaper


def _literal_head(pattern: str) -> str:
    """The pattern's leading literal run — a MANDATORY substring of any
    re.search hit (the match starts by consuming it), so it can gate a
    vectorized substring prefilter over the distinct values. Returns ''
    when no safe literal exists: any alternation may bypass the head
    (`abc|x`), and a quantifier makes the preceding char optional."""
    if "|" in pattern:
        return ""
    if pattern.startswith("^"):
        pattern = pattern[1:]
    out: list[str] = []
    for ch in pattern:
        if ch in _RX_SPECIALS:
            if ch in _RX_QUANTS and out:
                out.pop()  # `ab*`: the b is optional
            break
        out.append(ch)
    return "".join(out)


class _Snapshot:
    """One measurement's columnar view at a recorded generation. All
    match_* methods return sorted unique int64 sid arrays."""

    __slots__ = ("gen", "measurement", "sids", "cols", "n", "_mesh_parts",
                 "_rx_luts")

    def __init__(self, gen, measurement: str, sids: np.ndarray, cols: dict):
        self.gen = gen
        self.measurement = measurement
        self.sids = sids
        self.cols = cols
        self.n = len(sids)
        self._mesh_parts = None  # (epoch, nparts, [row arrays])
        # (key, pattern) -> bool LUT over distinct values; the snapshot
        # is immutable per generation, so entries never go stale —
        # repeated dashboard selectors skip the automaton entirely
        self._rx_luts: dict = {}

    # -- matchers -------------------------------------------------------

    def match_eq(self, key: str, value: str) -> np.ndarray:
        kc = self.cols.get(key)
        if value == "":
            # influx: a missing tag equals the empty string; an explicit
            # '' value stored in the index matches too
            if kc is None:
                return self.sids
            mask = kc.col < 0
            vid = kc.vid_map.get("")
            if vid is not None:
                mask = mask | (kc.col == vid)
            return self.sids[mask]
        if kc is None:
            return EMPTY_SIDS
        vid = kc.vid_map.get(value)
        if vid is None:
            return EMPTY_SIDS
        return self.sids[kc.posting_rows(vid)]

    def match_neq(self, key: str, value: str) -> np.ndarray:
        kc = self.cols.get(key)
        if value == "":
            if kc is None:
                return EMPTY_SIDS
            mask = kc.col >= 0
            vid = kc.vid_map.get("")
            if vid is not None:
                mask = mask & (kc.col != vid)
            return self.sids[mask]
        if kc is None:
            return self.sids
        vid = kc.vid_map.get(value)
        if vid is None:
            return self.sids
        return self.sids[kc.col != vid]  # -1 (missing) != vid matches

    def match_regex(self, key: str, pattern: str, negate: bool = False,
                    head: "str | None" = None,
                    device=None) -> np.ndarray:
        """`head` is an optional mandatory-substring hint for callers
        that wrap the user pattern (promql anchors as ^(?:p)$, hiding
        the literal run from _literal_head); default derives it from
        `pattern` itself (influx search semantics). `device` is the
        torch device the LUT gather may route to (None: host only)."""
        rx = re.compile(pattern)
        empty_matches = bool(rx.search(""))  # missing tag is "" (influx)
        kc = self.cols.get(key)
        if kc is None:
            hit = empty_matches != negate
            return self.sids if hit else EMPTY_SIDS
        nvals = len(kc.values)
        lut = self._rx_luts.get((key, pattern))
        if lut is None:
            _STATS.incr("index", "regex_values_total", nvals)
            if head is None:
                head = _literal_head(pattern)
            if len(head) >= 2 and nvals >= _PREFILTER_MIN_VALUES:
                # any search hit must contain the leading literal run:
                # vectorized substring scan bounds the automaton to the
                # candidate values only (high-distinct keys like pod=)
                cand = np.flatnonzero(
                    np.char.find(kc.values_u(), head) >= 0)
                lut = np.zeros(nvals, np.bool_)
                if cand.size:
                    vals = kc.values
                    lut[cand] = np.fromiter(
                        (bool(rx.search(vals[i])) for i in cand.tolist()),
                        np.bool_, cand.size)
                _STATS.incr("index", "regex_prefilter_skipped_total",
                            nvals - int(cand.size))
            else:
                lut = np.fromiter((bool(rx.search(v)) for v in kc.values),
                                  np.bool_, nvals)
            if len(self._rx_luts) >= 128:
                self._rx_luts.clear()
            self._rx_luts[(key, pattern)] = lut
        else:
            _STATS.incr("index", "regex_lut_hits_total")
        # missing rows gather slot nvals: the empty-string verdict
        lut_ext = np.append(lut, np.bool_(empty_matches))
        mask = self._lut_gather(kc, lut_ext, device)
        if negate:
            mask = ~mask
        return self.sids[mask]

    def match_tag_compare(self, key_a: str, key_b: str,
                          want_equal: bool) -> np.ndarray:
        """tag = tag / tag != tag leaves: two series tags compare equal
        when both are missing or both hold the same value (the per-sid
        tags_of walk's `tags.get(a) == tags.get(b)`), vectorized over
        the two columns."""
        if key_a == key_b:
            return self.sids if want_equal else EMPTY_SIDS
        ca, cb = self.cols.get(key_a), self.cols.get(key_b)
        if ca is None and cb is None:
            eq = np.ones(self.n, np.bool_)
        elif ca is None:
            eq = cb.col < 0
        elif cb is None:
            eq = ca.col < 0
        else:
            eq = _materialized(ca) == _materialized(cb)
        return self.sids[eq if want_equal else ~eq]

    def estimate(self, op: str, key: str, value) -> int:
        """Posting-length selectivity estimate for matcher ordering.
        Regexes are unknown until the automaton runs: worst case."""
        kc = self.cols.get(key)
        if op == "=":
            if value == "":
                miss = self.n - (0 if kc is None else kc.n_present)
                if kc is not None:
                    vid = kc.vid_map.get("")
                    if vid is not None:
                        miss += int(kc.counts()[vid])
                return miss
            if kc is None:
                return 0
            vid = kc.vid_map.get(value)
            return 0 if vid is None else int(kc.counts()[vid])
        if op == "!=":
            return self.n - self.estimate("=", key, value)
        return self.n

    # -- the LUT gather (host / device) ---------------------------------

    def _lut_gather(self, kc: _KeyCol, lut_ext: np.ndarray,
                    device=None) -> np.ndarray:
        nvals = len(kc.values)
        col_idx = np.where(kc.col < 0, np.int32(nvals), kc.col)
        route = _route_gather(self.n, nvals, device)
        if route == "host":
            return lut_ext[col_idx]
        t0 = time.perf_counter()
        if route == "mesh":
            mask = self._gather_mesh(col_idx, lut_ext)
        else:
            mask = _gather_device(col_idx, lut_ext, device)
        _observe_gather(self.n, nvals, route, time.perf_counter() - t0)
        return mask

    def _gather_mesh(self, col_idx: np.ndarray,
                     lut_ext: np.ndarray) -> np.ndarray:
        """Hash-partition rows by series id over the mesh's shards and
        gather each part on its shard's device — the series-axis split
        the scan kernels use, applied to index probes. The mask scattered
        back is bit-identical to the host gather."""
        import torch

        from opengemini_tpu_torch.parallel import runtime
        from opengemini_tpu_torch.utils import devobs

        mesh = runtime.get_mesh()
        parts = self._hash_parts(mesh.size)
        mask = np.empty(self.n, np.bool_)
        shipped = 0
        outs = []
        for rows, dev in zip(parts, mesh.shard_devices):
            if not len(rows):
                outs.append(None)
                continue
            sub = np.ascontiguousarray(col_idx[rows])
            cd = torch.from_numpy(sub).to(dev)
            ld = torch.from_numpy(np.ascontiguousarray(lut_ext)).to(dev)
            shipped += int(sub.nbytes) + int(lut_ext.nbytes)
            idx = cd.to(torch.int64).clamp_(0, ld.shape[0] - 1)
            outs.append(ld[idx])
        devobs.note_transfer("h2d", "label-match", shipped, mesh=True)
        got = 0
        for rows, out in zip(parts, outs):
            if out is None:
                continue
            res = out.cpu().numpy()
            got += res.nbytes
            mask[rows] = res
        devobs.note_transfer("d2h", "label-match", got, mesh=True)
        return mask

    def _hash_parts(self, nparts: int) -> list:
        """The snapshot's rows split into `nparts` parts by a hash of
        their series ids, cached per (mesh epoch, part count)."""
        from opengemini_tpu_torch.parallel import runtime

        epoch = runtime.mesh_epoch()
        cached = self._mesh_parts
        if cached is not None and cached[0] == epoch and cached[1] == nparts:
            return cached[2]
        h = (self.sids.astype(np.uint64) * _FNV) >> np.uint64(33)
        part = (h % np.uint64(nparts)).astype(np.int64)
        rows = [np.flatnonzero(part == p) for p in range(nparts)]
        self._mesh_parts = (epoch, nparts, rows)
        return rows


def _materialized(kc: _KeyCol) -> np.ndarray:
    """The column as an object array of value strings, None where the
    series lacks the key (matches dict.get semantics)."""
    ext = np.empty(len(kc.values) + 1, object)
    ext[:len(kc.values)] = kc.values
    ext[len(kc.values)] = None
    idx = np.where(kc.col < 0, len(kc.values), kc.col)
    return ext[idx]


def _gather_device(col_idx: np.ndarray, lut_ext: np.ndarray,
                   device) -> np.ndarray:
    """The LUT gather on `device`: the vid column and the LUT go over,
    the row mask comes back. Indices are clamped to the LUT as the
    reference's clip-mode take does (every vid is in range already:
    missing rows carry slot nvals)."""
    import torch

    from opengemini_tpu_torch.utils import devobs

    cd = torch.from_numpy(np.ascontiguousarray(col_idx)).to(device)
    ld = torch.from_numpy(np.ascontiguousarray(lut_ext)).to(device)
    devobs.note_transfer("h2d", "label-match",
                         int(col_idx.nbytes) + int(lut_ext.nbytes))
    idx = cd.to(torch.int64).clamp_(0, ld.shape[0] - 1)
    out = ld[idx].cpu().numpy()
    devobs.note_transfer("d2h", "label-match", out.nbytes)
    return out


def _route_gather(n_rows: int, n_vals: int, device) -> str:
    mode = _device_mode()
    if device is None or mode == "0" or n_rows < _DEVICE_MIN_ROWS:
        return "host"
    from opengemini_tpu_torch.parallel import runtime
    from opengemini_tpu_torch.query import offload

    mesh = runtime.get_mesh()
    candidates = ["host", "device"]
    if mesh is not None:
        candidates.append("mesh")
    static = "host"
    if mode == "1":
        static = "mesh" if mesh is not None else "device"
    return offload.GLOBAL.decide(
        "label_match", (n_rows, n_vals), candidates, static,
        stage="label-match",
        bytes_hint={"device": n_rows * 4 + n_vals + 1,
                    "mesh": n_rows * 4 + n_vals + 1})


def _observe_gather(n_rows: int, n_vals: int, route: str,
                    seconds: float) -> None:
    from opengemini_tpu_torch.query import offload

    offload.GLOBAL.observe("label_match", (n_rows, n_vals), route, seconds)


def _build_snapshot(index, measurement: str, gen) -> _Snapshot:
    sid_set = index.series_ids(measurement)
    if not sid_set:
        return _Snapshot(gen, measurement, EMPTY_SIDS, {})
    sids = np.fromiter(sid_set, np.int64, len(sid_set))
    sids.sort()
    if hasattr(index, "entries_bulk"):
        try:
            entries = index.entries_bulk(sids, cache=False)
        except TypeError:  # duck-typed index without the cache knob
            entries = index.entries_bulk(sids)
    else:
        entries = [index.series_entry(int(s)) for s in sids]
    n = len(sids)
    per_key: dict[str, tuple] = {}  # key -> (rows, vals)
    for row, entry in enumerate(entries):
        if entry is None:
            continue
        for k, v in entry[1]:
            bucket = per_key.get(k)
            if bucket is None:
                bucket = per_key[k] = ([], [])
            bucket[0].append(row)
            bucket[1].append(v)
    cols: dict[str, _KeyCol] = {}
    for k, (rows, vals) in per_key.items():
        distinct = sorted(set(vals))
        vid_map = {v: i for i, v in enumerate(distinct)}
        col = np.full(n, -1, np.int32)
        col[np.asarray(rows, np.int64)] = np.fromiter(
            (vid_map[v] for v in vals), np.int32, len(vals))
        kc = cols[k] = _KeyCol(distinct, vid_map, col, len(vals))
        if len(distinct) >= _PREFILTER_MIN_VALUES:
            kc.values_u()  # pay the U-array conversion here, not on the
            # first regex probe — high-distinct keys are the ones whose
            # matchers need the vectorized substring prefilter
    return _Snapshot(gen, measurement, sids, cols)


class LabelTier:
    """Lazily-built columnar snapshots per measurement, LRU-bounded.
    Builds run OUTSIDE the tier lock (entries_bulk takes the index's own
    lock; tier lock -> index lock nesting never happens), so a racing
    insert mid-build at worst yields a snapshot already stale on arrival
    — the recorded pre-build generation forces the next probe to
    rebuild. Builds are SINGLE-FLIGHT per measurement: when a
    generation bump invalidates a hot snapshot, concurrent probes wait
    on the in-progress build instead of each re-walking the index (the
    churn thundering herd: N readers x an O(series) build per churn)."""

    MAX_SNAPSHOTS = 64

    def __init__(self, index):
        self._index = index
        self._lock = threading.Lock()
        self._snaps: dict[str, _Snapshot] = {}
        self._building: dict = {}  # measurement -> (gen, Event)

    def snapshot(self, measurement: str) -> _Snapshot:
        while True:
            gen = self._index.label_gen(measurement)
            with self._lock:
                snap = self._snaps.get(measurement)
                if snap is not None:
                    if snap.gen == gen:
                        # move-to-end: dict order is the LRU order
                        self._snaps.pop(measurement)
                        self._snaps[measurement] = snap
                        _STATS.incr("index", "tier_hits_total")
                        return snap
                    _STATS.incr("index", "tier_stale_total")
                pending = self._building.get(measurement)
                if pending is None or pending[0] != gen:
                    ev = threading.Event()
                    self._building[measurement] = (gen, ev)
                    break  # this thread owns the build for `gen`
                ev = pending[1]
            # another probe is building this generation: wait for it and
            # re-check the cache (timeout so a failed builder can't park
            # waiters forever; the loop then claims the build itself)
            ev.wait(timeout=30.0)
            _STATS.incr("index", "tier_build_waits_total")
        try:
            snap = _build_snapshot(self._index, measurement, gen)
            _STATS.incr("index", "tier_builds_total")
            with self._lock:
                self._snaps.pop(measurement, None)
                self._snaps[measurement] = snap
                while len(self._snaps) > self.MAX_SNAPSHOTS:
                    self._snaps.pop(next(iter(self._snaps)))
        finally:
            with self._lock:
                cur = self._building.get(measurement)
                if cur is not None and cur[1] is ev:
                    del self._building[measurement]
            ev.set()
        return snap


def match_tier(snap: _Snapshot, op: str, key: str, value: str,
               device=None):
    """Operator dispatch over one snapshot; returns a sorted int64 sid
    array, or None for an operator the tier does not handle. `device`
    is where a regex LUT gather may route (None: host only)."""
    if op == "=":
        return snap.match_eq(key, value)
    if op in ("!=", "<>"):
        return snap.match_neq(key, value)
    if op == "=~":
        return snap.match_regex(key, value, device=device)
    if op == "!~":
        return snap.match_regex(key, value, negate=True, device=device)
    return None
