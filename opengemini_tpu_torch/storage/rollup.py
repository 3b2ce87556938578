"""Incremental materialized rollups.

The port of ``opengemini_tpu/storage/rollup.py``, whole, with plain
``threading`` locks. The write path marks (rollup, window) pairs dirty;
a governed background service (services/rollup.py) folds the dirty and
newly closed windows into rollup rows under the system retention policy
``_rollup``; the executor splices eligible ``GROUP BY time(T)`` reads
(query/rollupplan.py): rollup rows serve every clean window below the
durable watermark, a raw-tail scan (the grid and its kernels on the
engine's device) covers the rest.

Storage model: one rollup row per (source series, window), written with
the SOURCE tags at timestamp = window start into measurement
``<spec name>`` of RP ``_rollup``:

    c_<field>   INT     count of valid values
    s_<field>   INT/FLOAT  sum (int64-exact for INT sources)
    mn_<field>  INT/FLOAT  min        } omitted for string sources
    mx_<field>  INT/FLOAT  max        } (count only)
    sk_<field>  STRING  base64 RollupSketch (query/sketch.py) when the
                        spec keeps percentile sketches

All five merge, so a coarser query grid (T = k * interval) and a GROUP
BY over tag subsets fold cells without touching raw data; ``mean`` is
s/c at splice time. The fold is host code (numpy), as in the reference.

Watermark/dirty contract (the splice's correctness):
  * windows whose end <= watermark AND that are not dirty are served
    from rollup rows;
  * every write below the watermark re-dirties exactly the windows it
    touches BEFORE its rows apply, and that mark is fsynced before the
    write proceeds (failpoint ``rollup-mark-dirty``), so an acknowledged
    late write is never masked by a stale cell, even across a crash;
  * advancing the watermark folds the whole span [old, new) in one scan,
    and the watermark is saved (fsync, ``rollup-before-state-save``)
    only after the fold's rows are written (``rollup-fold-before-write``,
    ``rollup-fold-after-write``): a re-fold is idempotent (same series
    and timestamp overwrite), so a crash between them repeats work.

The state lives in ``<root>/rollup/<db>/<name>.json`` (watermark and
dirty set), in the reference's layout, so either package reopens it.
``OGT_ROLLUP=0`` disables the subsystem; with no spec declared the
engine never builds a manager and every path stays as it was.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import threading
import time as _time

import numpy as np

from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.record import Column, FieldType, Record
from opengemini_tpu_torch.utils.failpoint import inject as _fp
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS
from opengemini_tpu_torch.utils.stats import observe_ns as _observe_ns

NS = 1_000_000_000
ROLLUP_RP = "_rollup"

# rollup row field-name prefixes
C_, S_, MN_, MX_, SK_ = "c_", "s_", "mn_", "mx_", "sk_"

# aggregates a rollup row can answer exactly (mean = s/c); percentile
# additionally needs the spec's sketches
DERIVABLE = {"count", "sum", "min", "max", "mean"}

_MAX_DIRTY = 4096  # beyond this the state collapses into the watermark
_MAX_ADVANCE_WINDOWS = int(
    os.environ.get("OGT_ROLLUP_MAX_WINDOWS", "") or 4096)
_SKETCH_EXACT = int(os.environ.get("OGT_ROLLUP_SKETCH_EXACT", "") or 512)
_SKETCH_COMPRESSION = 100  # RollupSketch's default
_B64 = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                     b"0123456789+/", np.uint8)


def _b64_rows(cells: np.ndarray) -> np.ndarray:
    """base64 of each row of a (rows, width) uint8 array, as str objects:
    base64.b64encode(row).decode() for every row, in one pass."""
    m, width = cells.shape
    pad = -width % 3
    if pad:
        cells = np.concatenate([cells, np.zeros((m, pad), np.uint8)], 1)
    t = cells.reshape(m, -1, 3)
    b0, b1, b2 = t[..., 0], t[..., 1], t[..., 2]
    idx = np.empty((m, t.shape[1], 4), np.uint8)
    idx[..., 0] = b0 >> 2
    idx[..., 1] = ((b0 & 3) << 4) | (b1 >> 4)
    idx[..., 2] = ((b1 & 15) << 2) | (b2 >> 6)
    idx[..., 3] = b2 & 63
    text = _B64[idx.reshape(m, -1)]
    if pad:
        text[:, -pad:] = ord("=")
    width = text.shape[1]
    flat = text.tobytes().decode("ascii")
    out = np.empty(m, dtype=object)
    out[:] = [flat[i:i + width] for i in range(0, m * width, width)]
    return out


def enabled_by_env() -> bool:
    return os.environ.get("OGT_ROLLUP", "1") != "0"


class RollupSpec:
    """A declared rollup: maintain `every_ns` windows of `measurement`
    (source rp = `rp` or the database default) incrementally.  `fields`
    None = every field the source has at fold time; `sketch` keeps
    percentile sketches; `delay_ns` is the hold-back before a window is
    considered closed (late-arrival grace, default one interval)."""

    def __init__(self, name: str, measurement: str, every_ns: int,
                 rp: str | None = None, fields: list[str] | None = None,
                 sketch: bool = True, delay_ns: int | None = None):
        if every_ns <= 0:
            raise ValueError("rollup interval must be positive")
        self.name = name
        self.measurement = measurement
        self.every_ns = int(every_ns)
        self.rp = rp or None
        self.fields = sorted(fields) if fields else None
        self.sketch = bool(sketch)
        self.delay_ns = int(delay_ns) if delay_ns is not None \
            else self.every_ns

    @property
    def target(self) -> str:
        return self.name  # measurement name under ROLLUP_RP

    def to_json(self) -> dict:
        return {
            "name": self.name, "measurement": self.measurement,
            "every_ns": self.every_ns, "rp": self.rp,
            "fields": self.fields, "sketch": self.sketch,
            "delay_ns": self.delay_ns,
        }

    @classmethod
    def from_json(cls, j: dict) -> "RollupSpec":
        return cls(j["name"], j["measurement"], j["every_ns"],
                   j.get("rp"), j.get("fields"), j.get("sketch", True),
                   j.get("delay_ns"))


class _State:
    """Durable per-(db, rollup) maintenance state.  watermark_ns None =
    never folded (the first maintenance bootstraps from the earliest
    source row, giving declared-on-existing-data specs a backfill)."""

    def __init__(self, path: str):
        self.path = path
        # serializes maintenance (and full invalidation) per spec: a
        # service tick racing a ctrl-flush must not interleave claim /
        # restore bookkeeping.  Ordering: m_lock OUTSIDE the manager
        # lock; write-path marks never take it.
        self.m_lock = threading.Lock()
        # save() runs OUTSIDE the manager-wide lock (an fsync under it
        # would stall every concurrent splice/note across all specs):
        # mutators bump `ver` under the manager lock and snapshot; the
        # io_lock-serialized writer skips snapshots an already-persisted
        # newer version supersedes (a newer snapshot always contains
        # every older mutation)
        self.io_lock = threading.Lock()
        self.ver = 0
        self._saved_ver = -1
        self.watermark_ns: int | None = None
        self.dirty: set[int] = set()  # window starts needing a re-fold
        # floors (earliest touched window start) of writes currently IN
        # FLIGHT between the pre-apply note hook and the engine's
        # write_done: maintenance neither advances the watermark past a
        # floor nor claims dirty windows at/above it — a fold scan must
        # never finalize a window whose rows are mid-apply
        self.inflight: list[int] = []
        # bumped by every note hook: the bootstrap sweep (which runs
        # before any watermark exists, when _mark is still a no-op)
        # aborts if a write raced it — see _maintain_spec_locked
        self.note_epoch = 0
        # transient (never persisted as such): windows an in-flight
        # maintenance claimed from `dirty` — save() keeps persisting them
        # so a crash mid-fold re-folds; a write racing the fold re-marks
        # into `dirty` and the fresh mark survives the claim clear
        self.claimed: set[int] = set()
        # the prospective watermark of an in-flight maintenance: writes
        # below it must dirty-mark even though the watermark itself has
        # not moved yet (the fold scan may already have passed them)
        self.advancing_hi: int | None = None
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                j = json.load(f)
        except (OSError, ValueError):
            return
        self.watermark_ns = j.get("watermark_ns")
        self.dirty = set(int(w) for w in j.get("dirty", []))

    def snapshot(self) -> tuple:
        """(ver, watermark, dirty∪claimed) — take under the manager
        lock after bumping `ver` for the mutation being persisted."""
        self.ver += 1
        return (self.ver, self.watermark_ns,
                sorted(self.dirty | self.claimed))

    def save(self, snap: tuple) -> None:
        ver, wm, dirty = snap
        with self.io_lock:
            if ver <= self._saved_ver:
                return  # a newer snapshot (superset) is already durable
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"watermark_ns": wm, "dirty": dirty}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._saved_ver = ver


def _runs(windows: list[int], every: int) -> list[list[int]]:
    """Coalesce sorted window starts into contiguous [lo, hi) runs."""
    out: list[list[int]] = []
    for w in windows:
        if out and out[-1][1] == w:
            out[-1][1] = w + every
        else:
            out.append([w, w + every])
    return out


class _FoldRows:
    """The rollup rows of one fold run, built column by column: a row per
    (series, window), the columns of the reference's layout (c_, s_,
    mn_, mx_, sk_ per source field), written as one columnar batch."""

    def __init__(self):
        self.tags: list[tuple] = []      # per series
        self.windows: list[list] = []    # per series: its row windows
        self.row_series: list = []       # per row block: its series
        self.cols: dict[str, list] = {}  # name -> [ftype, [(rows, vals)]]
        self.n_rows = 0

    def _col(self, name: str, ftype, rows, vals) -> None:
        ent = self.cols.setdefault(name, [ftype, []])
        ent[1].append((rows, vals))

    def add_series(self, tags, per_f: dict, schema: dict) -> None:
        merged = {f: _merge_parts(parts) for f, parts in per_f.items()}
        wins = np.unique(np.concatenate([m[0] for m in merged.values()]))
        base = self.n_rows
        self.tags.append(tags)
        self.windows.append(wins.tolist())
        self.row_series.append(np.full(len(wins), len(self.tags) - 1,
                                       np.int64))
        for fname, (fw, cnt, tot, mn, mx) in merged.items():
            rows = base + np.searchsorted(wins, fw)
            self._col(C_ + fname, FieldType.INT, rows, cnt)
            if tot is None:
                continue  # string column: count only
            vtype = (FieldType.INT if schema.get(fname) == FieldType.INT
                     else FieldType.FLOAT)
            dt = np.int64 if vtype == FieldType.INT else np.float64
            self._col(S_ + fname, vtype, rows, tot.astype(dt))
            self._col(MN_ + fname, vtype, rows, mn.astype(dt))
            self._col(MX_ + fname, vtype, rows, mx.astype(dt))
        self.n_rows += len(wins)

    def add_sketches(self, fname: str, parts: list, lo: int, hi: int,
                     every: int) -> None:
        """The sk_ column of one field, for every series at once. `parts`
        are (series index, windows, counts, values in window then time
        order) per series and shard, in scan order; a window's sketch
        takes its values part by part, as RollupSketch.add_values would,
        so an exact cell serializes to the same bytes. Call it after
        every add_series and before zero_fill."""
        from opengemini_tpu_torch.query.sketch import RollupSketch

        n_win = (hi - lo + every - 1) // every
        row_keys = np.concatenate([
            ti * n_win + (np.asarray(w, np.int64) - lo) // every
            for ti, w in enumerate(self.windows)])
        seg_sid = np.concatenate([np.full(len(p[1]), p[0], np.int64)
                                  for p in parts])
        seg_win = np.concatenate([p[1] for p in parts])
        seg_len = np.concatenate([p[2] for p in parts])
        vals = np.concatenate([np.asarray(p[3], np.float64) for p in parts])
        seg_off = np.cumsum(seg_len) - seg_len
        order = np.lexsort((np.arange(len(seg_win)), seg_win, seg_sid))
        seg_off, seg_len = seg_off[order], seg_len[order]
        key = seg_sid[order] * n_win + (seg_win[order] - lo) // every
        # values regrouped into (series, window) cells, parts in scan order
        dst = np.cumsum(seg_len) - seg_len
        vals = vals[np.repeat(seg_off - dst, seg_len)
                    + np.arange(len(vals))]
        first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        n = np.add.reduceat(seg_len, first)
        start = dst[first]
        rows = np.searchsorted(row_keys, key[first])
        out = np.empty(len(first), dtype=object)
        exact = n <= _SKETCH_EXACT
        head = np.frombuffer(b"\x00" + np.asarray(
            [_SKETCH_EXACT, _SKETCH_COMPRESSION], np.int64).tobytes(),
            np.uint8)
        for k in np.unique(n[exact]).tolist():
            sel = np.flatnonzero(exact & (n == k))
            cells = np.empty((len(sel), len(head) + 8 * k), np.uint8)
            cells[:, :len(head)] = head
            cells[:, len(head):] = vals[
                start[sel, None] + np.arange(k)].view(np.uint8)
            out[sel] = _b64_rows(cells)
        last = np.append(first[1:], len(key))
        for g in np.flatnonzero(~exact).tolist():
            # past the exact limit: a t-digest, fed part by part
            sk = RollupSketch(_SKETCH_EXACT, _SKETCH_COMPRESSION)
            for j in range(first[g], last[g]):
                sk.add_values(vals[dst[j]:dst[j] + seg_len[j]])
            out[g] = base64.b64encode(sk.serialize()).decode("ascii")
        self._col(SK_ + fname, FieldType.STRING, rows, out)

    def zero_fill(self, existing) -> int:
        """count=0 for every c_ field of an existing rollup row the run no
        longer produces (a new row when its whole (series, window) went);
        returns the rows added."""
        row_of = {}
        off = 0
        for tags, wins in zip(self.tags, self.windows):
            for j, w in enumerate(wins):
                row_of[(tags, w)] = off + j
            off += len(wins)
        present: dict[str, set] = {}
        for name, (_ft, blocks) in self.cols.items():
            if name.startswith(C_):
                present[name] = {int(r) for rows, _v in blocks
                                 for r in rows.tolist()}
        added = 0
        tag_idx = {t: i for i, t in enumerate(self.tags)}
        for tags, w, fields in existing:
            zeros = [f for f in fields if f.startswith(C_)]
            if not zeros:
                continue
            row = row_of.get((tags, w))
            if row is None:
                ti = tag_idx.get(tags)
                if ti is None:
                    ti = tag_idx[tags] = len(self.tags)
                    self.tags.append(tags)
                    self.windows.append([])
                row = self.n_rows
                self.n_rows += 1
                self.row_series.append(np.array([ti], np.int64))
                self.windows[ti].append(w)
                row_of[(tags, w)] = row
                added += 1
            for f in zeros:
                if row not in present.get(f, ()):
                    self._col(f, FieldType.INT, np.array([row], np.int64),
                              np.array([0], np.int64))
                    present.setdefault(f, set()).add(row)
        return added

    def batch(self, measurement: str):
        from opengemini_tpu_torch.ingest.line_protocol import series_key
        from opengemini_tpu_torch.ingest.native_lp import ColumnarBatch
        from opengemini_tpu_torch.record import _zeroed

        ref = np.concatenate(self.row_series)
        ts = np.empty(self.n_rows, np.int64)
        # the row blocks in order: a series' block holds its windows in
        # order, a zero-fill row (a block of one, after every series
        # block) the next window appended to its series
        k = 0
        consumed = [0] * len(self.tags)
        for blk in self.row_series:
            ti = int(blk[0])
            n = len(blk)
            ts[k:k + n] = self.windows[ti][consumed[ti]:consumed[ti] + n]
            consumed[ti] += n
            k += n
        cols = []
        for name, (ftype, blocks) in self.cols.items():
            values = _zeroed(ftype, self.n_rows)
            valid = np.zeros(self.n_rows, np.bool_)
            for rows, vals in blocks:
                values[rows] = vals
                valid[rows] = True
            cols.append((0, name, ftype, values, valid))
        return ColumnarBatch(
            ts, ref, [series_key(measurement, t) for t in self.tags],
            np.zeros(len(self.tags), np.int64), [measurement], cols)


def _merge_parts(parts: list) -> tuple:
    """One field's per-shard window cells merged by window, in shard order
    (a window two shards share adds their cells)."""
    if len(parts) == 1:
        return parts[0]
    wins = np.concatenate([p[0] for p in parts])
    order = np.argsort(wins, kind="stable")
    wins = wins[order]
    starts = np.flatnonzero(np.r_[True, wins[1:] != wins[:-1]])
    out = [wins[starts],
           np.add.reduceat(np.concatenate([p[1] for p in parts])[order],
                           starts)]
    if parts[0][2] is None:
        return (*out, None, None, None)
    for k, ufunc in ((2, np.add), (3, np.minimum), (4, np.maximum)):
        out.append(ufunc.reduceat(
            np.concatenate([p[k] for p in parts])[order], starts))
    return tuple(out)


class RollupManager:
    """Owns dirty/watermark state for every declared rollup of one
    engine, the write-path dirty marking, the fold (maintenance), and
    the splice-side cell reader."""

    def __init__(self, engine):
        self.engine = engine
        # state fsyncs run off this lock: a late write's mark must not
        # stall every splice and note behind a disk
        self._lock = threading.RLock()
        self._states: dict[tuple[str, str], _State] = {}
        # read_enabled=False forces raw scans (bench A/B, fuzz oracle)
        # without touching maintenance
        self.read_enabled = True
        self._stats_provider = self._gauges
        STATS.register_provider("rollup", self._stats_provider)

    def close(self) -> None:
        STATS.unregister_provider("rollup", self._stats_provider)

    # -- spec/state access ----------------------------------------------------

    def _specs(self, db: str) -> dict:
        d = self.engine.databases.get(db)
        return d.rollups if d is not None else {}

    def dbs_with_specs(self) -> list[str]:
        return sorted(db for db, d in self.engine.databases.items()
                      if d.rollups)

    def has_specs(self) -> bool:
        return any(d.rollups for d in self.engine.databases.values())

    def spec_for(self, db: str, rp: str | None, mst: str,
                 every_ns: int, aligned: int):
        """The declared spec able to serve a GROUP BY time(`every_ns`)
        query over (db, rp, mst) whose window grid starts at `aligned`,
        or None.  Eligible when the query grid is a multiple of the
        rollup interval and lands on the rollup's (epoch-aligned)
        boundaries; the finest matching interval wins."""
        d = self.engine.databases.get(db)
        if d is None or not d.rollups:
            return None
        src_rp = rp or d.default_rp
        best = None
        for spec in d.rollups.values():
            if spec.measurement != mst:
                continue
            if (spec.rp or d.default_rp) != src_rp:
                continue
            if every_ns % spec.every_ns or aligned % spec.every_ns:
                continue
            if best is None or spec.every_ns < best.every_ns:
                best = spec
        return best

    def _state(self, db: str, spec: RollupSpec) -> _State:
        key = (db, spec.name)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _State(self._state_path(db, spec.name))
            return st

    def _state_path(self, db: str, name: str) -> str:
        return os.path.join(self.engine.root, "rollup", db, f"{name}.json")

    def drop_state(self, db: str, name: str) -> None:
        with self._lock:
            self._states.pop((db, name), None)
        try:
            os.remove(self._state_path(db, name))
        except OSError:
            pass

    def drop_db_state(self, db: str) -> None:
        """DROP DATABASE cleanup: a recreated database must not inherit
        a previous incarnation's watermark (clean-looking windows with
        no rollup rows would splice as empty over real new data)."""
        import shutil

        with self._lock:
            for key in [k for k in self._states if k[0] == db]:
                self._states.pop(key)
        shutil.rmtree(os.path.join(self.engine.root, "rollup", db),
                      ignore_errors=True)

    def serve_view(self, db: str, spec: RollupSpec) -> tuple[int, set[int]]:
        """(watermark, dirty set) snapshot the splice plans against.
        watermark is -inf-ish (0-serve) when the rollup never folded.
        Claimed (mid-refold) windows count as dirty: their cells are
        being rewritten right now."""
        st = self._state(db, spec)
        with self._lock:
            wm = st.watermark_ns
            return ((wm if wm is not None else -(2**62)),
                    st.dirty | st.claimed)

    # -- write-path dirty marking --------------------------------------------

    def note_write_points(self, db: str, rp: str | None, points):
        """Pre-apply hook: register the batch's in-flight floor and mark
        late windows dirty, DURABLY, before the write proceeds (see
        module docstring).  Returns a token for the engine's write_done
        (None when no spec matched — the common cheap case)."""
        specs = self._specs(db)
        if not specs:
            return None
        d = self.engine.databases[db]
        rp_name = rp or d.default_rp
        if rp_name == ROLLUP_RP:
            return None  # fold output must never re-dirty its own spec
        by_mst: dict[str, list[int]] = {}
        for p in points:
            by_mst.setdefault(p[0], []).append(p[2])
        token = []
        try:
            for spec in specs.values():
                ts = by_mst.get(spec.measurement)
                if ts is not None and (spec.rp or d.default_rp) == rp_name:
                    self._note_one(db, spec, np.asarray(ts, np.int64),
                                   token)
        except BaseException:
            # a failed mark aborts the write: release the floors already
            # registered or the watermark could never advance again
            self.write_done(token)
            raise
        return token or None

    def note_write_columnar(self, db: str, rp: str | None, batch):
        specs = self._specs(db)
        if not specs:
            return None
        d = self.engine.databases[db]
        rp_name = rp or d.default_rp
        if rp_name == ROLLUP_RP:
            return None
        row_mst = None
        token = []
        try:
            for spec in specs.values():
                if (spec.rp or d.default_rp) != rp_name:
                    continue
                try:
                    mid = batch.measurements.index(spec.measurement)
                except ValueError:
                    continue
                if row_mst is None:
                    row_mst = batch.row_mst()
                ts = batch.ts[row_mst == mid]
                if len(ts):
                    self._note_one(db, spec, ts, token)
        except BaseException:
            self.write_done(token)  # see note_write_points
            raise
        return token or None

    def _note_one(self, db: str, spec: RollupSpec, ts: np.ndarray,
                  token: list) -> None:
        st = self._state(db, spec)
        floor = int(winmod.window_start(int(ts.min()), spec.every_ns))
        # floor FIRST (a fold claiming between mark and floor could
        # still finalize the window pre-apply), then the durable mark
        with self._lock:
            st.inflight.append(floor)
            st.note_epoch += 1
        token.append((st, floor))
        self._mark(db, spec, ts)

    def write_done(self, token) -> None:
        """Engine post-apply callback: the batch's rows are readable,
        maintenance may fold its windows again."""
        with self._lock:
            for st, floor in token:
                try:
                    st.inflight.remove(floor)
                except ValueError:
                    pass

    def note_delete(self, db: str, mst: str,
                    tmin: int | None = None, tmax: int | None = None) -> None:
        """DELETE/DROP SERIES invalidation: re-dirty every folded window
        the delete overlaps so the next maintenance re-folds (and
        zero-fills vanished series)."""
        specs = self._specs(db)
        for spec in specs.values():
            if spec.measurement != mst:
                continue
            st = self._state(db, spec)
            with self._lock:
                wm = st.watermark_ns
            if wm is None:
                continue
            # the data sweep takes the engine lock: keep it OUTSIDE the
            # manager lock (the engine calls into the manager while
            # holding its own lock — lock order engine -> manager)
            lo = (int(winmod.window_start(tmin, spec.every_ns))
                  if tmin is not None
                  else self._earliest_window(db, spec, wm))
            if lo is None:
                continue
            with self._lock:
                wm = st.watermark_ns
                if wm is None:
                    continue
                hi = min(wm, tmax if tmax is not None else wm)
                n = self._redirty_span_locked(st, spec, lo, hi)
                if not n:
                    continue
                snap = st.snapshot()
            _fp("rollup-mark-dirty")
            st.save(snap)
            STATS.incr("rollup", "late_redirty", n)

    def _earliest_window(self, db, spec, wm) -> int | None:
        """Earliest window any SOURCE row — or any persisted ROLLUP
        row — lives in.  The target side matters when the source data
        below some point was deleted (retention trims): the stale rollup
        cells still cover those windows and must be re-foldable (and a
        bootstrap after a full invalidation must start below them, or
        they would serve deleted rows forever)."""
        d = self.engine.databases.get(db)
        dmin = None

        def sweep(rp_name, mst):
            nonlocal dmin
            for sh in self.engine.shards_for_range(db, rp_name,
                                                   -(2**62), wm):
                for _r, c in sh.file_chunks(mst):
                    dmin = c.tmin if dmin is None else min(dmin, c.tmin)
                if sh.mem_sids_for(mst):
                    m_lo, _m_hi = sh.mem_time_range()
                    if m_lo is not None:
                        dmin = m_lo if dmin is None else min(dmin, m_lo)

        sweep(spec.rp or d.default_rp, spec.measurement)
        if ROLLUP_RP in d.rps:
            sweep(ROLLUP_RP, spec.target)
        if dmin is None:
            return None
        return int(winmod.window_start(dmin, spec.every_ns))

    def _mark(self, db: str, spec: RollupSpec, ts: np.ndarray) -> None:
        st = self._state(db, spec)
        with self._lock:
            wm = st.watermark_ns
            if wm is None:
                return  # nothing folded yet: everything is raw-served
            # a write dirty-marks every window below the watermark — OR
            # below a fold-in-flight's prospective watermark
            # (advancing_hi): the fold scan may already have passed this
            # write's rows, and the mark (new, so outside the fold's
            # claimed set) is what forces the re-fold.  The in-flight
            # floor covers the complementary interleaving (fold starting
            # AFTER this hook but before the rows apply).
            cutoff = max(
                wm,
                st.advancing_hi if st.advancing_hi is not None else wm,
            )
            late = ts[ts < cutoff]
            if not len(late):
                return
            wins = np.unique(winmod.window_start(late, spec.every_ns))
            # claimed windows do NOT suppress the mark: the in-flight
            # fold may already have scanned past these rows, so they
            # must re-enter `dirty` and survive the claim clear
            new = set(int(w) for w in wins) - st.dirty
            if not new:
                return  # already durably dirty
            st.dirty |= new
            self._collapse_dirty_locked(st, spec)
            snap = st.snapshot()
        # fsync BEFORE the rows apply (but OUTSIDE the manager lock): an
        # acked late write implies a durable dirty mark (kill here loses
        # the mark but also the write — see the crash tests)
        _fp("rollup-mark-dirty")
        st.save(snap)
        STATS.incr("rollup", "late_redirty", len(new))

    def _redirty_span_locked(self, st: _State, spec: RollupSpec,
                             lo: int, hi: int) -> int:
        """Dirty-mark every window of [lo, hi) — or, for a span too wide
        to enumerate, pull the watermark back to `lo` so the whole tail
        re-folds wholesale (a year-wide DELETE over a 1s rollup must not
        build a 31M-element set under the manager lock)."""
        every = spec.every_ns
        if hi <= lo:
            return 0
        span = -(-(hi - lo) // every)  # ceil: a partial window counts
        if span > _MAX_DIRTY:
            st.watermark_ns = min(st.watermark_ns, lo)
            st.dirty = {w for w in st.dirty if w < lo}
            return span
        new = set(range(lo, hi, every)) - st.dirty
        st.dirty |= new
        self._collapse_dirty_locked(st, spec)
        return len(new)

    def _collapse_dirty_locked(self, st: _State, spec: RollupSpec) -> None:
        """A pathological dirty set collapses into the watermark: pulling
        the watermark back to the oldest dirty window turns the whole
        tail into one wholesale advance re-fold."""
        if len(st.dirty) <= _MAX_DIRTY:
            return
        st.watermark_ns = min(st.dirty)
        st.dirty.clear()

    # -- maintenance (fold) ---------------------------------------------------

    def maintain(self, now_ns: int | None = None,
                 max_windows: int | None = None) -> int:
        """Fold pending windows of every spec; returns windows folded."""
        return sum(
            self.maintain_db(db, now_ns, max_windows)
            for db in self.dbs_with_specs()
        )

    def maintain_db(self, db: str, now_ns: int | None = None,
                    max_windows: int | None = None) -> int:
        d = self.engine.databases.get(db)
        if d is None or not d.rollups:
            return 0
        if now_ns is None:
            now_ns = _time.time_ns()
        folded = 0
        for spec in list(d.rollups.values()):
            if (self.engine.is_measurement_dropped(db, spec.measurement)
                    or self.engine.is_measurement_dropped(db, spec.target)):
                # a mark-dropped source awaits its deferred purge: a fold
                # now would re-materialize the dropped rows into cells
                # that outlive the purge (the watermark was already reset
                # by mark_measurement_delete; folding resumes after the
                # purge, from whatever data the recreated name has)
                continue
            folded += self._maintain_spec(db, spec, now_ns,
                                          max_windows or _MAX_ADVANCE_WINDOWS)
        return folded

    def _maintain_spec(self, db: str, spec: RollupSpec, now_ns: int,
                       max_windows: int) -> int:
        st = self._state(db, spec)
        with st.m_lock:
            return self._maintain_spec_locked(db, spec, st, now_ns,
                                              max_windows)

    def _maintain_spec_locked(self, db: str, spec: RollupSpec, st: _State,
                              now_ns: int, max_windows: int) -> int:
        every = spec.every_ns
        horizon = int(winmod.window_start(now_ns - spec.delay_ns, every))
        start = epoch0 = None
        if st.watermark_ns is None:
            with self._lock:
                epoch0 = st.note_epoch
            start = self._earliest_window(db, spec, horizon)
        boot_snap = None
        with self._lock:
            floor = min(st.inflight) if st.inflight else None
            if st.watermark_ns is None:
                if st.note_epoch != epoch0:
                    # a write raced the bootstrap sweep (and may have
                    # fully applied after the sweep passed its rows —
                    # with no watermark yet, _mark recorded nothing):
                    # retry the bootstrap next tick
                    return 0
                wm0 = (start if start is not None and start < horizon
                       else horizon)
                if floor is not None:
                    # an in-flight write's rows may be older than any
                    # visible row: the bootstrap watermark must not
                    # open past its floor
                    wm0 = min(wm0, floor)
                st.watermark_ns = wm0
                if wm0 >= horizon:
                    boot_snap = st.snapshot()
        if boot_snap is not None:
            # no closed data yet: persist the opened watermark (fsync
            # OUTSIDE the manager lock like every other save)
            _fp("rollup-before-state-save")
            st.save(boot_snap)
            return 0
        with self._lock:
            # re-read both under THIS lock: a floor registered (or a
            # note_delete pull-back landing) between the two critical
            # sections must be honored
            wm = st.watermark_ns
            floor = min(st.inflight) if st.inflight else None
            advance_hi = max(wm, min(horizon, wm + max_windows * every))
            if floor is not None:
                # never advance past (or claim at/above) an in-flight
                # write's floor: its rows may not be readable yet, so a
                # fold scan could finalize the window without them
                advance_hi = max(wm, min(advance_hi, floor))
            claim_cutoff = (advance_hi if floor is None
                            else min(advance_hi, floor))
            # claim the dirty windows this round folds; publish the
            # prospective watermark so concurrent writes below it
            # dirty-mark (see _mark) instead of slipping past the scan
            claimed = {w for w in st.dirty if w < claim_cutoff}
            st.dirty -= claimed
            st.claimed |= claimed
            st.advancing_hi = advance_hi
        try:
            pending = sorted(claimed | set(range(wm, advance_hi, every)))
            folded = 0
            for lo, hi in _runs(pending, every):
                folded += self._fold_run(db, spec, lo, hi)
        except BaseException:
            with self._lock:
                st.dirty |= st.claimed
                st.claimed.clear()
                st.advancing_hi = None
            raise
        with self._lock:
            if st.watermark_ns == wm:
                st.watermark_ns = max(wm, advance_hi)
            # else: a concurrent invalidation (note_delete pull-back /
            # DROP MEASUREMENT reset) moved the watermark while we were
            # folding — its (older or None) value wins so the span it
            # invalidated re-folds
            st.claimed.clear()
            st.advancing_hi = None
            snap = st.snapshot()
        _fp("rollup-before-state-save")
        st.save(snap)
        STATS.incr("rollup", "windows_folded", folded)
        return folded

    def _fold_run(self, db: str, spec: RollupSpec, lo: int, hi: int) -> int:
        """Fold every (series, window) of [lo, hi) into rollup rows —
        ONE raw scan for the whole run, so advancing over a long idle
        span costs one (empty) sweep, not one per window."""
        _t0 = _time.perf_counter_ns()
        try:
            return self._fold_run_inner(db, spec, lo, hi)
        finally:
            # fold-latency distribution (ogt_rollup_fold_seconds): a
            # maintenance tick stalling dashboards shows here first
            _observe_ns("rollup_fold_seconds",
                        _time.perf_counter_ns() - _t0)

    def _fold_run_inner(self, db: str, spec: RollupSpec, lo: int,
                        hi: int) -> int:
        """The reference's fold, vectorized per series and field: each
        series' windows reduce with one ufunc reduceat each (count, sum,
        min, max) instead of a Python loop per window, and the rollup rows
        go to the engine as one columnar batch (one series key per
        series) instead of a point per row. The cells are the
        reference's; a sum adds its window's values in time order, where
        the reference's per-window ``sum()`` adds pairwise, so a float
        sum may differ from it in its last bits."""
        from opengemini_tpu_torch.query import condition as cond

        d = self.engine.databases.get(db)
        src_rp = spec.rp or d.default_rp
        every = spec.every_ns
        schema: dict[str, FieldType] = {}
        # (tags items tuple) -> {field: [(windows, cnt, sum, mn, mx)] in
        # shard order}; sum/mn/mx None for a string field
        acc: dict[tuple, dict[str, list]] = {}
        series_ix: dict[tuple, int] = {}  # tags -> its place in acc
        # field -> [(series index, windows, counts, values)] in scan order
        sk_parts: dict[str, list] = {}
        rows_in = 0
        for sh in self.engine.shards_for_range(db, src_rp, lo, hi):
            schema.update(sh.schema(spec.measurement))
            sids = cond.eval_tag_expr(None, sh.index, spec.measurement)
            for sid in sorted(sids):
                rec = sh.read_series(spec.measurement, sid, lo, hi,
                                     fields=spec.fields)
                if not len(rec):
                    continue
                rows_in += len(rec)
                tags = tuple(sorted(sh.index.tags_of(sid).items()))
                ti = len(acc) if tags not in acc else None
                per_f = acc.setdefault(tags, {})
                if ti is not None:
                    series_ix[tags] = ti
                widx, _ = winmod.window_index(rec.times, lo, every)
                for fname, col in rec.columns.items():
                    valid = col.valid
                    if not valid.any():
                        continue
                    order = np.argsort(widx[valid], kind="stable")
                    wv = widx[valid][order]
                    starts = np.flatnonzero(np.concatenate(
                        ([True], wv[1:] != wv[:-1])))
                    ends = np.append(starts[1:], len(wv))
                    wins = lo + wv[starts].astype(np.int64) * every
                    cnt = (ends - starts).astype(np.int64)
                    if col.ftype == FieldType.STRING:
                        per_f.setdefault(fname, []).append(
                            (wins, cnt, None, None, None))
                        continue
                    vals = col.values[valid].astype(
                        np.int64 if col.ftype == FieldType.INT
                        else np.float64)[order]
                    per_f.setdefault(fname, []).append(
                        (wins, cnt, np.add.reduceat(vals, starts),
                         np.minimum.reduceat(vals, starts),
                         np.maximum.reduceat(vals, starts)))
                    if spec.sketch and col.ftype in (FieldType.FLOAT,
                                                    FieldType.INT):
                        sk_parts.setdefault(fname, []).append(
                            (series_ix[tags], wins, cnt, vals))
        out = _FoldRows()
        for tags, per_f in acc.items():
            out.add_series(tags, per_f, schema)
        for fname, parts in sk_parts.items():
            out.add_sketches(fname, parts, lo, hi, every)
        n_points = out.n_rows
        # zero-out what a re-folded span no longer contains (late
        # deletes): a count=0 overwrite hides the stale cell from the
        # splice (field-level LWW cannot remove old row fields).  Both
        # granularities matter — a whole (series, window) that vanished,
        # AND a field that vanished from a still-live pair.
        existing = self.read_rows(db, spec, [(lo, hi)], fields=None)
        if existing:
            n_points += out.zero_fill(existing)
        n_windows = len({w for wins in out.windows for w in wins})
        if n_points:
            _fp("rollup-fold-before-write")
            self.engine.ensure_rollup_rp(db)
            self.engine.load_columnar_batches(
                db, [out.batch(spec.target)], rp=ROLLUP_RP)
            _fp("rollup-fold-after-write")
        STATS.incr("rollup", "rows_folded_in", rows_in)
        STATS.incr("rollup", "rows_folded_out", n_points)
        return n_windows

    # -- splice-side reader ---------------------------------------------------

    def read_recs(self, db: str, spec: RollupSpec, ranges,
                  fields: list[str] | None, tag_expr=None):
        """Rollup rows overlapping the [lo, hi) ranges, one merged
        columnar record per (series, shard): [(tags items tuple,
        Record)].  `fields` are SOURCE field names (None = all);
        `tag_expr` is the query's tags-only WHERE, evaluated against the
        rollup series index (identical tag sets by construction)."""
        from opengemini_tpu_torch.query import condition as cond

        want = None
        if fields is not None:
            want = [p + f for f in fields for p in (C_, S_, MN_, MX_, SK_)]
        out = []
        for lo, hi in ranges:
            for sh in self.engine.shards_for_range(db, ROLLUP_RP, lo, hi):
                sids = cond.eval_tag_expr(tag_expr, sh.index, spec.target)
                if not sids:
                    continue
                # one bulk read of the shard's rollup series, split by
                # series (the reference reads each series on its own)
                sid_arr, rec = sh.read_series_bulk(
                    spec.target, np.fromiter(sids, np.int64), lo, hi,
                    fields=want)
                if not len(rec):
                    continue
                cols = {name: Column(col.ftype, col.values, col.valid)
                        for name, col in rec.columns.items()}
                uniq, starts = np.unique(sid_arr, return_index=True)
                ends = np.r_[starts[1:], len(sid_arr)]
                for sid, a, b in zip(uniq.tolist(), starts.tolist(),
                                     ends.tolist()):
                    tags = tuple(sorted(sh.index.tags_of(sid).items()))
                    out.append((tags, Record(rec.times[a:b], {
                        name: Column(c.ftype, c.values[a:b], c.valid[a:b])
                        for name, c in cols.items()})))
        return out

    def read_rows(self, db: str, spec: RollupSpec, ranges,
                  fields: list[str] | None, tag_expr=None):
        """read_recs flattened to per-row dicts: [(tags items tuple,
        window_start, {rollup_field: value})] — the fold's zero-out
        sweep and tests use this small-volume form."""
        out = []
        for tags, rec in self.read_recs(db, spec, ranges, fields,
                                        tag_expr):
            for i, t in enumerate(rec.times):
                row = {}
                for fname, col in rec.columns.items():
                    if col.valid[i]:
                        v = col.values[i]
                        row[fname] = v if isinstance(v, str) else v.item()
                out.append((tags, int(t), row))
        return out

    # -- ops / observability --------------------------------------------------

    def status(self, now_ns: int | None = None) -> dict:
        if now_ns is None:
            now_ns = _time.time_ns()
        out = {}
        for db in self.dbs_with_specs():
            d = self.engine.databases[db]
            for name, spec in d.rollups.items():
                st = self._state(db, spec)
                with self._lock:
                    wm, dirty = st.watermark_ns, len(st.dirty)
                out[f"{db}.{name}"] = {
                    "measurement": spec.measurement,
                    "every_ns": spec.every_ns,
                    "sketch": spec.sketch,
                    "fields": spec.fields,
                    "watermark_ns": wm,
                    "watermark_age_s": (
                        round((now_ns - wm) / NS, 1) if wm is not None
                        else None),
                    "dirty_windows": dirty,
                }
        return out

    def invalidate(self, db: str, name: str | None = None,
                   tmin: int | None = None, tmax: int | None = None) -> int:
        """Operator re-dirty (/debug/ctrl?mod=rollup&op=invalidate):
        re-fold the given span (whole history when unbounded) on the
        next maintenance.  Returns windows re-dirtied (wholesale
        watermark pull-backs count their span)."""
        n = 0
        for spec_db in self.dbs_with_specs():
            if spec_db != db:
                continue
            for sname, spec in self.engine.databases[db].rollups.items():
                if name is not None and sname != name:
                    continue
                st = self._state(db, spec)
                with st.m_lock:
                    with self._lock:
                        wm = st.watermark_ns
                        if wm is None:
                            continue
                        if tmin is None and tmax is None:
                            st.watermark_ns = None
                            st.dirty.clear()
                            n += 1
                        else:
                            lo = int(winmod.window_start(
                                tmin if tmin is not None else 0,
                                spec.every_ns))
                            hi = min(wm, tmax if tmax is not None else wm)
                            n += self._redirty_span_locked(
                                st, spec, lo, hi)
                        snap = st.snapshot()
                    st.save(snap)
        return n

    def _gauges(self) -> dict:
        """/debug/vars section (module "rollup").  Empty when no specs —
        declared-nothing keeps /debug/vars byte-identical."""
        if not self.has_specs():
            return {}
        now_ns = _time.time_ns()
        backlog = 0
        age = 0
        with self._lock:
            states = dict(self._states)
        for (db, name), st in states.items():
            spec = self._specs(db).get(name)
            if spec is None:
                continue
            wm = st.watermark_ns
            backlog += len(st.dirty) + len(st.claimed)
            if wm is not None:
                horizon = int(winmod.window_start(
                    now_ns - spec.delay_ns, spec.every_ns))
                backlog += max(0, (horizon - wm) // spec.every_ns)
                age = max(age, int((now_ns - wm) / NS))
        return {"dirty_backlog": backlog, "watermark_age_s": age,
                "specs": sum(len(self._specs(db))
                             for db in self.dbs_with_specs())}
