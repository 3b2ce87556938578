"""Columnar in-memory record format.

The device-friendly analogue of the reference's `lib/record.Record`
(record.go:57) / `ColVal` (column.go:30): struct-of-arrays with explicit
validity masks instead of packed nil-bitmaps, so columns map 1:1 onto
(values, mask) device array pairs.

Field types follow InfluxDB semantics: float64, int64, bool, string.
Strings never go to the device; group keys are dictionary-encoded on the CPU
before transfer.
"""

from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass, field

import numpy as np


class FieldType(enum.IntEnum):
    """Field types (reference: lib/record/record.go influx.Field_Type_*)."""

    FLOAT = 1
    INT = 2
    BOOL = 3
    STRING = 4

    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self]


_NP_DTYPES = {
    FieldType.FLOAT: np.dtype(np.float64),
    FieldType.INT: np.dtype(np.int64),
    FieldType.BOOL: np.dtype(np.bool_),
    FieldType.STRING: np.dtype(object),
}

TIME_COL = "time"


def np_to_field_type(dtype: np.dtype) -> FieldType:
    if dtype.kind == "f":
        return FieldType.FLOAT
    if dtype.kind in ("i", "u"):
        return FieldType.INT
    if dtype.kind == "b":
        return FieldType.BOOL
    return FieldType.STRING


@dataclass
class Column:
    """A single column: values plus a validity mask (True = present).

    Equivalent of the reference ColVal's Val+Bitmap (lib/record/column.go:30),
    unpacked for device friendliness.
    """

    ftype: FieldType
    values: np.ndarray
    valid: np.ndarray

    @classmethod
    def empty(cls, ftype: FieldType) -> "Column":
        return cls(ftype, np.empty(0, dtype=ftype.np_dtype), np.empty(0, dtype=np.bool_))

    @classmethod
    def from_values(cls, ftype: FieldType, values, valid=None) -> "Column":
        arr = np.asarray(values, dtype=ftype.np_dtype)
        if valid is None:
            v = np.ones(len(arr), dtype=np.bool_)
        else:
            v = np.asarray(valid, dtype=np.bool_)
        return cls(ftype, arr, v)

    def __len__(self) -> int:
        return len(self.values)

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.ftype, self.values[idx], self.valid[idx])

    def concat(self, other: "Column") -> "Column":
        assert self.ftype == other.ftype
        return Column(
            self.ftype,
            np.concatenate([self.values, other.values]),
            np.concatenate([self.valid, other.valid]),
        )


class EncodedColumn(Column):
    """Column whose values are still in their on-disk encoded blocks
    (storage/encoding.py device-profile raw envelopes).

    `.values` decodes lazily on the host — bit-identical to an eager
    decode and memoized, so every existing consumer works unchanged.
    Device-decode-aware consumers (models/grid.py GridBatch via
    ops/device_decode.py) take `.blocks` — the raw self-describing block
    buffers — and ship the encoded payloads to the accelerator instead.
    `valid` is always a real (eagerly decoded) array: masks are tiny.

    The column VIEW may be a row subset of the blocks' decoded
    concatenation: `segments` is a (k, 2) int64 array of absolute
    [lo, hi) row runs (None = the whole concatenation of `n_full`
    rows).  A strictly-increasing take() — every time-range trim, sid
    filter, and dedup keep over sorted rows — stays ENCODED by
    composing run lists; anything else decodes, bit-identically.  The
    device decoder replays the same runs after decoding whole blocks.

    The column is immutable by the read-path contract like any cached
    decoded column; the lazy decode is idempotent, so concurrent first
    touches converge on identical arrays."""

    # past this many row runs the per-run bookkeeping stops paying for
    # itself; take() then just decodes
    _SEG_CAP = 4096

    def __init__(self, ftype: FieldType, blocks, valid: np.ndarray, decode,
                 segments: np.ndarray | None = None,
                 n_full: int | None = None):
        self.ftype = ftype
        self.blocks = list(blocks)
        self.valid = valid
        self.segments = segments
        self.n_full = len(valid) if n_full is None else int(n_full)
        self._decode = decode  # (ftype, blocks) -> np.ndarray host decode
        self._values: np.ndarray | None = None
        # provenance of this view's block concatenation as
        # [(root_column, abs_row_offset)] — the FULL-view columns
        # (segments None, typically colcache-resident chunk columns)
        # whose decodes concatenate to exactly this view's blocks.
        # Host decodes route through each root's memoized .values, so N
        # views/merges over one cached chunk column cost ONE block
        # decode process-wide, not N.  None = decode own blocks directly.
        self._spans: list | None = None

    @property
    def is_decoded(self) -> bool:
        return self._values is not None

    def roots(self) -> list["EncodedColumn"]:
        """The columns whose block decodes this view's ``.values`` reads:
        its root columns, or itself. Decoding them first (in any order,
        on any thread) leaves ``.values`` only slicing."""
        spans = self._spans_or_self()
        return [self] if spans is None else [r for r, _off in spans]

    def _spans_or_self(self) -> list | None:
        """This column as root spans, or None when it has no root
        provenance (a standalone segmented view decodes its own
        blocks)."""
        if self._spans is not None:
            return self._spans
        if self.segments is None:
            return [(self, 0)]
        return None

    @property
    def values(self) -> np.ndarray:  # type: ignore[override]
        v = self._values
        if v is None:
            spans = self._spans
            if spans is not None:
                # slice each [lo, hi) run out of its root's memoized
                # full decode (runs merged across a root boundary by
                # take() split back here) — one decode per root ever
                offs = [off for _r, off in spans] + [self.n_full]
                pieces = []
                for a, b in self.abs_segments():
                    j = bisect.bisect_right(offs, a) - 1
                    while a < b:
                        root, off = spans[j]
                        hi = min(b, offs[j + 1])
                        pieces.append(root.values[a - off:hi - off])
                        a = hi
                        j += 1
                v = (np.concatenate(pieces) if pieces
                     else np.empty(0, self.ftype.np_dtype))
            else:
                d = self._decode(self.ftype, self.blocks)
                if self.segments is not None:
                    d = (np.concatenate([d[a:b] for a, b in self.segments])
                         if len(self.segments) else d[:0])
                v = d
            self._values = v
        return v

    def __len__(self) -> int:
        return len(self.valid)

    def accounted_nbytes(self) -> int:
        """Cache-budget accounting WITHOUT firing the lazy decode:
        decoded width (8 bytes/value — only numeric ftypes are ever
        encoded) plus the retained encoded payload, since both stay
        live once a host consumer memoizes `.values`.  The single rule
        both column caches (storage/colcache.py, storage/tsf.py)
        charge by."""
        return (len(self) * 8 + int(self.valid.nbytes)
                + sum(len(b) for b in self.blocks))

    def abs_segments(self) -> np.ndarray:
        """The view's absolute [lo, hi) runs over the decoded block
        concatenation ((k, 2) int64; identity view = one full run)."""
        if self.segments is not None:
            return self.segments
        return np.array([[0, self.n_full]], np.int64)

    def _abs_index(self) -> np.ndarray:
        """Absolute row index per view row."""
        segs = self.abs_segments()
        return (np.concatenate([np.arange(a, b) for a, b in segs])
                if len(segs) else np.empty(0, np.int64))

    def take(self, idx: np.ndarray) -> "Column":
        idx = np.asarray(idx)
        if len(idx) == 0:
            return Column(self.ftype,
                          np.empty(0, dtype=self.ftype.np_dtype),
                          np.empty(0, dtype=np.bool_))
        if len(idx) > 1 and (np.diff(idx) <= 0).any():
            return super().take(idx)
        abs_idx = self._abs_index()[idx]
        brk = np.flatnonzero(np.diff(abs_idx) != 1)
        if len(brk) + 1 > self._SEG_CAP:
            return super().take(idx)
        lo = np.concatenate([abs_idx[:1], abs_idx[brk + 1]])
        hi = np.concatenate([abs_idx[brk], abs_idx[-1:]]) + 1
        out = EncodedColumn(
            self.ftype, self.blocks, self.valid[idx], self._decode,
            segments=np.stack([lo, hi], axis=1), n_full=self.n_full)
        out._spans = self._spans_or_self()
        if self._values is not None:
            # already decoded (e.g. a colcache host-tier hit): keep the
            # blocks attached — the device route stays available for a
            # warm repeat — and carry the row subset of the memoized
            # view so no host consumer ever re-decodes
            out._values = self._values[idx]
        return out

    def concat(self, other: "Column") -> "Column":
        if (isinstance(other, EncodedColumn)
                and self.ftype == other.ftype):
            segs = np.concatenate(
                [self.abs_segments(),
                 other.abs_segments() + self.n_full])
            if len(segs) <= self._SEG_CAP:
                out = EncodedColumn(
                    self.ftype, self.blocks + other.blocks,
                    np.concatenate([self.valid, other.valid]),
                    self._decode, segments=segs,
                    n_full=self.n_full + other.n_full)
                s1, s2 = self._spans_or_self(), other._spans_or_self()
                if s1 is not None and s2 is not None:
                    out._spans = s1 + [(r, off + self.n_full)
                                       for r, off in s2]
                if self._values is not None and other._values is not None:
                    # both sides already decoded: carry the memoized
                    # views forward so no host consumer re-decodes;
                    # mixed decode states stay lazy (bit-identical)
                    out._values = np.concatenate(
                        [self._values, other._values])
                return out
        return super().concat(other)


@dataclass
class Record:
    """A batch of rows for one series (or one measurement slice): a time
    column plus named field columns, all equal length.

    times are int64 nanoseconds since epoch (InfluxDB convention).
    """

    times: np.ndarray  # int64 ns
    columns: dict[str, Column] = field(default_factory=dict)

    @classmethod
    def empty(cls) -> "Record":
        return cls(np.empty(0, dtype=np.int64), {})

    def __len__(self) -> int:
        return len(self.times)

    @property
    def field_names(self) -> list[str]:
        return list(self.columns.keys())

    def take(self, idx: np.ndarray) -> "Record":
        return Record(self.times[idx], {k: c.take(idx) for k, c in self.columns.items()})

    def concat(self, other: "Record") -> "Record":
        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        cols: dict[str, Column] = {}
        names = list(self.columns.keys()) + [
            k for k in other.columns if k not in self.columns
        ]
        n_self, n_other = len(self), len(other)
        for k in names:
            a = self.columns.get(k)
            b = other.columns.get(k)
            if a is None:
                a = _null_column(b.ftype, n_self)
            if b is None:
                b = _null_column(a.ftype, n_other)
            cols[k] = a.concat(b)
        return Record(np.concatenate([self.times, other.times]), cols)

    def sort_by_time(self, descending: bool = False) -> "Record":
        """Stable sort by time. With duplicate timestamps the LAST occurrence
        wins on dedup (reference last-write-wins merge semantics,
        lib/record/merge.go)."""
        if not descending and (
                len(self) <= 1 or not (self.times[1:] < self.times[:-1]).any()):
            # already ascending (every TSF chunk, most merged reads):
            # records are immutable on the read path, so the identity
            # return is safe — and it keeps lazily-encoded columns
            # (EncodedColumn) intact for the device-decode path
            return self
        order = np.argsort(self.times, kind="stable")
        if descending:
            order = order[::-1]
        return self.take(order)

    def dedup_last_wins(self) -> "Record":
        """Assumes time-sorted ascending; keeps the last row per timestamp."""
        if len(self) <= 1:
            return self
        keep = np.empty(len(self), dtype=np.bool_)
        keep[:-1] = self.times[:-1] != self.times[1:]
        keep[-1] = True
        if keep.all():
            return self
        return self.take(np.nonzero(keep)[0])

    def slice_time(self, t_min: int, t_max: int) -> "Record":
        """Rows with t_min <= time < t_max (assumes nothing about order)."""
        m = (self.times >= t_min) & (self.times < t_max)
        if m.all():
            return self
        return self.take(np.nonzero(m)[0])


def _zeroed(ftype: FieldType, n: int) -> np.ndarray:
    if ftype == FieldType.STRING:
        return np.full(n, None, dtype=object)
    return np.zeros(n, dtype=ftype.np_dtype)


def _null_column(ftype: FieldType, n: int) -> Column:
    return Column(ftype, _zeroed(ftype, n), np.zeros(n, dtype=np.bool_))


class RecordBuilder:
    """Row-at-a-time appender producing a Record; used by the memtable.

    Maintains per-field python lists and converts to numpy on build — O(1)
    amortized appends without numpy realloc churn.
    """

    def __init__(self) -> None:
        self._times: list[int] = []
        self._cols: dict[str, tuple[FieldType, list, list]] = {}

    def __len__(self) -> int:
        return len(self._times)

    def append_row(self, t: int, fields: dict[str, tuple[FieldType, object]]) -> None:
        # Validate the whole point before mutating any state: a rejected
        # point must not leave a phantom row behind (the reference rejects
        # whole points at routeAndMapOriginRows, coordinator/points_writer.go:381).
        for name, (ftype, _) in fields.items():
            col = self._cols.get(name)
            if col is not None and col[0] != ftype:
                raise FieldTypeConflict(name, col[0], ftype)
        row_i = len(self._times)
        self._times.append(t)
        for name, (ftype, value) in fields.items():
            col = self._cols.get(name)
            if col is None:
                col = (ftype, [], [])
                self._cols[name] = col
            _, vals, idxs = col
            vals.append(value)
            idxs.append(row_i)

    def build(self) -> Record:
        n = len(self._times)
        times = np.asarray(self._times, dtype=np.int64)
        cols: dict[str, Column] = {}
        for name, (ftype, vals, idxs) in self._cols.items():
            valid = np.zeros(n, dtype=np.bool_)
            idx_arr = np.asarray(idxs, dtype=np.int64)
            valid[idx_arr] = True
            if ftype == FieldType.STRING:
                values = np.full(n, None, dtype=object)
            else:
                values = np.zeros(n, dtype=ftype.np_dtype)
            values[idx_arr] = np.asarray(vals, dtype=ftype.np_dtype)
            cols[name] = Column(ftype, values, valid)
        return Record(times, cols)


class FieldTypeConflict(Exception):
    """Write with a field type conflicting with the existing schema
    (reference rejects these at routeAndMapOriginRows,
    coordinator/points_writer.go:381)."""

    def __init__(self, name: str, have: FieldType, got: FieldType):
        super().__init__(
            f"field type conflict for {name!r}: have {have.name}, got {got.name}"
        )
        self.field = name
        self.have = have
        self.got = got


def _merge_bulk_sorted_fast(parts, lo_t: int, hi_t: int):
    """Sort-free fast path for the common bulk-scan shape: every part is
    a single-series chunk. Grouping parts by sid and checking the
    concatenation for strictly-increasing (sid, time) replaces the
    three-key lexsort (the profiled hot spot of at-spec scans) with one
    vectorized monotonicity pass. Returns None when the shape does not
    apply (multi-sid parts, overlapping chunks, duplicate timestamps) —
    the caller's general merge handles those."""
    # PRECONDITION: every part is internally time-sorted (TSF chunks are
    # written sorted, memtable bulk parts sort on freeze) — searchsorted
    # slicing below relies on it; the post-slice monotonicity check still
    # rejects cross-part overlap/duplicates.
    single = []
    ftypes: dict[str, object] = {}
    for s, r in parts:
        # CONSTANT sid required — endpoints alone are not enough: a
        # time-sorted memtable part can interleave sids and still have
        # s[0] == s[-1]
        if s[0] != s[-1] or not (s == s[0]).all():
            return None
        # column set collects over ALL parts — a part fully trimmed by
        # the time range must still contribute its (all-invalid) columns,
        # like the general merge path does
        for name, col in r.columns.items():
            ftypes.setdefault(name, col.ftype)
        # pre-slice each part to [lo_t, hi_t): parts are time-sorted, so
        # two searchsorteds trim chunk-straddle rows as VIEWS before any
        # copy — the former post-concat range mask was a second full pass
        lo = int(np.searchsorted(r.times, lo_t, "left"))
        hi = int(np.searchsorted(r.times, hi_t, "left"))
        if hi <= lo:
            continue
        single.append((int(s[0]), lo, hi, r))
    if not single:
        return np.empty(0, np.int64), Record(np.empty(0, np.int64), {})
    # stable by sid: parts of one series keep oldest-first order, which
    # the monotonicity check below then validates
    single.sort(key=lambda x: x[0])
    t_all = np.concatenate([r.times[lo:hi] for _k, lo, hi, r in single])
    sid_all = np.concatenate(
        [np.full(hi - lo, k, np.int64) for k, lo, hi, _r in single])
    ds = np.diff(sid_all)
    if not ((ds > 0) | ((ds == 0) & (np.diff(t_all) > 0))).all():
        return None  # overlap or duplicates: general merge required
    cols = {}
    total = len(t_all)
    for name, ftype in ftypes.items():
        enc = _concat_encoded(name, ftype, single, total)
        if enc is not None:
            cols[name] = enc
            continue
        values = _zeroed(ftype, total)
        valid = np.zeros(total, dtype=np.bool_)
        at = 0
        for _k, lo, hi, r in single:
            m = hi - lo
            col = r.columns.get(name)
            if col is not None:
                values[at:at + m] = col.values[lo:hi]
                valid[at:at + m] = col.valid[lo:hi]
            at += m
        cols[name] = Column(ftype, values, valid)
    return sid_all, Record(t_all, cols)


def _concat_encoded(name, ftype, single, total):
    """Encoded-view concatenation for the sorted-fast merge: when every
    part contributes this column as an EncodedColumn, the merged column
    composes their (possibly time-trimmed) row views.  Still-encoded
    parts never materialize decoded bytes on the host (the device-decode
    cold path, ops/device_decode.py); already-decoded parts (colcache
    host-tier hits on a warm repeat) compose too, carrying their
    memoized values forward WITH the raw blocks still attached — so the
    offload planner (query/offload.py) keeps the device route available
    on every repeat.  Any absence or run-cap overflow falls back to the
    copying path (bit-identical either way)."""
    merged = None
    for _k, lo, hi, r in single:
        col = r.columns.get(name)
        if not isinstance(col, EncodedColumn) or col.ftype != ftype:
            return None
        view = col if (lo == 0 and hi == len(col)) \
            else col.take(np.arange(lo, hi))
        if not isinstance(view, EncodedColumn):
            return None  # run-cap overflow dropped the blocks
        merged = view if merged is None else merged.concat(view)
        if not isinstance(merged, EncodedColumn):
            return None
    if merged is None or len(merged) != total:
        return None
    return merged


def concat_records(records: list) -> Record:
    """Record.concat over many records at once: each column is copied
    once, where folding concat pairwise copies the growing prefix again
    for every record (quadratic in the record count — a flush streams a
    packed chunk every 131072 rows, so a one-file scan has hundreds).
    Still-encoded columns compose into one encoded view, exactly as the
    pairwise fold would, and decode past the same run cap."""
    recs = [r for r in records if len(r)]
    if len(recs) <= 1:
        return recs[0] if recs else Record.empty()
    ftypes: dict[str, FieldType] = {}
    for r in recs:
        for k, c in r.columns.items():
            ftypes.setdefault(k, c.ftype)
    cols: dict[str, Column] = {}
    for k, ftype in ftypes.items():
        parts = [r.columns.get(k) for r in recs]
        enc = concat_encoded_columns(parts, ftype)
        if enc is not None:
            cols[k] = enc
            continue
        parts = [c if c is not None else _null_column(ftype, len(r))
                 for c, r in zip(parts, recs)]
        cols[k] = Column(ftype, np.concatenate([c.values for c in parts]),
                         np.concatenate([c.valid for c in parts]))
    return Record(np.concatenate([r.times for r in recs]), cols)


def concat_encoded_columns(cols, ftype):
    """The pairwise EncodedColumn.concat fold in one step, or None when
    a part is not an EncodedColumn of `ftype` or the runs pass the cap
    (the caller then copies decoded values)."""
    if not all(isinstance(c, EncodedColumn) and c.ftype == ftype
               for c in cols):
        return None
    bases = np.cumsum([0] + [c.n_full for c in cols])
    segs = np.concatenate([c.abs_segments() + b
                           for c, b in zip(cols, bases)])
    if len(segs) > EncodedColumn._SEG_CAP:
        return None
    out = EncodedColumn(ftype, [b for c in cols for b in c.blocks],
                        np.concatenate([c.valid for c in cols]),
                        cols[0]._decode, segments=segs,
                        n_full=int(bases[-1]))
    spans = [c._spans_or_self() for c in cols]
    if all(sp is not None for sp in spans):
        out._spans = [(root, off + b) for sp, b in zip(spans, bases)
                      for root, off in sp]
    if all(c.is_decoded for c in cols):
        out._values = np.concatenate([c.values for c in cols])
    return out


def _merge_bulk_encoded(parts, lo_t: int, hi_t: int):
    """Merge of multi-series parts that share no (sid, time) key — the
    packed chunks of several flushes, each holding every series for its
    own stretch of time — that keeps still-encoded columns ENCODED: the
    merged column is a row-run view, in (sid, time) order, over the
    concatenation of every part's blocks. The JAX package's merge
    decodes such parts on the host; here the grid freeze can still ship
    their blocks to the card. Returns None when no part has an encoded
    column or two parts share a key (the general merge dedups those)."""
    if not any(isinstance(c, EncodedColumn)
               for _s, r in parts for c in r.columns.values()):
        return None
    sid_all = np.concatenate([s for s, _r in parts])
    t_all = np.concatenate([r.times for _s, r in parts])
    # parts come oldest first, so a stable sort by sid alone already
    # puts each series' rows in time order when the parts follow each
    # other in time (a time-ordered load); the full two-key sort is
    # the general case
    for sort in (lambda: np.argsort(sid_all, kind="stable"),
                 lambda: np.lexsort((t_all, sid_all))):
        order = sort()
        sid_s, t_s = sid_all[order], t_all[order]
        ds = np.diff(sid_s)
        if ((ds > 0) | ((ds == 0) & (np.diff(t_s) > 0))).all():
            break
    else:
        return None
    keep = (t_s >= lo_t) & (t_s < hi_t)
    if not keep.all():
        order, sid_s, t_s = order[keep], sid_s[keep], t_s[keep]
    ftypes: dict[str, object] = {}
    for _s, r in parts:
        for name, col in r.columns.items():
            ftypes.setdefault(name, col.ftype)
    cols = {}
    for name, ftype in ftypes.items():
        enc = _permute_encoded(name, ftype, parts, order)
        if enc is not None:
            cols[name] = enc
            continue
        values = _zeroed(ftype, len(sid_all))
        valid = np.zeros(len(sid_all), dtype=np.bool_)
        at = 0
        for _s, r in parts:
            col = r.columns.get(name)
            if col is not None:
                values[at:at + len(r)] = col.values
                valid[at:at + len(r)] = col.valid
            at += len(r)
        cols[name] = Column(ftype, values[order], valid[order])
    return sid_s, Record(t_s, cols)


def _permute_encoded(name, ftype, parts, order):
    """One column of _merge_bulk_encoded: an EncodedColumn whose view
    takes the concatenated parts' rows in `order`, or None when a part
    lacks the column in encoded form or the view would need more runs
    than one per 64 rows (then copying is cheaper)."""
    cols = [r.columns.get(name) for _s, r in parts]
    if not all(isinstance(c, EncodedColumn) and c.ftype == ftype
               for c in cols):
        return None
    bases = np.cumsum([0] + [c.n_full for c in cols])
    abs_idx = np.concatenate(
        [c._abs_index() + b for c, b in zip(cols, bases)])[order]
    if not len(abs_idx):
        return None
    brk = np.flatnonzero(np.diff(abs_idx) != 1)
    if len(brk) + 1 > max(EncodedColumn._SEG_CAP, len(abs_idx) // 64):
        return None
    lo = np.concatenate([abs_idx[:1], abs_idx[brk + 1]])
    hi = np.concatenate([abs_idx[brk], abs_idx[-1:]]) + 1
    out = EncodedColumn(
        ftype, [b for c in cols for b in c.blocks],
        np.concatenate([c.valid for c in cols])[order], cols[0]._decode,
        segments=np.stack([lo, hi], axis=1), n_full=int(bases[-1]))
    spans = [c._spans_or_self() for c in cols]
    if all(sp is not None for sp in spans):
        out._spans = [(root, off + b) for sp, b in zip(spans, bases)
                      for root, off in sp]
    if all(c.is_decoded for c in cols):
        out._values = np.concatenate([c.values for c in cols])[order]
    return out


def merge_bulk_parts(
    parts: list[tuple[np.ndarray, Record]], lo_t: int, hi_t: int
) -> tuple[np.ndarray, Record]:
    """Vectorized multi-series merge: `parts` is [(sid_arr, record)] in
    oldest-to-newest order; output rows sort by (sid, time), duplicate
    (sid, time) pairs keep the newest ROW whole (matching
    merge_sorted_records / dedup_last_wins row semantics exactly), done
    in one numpy pass over every series at once."""
    parts = [(s, r) for s, r in parts if len(r)]
    if not parts:
        return np.empty(0, np.int64), Record(np.empty(0, np.int64), {})
    # parts whose in-order concatenation is ALREADY strictly
    # (sid, time)-sorted need no merge at all: one part (the memtable
    # consolidation, one packed colstore chunk), or several packed
    # chunks written series-ascending (a big flush streams a chunk
    # every PACK_ROWS rows, never splitting a series).  One
    # monotonicity pass + a time mask instead of the three-key lexsort,
    # and — the part that matters for the device-decode cold path —
    # Record.concat/take keep still-encoded columns ENCODED, where the
    # general merge below materializes them on the host.
    s_cat = (parts[0][0] if len(parts) == 1
             else np.concatenate([s for s, _r in parts]))
    t_cat = (parts[0][1].times if len(parts) == 1
             else np.concatenate([r.times for _s, r in parts]))
    ds = np.diff(s_cat)
    if not len(ds) or (
            (ds > 0) | ((ds == 0) & (np.diff(t_cat) > 0))).all():
        rec = concat_records([r for _s, r in parts])
        m = (t_cat >= lo_t) & (t_cat < hi_t)
        if m.all():
            return s_cat, rec
        idx = np.flatnonzero(m)
        return s_cat[idx], rec.take(idx)
    fast = _merge_bulk_sorted_fast(parts, lo_t, hi_t)
    if fast is not None:
        return fast
    enc = _merge_bulk_encoded(parts, lo_t, hi_t)
    if enc is not None:
        return enc
    sid_all = np.concatenate([s for s, _r in parts])
    t_all = np.concatenate([r.times for _s, r in parts])
    rank_all = np.concatenate(
        [np.full(len(r), i, np.int32) for i, (_s, r) in enumerate(parts)])
    in_range = (t_all >= lo_t) & (t_all < hi_t)

    ftypes: dict[str, object] = {}
    for _s, r in parts:
        for name, col in r.columns.items():
            ftypes.setdefault(name, col.ftype)

    order = np.lexsort((rank_all, t_all, sid_all))
    order = order[in_range[order]]
    n = len(order)
    if n == 0:
        return np.empty(0, np.int64), Record(np.empty(0, np.int64), {})
    sid_s = sid_all[order]
    t_s = t_all[order]
    new_grp = np.empty(n, np.bool_)
    new_grp[0] = True
    new_grp[1:] = (np.diff(sid_s) != 0) | (np.diff(t_s) != 0)
    starts = np.flatnonzero(new_grp)
    # newest row of each (sid, time) group wins whole (rank is the last
    # lexsort key, so the group's final position is its newest part)
    winners = np.append(starts[1:], n) - 1
    out_sid = sid_s[starts]
    out_t = t_s[starts]

    cols = {}
    for name, ftype in ftypes.items():
        total = len(sid_all)
        # zero-init, not np.empty: rows where no part has the column stay
        # invalid but their value bytes still flow into flushed chunks and
        # content_digest — heap garbage there breaks the replica-identical
        # digest guarantee
        values = _zeroed(ftype, total)
        valid = np.zeros(total, dtype=np.bool_)
        at = 0
        for _s, r in parts:
            m = len(r)
            col = r.columns.get(name)
            if col is not None:
                values[at:at + m] = col.values
                valid[at:at + m] = col.valid
            at += m
        take = order[winners]
        cols[name] = Column(ftype, values[take], valid[take])
    return out_sid, Record(out_t, cols)


def merge_sorted_records(records: list[Record]) -> Record:
    """Merge time-sorted records into one sorted, deduped record.

    Later entries in `records` win on duplicate timestamps (caller passes
    older files first, memtable last — the reference's out-of-order merge
    ordering, engine/immutable/merge_tool.go)."""
    recs = [r for r in records if len(r)]
    if not recs:
        return Record.empty()
    if len(recs) == 1:
        return recs[0].sort_by_time().dedup_last_wins()
    merged = recs[0]
    for r in recs[1:]:
        merged = merged.concat(r)
    return merged.sort_by_time().dedup_last_wins()
