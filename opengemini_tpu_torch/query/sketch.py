"""Approximate percentile from chunk histogram sketches.

The port of ``opengemini_tpu/query/sketch.py``, whole (numpy on the
host: the sketches read chunk metadata or decoded host columns, and no
column of them goes to the device).

Reference: OGSketch quantile sketches (engine/executor/ogsketch.go) — but
persisted per chunk in the TSF pre-agg metadata, so
`percentile_approx(field, q)` answers WITHOUT decoding data blocks:
chunk histograms re-bin into one global histogram (proportional count
distribution), memtable rows and histogram-less chunks bin directly.
Error bound: directly-binned values are within one GLOBAL bin width
(range/256); mass re-binned from a chunk histogram is within one CHUNK
bin width ((chunk_max - chunk_min)/32), which dominates when a chunk
spans most of the value range.
"""

from __future__ import annotations

import math

import numpy as np

GLOBAL_BINS = 256


class HistSketch:
    """Mergeable equi-width histogram over a fixed global [lo, hi]."""

    def __init__(self, lo: float, hi: float, bins: int = GLOBAL_BINS):
        self.lo = lo
        self.hi = max(hi, lo)
        self.bins = bins
        self.counts = np.zeros(bins, dtype=np.float64)
        self.total = 0.0

    def _width(self) -> float:
        return (self.hi - self.lo) / self.bins if self.hi > self.lo else 1.0

    def add_chunk_hist(self, vmin: float, vmax: float, hist: list) -> None:
        """Re-bin a chunk's histogram: each source bin's count spreads
        proportionally over the global bins it overlaps."""
        src = np.asarray(hist, dtype=np.float64)
        n_src = len(src)
        src_w = (vmax - vmin) / n_src if vmax > vmin else 0.0
        if src_w == 0.0:
            self.add_values(np.full(int(src.sum()), vmin))
            return
        w = self._width()
        for i, c in enumerate(src):
            if c == 0:
                continue
            a = vmin + i * src_w
            b = a + src_w
            g0 = int(np.clip((a - self.lo) / w, 0, self.bins - 1))
            g1 = int(np.clip((b - self.lo) / w - 1e-12, 0, self.bins - 1))
            if g1 <= g0:
                self.counts[g0] += c
            else:
                # proportional split over covered global bins
                for g in range(g0, g1 + 1):
                    lo_g = self.lo + g * w
                    hi_g = lo_g + w
                    overlap = max(0.0, min(b, hi_g) - max(a, lo_g))
                    self.counts[g] += c * overlap / src_w
        self.total += float(src.sum())

    def add_values(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        v = np.asarray(values, dtype=np.float64)
        idx = np.clip(
            ((v - self.lo) / self._width()).astype(np.int64), 0, self.bins - 1
        )
        np.add.at(self.counts, idx, 1.0)
        self.total += len(v)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile, interpolated inside the winning bin."""
        if self.total <= 0:
            return None
        rank = max(np.ceil(q / 100.0 * self.total), 1.0)
        cum = np.cumsum(self.counts)
        g = int(np.searchsorted(cum, rank - 1e-9))
        g = min(g, self.bins - 1)
        prev = cum[g - 1] if g > 0 else 0.0
        in_bin = self.counts[g]
        frac = (rank - prev) / in_bin if in_bin > 0 else 0.5
        w = self._width()
        return float(self.lo + g * w + frac * w)


# -- OGSketch: centroid (t-digest-family) quantile sketch --------------------


class OGSketch:
    """Centroid quantile sketch — the role of the reference's OGSketch
    (engine/executor/ogsketch.go: bounded ClusterSet of (mean, weight)
    centroids, quantiles interpolated over half-weight accumulative sums).

    TPU-first shape: centroids live as parallel numpy arrays (means,
    weights) and inserts are BATCH merges — buffer values, then one
    sort + vectorized cumulative-weight compression pass, never a
    per-point tree walk. Mergeable across nodes (concatenate centroid
    sets, recompress): a peer ships O(compression) floats per segment
    regardless of row count, which is what makes huge-cardinality
    quantiles cheap in a cluster."""

    def __init__(self, compression: int = 100):
        self.compression = max(int(compression), 4)
        self.means = np.empty(0, np.float64)
        self.weights = np.empty(0, np.float64)
        self._buf: list[np.ndarray] = []
        self._buf_n = 0
        self.min = math.inf
        self.max = -math.inf

    # -- build ----------------------------------------------------------

    def insert(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if not len(v):
            return
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        self._buf.append(v)
        self._buf_n += len(v)
        if self._buf_n >= 8 * self.compression:
            self._compress()

    def merge(self, other: "OGSketch") -> None:
        """Fold another sketch in as WEIGHTED centroids (lossless relative
        to both sketches' own precision) and recompress."""
        other._compress()
        self._compress()
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        if len(other.means):
            self.means, self.weights = _tdigest_compress(
                np.concatenate([self.means, other.means]),
                np.concatenate([self.weights, other.weights]),
                self.compression,
            )

    def _compress(self) -> None:
        if not self._buf:
            return
        bufv = np.concatenate(self._buf)
        self._buf, self._buf_n = [], 0
        m = np.concatenate([self.means, bufv])
        w = np.concatenate([self.weights,
                            np.ones(len(bufv), np.float64)])
        self.means, self.weights = _tdigest_compress(m, w, self.compression)

    # -- query ----------------------------------------------------------

    @property
    def n(self) -> float:
        self._compress()
        return float(self.weights.sum())

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1]: interpolation over half-weight
        accumulative sums (the reference's updateAccumulativeSum +
        Quantile walk, vectorized via searchsorted)."""
        self._compress()
        if not len(self.means):
            return math.nan
        q = min(max(q, 0.0), 1.0)
        w = self.weights
        total = w.sum()
        # centroid "positions": cumulative weight at centroid midpoints
        cum = np.cumsum(w) - w / 2
        target = q * total
        if target <= cum[0]:
            return float(self.min if total > 1 else self.means[0])
        if target >= cum[-1]:
            return float(self.max if total > 1 else self.means[-1])
        i = int(np.searchsorted(cum, target))
        lo, hi = cum[i - 1], cum[i]
        frac = (target - lo) / max(hi - lo, 1e-12)
        return float(self.means[i - 1]
                     + (self.means[i] - self.means[i - 1]) * frac)

    # -- wire ------------------------------------------------------------

    def serialize(self) -> bytes:
        self._compress()
        head = np.asarray(
            [self.compression, len(self.means), self.min, self.max],
            np.float64)
        return b"".join(a.tobytes() for a in (head, self.means, self.weights))

    @classmethod
    def deserialize(cls, raw: bytes) -> "OGSketch":
        if len(raw) < 32:
            raise ValueError("truncated OGSketch payload")
        head = np.frombuffer(raw[:32], np.float64)
        comp, k = int(head[0]), int(head[1])
        if len(raw) != 32 + 16 * k:
            raise ValueError(
                f"OGSketch payload length {len(raw)} != {32 + 16 * k}")
        s = cls(comp)
        s.min, s.max = float(head[2]), float(head[3])
        s.means = np.frombuffer(raw[32:32 + 8 * k], np.float64).copy()
        s.weights = np.frombuffer(raw[32 + 8 * k:32 + 16 * k],
                                  np.float64).copy()
        return s


def _tdigest_compress(means: np.ndarray, weights: np.ndarray,
                      compression: int):
    """Merge (mean, weight) centroids down to <= ~compression clusters
    with the k1 (arcsine) scale function: tight clusters at the tails,
    coarse in the middle — the error profile quantile sketches need.
    Fully vectorized: one sort, one k-scale bucket assignment over the
    cumulative weights, one reduceat per output array (a per-element
    greedy loop was ~100x slower than np.quantile at 1M rows)."""
    order = np.argsort(means, kind="stable")
    m, w = means[order], weights[order]
    total = w.sum()
    if total <= 0:
        return np.empty(0, np.float64), np.empty(0, np.float64)
    q_left = (np.cumsum(w) - w) / total
    k = np.floor(compression * (
        np.arcsin(np.clip(2 * q_left - 1, -1.0, 1.0)) / np.pi + 0.5))
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
    out_w = np.add.reduceat(w, starts)
    out_m = np.add.reduceat(m * w, starts) / out_w
    return out_m, out_w


# -- rollup percentile cell (exact-until-K, then t-digest) -------------------


class RollupSketch:
    """Per-(series, window, field) percentile cell persisted by the
    materialized-rollup subsystem (storage/rollup.py).

    Two modes:
      exact  — keeps the raw values while there are at most `exact_limit`
               of them; `percentile()` reproduces influx's nearest-rank
               semantics bit-for-bit, so a rollup-spliced percentile
               equals the raw-scan answer (the splice fuzz asserts this).
      digest — past the limit the cell degrades to an OGSketch (bounded
               memory regardless of row count); `percentile()` is then
               the t-digest interpolated quantile (documented approximate,
               same trade the reference's downsampled quantiles make).

    Merging (across series of one GROUP BY key, and across sub-windows
    when the query's time(T) is a multiple of the rollup interval)
    preserves exactness while the combined cell fits the limit."""

    def __init__(self, exact_limit: int = 512, compression: int = 100):
        self.exact_limit = int(exact_limit)
        self.compression = int(compression)
        self._vals: list[np.ndarray] = []
        self._n = 0
        self._digest: OGSketch | None = None

    @property
    def exact(self) -> bool:
        return self._digest is None

    @property
    def n(self) -> float:
        if self._digest is not None:
            return self._digest.n
        return float(self._n)

    def add_values(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if not len(v):
            return
        if self._digest is not None:
            self._digest.insert(v)
            return
        self._vals.append(v)
        self._n += len(v)
        if self._n > self.exact_limit:
            self._degrade()

    def merge(self, other: "RollupSketch") -> None:
        if other._digest is None:
            for v in other._vals:
                self.add_values(v)
            return
        self._degrade()
        self._digest.merge(other._digest)

    def _degrade(self) -> None:
        if self._digest is not None:
            return
        self._digest = OGSketch(self.compression)
        for v in self._vals:
            self._digest.insert(v)
        self._vals, self._n = [], 0

    def percentile(self, q_pct: float) -> float | None:
        """Influx nearest-rank percentile in exact mode (rank
        floor(n*q/100+0.5)-1, None when that rank is out of range — the
        executor's 'no row for this window' rule); t-digest quantile in
        digest mode."""
        if self._digest is not None:
            if self._digest.n <= 0:
                return None
            return self._digest.quantile(q_pct / 100.0)
        if self._n == 0:
            return None
        allv = np.sort(np.concatenate(self._vals), kind="stable")
        i = int(math.floor(len(allv) * q_pct / 100.0 + 0.5)) - 1
        if i < 0 or i >= len(allv):
            return None
        return float(allv[i])

    # -- wire ------------------------------------------------------------

    def serialize(self) -> bytes:
        if self._digest is not None:
            return b"\x01" + self._digest.serialize()
        head = np.asarray([self.exact_limit, self.compression], np.int64)
        body = (np.concatenate(self._vals) if self._vals
                else np.empty(0, np.float64))
        return b"\x00" + head.tobytes() + body.tobytes()

    @classmethod
    def deserialize(cls, raw: bytes) -> "RollupSketch":
        if not raw:
            raise ValueError("empty RollupSketch payload")
        mode, rest = raw[0], raw[1:]
        if mode == 1:
            s = cls()
            s._digest = OGSketch.deserialize(rest)
            s.compression = s._digest.compression
            return s
        if mode != 0 or len(rest) < 16 or (len(rest) - 16) % 8:
            raise ValueError("bad RollupSketch payload")
        head = np.frombuffer(rest[:16], np.int64)
        s = cls(int(head[0]), int(head[1]))
        vals = np.frombuffer(rest[16:], np.float64).copy()
        if len(vals):
            s._vals = [vals]
            s._n = len(vals)
        return s


# -- count-min sketch --------------------------------------------------------


class CountMinSketch:
    """Approximate frequency counts in sublinear space (reference:
    engine/executor/count_min_sketch.go): a (depth x width) counter
    matrix, point estimate = min over rows. Adds are VECTORIZED — a whole
    batch of items hashes in one numpy pass per row (no per-item loop),
    matching how the engine feeds columnar batches."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 7):
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.counts = np.zeros((depth, self.width), np.int64)
        rng = np.random.default_rng(seed)
        self._row_seed = rng.integers(0, 2**63, size=depth,
                                      dtype=np.int64).astype(np.uint64)

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        """(depth, n) column indices: splitmix64 finalizer with a per-row
        seed xor. Plain multiply-shift fails here — float64 bit patterns
        of small integers have 52 trailing zero bits, leaving the
        product's top bits with almost no entropy (measured: every small
        key collided with the heavy hitter)."""
        k = keys.astype(np.uint64)[None, :] ^ self._row_seed[:, None]
        with np.errstate(over="ignore"):
            k ^= k >> np.uint64(30)
            k *= np.uint64(0xBF58476D1CE4E5B9)
            k ^= k >> np.uint64(27)
            k *= np.uint64(0x94D049BB133111EB)
            k ^= k >> np.uint64(31)
        return (k % np.uint64(self.width)).astype(np.int64)

    @staticmethod
    def _keys_of(items) -> np.ndarray:
        arr = np.asarray(items)
        if arr.dtype.kind in "iuf":
            # ONE numeric representation: 7 and 7.0 (and -0.0 and 0.0)
            # must collide, or a float producer + int consumer
            # underestimates (the one thing count-min must never do).
            # float64 is exact for ints < 2^53; +0.0 canonicalizes -0.0.
            return (arr.astype(np.float64) + 0.0).view(np.int64)
        # strings/objects: stable 64-bit digests
        import hashlib

        return np.asarray([
            int.from_bytes(
                hashlib.blake2b(str(x).encode(), digest_size=8).digest(),
                "little", signed=True)
            for x in arr
        ], np.int64)

    def add(self, items, counts=1) -> None:
        keys = self._keys_of(items)
        if not len(keys):
            return
        c = np.broadcast_to(np.asarray(counts, np.int64), keys.shape)
        idx = self._rows(keys)
        for d in range(self.depth):
            np.add.at(self.counts[d], idx[d], c)

    def count(self, item) -> int:
        keys = self._keys_of([item])
        idx = self._rows(keys)
        return int(min(self.counts[d, idx[d, 0]] for d in range(self.depth)))

    def merge(self, other: "CountMinSketch") -> None:
        if (other.width != self.width or other.depth != self.depth
                or other.seed != self.seed):
            raise ValueError("count-min parameters differ")
        self.counts += other.counts

    def serialize(self) -> bytes:
        head = np.asarray([self.width, self.depth, self.seed], np.int64)
        return head.tobytes() + self.counts.tobytes()

    @classmethod
    def deserialize(cls, raw: bytes) -> "CountMinSketch":
        width, depth, seed = np.frombuffer(raw[:24], np.int64)
        s = cls(int(width), int(depth), int(seed))
        body = np.frombuffer(raw[24:], np.int64)
        if len(body) != s.depth * s.width:
            raise ValueError("truncated count-min payload")
        s.counts = body.reshape(s.depth, s.width).copy()
        return s
