"""Ragged-to-dense segment batching: variable group sizes as dense rows.

The port of ``opengemini_tpu/models/ragged.py``. Ragged (segment id per
row) batches become SIZE-BUCKETED DENSE matrices on the host, and every
aggregate becomes a per-row reduction on the card:

  - the WIDTHS ladder (16/64/256/1024, <=4x padding waste) and pow2-padded
    row counts keep the shapes few;
  - segments wider than the top width SPLIT into consecutive sub-rows and
    combine on the host (exact k-way variance combination for stddev:
    SSD = sum_i [ssd_i + c_i (mu_i - mu)^2]);
  - offsets within segments come from RUN analysis, not a global argsort.

Per bucket, the basic statistics run in the CUDA kernel
``cuda_segment.bucket_stats_basic`` and the selector picks in
``cuda_segment.bucket_stats_selectors`` (their plain versions on a CPU
device). Segments live in exactly one bucket; per-bucket results scatter
back into (num_segments,) outputs on the host. A kernel group's first run
in the process is its compile (utils/devobs.py: ``bucket_basic``,
``bucket_selectors``).

With a device mesh configured (parallel/runtime.py) and at least as many
bucket rows as shards, a bucket's matrices are split by rows over the
mesh's shards (parallel/distributed.py ``shard_leading_axis``, site
``bucket-shard``) and kernels 1 and 2 launch once per shard on its
rows; the host concatenates the shards' per-row outputs. Bucket rows
are independent, so the shards need no merge. Across processes a rank
places and computes its own shards' rows only, and the per-row outputs
come back whole on every rank (``distributed.fetch_np``'s all_gather). The sharded copy is keyed
by the mesh epoch (a reload reshards it) and is a row of the
device-memory ledger (owner ``bucket_mesh``).
"""

from __future__ import annotations

import numpy as np

from opengemini_tpu_torch.models import templates
from opengemini_tpu_torch.ops import cuda_segment
from opengemini_tpu_torch.parallel import distributed, runtime
from opengemini_tpu_torch.utils import devobs

_REL_LO_BITS = 30
_REL_LO_MASK = (1 << _REL_LO_BITS) - 1

WIDTHS = (16, 64, 256, 1024)  # ~4x max padding waste, 4 canonical shapes
_MIN_G = 8

# aggregates the dense path supports (others use the scatter/lexsort path)
DENSE_AGGS = {"sum", "count", "mean", "min", "max", "first", "last",
              "spread", "stddev"}

# aggregates the host-exact int64 path supports (INT fields: float compute
# dtype would corrupt values beyond its mantissa — 2^24 in f32 on TPU).
# Selector aggs (min/max/first/last) stay on-device for row selection.
INT_EXACT_AGGS = {"sum", "count", "mean"}


class IntExactBatch:
    """Host-side exact int64 aggregation for INT fields (same add/run
    contract as AggBatch/BucketedBatch, minus selector support — the
    routing predicate never sends selectors here). numpy ufunc.at is
    slower than the device, but integer exactness wins for int columns —
    the same tradeoff storage/downsample.py makes for destructive
    rewrites. No timestamps are retained (no selectors -> no consumer)."""

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._seg: list[np.ndarray] = []
        self._mask: list[np.ndarray] = []
        self.n = 0
        self._acc = None

    def add(self, values, rel_ns, seg_ids, mask, times_ns, sids=None):
        self._vals.append(np.asarray(values))
        self._seg.append(np.asarray(seg_ids, dtype=np.int64))
        self._mask.append(np.asarray(mask, dtype=np.bool_))
        self.n += len(values)

    def layout_name(self) -> str:
        return "int-exact"

    def host_times(self) -> np.ndarray:
        return np.empty(0, np.int64)  # interface parity; never consumed

    def _accumulate(self, num_segments: int):
        if self._acc is not None:
            return self._acc
        s = np.zeros(num_segments, dtype=np.int64)
        c = np.zeros(num_segments, dtype=np.int64)
        for vals, seg, mask in zip(self._vals, self._seg, self._mask):
            idx = np.flatnonzero(mask)
            if not len(idx):
                continue
            v = vals[idx].astype(np.int64)
            g = seg[idx]
            np.add.at(s, g, v)
            np.add.at(c, g, 1)
        self._acc = (s, c)
        self._vals = self._seg = self._mask = []  # free the raw rows
        return self._acc

    def run(self, spec, num_segments: int, params: tuple = ()):
        s, c = self._accumulate(num_segments)
        if spec.name == "sum":
            out = s  # int64 end-to-end; renderer keeps integers exact
        elif spec.name == "count":
            out = c
        elif spec.name == "mean":
            out = s / np.maximum(c, 1)
        else:
            raise ValueError(f"int-exact path does not support {spec.name!r}")
        return np.asarray(out), None, c


class BucketedBatch:
    """Drop-in alternative to templates.AggBatch for dense-capable
    aggregates. add() accumulates ragged chunks; the first run() freezes
    the batch into dense buckets."""

    def __init__(self, dtype, device):
        self.dtype = np.dtype(dtype or templates.compute_dtype())
        self.device = device
        self._vals: list[np.ndarray] = []
        self._rel: list[np.ndarray] = []
        self._seg: list[np.ndarray] = []
        self._mask: list[np.ndarray] = []
        self._times: list[np.ndarray] = []
        self.n = 0
        self._frozen = None

    def add(self, values, rel_ns, seg_ids, mask, times_ns, sids=None):
        self._vals.append(np.asarray(values, dtype=self.dtype))
        self._rel.append(np.asarray(rel_ns, dtype=np.int64))
        self._seg.append(np.asarray(seg_ids, dtype=np.int64))
        self._mask.append(np.asarray(mask, dtype=np.bool_))
        self._times.append(np.asarray(times_ns, dtype=np.int64))
        self.n += len(values)

    def layout_name(self) -> str:
        return "bucketed"

    def host_times(self) -> np.ndarray:
        return np.concatenate(self._times) if self._times else np.empty(0, np.int64)

    # -- freeze: ragged -> dense buckets --------------------------------

    def _freeze(self, num_segments: int):
        if self._frozen is not None:
            return self._frozen
        if self.n == 0:
            self._frozen = []
            return self._frozen
        vals = np.concatenate(self._vals)
        rel = np.concatenate(self._rel)
        seg = np.concatenate(self._seg)
        mask = np.concatenate(self._mask)
        n = len(vals)
        row_idx = np.arange(n, dtype=np.int32)

        counts = np.bincount(seg, minlength=num_segments)

        # within-segment arrival offsets via run analysis (no global sort)
        run_starts = np.concatenate([[0], np.flatnonzero(seg[1:] != seg[:-1]) + 1])
        run_segs = seg[run_starts]
        run_lens = np.diff(np.concatenate([run_starts, [n]]))
        order = np.argsort(run_segs, kind="stable")  # runs, not rows
        cum = np.zeros(len(run_starts), dtype=np.int64)
        lens_sorted = run_lens[order]
        segs_sorted = run_segs[order]
        csum = np.cumsum(lens_sorted) - lens_sorted
        first_run_of_seg = np.searchsorted(segs_sorted, segs_sorted)
        base_sorted = csum - csum[first_run_of_seg]
        cum[order] = base_sorted
        offsets = (
            np.arange(n, dtype=np.int64)
            - np.repeat(run_starts, run_lens)
            + np.repeat(cum, run_lens)
        )

        buckets: list[_Bucket] = []
        bucket_of = np.full(num_segments, -1, dtype=np.int8)
        for bi, w in enumerate(WIDTHS):
            lo = WIDTHS[bi - 1] if bi else 0
            if w == WIDTHS[-1]:
                here = counts > lo  # larger segments split into sub-rows
            else:
                here = (counts > lo) & (counts <= w)
            segs_here = np.nonzero(here)[0]
            if len(segs_here) == 0:
                continue
            bucket_of[segs_here] = len(buckets)
            buckets.append(_Bucket(w, segs_here, counts[segs_here],
                                   self.device))

        for b in buckets:
            w = b.width
            # sub-row layout: segment k gets ceil(count/w) consecutive rows
            n_sub = np.maximum((b.seg_counts + w - 1) // w, 1)
            sub_base = np.cumsum(n_sub) - n_sub  # first sub-row per segment
            g = int(n_sub.sum())
            g_pad = _pow2_at_least(g, _MIN_G)
            slot_of = np.zeros(num_segments, dtype=np.int64)
            slot_of[b.segs] = sub_base
            rows = np.nonzero(bucket_of[seg] == _index_of(buckets, b))[0]
            off = offsets[rows]
            flat = (slot_of[seg[rows]] + off // w) * w + off % w
            vmat = np.zeros((g_pad, w), dtype=self.dtype)
            mmat = np.zeros((g_pad, w), dtype=np.bool_)
            hmat = np.zeros((g_pad, w), dtype=np.int32)
            lmat = np.zeros((g_pad, w), dtype=np.int32)
            imat = np.zeros((g_pad, w), dtype=np.int32)
            vmat.reshape(-1)[flat] = vals[rows]
            mmat.reshape(-1)[flat] = mask[rows]
            r = rel[rows]
            hmat.reshape(-1)[flat] = (r >> _REL_LO_BITS).astype(np.int32)
            lmat.reshape(-1)[flat] = (r & _REL_LO_MASK).astype(np.int32)
            imat.reshape(-1)[flat] = row_idx[rows]
            b.arrays = (vmat, hmat, lmat, imat, mmat)
            b.g = g
            b.sub_base = sub_base
            b.n_sub = n_sub
            b.rel = rel  # for host combine of split selectors
        self._frozen = buckets
        return buckets

    # -- execution -------------------------------------------------------

    supports_want_sel = True

    def run(self, spec, num_segments: int, params: tuple = (),
            want_sel: bool = True):
        """Same contract as AggBatch.run: (values, sel|None, counts).
        want_sel=False skips the selector lex-scan kernels for min/max
        (their values come from the basic pass) — GROUP BY time() scans
        never consult sel. first/last still need the selector kernel for
        their VALUES."""
        buckets = self._freeze(num_segments)
        out = np.zeros(num_segments, dtype=np.float64)
        sel = np.zeros(num_segments, dtype=np.int64)
        counts = np.zeros(num_segments, dtype=np.int64)
        is_selector = spec.name in ("min", "max", "first", "last")
        need_sel = spec.name in ("first", "last") or (
            want_sel and spec.name in ("min", "max"))
        for b in buckets:
            st = b.combined(need_selectors=need_sel)
            counts[b.segs] = st["count"]
            if spec.name == "spread":
                out[b.segs] = st["max"] - st["min"]
            elif spec.name == "stddev":
                c = np.maximum(st["count"], 1)
                out[b.segs] = np.sqrt(np.maximum(st["ssd"] / np.maximum(c - 1, 1), 0))
            else:
                out[b.segs] = st[spec.name]
            if is_selector and need_sel:
                sel[b.segs] = st["sel_" + spec.name]
        return out, (sel if (is_selector and need_sel) else None), counts


class _Bucket:
    def __init__(self, width: int, segs: np.ndarray, seg_counts: np.ndarray,
                 device):
        self.width = width
        self.segs = segs
        self.seg_counts = seg_counts
        self.device = device
        self.arrays = None
        self.g = 0
        self.sub_base = None
        self.n_sub = None
        self.rel = None
        self._dev = None
        self._mesh_arrays = None
        self._mesh_epoch = None
        self._ledger = None
        self._raw: dict = {}
        self._combined: dict = {}

    def _device_arrays(self, mesh):
        """(v, hi, lo, idx, m) for the kernels: with a configured mesh
        and at least mesh.size rows, Sharded row splits over its shards
        (keyed by the mesh epoch, so a reload reshards instead of
        serving a dead mesh); otherwise tensors on the bucket's device,
        moved once."""
        if mesh is None or self.g < mesh.size:
            if self._dev is None:
                self._dev = tuple(templates.to_device(a, self.device)
                                  for a in self.arrays)
            return self._dev
        epoch = runtime.mesh_epoch()
        if self._mesh_arrays is None or self._mesh_epoch != epoch:
            devobs.LEDGER.drop(self._ledger)
            self._mesh_arrays = distributed.shard_leading_axis(
                mesh, *self.arrays, xfer_site="bucket-shard")
            self._mesh_epoch = epoch
            self._ledger = devobs.LEDGER.register(
                "bucket_mesh",
                sum(a.nbytes for a in self._mesh_arrays),
                mesh_epoch=epoch, label="bucket", anchor=self)
        return self._mesh_arrays

    def _raw_stats(self, need_selectors: bool) -> dict:
        """Per-sub-row device stats, computed lazily per group: the
        selector kernel runs only for selector queries. Sharded inputs
        launch each kernel once per shard."""
        v, hi, lo, idx, m = self._device_arrays(runtime.get_mesh())
        sharded = isinstance(v, distributed.Sharded)

        def launch(fn, *args):
            if sharded:
                return distributed.per_shard(fn, *args)
            return fn(*args)

        if "count" not in self._raw:
            with devobs.first_run("bucket_basic", (), v.device):
                got = launch(cuda_segment.bucket_stats_basic, v, m)
            self._raw.update({k: distributed.fetch_np(t)[: self.g]
                              for k, t in got.items()})
        if need_selectors and "sel_first" not in self._raw:
            with devobs.first_run("bucket_selectors", (), v.device):
                got = launch(cuda_segment.bucket_stats_selectors,
                             v, hi, lo, idx, m)
            self._raw.update({k: distributed.fetch_np(t)[: self.g]
                              for k, t in got.items()})
        return self._raw

    def combined(self, need_selectors: bool) -> dict:
        """Per-segment stats: raw sub-row stats + host k-way combine."""
        if "count" in self._combined and (
            not need_selectors or "sel_first" in self._combined
        ):
            return self._combined
        raw = self._raw_stats(need_selectors)
        if (self.n_sub == 1).all():
            self._combined = dict(raw)
            cnt = raw["count"].astype(np.int64)
            self._combined["count"] = cnt
            # mean recomputed host-side as f64(sum)/count — the SAME
            # arithmetic as the k-way combine branch below and the grid
            # layout (models/grid.py run()), so a query answers
            # identically whichever layout or slice width the planner
            # picked (the device f32 mean differs in the last ulp)
            self._combined["mean"] = raw["sum"] / np.maximum(cnt, 1)
            return self._combined
        starts = self.sub_base
        out = self._combined
        if "count" not in out:
            cnt = np.add.reduceat(raw["count"], starts).astype(np.int64)
            s = np.add.reduceat(raw["sum"], starts)
            mean = s / np.maximum(cnt, 1)
            # exact k-way variance combination:
            # SSD = sum_i [ssd_i + c_i (mu_i - mu)^2]
            mean_rep = np.repeat(mean, self.n_sub)
            extra = raw["count"] * (raw["mean"] - mean_rep) ** 2
            out.update(
                count=cnt,
                sum=s,
                mean=mean,
                min=np.minimum.reduceat(raw["min"], starts),
                max=np.maximum.reduceat(raw["max"], starts),
                ssd=np.add.reduceat(raw["ssd"] + extra, starts),
            )
        if need_selectors and "sel_first" not in out:
            rel = self.rel
            i64max = np.iinfo(np.int64).max
            i64min = np.iinfo(np.int64).min
            for name, latest in (("first", False), ("last", True)):
                sel_sub = raw["sel_" + name]
                r = np.where(
                    raw["count"] > 0, rel[sel_sub], i64max if not latest else i64min
                )
                red = np.maximum if latest else np.minimum
                best_rep = np.repeat(red.reduceat(r, starts), self.n_sub)
                hit = (r == best_rep) & (raw["count"] > 0)
                # exact-time ties across sub-rows: larger value wins
                # (reference FirstReduce/LastReduce tie rule)
                v_best = np.repeat(np.maximum.reduceat(
                    np.where(hit, raw[name], -np.inf), starts), self.n_sub)
                hit &= raw[name] == v_best
                idx_sub = np.where(hit, np.arange(len(r)), len(r))
                pick = np.clip(np.minimum.reduceat(idx_sub, starts), 0, len(r) - 1)
                out[name] = raw[name][pick]
                out["sel_" + name] = sel_sub[pick]
            for name in ("min", "max"):
                sel_sub = raw["sel_" + name]
                ext_rep = np.repeat(out[name], self.n_sub)
                hit = (raw[name] == ext_rep) & (raw["count"] > 0)
                r = np.where(hit, rel[sel_sub], i64max)
                best_rep = np.repeat(np.minimum.reduceat(r, starts), self.n_sub)
                hit &= r == best_rep
                idx_sub = np.where(hit, np.arange(len(r)), len(r))
                pick = np.clip(np.minimum.reduceat(idx_sub, starts), 0, len(r) - 1)
                out["sel_" + name] = sel_sub[pick]
        return out


def _index_of(buckets: list, b) -> int:
    for i, x in enumerate(buckets):
        if x is b:
            return i
    raise ValueError


def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
