"""Aggregate batches on the device: pad -> tensors -> run -> slice.

The port of ``opengemini_tpu/models/templates.py``. The executor hands
numpy batches here; ``AggBatch`` pads them, moves them to its device as
one set of tensors and runs the scatter-form aggregates of
``ops/segment.py`` there. Padding rows are masked out; padded segments
are sliced off after the device call. PyTorch runs eagerly, so there is
no compile cache to key: an aggregate's first run at (function, padded
segments, params) in the process is its "compile" (utils/devobs.py,
``agg_batch``). The padded batch's copy counts on the ``agg-batch``
transfer site and every result fetch on ``result-fetch``.

With a device mesh configured (parallel/runtime.py), the aggregates the
mesh can serve (``distributed.MESH_AGGS``) run over its shards: rows
split over the shards, per-shard partials, one merge
(``distributed.build_batch_agg``). The sel contract is the same (global
row indices), so selector times resolve as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from opengemini_tpu_torch.ops import window as winmod
from opengemini_tpu_torch.ops import segment as seg
from opengemini_tpu_torch.ops.aggregates import AggSpec
from opengemini_tpu_torch.parallel import distributed, runtime
from opengemini_tpu_torch.utils import devobs

_REL_LO_BITS = 30
_REL_LO_MASK = (1 << _REL_LO_BITS) - 1


def compute_dtype() -> np.dtype:
    """float64, on the card as on the CPU (the H100 runs f64 natively);
    the JAX package under x64 computes in the same type."""
    return np.dtype(np.float64)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device` (bool stays bool)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy, counted as a result fetch (devobs.fetch_np)."""
    return devobs.fetch_np(t)


def split_rel_ns(rel_ns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact int64 ns offset -> lexicographic int32 (hi, lo) pair for
    device-side time ordering."""
    hi = (rel_ns >> _REL_LO_BITS).astype(np.int32)
    lo = (rel_ns & _REL_LO_MASK).astype(np.int32)
    return hi, lo


class AggBatch:
    """A device-ready batch for one field: values, (hi, lo) relative
    times, segment ids, validity mask — plus a host-only int64 ns time
    array for exact selector timestamps. Accumulated across shards and
    series."""

    def __init__(self, dtype, device):
        self.dtype = np.dtype(dtype or compute_dtype())
        self.device = torch.device(device)
        self.values: list[np.ndarray] = []
        self.rel_hi: list[np.ndarray] = []
        self.rel_lo: list[np.ndarray] = []
        self.seg_ids: list[np.ndarray] = []
        self.mask: list[np.ndarray] = []
        self.times_ns: list[np.ndarray] = []  # host-side only
        self.n = 0
        self._dev = None
        self._counts_cache: dict[int, np.ndarray] = {}
        self._mesh_outs: dict = {}

    def add(self, values, rel_ns, seg_ids, mask, times_ns, sids=None):
        self.values.append(np.asarray(values, dtype=self.dtype))
        hi, lo = split_rel_ns(np.asarray(rel_ns, dtype=np.int64))
        self.rel_hi.append(hi)
        self.rel_lo.append(lo)
        self.seg_ids.append(np.asarray(seg_ids, dtype=np.int32))
        self.mask.append(np.asarray(mask, dtype=np.bool_))
        self.times_ns.append(np.asarray(times_ns, dtype=np.int64))
        self.n += len(values)

    def _host_padded(self):
        """(values, rel_hi, rel_lo, seg_ids, mask) padded on the host."""
        npad = winmod.pad_to(max(self.n, 1))
        values = np.zeros(npad, dtype=self.dtype)
        rel_hi = np.zeros(npad, dtype=np.int32)
        rel_lo = np.zeros(npad, dtype=np.int32)
        seg_ids = np.zeros(npad, dtype=np.int32)
        mask = np.zeros(npad, dtype=np.bool_)
        off = 0
        for v, h, l, s, m in zip(self.values, self.rel_hi, self.rel_lo,
                                 self.seg_ids, self.mask):
            k = len(v)
            values[off: off + k] = v
            rel_hi[off: off + k] = h
            rel_lo[off: off + k] = l
            seg_ids[off: off + k] = s
            mask[off: off + k] = m
            off += k
        return values, rel_hi, rel_lo, seg_ids, mask

    def _device_arrays(self):
        """(values, rel_hi, rel_lo, seg_ids, mask) padded and on the
        device, built once per batch."""
        if self._dev is not None:
            return self._dev
        padded = self._host_padded()
        devobs.note_transfer("h2d", "agg-batch",
                             sum(a.nbytes for a in padded))
        self._dev = tuple(to_device(a, self.device) for a in padded)
        return self._dev

    def layout_name(self) -> str:
        return "scatter"

    def host_times(self) -> np.ndarray:
        return (np.concatenate(self.times_ns) if self.times_ns
                else np.empty(0, np.int64))

    def host_value_multiset(self, num_segments: int):
        """Per-segment (value, count) multiset of the masked rows: (values
        f64, counts i64, offsets i64[num_segments + 1]), values ascending
        within each segment. Rank aggregates (percentile, median,
        count_distinct) recompute exactly from merged multisets, so the
        cluster's pushdown ships O(groups x distinct) for them
        (query/partials.py)."""
        if not self.values:
            return (np.empty(0, np.float64), np.empty(0, np.int64),
                    np.zeros(num_segments + 1, np.int64))
        v = np.concatenate([np.asarray(x, np.float64) for x in self.values])
        s = np.concatenate([np.asarray(x, np.int64) for x in self.seg_ids])
        m = np.concatenate(self.mask)
        keep = m & (s >= 0) & (s < num_segments)
        v, s = v[keep], s[keep]
        if len(v) == 0:
            return (v, np.empty(0, np.int64),
                    np.zeros(num_segments + 1, np.int64))
        order = np.lexsort((v, s))
        v, s = v[order], s[order]
        new = np.empty(len(v), np.bool_)
        new[0] = True
        new[1:] = (s[1:] != s[:-1]) | (v[1:] != v[:-1])
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, len(v)))
        offs = np.searchsorted(s[starts], np.arange(num_segments + 1))
        return v[starts], counts.astype(np.int64), offs.astype(np.int64)

    def counts(self, num_segments: int) -> np.ndarray:
        """Per-segment valid-row counts (cached per batch)."""
        got = self._counts_cache.get(num_segments)
        if got is None:
            seg_pad = winmod.pad_to(max(num_segments, 1), 256)
            _v, _h, _l, seg_ids, mask = self._device_arrays()
            with devobs.first_run("agg_batch", ("_count_fn", seg_pad, ()),
                                  self.device):
                counts = seg.seg_count(seg_ids, seg_pad, mask)
            got = to_host(counts)[:num_segments]
            self._counts_cache[num_segments] = got
        return got

    def run(self, spec: AggSpec, num_segments: int, params: tuple = ()):
        """Execute one aggregate; returns (values[num_segments],
        sel_idx[num_segments] | None, counts[num_segments]). With a
        configured mesh, the aggregates it serves run over its shards
        (_run_mesh)."""
        mesh = runtime.get_mesh()
        if mesh is not None and not params:
            got = self._run_mesh(mesh, spec, num_segments)
            if got is not None:
                return got
        seg_pad = winmod.pad_to(max(num_segments, 1), 256)
        values, rel_hi, rel_lo, seg_ids, mask = self._device_arrays()
        with devobs.first_run(
                "agg_batch", (spec.fn.__name__, seg_pad, tuple(params)),
                self.device):
            out, sel = spec.fn(values, rel_hi, rel_lo, seg_ids, seg_pad,
                               mask, *params)
        out_np = to_host(out)[:num_segments]
        sel_np = to_host(sel)[:num_segments] if sel is not None else None
        return out_np, sel_np, self.counts(num_segments)

    def _run_mesh(self, mesh, spec: AggSpec, num_segments: int):
        """One aggregate over the mesh's shards, or None for one it does
        not serve. The merged outputs of one (segments, selector) program
        are kept, so the batch's other aggregates reuse them."""
        if spec.name not in distributed.MESH_AGGS:
            return None
        seg_pad = winmod.pad_to(max(num_segments, 1), 256)
        # the winner merge runs only for the selector this spec needs;
        # value-only aggregates share one program
        sel = ((spec.name,) if spec.name in ("min", "max", "first", "last")
               else ())
        key = (seg_pad, sel)
        outs = self._mesh_outs.get(key)
        if outs is None:
            values, rel_hi, rel_lo, seg_ids, mask = self._host_padded()
            gidx = np.arange(len(values), dtype=np.int32)
            step = distributed.batch_agg_jit(mesh, seg_pad, sel)
            sharded = distributed.shard_rows(
                mesh, values, rel_hi, rel_lo, seg_ids, mask, gidx)
            outs = {k: to_host(v) for k, v in step(*sharded).items()}
            self._mesh_outs[key] = outs
        out = outs[spec.name][:num_segments]
        sel_np = outs.get(spec.name + "_sel")
        if sel_np is not None:
            sel_np = sel_np[:num_segments]
        return out, sel_np, outs["count"][:num_segments]
