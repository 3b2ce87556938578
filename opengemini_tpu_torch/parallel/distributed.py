"""Row-sharded aggregation over a device mesh.

The port of ``opengemini_tpu/parallel/distributed.py``. The reference
lays a scan batch's rows over a JAX device mesh and lets XLA merge the
devices' partials with collectives. The port's mesh is a small class of
its own (``Mesh``): axis names, a shape, and one ``torch.device`` per
shard. A shard's work runs on its own device; the cross-shard merge is
PyTorch code on the first shard's device:

  sum/count   add
  min/max     reduce
  first/last  the lexicographic (hi, lo) time winner, exact-time ties to
              the larger value, then the lowest shard (the shards hold
              contiguous row ranges, so that is the lowest global row)

A sharded tensor (``Sharded``) is a list of per-shard pieces, each on
its shard's device, with the reference's padding (rows padded with
zeros to a multiple of the shard count, masked out by the callers) and
row split (equal consecutive row ranges). ``make_mesh`` lays the shards
over every visible CUDA device by default, one on an H100; a caller may
lay ``n`` shards over fewer devices by passing ``devices`` explicitly,
``[torch.device("cpu")] * 8`` in the tests or ``[cuda:0] * 4`` on one
card. That is the port's counterpart of XLA's forced host device count.

Meshes over more than one GPU (NCCL) and over more than one process
(the reference's ``[device] coordinator-address``) are not in this
port yet (ROADMAP A8.4): a mesh here lives in one process.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from opengemini_tpu_torch.ops import segment as seg
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

_BIG_I32 = 2**31 - 1


class Mesh:
    """A device mesh of one process: ``size`` shards named by
    ``axis_names``, laid out as ``devices`` (an object array of
    ``torch.device`` of the mesh's shape, the reference's meaning);
    ``shard_devices`` is the same devices as a flat list, one per
    shard, in the row split's order."""

    def __init__(self, devices, axis_names, shape):
        self.shard_devices = [_indexed(torch.device(d)) for d in devices]
        self.axis_names = tuple(axis_names)
        flat = np.empty(len(self.shard_devices), dtype=object)
        flat[:] = self.shard_devices
        self.devices = flat.reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = len(self.shard_devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.shard_devices]})")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so that every
    shard names its device the way its tensors report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("shard",),
              shape: tuple[int, ...] | None = None,
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards over ``axes``. ``devices`` defaults
    to every visible CUDA device (and raises without one: nothing falls
    back to the CPU); ``n_devices`` defaults to all of them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible for the mesh; pass devices=[...] "
                "to lay its shards on other devices")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    n_devices = int(n_devices)
    if not 1 <= n_devices <= len(devs):
        raise ValueError(f"a mesh of {n_devices} shards needs as many "
                         f"devices, {len(devs)} given")
    devs = devs[:n_devices]
    if shape is None:
        shape = ((n_devices,) if len(axes) == 1
                 else _factor(n_devices, len(axes)))
    if math.prod(shape) != n_devices or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} "
                         f"shards over axes {axes}")
    return Mesh(devs, axes, shape)


def _factor(n: int, k: int) -> tuple[int, ...]:
    """Split n into k roughly-even factors (8, 2 axes -> (4, 2))."""
    shape = [1] * k
    i = 0
    d = 2
    while n > 1:
        while n % d:
            d += 1
        shape[i % k] *= d
        n //= d
        i += 1
    shape.sort(reverse=True)
    return tuple(shape)


class Sharded:
    """A tensor whose leading axis is split over a mesh's shards: one
    piece per shard, each on its shard's device (the port's counterpart
    of a row-sharded NamedSharding array)."""

    __slots__ = ("mesh", "parts")

    def __init__(self, mesh: Mesh, parts):
        self.mesh = mesh
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return ((sum(int(p.shape[0]) for p in self.parts),)
                + tuple(self.parts[0].shape[1:]))

    @property
    def device(self) -> torch.device:
        """The first shard's device (where cross-shard merges run)."""
        return self.parts[0].device

    @property
    def nbytes(self) -> int:
        return sum(int(p.numel()) * int(p.element_size())
                   for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first shard's)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.parts])


def nbytes_of(x) -> int:
    """Bytes of a tensor or a Sharded one."""
    if isinstance(x, Sharded):
        return x.nbytes
    return int(x.numel()) * int(x.element_size())


def fetch_np(x) -> np.ndarray:
    """devobs.fetch_np of a tensor, or of every piece of a Sharded one
    concatenated in row order."""
    if isinstance(x, Sharded):
        return np.concatenate([devobs.fetch_np(p) for p in x.parts])
    return devobs.fetch_np(x)


def per_shard(fn, *args):
    """Run ``fn`` once per shard on that shard's pieces of the Sharded
    arguments (other arguments go to every call as they are). A dict
    result becomes a dict of Sharded."""
    mesh = next(a.mesh for a in args if isinstance(a, Sharded))
    outs = [fn(*[a.parts[i] if isinstance(a, Sharded) else a
                 for a in args]) for i in range(mesh.size)]
    if isinstance(outs[0], dict):
        return {k: Sharded(mesh, [o[k] for o in outs]) for k in outs[0]}
    return Sharded(mesh, outs)


def _stack(mesh: Mesh, pieces) -> torch.Tensor:
    """Per-shard partials stacked on the first shard's device:
    (shards, ...)."""
    dev = mesh.shard_devices[0]
    return torch.stack([p.to(dev) for p in pieces])


def _local_partials(values, rel_hi, rel_lo, seg_ids, mask, num_segments):
    """Per-shard dense partial aggregates over the local row slice."""
    s = seg.seg_sum(values, seg_ids, num_segments, mask)
    c = seg.seg_count(seg_ids, num_segments, mask)
    mn = seg.seg_min(values, seg_ids, num_segments, mask)
    mx = seg.seg_max(values, seg_ids, num_segments, mask)
    big = torch.tensor(_BIG_I32, dtype=torch.int32, device=values.device)
    n = values.shape[0]
    fv, fsel = seg.seg_first(values, rel_hi, rel_lo, seg_ids, num_segments,
                             mask)
    safe = fsel.clamp(0, n - 1).long()
    f_hi = torch.where(c > 0, rel_hi[safe], big)
    f_lo = torch.where(c > 0, rel_lo[safe], big)
    lv, lsel = seg.seg_last(values, rel_hi, rel_lo, seg_ids, num_segments,
                            mask)
    safe_l = lsel.clamp(0, n - 1).long()
    l_hi = torch.where(c > 0, rel_hi[safe_l], -big)
    l_lo = torch.where(c > 0, rel_lo[safe_l], -big)
    return s, c, mn, mx, (fv, f_hi, f_lo), (lv, l_hi, l_lo)


def _merge_time_extreme(value, hi, lo, earliest: bool):
    """Cross-shard lexicographic (hi, lo) winner over (shards, G)
    partials: exact int32 compares, exact-time ties to the larger value,
    remaining ties to the lowest shard — one actual row's value, never
    an average of tied rows."""
    red = torch.amin if earliest else torch.amax
    big = _BIG_I32 if earliest else -_BIG_I32
    cand = hi == red(hi, 0)
    lo_best = red(torch.where(cand, lo, big), 0)
    cand &= lo == lo_best
    v_best = torch.where(cand, value, -math.inf).amax(0)
    cand &= value == v_best
    return _pick(value, _lowest_rank(cand))


def _lowest_rank(cand: torch.Tensor) -> torch.Tensor:
    """One-hot (shards, G) of the lowest shard among the candidates."""
    rank = torch.arange(cand.shape[0], device=cand.device)[:, None]
    best = torch.where(cand, rank, _BIG_I32).amin(0)
    return cand & (rank == best)


def _pick(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The winning shard's x per segment (w: winner one-hot). where, not
    a product: inf * 0 would poison the sum with NaN."""
    return torch.where(w, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device)).sum(0)


def build_dist_agg(mesh: Mesh, num_segments: int):
    """The distributed query step: sharded batch -> {sum, count, mean,
    min, max, first, last} per segment on the first shard's device.

    The returned function takes Sharded (values, rel_hi, rel_lo,
    seg_ids, mask), padded to a multiple of the mesh size, computes each
    shard's partials on its device and merges them."""

    def step(values, rel_hi, rel_lo, seg_ids, mask):
        locs = [_local_partials(*[a.parts[i] for a in
                                  (values, rel_hi, rel_lo, seg_ids, mask)],
                                num_segments)
                for i in range(mesh.size)]
        s = _stack(mesh, [p[0] for p in locs]).sum(0)
        c = _stack(mesh, [p[1] for p in locs]).sum(0)
        mn = _stack(mesh, [p[2] for p in locs]).amin(0)
        mx = _stack(mesh, [p[3] for p in locs]).amax(0)
        fv = _merge_time_extreme(
            *[_stack(mesh, [p[4][j] for p in locs]) for j in range(3)],
            earliest=True)
        lv = _merge_time_extreme(
            *[_stack(mesh, [p[5][j] for p in locs]) for j in range(3)],
            earliest=False)
        mean = s / c.clamp(min=1).to(s.dtype)
        return {"sum": s, "count": c, "mean": mean, "min": mn, "max": mx,
                "first": fv, "last": lv}

    return step


# aggregates the mesh batch step can serve (everything the executor's
# device path computes except rank-based ones — median/percentile — and
# stddev, which keep the single-device kernels)
MESH_AGGS = {"count", "sum", "mean", "min", "max", "first", "last", "spread"}


def _winner(keys, valid: torch.Tensor) -> torch.Tensor:
    """Cross-shard lexicographic winner one-hot over (shards, G). keys:
    [(stacked array, minimize)], narrowed key by key; ties resolve to
    the lowest shard, so exactly one shard wins per segment."""
    cand = valid
    for arr, minimize in keys:
        if arr.dtype.is_floating_point:
            sent = math.inf if minimize else -math.inf
        else:
            sent = _BIG_I32 if minimize else -_BIG_I32
        masked = torch.where(cand, arr, sent)
        best = masked.amin(0) if minimize else masked.amax(0)
        cand = cand & (masked == best)
    return _lowest_rank(cand)


def build_batch_agg(mesh: Mesh, num_segments: int, sel_names: tuple = ()):
    """The executor's aggregate batch step over a mesh: the multi-shard
    equivalent of templates.AggBatch's single-device aggregates.

    Takes Sharded (values, rel_hi, rel_lo, seg_ids, mask, global_idx)
    and returns per-segment outputs on the first shard's device.
    count/sum/mean and min/max/spread values merge by adding and
    reducing; the winner merge runs only for the selectors in
    `sel_names`, whose ``<name>_sel`` outputs are global row indices, the
    single-device sel contract."""

    def local(values, rel_hi, rel_lo, seg_ids, mask, gidx):
        n_rows = values.shape[0]
        out = {
            "count": seg.seg_count(seg_ids, num_segments, mask),
            "sum": seg.seg_sum(values, seg_ids, num_segments, mask),
            "min": seg.seg_min(values, seg_ids, num_segments, mask),
            "max": seg.seg_max(values, seg_ids, num_segments, mask),
        }
        pick = {"min": seg.seg_min_selector, "max": seg.seg_max_selector,
                "first": seg.seg_first, "last": seg.seg_last}
        for name in sel_names:
            v, sel = pick[name](values, rel_hi, rel_lo, seg_ids,
                                num_segments, mask)
            safe = sel.clamp(0, n_rows - 1).long()
            out[name] = v
            out[name + "_th"] = rel_hi[safe]
            out[name + "_tl"] = rel_lo[safe]
            out[name + "_gsel"] = gidx[safe]
        return out

    def step(values, rel_hi, rel_lo, seg_ids, mask, gidx):
        part = per_shard(local, values, rel_hi, rel_lo, seg_ids, mask, gidx)
        st = {k: _stack(mesh, v.parts) for k, v in part.items()}
        totc, tots = st["count"].sum(0), st["sum"].sum(0)
        mn, mx = st["min"].amin(0), st["max"].amax(0)
        out = {
            "count": totc,
            "sum": tots,
            "mean": tots / totc.clamp(min=1).to(tots.dtype),
            "min": mn,
            "max": mx,
            "spread": mx - mn,
        }
        valid = st["count"] > 0
        for name in sel_names:
            v, th, tl = st[name], st[name + "_th"], st[name + "_tl"]
            if name == "min":
                keys = [(v, True), (th, True), (tl, True)]
            elif name == "max":
                keys = [(v, False), (th, True), (tl, True)]
            elif name == "first":
                # time ties take the larger value (reference FirstReduce)
                keys = [(th, True), (tl, True), (v, False)]
            else:
                keys = [(th, False), (tl, False), (v, False)]
            w = _winner(keys, valid)
            out[name] = _pick(v, w)
            out[name + "_sel"] = _pick(st[name + "_gsel"], w)
        return out

    return step


_BATCH_AGG_CACHE: dict = {}


def batch_agg_jit(mesh: Mesh, num_segments: int, sel_names: tuple = ()):
    """build_batch_agg, one per (mesh, segments, selectors); its first
    build at a geometry counts as the site's compile."""
    key = (id(mesh), num_segments, sel_names)
    got = _BATCH_AGG_CACHE.get(key)
    if got is None or got[0] is not mesh:
        devobs.note_compile("mesh_batch_agg",
                            (mesh.size, num_segments, sel_names))
        got = _BATCH_AGG_CACHE[key] = (
            mesh, build_batch_agg(mesh, num_segments, sel_names))
    return got[1]


def shard_rows(mesh: Mesh, *arrays, xfer_site: str = "agg-batch"):
    """Pad 1D row arrays to a multiple of the mesh size (callers mask the
    padding out) and put them on the shards: the 1D case of
    shard_leading_axis."""
    return shard_leading_axis(mesh, *arrays, xfer_site=xfer_site)


def shard_leading_axis(mesh: Mesh, *arrays, xfer_site: str = "mesh-shard"):
    """Host arrays -> Sharded tensors with their LEADING axis split over
    the mesh's shards (the remaining axes whole on each shard). This is
    how the dense layouts (models/ragged.py bucket matrices,
    models/grid.py grids) go multi-shard: their rows are independent, so
    each shard's kernels need no merge, and the host concatenates the
    shards' (rows,)-shaped outputs.

    Rows are padded with zeros (masked out by the kernels' mask plane or
    sliced off by the [:g] caller convention) to a multiple of
    mesh.size."""
    n_dev = mesh.size
    n = arrays[0].shape[0]
    npad = (n + n_dev - 1) // n_dev * n_dev
    rows = npad // n_dev
    out = []
    nbytes = 0
    t0 = time.perf_counter_ns()
    for a in arrays:
        a = np.asarray(a)
        if npad != n:
            pad = np.zeros((npad - n,) + a.shape[1:], dtype=a.dtype)
            a = np.concatenate([a, pad])
        parts = [torch.from_numpy(np.ascontiguousarray(
            a[i * rows:(i + 1) * rows])).to(dev, copy=True)
            for i, dev in enumerate(mesh.shard_devices)]
        out.append(Sharded(mesh, parts))
        nbytes += int(a.nbytes)
    _STATS.incr("device", "mesh_dense_batches")
    # every byte here is a host->device transfer a warm mesh query must
    # NOT repeat (the colcache device tier retains the sharded tensors)
    _STATS.incr("device", "mesh_h2d_bytes", nbytes)
    devobs.note_transfer("h2d", xfer_site, nbytes,
                         (time.perf_counter_ns() - t0) / 1e9)
    return tuple(out)


def donate_reshard(target, *arrays):
    """Device-to-device relayout of resident tensors onto ``target``: a
    Mesh (the layout shard_leading_axis gives: the leading axis split
    over its shards, which stands in for the reference's
    ``leading_axis_sharding``), or a ``torch.device`` for one device.
    The inputs are donated: the caller keeps only the outputs, so the stale
    layout is freed as soon as the new one has landed, and nothing goes
    through the host. A piece that already lies on its target device
    moves as a view of the gathered tensor, with no copy; a gather onto
    one device holds both layouts only while it copies."""
    _STATS.incr("device", "mesh_reshards")
    nbytes = sum(nbytes_of(a) for a in arrays)
    t0 = time.perf_counter_ns()
    out = tuple(_relayout(a, target) for a in arrays)
    devobs.note_transfer("reshard", "reshard", nbytes,
                         (time.perf_counter_ns() - t0) / 1e9)
    return out


def _relayout(a, target):
    if not isinstance(target, Mesh):
        dev = torch.device(target)
        return a.gather(dev) if isinstance(a, Sharded) else a.to(dev)
    mesh = target
    if isinstance(a, Sharded) and a.mesh is mesh:
        return a
    whole = a.gather() if isinstance(a, Sharded) else a
    n = int(whole.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    rows = n // mesh.size
    return Sharded(mesh, [whole.narrow(0, i * rows, rows).to(dev)
                          for i, dev in enumerate(mesh.shard_devices)])
