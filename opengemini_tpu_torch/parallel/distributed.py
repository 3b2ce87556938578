"""Row-sharded aggregation over a device mesh, in one process or across
several.

The port of ``opengemini_tpu/parallel/distributed.py``. The reference
lays a scan batch's rows over a JAX device mesh and lets XLA merge the
devices' partials with collectives. The port's mesh is a small class of
its own (``Mesh``): axis names, a shape, and one ``torch.device`` per
shard. A shard's work runs on its own device; the cross-shard merge is
PyTorch code on this process's first shard's device, then, across
processes, a ``torch.distributed`` collective (NCCL on the card, gloo
on the CPU):

  sum/count   add, then all_reduce SUM
  min/max     reduce, then all_reduce MIN / MAX
  first/last  the lexicographic (hi, lo) time winner, exact-time ties to
              the larger value, then the lowest global shard (the
              shards hold contiguous row ranges, so that is the lowest
              global row): each key a MIN or MAX round, the value taken
              by a masked SUM, as the reference's psum of one-hot
              winners; tied values are never averaged

A sharded tensor (``Sharded``) is a list of this process's pieces, each
on its shard's device, with the reference's global padding (rows padded
with zeros to a multiple of the shard count, masked out by the callers)
and row split (equal consecutive row ranges, shard ``i`` holding rows
``[i * rows, (i + 1) * rows)``). ``make_mesh`` lays the shards over
every visible CUDA device by default, one on an H100; a caller may lay
``n`` shards over fewer devices by passing ``devices`` explicitly,
``[torch.device("cpu")] * 8`` in the tests or ``[cuda:0] * 4`` on one
card. That is the port's counterpart of XLA's forced host device count.

Across processes (a ``runtime.World``, set by server/app.py's
``_init_distributed`` from the ``[device]`` keys, one process per card)
the mesh is global, as the reference's ``jax.devices()`` spans every
process after ``jax.distributed.initialize``: its shard list is
rank-major, each rank's card count comes from an ``all_gather``, and
``local_shards`` are this process's. The model is multi-controller
SPMD: every rank holds the same data, places only its own shards' rows
on its own cards and runs every mesh program in the same order, so the
host arrays every rank passes to ``shard_leading_axis`` are the same
and each rank ships its own rows only. A row-sharded result comes back
whole on every rank (``fetch_np``, ``Sharded.gather``) through an
``all_gather`` of the ranks' equal padded parts: where the reference
raises ("Fetching value for jax.Array that spans non-addressable
devices is not possible"), the port gives the answer of the
reference's own one-process mesh of the same shard count. Every rank
holds the same number of shards.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from opengemini_tpu_torch.ops import segment as seg
from opengemini_tpu_torch.parallel import runtime
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

_BIG_I32 = 2**31 - 1


class Mesh:
    """A device mesh: ``size`` shards named by ``axis_names``, laid out
    as ``devices`` (an object array of ``torch.device`` of the mesh's
    shape, the reference's meaning); ``shard_devices`` is the same
    devices as a flat list, one per shard, in the row split's order,
    each as the process that holds it names it, and ``shard_ranks`` the
    rank of that process. ``world`` is the runtime.World the mesh spans
    (None: this process alone); ``local_shards`` are the global indices
    of this process's shards, ``local_devices`` their devices."""

    def __init__(self, devices, axis_names, shape, ranks=None, world=None):
        self.shard_devices = [_indexed(torch.device(d)) for d in devices]
        self.axis_names = tuple(axis_names)
        flat = np.empty(len(self.shard_devices), dtype=object)
        flat[:] = self.shard_devices
        self.devices = flat.reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = len(self.shard_devices)
        self.shard_ranks = (list(ranks) if ranks is not None
                            else [0] * self.size)
        self.world = world
        rank = 0 if world is None else world.rank
        self.local_shards = [i for i, r in enumerate(self.shard_ranks)
                             if r == rank]
        self.local_devices = [self.shard_devices[i]
                              for i in self.local_shards]

    def __repr__(self) -> str:
        ranks = ("" if self.world is None
                 else f", ranks {self.shard_ranks}")
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.shard_devices]}{ranks})")


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
    """A mesh of ``n_devices`` shards over ``axes``. ``devices`` are this
    process's: every visible CUDA device by default (and it raises
    without one: nothing falls back to the CPU). Under a world every
    rank calls this with the same arguments (an ``all_gather`` of the
    ranks' device counts), ``n_devices`` defaults to all of every
    rank's devices, and every rank holds the same number of shards,
    rank r the global shards [r * k, (r + 1) * k) on its first k
    devices (rank-major, the order of jax.devices()): the ranks' pieces,
    their resident bytes and their caches' evictions are then alike."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible for the mesh; pass devices=[...] "
                "to lay its shards on other devices")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    world = runtime.get_world()
    size = 1 if world is None else world.size
    counts = ([len(devs)] if world is None
              else [int(c) for c in all_gather(
                  torch.tensor([len(devs)], dtype=torch.int64), world)])
    if n_devices is None:
        n_devices = sum(counts)
    n_devices = int(n_devices)
    per_rank = n_devices // size
    if n_devices % size or not 1 <= per_rank <= min(counts):
        raise ValueError(
            f"a mesh of {n_devices} shards needs as many devices, "
            + (f"{counts[0]} given" if world is None else
               f"the same number on each of {size} processes, which "
               f"have {counts}"))
    rank = 0 if world is None else world.rank
    shard_devs = []
    for r in range(size):
        shard_devs += (devs[:per_rank] if r == rank
                       else [_remote(devs[0], i) for i in range(per_rank)])
    if shape is None:
        shape = ((n_devices,) if len(axes) == 1
                 else _factor(n_devices, len(axes)))
    if math.prod(shape) != n_devices or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} "
                         f"shards over axes {axes}")
    return Mesh(shard_devs, axes, shape,
                [r for r in range(size) for _ in range(per_rank)], world)


def _remote(like: torch.device, i: int) -> torch.device:
    """Another process's i-th device, as that process names it."""
    return torch.device(like.type, i) if like.type == "cuda" else like


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


# -- collectives across processes -------------------------------------------

_coll_lock = threading.Lock()
COLLECTIVES = {"calls": 0, "bytes": 0, "wall_ns": 0}


def collective_stats() -> dict:
    """This process's collectives since start: calls, the bytes it sent
    and their wall (each up to its result being ready)."""
    with _coll_lock:
        return dict(COLLECTIVES)


def _note_collective(nbytes: int, t0: int) -> None:
    with _coll_lock:
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += int(nbytes)
        COLLECTIVES["wall_ns"] += time.perf_counter_ns() - t0


def _to_wire(t: torch.Tensor, world) -> torch.Tensor:
    """t as the collective's buffer: contiguous, on the world's device,
    bools as bytes."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.to(world.device).contiguous()


def _finish(world) -> None:
    """Wait for the collective's result: NCCL runs on the card's
    stream, and its wall is the time to the result."""
    if world.backend == "nccl":
        torch.cuda.current_stream(world.device).synchronize()


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce(t: torch.Tensor, op: str, world) -> torch.Tensor:
    """t reduced elementwise over every rank (op: sum, min or max), on
    t's device."""
    import torch.distributed as tdist

    t0 = time.perf_counter_ns()
    buf = _to_wire(t, world)
    tdist.all_reduce(buf, op=getattr(tdist.ReduceOp, _OPS[op]),
                     group=world.group)
    _finish(world)
    _note_collective(buf.numel() * buf.element_size(), t0)
    return buf.to(t.device).to(t.dtype)


def all_gather(t: torch.Tensor, world) -> list:
    """Every rank's t (equal shapes), in rank order, on t's device."""
    import torch.distributed as tdist

    t0 = time.perf_counter_ns()
    buf = _to_wire(t, world)
    outs = [torch.empty_like(buf) for _ in range(world.size)]
    tdist.all_gather(outs, buf, group=world.group)
    _finish(world)
    _note_collective(buf.numel() * buf.element_size(), t0)
    return [o.to(t.device).to(t.dtype) for o in outs]


def _reduce(stacked: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """(local shards, ...) partials reduced over every shard of the
    mesh: over this process's shards, then across the processes."""
    local = {"sum": lambda x: x.sum(0), "min": lambda x: x.amin(0),
             "max": lambda x: x.amax(0)}[op](stacked)
    if mesh.world is None:
        return local
    return all_reduce(local, op, mesh.world)


class Sharded:
    """A tensor whose leading axis is split over a mesh's shards: one
    piece per shard of this process, each on its shard's device (the
    port's counterpart of a row-sharded NamedSharding array). Every
    shard holds the same number of rows."""

    __slots__ = ("mesh", "parts")

    def __init__(self, mesh: Mesh, parts):
        self.mesh = mesh
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return ((int(self.parts[0].shape[0]) * self.mesh.size,)
                + tuple(self.parts[0].shape[1:]))

    @property
    def device(self) -> torch.device:
        """This process's first shard's device (where its cross-shard
        merges run)."""
        return self.parts[0].device

    @property
    def nbytes(self) -> int:
        """The bytes resident in this process."""
        return sum(int(p.numel()) * int(p.element_size())
                   for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first local
        shard's); across processes an all_gather of every rank's
        pieces (every rank holds as many, rank-major), so every rank
        calls it."""
        dev = self.device if device is None else torch.device(device)
        world = self.mesh.world
        if world is None:
            return torch.cat([p.to(dev) for p in self.parts])
        mine = torch.cat([p.to(world.device) for p in self.parts])
        return torch.cat(all_gather(mine, world)).to(dev)


def nbytes_of(x) -> int:
    """Bytes of a tensor or of this process's pieces of a Sharded one."""
    if isinstance(x, Sharded):
        return x.nbytes
    return int(x.numel()) * int(x.element_size())


def fetch_np(x) -> np.ndarray:
    """devobs.fetch_np of a tensor, or of the whole of a Sharded one in
    row order (across processes, after its all_gather)."""
    if isinstance(x, Sharded):
        if x.mesh.world is not None:
            return devobs.fetch_np(x.gather())
        return np.concatenate([devobs.fetch_np(p) for p in x.parts])
    return devobs.fetch_np(x)


def per_shard(fn, *args):
    """Run ``fn`` once per shard of this process on that shard's pieces
    of the Sharded arguments (other arguments go to every call as they
    are). A dict result becomes a dict of Sharded."""
    mesh = next(a.mesh for a in args if isinstance(a, Sharded))
    outs = [fn(*[a.parts[i] if isinstance(a, Sharded) else a
                 for a in args]) for i in range(len(mesh.local_shards))]
    if isinstance(outs[0], dict):
        return {k: Sharded(mesh, [o[k] for o in outs]) for k in outs[0]}
    return Sharded(mesh, outs)


def _stack(mesh: Mesh, pieces) -> torch.Tensor:
    """This process's per-shard partials stacked on its first shard's
    device: (local shards, ...)."""
    dev = mesh.local_devices[0]
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


def _merge_time_extreme(value, hi, lo, earliest: bool, mesh: Mesh):
    """Cross-shard lexicographic (hi, lo) winner over (local shards, G)
    partials: exact int32 compares (MIN/MAX on hi, then on lo among the
    hi-winners), exact-time ties to the larger value, remaining ties to
    the lowest global shard — one actual row's value, never an average
    of tied rows."""
    red = "min" if earliest else "max"
    big = _BIG_I32 if earliest else -_BIG_I32
    cand = hi == _reduce(hi, red, mesh)
    lo_best = _reduce(torch.where(cand, lo, big), red, mesh)
    cand &= lo == lo_best
    v_best = _reduce(torch.where(cand, value, -math.inf), "max", mesh)
    cand &= value == v_best
    return _pick(value, _lowest_shard(cand, mesh), mesh)


def _lowest_shard(cand: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One-hot (local shards, G) of the lowest global shard among the
    candidates of every process."""
    shard = torch.tensor(mesh.local_shards, device=cand.device)[:, None]
    best = _reduce(torch.where(cand, shard, _BIG_I32), "min", mesh)
    return cand & (shard == best)


def _pick(x: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The winning shard's x per segment (w: winner one-hot), a masked
    SUM over every shard. where, not a product: inf * 0 would poison the
    sum with NaN."""
    return _reduce(torch.where(w, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device)),
                   "sum", mesh)


def build_dist_agg(mesh: Mesh, num_segments: int):
    """The distributed query step: sharded batch -> {sum, count, mean,
    min, max, first, last} per segment on this process's first shard's
    device, the same on every rank.

    The returned function takes Sharded (values, rel_hi, rel_lo,
    seg_ids, mask), padded to a multiple of the mesh size, computes each
    local shard's partials on its device and merges them over every
    shard."""

    def step(values, rel_hi, rel_lo, seg_ids, mask):
        locs = [_local_partials(*[a.parts[i] for a in
                                  (values, rel_hi, rel_lo, seg_ids, mask)],
                                num_segments)
                for i in range(len(mesh.local_shards))]
        s = _reduce(_stack(mesh, [p[0] for p in locs]), "sum", mesh)
        c = _reduce(_stack(mesh, [p[1] for p in locs]), "sum", mesh)
        mn = _reduce(_stack(mesh, [p[2] for p in locs]), "min", mesh)
        mx = _reduce(_stack(mesh, [p[3] for p in locs]), "max", mesh)
        fv = _merge_time_extreme(
            *[_stack(mesh, [p[4][j] for p in locs]) for j in range(3)],
            earliest=True, mesh=mesh)
        lv = _merge_time_extreme(
            *[_stack(mesh, [p[5][j] for p in locs]) for j in range(3)],
            earliest=False, mesh=mesh)
        mean = s / c.clamp(min=1).to(s.dtype)
        return {"sum": s, "count": c, "mean": mean, "min": mn, "max": mx,
                "first": fv, "last": lv}

    return step


# aggregates the mesh batch step can serve (everything the executor's
# device path computes except rank-based ones — median/percentile — and
# stddev, which keep the single-device kernels)
MESH_AGGS = {"count", "sum", "mean", "min", "max", "first", "last", "spread"}


def _winner(keys, valid: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Cross-shard lexicographic winner one-hot over (local shards, G).
    keys: [(stacked array, minimize)], narrowed key by key over every
    shard; ties resolve to the lowest global shard, so exactly one shard
    wins per segment."""
    cand = valid
    for arr, minimize in keys:
        if arr.dtype.is_floating_point:
            sent = math.inf if minimize else -math.inf
        else:
            sent = _BIG_I32 if minimize else -_BIG_I32
        masked = torch.where(cand, arr, sent)
        best = _reduce(masked, "min" if minimize else "max", mesh)
        cand = cand & (masked == best)
    return _lowest_shard(cand, mesh)


def build_batch_agg(mesh: Mesh, num_segments: int, sel_names: tuple = ()):
    """The executor's aggregate batch step over a mesh: the multi-shard
    equivalent of templates.AggBatch's single-device aggregates.

    Takes Sharded (values, rel_hi, rel_lo, seg_ids, mask, global_idx)
    and returns per-segment outputs on this process's first shard's
    device, the same on every rank. count/sum/mean and min/max/spread
    values merge by adding and reducing; the winner merge runs only for
    the selectors in `sel_names`, whose ``<name>_sel`` outputs are global
    row indices, the single-device sel contract."""

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
        totc = _reduce(st["count"], "sum", mesh)
        tots = _reduce(st["sum"], "sum", mesh)
        mn = _reduce(st["min"], "min", mesh)
        mx = _reduce(st["max"], "max", mesh)
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
            w = _winner(keys, valid, mesh)
            out[name] = _pick(v, w, mesh)
            out[name + "_sel"] = _pick(st[name + "_gsel"], w, mesh)
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
    each shard's kernels need no merge, and the shards' (rows,)-shaped
    outputs come back whole (``fetch_np``).

    Rows are padded with zeros (masked out by the kernels' mask plane or
    sliced off by the [:g] caller convention) to a multiple of
    mesh.size. Every rank passes the same host arrays and ships only its
    own shards' rows."""
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
            for i, dev in zip(mesh.local_shards, mesh.local_devices)]
        out.append(Sharded(mesh, parts))
        nbytes += sum(int(p.numel()) * int(p.element_size())
                      for p in parts)
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
    one device holds both layouts only while it copies. Across processes
    the rows move between ranks over the process group (an all_gather
    of the old layout, of which each rank keeps its new shards' rows and
    drops the rest), so every rank reshards in step."""
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
                          for i, dev in zip(mesh.local_shards,
                                            mesh.local_devices)])
