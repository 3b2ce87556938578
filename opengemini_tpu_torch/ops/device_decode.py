"""Device-side decode of TSF device-profile blocks, fused into the grid
aggregation data path.

The port of ``opengemini_tpu/ops/device_decode.py``. A cold scan over files written
with the device profile (storage/encoding.py, ``OGT_DEVICE_PROFILE=1``)
ships the ENCODED value bytes — plus the scatter slots (or per-run
scalars that rebuild them) and packed mask bits — to the card, and one
sequence of launches on the current stream decodes them, scatters the
values into the (S_pad, k, W_pad) grid and runs the grid window reduce
(kernel 3): no decoded column ever materializes on the host.

Decodable block kinds (encoding.DeviceBlock), each bit-identical to the
host decoders:

  const    first + step * iota — no payload
  delta    frame-of-reference deltas at a fixed byte width: widen
           (kernel 4, ``cuda_segment.widen_packed_segments``: every
           width-1/2 block of a plan in one launch), +step, one int64
           cumsum over the plan, each block's start subtracted, +first
  raw64    little-endian float64 values: an 8-byte reinterpretation
  gorilla  XOR-compressed float64: a host structural scan walks the
           control bits once per block (cached) and emits per-value
           (bitpos, mbits, shift) vectors; the card unpacks a chunk of
           whole blocks to bits in one launch (kernel 5,
           ``cuda_segment.unpack_bits_segments``), gathers each value's
           meaningful bits into bit planes and rebuilds the words with
           one prefix XOR over the chunk
  varint   delta+zigzag LEB128 int64: terminator bytes mark value ids, a
           segmented shift/or rebuilds each varint, zigzag and a
           wrapping int64 cumsum follow
  strdict  dictionary-coded strings: the min-width index array widens on
           the card (in the plan's one widen launch at widths 1 and 2);
           the table stays on the host

Unsigned 64-bit words are carried in int64: every shift of a set bit is
a left shift (whose overflow torch defines as the unsigned result), a
logical right shift masks off the sign fill, and a sum of distinct bits
that wraps gives the same bit pattern as the uint64 sum.

Kernels 4 and 5 run only where the capability probe (kernel 6,
utils/devobs.probe) ran and counted right; a failed probe raises. Every
other step is plain torch on the device, batched over a plan (FOR-delta)
or a chunk (gorilla) like the kernels, so a decode's launches grow with
its chunks, not its blocks. On a CPU device the wrappers take their
plain versions, which is how the tests run this module against the JAX
package.

Counters (utils.stats.GLOBAL, module ``device``): decode_blocks_total,
decode_payload_bytes_total, decode_rows_total, decode_fallbacks_total,
and per codec decode_blocks_<codec>_total /
decode_payload_bytes_<codec>_total. Transfers land on the
``device-decode`` site of devobs.note_transfer. The fused site's first
run at a geometry is its "compile" (utils/devobs.py:
``grid_decode_fused``, ``grid_decode_imat``, ``device_decode``); every
fused run counts a ``note_use`` and registers the site's pre-warm
builder (``plan_builder``: a first run on zeros of the plan's shapes).

Knobs, read fresh every plan: ``OGT_DEVICE_DECODE`` (0 = every plan
answers None, so the grid decodes on the host) and
``OGT_DEVICE_DECODE_CODECS`` (a comma list of the block kinds allowed
to decode on the card; unset means all). They are routes, not
fallbacks: a kernel that fails to build or launch raises.

The cost gate is the offload planner's zero-sample prior
(query/offload.py ``gate_prior``).

Under a device mesh (parallel/runtime.py) a plan splits by output row
shard (``build_mesh_grid_plan``): the scatter rows are in order, so each
shard owns one contiguous span of rows, blocks and payload bytes. A
block that spans two shards is cut at value granularity
(``_slice_block``), each piece carrying its seed: gorilla the decoded
bit pattern of the value before the cut (XORed into the piece's scan),
varint that value (added to its cumsum), FOR-delta its first value.
Each shard's plan is an ordinary single-device plan on its shard's
device, so each shard decodes its rows with kernels 5 and 4 and reduces
them with kernel 3, straight into its piece of the sharded grid
(``run_mesh_grid_plan``; its transfers count on ``mesh_h2d_bytes`` and
carry the ``mesh="on"`` label).

The PromQL tiled kernels take their (series, samples) value matrix from
``decode_rows_matrix``: the same decode, each series' slice of the
decoded column laid into a zero-padded row (site ``prom_decode_rows``,
gated by ``gate_prior("prom_decode_rows", ...)``); ``materialize_enc``
is its bit-identical host decode.
"""

from __future__ import annotations

import functools
import os
import struct
import time

import numpy as np
import torch

from opengemini_tpu_torch.ops import cuda_segment
from opengemini_tpu_torch.query import offload
from opengemini_tpu_torch.storage import encoding
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

# the most blocks a plan decodes on the card: one segmented launch
# carries every width-1/2 block of a plan in its parameters, and the
# kernels take at most this many rows (cuda_segment.MAX_SEGMENTS); the
# host decode handles the long tail
_MAX_BLOCKS = cuda_segment.MAX_SEGMENTS
# consecutive gorilla blocks decode in chunks of at most this many values
# (a chunk ends only at a block boundary): one unpack launch and one
# batch of gather and scan ops each. The gather's (values, 64)
# temporaries take 256 B per value as int32 bit indices and 64 B as
# uint8 bit planes: 256 and 64 MiB at 2^20 values (8 blocks of 131072),
# a few alive at once
_CHUNK_VALUES = 1 << 20
# the prefix XOR scans rows of this many values, one sequential scan per
# row and bit: long enough rows keep the scan of the row totals short
_SCAN_ROW = 1024
# sum of 2^(56 - 7k), k = 0..7: times a word of eight 0/1 bytes it puts
# byte k's bit at bit 56 + k (the other partial products are distinct
# powers below bit 56 or past bit 63)
_GATHER_BITS = 0x0102040810204080

_XFER_SITE = "device-decode"
_ALL_CODECS = ("const", "delta", "raw64", "gorilla", "varint", "strdict")


def enabled() -> bool:
    """The OGT_DEVICE_DECODE knob alone."""
    return os.environ.get("OGT_DEVICE_DECODE", "1") not in ("", "0")


def active() -> bool:
    """Device decode usable in this process: the OGT_DEVICE_DECODE knob
    (the JAX package also asks for x64 and a backend; torch has both)."""
    return enabled()


def codecs_enabled() -> frozenset:
    """The block kinds allowed to decode on the card
    (OGT_DEVICE_DECODE_CODECS, a comma list; unset or empty means all).
    Read fresh every plan: pin a suspect codec to the host path live."""
    raw = os.environ.get("OGT_DEVICE_DECODE_CODECS", "")
    if not raw.strip():
        return frozenset(_ALL_CODECS)
    return frozenset(t.strip().lower() for t in raw.split(",") if t.strip())
_INT64_MAX = (1 << 63) - 1
_TORCH_DTYPE = {np.dtype(np.float64): torch.float64,
                np.dtype(np.int64): torch.int64}


@functools.lru_cache(maxsize=1024)
def _gorilla_scan(payload: bytes, n: int):
    """Host structural scan of one gorilla XOR stream: the control bits
    are inherently sequential, so the host walks them ONCE per block
    (cached on the payload bytes) and emits the per-value vectors the
    data-parallel device decode needs — bitpos (where each value's
    meaningful-bit window starts), mbits (its length; 0 marks a repeat),
    shift (its trailing-zero shift). Value 0 is the raw 64-bit first
    value (mbits=64, shift=0). Returns (bitpos int32, mbits uint8, shift
    uint8, vals uint64), vals[i] the decoded bit pattern of value i, or
    None when the stream is malformed.

    The walk and its bounds checks are the JAX package's, in C++
    (native/gorillascan.cpp): the walk is one step per value, which in
    Python dominated a cold query's first run."""
    from opengemini_tpu_torch import native

    return native.gorilla_scan(payload, n)


def _varint_ok(payload: bytes, n: int) -> bool:
    """Shape-validate a varint stream on the host (vectorized): exactly
    n terminator bytes, the stream ends on one, and every varint is at
    most 10 bytes (so the 7*offset shifts stay in range)."""
    b = np.frombuffer(payload, np.uint8)
    ends = np.flatnonzero((b & 0x80) == 0)
    if len(ends) != n or (n and ends[-1] != len(b) - 1):
        return False
    if n == 0:
        return len(b) == 0
    lens = np.diff(np.concatenate(([np.int64(-1)], ends)))
    return bool((lens <= 10).all())


def classify(blocks) -> list | None:
    """DeviceBlock views of every raw block buffer, or None when any
    block (or the block count) is not device-decodable — including
    kinds excluded by OGT_DEVICE_DECODE_CODECS and streams whose host
    structural validation fails."""
    if len(blocks) > _MAX_BLOCKS:
        return None
    allowed = codecs_enabled()
    out = []
    for buf in blocks:
        if isinstance(buf, encoding.DeviceBlock):
            db = buf  # a block a mesh shard cut; the knob still applies
        else:
            db = encoding.device_block(buf)
        if db is None or db.kind not in allowed:
            return None
        if db.kind == "gorilla":
            # a cut block carries its scan (aux); whole blocks scan here
            if db.aux is None and \
                    _gorilla_scan(bytes(db.payload), db.n) is None:
                return None
        elif db.kind == "varint":
            if not _varint_ok(bytes(db.payload), db.n):
                return None
        elif db.kind == "strdict" and len(db.payload) != db.n * db.width:
            return None
        out.append(db)
    return out


def _pack_blocks(dbs):
    """(sig, payload, scalars, aux32, aux8) of classified DeviceBlocks —
    the block assembly every plan shares. aux32/aux8 carry the gorilla
    structural-scan vectors (bitpos; interleaved mbits, shift) and are
    None when no block needs them."""
    sig = tuple((b.kind, b.n, b.width) for b in dbs)
    payload = np.frombuffer(  # writable: torch.from_numpy takes it as is
        bytearray(b"".join(bytes(b.payload) for b in dbs)), np.uint8)
    scalars = np.array([[b.first, b.step] for b in dbs],
                       np.int64).reshape(len(dbs), 2)
    aux32 = aux8 = None
    if any(b.kind == "gorilla" for b in dbs):
        p32, p8 = [], []
        for b in dbs:
            if b.kind != "gorilla":
                continue
            if b.aux is not None:
                bitpos, mbits, shift = b.aux
            else:
                bitpos, mbits, shift, _ = _gorilla_scan(bytes(b.payload),
                                                        b.n)
            p32.append(bitpos)
            p8.append(np.stack([mbits, shift], axis=1).reshape(-1))
        aux32 = np.concatenate(p32) if p32 else np.zeros(0, np.int32)
        aux8 = np.concatenate(p8) if p8 else np.zeros(0, np.uint8)
    return sig, payload, scalars, aux32, aux8


def note_fallback(n: int = 1) -> None:
    """Count an eligible-looking encoded scan that ended up on the host
    decode path anyway (ineligible blocks, cost gate)."""
    STATS.incr("device", "decode_fallbacks_total", n)


def _payload_nbytes(kind: str, n: int, width: int) -> int:
    if kind == "const":
        return 0
    if kind == "delta":
        return (n - 1) * width if n else 0
    if kind == "raw64":
        return 8 * n
    if kind == "strdict":
        return n * width
    return width  # gorilla/varint: width IS the payload byte length


def _note_decode_stats(sig, rows: int) -> None:
    STATS.incr("device", "decode_blocks_total", len(sig))
    total = 0
    for kind, bn, width in sig:
        nb = _payload_nbytes(kind, bn, width)
        total += nb
        STATS.incr("device", f"decode_blocks_{kind}_total")
        STATS.incr("device", f"decode_payload_bytes_{kind}_total", nb)
    STATS.incr("device", "decode_payload_bytes_total", total)
    STATS.incr("device", "decode_rows_total", rows)


class GridPlan:
    """Host-side inputs + geometry of one fused decode -> scatter ->
    reduce run. The scatter slots travel either as an explicit int32
    `flat` array (4 bytes/row) or — when every series run is
    constant-stride and the window arithmetic verifies on the host — as
    `runmeta` (rel0, stride, start_row) int64 triples plus one phase
    scalar, rebuilt on the card."""

    __slots__ = ("geom", "payload", "scalars", "aux32", "aux8",
                 "viewruns", "flat", "runmeta", "consts", "maskbits", "n",
                 "device")

    def __init__(self, geom, payload, scalars, aux32, aux8, viewruns,
                 flat, runmeta, consts, maskbits, n, device):
        self.geom = geom
        self.payload = payload
        self.scalars = scalars
        self.aux32 = aux32
        self.aux8 = aux8
        self.viewruns = viewruns
        self.flat = flat
        self.runmeta = runmeta
        self.consts = consts
        self.maskbits = maskbits
        self.n = n
        self.device = device

    def transfer_nbytes(self) -> int:
        nb = int(self.payload.nbytes) + int(self.scalars.nbytes)
        for a in (self.aux32, self.aux8, self.viewruns, self.flat,
                  self.runmeta, self.consts, self.maskbits):
            if a is not None:
                nb += int(a.nbytes)
        return nb


def _affine_scatter(flat, rel, starts, every_ns, dt, k, w_pad):
    """(runmeta, consts) when the scatter slots are rebuildable on the
    card from per-run scalars, else None. Every requirement is VERIFIED
    on the host against the actual arrays: every run's times are affine
    (rel0 + j*stride) and the window ordinal follows one global phase,
    w == (rel - woff) // every; then the card recomputes
    flat = (rid*k + (rel - w*every)//dt)*w_pad + w exactly."""
    n = len(rel)
    runs = len(starts)
    if n == 0 or runs == 0 or every_ns is None or not every_ns or not dt:
        return None
    lens = np.diff(np.append(starts, n))
    rel0 = rel[starts]
    stride = np.zeros(runs, np.int64)
    multi = lens > 1
    if multi.any():
        d = np.diff(rel)
        stride[multi] = d[starts[multi]]
    rid = np.repeat(np.arange(runs, dtype=np.int64), lens)
    j = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
    if not np.array_equal(rel0[rid] + j * stride[rid], rel):
        return None  # gaps / irregular spacing inside a run
    w = flat % w_pad
    # any valid window phase woff satisfies woff + w*every <= rel <
    # woff + (w+1)*every for EVERY row; the supremum min(rel - w*every)
    # is valid whenever any is, and the checks below reject the rest
    woff = int((rel - w * every_ns).min())
    if not np.array_equal((rel - woff) // every_ns, w):
        return None
    r = (rel - w * every_ns) // dt
    if not np.array_equal((rid * k + r) * w_pad + w, flat):
        return None
    runmeta = np.stack([rel0, stride, starts.astype(np.int64)], axis=1)
    return runmeta, np.array([woff], np.int64)


def combine_views(views):
    """Flatten per-column (blocks, segments, n_full) views into one
    block list plus the absolute row runs of the combined view over the
    combined decode (adjacent runs merged; None = identity). Returns
    (blocks, runs|None, n_view, n_full)."""
    blocks: list = []
    runs = []
    base = 0
    n_view = 0
    for vb, segs, n_full in views:
        blocks.extend(vb)
        for a, b in np.asarray(segs, np.int64).tolist():
            a, b = a + base, b + base
            n_view += b - a
            if runs and runs[-1][1] == a:
                runs[-1][1] = b  # adjacent runs merge
            else:
                runs.append([a, b])
        base += int(n_full)
    if not runs or (len(runs) == 1 and runs[0] == [0, base]):
        return blocks, None, n_view, base  # identity (or empty) view
    return blocks, np.asarray(runs, np.int64), n_view, base


def build_grid_plan(views, flat, mask, shape, dtype, device, rel=None,
                    starts=None, every_ns=None, dt=None) -> GridPlan | None:
    """Plan the fused decode for one frozen grid: `views` are the
    still-encoded value columns' (blocks, segments, n_full) triples in
    row order, `flat` the host-computed scatter slots (injective,
    < prod(shape)), `mask` the row validity. `rel`/`starts`/`every_ns`/
    `dt` (the freeze's run layout) enable the per-run scatter rebuild.
    Returns None when OGT_DEVICE_DECODE is off, the blocks are not
    device-decodable or the transfer would not beat the decoded grid —
    the caller then decodes on the host exactly as before."""
    if not enabled():
        return None
    blocks, viewruns, n_view, n_full = combine_views(views)
    dbs = classify(blocks)
    if dbs is None:
        note_fallback()
        return None
    if sum(b.n for b in dbs) != n_full or n_view != len(flat):
        note_fallback()
        return None  # defensive: blocks must cover the view exactly
    sig, payload, scalars, aux32, aux8 = _pack_blocks(dbs)
    maskbits = None
    if mask is not None and not mask.all():
        maskbits = np.packbits(np.asarray(mask, np.bool_))
    affine = None
    if rel is not None and starts is not None:
        affine = _affine_scatter(flat, rel, np.asarray(starts),
                                 every_ns, dt, shape[1], shape[2])
    if affine is not None:
        runmeta, consts = affine
        flat32 = None
    else:
        runmeta = consts = None
        flat32 = np.ascontiguousarray(flat, np.int32)
    geom = (sig, n_view, tuple(shape), np.dtype(dtype).str,
            every_ns if affine is not None else None,
            dt if affine is not None else None)
    plan = GridPlan(geom, payload, scalars, aux32, aux8, viewruns, flat32,
                    runmeta, consts, maskbits, n_view, torch.device(device))
    # the offload planner's zero-sample prior: the fused path must shrink
    # the transfer below the decoded grid it replaces (values + mask
    # bytes per padded cell); once the planner holds wall samples of the
    # device route at this geometry, its decide() owns the choice
    if not offload.GLOBAL.gate_prior(
            "grid_decode", geom, plan.transfer_nbytes(),
            int(np.prod(shape)) * 9):
        note_fallback()
        return None
    return plan


def _to_dev(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _prewarm_geo(geom) -> tuple:
    """The fused site's inventory and pre-warm key of a plan geometry:
    (blocks, rows, shape, dtype, affine scatter)."""
    sig, n, shape, dtype_str, every_ns, _dt = geom
    return (len(sig), n, shape, dtype_str, every_ns is not None)


def run_grid_plan(plan: GridPlan):
    """Execute the fused decode: one host-to-device copy of each encoded
    input (site `device-decode`), then decode + scatter + the grid
    window reduce, all queued on the current stream. Returns
    ({count,sum,mean,min,max} device tensors, vt, mt, flat): vt/mt are
    the decoded grid buffers, ready for the ssd and selector groups;
    flat is the device-resident scatter-slot vector (imat_from_flat
    builds the selector index grid from it)."""
    t0 = time.perf_counter_ns()
    inputs = _plan_to_dev(plan)
    # what crosses: every input but the per-block scalars and the window
    # phase, which stay host ints (no launch waits on reading them back)
    devobs.note_transfer("h2d", _XFER_SITE, sum(
        int(a.nbytes) for a in (plan.payload, plan.aux32, plan.aux8,
                                plan.viewruns, plan.flat, plan.runmeta,
                                plan.maskbits) if a is not None),
        (time.perf_counter_ns() - t0) / 1e9)
    _note_decode_stats(plan.geom[0], plan.n)
    pw_geo = _prewarm_geo(plan.geom)
    devobs.note_use("grid_decode_fused", pw_geo)
    offload.register_builder("grid_decode_fused", pw_geo,
                             plan_builder(plan))
    with devobs.first_run("grid_decode_fused", pw_geo, plan.device):
        return _run_fused(plan, *inputs)


def _plan_to_dev(plan: GridPlan) -> tuple:
    """(payload, aux32, aux8, viewruns, flat, runmeta, maskbits) on the
    plan's device, None where the plan has none."""
    return tuple(None if a is None else _to_dev(a, plan.device)
                 for a in (plan.payload, plan.aux32, plan.aux8,
                           plan.viewruns, plan.flat, plan.runmeta,
                           plan.maskbits))


def _run_fused(plan: GridPlan, payload, aux32, aux8, viewruns, flat,
               runmeta, maskbits):
    dev = plan.device
    sig, n, shape, dtype_str, every_ns, dt = plan.geom
    out_dt = _TORCH_DTYPE[np.dtype(dtype_str)]
    vals = _decode(sig, out_dt, payload, plan.scalars, aux32, aux8)
    if viewruns is not None:
        vals = _view_gather(vals, viewruns, n)
    if flat is not None:
        flat = flat.to(torch.int64)
    else:
        flat = _affine_slots(runmeta, int(plan.consts[0]), n, shape,
                             every_ns, dt)
    cells = int(np.prod(shape))
    vt = torch.zeros(cells, dtype=out_dt, device=dev)
    vt[flat] = vals
    if maskbits is not None:
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        mrow = ((maskbits[:, None] >> shifts) & 1).reshape(-1)[:n].to(
            torch.bool)
    else:
        mrow = torch.ones(n, dtype=torch.bool, device=dev)
    mt = torch.zeros(cells, dtype=torch.bool, device=dev)
    mt[flat] = mrow
    vt, mt = vt.reshape(shape), mt.reshape(shape)
    stats = cuda_segment.grid_window_agg(vt, mt)
    return stats, vt, mt, flat


def plan_builder(plan: GridPlan):
    """The fused site's pre-warm builder at `plan`'s geometry: a zero-
    argument callable that runs the site once on zeros of the plan's
    shapes — never on the query's data or tensors — unless the site
    already ran at that geometry. It keeps the array sizes and the view
    runs (which index the decoded blocks), not the payload. In the
    zeros, each varint block's bytes end in exactly its value count of
    terminators and the scatter slots stay inside the grid."""
    if isinstance(plan, MeshGridPlan):
        builders = [plan_builder(p) for p in plan.shards]
        return lambda: [b() for b in builders]
    pw_geo = _prewarm_geo(plan.geom)
    geom, n, device, consts = plan.geom, plan.n, plan.device, plan.consts
    sizes = {k: None if a is None else a.shape
             for k, a in (("payload", plan.payload),
                          ("scalars", plan.scalars), ("aux32", plan.aux32),
                          ("aux8", plan.aux8), ("flat", plan.flat),
                          ("runmeta", plan.runmeta),
                          ("maskbits", plan.maskbits))}
    viewruns = None if plan.viewruns is None else plan.viewruns.copy()

    def build() -> None:
        if devobs.has_run("grid_decode_fused", pw_geo):
            return
        z = {k: None if sh is None else np.zeros(
            sh, {"payload": np.uint8, "aux32": np.int32, "aux8": np.uint8,
                 "flat": np.int32, "maskbits": np.uint8}.get(k, np.int64))
             for k, sh in sizes.items()}
        off = 0
        for kind, bn, width in geom[0]:
            m = _payload_nbytes(kind, bn, width)
            if kind == "varint" and bn:
                z["payload"][off:off + m - bn] = 0x80  # continuation bytes
            off += m
        zplan = GridPlan(geom, z["payload"], z["scalars"], z["aux32"],
                         z["aux8"], viewruns, z["flat"], z["runmeta"],
                         None if consts is None else np.zeros_like(consts),
                         z["maskbits"], n, device)
        with devobs.first_run("grid_decode_fused", pw_geo, device):
            _run_fused(zplan, *_plan_to_dev(zplan))

    return build


def _affine_slots(runmeta, woff: int, n: int, shape, every_ns: int,
                  dt: int) -> torch.Tensor:
    """Scatter slots rebuilt on the card from (rel0, stride, start_row)
    per run and the global window phase."""
    _s, k, w_pad = shape
    ar = torch.arange(n, dtype=torch.int64, device=runmeta.device)
    starts = runmeta[:, 2].contiguous()
    rid = torch.searchsorted(starts, ar, right=True) - 1
    rel = runmeta[:, 0][rid] + (ar - starts[rid]) * runmeta[:, 1][rid]
    w = torch.div(rel - woff, every_ns, rounding_mode="floor")
    r = torch.div(rel - w * every_ns, dt, rounding_mode="floor")
    return (rid * k + r) * w_pad + w


def imat_from_flat(flat_dev: torch.Tensor, shape) -> torch.Tensor:
    """Selector index grid (sample ordinal per grid slot) from the
    device-resident scatter slots a fused decode left behind — no host
    imat build and no full-grid transfer."""
    n = int(flat_dev.shape[0])
    with devobs.first_run("grid_decode_imat", (n, tuple(shape)),
                          flat_dev.device):
        imat = torch.zeros(int(np.prod(shape)), dtype=torch.int32,
                           device=flat_dev.device)
        imat[flat_dev] = torch.arange(n, dtype=torch.int32,
                                      device=flat_dev.device)
    return imat.reshape(shape)


class MeshGridPlan:
    """One fused-decode plan per mesh shard, plus the global geometry the
    assembly needs. Each shard's GridPlan is self-contained (its own
    blocks, scatter slots rebased to the shard's first row, per-shard
    affine runs) on its shard's device, so a shard runs exactly the
    single-device fused path: the split is pure input partitioning."""

    __slots__ = ("mesh", "shards", "shape", "dtype_str", "n")

    def __init__(self, mesh, shards, shape, dtype_str, n):
        self.mesh = mesh
        self.shards = shards
        self.shape = shape
        self.dtype_str = dtype_str
        self.n = n

    def transfer_nbytes(self) -> int:
        return sum(p.transfer_nbytes() for p in self.shards)


@functools.lru_cache(maxsize=1024)
def _varint_scan(payload: bytes, n: int):
    """Host byte structure and values of one varint block: (ends, vals),
    ends[i] the byte index of value i's terminator byte and vals[i] its
    decoded int64. A shard cuts the byte stream at ends and seeds the
    device cumsum with vals[lo-1]."""
    b = np.frombuffer(payload, np.uint8)
    ends = np.flatnonzero((b & 0x80) == 0).astype(np.int64)
    vals = encoding.decode_ints(
        struct.pack("<BI", encoding._T_VARINT, n) + payload)
    return ends, np.asarray(vals, np.int64)


@functools.lru_cache(maxsize=1024)
def _delta_vals(payload: bytes, n: int, first: int, step: int,
                width: int):
    """Host-decoded int64 values of one FOR-delta block (the host
    decode's arithmetic: zero-extended widen, +step, wrapping cumsum,
    +first); a shard's cut reseeds its `first` from vals[lo]."""
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[width]
    d = np.frombuffer(payload[:(n - 1) * width], dtype=dt).astype(np.int64)
    out = np.empty(n, np.int64)
    out[0] = first
    if n > 1:
        np.cumsum(d + step, out=out[1:])
        out[1:] += first
    return out


def _wrap_i64(v) -> int:
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


def _slice_block(db, lo: int, hi: int):
    """A DeviceBlock of values [lo, hi) of `db` that ships ONLY the
    payload bytes those values need, so a shard whose span ends inside a
    block does not carry the whole stream. Stateful codecs carry their
    seed in `first` (gorilla: the decoded bit pattern of value lo-1,
    XORed into the device scan; varint: the int64 value lo-1, added to
    the device cumsum), and gorilla pieces carry their part of the
    structural scan as `aux` (the control bits are sequential, so a
    mid-stream payload cannot be scanned again). None when the codec
    cannot cut (the caller decodes on the host)."""
    n = hi - lo
    if lo == 0 and hi == db.n:
        return db
    if db.kind == "const":
        return encoding.DeviceBlock(
            "const", n, _wrap_i64(db.first + db.step * lo), db.step)
    if db.kind == "raw64":
        return encoding.DeviceBlock(
            "raw64", n, payload=db.payload[8 * lo:8 * hi])
    if db.kind == "strdict":
        w = db.width
        return encoding.DeviceBlock(
            "strdict", n, width=w, payload=db.payload[w * lo:w * hi],
            table=db.table)
    if db.kind == "delta":
        vals = _delta_vals(bytes(db.payload), db.n, db.first, db.step,
                           db.width)
        # the payload keeps deltas for piece indices 1..n-1 = global
        # lo+1..hi-1; delta j lives at payload[(j-1)*width:]
        return encoding.DeviceBlock(
            "delta", n, int(vals[lo]), db.step, db.width,
            db.payload[lo * db.width:(hi - 1) * db.width])
    if db.kind == "varint":
        ends, vals = _varint_scan(bytes(db.payload), db.n)
        b0 = 0 if lo == 0 else int(ends[lo - 1]) + 1
        sub = db.payload[b0:int(ends[hi - 1]) + 1]
        seed = 0 if lo == 0 else int(vals[lo - 1])
        return encoding.DeviceBlock(
            "varint", n, seed, width=len(sub), payload=sub)
    if db.kind == "gorilla":
        scan = _gorilla_scan(bytes(db.payload), db.n)
        if scan is None:
            return None
        bitpos, mbits, shift, vals = scan
        mb = mbits[lo:hi].astype(np.int32)
        sel = mb > 0
        if sel.any():
            bp = bitpos[lo:hi].astype(np.int64)
            b0 = int(bp[sel].min()) >> 3
            b1 = (int((bp[sel] + mb[sel]).max()) + 7) >> 3
            sub = db.payload[b0:b1]
            bp = np.where(sel, bp - 8 * b0, 0).astype(np.int32)
        else:  # a pure repeat run: every value IS the seed
            sub = b""
            bp = np.zeros(n, np.int32)
        seed = 0 if lo == 0 else _wrap_i64(vals[lo - 1])
        return encoding.DeviceBlock(
            "gorilla", n, seed, width=len(sub), payload=sub,
            aux=(bp, mbits[lo:hi].copy(), shift[lo:hi].copy()))
    return None


def build_mesh_grid_plan(views, flat, mask, shape, dtype, mesh, rel=None,
                         starts=None, every_ns=None,
                         dt=None) -> MeshGridPlan | None:
    """Split one fused grid-decode plan by output row shard. The scatter
    rows (flat // (k*W_pad)) never decrease (series runs come in row
    order), so each shard owns one CONTIGUOUS span of data rows, which
    maps to a contiguous span of view rows, blocks and payload bytes:
    every shard's input is a slice and rebase of the whole plan's, built
    through build_grid_plan on the shard's device (same checks, same
    per-shard cost gate). None when the rows cannot split cleanly or any
    shard refuses: the caller then scatters on the host."""
    if not enabled():
        return None
    S_pad, k, w_pad = shape
    nsh = int(mesh.size)
    if S_pad % nsh:
        return None
    rows_per = S_pad // nsh
    blocks, viewruns, n_view, n_full = combine_views(views)
    dbs = classify(blocks)
    if dbs is None or sum(b.n for b in dbs) != n_full \
            or n_view != len(flat):
        note_fallback()
        return None
    flat = np.asarray(flat, np.int64)
    row_of = flat // (k * w_pad)
    if len(row_of) and (np.diff(row_of) < 0).any():
        note_fallback()
        return None  # rows out of order: no contiguous shard spans
    cuts = np.concatenate((
        [0], np.searchsorted(row_of, np.arange(1, nsh) * rows_per),
        [n_view])).astype(np.int64)
    mask = None if mask is None else np.asarray(mask, bool)
    rel = None if rel is None else np.asarray(rel, np.int64)
    starts = None if starts is None else np.asarray(starts, np.int64)
    # block offsets in FULL (concatenated-decode) coordinates, and the
    # view runs as explicit [lo, hi) full-coordinate spans
    boffs = np.cumsum([0] + [b.n for b in dbs]).astype(np.int64)
    vruns = (np.array([[0, n_full]], np.int64) if viewruns is None
             else np.asarray(viewruns, np.int64))
    run_len = vruns[:, 1] - vruns[:, 0]
    run_end_v = np.cumsum(run_len)  # view-coordinate run ends
    run_start_v = run_end_v - run_len
    shards = []
    for s, device in enumerate(mesh.shard_devices):
        a, b = int(cuts[s]), int(cuts[s + 1])
        sub_views: list = []
        if a < b:
            i0 = int(np.searchsorted(run_end_v, a, side="right"))
            i1 = int(np.searchsorted(run_start_v, b, side="left"))
            lo_f = vruns[i0:i1, 0] + np.maximum(a - run_start_v[i0:i1], 0)
            hi_f = vruns[i0:i1, 0] + np.minimum(b - run_start_v[i0:i1],
                                                run_len[i0:i1])
            span_lo, span_hi = int(lo_f[0]), int(hi_f[-1])
            jmin = int(np.searchsorted(boffs, span_lo, side="right")) - 1
            jmax = int(np.searchsorted(boffs, span_hi - 1,
                                       side="right")) - 1
            # cut boundary blocks at value granularity: a block over
            # several shards must not ship whole to each
            sub_blocks = []
            for j in range(jmin, jmax + 1):
                o = int(boffs[j])
                sb = _slice_block(dbs[j], max(span_lo - o, 0),
                                  min(span_hi, int(boffs[j + 1])) - o)
                if sb is None:
                    note_fallback()
                    return None
                sub_blocks.append(sb)
            segs = np.stack([lo_f - span_lo, hi_f - span_lo], axis=1)
            sub_views = [(sub_blocks, segs, span_hi - span_lo)]
        plan = build_grid_plan(
            sub_views, flat[a:b] - s * rows_per * k * w_pad,
            None if mask is None else mask[a:b],
            (rows_per, k, w_pad), dtype, device,
            rel=None if rel is None else rel[a:b],
            starts=None if starts is None else
            starts[(starts >= a) & (starts < b)] - a,
            every_ns=every_ns, dt=dt)
        if plan is None:
            note_fallback()
            return None
        shards.append(plan)
    return MeshGridPlan(mesh, shards, tuple(shape), np.dtype(dtype).str,
                        n_view)


def run_mesh_grid_plan(mplan: MeshGridPlan):
    """Run each shard's fused decode on its device: one host-to-device
    copy of each shard's encoded inputs (only its own bytes), then the
    same decode, scatter and grid reduce as run_grid_plan. Returns
    (stats, vt, mt, None), each a Sharded over the mesh: vt/mt ready for
    the mesh layout of the colcache device tier and the per-shard ssd
    and selector groups."""
    from opengemini_tpu_torch.parallel import distributed

    t0 = time.perf_counter_ns()
    shard_in = [_plan_to_dev(plan) for plan in mplan.shards]
    nbytes = mplan.transfer_nbytes()
    # every byte here is a cold transfer a warm mesh repeat must NOT pay
    # (the sharded device tier retains vt/mt)
    STATS.incr("device", "mesh_h2d_bytes", nbytes)
    devobs.note_transfer("h2d", _XFER_SITE, nbytes,
                         (time.perf_counter_ns() - t0) / 1e9, mesh=True)
    outs = []
    for plan, ins in zip(mplan.shards, shard_in):
        _note_decode_stats(plan.geom[0], plan.n)
        pw_geo = _prewarm_geo(plan.geom)
        devobs.note_use("grid_decode_fused", pw_geo)
        with devobs.first_run("grid_decode_fused", pw_geo, plan.device):
            outs.append(_run_fused(plan, *ins))
    mesh = mplan.mesh
    stats = {key: distributed.Sharded(mesh, [o[0][key] for o in outs])
             for key in outs[0][0]}
    vt = distributed.Sharded(mesh, [o[1] for o in outs])
    mt = distributed.Sharded(mesh, [o[2] for o in outs])
    return stats, vt, mt, None


def decode_to_device(blocks, device, dtype=None) -> torch.Tensor:
    """Standalone device decode of raw block buffers -> one value tensor
    on `device` (int64/float64, or `dtype` when given): the non-fused
    entry point the tests hold against the host decoders."""
    dbs = classify(blocks)
    if dbs is None:
        raise ValueError("blocks are not device-decodable")
    out_dtype = np.dtype(dtype) if dtype is not None else (
        np.dtype(np.float64)
        if any(b.kind in ("raw64", "gorilla") for b in dbs)
        else np.dtype(np.int64))
    sig, payload, scalars, aux32, aux8 = _pack_blocks(dbs)
    devobs.note_transfer("h2d", _XFER_SITE, sum(
        int(a.nbytes) for a in (payload, aux32, aux8) if a is not None))
    with devobs.first_run(
            "device_decode", (len(sig), sum(b[1] for b in sig),
                              out_dtype.str), device):
        return _decode(
            sig, _TORCH_DTYPE[out_dtype], _to_dev(payload, device),
            scalars, None if aux32 is None else _to_dev(aux32, device),
            None if aux8 is None else _to_dev(aux8, device))


# -- per-block decode on the device -------------------------------------------


def _view_gather(vals_full, viewruns, n_view: int):
    """Gather a column VIEW (absolute [lo, hi) row runs) out of the
    decoded block concatenation, on the card."""
    run_len = viewruns[:, 1] - viewruns[:, 0]
    ends = torch.cumsum(run_len, 0)
    pos = torch.arange(n_view, dtype=torch.int64, device=vals_full.device)
    rid = torch.searchsorted(ends, pos, right=True)
    start_out = ends - run_len
    return vals_full[viewruns[rid, 0] + pos - start_out[rid]]


def _widen(raw, width: int, cnt: int):
    """(cnt*width,) LE bytes -> (cnt,) int64 for widths 4 and 8, matching
    the host frombuffer(...).astype(int64) exactly (zero-extend at 4,
    bit-reinterpretation at 8). Widths 1 and 2 go through _widen_group."""
    # clone: a slice of the packed payload may start at any byte, and a
    # dtype view needs an aligned storage offset
    if width == 8:
        return raw.clone().view(torch.int64)
    return raw.clone().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _meta_to_dev(rows, device) -> torch.Tensor:
    """A small int64 table of per-block host scalars on the card (one
    copy, counted on the `device-decode` transfer site)."""
    arr = np.asarray(rows, np.int64)
    devobs.note_transfer("h2d", _XFER_SITE, arr.nbytes)
    return _to_dev(arr, device)


def _block_ids(counts, total: int):
    """(total,) block id of every element, blocks of `counts` (device
    int64) elements in order."""
    ids = torch.arange(counts.shape[0], dtype=torch.int64,
                       device=counts.device)
    return torch.repeat_interleave(ids, counts, output_size=total)


def _widen_group(payload, delta_rows, dict_rows):
    """Every width-1/2 FOR-delta and strdict block of a plan in ONE
    widen launch (kernel 4, the delta rows first). Returns (the delta
    blocks' values, each block's leading `first` then its n-1 values, in
    block order; the strdict indices) as int64.

    FOR-delta per block is first, first + cumsum(d + step); here one
    int64 cumsum C runs over every block's d + step, and a block's value
    j >= 1 is first + C[a + j - 1] - C[a - 1] (a the block's first
    delta): int64 wraps mod 2^64 alike in the per-block and the global
    form, so the values are bit-identical."""
    dev = payload.device
    devobs.probe(dev)
    w = cuda_segment.widen_packed_segments(
        payload, [r[:3] for r in delta_rows] + dict_rows).to(torch.int64)
    tot = sum(r[1] for r in delta_rows)
    n_blocks = len(delta_rows)
    if not n_blocks:
        return None, w
    meta = _meta_to_dev([[r[3] for r in delta_rows],
                         [r[4] for r in delta_rows],
                         [r[1] for r in delta_rows]], dev)
    first, step, cnt = meta[0], meta[1], meta[2]
    a = torch.cumsum(cnt, 0) - cnt
    out = torch.empty(tot + n_blocks, dtype=torch.int64, device=dev)
    out[a + torch.arange(n_blocks, dtype=torch.int64, device=dev)] = first
    if tot:
        blk = _block_ids(cnt, tot)
        c = torch.cumsum(w[:tot] + step[blk], 0)
        c_before = torch.cat([c.new_zeros(1), c])[a]
        pos = torch.arange(tot, dtype=torch.int64, device=dev) + blk + 1
        out[pos] = c + (first - c_before)[blk]
    return out, w[tot:]


def _prefix_xor(planes: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR of int64 words given as (n, 64) uint8 bit
    planes (column p = bit p): torch has no cumulative XOR, but bit p of
    a prefix XOR is the parity of bit p over the prefix, which a uint8
    cumulative sum keeps (it wraps mod 256). The planes are scanned in
    rows of _SCAN_ROW values (one sequential scan per row and bit, all
    in parallel), then each row adds the parity of the rows before it;
    the parities go back into bytes as sums of distinct bits, so the
    words are bit-identical to the sequential walk."""
    n = planes.shape[0]
    rows = -(-n // _SCAN_ROW)
    if rows * _SCAN_ROW != n:
        planes = torch.cat([planes, planes.new_zeros(rows * _SCAN_ROW - n,
                                                     64)])
    inner = torch.cumsum(planes.reshape(rows, _SCAN_ROW, 64), 1,
                         dtype=torch.uint8)
    last = inner[:, -1, :]
    before = torch.cumsum(last, 0, dtype=torch.uint8) - last
    parity = ((inner + before[:, None, :]) & 1).reshape(-1).view(torch.int64)
    # eight 0/1 bytes -> one byte: the product moves byte k's bit to bit
    # 56 + k and every other partial product elsewhere, without carries
    packed = ((parity * _GATHER_BITS) >> 56) & 0xFF
    return packed.to(torch.uint8).view(torch.int64)[:n]


def _gorilla_chunk(payload, rows, aux32, aux8):
    """Data-parallel gorilla reconstruction of a chunk of whole blocks
    (rows of (src, nbytes, n, aux offset, seed), consecutive in the aux
    vectors) from one unpack launch (kernel 5) of their payloads plus
    the host structural scan's vectors. Value i's XOR delta is its mbits
    meaningful bits, read MSB first from bitpos (moved by 8 x its
    block's byte offset in the chunk's bits), shifted left by its
    trailing-zero count: bit p of the delta, for shift <= p < shift +
    mbits, is window bit shift + mbits - 1 - p (repeats have mbits=0 ->
    delta 0; a block's value 0 has mbits=64 -> its raw bits). The deltas
    are built as bit planes, which the prefix XOR over the chunk scans
    directly; then scan[i] ^ scan[start of i's block - 1] (XOR is its
    own inverse) yields every block's decoded words. A block a mesh
    shard cut starts mid-stream: its seed, the decoded bit pattern of
    the value before the cut (0 for a whole block), XORs into each of
    its words."""
    dev = payload.device
    devobs.probe(dev)
    bits = cuda_segment.unpack_bits_segments(payload, [r[:2] for r in rows])
    bits = torch.cat([bits.to(torch.uint8),
                      torch.zeros(64, dtype=torch.uint8, device=dev)])
    counts = [r[2] for r in rows]
    n = sum(counts)
    a0 = rows[0][3]
    byte_off = np.cumsum([0] + [r[1] for r in rows[:-1]])
    meta = _meta_to_dev([8 * byte_off, counts], dev)
    blk = _block_ids(meta[1], n)
    pair = aux8[2 * a0:2 * (a0 + n)].reshape(n, 2).to(torch.int32)
    mb, sh = pair[:, 0:1], pair[:, 1:2]
    top = sh + mb  # one past the delta's highest bit
    high = (aux32[a0:a0 + n, None] + meta[0][blk, None].to(torch.int32)
            + top - 1)  # the bit that lands on delta bit 0 if it is kept
    p = torch.arange(64, dtype=torch.int32, device=dev)
    planes = torch.where((p >= sh) & (p < top),
                         bits[(high - p).clamp(min=0)], 0)
    words = _prefix_xor(planes)
    if len(rows) > 1:
        start = torch.cumsum(meta[1], 0) - meta[1]
        words = words ^ torch.cat([words.new_zeros(1), words])[start][blk]
    if any(r[4] for r in rows):
        words = words ^ _meta_to_dev([[r[4] for r in rows]], dev)[0][blk]
    return words.view(torch.float64)


def _varint_piece(raw, m: int, bn: int):
    """Data-parallel LEB128 delta+zigzag decode: terminator bytes (high
    bit clear) close each varint, so a cumulative count assigns every
    byte its value id; a segmented shift/or (the 7-bit groups occupy
    disjoint bit ranges, so a scatter-add IS an or) rebuilds each
    word; zigzag, then a wrapping int64 cumsum, match the host's
    mod-2^64 walk exactly."""
    dev = raw.device
    ends = (raw & 0x80) == 0
    e64 = ends.to(torch.int64)
    vid = torch.cumsum(e64, 0) - e64
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ends[:-1]])
    starts = torch.zeros(bn, dtype=torch.int64, device=dev).index_add_(
        0, vid, torch.where(is_start, pos, 0))
    off7 = (pos - starts[vid]) * 7
    groups = (raw.to(torch.int64) & 0x7F) << off7
    u = torch.zeros(bn, dtype=torch.int64, device=dev).index_add_(
        0, vid, groups)
    d = ((u >> 1) & _INT64_MAX) ^ -(u & 1)
    return torch.cumsum(d, 0)


def _gorilla_chunks(rows):
    """Consecutive gorilla rows cut into chunks of at most _CHUNK_VALUES
    values, each ending at a block boundary (a longer block is a chunk of
    its own)."""
    chunks, cur, n = [], [], 0
    for r in rows:
        if cur and n + r[2] > _CHUNK_VALUES:
            chunks.append(cur)
            cur, n = [], 0
        cur.append(r)
        n += r[2]
    if cur:
        chunks.append(cur)
    return chunks


def _decode(sig, out_dt, payload, scalars, aux32=None, aux8=None):
    """The decode of a plan: (n,) values in `out_dt` on the payload's
    device, in signature order. A host walk of the signature places
    every block: width-1/2 FOR-delta and strdict blocks go to one
    segmented widen (_widen_group), gorilla blocks to chunks of one
    segmented unpack each (_gorilla_chunk), the other codecs decode
    block by block. Offsets come from the signature; `scalars` ((B, 2)
    int64 first/step per block) stays on the host apart from the
    FOR-delta blocks' copy, so no launch waits on a device-to-host
    read."""
    dev = payload.device
    delta_rows, dict_rows, gor_rows = [], [], []
    order = []  # per block: its values, or (group, row) in a batched group
    off = aoff = 0
    for i, (kind, bn, width) in enumerate(sig):
        if bn == 0:
            continue
        first = int(scalars[i, 0])
        step = int(scalars[i, 1])
        if kind == "const":
            order.append(first + step * torch.arange(bn, dtype=torch.int64,
                                                     device=dev))
        elif kind == "delta":
            m = (bn - 1) * width
            if width in (1, 2):
                order.append(("delta", len(delta_rows)))
                delta_rows.append((off, bn - 1, width, first, step))
            else:
                d = _widen(payload[off:off + m], width, bn - 1) + step
                order.append(torch.cat([
                    torch.full((1,), first, dtype=torch.int64, device=dev),
                    first + torch.cumsum(d, 0)]))
            off += m
        elif kind == "raw64":
            m = 8 * bn
            order.append(payload[off:off + m].clone().view(torch.float64))
            off += m
        elif kind == "gorilla":
            m = width  # payload byte length rides in the signature
            order.append(("gorilla", len(gor_rows)))
            # `first` seeds a block a mesh shard cut (0 for whole ones)
            gor_rows.append((off, m, bn, aoff, first))
            off += m
            aoff += bn
        elif kind == "varint":
            m = width
            # `first` seeds a block a mesh shard cut (a wrapping int64
            # add, like the host's mod-2^64 walk); 0 for whole blocks
            piece = _varint_piece(payload[off:off + m], m, bn)
            order.append(piece + first if first else piece)
            off += m
        else:  # strdict: min-width indices, table stays host-side
            m = bn * width
            if width in (1, 2):
                order.append(("dict", len(dict_rows)))
                dict_rows.append((off, bn, width))
            else:
                order.append(_widen(payload[off:off + m], width, bn))
            off += m
    if not order:
        return torch.zeros(0, dtype=out_dt, device=dev)
    # (group, row) -> (the group's values, lo, hi) of that block
    spans = {}
    if delta_rows or dict_rows:
        deltas, indices = _widen_group(payload, delta_rows, dict_rows)
        for group, vals, rows, extra in (("delta", deltas, delta_rows, 1),
                                         ("dict", indices, dict_rows, 0)):
            lo = 0
            for k, r in enumerate(rows):
                spans[(group, k)] = (vals, lo, lo + r[1] + extra)
                lo += r[1] + extra
    k = 0
    for chunk in _gorilla_chunks(gor_rows):
        vals = _gorilla_chunk(payload, chunk, aux32, aux8)
        lo = 0
        for r in chunk:
            spans[("gorilla", k)] = (vals, lo, lo + r[2])
            lo += r[2]
            k += 1
    # neighbouring blocks that lie next to each other in one group's
    # values become one slice
    runs = []
    for item in order:
        src, lo, hi = (spans[item] if isinstance(item, tuple)
                       else (item, 0, item.shape[0]))
        if runs and runs[-1][0] is src and runs[-1][2] == lo:
            runs[-1][2] = hi
        else:
            runs.append([src, lo, hi])
    parts = [src[lo:hi].to(out_dt) for src, lo, hi in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# -- PromQL: the (series, samples) value matrix -------------------------------


def materialize_enc(enc) -> np.ndarray:
    """Host materialization of a (ftype, blocks, segments, slices)
    encoded-column descriptor into the concatenated f64 sample vector —
    the bit-identical host decode for consumers that need host values
    (the dense prom kernels, the host route)."""
    ftype, blocks, segments, slices = enc
    d = encoding.decode_value_blocks(ftype, list(blocks)).astype(
        np.float64)
    if segments is not None:
        d = (np.concatenate([d[a:b] for a, b in segments])
             if len(segments) else d[:0])
    if not slices:
        return np.empty(0, np.float64)
    if len(slices) == 1:
        lo, hi = slices[0]
        return d[lo:hi]
    return np.concatenate([d[lo:hi] for lo, hi in slices])


def decode_rows_matrix(enc, shape, dtype, device):
    """Decode raw blocks ON `device` and lay the per-series sample slices
    into a zero-padded (S, N) row matrix — the PromQL tiled kernels'
    value matrix without the padded-f64 transfer (what crosses is the
    raw payload, the gorilla scan vectors and two ints per series).
    `enc` is the (ftype, blocks, segments, slices) descriptor (slices in
    VIEW coordinates). Returns the device matrix, or None when the
    blocks are not device-decodable or the cost gate keeps the decode on
    the host (the caller then materializes on the host,
    bit-identically)."""
    if not active():
        return None
    _ftype, blocks, segments, slices = enc
    dbs = classify(list(blocks))
    if dbs is None:
        note_fallback()
        return None
    n_full = sum(b.n for b in dbs)
    if segments is None:
        viewruns, n_view = None, n_full
    else:
        segments = np.asarray(segments, np.int64).reshape(-1, 2)
        viewruns = segments
        n_view = int((segments[:, 1] - segments[:, 0]).sum())
        if len(segments) and ((segments[:, 0] < 0).any()
                              or (segments[:, 1] > n_full).any()):
            note_fallback()
            return None
    S, N = shape
    lo = np.array([s[0] for s in slices], np.int64)
    ln = np.array([s[1] - s[0] for s in slices], np.int64)
    if len(slices) != S or (ln > N).any() or (lo < 0).any() \
            or (lo + ln > n_view).any():
        note_fallback()
        return None
    sig, payload, scalars, aux32, aux8 = _pack_blocks(dbs)
    host_in = [payload, scalars]
    if aux32 is not None:
        host_in.extend((aux32, aux8))
    host_in.extend((lo, ln))
    if viewruns is not None:
        host_in.append(viewruns)
    # cost gate (the encoded transfer must beat the padded value matrix
    # it replaces — whole-block payloads can exceed a heavily trimmed
    # view; raw64 floats have no width compression to amortize it),
    # serving as the offload planner's zero-sample prior: measured
    # device samples for this geometry retire the byte rule
    rows_geo = (len(sig), n_view, (S, N))
    if not offload.GLOBAL.gate_prior(
            "prom_decode_rows", rows_geo,
            sum(int(a.nbytes) for a in host_in),
            S * N * np.dtype(dtype).itemsize):
        note_fallback()
        return None
    t0 = time.perf_counter_ns()
    dev = [None if a is None else _to_dev(a, device)
           for a in (payload, aux32, aux8, lo, ln, viewruns)]
    # what crosses: every input but the per-block scalars, which stay
    # host ints (as in the grid plan)
    devobs.note_transfer("h2d", _XFER_SITE, sum(
        int(a.nbytes) for a in (payload, aux32, aux8, lo, ln, viewruns)
        if a is not None), (time.perf_counter_ns() - t0) / 1e9)
    _note_decode_stats(sig, n_view)
    devobs.note_use("prom_decode_rows", rows_geo)
    out_dt = _TORCH_DTYPE[np.dtype(dtype)]
    offload.register_builder(
        "prom_decode_rows", rows_geo,
        _rows_builder(sig, n_view, (S, N), out_dt, device, payload.shape,
                      scalars.shape, None if aux32 is None else aux32.shape,
                      viewruns))
    with devobs.first_run("prom_decode_rows", rows_geo, device):
        return _rows_matrix(sig, n_view, (S, N), out_dt, dev[0], scalars,
                            dev[1], dev[2], dev[3], dev[4], dev[5])


def _rows_matrix(sig, n: int, shape, out_dt, payload, scalars, aux32, aux8,
                 lo, ln, viewruns):
    """The decode of a rows plan, each series' slice laid into its row
    of a zero-padded (S, N) matrix. The gather index is clamped into the
    decoded values (rows past a series' length are masked to zero)."""
    S, N = shape
    dev = payload.device
    if n == 0:
        return torch.zeros((S, N), dtype=out_dt, device=dev)
    vals = _decode(sig, out_dt, payload, scalars, aux32, aux8)
    if viewruns is not None:
        vals = _view_gather(vals, viewruns, n)
    col = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    idx = (lo[:, None] + col).clamp(0, n - 1)
    m = col < ln[:, None]
    return torch.where(m, vals[idx], torch.zeros((), dtype=out_dt,
                                                 device=dev))


def _rows_builder(sig, n: int, shape, out_dt, device, payload_shape,
                  scalars_shape, aux_shape, viewruns):
    """The rows site's pre-warm builder: a zero-argument callable that
    runs the site once on zeros of the plan's shapes (each varint
    block's bytes end in exactly its value count of terminators) unless
    it already ran at that geometry."""
    rows_geo = (len(sig), n, shape)
    viewruns = None if viewruns is None else viewruns.copy()

    def build() -> None:
        if devobs.has_run("prom_decode_rows", rows_geo):
            return
        payload = np.zeros(payload_shape, np.uint8)
        off = 0
        for kind, bn, width in sig:
            m = _payload_nbytes(kind, bn, width)
            if kind == "varint" and bn:
                payload[off:off + m - bn] = 0x80  # continuation bytes
            off += m
        aux32 = aux8 = None
        if aux_shape is not None:
            aux32 = _to_dev(np.zeros(aux_shape, np.int32), device)
            aux8 = _to_dev(np.zeros(2 * aux_shape[0], np.uint8), device)
        s_dim = shape[0]
        zi = _to_dev(np.zeros(s_dim, np.int64), device)
        with devobs.first_run("prom_decode_rows", rows_geo, device):
            _rows_matrix(sig, n, shape, out_dt, _to_dev(payload, device),
                         np.zeros(scalars_shape, np.int64), aux32, aux8,
                         zi, zi, None if viewruns is None
                         else _to_dev(viewruns, device))

    return build
