"""Device-side decode of TSF device-profile blocks, fused into the grid
aggregation data path.

The port of ``opengemini_tpu/ops/device_decode.py`` for one device (the
mesh-sharded plans are not ported yet). A cold scan over files written
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
           (kernel 4, ``cuda_segment.widen_packed``, for widths 1 and 2),
           +step, int64 cumsum, +first
  raw64    little-endian float64 values: an 8-byte reinterpretation
  gorilla  XOR-compressed float64: a host structural scan walks the
           control bits once per block (cached) and emits per-value
           (bitpos, mbits, shift) vectors; the card unpacks the payload
           to bits (kernel 5, ``cuda_segment.unpack_bits``), gathers each
           value's meaningful bits and rebuilds the words with a
           log-step XOR prefix scan
  varint   delta+zigzag LEB128 int64: terminator bytes mark value ids, a
           segmented shift/or rebuilds each varint, zigzag and a
           wrapping int64 cumsum follow
  strdict  dictionary-coded strings: the min-width index array widens on
           the card; the table stays on the host

Unsigned 64-bit words are carried in int64: every shift of a set bit is
a left shift (whose overflow torch defines as the unsigned result), a
logical right shift masks off the sign fill, and a sum of distinct bits
that wraps gives the same bit pattern as the uint64 sum.

Kernels 4 and 5 run only where the capability probe (kernel 6,
utils/devobs.probe) ran and counted right; a failed probe raises. Every other step is plain torch on the device. On a CPU device
the wrappers take their plain versions, which is how the tests run this
module against the JAX package.

Counters (utils.stats.STATS, ``device/...``): decode_blocks_total,
decode_payload_bytes_total, decode_rows_total, decode_fallbacks_total,
and per codec decode_blocks_<codec>_total /
decode_payload_bytes_<codec>_total. Transfers land on the
``device-decode`` site of devobs.note_transfer.

Not ported: the ``OGT_DEVICE_DECODE`` and ``OGT_DEVICE_DECODE_CODECS``
triage knobs (the port always decodes every eligible codec on the
device) and the mesh plans.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opengemini_tpu_torch.ops import cuda_segment
from opengemini_tpu_torch.query import offload
from opengemini_tpu_torch.storage import encoding
from opengemini_tpu_torch.utils import devobs
from opengemini_tpu_torch.utils.stats import incr as _incr

# past this many blocks a plan's per-block launches stop paying for what
# they save; the host decode handles the long tail
_MAX_BLOCKS = 256

_XFER_SITE = "device-decode"
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

    The walk and its bounds checks are the JAX package's; its bit reader
    differs: one 128-bit big-endian window per value (zero-padded past
    the end, never read there) serves the control bits, the header and
    the meaningful bits, since they span at most 7 + 13 + 64 bits."""
    nbits = len(payload) * 8
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint8),
                np.zeros(0, np.uint8), np.zeros(0, np.uint64))
    if nbits < 64:
        return None
    padded = bytes(payload) + bytes(16)
    from_bytes = int.from_bytes
    bitpos = [0] * n
    mbits = [0] * n
    shift = [0] * n
    vals = [0] * n
    acc = from_bytes(padded[:8], "big")
    vals[0] = acc
    mbits[0] = 64
    pos = 64
    lz = tz = 0
    for i in range(1, n):
        if pos + 1 > nbits:
            return None
        j = pos >> 3
        w = from_bytes(padded[j:j + 16], "big")
        r = 128 - (pos & 7)  # bits of w from pos on
        if not (w >> (r - 1)) & 1:
            vals[i] = acc  # repeat of prev: xor = 0, mbits stays 0
            pos += 1
            continue
        if pos + 2 > nbits:
            return None
        if (w >> (r - 2)) & 1:
            if pos + 13 > nbits:
                return None
            lz = (w >> (r - 7)) & 31
            tz = 64 - lz - ((w >> (r - 13)) & 63) - 1
            if tz < 0:
                return None
            head = 13
        else:
            head = 2
        mb = 64 - lz - tz
        if mb <= 0 or pos + head + mb > nbits:
            return None
        bitpos[i] = pos + head
        mbits[i] = mb
        shift[i] = tz
        acc ^= ((w >> (r - head - mb)) & ((1 << mb) - 1)) << tz
        vals[i] = acc
        pos += head + mb
    return (np.array(bitpos, np.int32), np.array(mbits, np.uint8),
            np.array(shift, np.uint8), np.array(vals, np.uint64))


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
    streams whose host structural validation fails."""
    if len(blocks) > _MAX_BLOCKS:
        return None
    out = []
    for buf in blocks:
        db = encoding.device_block(buf)
        if db is None:
            return None
        if db.kind == "gorilla":
            if _gorilla_scan(bytes(db.payload), db.n) is None:
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
            bitpos, mbits, shift, _ = _gorilla_scan(bytes(b.payload), b.n)
            p32.append(bitpos)
            p8.append(np.stack([mbits, shift], axis=1).reshape(-1))
        aux32 = np.concatenate(p32)
        aux8 = np.concatenate(p8)
    return sig, payload, scalars, aux32, aux8


def note_fallback(n: int = 1) -> None:
    """Count an eligible-looking encoded scan that ended up on the host
    decode path anyway (ineligible blocks, cost gate)."""
    _incr("device/decode_fallbacks_total", n)


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
    _incr("device/decode_blocks_total", len(sig))
    total = 0
    for kind, bn, width in sig:
        nb = _payload_nbytes(kind, bn, width)
        total += nb
        _incr(f"device/decode_blocks_{kind}_total")
        _incr(f"device/decode_payload_bytes_{kind}_total", nb)
    _incr("device/decode_payload_bytes_total", total)
    _incr("device/decode_rows_total", rows)


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
    Returns None when the blocks are not device-decodable or the
    transfer would not beat the decoded grid — the caller then decodes
    on the host exactly as before."""
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
    # bytes per padded cell)
    if not offload.gate_prior(plan.transfer_nbytes(),
                              int(np.prod(shape)) * 9):
        note_fallback()
        return None
    return plan


def _to_dev(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def run_grid_plan(plan: GridPlan):
    """Execute the fused decode: one host-to-device copy of each encoded
    input (site `device-decode`), then decode + scatter + the grid
    window reduce, all queued on the current stream. Returns
    ({count,sum,mean,min,max} device tensors, vt, mt, flat): vt/mt are
    the decoded grid buffers, ready for the ssd and selector groups;
    flat is the device-resident scatter-slot vector (imat_from_flat
    builds the selector index grid from it)."""
    dev = plan.device
    payload = _to_dev(plan.payload, dev)
    aux32 = None if plan.aux32 is None else _to_dev(plan.aux32, dev)
    aux8 = None if plan.aux8 is None else _to_dev(plan.aux8, dev)
    viewruns = None if plan.viewruns is None else _to_dev(plan.viewruns, dev)
    # what crosses: every input but the per-block scalars and the window
    # phase, which stay host ints (no launch waits on reading them back)
    devobs.note_transfer("h2d", _XFER_SITE, sum(
        int(a.nbytes) for a in (plan.payload, plan.aux32, plan.aux8,
                                plan.viewruns, plan.flat, plan.runmeta,
                                plan.maskbits) if a is not None))
    sig, n, shape, dtype_str, every_ns, dt = plan.geom
    _note_decode_stats(sig, n)
    out_dt = _TORCH_DTYPE[np.dtype(dtype_str)]
    vals = _decode(sig, out_dt, payload, plan.scalars, aux32, aux8)
    if viewruns is not None:
        vals = _view_gather(vals, viewruns, n)
    if plan.flat is not None:
        flat = _to_dev(plan.flat, dev).to(torch.int64)
    else:
        flat = _affine_slots(_to_dev(plan.runmeta, dev),
                             int(plan.consts[0]), n, shape, every_ns, dt)
    cells = int(np.prod(shape))
    vt = torch.zeros(cells, dtype=out_dt, device=dev)
    vt[flat] = vals
    if plan.maskbits is not None:
        bits = _to_dev(plan.maskbits, dev)
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        mrow = ((bits[:, None] >> shifts) & 1).reshape(-1)[:n].to(torch.bool)
    else:
        mrow = torch.ones(n, dtype=torch.bool, device=dev)
    mt = torch.zeros(cells, dtype=torch.bool, device=dev)
    mt[flat] = mrow
    vt, mt = vt.reshape(shape), mt.reshape(shape)
    stats = cuda_segment.grid_window_agg(vt, mt)
    return stats, vt, mt, flat


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
    imat = torch.zeros(int(np.prod(shape)), dtype=torch.int32,
                       device=flat_dev.device)
    imat[flat_dev] = torch.arange(n, dtype=torch.int32,
                                  device=flat_dev.device)
    return imat.reshape(shape)


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
    return _decode(
        sig, _TORCH_DTYPE[out_dtype], _to_dev(payload, device), scalars,
        None if aux32 is None else _to_dev(aux32, device),
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
    """(cnt*width,) LE bytes -> (cnt,) int64, matching the host
    frombuffer(...).astype(int64) exactly (zero-extend below 8 bytes,
    bit-reinterpretation at 8). Widths 1 and 2 run kernel 4."""
    if width in (1, 2):
        devobs.probe(raw.device)
        return cuda_segment.widen_packed(raw, width, cnt).to(torch.int64)
    # clone: a slice of the packed payload may start at any byte, and a
    # dtype view needs an aligned storage offset
    if width == 8:
        return raw.clone().view(torch.int64)
    return raw.clone().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _unpack_bits(raw, nbytes: int):
    """(nbytes,) uint8 -> (nbytes*8,) int32 bits, MSB first per byte:
    kernel 5."""
    devobs.probe(raw.device)
    return cuda_segment.unpack_bits(raw, nbytes)


def _xor_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR (Hillis-Steele, log2(n) steps): torch has no
    cumulative XOR, and XOR's associativity makes the result
    bit-identical to the sequential walk."""
    s = 1
    n = x.shape[0]
    while s < n:
        y = x.clone()
        y[s:] ^= x[:-s]
        x = y
        s *= 2
    return x


def _gorilla_piece(raw, m: int, bitpos, mb_sh, bn: int):
    """Data-parallel gorilla reconstruction from the payload bytes plus
    the host structural scan's vectors. Value i's XOR delta is its mbits
    meaningful bits, read MSB first from bitpos, shifted left by its
    trailing-zero count: bit j lands at position shift + mbits - 1 - j
    (repeats have mbits=0 -> delta 0; value 0 has mbits=64 -> its raw
    bits). A prefix XOR of the deltas yields every decoded word."""
    dev = bitpos.device
    if m == 0:
        bits = torch.zeros(64, dtype=torch.int32, device=dev)
    else:
        bits = torch.cat([_unpack_bits(raw, m),
                          torch.zeros(64, dtype=torch.int32, device=dev)])
    j = torch.arange(64, dtype=torch.int64, device=dev)
    g = bitpos.to(torch.int64)[:, None] + j
    pair = mb_sh.reshape(bn, 2).to(torch.int64)
    mb, sh = pair[:, 0:1], pair[:, 1:2]
    pos = sh + mb - 1 - j  # (bn, 64) target bit of window bit j
    take = j < mb
    bv = bits[g].to(torch.int64)
    xor = torch.where(take, bv << pos.clamp(min=0), 0).sum(dim=1)
    return _xor_scan(xor).view(torch.float64)


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


def _decode(sig, out_dt, payload, scalars, aux32=None, aux8=None):
    """The per-block decode: (n,) values in `out_dt` on the payload's
    device. Offsets come from the signature; `scalars` ((B, 2) int64
    first/step per block) stays on the host, so no launch waits on a
    device-to-host read."""
    pieces = []
    off = 0
    aoff = 0
    dev = payload.device
    for i, (kind, bn, width) in enumerate(sig):
        if bn == 0:
            continue
        first = int(scalars[i, 0])
        step = int(scalars[i, 1])
        if kind == "const":
            piece = first + step * torch.arange(bn, dtype=torch.int64,
                                                device=dev)
        elif kind == "delta":
            m = (bn - 1) * width
            raw = payload[off:off + m]
            off += m
            d = _widen(raw, width, bn - 1) + step
            piece = torch.cat([
                torch.full((1,), first, dtype=torch.int64, device=dev),
                first + torch.cumsum(d, 0)])
        elif kind == "raw64":
            m = 8 * bn
            piece = payload[off:off + m].clone().view(torch.float64)
            off += m
        elif kind == "gorilla":
            m = width  # payload byte length rides in the signature
            raw = payload[off:off + m]
            off += m
            bitpos = aux32[aoff:aoff + bn]
            mb_sh = aux8[2 * aoff:2 * (aoff + bn)]
            aoff += bn
            piece = _gorilla_piece(raw, m, bitpos, mb_sh, bn)
        elif kind == "varint":
            m = width
            raw = payload[off:off + m]
            off += m
            piece = _varint_piece(raw, m, bn)
        else:  # strdict: min-width indices, table stays host-side
            m = bn * width
            raw = payload[off:off + m]
            off += m
            piece = _widen(raw, width, bn)
        pieces.append(piece.to(out_dt))
    if not pieces:
        return torch.zeros(0, dtype=out_dt, device=dev)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)

