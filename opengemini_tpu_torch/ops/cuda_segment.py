"""Hand-written CUDA kernels, with their plain PyTorch versions.

The port of ``opengemini_tpu/ops/pallas_segment.py`` and of the Pallas
capability probe in ``opengemini_tpu/utils/devobs.py``. Six kernels:

  - ``bucket_stats_basic``     — (G, W) bucket rows: count/sum/mean/min/
                                 max/ssd (csrc/bucket_basic.cu)
  - ``bucket_stats_selectors`` — same rows: first/last values and the
                                 first/last/min/max sample indices
                                 (csrc/bucket_selectors.cu)
  - ``grid_window_agg``        — (S, K, W) regular grid: count/sum/mean/
                                 min/max per (series, window)
                                 (csrc/grid_window.cu)
  - ``widen_packed``           — little-endian width-1/2 bytes -> int32,
                                 the FOR-delta and dictionary-index
                                 decode, one launch for a table of
                                 segments (csrc/widen_packed.cu)
  - ``unpack_bits``            — bytes -> MSB-first int32 bits, the
                                 gorilla decode, one launch for a table
                                 of segments (csrc/unpack_bits.cu)
  - ``probe_count``            — masked row count of an int8 matrix, the
                                 capability probe (csrc/probe_count.cu)

Dispatch is by the device of the input tensor and nothing else: a CUDA
tensor launches the kernel (and counts the launch in ``LAUNCHES``), a
CPU tensor takes the plain version, any other device raises. There is no
fallback from a kernel that fails to build or launch; the error
propagates.

The kernels are built at first use with ``nvcc`` for ``sm_90a``, one
shared library with a plain C interface per source (no PyTorch headers,
so each builds in seconds), into ``build/torch_ext/`` at the repository
root, and loaded with ``ctypes``. All sources compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from opengemini_tpu_torch.ops import segment as _seg
from opengemini_tpu_torch.utils import devobs

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "torch_ext")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _float_pair(prefix: str, argtypes: list) -> dict:
    return {f"{prefix}_{suffix}": argtypes for suffix in ("f32", "f64")}


# kernel name -> (source file, {C symbol: argtypes}); every entry point
# takes the stream last and returns the launch's cudaError_t
_KERNELS = {
    "bucket_stats_basic": ("bucket_basic.cu", _float_pair(
        "ogt_bucket_basic", [_P, _P, _LL, _I] + [_P] * 7)),
    "bucket_stats_selectors": ("bucket_selectors.cu", _float_pair(
        "ogt_bucket_selectors", [_P] * 5 + [_LL, _I] + [_P] * 7)),
    "grid_window_agg": ("grid_window.cu", _float_pair(
        "ogt_grid_window_agg", [_P, _P, _LL, _I, _I] + [_P] * 6)),
    "widen_packed": ("widen_packed.cu", {
        "ogt_widen_packed_segments": [_P, _P, _I, _P, _P]}),
    "unpack_bits": ("unpack_bits.cu", {
        "ogt_unpack_bits_segments": [_P, _P, _I, _P, _P]}),
    "probe_count": ("probe_count.cu", {
        "ogt_probe_count": [_P, _LL, _I, _P, _P]}),
}

# launches of each kernel since the last reset_launches(); only the
# wrappers' kernel branches add to it
LAUNCHES = {name: 0 for name in _KERNELS}

_libs: dict = {}
_build_lock = threading.Lock()
# (kernel name, dtype) -> (library, C entry point), filled at first use so
# that a launch looks nothing up again
_entries: dict = {}
# the most rows one segmented launch takes (the kernels' kMaxSegments;
# ops/device_decode.py's _MAX_BLOCKS caps a plan at the same)
MAX_SEGMENTS = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_path(name: str) -> str:
    return os.path.join(_CSRC, _KERNELS[name][0])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    for p in (src, os.path.join(_CSRC, "ogt_common.cuh")):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(names=None, verbose: bool = False) -> dict:
    """Compile (when not already built) and load the kernels' libraries:
    one nvcc per source, all started together. Returns {name: CDLL}.
    A compile error raises with nvcc's output. Each library loaded goes
    into the device compile inventory as ``build:<source stem>``
    (utils/devobs.py ``note_build``) with its wall: from the start of
    the parallel builds to its library (0 when it was built already)."""
    names = list(_KERNELS) if names is None else list(names)
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        walls = {}
        procs = []
        for n in todo:
            src = source_path(n)
            out = _lib_path(src)
            if os.path.exists(out):
                procs.append((n, out, None, None))
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
            cmd = [_nvcc(), *flags, "-I", _CSRC, "-o", tmp, src]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for n, out, tmp, proc in procs:
            if proc is None:
                continue
            log = proc.communicate()[0].decode(errors="replace")
            walls[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n} ({proc.returncode}):\n{log}")
                continue
            if verbose and log.strip():
                print(f"[nvcc {n}]\n{log}", flush=True)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, out, _tmp, _proc in procs:
            lib = ctypes.CDLL(out)
            for symbol, argtypes in _KERNELS[n][1].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ogt_error_string.argtypes = [ctypes.c_int]
            lib.ogt_error_string.restype = ctypes.c_char_p
            _libs[n] = lib
            devobs.note_build(
                "build:" + os.path.splitext(_KERNELS[n][0])[0],
                (NVCC_FLAGS[1].split("code=")[-1],), walls.get(n, 0.0))
        return {n: _libs[n] for n in names}


def _entry(name: str, dtype: torch.dtype | None = None):
    """(library, C entry point) of a kernel; the float kernels pick the
    entry point of the values' dtype."""
    hit = _entries.get((name, dtype))
    if hit is not None:
        return hit
    hit = _entries[(name, dtype)] = _resolve(name, dtype)
    return hit


def _resolve(name: str, dtype: torch.dtype | None):
    lib = build([name])[name]
    symbols = list(_KERNELS[name][1])
    if len(symbols) == 1:
        return lib, getattr(lib, symbols[0])
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: values must be float32 or float64, got {dtype}")
    return lib, getattr(lib, symbols[0][:-3] + suffix)


def _check(name: str, v: torch.Tensor, ints=(), mask=None, dim=2) -> None:
    if v.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D values, got {v.dim()}-D")
    for t in (v, *ints, mask):
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"{name}: inputs on {t.device} and {v.device}")
        if t.shape != v.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(v.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: time/index inputs must be int32")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool")


def _launch(name: str, fn, lib, device: torch.device, *args) -> None:
    """Launch on `device`'s current stream; the device context is
    entered only when `device` is not the current device (the tensors
    are on the card, so CUDA is initialised)."""
    cur = torch._C._cuda_getDevice()
    if device.index is None or device.index == cur:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(cur))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.ogt_error_string(code).decode()}")
    LAUNCHES[name] += 1


def _require_cuda_or_cpu(name: str, v: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); anything else raises."""
    if v.device.type == "cuda":
        return True
    if v.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {v.device}")


# -- (G, W) bucket stats: basic ---------------------------------------------


def bucket_stats_basic_plain(v: torch.Tensor, m: torch.Tensor) -> dict:
    """Plain form of kernel 1 (the XLA 'basic' of models/ragged.py and
    the TPU _basic_kernel): ssd is taken around mean = sum / max(cnt, 1)
    in the data type."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    cnt = m.sum(dim=1, dtype=torch.int32)
    s = torch.where(m, v, zero).sum(dim=1)
    mean = s / cnt.clamp(min=1).to(v.dtype)
    dev = torch.where(m, v - mean[:, None], zero)
    return {
        "count": cnt, "sum": s, "mean": mean,
        "min": torch.where(m, v, inf).amin(dim=1),
        "max": torch.where(m, v, -inf).amax(dim=1),
        "ssd": (dev * dev).sum(dim=1),
    }


def _basic_outputs(dtype: torch.dtype, g: int, device):
    """Kernel 1's outputs from one allocation: sum, mean, min, max and
    ssd of `dtype`, then the int32 counts, (g,) each, in one buffer."""
    buf = torch.empty(5 * g + -(-4 * g // dtype.itemsize), dtype=dtype,
                      device=device)
    return (buf[:5 * g].view(5, g).unbind(0),
            buf[5 * g:].view(torch.int32)[:g])


def bucket_stats_basic(v: torch.Tensor, m: torch.Tensor) -> dict:
    """count/sum/mean/min/max/ssd per row of (G, W) bucket rows; the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    name = "bucket_stats_basic"
    _check(name, v, mask=m)
    if not _require_cuda_or_cpu(name, v):
        return bucket_stats_basic_plain(v, m)
    lib, fn = _entry(name, v.dtype)
    g, w = v.shape
    outs, cnt = _basic_outputs(v.dtype, g, v.device)
    _launch(name, fn, lib, v.device, v.data_ptr(), m.data_ptr(), g, w,
            cnt.data_ptr(), *(o.data_ptr() for o in outs))
    s, mean, mn, mx, ssd = outs
    return {"count": cnt, "sum": s, "mean": mean, "min": mn, "max": mx,
            "ssd": ssd}


# -- (G, W) bucket stats: selectors ------------------------------------------

_BIG = 2**31 - 1


def _time_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 pair -> int64 key hi * 2^30 + lo; 0 <= lo < 2^30, so
    the key orders exactly as the pair does lexicographically."""
    return hi.to(torch.int64) * (1 << 30) + lo.to(torch.int64)


def _pick_col(cand: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    big = torch.tensor(_BIG, dtype=col.dtype, device=col.device)
    return torch.where(cand, col, big).amin(dim=1)


def _first_last_col(v, key, cand, col, latest: bool):
    i64 = torch.iinfo(torch.int64)
    if latest:
        ext = torch.where(cand, key, i64.min).amax(dim=1, keepdim=True)
    else:
        ext = torch.where(cand, key, i64.max).amin(dim=1, keepdim=True)
    c3 = cand & (key == ext)
    ninf = torch.tensor(-float("inf"), dtype=v.dtype, device=v.device)
    v_ext = torch.where(c3, v, ninf).amax(dim=1, keepdim=True)
    return _pick_col(c3 & (v == v_ext), col)


def _earliest_col(key, cand, col):
    ext = torch.where(cand, key, torch.iinfo(torch.int64).max).amin(
        dim=1, keepdim=True)
    return _pick_col(cand & (key == ext), col)


def bucket_stats_selectors_plain(v, hi, lo, idx, m) -> dict:
    """Plain form of kernel 2 (the XLA 'selectors' of models/ragged.py and
    the TPU _sel_kernel)."""
    g, w = v.shape
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    key = _time_key(hi, lo)
    col = torch.arange(w, dtype=torch.int64, device=v.device)[None, :]
    mn = torch.where(m, v, inf).amin(dim=1, keepdim=True)
    mx = torch.where(m, v, -inf).amax(dim=1, keepdim=True)

    def clip(c):
        return c.clamp(0, w - 1)

    cf = clip(_first_last_col(v, key, m, col, latest=False))
    cl = clip(_first_last_col(v, key, m, col, latest=True))
    cmin = clip(_earliest_col(key, m & (v == mn), col))
    cmax = clip(_earliest_col(key, m & (v == mx), col))

    def take(mat, c):
        return torch.gather(mat, 1, c[:, None])[:, 0]

    return {
        "first": take(v, cf), "last": take(v, cl),
        "sel_first": take(idx, cf), "sel_last": take(idx, cl),
        "sel_min": take(idx, cmin), "sel_max": take(idx, cmax),
    }


def _selector_outputs(dtype: torch.dtype, g: int, device):
    """Kernel 2's outputs from one allocation: (first, last) of `dtype`
    and the four int32 selections, (g,) rows of one buffer."""
    buf = torch.empty((2 + 16 // dtype.itemsize) * g, dtype=dtype,
                      device=device)
    return (buf[:2 * g].view(2, g).unbind(0),
            buf[2 * g:].view(torch.int32).view(4, g).unbind(0))


def bucket_stats_selectors(v, hi, lo, idx, m) -> dict:
    """first/last values and first/last/min/max sample indices per row of
    (G, W) bucket rows; the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    name = "bucket_stats_selectors"
    _check(name, v, ints=(hi, lo, idx), mask=m)
    if not _require_cuda_or_cpu(name, v):
        return bucket_stats_selectors_plain(v, hi, lo, idx, m)
    lib, fn = _entry(name, v.dtype)
    g, w = v.shape
    (first, last), sels = _selector_outputs(v.dtype, g, v.device)
    _launch(name, fn, lib, v.device, v.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), idx.data_ptr(), m.data_ptr(), g, w,
            first.data_ptr(), last.data_ptr(), *(s.data_ptr() for s in sels))
    sf, sl, smin, smax = sels
    return {"first": first, "last": last, "sel_first": sf, "sel_last": sl,
            "sel_min": smin, "sel_max": smax}


# -- (S, K, W) regular-grid window aggregation -------------------------------

grid_window_agg_plain = _seg.grid_window_agg_t  # plain form of kernel 3


def _grid_outputs(dtype: torch.dtype, s_dim: int, w: int, device):
    """Kernel 3's outputs from one allocation: sum, mean, min and max of
    `dtype`, then the int32 counts, (s_dim, w) each, in one buffer. Each
    starts 16-byte aligned wherever the kernel's vector path applies (w a
    multiple of 16 / itemsize)."""
    n = s_dim * w
    buf = torch.empty(4 * n + -(-4 * n // dtype.itemsize), dtype=dtype,
                      device=device)
    return (buf[:4 * n].view(4, s_dim, w).unbind(0),
            buf[4 * n:].view(torch.int32)[:n].view(s_dim, w))


def grid_window_agg(v: torch.Tensor, m: torch.Tensor) -> dict:
    """count/sum/mean/min/max per (series, window) of an (S, K, W) grid,
    reduced over K; the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    name = "grid_window_agg"
    _check(name, v, mask=m, dim=3)
    if not _require_cuda_or_cpu(name, v):
        return grid_window_agg_plain(v, m)
    lib, fn = _entry(name, v.dtype)
    s_dim, k, w = v.shape
    outs, cnt = _grid_outputs(v.dtype, s_dim, w, v.device)
    _launch(name, fn, lib, v.device, v.data_ptr(), m.data_ptr(), s_dim, k, w,
            cnt.data_ptr(), *(o.data_ptr() for o in outs))
    s, mean, mn, mx = outs
    return {"count": cnt, "sum": s, "mean": mean, "min": mn, "max": mx}


# -- packed widen and bit unpack (device decode) ------------------------------
#
# Both kernels take a host table of segments of one 1-D uint8 payload
# and compute, in one launch, the concatenation in table order of the
# TPU kernel's function applied to each segment. The table rides in the
# launch's parameters: no device copy of it. The single-block forms are
# its one-row case.


class _Rows(threading.local):
    """One table row per thread as ctypes arrays, reused by every call:
    the single-block forms pass their row without building numpy or
    ctypes objects (a call is timed against one torch call)."""

    def __init__(self):
        self.row2 = (_LL * 2)()
        self.row3 = (_LL * 3)()


_rows = _Rows()


def _check_raw(name: str, raw: torch.Tensor) -> None:
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise TypeError(f"{name}: expected a 1-D uint8 tensor")
    if not raw.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _segment_table(name: str, raw: torch.Tensor, segs, cols: int):
    """A host segment table as checked int64 rows: (src_byte_off, cnt,
    width) for cols 3, (src_byte_off, nbytes) for cols 2, each inside
    `raw`, at most MAX_SEGMENTS of them."""
    table = np.ascontiguousarray(segs, dtype=np.int64).reshape(-1, cols)
    if len(table) > MAX_SEGMENTS:
        raise ValueError(f"{name}: {len(table)} segments, at most "
                         f"{MAX_SEGMENTS} per launch")
    nbytes = table[:, 1] * table[:, 2] if cols == 3 else table[:, 1]
    if cols == 3 and not ((table[:, 2] == 1) | (table[:, 2] == 2)).all():
        raise ValueError(f"{name}: width must be 1 or 2")
    if (table[:, :2] < 0).any() or (table[:, 0] + nbytes > raw.numel()).any():
        raise ValueError(f"{name}: a segment lies outside the "
                         f"{raw.numel()} bytes given")
    return table


def _launch_segments(name: str, raw: torch.Tensor, device, table,
                     rows: int, n_out: int):
    """One launch of kernel `name` over a checked host table of `rows`
    int64 rows (a numpy array or a ctypes array) into a fresh (n_out,)
    int32 output; no launch (and no count) when it is empty."""
    out = torch.empty(n_out, dtype=torch.int32, device=device)
    if n_out:
        ptr = out.data_ptr()
        if ptr % 16:
            raise RuntimeError(f"{name}: output not 16-byte aligned")
        lib, fn = _entry(name)
        if isinstance(table, np.ndarray):
            table = table.ctypes.data
        _launch(name, fn, lib, device, raw.data_ptr(), table, rows, ptr)
    return out


def widen_packed_plain(raw: torch.Tensor, width: int, cnt: int) -> torch.Tensor:
    """Plain form of kernel 4 (the TPU _widen_kernel): `cnt` unsigned
    little-endian `width`-byte values -> int32."""
    b = raw.reshape(cnt, width).to(torch.int32)
    acc = b[:, 0].clone()
    for j in range(1, width):
        acc |= b[:, j] << (8 * j)
    return acc


def widen_packed_segments_plain(raw: torch.Tensor, segs) -> torch.Tensor:
    """Plain form of the segmented kernel 4: widen_packed_plain of each
    (src_byte_off, cnt, width) row's bytes, concatenated in row order."""
    table = np.asarray(segs, dtype=np.int64).reshape(-1, 3)
    parts = [widen_packed_plain(raw[s:s + c * w], w, c)
             for s, c, w in table.tolist()]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=raw.device)
    return torch.cat(parts)


def widen_packed_segments(raw: torch.Tensor, segs) -> torch.Tensor:
    """Widen every (src_byte_off, cnt, width) row of the host table
    `segs` (width 1 or 2 per row, at most MAX_SEGMENTS rows) of the
    packed payload `raw` to int32 and concatenate them in row order, in
    one launch; the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    name = "widen_packed"
    _check_raw(name, raw)
    table = _segment_table(name, raw, segs, 3)
    if not _require_cuda_or_cpu(name, raw):
        return widen_packed_segments_plain(raw, table)
    return _launch_segments(name, raw, raw.device, table, len(table),
                            int(table[:, 1].sum()))


def widen_packed(raw: torch.Tensor, width: int, cnt: int) -> torch.Tensor:
    """Widen `cnt` packed little-endian `width`-byte (1 or 2) unsigned
    values to int32: the one-segment case of widen_packed_segments."""
    name = "widen_packed"
    if width not in (1, 2):
        raise ValueError(f"{name}: width must be 1 or 2, got {width}")
    _check_raw(name, raw)
    if raw.numel() != cnt * width:
        raise ValueError(f"{name}: {raw.numel()} bytes given, "
                         f"{cnt * width} expected")
    if raw.is_cuda:  # first: the host time of this call is what counts
        row = _rows.row3
        row[1] = cnt
        row[2] = width
        return _launch_segments(name, raw, raw.device, row, 1, cnt)
    _require_cuda_or_cpu(name, raw)  # raises unless on the CPU
    return widen_packed_plain(raw, width, cnt)


def unpack_bits_plain(raw: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain form of kernel 5 (the TPU _unpack_bits_kernel): bytes ->
    (nbytes * 8,) int32 bits, MSB first within each byte."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=raw.device)
    return ((raw.to(torch.int32)[:, None] >> shifts) & 1).reshape(nbytes * 8)


def unpack_bits_segments_plain(raw: torch.Tensor, segs) -> torch.Tensor:
    """Plain form of the segmented kernel 5: unpack_bits_plain of each
    (src_byte_off, nbytes) row's bytes, concatenated in row order."""
    table = np.asarray(segs, dtype=np.int64).reshape(-1, 2)
    parts = [unpack_bits_plain(raw[s:s + n], n) for s, n in table.tolist()]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=raw.device)
    return torch.cat(parts)


def unpack_bits_segments(raw: torch.Tensor, segs) -> torch.Tensor:
    """Unpack every (src_byte_off, nbytes) row of the host table `segs`
    (at most MAX_SEGMENTS rows) of `raw` into int32 bits, MSB first per
    byte, concatenated in row order ((8 * sum nbytes,)), in one launch;
    the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    name = "unpack_bits"
    _check_raw(name, raw)
    table = _segment_table(name, raw, segs, 2)
    if not _require_cuda_or_cpu(name, raw):
        return unpack_bits_segments_plain(raw, table)
    return _launch_segments(name, raw, raw.device, table, len(table),
                            8 * int(table[:, 1].sum()))


def unpack_bits(raw: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Unpack `nbytes` bytes into (nbytes * 8,) int32 bits, MSB first per
    byte (np.unpackbits order): the one-segment case of
    unpack_bits_segments."""
    name = "unpack_bits"
    _check_raw(name, raw)
    if raw.numel() != nbytes:
        raise ValueError(f"{name}: {raw.numel()} bytes given, "
                         f"{nbytes} expected")
    if raw.is_cuda:
        row = _rows.row2
        row[1] = nbytes
        return _launch_segments(name, raw, raw.device, row, 1, 8 * nbytes)
    _require_cuda_or_cpu(name, raw)  # raises unless on the CPU
    return unpack_bits_plain(raw, nbytes)


# -- capability probe ----------------------------------------------------------


def probe_count_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain form of kernel 6 (the TPU probe kernel): masked count of
    every row of an int8 (R, C) matrix, int32 (R, 1)."""
    return (m != 0).sum(dim=1, keepdim=True, dtype=torch.int32)


def probe_count(m: torch.Tensor) -> torch.Tensor:
    """Masked row count of an int8 (R, C) matrix into int32 (R, 1); the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    name = "probe_count"
    if m.dtype != torch.int8 or m.dim() != 2:
        raise TypeError(f"{name}: expected a 2-D int8 tensor")
    if not m.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if not _require_cuda_or_cpu(name, m):
        return probe_count_plain(m)
    lib, fn = _entry(name)
    rows, cols = m.shape
    out = torch.empty((rows, 1), dtype=torch.int32, device=m.device)
    _launch(name, fn, lib, m.device, m.data_ptr(), rows, cols, out.data_ptr())
    return out
