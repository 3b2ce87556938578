"""Hand-written CUDA kernels for the aggregation hot loop, with their
plain PyTorch versions.

The port of ``opengemini_tpu/ops/pallas_segment.py``. Three kernels
carry the InfluxQL aggregate path on the card:

  - ``bucket_stats_basic``     — (G, W) bucket rows: count/sum/mean/min/
                                 max/ssd (csrc/bucket_basic.cu)
  - ``bucket_stats_selectors`` — same rows: first/last values and the
                                 first/last/min/max sample indices
                                 (csrc/bucket_selectors.cu)
  - ``grid_window_agg``        — (S, K, W) regular grid: count/sum/mean/
                                 min/max per (series, window)
                                 (csrc/grid_window.cu)

Dispatch is by the device of the input tensor and nothing else: a CUDA
tensor launches the kernel (and counts the launch in ``LAUNCHES``), a
CPU tensor takes the plain version, any other device raises. There is no
fallback from a kernel that fails to build or launch; the error
propagates.

The kernels are built at first use with ``nvcc`` for ``sm_90a``, one
shared library with a plain C interface per source (no PyTorch headers,
so each builds in seconds), into ``build/torch_ext/`` at the repository
root, and loaded with ``ctypes``. All three sources compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from opengemini_tpu_torch.ops import segment as _seg

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "torch_ext")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> (source file, C symbol prefix)
_KERNELS = {
    "bucket_stats_basic": ("bucket_basic.cu", "ogt_bucket_basic"),
    "bucket_stats_selectors": ("bucket_selectors.cu", "ogt_bucket_selectors"),
    "grid_window_agg": ("grid_window.cu", "ogt_grid_window_agg"),
}

# launches of each kernel since the last reset_launches(); only the
# wrappers' kernel branches add to it
LAUNCHES = {name: 0 for name in _KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "bucket_stats_basic": [_P, _P, _LL, _I] + [_P] * 7,
    "bucket_stats_selectors": [_P] * 5 + [_LL, _I] + [_P] * 7,
    "grid_window_agg": [_P, _P, _LL, _I, _I] + [_P] * 6,
}

_libs: dict = {}
_build_lock = threading.Lock()


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
    A compile error raises with nvcc's output."""
    names = list(_KERNELS) if names is None else list(names)
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        os.makedirs(BUILD_DIR, exist_ok=True)
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
            prefix = _KERNELS[n][1]
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{prefix}_{suffix}")
                fn.argtypes = _ARGTYPES[n]
                fn.restype = ctypes.c_int
            lib.ogt_error_string.argtypes = [ctypes.c_int]
            lib.ogt_error_string.restype = ctypes.c_char_p
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def _entry(name: str, dtype: torch.dtype):
    lib = build([name])[name]
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: values must be float32 or float64, got {dtype}")
    return lib, getattr(lib, f"{_KERNELS[name][1]}_{suffix}")


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


def _launch(name: str, fn, lib, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*args, stream)
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


def bucket_stats_basic(v: torch.Tensor, m: torch.Tensor) -> dict:
    """count/sum/mean/min/max/ssd per row of (G, W) bucket rows; the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    name = "bucket_stats_basic"
    _check(name, v, mask=m)
    if not _require_cuda_or_cpu(name, v):
        return bucket_stats_basic_plain(v, m)
    lib, fn = _entry(name, v.dtype)
    g, w = v.shape
    cnt = torch.empty(g, dtype=torch.int32, device=v.device)
    outs = [torch.empty(g, dtype=v.dtype, device=v.device) for _ in range(5)]
    with torch.cuda.device(v.device):
        _launch(name, fn, lib, v.data_ptr(), m.data_ptr(), g, w,
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
    first = torch.empty(g, dtype=v.dtype, device=v.device)
    last = torch.empty(g, dtype=v.dtype, device=v.device)
    sels = [torch.empty(g, dtype=torch.int32, device=v.device)
            for _ in range(4)]
    with torch.cuda.device(v.device):
        _launch(name, fn, lib, v.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                idx.data_ptr(), m.data_ptr(), g, w, first.data_ptr(),
                last.data_ptr(), *(s.data_ptr() for s in sels))
    sf, sl, smin, smax = sels
    return {"first": first, "last": last, "sel_first": sf, "sel_last": sl,
            "sel_min": smin, "sel_max": smax}


# -- (S, K, W) regular-grid window aggregation -------------------------------

grid_window_agg_plain = _seg.grid_window_agg_t  # plain form of kernel 3


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
    cnt = torch.empty((s_dim, w), dtype=torch.int32, device=v.device)
    outs = [torch.empty((s_dim, w), dtype=v.dtype, device=v.device)
            for _ in range(4)]
    with torch.cuda.device(v.device):
        _launch(name, fn, lib, v.data_ptr(), m.data_ptr(), s_dim, k, w,
                cnt.data_ptr(), *(o.data_ptr() for o in outs))
    s, mean, mn, mx = outs
    return {"count": cnt, "sum": s, "mean": mean, "min": mn, "max": mx}
