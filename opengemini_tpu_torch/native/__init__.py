"""ctypes bindings for the repository's C++ host libraries.

The port of ``opengemini_tpu/native/__init__.py``. The sources are the
repository's own ``native/*.cpp`` (shared with the JAX package, which
builds them in place with ``make``: the codecs, the series index and the
line-protocol parser, ``lineproto.cpp``, which
ingest/native_lp.parse_columnar binds) and the port's ``lpformat.cpp``
beside this file (the line-protocol text the bulk load logs to the WAL,
``ingest/native_lp.LineWriter``, and ``gorillascan.cpp``, the
structural scan of a gorilla stream that the device decode's host half
walks, ``gorilla_scan``); the port builds them with ``g++`` at
first use into ``build/native/`` at the repository root, named by a
hash of the source and flags, and never writes into ``native/``. A build that fails raises: the port never falls back to
another codec, because that would change the bytes written to disk and
hide the device decode path. The pure-Python gorilla/varint decoders
below are the oracles the native decoders and the device decoders are
tested against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_REPO, "native")
PORT_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_build_lock = threading.Lock()
_built: dict[str, str] = {}


def build_shared(source: str) -> str:
    """Compile ``native/<source>``, or the port's own source of that name
    beside this file, (when not already built) and return the shared
    library's path. Concurrent processes each compile into a temporary
    name and rename atomically, so they never see a partial library. A
    compile error raises with g++'s output."""
    with _build_lock:
        got = _built.get(source)
        if got is not None:
            return got
        src = os.path.join(PORT_SRC_DIR, source)
        if not os.path.exists(src):
            src = os.path.join(SRC_DIR, source)
        h = hashlib.sha256()
        with open(src, "rb") as f:
            h.update(f.read())
        h.update(" ".join(CXX_FLAGS).encode())
        stem = os.path.splitext(source)[0]
        out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            cxx = os.environ.get("CXX") or "g++"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cxx} failed for {os.path.relpath(src, _REPO)} "
                    f"({proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        _built[source] = out
        return out


_LIB = None
_lib_lock = threading.Lock()


def load():
    """The codec library (native/codecs.cpp), built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lib_lock:
        if _LIB is None:
            lib = ctypes.CDLL(build_shared("codecs.cpp"))
            for name in ("ogt_gorilla_encode", "ogt_gorilla_decode",
                         "ogt_varint_delta_encode",
                         "ogt_varint_delta_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]
            _LIB = lib
    return _LIB


_LP_LIB = None


def load_lpformat():
    """The line-protocol formatter (lpformat.cpp), built at first use."""
    global _LP_LIB
    if _LP_LIB is not None:
        return _LP_LIB
    with _lib_lock:
        if _LP_LIB is None:
            lib = ctypes.CDLL(build_shared("lpformat.cpp"))
            fn = lib.ogt_lp_format
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_int64, *[ctypes.c_void_p] * 5,
                           ctypes.c_int32, *[ctypes.c_void_p] * 6,
                           ctypes.c_void_p, ctypes.c_int64]
            _LP_LIB = lib
    return _LP_LIB


_SCAN_LIB = None


def load_gorillascan():
    """The gorilla structural scan (gorillascan.cpp), built at first
    use."""
    global _SCAN_LIB
    if _SCAN_LIB is not None:
        return _SCAN_LIB
    with _lib_lock:
        if _SCAN_LIB is None:
            lib = ctypes.CDLL(build_shared("gorillascan.cpp"))
            fn = lib.ogt_gorilla_scan
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           *[ctypes.c_void_p] * 4]
            _SCAN_LIB = lib
    return _SCAN_LIB


def gorilla_scan(payload: bytes, n: int):
    """(bitpos int32, mbits uint8, shift uint8, vals uint64) of one gorilla
    stream of `n` values, or None when it is malformed
    (gorillascan.cpp)."""
    bitpos = np.zeros(n, np.int32)
    mbits = np.zeros(n, np.uint8)
    shift = np.zeros(n, np.uint8)
    vals = np.zeros(n, np.uint64)
    buf = np.frombuffer(payload, np.uint8) if len(payload) else \
        np.zeros(1, np.uint8)
    got = load_gorillascan().ogt_gorilla_scan(
        buf.ctypes.data, len(payload), n, bitpos.ctypes.data,
        mbits.ctypes.data, shift.ctypes.data, vals.ctypes.data)
    if got != 0:
        return None
    return bitpos, mbits, shift, vals


_LINEPROTO_LIB = None


def load_lineproto():
    """The line-protocol parser (native/lineproto.cpp), built at first
    use; ogt_lp_parse returns an ``ingest.native_lp._LpBatch``."""
    global _LINEPROTO_LIB
    if _LINEPROTO_LIB is not None:
        return _LINEPROTO_LIB
    with _lib_lock:
        if _LINEPROTO_LIB is None:
            from opengemini_tpu_torch.ingest.native_lp import _LpBatch

            lib = ctypes.CDLL(build_shared("lineproto.cpp"))
            lib.ogt_lp_parse.restype = ctypes.POINTER(_LpBatch)
            lib.ogt_lp_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
            ]
            lib.ogt_lp_free.restype = None
            lib.ogt_lp_free.argtypes = [ctypes.POINTER(_LpBatch)]
            _LINEPROTO_LIB = lib
    return _LINEPROTO_LIB


# -- native-backed codecs ----------------------------------------------------


def gorilla_encode(values: np.ndarray) -> bytes | None:
    """Gorilla XOR stream of float64 values; None when the encoder
    reports the stream does not fit (the caller keeps another codec)."""
    lib = load()
    vals = np.ascontiguousarray(values, dtype=np.float64).view(np.uint64)
    cap = len(vals) * 10 + 16
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.ogt_gorilla_encode(vals.ctypes.data, len(vals), out.ctypes.data,
                               cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def gorilla_decode_native(buf: bytes, n: int) -> np.ndarray:
    lib = load()
    inp = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint64)
    got = lib.ogt_gorilla_decode(inp.ctypes.data, len(inp), out.ctypes.data, n)
    if got != n:
        raise ValueError("corrupt gorilla block")
    return out.view(np.float64)


def varint_delta_encode(values: np.ndarray) -> bytes | None:
    lib = load()
    vals = np.ascontiguousarray(values, dtype=np.int64)
    cap = len(vals) * 10 + 16
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.ogt_varint_delta_encode(vals.ctypes.data, len(vals),
                                    out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def varint_delta_decode_native(buf: bytes, n: int) -> np.ndarray:
    lib = load()
    inp = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.int64)
    got = lib.ogt_varint_delta_decode(inp.ctypes.data, len(inp),
                                      out.ctypes.data, n)
    if got != n:
        raise ValueError("corrupt varint block")
    return out


# -- pure-python decoders (the oracles) ---------------------------------------


def gorilla_decode_py(buf: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out.view(np.float64)
    bits = _Bits(buf)
    prev = bits.read(64)
    out[0] = prev
    lz = tz = 0
    for i in range(1, n):
        if bits.read(1) == 0:
            out[i] = prev
            continue
        if bits.read(1) == 1:
            lz = bits.read(5)
            mbits = bits.read(6) + 1
            tz = 64 - lz - mbits
            if tz < 0:
                raise ValueError("corrupt gorilla block")
        mbits = 64 - lz - tz
        x = bits.read(mbits) << tz
        prev ^= x
        out[i] = prev & 0xFFFFFFFFFFFFFFFF
    return out.view(np.float64)


def varint_delta_decode_py(buf: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    pos = 0
    prev = 0
    for i in range(n):
        u = 0
        shift = 0
        while True:
            if pos >= len(buf):
                raise ValueError("corrupt varint block")
            b = buf[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        delta = (u >> 1) ^ -(u & 1)
        # int64 wraparound semantics must match the native codec: deltas
        # may overflow int64 by design (encoded mod 2^64)
        prev = (prev + delta) & 0xFFFFFFFFFFFFFFFF
        out[i] = prev - (1 << 64) if prev >= (1 << 63) else prev
        prev = int(out[i])
    return out


class _Bits:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte_i = self.pos >> 3
            if byte_i >= len(self.buf):
                raise ValueError("truncated bit stream")
            bit = (self.buf[byte_i] >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v


def gorilla_decode(buf: bytes, n: int) -> np.ndarray:
    return gorilla_decode_native(buf, n)


def varint_delta_decode(buf: bytes, n: int) -> np.ndarray:
    return varint_delta_decode_native(buf, n)
