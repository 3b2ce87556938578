"""The port's block codecs and device decode against the JAX package.

Same seeded numpy inputs through both packages: the encoders must write
the same bytes (both profiles), every codec's device decode
(ops/device_decode.py, on the CPU through the kernels' plain versions)
must equal the JAX package's decode_to_device and the host decoders bit
for bit, and the plain versions of kernels 4-6 must equal the Pallas
kernels (interpret mode) and numpy. Tolerance: exact everywhere.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from opengemini_tpu import native as jnative  # noqa: E402
from opengemini_tpu.ops import device_decode as jdd  # noqa: E402
from opengemini_tpu.ops import pallas_segment as ps  # noqa: E402
from opengemini_tpu.record import Column as JColumn  # noqa: E402
from opengemini_tpu.record import FieldType as JFieldType  # noqa: E402
from opengemini_tpu.storage import encoding as jenc  # noqa: E402
from opengemini_tpu.utils import devobs as jdevobs  # noqa: E402

from opengemini_tpu_torch.ops import cuda_segment as cs  # noqa: E402
from opengemini_tpu_torch.ops import device_decode as tdd  # noqa: E402
from opengemini_tpu_torch.record import (  # noqa: E402
    Column, EncodedColumn, FieldType, Record, merge_bulk_parts)
from opengemini_tpu_torch.storage import encoding as tenc  # noqa: E402
from opengemini_tpu_torch.utils import devobs as tdevobs  # noqa: E402
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS  # noqa: E402


def _stat(key: str) -> int:
    """A port counter by its "module/name" key."""
    module, name = key.split("/", 1)
    return TSTATS.counters(module).get(name, 0)


torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000


@pytest.fixture(scope="module", autouse=True)
def _jax_native_codecs():
    """The JAX package writes native gorilla/varint blocks only when its
    codec library is built (its own tests build it the same way)."""
    if jnative.load() is None:
        assert jnative.build(), "g++ build of native/codecs.cpp failed"


@pytest.fixture
def profile(request, monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", request.param)
    return request.param


def _int_cases(rng):
    yield np.empty(0, np.int64)
    yield np.array([42], np.int64)
    yield np.arange(0, 5000, 7, dtype=np.int64)
    yield np.cumsum(rng.integers(0, 3, 400)).astype(np.int64)
    for scale in (200, 40_000, 2**20, 2**44):                # widths 1,2,4,8
        yield np.cumsum(rng.integers(0, scale, 300)).astype(np.int64)
    yield rng.integers(-2**62, 2**62, 257).astype(np.int64)
    yield np.array([5, 5, 5, 5, 9], np.int64)
    v = np.cumsum(rng.integers(-3, 4, 400)).astype(np.int64)
    v[::97] += 2**40
    yield v


def _float_cases(rng):
    yield np.empty(0, np.float64)
    yield np.repeat(3.25, 300)
    yield np.cumsum(rng.standard_normal(400)) + 50.0
    yield rng.standard_normal(513) * 1e18
    yield np.round(np.cumsum(rng.standard_normal(300)), 1)
    v = np.round(np.cumsum(rng.standard_normal(256)), 2)
    v[::11] = np.nan
    v[5] = np.inf
    v[6] = -np.inf
    v[7:9] = [0.0, -0.0]
    yield v
    yield np.zeros(200)
    yield np.array([3.5])


def _same_block(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (a.kind, a.n, a.first, a.step, a.width, bytes(a.payload),
            a.table) == (b.kind, b.n, b.first, b.step, b.width,
                         bytes(b.payload), b.table)


# -- (a) byte-identical encodings ---------------------------------------------


@pytest.mark.parametrize("profile", ["0", "1"], indirect=True)
def test_encodings_byte_identical_to_jax(profile):
    rng = np.random.default_rng(7)
    for _ in range(3):  # fuzz rounds
        for v in _int_cases(rng):
            a, b = tenc.encode_ints(v), jenc.encode_ints(v)
            assert a == b
            assert _same_block(tenc.device_block(a), jenc.device_block(b))
            np.testing.assert_array_equal(tenc.decode_ints(a), v)
        for v in _float_cases(rng):
            a, b = tenc.encode_floats(v), jenc.encode_floats(v)
            assert a == b
            assert _same_block(tenc.device_block(a), jenc.device_block(b))
            np.testing.assert_array_equal(
                tenc.decode_floats(a).view(np.uint64), v.view(np.uint64))
        bools = rng.random(77) < 0.4
        assert tenc.encode_bools(bools) == jenc.encode_bools(bools)
        for vals in (rng.choice(["info", "warn", "error"], 90).astype(object),
                     np.array([f"s{i}" for i in range(40)], dtype=object)):
            a, b = tenc.encode_strings(vals), jenc.encode_strings(vals)
            assert a == b
            assert _same_block(tenc.device_block(a), jenc.device_block(b))
        valid = rng.random(300) < 0.8
        fv = rng.standard_normal(300)
        assert tenc.encode_column(Column(FieldType.FLOAT, fv, valid)) == \
            jenc.encode_column(JColumn(JFieldType.FLOAT, fv, valid))


# -- (b) each codec's device decode, bit for bit ------------------------------


def _codec_blocks(rng):
    """(kind, block) pairs covering every device codec."""
    out = [("const", tenc.encode_ints(np.arange(0, 900, 9, dtype=np.int64)))]
    # deltas wide enough that FOR at each width beats the varint stream
    for lo, hi, width in ((64, 256, 1), (2**14, 2**16, 2),
                          (2**28, 2**31, 4), (2**56, 2**62, 8)):
        v = np.cumsum(rng.integers(lo, hi, 300)).astype(np.int64)
        buf = tenc.encode_ints(v)
        db = tenc.device_block(buf)
        assert (db.kind, db.width) == ("delta", width)
        out.append(("delta", buf))
    out.append(("raw64", tenc.encode_floats(rng.standard_normal(257))))
    for v in (np.round(np.cumsum(rng.standard_normal(300)), 1),
              np.repeat(rng.standard_normal(12), 40)):
        out.append(("gorilla", tenc.encode_floats(v)))
    v = np.repeat(np.round(rng.standard_normal(32), 1), 8)
    v[::11] = np.nan
    v[5], v[6], v[7:9] = np.inf, -np.inf, [0.0, -0.0]
    out.append(("gorilla", tenc.encode_floats(v)))
    v = np.cumsum(rng.integers(-3, 4, 400)).astype(np.int64)
    v[::97] += 2**40
    out.append(("varint", tenc.encode_ints(v)))
    out.append(("varint", tenc.encode_ints(
        np.array([2**62, -2**62, 0, -1, 1], np.int64))))
    out.append(("strdict", tenc.encode_strings(
        rng.choice(["info", "warn", "error", "debug"], 300).astype(object))))
    return out


def _host(buf):
    tag = buf[0] & 0x7F
    if tag in (tenc._T_RAW64, tenc._T_GORILLA):
        return tenc.decode_floats(buf).view(np.uint64)
    return tenc.decode_ints(buf)


@pytest.mark.parametrize("kind", ["const", "delta", "raw64", "gorilla",
                                  "varint", "strdict"])
def test_codec_decode_matches_jax_and_host(monkeypatch, kind):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(11)
    blocks = [b for k, b in _codec_blocks(rng) if k == kind]
    assert blocks and all(tenc.device_block(b).kind == kind for b in blocks)
    for buf in blocks:
        dtype = np.int64 if kind == "strdict" else None
        got = tdd.decode_to_device([buf], "cpu", dtype=dtype).numpy()
        want = np.asarray(jdd.decode_to_device([buf], dtype=dtype))
        if got.dtype == np.float64:
            got, want = got.view(np.uint64), want.view(np.uint64)
        np.testing.assert_array_equal(got, want)
        if kind == "strdict":
            db = tenc.device_block(buf)
            np.testing.assert_array_equal(
                np.asarray([db.table[i] for i in got], dtype=object),
                tenc.decode_strings(buf))
        else:
            np.testing.assert_array_equal(got, _host(buf))


def test_mixed_codec_plan_matches_jax(monkeypatch):
    """One decode over const+delta+raw64+gorilla+varint blocks: payload
    offsets and scan vectors line up per block."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(5)
    blocks = [b for k, b in _codec_blocks(rng) if k != "strdict"]
    got = tdd.decode_to_device(blocks, "cpu", dtype=np.float64).numpy()
    want = np.asarray(jdd.decode_to_device(blocks, dtype=np.float64))
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_gorilla_scan_matches_jax(monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(3)
    for _k, buf in [x for x in _codec_blocks(rng) if x[0] == "gorilla"]:
        db = tenc.device_block(buf)
        got = tdd._gorilla_scan(bytes(db.payload), db.n)
        want = jdd._gorilla_scan(bytes(db.payload), db.n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        # truncated streams: malformed at the same place in both
        for cut in (7, 9, len(db.payload) // 2, len(db.payload) - 1):
            got = tdd._gorilla_scan(bytes(db.payload)[:cut], db.n)
            want = jdd._gorilla_scan(bytes(db.payload)[:cut], db.n)
            assert (got is None) == (want is None)


@pytest.mark.parametrize("seed", range(6))
def test_gorilla_scan_matches_jax_on_random_streams(seed):
    """The native structural scan against the JAX package's walk: random
    float streams (repeats, small and large XORs, NaN and inf) encoded by
    the codec, and random bytes read as streams of random lengths
    (mostly malformed, at the same place in both)."""
    from opengemini_tpu_torch import native

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    vals = np.where(rng.random(n) < 0.3, 1.5,
                    rng.normal(0, 10.0 ** rng.integers(-3, 9), n))
    vals[rng.random(n) < 0.01] = np.nan
    vals[rng.random(n) < 0.01] = np.inf
    payloads = [(native.gorilla_encode(vals.astype(np.float64)), n)]
    for _ in range(20):
        raw = rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8)
        payloads.append((raw.tobytes(), int(rng.integers(0, 40))))
    for payload, m in payloads:
        got = tdd._gorilla_scan(payload, m)
        want = jdd._gorilla_scan(payload, m)
        assert (got is None) == (want is None), (payload, m)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# -- (c) plain versions of kernels 4-6 -----------------------------------------


@pytest.mark.parametrize("width", [1, 2])
def test_widen_plain_matches_pallas_and_numpy(width):
    rng = np.random.default_rng(width)
    for cnt in (1, 7, 255, 1031):
        raw = rng.integers(0, 256, cnt * width).astype(np.uint8)
        raw[:min(len(raw), 256)] = np.arange(min(len(raw), 256))
        got = cs.widen_packed(torch.from_numpy(raw), width, cnt).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.frombuffer(raw.tobytes(), {1: np.uint8, 2: "<u2"}[width])
            .astype(np.int32))
        want = np.asarray(ps._widen_call(jax.numpy.asarray(raw), width=width,
                                         cnt=cnt, interpret=True))
        np.testing.assert_array_equal(got, want)


def test_unpack_plain_matches_numpy_and_jax_path():
    rng = np.random.default_rng(1)
    for n in (1, 7, 8, 100_003):
        raw = rng.integers(0, 256, n).astype(np.uint8)
        got = cs.unpack_bits(torch.from_numpy(raw), n).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.unpackbits(raw))
        # the jnp path device_decode._unpack_bits takes off the TPU
        np.testing.assert_array_equal(
            got, np.asarray(jdd._unpack_bits(jax.numpy.asarray(raw), n)))
    # ps.unpack_bits itself cannot run in interpret mode on this JAX: the
    # kernel body captures a constant array, which Pallas rejects
    with pytest.raises(Exception, match="captures constants"):
        ps.unpack_bits(jax.numpy.asarray(raw), n)


def _widen_tables(rng, nraw):
    """Segment tables (src, cnt, width) over an `nraw`-byte payload: one
    segment, 256 segments (few distinct shapes, so the Pallas reference
    compiles few times), empty segments, odd offsets, mixed widths."""
    yield "one", [(0, 1031, 2)]
    rows, off = [], 1
    for r in range(256):
        cnt, w = ((0, 1), (1, 1), (7, 2), (33, 1))[r % 4]
        rows.append((off, cnt, w))
        off += cnt * w + 1  # an odd gap: odd source offsets
    yield "256", rows
    yield "empty", [(5, 0, 1), (5, 0, 2), (9, 3, 2), (20, 0, 1)]
    yield "odd-mixed", [(int(rng.integers(0, 50)) * 2 + 1, int(c), int(w))
                        for c, w in zip(rng.integers(1, 300, 9),
                                        rng.integers(1, 3, 9))]
    yield "reversed", [(900, 40, 2), (3, 41, 1), (0, 1, 1)]
    assert off < nraw


@pytest.mark.parametrize("table", ["one", "256", "empty", "odd-mixed",
                                   "reversed"])
def test_widen_segments_plain_matches_pallas_and_numpy(table):
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, 6000).astype(np.uint8)
    raw[:256] = np.arange(256)
    segs = dict(_widen_tables(rng, len(raw)))[table]
    got = cs.widen_packed_segments(torch.from_numpy(raw), segs).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, cs.widen_packed_segments_plain(torch.from_numpy(raw),
                                            segs).numpy())
    want_np, want_ps = [], []
    for src, cnt, w in segs:
        b = raw[src:src + cnt * w]
        want_np.append(np.frombuffer(b.tobytes(), {1: np.uint8, 2: "<u2"}[w])
                       .astype(np.int32))
        if cnt:
            want_ps.append(np.asarray(ps._widen_call(
                jax.numpy.asarray(b), width=w, cnt=cnt, interpret=True)))
    assert len(got) == sum(c for _s, c, _w in segs)
    np.testing.assert_array_equal(got, np.concatenate(want_np))
    np.testing.assert_array_equal(
        got, np.concatenate(want_ps) if want_ps else np.zeros(0, np.int32))


def _unpack_tables(rng, nraw):
    """Segment tables (src, nbytes): one, 256, empty, single-byte and odd
    offsets, and a few large segments in an order unlike the payload's."""
    yield "one", [(0, 100_003)]
    yield "256", [(3 * r + 1, int(rng.integers(0, 200)))
                  for r in range(256)]
    yield "empty", [(0, 0), (7, 0), (9, 1), (nraw, 0)]
    yield "single-bytes", [(int(s), 1) for s in rng.integers(0, nraw, 40)]
    yield "chunk", [(50_000, 20_001), (1, 30_000), (90_001, 9_999)]


@pytest.mark.parametrize("table", ["one", "256", "empty", "single-bytes",
                                   "chunk"])
def test_unpack_segments_plain_matches_numpy_and_jax_path(table):
    rng = np.random.default_rng(22)
    raw = rng.integers(0, 256, 100_003).astype(np.uint8)
    segs = dict(_unpack_tables(rng, len(raw)))[table]
    got = cs.unpack_bits_segments(torch.from_numpy(raw), segs).numpy()
    assert got.dtype == np.int32
    assert len(got) == 8 * sum(n for _s, n in segs)
    np.testing.assert_array_equal(
        got, cs.unpack_bits_segments_plain(torch.from_numpy(raw),
                                           segs).numpy())
    np.testing.assert_array_equal(got, np.concatenate(
        [np.unpackbits(raw[s:s + n]) for s, n in segs]))
    # the jnp path device_decode._unpack_bits takes off the TPU
    np.testing.assert_array_equal(got, np.concatenate(
        [np.asarray(jdd._unpack_bits(jax.numpy.asarray(raw[s:s + n]), n))
         for s, n in segs]))


def test_segment_wrappers_check_their_tables():
    raw = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="width"):
        cs.widen_packed_segments(raw, [(0, 4, 3)])
    with pytest.raises(ValueError, match="outside"):
        cs.widen_packed_segments(raw, [(60, 3, 2)])
    with pytest.raises(ValueError, match="outside"):
        cs.unpack_bits_segments(raw, [(-1, 2)])
    with pytest.raises(ValueError, match="at most"):
        cs.unpack_bits_segments(raw, [(0, 0)] * (cs.MAX_SEGMENTS + 1))
    with pytest.raises(TypeError):
        cs.unpack_bits_segments(raw.to(torch.int32), [(0, 1)])
    assert cs.widen_packed_segments(raw, []).shape == (0,)
    assert cs.unpack_bits_segments(raw, np.zeros((0, 2))).shape == (0,)


def test_probe_plain_counts_like_the_pallas_probe():
    got = cs.probe_count(torch.ones((8, 8), dtype=torch.int8))
    assert got.dtype == torch.int32 and got.shape == (8, 1)
    assert (got == 8).all()
    assert jdevobs._probe_pallas() == (True, "")
    m = np.random.default_rng(0).integers(-2, 3, (33, 17)).astype(np.int8)
    np.testing.assert_array_equal(
        cs.probe_count(torch.from_numpy(m)).numpy(),
        (m != 0).sum(axis=1, keepdims=True))
    tdevobs.probe("cpu")  # raises on a wrong count


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="width"):
        cs.widen_packed(torch.zeros(8, dtype=torch.uint8), 4, 2)
    with pytest.raises(TypeError):
        cs.unpack_bits(torch.zeros(8, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="bytes"):
        cs.unpack_bits(torch.zeros(8, dtype=torch.uint8), 9)
    with pytest.raises(TypeError):
        cs.probe_count(torch.ones((8, 8), dtype=torch.int32))


# -- plans: views, scatter, gate ----------------------------------------------


def test_affine_scatter_and_views_match_jax():
    rng = np.random.default_rng(2)
    n_runs, per = 6, 30
    rel = np.concatenate([np.arange(per, dtype=np.int64) * 10 * NS + r * 0
                          for r in range(n_runs)])
    starts = np.arange(n_runs, dtype=np.int64) * per
    every, dt, k, w_pad = 60 * NS, 10 * NS, 6, 8
    w = rel // every
    flat = ((np.repeat(np.arange(n_runs), per) * k
             + (rel - w * every) // dt) * w_pad + w)
    got = tdd._affine_scatter(flat, rel, starts, every, dt, k, w_pad)
    want = jdd._affine_scatter(flat, rel, starts, every, dt, k, w_pad)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    slots = tdd._affine_slots(torch.from_numpy(got[0]), int(got[1][0]),
                              len(rel), (n_runs, k, w_pad), every, dt)
    np.testing.assert_array_equal(slots.numpy(), flat)
    bad = rel.copy()
    bad[3] += NS  # irregular spacing inside a run
    assert tdd._affine_scatter(flat, bad, starts, every, dt, k, w_pad) is None
    views = [([b"a"], np.array([[2, 5], [7, 9]]), 10),
             ([b"b"], np.array([[0, 4]]), 6)]
    for a, b in zip(tdd.combine_views(views)[1:], jdd.combine_views(views)[1:]):
        np.testing.assert_array_equal(a, b)
    vals = torch.arange(16, dtype=torch.int64) * 3
    runs = torch.tensor([[2, 5], [7, 9], [10, 14]])
    np.testing.assert_array_equal(
        tdd._view_gather(vals, runs, 9).numpy(),
        np.asarray(jdd._view_gather(jax.numpy.asarray(vals.numpy()),
                                    jax.numpy.asarray(runs.numpy()), 9)))
    del rng


def test_cost_gate_refuses_a_transfer_losing_plan(monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(4)
    s_pad, k, w_pad = 8, 1, 128
    n = s_pad * k * w_pad
    blocks = [tenc.encode_floats(rng.standard_normal(n) * 1e17)]
    assert tenc.device_block(blocks[0]).kind == "raw64"
    views = [(blocks, np.array([[0, n]], np.int64), n)]
    before = _stat("device/decode_fallbacks_total")
    plan = tdd.build_grid_plan(views, rng.permutation(n).astype(np.int64),
                               np.ones(n, bool), (s_pad, k, w_pad),
                               np.float64, "cpu")
    assert plan is None
    assert _stat("device/decode_fallbacks_total") == before + 1


def test_encoded_merge_of_multi_series_parts_keeps_blocks(monkeypatch):
    """Packed chunks of two flushes (each holding every series for its
    own time stretch) merge into one encoded view in (sid, time) order,
    equal to the copying merge."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(9)
    parts, plain = [], []
    for f in range(2):
        sids = np.repeat(np.arange(1, 5, dtype=np.int64), 10)
        times = np.tile(np.arange(10, dtype=np.int64) + 10 * f, 4)
        v = np.round(rng.standard_normal(40), 2)
        col = EncodedColumn(FieldType.FLOAT, [tenc.encode_floats(v)],
                            np.ones(40, bool), tenc.decode_value_blocks)
        parts.append((sids, Record(times, {"v": col})))
        plain.append((sids, Record(times, {"v": Column(FieldType.FLOAT, v,
                                                       np.ones(40, bool))})))
    s1, r1 = merge_bulk_parts(parts, 3, 17)
    s2, r2 = merge_bulk_parts(plain, 3, 17)
    assert isinstance(r1.columns["v"], EncodedColumn)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(r1.times, r2.times)
    np.testing.assert_array_equal(r1.columns["v"].values, r2.columns["v"].values)
    got = tdd.decode_to_device(r1.columns["v"].blocks, "cpu")
    segs = r1.columns["v"].abs_segments()
    np.testing.assert_array_equal(
        tdd._view_gather(got, torch.from_numpy(segs), len(s1)).numpy(),
        r2.columns["v"].values)


# -- (e) the cold scan takes the fused path -----------------------------------


def _write_random(e, rng, hosts=70, points=120):
    lines = []
    for h in range(hosts):
        step = int(rng.choice([10, 10, 10, 20]))
        for p in range(points):
            t = (BASE + p * step) * NS
            f = f"cpu,host=h{h} vi={int(rng.integers(0, 250))}i," \
                f"vf={float(rng.standard_normal()):.6f}"
            if rng.random() < 0.3:
                f += f",sparse={float(rng.random()):.4f}"
            lines.append(f"{f} {t}")
    e.write_lines("db", "\n".join(lines))
    e.flush_all()


def test_cold_scan_takes_the_fused_path(tmp_path, monkeypatch):
    from opengemini_tpu.query.executor import Executor as JExecutor
    from opengemini_tpu.storage.engine import Engine as JEngine

    from opengemini_tpu_torch.query.executor import Executor
    from opengemini_tpu_torch.storage.engine import Engine

    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    te = Engine(str(tmp_path / "t"), device="cpu")
    je = JEngine(str(tmp_path / "j"))
    for e in (te, je):
        e.create_database("db")
        _write_random(e, np.random.default_rng(42), points=100)
    q = ("SELECT count(vi), min(vi), max(vi) FROM cpu WHERE time >= %d "
         "AND time < %d GROUP BY time(1m)" % (BASE * NS, (BASE + 4000) * NS))
    keys = ("executor/grid_decode_fused", "device/decode_fallbacks_total",
            "device/h2d_bytes_total", "executor/grid_batches")
    before = {k: _stat(k) for k in keys}
    got = Executor(te).execute(q, db="db")
    d = {k: _stat(k) - before[k] for k in keys}
    assert d["executor/grid_decode_fused"] >= 1
    assert d["device/decode_fallbacks_total"] == 0
    # the grid this scan fills: 70 series rows (padded) x 6 x windows
    nbytes = d["device/h2d_bytes_total"]
    assert 0 < nbytes < 9 * 8400 * 2, nbytes
    want = JExecutor(je).execute(q, db="db")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    te.close()
    je.close()



def test_concat_records_equals_the_pairwise_fold(monkeypatch):
    """The one-pass concat of many chunk records (merge_bulk_parts' fast
    path) equals Record.concat folded pairwise: encoded columns stay
    encoded, a column missing from a part pads invalid."""
    from opengemini_tpu_torch.record import concat_records

    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(12)
    recs = []
    for i in range(5):
        n = 30 + i
        v = np.round(rng.standard_normal(n), 2)
        cols = {"e": EncodedColumn(FieldType.FLOAT, [tenc.encode_floats(v)],
                                   rng.random(n) < 0.9,
                                   tenc.decode_value_blocks)}
        if i != 2:
            cols["p"] = Column(FieldType.INT, rng.integers(0, 9, n),
                               np.ones(n, bool))
        recs.append(Record(np.arange(n, dtype=np.int64) + 100 * i, cols))
    fold = recs[0]
    for r in recs[1:]:
        fold = fold.concat(r)
    got = concat_records(recs)
    assert isinstance(got.columns["e"], EncodedColumn)
    np.testing.assert_array_equal(got.times, fold.times)
    for k in ("e", "p"):
        np.testing.assert_array_equal(got.columns[k].values,
                                      fold.columns[k].values)
        np.testing.assert_array_equal(got.columns[k].valid,
                                      fold.columns[k].valid)


# -- (f) the batched decode: one widen per plan, unpacks per chunk ------------


def _gorilla_plan(rng, n_blocks=13):
    """Float blocks of many gorilla streams (20 to 900 values each),
    with a const, a raw64 and a varint block between them."""
    blocks = []
    for b in range(n_blocks):
        n = (20, 900, 377, 64, 512)[b % 5]
        v = np.round(np.cumsum(rng.standard_normal(n)), 1 + b % 3) + 50.0
        if b % 4 == 1:
            v[::7] = np.nan
        blocks.append(tenc.encode_floats(v))
        if b == 3:
            blocks.append(tenc.encode_floats(rng.standard_normal(60) * 1e17))
        if b == 8:
            blocks.append(tenc.encode_ints(np.arange(0, 90, 3,
                                                     dtype=np.int64)))
    kinds = [tenc.device_block(b).kind for b in blocks]
    assert kinds.count("gorilla") == n_blocks and "raw64" in kinds
    return blocks


def _delta_plan(rng):
    """Int blocks of FOR deltas at widths 1 and 2 (values near +-2^63 so
    the cumsum wraps), with a varint and a width-4 block between them."""
    blocks = []
    for b in range(11):
        lo, hi = ((0, 200), (2**14, 2**16))[b % 2]
        n = (300, 1, 2, 129, 1000)[b % 5]
        base = (2**63 - 2**19, -2**63, 0)[b % 3]
        v = np.int64(base) + np.cumsum(
            rng.integers(lo, hi, n)).astype(np.int64)
        blocks.append(tenc.encode_ints(v))
        if b == 4:
            v = np.cumsum(rng.integers(-3, 4, 200)).astype(np.int64)
            blocks.append(tenc.encode_ints(v))
        if b == 6:
            blocks.append(tenc.encode_ints(np.cumsum(
                rng.integers(2**28, 2**31, 90)).astype(np.int64)))
    dbs = [tenc.device_block(b) for b in blocks]
    assert {(d.kind, d.width) for d in dbs if d.kind == "delta"} >= {
        ("delta", 1), ("delta", 2), ("delta", 4)}
    assert any(d.kind == "varint" for d in dbs)
    return blocks


@pytest.mark.parametrize("chunk", ["real", "small"])
@pytest.mark.parametrize("plan", ["gorilla", "delta"])
def test_batched_decode_matches_jax_and_host(monkeypatch, plan, chunk):
    """A plan of many blocks decodes bit-identically to the JAX package
    and the host decoders, with chunks of the real size and with chunks
    that split the plan's gorilla blocks."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    if chunk == "small":
        monkeypatch.setattr(tdd, "_CHUNK_VALUES", 1000)
    rng = np.random.default_rng(31)
    blocks = _gorilla_plan(rng) if plan == "gorilla" else _delta_plan(rng)
    got = tdd.decode_to_device(blocks, "cpu").numpy()
    want = np.asarray(jdd.decode_to_device(blocks))
    host = np.concatenate([_host(b) for b in blocks])
    if got.dtype == np.float64:
        got, want = got.view(np.uint64), want.view(np.uint64)
        host = np.concatenate([
            _host(b) if tenc.device_block(b).kind != "const"
            else _host(b).astype(np.float64).view(np.uint64) for b in blocks])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_prefix_xor_matches_the_sequential_walk(n):
    x = np.random.default_rng(n).integers(-2**63, 2**63 - 1, n,
                                           dtype=np.int64)
    x[::5] = -1
    planes = np.unpackbits(x.view(np.uint8).reshape(n, 8), axis=1,
                           bitorder="little")
    got = tdd._prefix_xor(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_xor.accumulate(x))


def _count_calls(monkeypatch, name):
    calls = []
    original = getattr(cs, name)

    def counted(raw, segs):
        calls.append(len(np.asarray(segs).reshape(len(segs), -1))
                     if len(segs) else 0)
        return original(raw, segs)

    monkeypatch.setattr(cs, name, counted)
    return calls


@pytest.mark.parametrize("per_chunk", [1, 3, 4, 100])
def test_decode_calls_one_segmented_wrapper_per_plan_or_chunk(
        monkeypatch, per_chunk):
    """The batching without a card: the decode of a plan calls the widen
    wrapper once for all its width-1/2 blocks and the unpack wrapper
    once per chunk of ceil(blocks / blocks-per-chunk)."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(32)
    n, n_blocks = 200, 10
    gor = [tenc.encode_floats(
        np.round(np.cumsum(rng.standard_normal(n)), 1) + 50)
        for _ in range(n_blocks)]
    assert {tenc.device_block(b).kind for b in gor} == {"gorilla"}
    deltas = [tenc.encode_ints(np.cumsum(rng.integers(lo, hi, n)).astype(
        np.int64)) for lo, hi in ((0, 200), (2**14, 2**16))] * 5
    monkeypatch.setattr(tdd, "_CHUNK_VALUES", per_chunk * n)
    widen = _count_calls(monkeypatch, "widen_packed_segments")
    unpack = _count_calls(monkeypatch, "unpack_bits_segments")
    tdd.decode_to_device(gor, "cpu")
    assert widen == []
    # rows per call: whole chunks of per_chunk blocks, then the rest
    assert unpack == [min(per_chunk, n_blocks - i)
                      for i in range(0, n_blocks, per_chunk)]
    assert len(unpack) == -(-n_blocks // per_chunk)
    del unpack[:]
    tdd.decode_to_device(deltas, "cpu")
    assert widen == [len(deltas)] and unpack == []
