"""The port's native line-protocol parser and its write path against the
JAX package's, on the CPU.

``parse_columnar`` of both packages binds the same native/lineproto.cpp
(the port builds it into build/native/); on the cases of
tests/test_native_lp.py the two must give the same columnar batch, the
same fallback (None) and the same error message and line.
``Engine.write_lines`` must then store what the reference stores: the
same query answers and the same merged rows, also when a large body is
parsed in segments on the ingest pool.
"""

import math

import numpy as np
import pytest
import torch

from opengemini_tpu.ingest import line_protocol as jlp
from opengemini_tpu.ingest import native_lp as jnative_lp
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import engine as jengine
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.ingest import line_protocol as tlp
from opengemini_tpu_torch.ingest import native_lp as tnative_lp
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import engine as tengine
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000
T0S = 1_451_606_400  # 2016-01-01T00:00:00Z, s

# tests/test_native_lp.py TestParserEquivalence.CASES
CASES = [
    b"cpu,host=h1,region=us usage_user=50.5,usage_sys=3i,up=t 1700000000000000000",
    b'cpu,host=h2 usage_user=60,msg="hello world, ok" 1700000001000000000',
    b"m,b=2,a=1,a=0 v=1",
    b"m,k=a=b f=1 5",
    b"mem,host=h1 free=123u 1700000002000000000",
    b"bools x=TRUE,y=F,z=false",
    b"neg v=-12.75e2 -1700000002000000000",
    b"m   f=1   1700000000000000001",
    b"# comment\n\nm f=1 7\r\nm f=2 8\r",
    b'strings s="",t="x,y z=1"',
    b"ints a=-9223372036854775808i,b=9223372036854775807i 1",
    b"floats a=inf,b=-inf,c=nan 1",
    b"dup f=1,f=2 9",
]
# ... ERRORS, and the body of the /write errno fault (line 2 is bad)
ERRORS = [
    b"novalue",
    b"m f=abc",
    b"m,=x f=1",
    b"m f= 1",
    b"m f=1 badts",
    b"m f=1,",
    b"m f=1 1 2 3",
    b'm s="unterminated 1',
    b"m f=99999999999999999999i 1",
    b"m f=1 99999999999999999999",
    b", f=1",
    b"m ,f=1",
    b"m f=0x10",
    b"cpu,host=c v=4 1\nbad line here\ncpu,host=c v=5 2",
]
# ... FALLBACKS: bodies only the exact Python parser takes
FALLBACKS = [
    b"m,h=a\\ b f=1",
    b'm f="say \\"hi\\""',
    b"m f=1_0",
    b"m f=1 1_000",
    b'm"x,t=1 f=1',
]


def _same_values(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    else:
        assert a.tolist() == b.tolist()


def _same_batch(got, want):
    assert len(got) == len(want)
    _same_values(got.ts, want.ts)
    _same_values(got.series_ref, want.series_ref)
    _same_values(got.series_mst, want.series_mst)
    assert got.series_keys == want.series_keys
    assert got.measurements == want.measurements
    assert len(got.cols) == len(want.cols)
    for (gm, gn, gt, gv, gok), (wm, wn, wt, wv, wok) in zip(got.cols,
                                                          want.cols):
        assert (gm, gn, int(gt)) == (wm, wn, int(wt))
        _same_values(gok, wok)
        _same_values(gv, wv)


@pytest.mark.parametrize("data", CASES)
def test_parse_columnar_matches_jax(data):
    got = tnative_lp.parse_columnar(data, now_ns=424242)
    want = jnative_lp.parse_columnar(data, now_ns=424242)
    assert got is not None and want is not None
    _same_batch(got, want)
    assert np.array_equal(got.row_mst(), want.row_mst())
    # and both rebuild the Python parser's points
    pts = tlp.parse_lines(data, now_ns=424242)
    back = got.to_points()
    assert [p[:3] for p in back] == [p[:3] for p in pts]


@pytest.mark.parametrize("precision", ["ns", "us", "ms", "s", "m", "h"])
def test_parse_columnar_precision_matches_jax(precision):
    got = tnative_lp.parse_columnar(b"m f=1 17000", precision=precision)
    want = jnative_lp.parse_columnar(b"m f=1 17000", precision=precision)
    _same_batch(got, want)


@pytest.mark.parametrize("data", ERRORS)
def test_parse_errors_match_jax(data):
    with pytest.raises(jlp.ParseError) as want:
        jnative_lp.parse_columnar(data)
    with pytest.raises(tlp.ParseError) as got:
        tnative_lp.parse_columnar(data)
    assert (got.value.lineno, got.value.msg) == (want.value.lineno,
                                                 want.value.msg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data", FALLBACKS)
def test_fallbacks_match_jax(data):
    assert jnative_lp.parse_columnar(data) is None
    assert tnative_lp.parse_columnar(data) is None


def test_library_builds_into_build_dir():
    from opengemini_tpu_torch import native

    path = native.build_shared("lineproto.cpp")
    assert path.startswith(native.BUILD_DIR)
    assert native.load_lineproto().ogt_lp_parse is not None


def test_failed_build_raises(monkeypatch, tmp_path):
    from opengemini_tpu_torch import native

    monkeypatch.setattr(native, "_LINEPROTO_LIB", None)
    monkeypatch.setattr(native, "_built", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="lineproto.cpp"):
        tnative_lp.parse_columnar(b"m f=1 1")


def _body(rng, hosts=12, points=300, t0=BASE):
    lines = []
    for p in range(points):
        for h in range(hosts):
            t = (t0 + p * 10) * NS
            lines.append(
                f"cpu,host=h{h},dc=d{h % 3} u={rng.normal():.17g},"
                f"n={int(rng.integers(-1000, 1000))}i,"
                f"ok={'t' if rng.random() < 0.5 else 'f'},"
                f's="v{int(rng.integers(0, 9))}" {t}')
        if p % 50 == 0:
            lines.append(f"disk,host=h{p % hosts} free={p}u {(t0 + p) * NS}")
    # escapes send a body to the Python parser
    lines.append(f"cpu,host=h\\ esc u=1.5 {(t0 + 1) * NS}")
    return "\n".join(lines).encode()


QUERIES = [
    "SELECT mean(u), max(u), count(u) FROM cpu GROUP BY time(5m), host",
    "SELECT sum(n), count(s), count(ok) FROM cpu GROUP BY dc",
    "SELECT first(u), last(u) FROM cpu WHERE host = 'h3'",
    "SELECT max(free) FROM disk GROUP BY host",
    "SELECT count(u) FROM cpu WHERE host = 'h esc'",
]


def _close(a, b, path="$"):
    """Equal, floats within rel 1e-12 (summation order)."""
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _stored(je, te):
    for q in QUERIES:
        want = JExecutor(je).execute(q, db="db", now_ns=(BASE + 10**5) * NS)
        got = TExecutor(te).execute(q, db="db", now_ns=(BASE + 10**5) * NS)
        assert "error" not in got["results"][0], (q, got)
        _close(got, want)
    for jsh, tsh in zip(je.all_shards(), te.all_shards()):
        assert jsh.path.split("data")[1] == tsh.path.split("data")[1]
        for mst in ("cpu", "disk"):
            js = np.asarray(sorted(jsh.index.series_ids(mst)), np.int64)
            ts_ = np.asarray(sorted(tsh.index.series_ids(mst)), np.int64)
            assert [jsh.index.series_entry(int(s)) for s in js] == [
                tsh.index.series_entry(int(s)) for s in ts_]
            jsid, jrec = jsh.read_series_bulk(mst, js)
            tsid, trec = tsh.read_series_bulk(mst, ts_)
            assert jsid.tolist() == tsid.tolist()
            assert jrec.times.tolist() == trec.times.tolist()
            assert sorted(jrec.columns) == sorted(trec.columns)
            for name, jc in jrec.columns.items():
                tc = trec.columns[name]
                assert np.asarray(jc.valid).tolist() == np.asarray(
                    tc.valid).tolist()
                ok = np.asarray(jc.valid)
                _same_values(np.asarray(jc.values)[ok],
                             np.asarray(tc.values)[ok])


@pytest.mark.parametrize("segmented", [False, True])
def test_write_lines_stores_like_jax(tmp_path, monkeypatch, segmented):
    if segmented:
        # force the multi-core path on a small body, in both packages
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, "_INGEST_WORKERS", 4)
            monkeypatch.setattr(mod, "_INGEST_SEGMENT_BYTES", 4096)
            monkeypatch.setattr(mod, "_ingest_pool_obj", None)
    rng = np.random.default_rng(5)
    body = _body(rng)
    escaped, plain = body.rsplit(b"\n", 1)[1], body.rsplit(b"\n", 1)[0]
    je = JEngine(str(tmp_path / "jax"))
    te = TEngine(str(tmp_path / "torch"), device="cpu")
    try:
        for e in (je, te):
            e.create_database("db")
            e.write_lines("db", plain, now_ns=BASE * NS)
            e.write_lines("db", escaped, now_ns=BASE * NS)
        _stored(je, te)
        for e in (je, te):
            e.flush_all()
        _stored(je, te)
    finally:
        je.close()
        te.close()
        if segmented:
            for mod in (jengine, tengine):
                if mod._ingest_pool_obj is not None:
                    mod._ingest_pool_obj.shutdown(wait=True)


def test_segmented_errors_match_jax(tmp_path, monkeypatch):
    """A bad line in a later segment reports its line in the whole body,
    and nothing of the body is stored."""
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, "_INGEST_WORKERS", 4)
        monkeypatch.setattr(mod, "_INGEST_SEGMENT_BYTES", 4096)
        monkeypatch.setattr(mod, "_ingest_pool_obj", None)
    body = _body(np.random.default_rng(6)).rsplit(b"\n", 1)[0]
    lines = body.split(b"\n")
    lines[len(lines) * 3 // 4] = b"cpu,host=x u=oops 1"
    bad = b"\n".join(lines)
    conflict = body + f"\ncpu,host=h1 u=3i {(BASE + 5) * NS}".encode()
    je = JEngine(str(tmp_path / "jax"))
    te = TEngine(str(tmp_path / "torch"), device="cpu")
    try:
        for e in (je, te):
            e.create_database("db")
        with pytest.raises(jlp.ParseError) as want:
            je.write_lines("db", bad)
        with pytest.raises(tlp.ParseError) as got:
            te.write_lines("db", bad)
        assert str(got.value) == str(want.value)
        with pytest.raises(Exception) as wantc:
            je.write_lines("db", conflict)
        with pytest.raises(Exception) as gotc:
            te.write_lines("db", conflict)
        assert str(gotc.value) == str(wantc.value)
        assert type(gotc.value).__name__ == type(wantc.value).__name__
        assert not any(len(sh.mem) for sh in te.all_shards())
    finally:
        je.close()
        te.close()
        for mod in (jengine, tengine):
            if mod._ingest_pool_obj is not None:
                mod._ingest_pool_obj.shutdown(wait=True)


def test_wal_replay_of_native_writes_matches_jax(tmp_path):
    """Native writes across two shard groups, a type conflict rejected
    before the WAL, then a restart without a flush: each package replays
    the other's WAL to the same answers."""
    week = 7 * 24 * 3600 * NS
    body = "\n".join(
        f"cpu,host=h{h} u={h + k * 0.25},n={k}i {(T0S + k * 3600) * NS + w * week}"
        for w in range(2) for h in range(5) for k in range(30)).encode()
    je = JEngine(str(tmp_path / "jax"))
    te = TEngine(str(tmp_path / "torch"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        assert e.write_lines("db", body) == 300
    with pytest.raises(Exception) as want:
        je.write_lines("db", f"cpu,host=h1 u=1i {T0S * NS}")
    with pytest.raises(Exception) as got:
        te.write_lines("db", f"cpu,host=h1 u=1i {T0S * NS}")
    assert (type(got.value).__name__, str(got.value)) == (
        type(want.value).__name__, str(want.value))
    assert len(te.all_shards()) == len(je.all_shards()) == 2
    je.close()
    te.close()
    q = ("SELECT mean(u), max(u), sum(n), count(u) FROM cpu "
         "GROUP BY time(1d), host")
    now = (T0S + 30 * 24 * 3600) * NS
    je2 = JEngine(str(tmp_path / "torch"))  # the port's WAL
    te2 = TEngine(str(tmp_path / "jax"), device="cpu")  # the JAX WAL
    try:
        want = JExecutor(je2).execute(q, db="db", now_ns=now)
        got = TExecutor(te2).execute(q, db="db", now_ns=now)
        assert sum(len(s["values"]) for s in got["results"][0]["series"])
        _close(got, want)
    finally:
        je2.close()
        te2.close()


def test_float_parse_is_bit_exact_with_python():
    """The native float parse equals Python's float() bit for bit, as the
    reference's does: replicas that parsed one write with either parser
    must store the same bits."""
    import random

    rng = random.Random(7)
    tokens = [repr(rng.uniform(-1e6, 1e6)) for _ in range(500)]
    tokens += ["1e-320", "2.2250738585072014e-308", "1.7976931348623157e308",
               "0.1", "0.30000000000000004", "123456789.123456789"]
    data = "\n".join(f"m v={t} {i}" for i, t in enumerate(tokens)).encode()
    got = tnative_lp.parse_columnar(data)
    want = jnative_lp.parse_columnar(data)
    _same_batch(got, want)
    [(_m, _n, _t, values, _ok)] = got.cols
    assert np.array_equal(values.view(np.uint64), np.array(
        [float(t) for t in tokens], np.float64).view(np.uint64))
