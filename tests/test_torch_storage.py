"""The port's storage layer against the JAX package: the same bytes on
disk (chunk meta, TSF files, WAL frames), each package reading what the
other wrote (TSF, WAL, the mergeset series index, meta.json, whole
roots), WAL replay across a restart, and the bulk load's durability.

Answers of the port against the port (a restart) compare as JSON,
exactly. Answers of the port against the JAX package compare exactly
except floats, which agree within rel 1e-12 (tests/test_torch_e2e.py's
tolerance): torch and XLA sum a window's values in different orders, so
means and standard deviations can differ in the last bits.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from opengemini_tpu import native as jnative  # noqa: E402
from opengemini_tpu.query.executor import Executor as JExecutor  # noqa: E402
from opengemini_tpu.record import Column as JColumn  # noqa: E402
from opengemini_tpu.record import FieldType as JFieldType  # noqa: E402
from opengemini_tpu.record import Record as JRecord  # noqa: E402
from opengemini_tpu.storage import chunkmeta as jchunkmeta  # noqa: E402
from opengemini_tpu.storage import tsf as jtsf  # noqa: E402
from opengemini_tpu.storage import wal as jwal  # noqa: E402
from opengemini_tpu.storage.engine import Engine as JEngine  # noqa: E402

from opengemini_tpu_torch import convert  # noqa: E402
from opengemini_tpu_torch.index.mergeset import MergesetIndex  # noqa: E402
from opengemini_tpu_torch.query.executor import Executor  # noqa: E402
from opengemini_tpu_torch.record import Column, FieldType, Record  # noqa: E402
from opengemini_tpu_torch.storage import chunkmeta, tsf, wal  # noqa: E402
from opengemini_tpu_torch.storage.engine import Engine  # noqa: E402
from opengemini_tpu_torch.storage.shard import Shard  # noqa: E402
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS  # noqa: E402


def _stat(key: str) -> int:
    """A port counter by its "module/name" key."""
    module, name = key.split("/", 1)
    return TSTATS.counters(module).get(name, 0)


torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000
LO, HI = BASE * NS, (BASE + 120 * 20 + 60) * NS
PLO, PHI = (BASE + 300) * NS, (BASE + 1500) * NS
# tests/test_device_decode.py QUERIES
QUERIES = [
    "SELECT count(vi), min(vi), max(vi) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} GROUP BY time(1m)",
    "SELECT mean(vf), sum(vf), stddev(vf), first(vf), last(vf) FROM cpu "
    "WHERE time >= {lo} AND time < {hi} GROUP BY time(90s), host",
    "SELECT count(sparse), max(sparse) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} GROUP BY time(2m)",
    "SELECT mean(vf), count(vi) FROM cpu WHERE time >= {plo} AND "
    "time < {phi} GROUP BY time(1m)",
]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_codecs():
    """The JAX package writes native gorilla/varint blocks only when its
    codec library is built (its own tests build it the same way)."""
    if jnative.load() is None:
        assert jnative.build(), "g++ build of native/codecs.cpp failed"


@pytest.fixture(params=["0", "1"])
def profile(request, monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", request.param)
    return request.param


def _lines(rng, hosts=70, points=120, t0=BASE):
    """tests/test_device_decode.py _write_random_shard's rows: regular
    int and float fields, a sparse field, some 20 s series."""
    out = []
    for h in range(hosts):
        step = int(rng.choice([10, 10, 10, 20]))
        for p in range(points):
            t = (t0 + p * step) * NS
            f = f"cpu,host=h{h} vi={int(rng.integers(0, 250))}i," \
                f"vf={float(rng.standard_normal()):.6f}"
            if rng.random() < 0.3:
                f += f",sparse={float(rng.random()):.4f}"
            out.append(f"{f} {t}")
    return "\n".join(out)


def _answers(executor) -> list:
    return [executor.execute(q.format(lo=LO, hi=HI, plo=PLO, phi=PHI),
                             db="db") for q in QUERIES]


def _close(a, b, path="$"):
    """Exact except floats (rel 1e-12); see the module docstring."""
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


def _same_json(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _record_pair(rng, n=300):
    """The same record in both packages' types."""
    times = np.sort(rng.choice(10**6, n, replace=False)).astype(np.int64)
    cols = {
        "f": (FieldType.FLOAT, np.round(np.cumsum(rng.standard_normal(n)), 2),
              rng.random(n) < 0.9),
        "i": (FieldType.INT, np.cumsum(rng.integers(0, 900, n)),
              np.ones(n, bool)),
        "b": (FieldType.BOOL, rng.random(n) < 0.5, np.ones(n, bool)),
        "s": (FieldType.STRING,
              rng.choice(["a", "bb", "ccc"], n).astype(object),
              np.ones(n, bool)),
    }
    t = Record(times, {k: Column(ft, v, ok) for k, (ft, v, ok) in cols.items()})
    j = JRecord(times, {k: JColumn(JFieldType(int(ft)), v, ok)
                        for k, (ft, v, ok) in cols.items()})
    return t, j


# -- the same bytes -------------------------------------------------------------


def test_chunkmeta_bytes_identical_to_jax():
    meta = {"cpu": {"schema": {"a": 1, "b": 2}, "chunks": [
        {"sid": 7, "rows": 3, "tmin": -5, "tmax": 9, "time": [8, 20],
         "cols": {"a": {"v": [28, 10], "m": None,
                        "pre": [3, 1.5, 2.5, 6.0, [1, 2]]},
                  "b": {"v": [38, 4], "m": [42, 6],
                        "pre": [2, 1, 2**60, 2**61, None]}}},
        {"packed": 1, "smin": 1, "smax": 9, "sids": [50, 12],
         "sparse": [[1, 0], [5, 1024]], "rows": 2000, "tmin": 0,
         "tmax": 99, "time": [62, 8],
         "cols": {"a": {"v": [70, 9], "m": None,
                        "pre": [0, None, None, None, None]}}},
    ]}}
    buf = chunkmeta.encode_meta(meta)
    assert buf == jchunkmeta.encode_meta(meta)
    assert chunkmeta.decode_meta(buf) == jchunkmeta.decode_meta(buf)


def test_tsf_file_bytes_identical_to_jax(tmp_path, profile):
    rng = np.random.default_rng(3)
    t_rec, j_rec = _record_pair(rng)
    sids = np.repeat(np.arange(1, 4, dtype=np.int64), 100)
    pt = tsf.TSFWriter(str(tmp_path / "t.tsf"))
    pj = jtsf.TSFWriter(str(tmp_path / "j.tsf"))
    for w, rec in ((pt, t_rec), (pj, j_rec)):
        w.add_chunk("m1", 5, rec)
        w.add_packed_chunk("m2", sids, rec)
        w.finish()
    assert (tmp_path / "t.tsf").read_bytes() == (tmp_path / "j.tsf").read_bytes()


def test_wal_frames_identical_to_jax(tmp_path):
    pts = [("cpu", (("host", "a"),), 5 * NS,
            {"v": (FieldType.FLOAT, 1.5), "n": (FieldType.INT, 3)})]
    jpts = [("cpu", (("host", "a"),), 5 * NS,
             {"v": (JFieldType.FLOAT, 1.5), "n": (JFieldType.INT, 3)})]
    big = b"cpu,host=a v=1 1\n" * 70_000  # the uncompressed kind
    tw, jw = wal.WAL(str(tmp_path / "t.log")), jwal.WAL(str(tmp_path / "j.log"))
    for w, p in ((tw, pts), (jw, jpts)):
        w.append_lines("cpu,host=a v=2 10", "ns", 123)
        w.append_points(p)
        w.append_lines(big, "s", 456)
        w.flush()
        w.close()
    assert (tmp_path / "t.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    got = list(wal.WAL.replay(str(tmp_path / "j.log")))
    assert got[0] == ("lines", b"cpu,host=a v=2 10", "ns", 123)
    assert got[1] == ("points", pts) and got[2][1] == big


# -- each reads the other -----------------------------------------------------


def test_tsf_cross_read_and_crc(tmp_path, profile):
    rng = np.random.default_rng(4)
    t_rec, j_rec = _record_pair(rng)
    sids = np.repeat(np.arange(1, 4, dtype=np.int64), 100)
    w = jtsf.TSFWriter(str(tmp_path / "j.tsf"))
    w.add_packed_chunk("m", sids, j_rec)
    w.finish()
    r = tsf.TSFReader(str(tmp_path / "j.tsf"))
    (c,) = r.chunks("m")
    for encoded_ok in (False, True):
        s_arr, rec = r.read_packed_bulk("m", c, encoded_ok=encoded_ok)
        np.testing.assert_array_equal(s_arr, sids)
        for name, col in t_rec.columns.items():
            np.testing.assert_array_equal(rec.columns[name].values,
                                          col.values)
            np.testing.assert_array_equal(rec.columns[name].valid, col.valid)
    one = r.read_packed_sid("m", c, 2, encoded_ok=True)
    np.testing.assert_array_equal(one.times, t_rec.times[100:200])
    r.close()
    # the port's file reads back in the JAX package
    w = tsf.TSFWriter(str(tmp_path / "t.tsf"))
    w.add_chunk("m", 9, t_rec)
    w.finish()
    jr = jtsf.TSFReader(str(tmp_path / "t.tsf"))
    got = jr.read_chunk("m", jr.chunks("m")[0])
    np.testing.assert_array_equal(got.columns["i"].values,
                                  t_rec.columns["i"].values)
    jr.close()
    # a flipped bit in a data block raises before any value is used
    raw = bytearray((tmp_path / "t.tsf").read_bytes())
    raw[len(tsf.MAGIC2) + 3] ^= 0x10
    (tmp_path / "t.tsf").write_bytes(bytes(raw))
    r = tsf.TSFReader(str(tmp_path / "t.tsf"))
    with pytest.raises(tsf.CorruptFile, match="crc"):
        r.read_chunk("m", r.chunks("m")[0])
    r.close()


def test_wal_torn_tail_and_interior_salvage(tmp_path):
    path = str(tmp_path / "wal.log")
    w = wal.WAL(path)
    for i in range(3):
        w.append_lines(f"cpu,host=a v={i} {i + 1}", "ns", 0)
    w.flush()
    w.close()
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-3])  # torn tail
    assert len(list(wal.WAL.replay(path))) == 2
    bad = bytearray(data)
    bad[wal._HEADER.size + 2] ^= 0xFF  # damage the first frame
    open(path, "wb").write(bytes(bad))
    got = []
    with pytest.raises(wal.WALCorruption) as err:
        for e in wal.WAL.replay(path):
            got.append(e)
    assert got == [] and len(err.value.salvaged_entries()) == 2
    # a shard re-applies the salvaged frames and rewrites a clean log
    sh_dir = tmp_path / "shard"
    sh_dir.mkdir()
    open(sh_dir / "wal.log", "wb").write(bytes(bad))
    sh = Shard(str(sh_dir), 0, 2**62)
    assert len(sh.mem) == 2
    assert list((sh_dir / "quarantine").iterdir())
    assert len(list(wal.WAL.replay(str(sh_dir / "wal.log")))) == 2
    sh.close()


def test_mergeset_index_opens_the_jax_index(tmp_path):
    je = JEngine(str(tmp_path))
    je.create_database("db")
    je.write_lines("db", _lines(np.random.default_rng(1), hosts=20,
                                points=3))
    je.flush_all()
    (jsh,) = je.shards_for_range("db", None, 0, 2**62)
    want = {s: jsh.index.series_entry(s)
            for s in sorted(jsh.index.series_ids("cpu"))}
    je.close()
    idx = MergesetIndex(os.path.join(jsh.path, "seriesidx"))
    assert {s: idx.series_entry(s)
            for s in sorted(idx.series_ids("cpu"))} == want
    assert idx.measurements() == ["cpu"]
    assert idx.tag_keys("cpu") == ["host"]
    assert len(idx.match_eq("cpu", "host", "h3")) == 1
    assert len(idx.match_regex("cpu", "host", "^h1")) == 11
    assert idx.get_or_create("cpu", (("host", "h3"),)) in want
    idx.close()


@pytest.mark.parametrize("flush_first", [True, False])
def test_port_reopens_a_jax_root(tmp_path, profile, flush_first):
    """The JAX engine writes and flushes, then writes more without
    flushing; the port reopens the root (meta, mergeset index, TSF, WAL
    replay) and answers like the JAX engine."""
    rng = np.random.default_rng(42)
    je = JEngine(str(tmp_path))
    je.create_database("db")
    je.write_lines("db", _lines(rng))
    if flush_first:
        je.flush_all()
    je.write_lines("db", _lines(rng, hosts=30, points=40, t0=BASE + 1200))
    want = _answers(JExecutor(je))
    je.close()
    te = Engine(str(tmp_path), device="cpu")
    got = _answers(Executor(te))
    assert all(r["results"][0].get("series") for r in got)
    _close(got, want)
    te.close()


def test_jax_reopens_a_port_root(tmp_path, profile):
    """The port writes, flushes and leaves a WAL tail; the JAX engine
    reopens the root and answers like the port."""
    rng = np.random.default_rng(43)
    te = Engine(str(tmp_path), device="cpu")
    te.create_database("db")
    te.write_lines("db", _lines(rng))
    te.flush_all()
    te.write_lines("db", _lines(rng, hosts=30, points=40, t0=BASE + 1200))
    want = _answers(Executor(te))
    (sh,) = te.shards_for_range("db", None, 0, 2**62)
    te.close()
    assert [f for f in os.listdir(sh.path) if f.endswith(".tsf")]
    assert os.path.getsize(os.path.join(sh.path, "wal.log")) > 0
    je = JEngine(str(tmp_path))
    _close(_answers(JExecutor(je)), want)
    je.close()


def test_restart_replays_the_wal(tmp_path, profile):
    """Rows only the WAL holds survive a restart, with the same answers;
    a second restart after a flush answers the same from files alone."""
    rng = np.random.default_rng(44)
    te = Engine(str(tmp_path), device="cpu")
    te.create_database("db")
    te.write_lines("db", _lines(rng))
    want = _answers(Executor(te))
    te.close()
    te = Engine(str(tmp_path), device="cpu")
    assert _same_json(_answers(Executor(te)), want)
    te.flush_all()
    te.close()
    te = Engine(str(tmp_path), device="cpu")
    (sh,) = te.shards_for_range("db", None, 0, 2**62)
    assert len(sh.mem) == 0 and sh._files
    assert _same_json(_answers(Executor(te)), want)
    te.close()


def test_threshold_flush_and_meta_keys(tmp_path):
    """A write past flush_threshold_bytes flushes the shard; meta.json
    keys the port does not interpret survive its save, and so do the
    subscriptions it reads."""
    je = JEngine(str(tmp_path))
    je.create_database("db")
    je.close()
    meta = json.loads((tmp_path / "meta.json").read_text())
    sub = {"name": "kept", "mode": "ALL", "destinations": ["http://h:1"]}
    meta["databases"][0]["subscriptions"] = [sub]
    meta["databases"][0]["future_key"] = {"kept": [1, 2]}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    te = Engine(str(tmp_path), device="cpu", flush_threshold_bytes=1 << 10)
    te.create_database("db2")
    te.write_lines("db2", _lines(np.random.default_rng(5), hosts=4,
                                 points=10))
    (sh,) = te.shards_for_range("db2", None, 0, 2**62)
    assert len(sh.mem) == 0 and len(sh._files) == 1
    te.close()
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["databases"][0]["subscriptions"] == [sub]
    assert meta["databases"][0]["future_key"] == {"kept": [1, 2]}
    assert [d["name"] for d in meta["databases"]] == ["db", "db2"]


@pytest.mark.parametrize("load_rows", [None, 500])
def test_load_columnar_is_durable_on_return(tmp_path, profile, monkeypatch,
                                            load_rows):
    """The bulk load logs its rows to the WAL as line protocol: on return
    they are in the memtable and the WAL, and the JAX engine replays them
    to the same answers. Loaded 500 rows per WAL entry under a 64 KiB
    threshold, the load flushes on its way, as writes do."""
    from opengemini_tpu_torch.storage import engine as engine_mod

    rng = np.random.default_rng(6)
    hosts, n = 70, 60
    times = (BASE + np.arange(n, dtype=np.int64) * 10) * NS
    table = {
        "series_keys": [f"cpu,host=h{h}" for h in range(hosts)],
        "series": np.repeat(np.arange(hosts), n),
        "times": np.tile(times, hosts),
        "fields": {"vf": (np.round(rng.standard_normal(hosts * n), 3),
                          np.ones(hosts * n, bool)),
                   "vi": (rng.integers(0, 250, hosts * n),
                          np.ones(hosts * n, bool))},
    }
    if load_rows is None:
        te = Engine(str(tmp_path), device="cpu")
    else:
        monkeypatch.setattr(engine_mod, "LOAD_ROWS", load_rows)
        te = Engine(str(tmp_path), device="cpu",
                    flush_threshold_bytes=64 << 10)
    te.create_database("db")
    assert convert.load_columnar(te, "db", {"cpu": table}) == hosts * n
    (sh,) = te.shards_for_range("db", None, 0, 2**62)
    if load_rows is None:
        assert len(sh.mem) == hosts * n and not sh._files
    else:
        assert len(sh._files) >= 2 and len(sh.mem) < hosts * n
    want = _answers(Executor(te))
    te.close()
    je = JEngine(str(tmp_path))
    _close(_answers(JExecutor(je)), want)
    je.close()


def test_line_writer_round_trips_through_both_parsers():
    """The WAL text of a columnar batch parses back, in either package,
    to its rows: every field type, escaped keys and names, NaN and
    infinities, the extreme int64 values; rows of other measurements'
    columns carry only their own fields."""
    from opengemini_tpu.ingest import line_protocol as jlp

    from opengemini_tpu_torch.ingest import line_protocol as tlp
    from opengemini_tpu_torch.ingest.native_lp import (ColumnarBatch,
                                                       LineWriter)

    rng = np.random.default_rng(9)
    n = 2000
    keys = ["cpu,host=a", "cpu,host=b\\ c\\,d", "mem\\ x,host=e\\=f"]
    mst = np.array([0, 0, 1])
    ref = rng.integers(0, 3, n)
    ts = rng.integers(-2**62, 2**62, n)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    f[:5] = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    i = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    i[:2] = [-2**63, 2**63 - 1]
    b = rng.random(n) < 0.5
    s = np.array(['q"uo\\te,= x' * int(k) for k in rng.integers(0, 3, n)],
                 dtype=object)
    own = mst[ref] == 0
    cols = [(0, "f loat", FieldType.FLOAT, f, own & (rng.random(n) < .7)),
            (0, "i,nt", FieldType.INT, i, own & (rng.random(n) < .7)),
            (0, "b=ool", FieldType.BOOL, b, own & (rng.random(n) < .7)),
            (0, "s", FieldType.STRING, s, own & (rng.random(n) < .7)),
            (1, "m", FieldType.FLOAT, f, ~own)]
    batch = ColumnarBatch(ts, ref, keys, mst, ["cpu", "mem\\ x"], cols)
    rows = np.flatnonzero(np.logical_or.reduce([c[4] for c in cols]))
    text = LineWriter(batch).lines(rows)
    for parse, key in ((tlp.parse_lines, tlp.series_key),
                       (jlp.parse_lines, jlp.series_key)):
        points = parse(text, "ns", 0)
        assert len(points) == len(rows)
        for r, (m, tags, t, fields) in zip(rows.tolist(), points):
            assert key(m, tags) == keys[ref[r]] and t == ts[r]
            want = {name: (ft, vals[r]) for _m, name, ft, vals, ok in cols
                    if ok[r]}
            assert sorted(fields) == sorted(want)
            for name, (ft, v) in want.items():
                got_t, got = fields[name]
                assert int(got_t) == int(ft)
                if ft == FieldType.FLOAT:
                    assert np.float64(got).tobytes() == np.float64(v).tobytes() \
                        or (math.isnan(got) and math.isnan(v))
                else:
                    assert got == v


@pytest.mark.parametrize("kind", ["base64", "escaped", "non_ascii",
                                  "empty", "newline"])
def test_line_writer_string_column_one_pass(kind):
    """A string column's quoted blob, built in one pass where no value
    needs escaping, equals the value-by-value blob; other columns take
    the value-by-value path, which rejects a newline."""
    import base64

    from opengemini_tpu_torch.ingest import native_lp

    rng = np.random.default_rng(31)
    n = 300
    vals = {
        "base64": [base64.b64encode(rng.bytes(int(k))).decode()
                   for k in rng.integers(0, 70, n)],
        "escaped": ['a"b\\c' * int(k) for k in rng.integers(0, 3, n)],
        "non_ascii": ["\u00e9t\u00e9" * int(k) for k in rng.integers(0, 3, n)],
        "empty": [""] * n,
        "newline": ["a\nb"] * n,
    }[kind]
    values = np.array(vals + [None], dtype=object)
    ok = np.r_[rng.random(n) < 0.7, False].astype(np.bool_)
    ok[0] = True
    if kind == "newline":
        with pytest.raises(ValueError, match="holds a newline"):
            native_lp._quoted(values, ok.view(np.uint8), "s")
        return
    want = native_lp._blob([
        ('"' + v.replace("\\", "\\\\").replace('"', '\\"')
         + '"').encode() if o else b"" for v, o in zip(values, ok)])
    blob, off = native_lp._quoted(values, ok.view(np.uint8), "s")
    assert blob == want[0]
    assert off.tolist() == want[1].tolist()


def test_cold_scan_over_many_flushes_stays_encoded(tmp_path, monkeypatch):
    """Time-ordered loads flush one file per slice, each holding every
    series: the scan still decodes on the device, with the answers of
    the JAX package."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    rng = np.random.default_rng(8)
    te = Engine(str(tmp_path / "t"), device="cpu")
    je = JEngine(str(tmp_path / "j"))
    for e in (te, je):
        e.create_database("db")
    for s in range(3):
        body = _lines(rng, hosts=70, points=40, t0=BASE + 800 * s)
        for e in (te, je):
            e.write_lines("db", body)
            e.flush_all()
    before = (_stat("executor/grid_decode_fused"),
              _stat("device/decode_fallbacks_total"))
    got = _answers(Executor(te))
    assert _stat("executor/grid_decode_fused") > before[0]
    assert _stat("device/decode_fallbacks_total") == before[1]
    _close(got, _answers(JExecutor(je)))
    # one host: the per-series reads compose their encoded row runs in
    # the executor's scan stager
    q = ("SELECT mean(vf), count(vi), max(vi) FROM cpu WHERE host = 'h3' "
         f"AND time >= {LO} AND time < {HI} GROUP BY time(1m)")
    got = Executor(te).execute(q, db="db")
    assert got["results"][0]["series"][0]["values"]
    _close(got, JExecutor(je).execute(q, db="db"))
    te.close()
    je.close()


def test_rotated_segment_replays_and_sync_commit(tmp_path):
    """A crash between the WAL rotation and the TSF publish leaves a
    rotated segment: the reopened shard replays it (oldest first), and
    the next flush removes it. A sync WAL's commit fsyncs the append."""
    te = Engine(str(tmp_path), device="cpu", sync_wal=True)
    te.create_database("db")
    te.write_lines("db", _lines(np.random.default_rng(9), hosts=3,
                                points=5))
    (sh,) = te.shards_for_range("db", None, 0, 2**62)
    want = _answers(Executor(te))
    assert sh.wal._synced == sh.wal._seq > 0
    seg = sh.wal.rotate(os.path.join(sh.path, "wal.log.000001"))
    te.close()
    te = Engine(str(tmp_path), device="cpu")
    (sh,) = te.shards_for_range("db", None, 0, 2**62)
    assert sh._stale_wal_segs == [seg] and len(sh.mem) == 15
    assert _same_json(_answers(Executor(te)), want)
    te.flush_all()
    assert not os.path.exists(seg) and len(sh._files) == 1
    te.close()
