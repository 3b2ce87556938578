"""The port's sketches (query/sketch.py), percentile_approx and
percentile_ogsketch against the JAX package, on the CPU.

The reference's tests/test_sketch.py cases: each sketch gets the same
seeded values in both packages and gives the same answer (bit for bit:
both are the same numpy arithmetic), held also to the reference's own
error bounds; percentile_approx and percentile_ogsketch run through both
executors on the same writes, from chunk histograms (no decode: the
port's ``read_chunk`` is not called), from the memtable and from both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from opengemini_tpu.query import sketch as jsk
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import sketch as tsk
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import tsf as ttsf
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_040


class Pair:
    def __init__(self, root):
        self.je = JEngine(str(root / "jax"), sync_wal=False)
        self.te = TEngine(str(root / "torch"), device="cpu", sync_wal=False)
        for e in (self.je, self.te):
            e.create_database("db")
        self.jx, self.tx = JExecutor(self.je), TExecutor(self.te)

    def write(self, lines, flush=False):
        for e in (self.je, self.te):
            e.write_lines("db", "\n".join(lines))
            if flush:
                e.flush_all()

    def query(self, text):
        """Both answers, equal; returns the port's."""
        now = (BASE + 100_000) * NS
        got = self.tx.execute(text, db="db", now_ns=now)
        assert got == self.jx.execute(text, db="db", now_ns=now)
        return got


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.je.close()
    p.te.close()


def _value(res, i=0):
    return res["results"][0]["series"][i]["values"][0][1]


# -- HistSketch -----------------------------------------------------------------


def test_percentile_accuracy(rng):
    vals = rng.normal(50, 10, size=100_000)
    sks = [mod.HistSketch(vals.min(), vals.max()) for mod in (jsk, tsk)]
    for sk in sks:
        sk.add_values(vals)
    spread = vals.max() - vals.min()
    for p in (10, 50, 90, 99):
        approx = sks[1].percentile(p)
        assert approx == sks[0].percentile(p)
        assert abs(approx - np.percentile(vals, p)) <= spread / 256 * 2, p


def test_merge_chunk_hists(rng):
    a = rng.uniform(0, 50, size=5000)
    b = rng.uniform(40, 100, size=5000)
    ha = np.histogram(a, bins=32, range=(a.min(), a.max()))[0].tolist()
    hb = np.histogram(b, bins=32, range=(b.min(), b.max()))[0].tolist()
    got = []
    for mod in (jsk, tsk):
        sk = mod.HistSketch(min(a.min(), b.min()), max(a.max(), b.max()))
        sk.add_chunk_hist(a.min(), a.max(), ha)
        sk.add_chunk_hist(b.min(), b.max(), hb)
        got.append((sk.percentile(50), sk.counts.tolist(), sk.total))
    assert got[0] == got[1]
    allv = np.concatenate([a, b])
    assert abs(got[1][0] - np.percentile(allv, 50)) <= \
        (allv.max() - allv.min()) / 32


# -- percentile_approx through the executors --------------------------------------


def test_from_chunks_without_decode(pair, monkeypatch, rng):
    vals = rng.normal(100, 20, size=2000)
    pair.write([f"m v={v} {(BASE + i) * NS}" for i, v in enumerate(vals)],
               flush=True)
    calls = {"n": 0}
    orig = ttsf.TSFReader.read_chunk

    def counting(self, *a, **kw):
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(ttsf.TSFReader, "read_chunk", counting)
    approx = _value(pair.query("SELECT percentile_approx(v, 90) FROM m"))
    assert calls["n"] == 0  # metadata only
    assert abs(approx - np.percentile(vals, 90)) <= \
        (vals.max() - vals.min()) / 32


def test_mixed_memtable_exact_binning(pair):
    pair.write([f"m v={v} {(BASE + v) * NS}" for v in range(50)], flush=True)
    pair.write([f"m v={v} {(BASE + v) * NS}" for v in range(50, 100)])
    approx = _value(pair.query("SELECT percentile_approx(v, 50) FROM m"))
    assert abs(approx - 50) <= 99 / 32 + 1


def test_group_by_tags(pair):
    pair.write([f"m,h={'a' if i % 2 else 'b'} v={i} {(BASE + i) * NS}"
                for i in range(200)])
    res = pair.query("SELECT percentile_approx(v, 99) FROM m GROUP BY h")
    got = {s["tags"]["h"]: s["values"][0][1]
           for s in res["results"][0]["series"]}
    assert abs(got["a"] - 197) < 10 and abs(got["b"] - 196) < 10


def test_packed_series_bin_their_values(pair, rng):
    """64 series or more in a flush: packed chunks, so each series'
    values decode and bin directly: within one global bin width of the
    nearest-rank percentile the sketch estimates (numpy's
    ``inverted_cdf``)."""
    n = ttsf.PACK_MIN_SERIES + 6
    vals = rng.normal(10, 3, size=(n, 40))
    pair.write([f"m,s=s{s} v={vals[s, i]} {(BASE + i) * NS}"
                for s in range(n) for i in range(40)], flush=True)
    res = pair.query("SELECT percentile_approx(v, 95) FROM m GROUP BY s")
    for ser in res["results"][0]["series"]:
        s = int(ser["tags"]["s"][1:])
        width = (vals[s].max() - vals[s].min()) / tsk.GLOBAL_BINS
        exact = np.percentile(vals[s], 95, method="inverted_cdf")
        assert abs(ser["values"][0][1] - exact) <= width * (1 + 1e-9)


def test_constant_series_bin_is_one_wide(pair):
    """A series whose values never change (a walk held at 100): the
    sketch's range is empty, its one bin 1.0 wide, and the answer within
    it, in both packages alike."""
    pair.write([f"m,s=s{s} v={100.0 if s % 2 else s + 0.5 * (i % 3)} "
                f"{(BASE + i) * NS}"
                for s in range(ttsf.PACK_MIN_SERIES + 2) for i in range(30)],
               flush=True)
    res = pair.query("SELECT percentile_approx(v, 95) FROM m GROUP BY s")
    for ser in res["results"][0]["series"]:
        if int(ser["tags"]["s"][1:]) % 2:
            assert 100.0 <= ser["values"][0][1] <= 101.0


@pytest.mark.parametrize("text", [
    "SELECT percentile_approx(s, 50) FROM m",
    "SELECT percentile_approx(v) FROM m",
    "SELECT percentile_approx(v, 50) FROM m GROUP BY time(1m)",
    "SELECT percentile_approx(v, 500) FROM m",
    "SELECT percentile_approx(v, -1) FROM m",
    "SELECT percentile_approx(v, 50) FROM m WHERE v > 0",
])
def test_errors(pair, text):
    pair.write([f'm v=1,s="x" {BASE * NS}'])
    assert "error" in pair.query(text)["results"][0]


def test_nonfinite_values_ignored(pair):
    pair.write([f"m v={i} {(BASE + i) * NS}" for i in range(10)]
               + [f"m v=nan {(BASE + 50) * NS}", f"m v=inf {(BASE + 51) * NS}"])
    v = _value(pair.query("SELECT percentile_approx(v, 50) FROM m"))
    assert np.isfinite(v) and 0 <= v <= 9


def test_limit_offset_honored(pair):
    pair.write([f"m v=1 {BASE * NS}"])
    res = pair.query("SELECT percentile_approx(v, 50) FROM m OFFSET 1")
    assert "series" not in res["results"][0]


# -- OGSketch -------------------------------------------------------------------


def test_ogsketch_quantile_accuracy_bounds():
    rng = np.random.default_rng(3)
    for dist in (rng.lognormal(0, 1, 100_000), rng.normal(50, 5, 100_000),
                 rng.integers(0, 100, 100_000).astype(float)):
        sks = [mod.OGSketch(100) for mod in (jsk, tsk)]
        for lo in range(0, len(dist), 7_000):
            for s in sks:
                s.insert(dist[lo:lo + 7_000])
        spread = float(dist.max() - dist.min())
        for q in (0.01, 0.1, 0.5, 0.9, 0.99):
            approx = sks[1].quantile(q)
            assert approx == sks[0].quantile(q)
            assert abs(approx - float(np.quantile(dist, q))) <= \
                0.01 * spread + 1e-9
        assert len(sks[1].means) < 3 * sks[1].compression


def test_ogsketch_merge_equals_combined_build():
    data = np.random.default_rng(4).exponential(2.0, 60_000)
    got = []
    for mod in (jsk, tsk):
        whole = mod.OGSketch(100)
        whole.insert(data)
        parts = [mod.OGSketch(100) for _ in range(4)]
        for i, p in enumerate(parts):
            p.insert(data[i::4])
        for p in parts[1:]:
            parts[0].merge(p)
        got.append([parts[0].quantile(q) for q in (0.1, 0.5, 0.95)])
        for q, m in zip((0.1, 0.5, 0.95), got[-1]):
            assert abs(m - whole.quantile(q)) <= 0.01 * (data.max() - data.min())
    assert got[0] == got[1]


def test_ogsketch_wire_and_extremes():
    s = tsk.OGSketch(50)
    s.insert([5.0, 1.0, 9.0, 3.0])
    raw = s.serialize()
    js = jsk.OGSketch(50)
    js.insert([5.0, 1.0, 9.0, 3.0])
    assert raw == js.serialize()
    t = tsk.OGSketch.deserialize(raw)
    assert t.quantile(0.0) == 1.0 and t.quantile(1.0) == 9.0
    assert abs(t.quantile(0.5) - s.quantile(0.5)) < 1e-12
    assert np.isnan(tsk.OGSketch(50).quantile(0.5))


def test_sql_percentile_ogsketch(pair):
    vals = np.random.default_rng(5).normal(100, 10, 3000)
    pair.write([f"m v={v} {(BASE + i) * NS}" for i, v in enumerate(vals)])
    got = _value(pair.query("SELECT percentile_ogsketch(v, 50) FROM m"))
    assert abs(got - float(np.quantile(vals, 0.5))) < 1.0
    r2 = pair.query(f"SELECT percentile_ogsketch(v, 90) FROM m WHERE "
                    f"time >= {BASE * NS} AND time < {(BASE + 3000) * NS} "
                    "GROUP BY time(10m)")
    # BASE is 1m- but not 10m-aligned: 50 min of data spans 6 windows
    assert len(r2["results"][0]["series"][0]["values"]) == 6


# -- count-min ------------------------------------------------------------------


def test_countmin_never_underestimates_and_matches_jax():
    items = np.random.default_rng(6).zipf(1.3, 200_000) % 10_000
    cms = [mod.CountMinSketch(width=4096, depth=4) for mod in (jsk, tsk)]
    for cm in cms:
        cm.add(items)
    assert np.array_equal(cms[0].counts, cms[1].counts)
    true = np.bincount(items, minlength=10_000)
    over = []
    for i in range(0, 10_000, 131):
        est = cms[1].count(i)
        assert est >= true[i]
        over.append(est - true[i])
    assert np.mean(over) < 2 * len(items) / 4096


def test_countmin_merge_wire_and_key_types():
    a = tsk.CountMinSketch(width=512, depth=3)
    b = tsk.CountMinSketch(width=512, depth=3)
    a.add(["x", "y", "x"])
    b.add(["x", "z"])
    a.merge(b)
    assert a.count("x") >= 3 and a.count("z") >= 1
    c = tsk.CountMinSketch.deserialize(a.serialize())
    assert c.count("x") == a.count("x")
    ja = jsk.CountMinSketch(width=512, depth=3)
    ja.add(["x", "y", "x", "x", "z"])
    assert ja.serialize() == a.serialize()
    cm = tsk.CountMinSketch()
    cm.add(np.asarray([1.5, 1.5, 2.5]))
    cm.add(np.asarray([7, 7, 7], dtype=np.int64))
    assert cm.count(1.5) >= 2 and cm.count(7) >= 3
