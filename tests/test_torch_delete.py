"""DELETE, DROP SERIES and the DROP MEASUREMENT purge of the port against
the JAX package's, on the CPU.

The same seeded writes go into a root of each package (two flushes of
70 hosts, so the files hold packed chunks, plus rows still in the
memtable); then the same statement runs through each package's executor
and the same queries must answer alike, in each package, and after each
package reopens the root the other rewrote. Also the decoded-column
cache eviction of a delete rewrite (tests/test_colcache.py
``test_delete_rewrite_evicts``) and that the incremental result cache
never serves a deleted row.
"""

import math
import os

import numpy as np
import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.ingest import line_protocol as tlp
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import colcache
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard

torch.set_num_threads(1)

NS = 10**9
T0 = 1_700_000_000
HOSTS = 70
STEPS = 40  # 10 s apart, per flush
WHERE = f"time >= {T0 * NS} AND time < {(T0 + 3 * STEPS * 10) * NS}"
QUERIES = [
    f"SELECT count(u), sum(u), max(u), min(u) FROM cpu WHERE {WHERE}",
    f"SELECT mean(u), count(u) FROM cpu WHERE {WHERE} GROUP BY time(2m)",
    f"SELECT count(u), last(u) FROM cpu WHERE {WHERE} GROUP BY host",
    f"SELECT count(msg) FROM log WHERE {WHERE} GROUP BY host",
    "SHOW SERIES",
    "SHOW MEASUREMENTS",
    "SHOW TAG VALUES FROM cpu WITH KEY = host",
]
PACKAGES = {"jax": (JEngine, JExecutor, {}),
            "torch": (TEngine, TExecutor, {"device": "cpu"})}
MSGS = ("sshd accepted password", "CRON session opened",
        "kernel Out of memory: Killed process")


def _bodies(seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for part in range(3):  # two flushed, the last stays in the memtable
        lines = []
        for s in range(STEPS):
            t = (T0 + (part * STEPS + s) * 10) * NS
            for h in range(HOSTS):
                lines.append(f"cpu,host=h{h},rack=r{h % 4} "
                             f"u={rng.normal():.17g} {t}")
            for h in range(0, HOSTS, 7):
                lines.append(f'log,host=h{h} msg="{MSGS[h % 3]}" {t}')
        out.append("\n".join(lines))
    return out


def _build(root, pkg):
    cls, _ex, kw = PACKAGES[pkg]
    e = cls(str(root), **kw)
    e.create_database("db")
    bodies = _bodies()
    for body in bodies[:-1]:
        e.write_lines("db", body)
        e.flush_all()
    e.write_lines("db", bodies[-1])
    return e


def _close(a, b, path="$"):
    """Equal, floats within rel 1e-12 (summation order)."""
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-300), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _answers(ex):
    return [ex.execute(q, db="db") for q in QUERIES]


STATEMENTS = {
    "by_tag": ["DELETE FROM cpu WHERE host = 'h3'"],
    "by_time": [f"DELETE FROM cpu WHERE time >= {(T0 + 150) * NS} AND "
                f"time < {(T0 + 650) * NS}"],
    "by_tag_and_time": [f"DELETE FROM cpu WHERE rack = 'r1' AND "
                        f"time < {(T0 + 500) * NS}"],
    "drop_series": ["DROP SERIES FROM cpu WHERE host = 'h5' OR host = 'h6'",
                    "DROP SERIES FROM log WHERE host = 'h14'"],
    "whole_measurement": ["DELETE FROM log"],
    "drop_measurement_then_write": [
        "DROP MEASUREMENT log",
        f'WRITE log,host=h0 msg="fresh start" {(T0 + 5) * NS}'],
}


def _run(e, ex, stmt):
    if stmt.startswith("WRITE "):
        return e.write_lines("db", stmt[len("WRITE "):])
    res = ex.execute(stmt, db="db")
    assert "error" not in res["results"][0], (stmt, res)
    return res


@pytest.mark.parametrize("case", sorted(STATEMENTS))
def test_delete_matches_jax(tmp_path, monkeypatch, case):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    engines = {pkg: _build(tmp_path / pkg, pkg) for pkg in PACKAGES}
    execs = {pkg: PACKAGES[pkg][1](e) for pkg, e in engines.items()}
    before = _answers(execs["torch"])
    _close(before, _answers(execs["jax"]))
    for stmt in STATEMENTS[case]:
        for pkg in PACKAGES:
            _run(engines[pkg], execs[pkg], stmt)
    got = _answers(execs["torch"])
    _close(got, _answers(execs["jax"]))
    assert got != before
    [sh] = engines["torch"].all_shards()
    assert sh.file_count() == 1  # one delete rewrite replaced the set
    if case == "drop_measurement_then_write":
        res = execs["torch"].execute("SELECT * FROM log", db="db")
        assert res["results"][0]["series"][0]["values"] == [
            [(T0 + 5) * NS, "h0", "fresh start"]]
    for e in engines.values():
        e.close()
    # each package reopens the root the other rewrote
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        cls, ex_cls, kw = PACKAGES[reader]
        e = cls(str(tmp_path / writer), **kw)
        _close(_answers(ex_cls(e)), got)
        e.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_drop_series_with_a_time_condition_is_refused(tmp_path, pkg):
    e = _build(tmp_path / pkg, pkg)
    ex = PACKAGES[pkg][1](e)
    for q, msg in (
            (f"DROP SERIES FROM cpu WHERE time > {T0 * NS}",
             "DROP SERIES does not support time conditions"),
            ("DELETE FROM cpu WHERE u > 0",
             "DELETE conditions may only reference time and tags"),
            ("DELETE WHERE host = 'h1'",
             "DELETE/DROP SERIES requires FROM <measurement>")):
        res = ex.execute(q, db="db")
        assert res["results"][0].get("error", "").endswith(msg), (q, res)
    e.close()


def test_show_series_after_drop_series(tmp_path):
    got = {}
    for pkg in PACKAGES:
        e = _build(tmp_path / pkg, pkg)
        ex = PACKAGES[pkg][1](e)
        ex.execute("DROP SERIES FROM cpu WHERE rack = 'r2'", db="db")
        got[pkg] = [ex.execute(q, db="db") for q in (
            "SHOW SERIES FROM cpu", "SHOW SERIES CARDINALITY",
            "SHOW TAG VALUES FROM cpu WITH KEY = rack")]
        e.close()
    assert got["torch"] == got["jax"]
    keys = [v[0] for v in got["torch"][0]["results"][0]["series"][0]["values"]]
    assert len(keys) == HOSTS - HOSTS // 4 - (HOSTS % 4 > 2)
    assert not [k for k in keys if "rack=r2" in k]


@pytest.fixture
def cache():
    cc = colcache.GLOBAL
    prev = cc.config()
    cc.clear()
    cc.configure(budget_mb=64, device=False)
    yield cc
    cc.configure(**prev)
    cc.clear()


def test_delete_rewrite_evicts(tmp_path, cache):
    """tests/test_colcache.py's case on the port's shard: the rewrite
    drops the retired file's cached columns."""
    sh = TShard(str(tmp_path / "s"), 0, 10**18)
    line = "cpu usage=1 1000000000\ncpu usage=2 2000000000"
    sh.write_points(tlp.parse_lines(line), line.encode(), "ns", 0)
    sh.flush()
    sid = sh.index.get_or_create("cpu", ())
    assert len(sh.read_series("cpu", sid)) == 2
    c0 = cache.counters()
    assert c0["bytes"] > 0
    sh.delete_data("cpu", tmin=0, tmax=1500000000)
    c1 = cache.counters()
    assert c1["invalidations"] > c0["invalidations"]
    assert sh.read_series("cpu", sid).columns["usage"].values.tolist() \
        == [2.0]
    sh.close()


def test_no_stale_result_cache_answer_after_a_delete(tmp_path, monkeypatch):
    """The incremental result cache on: the panel before a delete fills
    it; after the delete the panel must answer without the deleted rows,
    as the cache-off run and the JAX package do."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "1")
    panel = QUERIES[1]
    got = {}
    for pkg in PACKAGES:
        e = _build(tmp_path / pkg, pkg)
        ex = PACKAGES[pkg][1](e)
        first = ex.execute(panel, db="db")
        assert ex.execute(panel, db="db") == first  # a cache hit
        ex.execute(f"DELETE FROM cpu WHERE time >= {(T0 + 100) * NS} AND "
                   f"time < {(T0 + 400) * NS}", db="db")
        got[pkg] = ex.execute(panel, db="db")
        assert got[pkg] != first
        monkeypatch.setenv("OGT_RESULT_CACHE", "0")
        _close(got[pkg], ex.execute(panel, db="db"))
        monkeypatch.setenv("OGT_RESULT_CACHE", "1")
        e.close()
    _close(got["torch"], got["jax"])
    rows = got["torch"]["results"][0]["series"][0]["values"]
    deleted = [r for r in rows
               if (T0 + 120) * NS <= r[0] < (T0 + 360) * NS]
    assert deleted and all(r[2] == 0 for r in deleted)


def test_delete_rewrite_reads_each_measurement_in_bulk(tmp_path,
                                                       monkeypatch):
    """The rewrite decodes each measurement through the bulk read: one
    read_series_bulk per measurement, no per-series read_series."""
    e = _build(tmp_path / "torch", "torch")
    [sh] = e.all_shards()
    calls = {"bulk": 0, "series": 0}
    bulk, series = TShard.read_series_bulk, TShard.read_series

    def count_bulk(self, *a, **kw):
        calls["bulk"] += 1
        return bulk(self, *a, **kw)

    def count_series(self, *a, **kw):
        calls["series"] += 1
        return series(self, *a, **kw)

    monkeypatch.setattr(TShard, "read_series_bulk", count_bulk)
    monkeypatch.setattr(TShard, "read_series", count_series)
    sh.delete_data("cpu", {sh.index.get_or_create("cpu", (
        ("host", "h1"), ("rack", "r1")))})
    assert calls == {"bulk": 2, "series": 0}
    assert sorted(os.listdir(sh.path)) == [
        "00000004.tidx", "00000004.tsf", "seriesidx", "wal.log"]
    e.close()
