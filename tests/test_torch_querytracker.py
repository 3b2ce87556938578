"""The port's running-query registry (utils/querytracker.py): SHOW
QUERIES, KILL QUERY, the cancellation points and /debug/queries, against
the JAX package, on the CPU.

The reference's cases (tests/test_executor.py ``TestQueryManager`` and
tests/test_scanpool.py's KILLs through the scan pool and the bulk scan)
run on the port, and what both packages answer alike is compared: SHOW
QUERIES' columns and rows (less the qid and the duration), the errors of
KILL QUERY and of a killed query. A KILL during a chunked subquery
leaves no spill directory and no thread behind, and the next query
answers right.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.request
from http.client import HTTPConnection

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import querytracker as jqt
from opengemini_tpu_torch.query import executor as texmod
from opengemini_tpu_torch.query import subquery as tsq
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService
from opengemini_tpu_torch.storage import scanpool, tsf as ttsf
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils import querytracker as tqt
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.querytracker import QueryKilled

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_040


@pytest.fixture
def pair(tmp_path):
    je = JEngine(str(tmp_path / "jax"), sync_wal=False)
    te = TEngine(str(tmp_path / "torch"), device="cpu", sync_wal=False)
    for e in (je, te):
        e.create_database("db")
    yield je, te
    je.close()
    te.close()


@pytest.fixture
def pool_on(monkeypatch):
    """The scan pool live, whatever the cores."""
    monkeypatch.setattr(scanpool, "WORKERS", 4)
    monkeypatch.setattr(scanpool, "_pool", None)
    yield
    pool = scanpool._pool
    monkeypatch.setattr(scanpool, "_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


def _write(engines, lines, flush=False):
    for e in engines:
        e.write_lines("db", "\n".join(lines))
        if flush:
            e.flush_all()


def _devops(engines):
    _write(engines, [f"cpu,host=h{i % 5} usage_user={i % 17} {(BASE + i) * NS}"
                     for i in range(200)])


def _kill_when_listed(pattern: str, timeout_s: float = 5.0) -> int:
    """Wait until a running query whose text holds `pattern` is listed,
    kill it, return its qid."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        for info in TRACKER.snapshot():
            if pattern in info["query"] and TRACKER.kill(info["qid"]):
                return info["qid"]
        time.sleep(0.001)
    raise AssertionError(f"no running query holds {pattern!r}")


def _slow_checks(monkeypatch, delay_s=0.005):
    """Every cancellation point sleeps first: a query stays killable."""
    started = threading.Event()
    orig = TRACKER.check

    def slow():
        started.set()
        time.sleep(delay_s)
        orig()

    monkeypatch.setattr(TRACKER, "check", slow)
    return started


# -- the reference's TestQueryManager ---------------------------------------------


def test_show_queries_lists_running(pair):
    _devops(pair)
    answers = []
    for ex in (JExecutor(pair[0]), TExecutor(pair[1])):
        s = ex.execute("SHOW QUERIES", db="db")["results"][0]["series"][0]
        assert s["columns"] == ["qid", "query", "database", "duration",
                                "status"]
        answers.append([r[1:3] + r[4:] for r in s["values"]
                        if "SHOW QUERIES" in r[1]])
    assert answers[0] == answers[1] == [["SHOW QUERIES", "db", "running"]]
    assert TRACKER.snapshot() == []  # unregistered after completion


def test_kill_query_aborts_scan(pair, monkeypatch):
    _write(pair[1:], [f"cpu,host=h{i} v={i} {(BASE + i) * NS}"
                      for i in range(200)])
    started = _slow_checks(monkeypatch)
    result = {}

    def run():
        result["res"] = TExecutor(pair[1]).execute(
            "SELECT mean(v) FROM cpu GROUP BY host", db="db")

    t = threading.Thread(target=run)
    t.start()
    assert started.wait(5)
    qid = _kill_when_listed("mean(v)")
    t.join(timeout=10)
    assert not t.is_alive()
    assert result["res"]["results"][0]["error"] == f"query {qid} killed"
    assert str(jqt.QueryKilled(qid)) == f"query {qid} killed"


@pytest.mark.parametrize("q", ["KILL QUERY 999999", "KILL QUERY 0"])
def test_kill_unknown_query_errors_like_jax(pair, q):
    got = TExecutor(pair[1]).execute(q, db="db")
    assert got == JExecutor(pair[0]).execute(q, db="db")
    assert "no such query" in got["results"][0]["error"]


def test_killed_query_skips_remaining_statements(pair, monkeypatch):
    _devops(pair[1:])
    orig = TRACKER.check
    state = {"armed": True}

    def hooked():
        if state["armed"]:
            for info in TRACKER.snapshot():
                if "DROP MEASUREMENT" in info["query"]:
                    TRACKER.kill(info["qid"])
            state["armed"] = False
        orig()

    monkeypatch.setattr(TRACKER, "check", hooked)
    ex = TExecutor(pair[1])
    res = ex.execute("SELECT mean(usage_user) FROM cpu; DROP MEASUREMENT cpu",
                     db="db")
    monkeypatch.undo()
    assert "killed" in str(res["results"])
    out = ex.execute("SHOW MEASUREMENTS", db="db")
    assert ["cpu"] in out["results"][0]["series"][0]["values"]


@pytest.mark.parametrize("text", [
    "CREATE USER bob WITH PASSWORD 'hunter2'",
    "SET PASSWORD FOR u = 's3c'", "SELECT v FROM m",
    "create user x with password 'a\\'b' WITH ALL PRIVILEGES"])
def test_redact_matches_jax(text):
    assert tqt.redact(text) == jqt.redact(text)


def test_snapshot_shape_matches_jax():
    got = []
    for mod in (jqt, tqt):
        tr = mod.QueryTracker()
        a = tr.register("SELECT 1", "db")
        b = tr.register("SELECT 2", "db2")
        tr.add_stage_ns(a, "scan", 3_000_000)
        tr.note_route(b, "decode", "device")
        tr.kill(b)
        snap = tr.full_snapshot()
        for q in snap["queries"]:
            q.pop("duration_ms")
        got.append((snap, tr.is_killed(b), tr.is_killed(a)))
        with pytest.raises(mod.QueryKilled):
            tr.raise_if_killed(b)
        tr.unregister(b)
        assert not tr.is_killed(b)
    assert got[0] == got[1]


# -- KILL through the scan pool and the bulk scan -------------------------------------


def test_kill_interrupts_pooled_decode(pair, pool_on, monkeypatch):
    """A pooled multi-chunk decode dies shortly after the KILL, and the
    pool serves the next scan right."""
    te = pair[1]
    for i in range(60):
        te.write_lines("db", f"cpu,host=h0 v={i} {(BASE + i) * NS}")
        te.flush_all()
    sh = next(iter(te._shards.values()))
    sid = next(iter(sh.index.series_ids("cpu")))
    orig = ttsf.TSFReader.read_chunk

    def slow(self, *a, **k):
        time.sleep(0.02)
        return orig(self, *a, **k)

    qid = TRACKER.register("pooled scan", "db")
    killed_at = {}

    def killer():
        time.sleep(0.08)
        TRACKER.kill(qid)
        killed_at["t"] = time.monotonic()

    t = threading.Thread(target=killer)
    t.start()
    try:
        monkeypatch.setattr(ttsf.TSFReader, "read_chunk", slow)
        with pytest.raises(QueryKilled):
            sh.read_series("cpu", sid)
        t_died = time.monotonic()
    finally:
        monkeypatch.setattr(ttsf.TSFReader, "read_chunk", orig)
        TRACKER.unregister(qid)
        t.join()
    assert t_died - killed_at["t"] < 0.5  # mid-scan, not at its end
    assert len(sh.read_series("cpu", sid)) == 60


def test_kill_interrupts_the_bulk_scan(pair, pool_on, monkeypatch):
    """The executor's bulk scan stops at its next unit after a KILL."""
    te = pair[1]
    for f in range(3):
        _write([te], [f"cpu,host=h{h} v={(h * 13 + p) % 37}.25 "
                      f"{(BASE + p * 5) * NS}"
                      for p in range(f * 40, (f + 1) * 40) for h in range(70)],
               flush=True)
    orig = TShard.read_series_bulk

    def slow(self, *a, **k):
        time.sleep(0.05)
        return orig(self, *a, **k)

    qid = TRACKER.register("pipeline scan", "db")
    t = threading.Thread(target=lambda: (time.sleep(0.02), TRACKER.kill(qid)))
    t.start()
    try:
        monkeypatch.setattr(TShard, "read_series_bulk", slow)
        stmt = texmod.parse("SELECT mean(v) FROM cpu GROUP BY time(1m)")[0]
        with pytest.raises(QueryKilled):
            TExecutor(te)._select(stmt, "db", (BASE + 10_000) * NS)
    finally:
        monkeypatch.setattr(TShard, "read_series_bulk", orig)
        TRACKER.unregister(qid)
        t.join()


# -- a KILL inside a chunked subquery -------------------------------------------------


def _threads():
    return sorted(t.name for t in threading.enumerate()
                  if not t.name.startswith("ogt-scan"))


def test_kill_during_chunked_subquery_leaves_nothing(pair, tmp_path,
                                                    monkeypatch):
    te = pair[1]
    _write([te], [f"cpu,host=h{h} v={(h + p) % 7} {(BASE + p * 10) * NS}"
                  for h in range(4) for p in range(360)])
    monkeypatch.setattr(tsq, "SUBQUERY_CHUNK_ROWS", 100)
    monkeypatch.setattr(tsq, "SUBQUERY_CHUNK_TARGET", 200)
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spill))
    q = (f"SELECT mean(m) FROM (SELECT max(v) AS m FROM cpu WHERE time >= "
         f"{BASE * NS} AND time < {(BASE + 3600) * NS} GROUP BY time(5m), "
         "host) GROUP BY time(30m)")
    ex = TExecutor(te)
    want = ex.execute(q, db="db")
    assert want["results"][0].get("series"), want
    threads0 = _threads()
    chunks = {"n": 0}
    orig_select = texmod.Executor._select

    def counting(self, stmt, *a, **k):
        res = orig_select(self, stmt, *a, **k)
        if self is ex:
            chunks["n"] += 1
            if chunks["n"] == 3:  # inside the chunk loop: kill the query
                for info in TRACKER.snapshot():
                    if "max(v) AS m" in info["query"]:
                        TRACKER.kill(info["qid"])
        return res

    monkeypatch.setattr(texmod.Executor, "_select", counting)
    got = ex.execute(q, db="db")
    monkeypatch.setattr(texmod.Executor, "_select", orig_select)
    assert got["results"][0]["error"].endswith("killed"), got
    assert chunks["n"] == 3  # the loop stopped at its next chunk
    assert os.listdir(spill) == []
    assert _threads() == threads0
    assert ex.execute(q, db="db") == want


# -- HTTP: /debug/queries, KILL from a second connection -------------------------------


def test_kill_over_http_and_debug_queries(tmp_path, monkeypatch):
    te = TEngine(str(tmp_path / "t"), device="cpu", sync_wal=False)
    te.create_database("db")
    _write([te], [f"cpu,host=h{i % 40} v={i % 17} {(BASE + i) * NS}"
                  for i in range(400)])
    svc = HttpService(te, port=0)
    svc.start()
    started = _slow_checks(monkeypatch, 0.01)
    out = {}
    q = "SELECT mean(v) FROM cpu GROUP BY host"

    def run():
        c = HTTPConnection("127.0.0.1", svc.port, timeout=30)
        c.request("GET", "/query?" + urllib.parse.urlencode(
            {"db": "db", "q": q}))
        out["res"] = json.loads(c.getresponse().read())
        c.close()

    try:
        t = threading.Thread(target=run)
        t.start()
        assert started.wait(5)
        base = f"http://127.0.0.1:{svc.port}"
        listed = json.loads(urllib.request.urlopen(
            base + "/debug/queries").read())
        [mine] = [x for x in listed["queries"] if x["query"] == q]
        assert mine["status"] == "running" and mine["database"] == "db"
        # no durability ledger yet; the governor's admission section is
        # there, disabled (pass-through), as the reference serves it
        assert listed["durability"] == {}
        assert listed["admission"]["enabled"] is False
        assert listed["admission"]["queue"] == []
        kill = urllib.request.urlopen(urllib.request.Request(
            base + "/query", data=urllib.parse.urlencode(
                {"q": f"KILL QUERY {mine['qid']}"}).encode(),
            method="POST"))
        assert json.loads(kill.read()) == {"results": [{"statement_id": 0}]}
        t.join(timeout=10)
        assert not t.is_alive()
        assert out["res"] == {"results": [
            {"statement_id": 0, "error": f"query {mine['qid']} killed"}]}
        monkeypatch.undo()
        after = json.loads(urllib.request.urlopen(
            base + "/debug/queries").read())
        assert [x for x in after["queries"] if x["query"] == q] == []
        again = json.loads(urllib.request.urlopen(
            base + "/query?" + urllib.parse.urlencode(
                {"db": "db", "q": q, "epoch": "ns"})).read())
        assert again == TExecutor(te).execute(q, db="db")
        assert "error" not in again["results"][0]
    finally:
        svc.stop()
        te.close()
