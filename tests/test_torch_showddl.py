"""The port's SHOW and DDL statements against the JAX package, on the
CPU.

- The SHOW statements over the same writes, on the memtable and after
  ``flush_all`` and a reopen: equal answers.
- The DDL statements (CREATE DATABASE ... WITH, CREATE/ALTER/DROP
  RETENTION POLICY, CREATE/DROP MEASUREMENT, DROP DATABASE) run through
  both executors step by step, each followed by the SHOW statements:
  equal answers, errors included.
- A cross-package reopen: DDL run by one package, the root reopened by
  the other, which gives the same SHOW answers.
- Over HTTP, per statement kind: a GET runs SHOW and refuses DDL as the
  JAX server does, a POST runs both; and ``/health``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
T0 = 1451606400 * NS  # 2016-01-01T00:00:00Z
DAY = 86400 * NS


def _body() -> str:
    """Two measurements over three days (three shard groups of a 1d
    policy, one of the 7d default), tags with escapes and an empty
    value, every field type."""
    lines = []
    for d in range(3):
        for i, host in enumerate(("a", "b", "c d")):
            t = T0 + d * DAY + i * NS
            esc = host.replace(" ", "\\ ")
            lines.append(f"cpu,host={esc},region=r{i % 2} "
                         f"v={d + i}.5,n={i}i {t}")
            lines.append(f"disk,host={esc},dev=sd{i} free={i * 10}i,"
                         f'ok=true,label="x{i}" {t}')
    lines.append(f"cpu,host=e v=1 {T0 + 5 * NS}")
    lines.append(f"gpu,host=a util=0.5 {T0}")
    return "\n".join(lines) + "\n"


SHOWS = [
    "SHOW DATABASES",
    "SHOW MEASUREMENTS",
    "SHOW MEASUREMENTS WITH MEASUREMENT =~ /d.*/",
    "SHOW TAG KEYS",
    "SHOW TAG KEYS FROM cpu",
    "SHOW TAG KEYS FROM disk WHERE host = 'b'",
    "SHOW TAG VALUES WITH KEY = host",
    "SHOW TAG VALUES FROM cpu WITH KEY IN (host, region)",
    "SHOW TAG VALUES FROM cpu WITH KEY =~ /reg.*/ WHERE host = 'a'",
    "SHOW TAG VALUES FROM disk WITH KEY = host WHERE value != 'a'",
    "SHOW TAG VALUES WITH KEY = host LIMIT 2 OFFSET 1",
    "SHOW FIELD KEYS",
    "SHOW FIELD KEYS FROM disk",
    "SHOW SERIES",
    "SHOW SERIES FROM cpu WHERE region = 'r1'",
    "SHOW SERIES WHERE v = 1",
    "SHOW SERIES CARDINALITY",
    "SHOW SERIES EXACT CARDINALITY",
    "SHOW SERIES EXACT CARDINALITY FROM disk",
    "SHOW MEASUREMENT CARDINALITY",
    "SHOW RETENTION POLICIES",
    "SHOW RETENTION POLICIES ON db",
    "SHOW SHARDS",
]

# each step is run through both executors, then every SHOW above
DDL_STEPS = [
    "CREATE DATABASE other WITH DURATION 3d SHARD DURATION 1h NAME r1",
    "CREATE MEASUREMENT newm",
    "DROP MEASUREMENT gpu",
    "CREATE RETENTION POLICY week ON db DURATION 7d REPLICATION 1",
    "CREATE RETENTION POLICY short ON db DURATION 10m REPLICATION 1",
    "ALTER RETENTION POLICY week ON db DURATION 14d SHARD DURATION 2d "
    "DEFAULT",
    "ALTER RETENTION POLICY week ON db DURATION 1d",
    "ALTER RETENTION POLICY missing ON db DURATION 1d",
    "DROP RETENTION POLICY week ON db",
    "DROP DATABASE other",
    "DROP DATABASE never_made",
]


def _run_shows(ex, now):
    return {q: ex.execute(q, db="db", now_ns=now) for q in SHOWS}


def _assert_same_shows(got: dict, want: dict):
    for q in SHOWS:
        assert got[q] == want[q], (q, got[q], want[q])


def _mk(root, body):
    je = JEngine(str(root / "jax"))
    te = TEngine(str(root / "torch"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.create_retention_policy("db", "daily", 30 * DAY, DAY,
                                  default=True)
        e.write_lines("db", body)
    return je, te


@pytest.fixture(scope="module", params=["memtable", "reopened"])
def engines(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"showddl-{request.param}")
    je, te = _mk(root, _body())
    if request.param == "reopened":
        for e in (je, te):
            e.flush_all()
            e.close()
        je = JEngine(str(root / "jax"))
        te = TEngine(str(root / "torch"), device="cpu")
    yield je, te
    je.close()
    te.close()


@pytest.mark.parametrize("q", SHOWS)
def test_show_matches_jax(engines, q):
    je, te = engines
    want = JExecutor(je).execute(q, db="db", now_ns=T0)
    got = TExecutor(te).execute(q, db="db", now_ns=T0)
    assert "error" not in want["results"][0], want
    assert got == want


def _check_dropped_is_hidden(jx, tx):
    """The dropped measurement is hidden from SELECT and the metadata
    SHOWs, while SHOW SERIES keeps its series until a purge."""
    for q in ("SELECT * FROM gpu", "SELECT count(util) FROM gpu",
              "SHOW MEASUREMENTS", "SHOW SERIES FROM gpu"):
        assert tx.execute(q, db="db", now_ns=T0) == \
            jx.execute(q, db="db", now_ns=T0), q
    assert "gpu" not in json.dumps(
        tx.execute("SHOW MEASUREMENTS", db="db", now_ns=T0))
    assert "gpu,host=a" in json.dumps(
        tx.execute("SHOW SERIES", db="db", now_ns=T0))


def test_ddl_steps_match_jax(tmp_path):
    je, te = _mk(tmp_path, _body())
    jx, tx = JExecutor(je), TExecutor(te)
    try:
        for step in DDL_STEPS:
            want = jx.execute(step, db="db", now_ns=T0)
            got = tx.execute(step, db="db", now_ns=T0)
            assert ("error" in got["results"][0]) == (
                "error" in want["results"][0]), (step, got, want)
            _assert_same_shows(_run_shows(tx, T0), _run_shows(jx, T0))
            if step == "DROP MEASUREMENT gpu":
                _check_dropped_is_hidden(jx, tx)
    finally:
        je.close()
        te.close()


def test_a_write_after_drop_measurement_says_the_purge_is_not_ported(
        tmp_path):
    """The purge is ported now: a write after DROP MEASUREMENT purges
    the marked rows first and is accepted, and the measurement then
    holds the new row alone, in both packages alike."""
    got = []
    for cls, ex_cls, kw in ((JEngine, JExecutor, {}),
                            (TEngine, TExecutor, {"device": "cpu"})):
        e = cls(str(tmp_path / cls.__module__.split(".")[0]), **kw)
        e.create_database("db")
        e.write_lines("db", f"gpu,host=a util=1 {T0}\n")
        ex_cls(e).execute("DROP MEASUREMENT gpu", db="db")
        assert e.write_lines("db", f"gpu,host=a util=2 {T0 + NS}\n") == 1
        assert not e.databases["db"].dropped_msts
        got.append([ex_cls(e).execute(q, db="db") for q in (
            "SELECT * FROM gpu", "SHOW MEASUREMENTS", "SHOW SERIES")])
        e.close()
    assert got[1] == got[0]
    assert got[1][0]["results"][0]["series"][0]["values"] == [
        [T0 + NS, "a", 2.0]]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_the_other_package_reopens_the_ddl(tmp_path, writer):
    """DDL by one package; the other reopens the root and answers the
    SHOW statements as the writer does."""
    cls = {"jax": (JEngine, JExecutor, {}),
           "torch": (TEngine, TExecutor, {"device": "cpu"})}
    wcls, wex, wkw = cls[writer]
    rcls, rex, rkw = cls["torch" if writer == "jax" else "jax"]
    root = str(tmp_path / "root")
    e = wcls(root, **wkw)
    e.create_database("db")
    e.create_database("gone")
    e.write_lines("db", _body())
    e.flush_all()
    ex = wex(e)
    for step in ("CREATE RETENTION POLICY week ON db DURATION 7d "
                 "REPLICATION 1 DEFAULT",
                 "ALTER RETENTION POLICY week ON db DURATION 14d "
                 "SHARD DURATION 2d",
                 "CREATE RETENTION POLICY hourly ON db DURATION 2h "
                 "REPLICATION 1",
                 "DROP RETENTION POLICY hourly ON db",
                 "DROP MEASUREMENT gpu",
                 "DROP DATABASE gone",
                 "ALTER RETENTION POLICY autogen ON db DEFAULT"):
        assert "error" not in ex.execute(step, db="db")["results"][0], step
    want = _run_shows(ex, T0)
    assert "gpu" not in json.dumps(want["SHOW MEASUREMENTS"])
    assert "disk,dev=sd1" in json.dumps(want["SHOW SERIES"])
    e.close()
    e2 = rcls(root, **rkw)
    try:
        got = _run_shows(rex(e2), T0)
        _assert_same_shows(got, want)
        assert e2.is_measurement_dropped("db", "gpu")
        assert "gone" not in e2.databases
    finally:
        e2.close()


# -- HTTP -----------------------------------------------------------------------


def _http(port: int, method: str, path: str, params: dict | None = None):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("showddl-http")
    je, te = _mk(root, _body())
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    js.start()
    ts.start()
    yield js.port, ts.port
    for e, svc in ((je, js), (te, ts)):
        svc.stop()
        e.close()


# one statement of each kind: (statement, runs from a GET)
HTTP_KINDS = {
    "show_databases": ("SHOW DATABASES", True),
    "show_measurements": ("SHOW MEASUREMENTS", True),
    "show_tag_keys": ("SHOW TAG KEYS FROM cpu", True),
    "show_tag_values": ("SHOW TAG VALUES WITH KEY = host", True),
    "show_field_keys": ("SHOW FIELD KEYS", True),
    "show_series": ("SHOW SERIES FROM disk", True),
    "show_series_cardinality": ("SHOW SERIES CARDINALITY", True),
    "show_measurement_cardinality": ("SHOW MEASUREMENT CARDINALITY", True),
    "show_retention_policies": ("SHOW RETENTION POLICIES", True),
    "show_shards": ("SHOW SHARDS", True),
    "create_database": ("CREATE DATABASE made_{m}", False),
    "create_retention_policy": (
        "CREATE RETENTION POLICY rp_{m} ON db DURATION 2d REPLICATION 1",
        False),
    "alter_retention_policy": (
        "ALTER RETENTION POLICY daily ON db DURATION 40d", False),
    "create_measurement": ("CREATE MEASUREMENT m_{m}", False),
    "drop_measurement": ("DROP MEASUREMENT nothing_{m}", False),
    "drop_retention_policy": ("DROP RETENTION POLICY rp_x ON db", False),
    "drop_database": ("DROP DATABASE made_x", False),
}


@pytest.mark.parametrize("kind", sorted(HTTP_KINDS))
def test_get_and_post_follow_the_read_only_rule_of_jax(servers, kind):
    stmt, readonly = HTTP_KINDS[kind]
    jport, tport = servers
    for method in ("GET", "POST"):
        q = stmt.format(m=method.lower())
        want = _http(jport, method, "/query", {"db": "db", "q": q})
        got = _http(tport, method, "/query", {"db": "db", "q": q})
        assert got == want, (method, q)
        refused = "must be sent via POST" in json.dumps(got[1])
        assert refused == (method == "GET" and not readonly), (method, got)


def test_health_answers_like_jax(servers):
    jport, tport = servers
    got, want = _http(tport, "GET", "/health"), _http(jport, "GET", "/health")
    assert got == want
    assert got[0] == 200 and got[1]["status"] == "pass"
