"""The port's whole write -> query slice against the JAX package, on the
CPU: the same TSBS-shaped line-protocol body (8 hosts x the 10 cpu
fields x 2 h at 10 s, plus an irregular measurement and an int field)
goes into both Engines, and the aggregate queries of chip_smoke.py
(Q1-Q4) plus a fill(null) variant must give equal JSON, floats within
rtol 1e-12 (summation order). Also: a convert.load_columnar round trip
from a JAX shard scan, and an HTTP /write + /query round trip on a free
port.
"""

import json
import math
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.ingest.line_protocol import series_key
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch import convert
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS


def _stat(key: str) -> int:
    """A port counter by its "module/name" key."""
    module, name = key.split("/", 1)
    return TSTATS.counters(module).get(name, 0)


torch.set_num_threads(1)

T0 = 1451606400 * 10**9  # 2016-01-01T00:00:00Z
STEP = 10 * 10**9
FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice",
          "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
          "usage_guest", "usage_guest_nice")
WHERE = "time >= '2016-01-01T00:00:00Z' AND time < '2016-01-01T02:00:00Z'"
F5 = FIELDS[:5]
QUERIES = {
    "Q1": "SELECT mean(usage_user), max(usage_user), count(usage_user) "
          f"FROM cpu WHERE {WHERE} GROUP BY time(1m)",
    "Q2": "SELECT " + ", ".join(f"mean({f})" for f in F5)
          + f" FROM cpu WHERE {WHERE} GROUP BY time(1h), hostname",
    "Q3": "SELECT " + ", ".join(f"max({f})" for f in F5)
          + f" FROM cpu WHERE hostname='host_7' AND {WHERE} GROUP BY time(1m)",
    "Q4": "SELECT first(usage_user), last(usage_user), min(usage_user), "
          "max(usage_user), mean(usage_user), stddev(usage_user), "
          f"spread(usage_user) FROM cpu WHERE {WHERE} GROUP BY hostname",
    "fill_null": "SELECT mean(usage_user), count(usage_user) FROM cpu "
                 "WHERE time >= '2015-12-31T23:58:00Z' AND "
                 "time < '2016-01-01T00:10:00Z' GROUP BY time(1m) fill(null)",
    "irregular": "SELECT mean(v), max(v), count(v), first(v), last(v) FROM "
                 f"jitter WHERE {WHERE} GROUP BY time(10m)",
    "int_field": "SELECT sum(n), mean(n), count(n) FROM cpu "
                 f"WHERE {WHERE} GROUP BY time(30m), region",
    "rank": "SELECT median(usage_user), percentile(usage_user, 90) FROM cpu "
            f"WHERE {WHERE} GROUP BY region",
    "fill_previous": "SELECT max(usage_idle) FROM cpu WHERE "
                     "time >= '2015-12-31T23:57:00Z' AND "
                     "time < '2016-01-01T00:03:00Z' GROUP BY time(1m) "
                     "fill(previous)",
    "fill_number": "SELECT min(usage_idle) FROM cpu WHERE "
                   "time >= '2015-12-31T23:57:00Z' AND "
                   "time < '2016-01-01T00:03:00Z' GROUP BY time(1m) fill(-1)",
    "desc_limit": "SELECT mean(usage_user) FROM cpu WHERE "
                  f"{WHERE} GROUP BY time(10m), hostname ORDER BY time DESC "
                  "LIMIT 3 OFFSET 1",
    "group_all_tags": "SELECT spread(usage_steal), stddev(usage_steal) FROM cpu "
                      f"WHERE {WHERE} GROUP BY time(30m), *",
    "math_and_regex": "SELECT mean(usage_user) * 2 + 1, count(usage_user) FROM "
                      f"/cp.*/ WHERE hostname =~ /host_[12]/ AND {WHERE} "
                      "GROUP BY time(15m)",
    "field_filter": "SELECT count(usage_user), sum(usage_user) FROM cpu "
                    f"WHERE usage_user > 50 AND {WHERE} GROUP BY time(20m), region",
    "selector_time": "SELECT max(usage_guest) FROM cpu WHERE "
                     "hostname = 'host_3' AND " + WHERE,
}
GRID_QUERIES = {"Q1", "Q2", "Q3"}


def _tsbs_body(seed=0, hosts=8, hours=2):
    rng = np.random.default_rng(seed)
    lines = []
    n = hours * 360
    for h in range(hosts):
        tags = (f"arch=x64,datacenter=us-east-1a,hostname=host_{h},os=Ubuntu16.10,"
                f"rack={h},region=r{h % 3},service={h % 4},service_environment=test,"
                f"service_version=0,team=SF")
        walk = np.clip(rng.random((len(FIELDS), 1)) * 100
                       + np.cumsum(rng.normal(0, 1, (len(FIELDS), n)), axis=1),
                       0, 100)
        for i in range(n):
            fv = ",".join(f"{f}={float(walk[j, i])!r}"
                          for j, f in enumerate(FIELDS))
            lines.append(f"cpu,{tags} {fv},n={int(rng.integers(-50, 50))}i "
                         f"{T0 + i * STEP}")
    # an irregular measurement: ns-jittered times (no common stride), so
    # its grid batch falls back to buckets
    t = T0 + np.sort(rng.integers(0, hours * 3600 * 10**9, 300))
    for i, ti in enumerate(np.unique(t)):
        lines.append(f"jitter,host=h{i % 3} v={float(rng.normal()):.6f} {ti}")
    return "\n".join(lines)


def _close(a, b, path="$"):
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


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    body = _tsbs_body()
    je = JEngine(str(root / "jax"))
    te = TEngine(str(root / "torch"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.write_lines("db", body)
    yield je, te
    je.close()


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_query_matches_jax(engines, qname):
    je, te = engines
    q = QUERIES[qname]
    before = _stat("executor/grid_batches")
    fallbacks = _stat("executor/grid_fallbacks")
    want = JExecutor(je).execute(q, db="db", now_ns=T0)
    got = TExecutor(te).execute(q, db="db", now_ns=T0)
    assert "error" not in got["results"][0], got
    assert got["results"][0].get("series"), got
    _close(got, want)
    if qname in GRID_QUERIES:
        assert _stat("executor/grid_batches") > before
    if qname == "irregular":
        assert _stat("executor/grid_fallbacks") > fallbacks


def test_unsupported_statements_answer_an_error(engines):
    """Every statement of the ported slices answers: SHOW STATS and SHOW
    DIAGNOSTICS with series under the reference's names; the raw select,
    the subquery, percentile_approx, SHOW (SHOW USERS and SHOW CLUSTER
    too) and the continuous-query DDL as JAX (SHOW QUERIES lists each
    package's own running statement: its qid and duration differ)."""
    je, te = engines
    for q in ("SHOW STATS", "SHOW DIAGNOSTICS"):
        res = TExecutor(te).execute(q, db="db")
        want = JExecutor(je).execute(q, db="db")
        assert "error" not in res["results"][0], res
        assert res["results"][0]["series"][0]["columns"] == \
            want["results"][0]["series"][0]["columns"]
    for q in ("SELECT usage_user FROM cpu LIMIT 1", "SHOW MEASUREMENTS",
              "SELECT max FROM (SELECT max(usage_user) FROM cpu)",
              "SELECT percentile_approx(usage_user, 50) FROM cpu",
              "CREATE CONTINUOUS QUERY cq ON db BEGIN SELECT "
              "mean(usage_user) INTO cpu_1h FROM cpu GROUP BY time(1h) END",
              "SHOW CONTINUOUS QUERIES", "SHOW SUBSCRIPTIONS",
              "SELECT detect(usage_user, 'mad') FROM cpu", "SHOW USERS",
              "SHOW CLUSTER"):
        got = TExecutor(te).execute(q, db="db")
        assert "error" not in got["results"][0], got
        assert got == JExecutor(je).execute(q, db="db")
    got = TExecutor(te).execute("SHOW QUERIES", db="db")
    want = JExecutor(je).execute("SHOW QUERIES", db="db")
    [gs], [ws] = got["results"][0]["series"], want["results"][0]["series"]
    assert gs["columns"] == ws["columns"]
    assert [r[1:3] + r[4:] for r in gs["values"]] == \
        [r[1:3] + r[4:] for r in ws["values"]] == \
        [["SHOW QUERIES", "db", "running"]]


def _export_jax(je, db):
    """What a JAX shard scan yields, as numpy arrays per measurement."""
    tables = {}
    for sh in je.shards_for_range(db, None, -(2**62), 2**62):
        for mst in sh.measurements():
            sids = np.asarray(sorted(sh.index.series_ids(mst)), np.int64)
            sid_arr, rec = sh.read_series_bulk(mst, sids)
            keys = [series_key(*sh.index.series_entry(int(s))) for s in sids]
            tables[mst] = {
                "series_keys": keys,
                "series": np.searchsorted(sids, sid_arr),
                "times": rec.times,
                "fields": {n: (np.asarray(c.values), np.asarray(c.valid))
                           for n, c in rec.columns.items()},
            }
    return tables


def test_load_columnar_round_trip_from_a_jax_shard_scan(engines, tmp_path):
    je, _te = engines
    te2 = TEngine(str(tmp_path), device="cpu")
    te2.create_database("db")
    tables = _export_jax(je, "db")
    n = convert.load_columnar(te2, "db", tables)
    assert n == sum(len(t["times"]) for t in tables.values())
    for qname in ("Q1", "Q4", "int_field", "irregular"):
        want = JExecutor(je).execute(QUERIES[qname], db="db", now_ns=T0)
        got = TExecutor(te2).execute(QUERIES[qname], db="db", now_ns=T0)
        _close(got, want)


def _http(port, method, path, params, body=None):
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=body, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        data = r.read()
        return r.status, (json.loads(data) if data else None)


def test_http_write_and_query_round_trip(tmp_path):
    te = TEngine(str(tmp_path), device="cpu")
    svc = HttpService(te, port=0)
    svc.start()
    try:
        assert _http(svc.port, "GET", "/ping", {})[0] == 204
        status, doc = _http(svc.port, "POST", "/query",
                            {"q": "CREATE DATABASE web"}, b"")
        assert status == 200 and "error" not in doc["results"][0]
        body = "\n".join(
            f"cpu,hostname=h{h} usage_user={h * 10 + i}.5 {T0 + i * STEP}"
            for h in range(2) for i in range(12)).encode()
        assert _http(svc.port, "POST", "/write",
                     {"db": "web", "precision": "ns"}, body)[0] == 204
        status, doc = _http(svc.port, "GET", "/query", {
            "db": "web", "epoch": "s",
            "q": "SELECT max(usage_user), count(usage_user) FROM cpu "
                 "WHERE time >= '2016-01-01T00:00:00Z' AND "
                 "time < '2016-01-01T00:02:00Z' GROUP BY time(1m), hostname"})
        assert status == 200
        series = doc["results"][0]["series"]
        assert [s["tags"]["hostname"] for s in series] == ["h0", "h1"]
        assert series[1]["values"] == [[T0 // 10**9, 15.5, 6],
                                       [T0 // 10**9 + 60, 21.5, 6]]
        status, doc = _http(svc.port, "GET", "/query", {
            "db": "web", "q": "SELECT count(usage_user) FROM cpu "
                              "WHERE time >= '2016-01-01T00:00:00Z' AND "
                              "time < '2016-01-01T00:02:00Z'"})
        assert doc["results"][0]["series"][0]["values"] == [
            ["2016-01-01T00:00:00Z", 24]]
        with pytest.raises(urllib.error.HTTPError) as err:
            _http(svc.port, "POST", "/write", {"db": "nope"}, body)
        assert err.value.code == 404
    finally:
        svc.stop()


# -- the HTTP error taxonomy and chunked answers, against the JAX server --


def _raw(port, method, path, params, body=None):
    """(status, headers, body bytes) of one request, errors included."""
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A JAX server and a port server over the same 3-host body."""
    from opengemini_tpu.server.http import HttpService as JHttpService

    root = tmp_path_factory.mktemp("http")
    body = "\n".join(
        f"cpu,host=h{h} v={h * 10 + i}.25 {T0 + i * STEP}"
        for h in range(3) for i in range(5)).encode()
    je = JEngine(str(root / "jax"))
    te = TEngine(str(root / "torch"), device="cpu")
    js, ts = JHttpService(je, "127.0.0.1", 0), HttpService(te, port=0)
    for e, svc in ((je, js), (te, ts)):
        e.create_database("d")
        svc.start()
        assert _raw(svc.port, "POST", "/write", {"db": "d"}, body)[0] == 204
    yield js.port, ts.port
    for e, svc in ((je, js), (te, ts)):
        svc.stop()
        e.close()


WRITE_ERRORS = {
    "bad_field": ({"db": "d"}, f"cpu,host=c v=4 {T0}\nbad line here\n"
                               f"cpu,host=c v=5 {T0 + 1}"),
    "bad_value": ({"db": "d"}, f"cpu,host=c v=abc {T0}"),
    "bad_timestamp": ({"db": "d"}, "cpu,host=c v=1 12x"),
    "int_range": ({"db": "d"}, f"cpu,host=c n=99999999999999999999i {T0}"),
    "type_conflict": ({"db": "d"}, f"cpu,host=h0 v=3i {T0 + 7 * STEP}"),
    "db_not_found": ({"db": "nope"}, f"cpu,host=c v=1 {T0}"),
}


@pytest.mark.parametrize("case", sorted(WRITE_ERRORS))
def test_write_errors_carry_the_errno_of_jax(servers, case):
    params, body = WRITE_ERRORS[case]
    jport, tport = servers
    want = _raw(jport, "POST", "/write", params, body.encode())
    got = _raw(tport, "POST", "/write", params, body.encode())
    assert got[0] == want[0] and got[0] >= 400
    assert json.loads(got[2]) == json.loads(want[2])
    assert "errno" in json.loads(got[2])
    assert got[1]["X-Ogt-Errno"] == want[1]["X-Ogt-Errno"]


CHUNKED_Q = "SELECT count(v), max(v) FROM cpu GROUP BY time(1m), host"
CHUNKED_WHERE = (" WHERE time >= '2016-01-01T00:00:00Z' AND "
                 "time < '2016-01-01T00:02:00Z'")


@pytest.mark.parametrize("chunk_size", [None, "1", "3"])
def test_chunked_query_streams_like_jax(servers, chunk_size):
    q = CHUNKED_Q.replace(" GROUP", CHUNKED_WHERE + " GROUP")
    params = {"db": "d", "q": q, "chunked": "true"}
    if chunk_size is not None:
        params["chunk_size"] = chunk_size
    jport, tport = servers
    want = _raw(jport, "GET", "/query", params)
    got = _raw(tport, "GET", "/query", params)
    assert got[0] == want[0] == 200
    assert got[1]["Transfer-Encoding"] == "chunked"
    docs = [json.loads(line) for line in got[2].decode().splitlines()]
    want_docs = [json.loads(line) for line in want[2].decode().splitlines()]
    # one document per series (more at a small chunk_size)
    assert len(docs) >= 3
    _close(docs, want_docs)
    # and the chunks hold the unchunked answer's rows
    plain = _raw(tport, "GET", "/query", {"db": "d", "q": q})
    series = json.loads(plain[2])["results"][0]["series"]
    rows = [r for d in docs for s in d["results"][0]["series"]
            for r in s["values"]]
    assert rows == [r for s in series for r in s["values"]]


def test_bad_chunk_size_answers_like_jax(servers):
    params = {"db": "d", "q": CHUNKED_Q, "chunked": "true",
              "chunk_size": "x"}
    jport, tport = servers
    want = _raw(jport, "GET", "/query", params)
    got = _raw(tport, "GET", "/query", params)
    assert got[0] == want[0] == 400
    assert json.loads(got[2]) == json.loads(want[2]) == {
        "error": "bad chunk_size"}


def test_debug_vars_carry_query_stages(servers):
    _jport, tport = servers
    q = CHUNKED_Q.replace(" GROUP", CHUNKED_WHERE + " GROUP")
    before = json.loads(_raw(tport, "GET", "/debug/vars", {})[2])
    assert _raw(tport, "GET", "/query", {"db": "d", "q": q})[0] == 200
    after = json.loads(_raw(tport, "GET", "/debug/vars", {})[2])
    stages = after["query_stages"]
    old = before.get("query_stages", {})
    for stage in ("request", "parse", "map_shards", "plan", "scan",
                  "device_compute", "render", "encode"):
        assert stages[f"{stage}_count"] == old.get(f"{stage}_count", 0) + 1
        assert stages[f"{stage}_ns"] > old.get(f"{stage}_ns", 0)
    assert after["write"]["points"] >= 15
    assert after["system"]["uptime_s"] >= 0


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_request_stage_times_each_query_request(servers, method):
    """The port's "request" stage: one count per /query (GET or POST)
    that reaches the executor, its time within the request's wall."""
    _jport, tport = servers
    q = CHUNKED_Q.replace(" GROUP", CHUNKED_WHERE + " GROUP")
    before = json.loads(_raw(tport, "GET", "/debug/vars", {})[2])
    t0 = time.perf_counter_ns()
    assert _raw(tport, method, "/query", {"db": "d", "q": q})[0] == 200
    wall_ns = time.perf_counter_ns() - t0
    old = before.get("query_stages", {})
    stages = json.loads(_raw(tport, "GET", "/debug/vars", {})[2])[
        "query_stages"]
    assert stages["request_count"] == old.get("request_count", 0) + 1
    assert 0 < stages["request_ns"] - old.get("request_ns", 0) < wall_ns
