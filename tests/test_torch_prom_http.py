"""The port's Prometheus HTTP surface against the JAX package's, over both
HttpServices on the CPU: /api/v1/query, /api/v1/query_range,
/api/v1/labels, /api/v1/series (GET and form POST, repeated match[]),
/api/v1/label/<name>/values, the 400 bad_data errors, KILL QUERY of a
running PromQL query (422 canceled), /api/v1/rules and /api/v1/alerts
with no rule manager, POST /api/v1/prom/write (snappy prompb), POST
/api/v1/prom/read and POST /api/v1/otlp/metrics.

Every answer must be equal: the status, the decoded JSON body (or the
decoded protobuf of a remote read) and the error body. The queries run
with host kernels on ("1"), where both packages answer in numpy and the
JSON is the same bit for bit."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.client import HTTPConnection

import pytest
import torch

from opengemini_tpu.ingest import protowire as jpw
from opengemini_tpu.query import offload as joffload
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils.querytracker import GLOBAL as JTRACKER
from opengemini_tpu_torch.ingest import protowire as tpw
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.server.http import _route_of
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TTRACKER

from test_torch_protowire import otlp_request, read_request, write_request

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000


def _req(port, method, path, body=b"", headers=None, params=()):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(list(params))
    req = urllib.request.Request(
        url, data=body if method == "POST" else None, method=method,
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _answer(resp):
    status, body, _headers = resp
    try:
        body = json.loads(body) if body else body
    except ValueError:
        pass
    return status, body


@pytest.fixture
def services(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    joffload.set_prom_host_kernels_mode("1")
    toffload.set_prom_host_kernels_mode("1")
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    lines = []
    for i in range(6):
        for k in range(40):
            t = (BASE + 15 * k) * NS
            lines.append(f"http_requests_total,instance=i{i},"
                         f"job={'api' if i % 2 else 'web'} "
                         f"value={k * (i + 1) + (k // 13) * 3} {t}")
            lines.append(f"up,instance=i{i},job=node value={k % 2} {t}")
    lines.append(f"down,job=x value=1 {BASE * NS}")
    body = "\n".join(lines).encode()
    for e, svc in ((je, js), (te, ts)):
        e.create_database("prom")
        e.create_database("db")
        svc.start()
        assert _req(svc.port, "POST", "/write", body,
                    params=[("db", "prom")])[0] == 204
    yield (js, je), (ts, te)
    for e, svc in ((je, js), (te, ts)):
        svc.stop()
        e.close()
    joffload.set_prom_host_kernels_mode("")
    toffload.set_prom_host_kernels_mode("")


def _both(services, method, path, body=b"", headers=None, params=()):
    (js, _je), (ts, _te) = services
    want = _answer(_req(js.port, method, path, body, headers, params))
    got = _answer(_req(ts.port, method, path, body, headers, params))
    assert got == want, (path, params)
    return got


QUERIES = [
    ("/api/v1/query", [("query", "up"), ("time", str(BASE + 300))]),
    ("/api/v1/query", [("query", "sum by (job) (rate(http_requests_total"
                                 "[2m]))"), ("time", str(BASE + 500))]),
    ("/api/v1/query", [("query", "topk(2, http_requests_total)"),
                       ("time", "2023-11-14T22:20:00Z")]),
    ("/api/v1/query", [("query", "1 + 2"), ("time", str(BASE))]),
    ("/api/v1/query_range", [("query", "rate(http_requests_total[1m])"),
                             ("start", str(BASE + 60)),
                             ("end", str(BASE + 590)), ("step", "30")]),
    ("/api/v1/query_range", [("query", "max_over_time(up[2m])"),
                             ("start", str(BASE)), ("end", str(BASE + 600)),
                             ("step", "1m")]),
    ("/api/v1/query_range", [("query", "avg by (job) (up)"),
                             ("start", str(BASE)), ("end", str(BASE + 600)),
                             ("step", "45"), ("db", "prom")]),
    # errors: 400 bad_data
    ("/api/v1/query", [("query", "rate("), ("time", "0")]),
    ("/api/v1/query", [("query", "rate(up)"), ("time", "0")]),
    ("/api/v1/query", [("query", "up"), ("time", "yesterday")]),
    ("/api/v1/query_range", [("query", "up"), ("start", str(BASE))]),
    ("/api/v1/query_range", [("query", "up"), ("start", str(BASE)),
                             ("end", str(BASE + 60)), ("step", "0")]),
    ("/api/v1/query_range", [("query", "up"), ("start", str(BASE)),
                             ("end", str(BASE + 600)), ("step", "1x")]),
    ("/api/v1/query", [("query", 'up{job=~"["}'), ("time", "0")]),
    # an unknown route under /api/v1
    ("/api/v1/nope", []),
]


@pytest.mark.parametrize("path,params", QUERIES)
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_query_routes(services, path, params, method):
    if method == "GET":
        status, body = _both(services, "GET", path, params=params)
    else:
        status, body = _both(
            services, "POST", path,
            urllib.parse.urlencode(params).encode(),
            {"Content-Type": "application/x-www-form-urlencoded"})
    if status == 400:
        assert body["errorType"] == "bad_data"


@pytest.mark.parametrize("path", ["/api/v1/labels",
                                  "/api/v1/label/job/values",
                                  "/api/v1/label/__name__/values",
                                  "/api/v1/label/nokey/values",
                                  "/api/v1/rules", "/api/v1/alerts"])
def test_metadata_and_rule_routes(services, path):
    status, body = _both(services, "GET", path)
    assert status == 200 and body["status"] == "success"
    _both(services, "GET", path, params=[("db", "db")])
    if path == "/api/v1/rules":
        assert body["data"] == {"groups": []}
    if path == "/api/v1/alerts":
        assert body["data"] == {"alerts": []}


@pytest.mark.parametrize("matches", [
    ['up{job="node"}'], ['up{instance=~"i[0-2]"}', 'down'],
    ['{__name__=~"up|down"}'], [], ['rate(up[1m])'], ['up{'],
    ['{job="x"}']])
def test_series_route(services, matches):
    params = [("match[]", m) for m in matches]
    status, _body = _both(services, "GET", "/api/v1/series", params=params)
    _both(services, "POST", "/api/v1/series",
          urllib.parse.urlencode(params).encode(),
          {"Content-Type": "application/x-www-form-urlencoded"})
    assert status in (200, 400)


def test_route_class():
    for p in ("/api/v1/query", "/api/v1/series", "/api/v1/rules"):
        assert _route_of(p) == "prom"
    for p in ("/api/v1/prom/write", "/api/v1/otlp/metrics"):
        assert _route_of(p) == "write"


# -- remote write / read, OTLP ----------------------------------------------------


def _remote_series():
    return [
        ({"__name__": "rw_metric", "job": "api", "instance": "a"},
         [(BASE * 1000 + 15_000 * k, float(k) * 1.5) for k in range(20)]),
        ({"__name__": "rw_metric", "job": "api", "instance": "b"},
         [(BASE * 1000 + 15_000 * k, float("nan") if k == 3 else -k)
          for k in range(20)]),
        ({"job": "nameless"}, [(BASE * 1000, 4.0)]),
    ]


@pytest.mark.parametrize("compress", [True, False])
def test_remote_write_then_read_back(services, compress):
    body = write_request(_remote_series())
    hdr = {}
    if compress:
        body = tpw.snappy_compress_literal(body)
        hdr = {"Content-Encoding": "snappy"}
    status, _ = _both(services, "POST", "/api/v1/prom/write", body, hdr,
                      [("db", "db")])
    assert status == 204
    # InfluxQL, the Prom API and remote read all see the written samples
    _both(services, "GET", "/query", params=[
        ("db", "db"), ("q", "SELECT count(value) FROM rw_metric"),
        ("epoch", "ms")])
    status, body = _both(services, "GET", "/api/v1/query", params=[
        ("db", "db"), ("query", 'rw_metric{instance="a"}'),
        ("time", str(BASE + 300))])
    assert body["data"]["result"][0]["value"][1] == "28.5"
    rbody = tpw.snappy_compress_literal(read_request([
        (BASE * 1000, BASE * 1000 + 200_000, [(0, "__name__", "rw_metric"),
                                              (2, "instance", "a|b")]),
        (BASE * 1000, BASE * 1000 + 1, [(0, "__name__", "nosuch")]),
        (0, 1, [(1, "job", "x")]),
    ]))
    (js, _je), (ts, _te) = services
    got = _req(ts.port, "POST", "/api/v1/prom/read", rbody,
               {"Content-Encoding": "snappy"}, [("db", "db")])
    want = _req(js.port, "POST", "/api/v1/prom/read", rbody,
                {"Content-Encoding": "snappy"}, [("db", "db")])
    assert got[0] == want[0] == 200
    assert got[2]["Content-Encoding"] == "snappy"
    assert tpw.snappy_uncompress(got[1]) == jpw.snappy_uncompress(want[1])
    payload = tpw.snappy_uncompress(got[1])
    assert len([v for f, _w, v in tpw.fields(payload) if f == 1]) == 3


@pytest.mark.parametrize("path,body", [
    ("/api/v1/prom/write", b"\x0a\x05abc"),
    ("/api/v1/prom/write", tpw.snappy_compress_literal(b"\x0a\xff")),
    ("/api/v1/prom/read", b"\x0a\x09\x08"),
    ("/api/v1/otlp/metrics", b"\x0a\x07\x0a"),
])
def test_malformed_bodies(services, path, body):
    status, doc = _both(services, "POST", path, body,
                        params=[("db", "db")])
    assert status == 400 and "bad" in doc["error"]


@pytest.mark.parametrize("path", ["/api/v1/prom/write", "/api/v1/prom/read",
                                  "/api/v1/otlp/metrics"])
def test_database_required_and_missing(services, path):
    body = {"/api/v1/prom/write": write_request(_remote_series()),
            "/api/v1/prom/read": read_request(
                [(0, BASE * 1000, [(0, "__name__", "up")])]),
            "/api/v1/otlp/metrics": body_of("g1")}[path]
    status, _ = _both(services, "POST", path, body)
    assert status == 400
    _both(services, "POST", path, body, params=[("db", "nosuchdb")])


def test_otlp_metrics_ingest(services):
    t0 = BASE * NS
    body = otlp_request({"service": "svc1"}, [
        ("cpu_temp", "gauge", [
            {"attrs": {"host": f"h{i}"}, "t_ns": t0 + i * 10 * NS,
             "value": 40.0 + i} for i in range(5)]),
        ("bytes_total", "sum", [{"attrs": {"host": "h1"}, "t_ns": t0,
                                 "value": 123}]),
        ("latency", "hist", [{"attrs": {}, "t_ns": t0, "count": 6,
                              "sum": 1.5, "counts": [1, 2, 3],
                              "bounds": [0.1, 0.5]}]),
    ])
    status, _ = _both(services, "POST", "/api/v1/otlp/metrics", body,
                      params=[("db", "db")])
    assert status == 200
    status, body = _both(services, "GET", "/query", params=[
        ("db", "db"), ("q", "SELECT * FROM cpu_temp GROUP BY *"),
        ("epoch", "ns")])
    assert len(body["results"][0]["series"]) == 5
    _both(services, "GET", "/query", params=[
        ("db", "db"), ("q", "SELECT * FROM latency GROUP BY *"),
        ("epoch", "ns")])
    _both(services, "POST", "/api/v1/otlp/metrics", gzip_body(body_of(
        "g2")), {"Content-Encoding": "gzip"}, [("db", "db")])
    _both(services, "GET", "/query", params=[
        ("db", "db"), ("q", "SELECT gauge FROM g2"), ("epoch", "ns")])


def body_of(name):
    return otlp_request({}, [(name, "gauge", [{"t_ns": BASE * NS,
                                               "value": 2.5}])])


def gzip_body(b):
    import gzip

    return gzip.compress(b)


# -- KILL QUERY of a running PromQL query -------------------------------------------


def _kill_running(svc, tracker, monkeypatch, path, params):
    """Run a PromQL request on one connection; while its first
    cancellation point holds, KILL it from a second connection."""
    started, release = threading.Event(), threading.Event()
    orig = tracker.check
    holder = []

    def held():
        # only the PromQL request's thread holds (the KILL statement
        # passes its own cancellation points)
        if not holder:
            holder.append(threading.get_ident())
        if holder[0] == threading.get_ident():
            started.set()
            release.wait(10)
        orig()

    monkeypatch.setattr(tracker, "check", held)
    out = {}

    def run():
        c = HTTPConnection("127.0.0.1", svc.port, timeout=30)
        c.request("GET", path + "?" + urllib.parse.urlencode(params))
        r = c.getresponse()
        out["res"] = (r.status, json.loads(r.read()))
        c.close()

    t = threading.Thread(target=run)
    t.start()
    try:
        assert started.wait(10)
        base = f"http://127.0.0.1:{svc.port}"
        listed = json.loads(urllib.request.urlopen(
            base + "/debug/queries").read())
        [mine] = [x for x in listed["queries"]
                  if x["query"] == dict(params)["query"]]
        kill = urllib.request.urlopen(urllib.request.Request(
            base + "/query", data=urllib.parse.urlencode(
                {"q": f"KILL QUERY {mine['qid']}"}).encode(),
            method="POST"))
        assert json.loads(kill.read()) == {"results": [{"statement_id": 0}]}
    finally:
        release.set()
        t.join(timeout=20)
        monkeypatch.undo()
    assert not t.is_alive()
    status, body = out["res"]
    body["error"] = body["error"].replace(str(mine["qid"]), "<qid>")
    return status, body


@pytest.mark.parametrize("path,params", [
    ("/api/v1/query_range", [("query", "rate(http_requests_total[1m])"),
                             ("start", str(BASE + 60)),
                             ("end", str(BASE + 590)), ("step", "30")]),
    ("/api/v1/query", [("query", "max_over_time(up[5m])"),
                       ("time", str(BASE + 400))]),
])
def test_kill_query_cancels_promql(services, monkeypatch, path, params):
    (js, _je), (ts, _te) = services
    want = _kill_running(js, JTRACKER, monkeypatch, path, params)
    got = _kill_running(ts, TTRACKER, monkeypatch, path, params)
    assert got == want
    assert got[0] == 422 and got[1]["errorType"] == "canceled"
    # the next run answers in full
    _both(services, "GET", path, params=params)


def _series_with(kind):
    base = [({"__name__": "rw", "job": "api", "instance": f"i{i}"},
             [(BASE * 1000 + 15_000 * k, float(k * (i + 1)) + 0.25)
              for k in range(12)]) for i in range(3)]
    if kind == "nan":  # no line-protocol form: the points path
        base[1][1][4] = (base[1][1][4][0], float("nan"))
        base[2][1][5] = (base[2][1][5][0], float("inf"))
    elif kind == "newline":  # a label value with a newline: the points
        base[0][0]["instance"] = "i0\nx"
    elif kind == "empty_label":  # line protocol drops an empty tag value:
        base[0][0]["job"] = ""   # the points keep the series as sent
    elif kind == "escaped":  # separators and quotes in a label value
        base[1][0]["instance"] = 'i1 a,b=c"d\\'
    elif kind == "duplicates":  # one timestamp twice: the last one wins
        base[0][1].append((base[0][1][3][0], 99.0))
    return base


@pytest.mark.parametrize("kind", ["finite", "nan", "newline", "empty_label",
                                  "escaped", "duplicates", "conflict"])
def test_remote_write_survives_a_restart(tmp_path, kind):
    """The port's columnar remote-write path (and its fallback to the
    points for a value or label with no line-protocol form) answers as
    the JAX package before and after a restart that replays the WAL, and
    a field-type conflict answers the same 400."""
    body = tpw.snappy_compress_literal(write_request(
        _series_with(kind)))
    hdr = {"Content-Encoding": "snappy"}
    qs = [("/query", [("db", "db"), ("epoch", "ns"),
                      ("q", "SELECT count(value), sum(value), last(value) "
                            "FROM rw GROUP BY *")]),
          ("/api/v1/query", [("db", "db"), ("query", "rw"),
                             ("time", str(BASE + 200))]),
          ("/api/v1/query", [("db", "db"), ("query", "count_over_time(rw[5m])"),
                             ("time", str(BASE + 200))])]
    outs = []
    for name, eng_cls, svc_cls, kw in (
            ("j", JEngine, JHttpService, {}),
            ("t", TEngine, THttpService, {"device": "cpu"})):
        root = str(tmp_path / name)
        e = eng_cls(root, **kw)
        e.create_database("db")
        if kind == "conflict":
            e.write_lines("db", f"rw,job=api,instance=i0 value=1i {BASE * NS}")
        svc = svc_cls(e, "127.0.0.1", 0) if name == "j" else \
            svc_cls(e, port=0)
        svc.start()
        got = [_answer(_req(svc.port, "POST", "/api/v1/prom/write", body,
                            hdr, [("db", "db")]))]
        got += [_answer(_req(svc.port, "GET", p, params=q)) for p, q in qs]
        svc.stop()
        e.close()
        e = eng_cls(root, **kw)  # the WAL replays
        svc = svc_cls(e, "127.0.0.1", 0) if name == "j" else \
            svc_cls(e, port=0)
        svc.start()
        got += [_answer(_req(svc.port, "GET", p, params=q)) for p, q in qs]
        svc.stop()
        e.close()
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1][0][0] == (400 if kind == "conflict" else 204)
