"""The single-node HTTP surface of the port against the JAX package's, on
the CPU: GET /metrics (the Prometheus text export), POST /api/v2/write,
and the syscontrol switches of POST /debug/ctrl (disablewrite,
disableread, readonly, flush).

/metrics differs by nature where a module is not ported yet (the two
registries hold different sections), so its comparison is of the
exposition format (parsed strictly), the types and label names of the
families both packages emit for the same requests, and the counts of
``ogt_http_request_seconds`` per route and method after the same
requests. Every other answer must be equal: status, JSON body and the
``X-Ogt-Errno`` header.
"""

import glob
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import stats as jstats
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.server.http import _route_of
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils import stats as tstats

from test_observability import parse_prometheus_strict

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000


def _req(port, method, path, body=b"", **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(
        url, data=body if method == "POST" else None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("X-Ogt-Errno")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("X-Ogt-Errno")


def _answer(resp):
    """(status, body as JSON or bytes, X-Ogt-Errno)."""
    status, body, eno = resp
    try:
        body = json.loads(body) if body else body
    except ValueError:
        pass
    return status, body, eno


@pytest.fixture
def services(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    for e, svc in ((je, js), (te, ts)):
        e.create_database("db")
        e.create_retention_policy("db", "short", 7 * 86400 * NS)
        svc.start()
        body = "\n".join(
            f"cpu,host=h{h} v={h + i * 0.5} {(BASE + 10 * i) * NS}"
            for h in range(3) for i in range(6)).encode()
        assert _req(svc.port, "POST", "/write", body, db="db")[0] == 204
    yield (js, je), (ts, te)
    for e, svc in ((je, js), (te, ts)):
        svc.stop()
        e.close()


def _both(services, method, path, body=b"", **params):
    (js, _je), (ts, _te) = services
    want = _answer(_req(js.port, method, path, body, **params))
    got = _answer(_req(ts.port, method, path, body, **params))
    assert got == want, (path, params)
    return got


# -- /metrics ------------------------------------------------------------------


def _http_counts(fams):
    return {(lab["route"], lab["method"]): v
            for n, lab, v in fams["ogt_http_request_seconds"]["samples"]
            if n.endswith("_count")}


def _settle():
    """A request's latency is observed after its answer is written: give
    the server threads of the requests just answered time to record
    theirs before a scrape."""
    time.sleep(0.25)


@pytest.fixture
def fresh_histograms():
    """Both packages' histograms are process globals, and an earlier
    test in the process may have made a series in one package only. Each
    registry is set aside for the test, so both start empty, and put back
    after it."""
    saved = []
    for mod in (jstats, tstats):
        with mod._HIST_LOCK:
            saved.append(dict(mod._HISTOGRAMS))
            mod._HISTOGRAMS.clear()
    yield
    for mod, hists in zip((jstats, tstats), saved):
        with mod._HIST_LOCK:
            mod._HISTOGRAMS.clear()
            mod._HISTOGRAMS.update(hists)


def test_metrics_parse_and_count_requests_like_jax(fresh_histograms,
                                                    services):
    (js, _je), (ts, _te) = services
    scrapes = {}
    for name, svc in (("jax", js), ("torch", ts)):
        _settle()
        st, body, _e = _req(svc.port, "GET", "/metrics")
        assert st == 200
        before = _http_counts(parse_prometheus_strict(body.decode()))
        for _ in range(3):
            _req(svc.port, "GET", "/query", db="db",
                 q="SELECT mean(v) FROM cpu")
        _req(svc.port, "POST", "/query", db="db", q="SHOW DATABASES")
        _req(svc.port, "POST", "/write",
             f"cpu,host=h9 v=1 {BASE * NS}".encode(), db="db")
        _req(svc.port, "POST", "/api/v2/write",
             f"cpu,host=h9 v=2 {(BASE + 1) * NS}".encode(), bucket="db")
        _req(svc.port, "GET", "/ping")
        _req(svc.port, "GET", "/debug/vars")
        _req(svc.port, "GET", "/nope")
        _settle()
        st, body, _e = _req(svc.port, "GET", "/metrics")
        fams = parse_prometheus_strict(body.decode())
        after = _http_counts(fams)
        scrapes[name] = (fams, {k: after.get(k, 0) - before.get(k, 0)
                                for k in set(after) | set(before)})
    (jf, jd), (tf, td) = scrapes["jax"], scrapes["torch"]
    assert td == jd
    assert td[("query", "GET")] == 3 and td[("write", "POST")] == 2
    # the families both packages emit: one type, one set of label names
    shared = set(jf) & set(tf)
    for fam in ("ogt_http_request_seconds", "ogt_query_stage_seconds",
                "ogt_write_rows_total", "ogt_executor_queries",
                "ogt_uptime_seconds", "ogt_build_info"):
        assert fam in shared, fam
    for fam in shared:
        assert tf[fam]["type"] == jf[fam]["type"], fam
    for fam in ("ogt_http_request_seconds", "ogt_query_stage_seconds",
                "ogt_build_info"):
        assert ({frozenset(lab) for _n, lab, _v in tf[fam]["samples"]}
                == {frozenset(lab) for _n, lab, _v in jf[fam]["samples"]})


def test_metrics_content_type_like_jax(services):
    (js, _je), (ts, _te) = services
    types = []
    for svc in (js, ts):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/metrics", timeout=30) as r:
            types.append(r.headers.get("Content-Type"))
    assert types[1] == types[0] == "text/plain; version=0.0.4; charset=utf-8"


@pytest.mark.parametrize("path", [
    "/query", "/write", "/api/v2/write", "/api/v1/prom/write",
    "/api/v1/query", "/internal/scan", "/debug/vars", "/metrics",
    "/raft/status", "/cluster/health", "/repo/x", "/ping", "/health",
    "/elsewhere"])
def test_route_classes_match(path):
    from opengemini_tpu.server.http import _route_of as jroute

    assert _route_of(path) == jroute(path)


def test_histograms_disarmed_with_obs_off(services):
    """OGT_TRACE=0's switch: no endpoint histogram moves."""
    from opengemini_tpu_torch.utils import stats as tstats

    (_js, _je), (ts, _te) = services
    prev = tstats.obs_enabled()

    def count():
        return sum(s["count"] for n, _l, s in tstats.histograms_snapshot()
                   if n == "http_request_seconds")

    tstats.set_obs_enabled(False)
    try:
        c0 = count()
        _req(ts.port, "GET", "/ping")
        assert count() == c0
    finally:
        tstats.set_obs_enabled(prev)


# -- /api/v2/write ----------------------------------------------------------------

V2_CASES = {
    "db": {"bucket": "db"},
    "db_rp": {"bucket": "db/short"},
    "db_autogen": {"bucket": "db/autogen", "precision": "s"},
    "rp_missing": {"bucket": "db/nope"},
    "db_missing": {"bucket": "nodb"},
    "no_bucket": {},
}


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_api_v2_write_like_jax(services, case):
    params = V2_CASES[case]
    t = BASE + 3600 if params.get("precision") == "s" else (BASE + 3600) * NS
    body = f"v2,host=a x=1.5 {t}\nv2,host=b x=2.5 {t}".encode()
    status, _body, _eno = _both(services, "POST", "/api/v2/write", body,
                                **params)
    if case in ("db", "db_rp", "db_autogen"):
        assert status == 204
        rp = params["bucket"].partition("/")[2] or "autogen"
        got = _both(services, "GET", "/query", db="db",
                    q=f'SELECT count(x) FROM "db"."{rp}".v2')
        assert got[1]["results"][0]["series"][0]["values"][0][1] == 2
    else:
        assert status >= 400


# -- the syscontrol switches --------------------------------------------------------


def _tsf_count(engine) -> int:
    return len(glob.glob(os.path.join(engine.root, "data", "**", "*.tsf"),
                         recursive=True))


_LINE = f"cpu,host=h7 v=7 {(BASE + 600) * NS}".encode()
_SELECT = "SELECT count(v) FROM cpu"


def test_disablewrite_refuses_writes_like_jax(services):
    got = _both(services, "POST", "/debug/ctrl", mod="disablewrite",
                switchon="true")
    assert got == (200, {"status": "ok", "mod": "disablewrite",
                         "switchon": True}, None)
    for path, params in (("/write", {"db": "db"}),
                         ("/api/v2/write", {"bucket": "db"})):
        st, body, eno = _both(services, "POST", path, _LINE, **params)
        assert (st, eno) == (403, "2003")
        assert body["error"] == "writes are disabled (syscontrol)"
    # SELECT INTO writes through the structured path: a statement error
    st, body, _e = _both(services, "POST", "/query", db="db",
                         q="SELECT v INTO cpu2 FROM cpu")
    assert "writes are disabled" in body["results"][0]["error"]
    _both(services, "POST", "/debug/ctrl", mod="disablewrite",
          switchon="false")
    assert _both(services, "POST", "/write", _LINE, db="db")[0] == 204


def test_readonly_refuses_writes_and_keeps_the_count(services):
    before = _both(services, "GET", "/query", db="db", q=_SELECT)
    _both(services, "POST", "/debug/ctrl", mod="readonly", switchon="1")
    st, _body, eno = _both(services, "POST", "/write", _LINE, db="db")
    assert (st, eno) == (403, "2003")
    assert _both(services, "GET", "/query", db="db", q=_SELECT) == before
    _both(services, "POST", "/debug/ctrl", mod="readonly", switchon="0")
    assert _both(services, "POST", "/write", _LINE, db="db")[0] == 204


def test_disableread_refuses_select_and_explain_like_jax(services):
    _both(services, "POST", "/debug/ctrl", mod="disableread",
          switchon="true")
    for q in (_SELECT, "EXPLAIN " + _SELECT):
        st, body, _e = _both(services, "GET", "/query", db="db", q=q)
        assert st == 200
        assert body["results"][0]["error"] == \
            "reads are disabled (syscontrol)"
    st, body, _e = _both(services, "GET", "/query", q="SHOW DATABASES")
    assert "error" not in body["results"][0]
    # writes still go through
    assert _both(services, "POST", "/write", _LINE, db="db")[0] == 204
    _both(services, "POST", "/debug/ctrl", mod="disableread",
          switchon="false")
    st, body, _e = _both(services, "GET", "/query", db="db", q=_SELECT)
    assert "error" not in body["results"][0]


def test_flush_writes_a_file_like_jax(services):
    (_js, je), (_ts, te) = services
    before = (_tsf_count(je), _tsf_count(te))
    got = _both(services, "POST", "/debug/ctrl", mod="flush")
    assert got == (200, {"status": "ok", "mod": "flush", "switchon": False},
                   None)
    assert (_tsf_count(je), _tsf_count(te)) == (before[0] + 1,
                                                before[1] + 1)
    _both(services, "GET", "/query", db="db", q=_SELECT)


@pytest.mark.parametrize("params", [
    {"mod": "nope"}, {"mod": ""}, {"mod": "disablewrite"},
    {"mod": "disableread", "switchon": "TRUE"},
    {"mod": "readonly", "switchon": "no"}],
    ids=["unknown", "empty", "no_switch", "upper_true", "no"])
def test_ctrl_answers_like_jax(services, params):
    _both(services, "POST", "/debug/ctrl", **params)
    # whatever the switch did, both engines agree on it
    (_js, je), (_ts, te) = services
    assert ((je.write_disabled, je.read_disabled)
            == (te.write_disabled, te.read_disabled))


# -- the histogram helpers ----------------------------------------------------


@pytest.mark.parametrize("q", [1, 50, 90, 99, 100])
def test_histogram_merge_and_percentiles_like_jax(q):
    """Histogram.merge (element-wise, exact), percentile_s and the
    bytes-unit snapshot_percentile against the JAX package's, on the
    same observations."""
    import numpy as np

    from opengemini_tpu.utils import stats as jstats
    from opengemini_tpu_torch.utils import stats as tstats

    rng = np.random.default_rng(q)
    ns = rng.integers(0, 1 << 36, 500).tolist() + [0, 1024, 1025, 1 << 40]
    got = []
    for mod in (jstats, tstats):
        a, b = mod.Histogram("x"), mod.Histogram("x")
        by = mod.Histogram("y", unit="bytes")
        for i, v in enumerate(ns):
            (a if i % 2 else b).observe_ns(v)
            by.observe_ns(v)
        a.merge(b)
        got.append((a.snapshot(), a.percentile_s(q),
                    mod.snapshot_percentile(by.snapshot(), q),
                    mod.snapshot_percentile_s({"counts": [0] * 27,
                                               "count": 0, "sum_ns": 0}, q)))
    assert got[1] == got[0]
    assert got[1][0]["count"] == len(ns)
