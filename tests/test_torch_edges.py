"""The port's edges against the JAX package's, on the CPU: the tag-array
write mode with its WAL replay, SHOW STATS and SHOW DIAGNOSTICS,
``GET /api/v1/consume`` and DELETE off /repo.

The reference's cases run on the port (``mirror_reference``): the tag
arrays of tests/test_line_protocol.py, the consume cases of
tests/test_http.py, tests/test_auth_delete.py and
tests/test_governor.py. Besides, both packages' ``HttpService`` take the
same bodies and answer alike, before and after a restart that replays
the WAL, also on a root the other package wrote. SHOW DIAGNOSTICS
departs in one row: the port names ``torch`` and its version where the
reference names ``jax``, and ``backend`` is the engine's device type.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.server.http import HttpService as THttpService
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_line_protocol",
                                  names={"TestTagArrays"}))
globals().update(mirror_reference("test_http", names={
    "test_consume_api_cursor_pagination", "test_consume_requires_params",
    "test_consume_review_regressions"}))
globals().update(mirror_reference("test_auth_delete", names={
    "TestAdvisorRegressions.test_consume_locked_during_auth_bootstrap"}))
globals().update(mirror_reference("test_governor", names={
    "test_remote_read_and_consume_surfaces_are_governed"}))

NS = 1_000_000_000
BASE = 1_700_000_040
PKGS = {"jax": (JEngine, JHttpService), "port": (CpuEngine, THttpService)}


def _req(port, method, path, body=None, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Served:
    def __init__(self, pkg, root, **kw):
        eng_cls, svc_cls = PKGS[pkg]
        self.engine = eng_cls(root, **kw)
        self.svc = svc_cls(self.engine, "127.0.0.1", 0)
        self.svc.start()
        self.port = self.svc.port

    def close(self):
        self.svc.stop()
        self.engine.close()


TAG_LINES = "\n".join(
    f"cpu,host=[a{i % 4},b{i % 3},c],dc=[x,y,z] v={i}.5,n={i}i "
    f"{(BASE + i) * NS}" for i in range(40)) + (
    f"\ncpu,host=solo,dc=w v=1 {(BASE + 50) * NS}"
    f"\nmem,host=[p,q] used=3i {(BASE + 1) * NS}")
TAG_QUERIES = [
    "SELECT count(v), sum(v), max(n) FROM cpu GROUP BY host",
    "SELECT count(v) FROM cpu GROUP BY dc",
    "SELECT mean(v) FROM cpu WHERE host = 'c' GROUP BY time(10s)",
    "SHOW SERIES",
    "SHOW TAG VALUES FROM cpu WITH KEY = host",
    "SELECT used FROM mem GROUP BY host",
]


def _answers(port):
    return [json.loads(_req(port, "GET", "/query", db="db", q=q)[1])
            for q in TAG_QUERIES]


@pytest.mark.parametrize("reopen", ["jax", "port"])
def test_tag_arrays_through_write_and_the_wal_replay(tmp_path, reopen):
    got = {}
    for pkg in ("jax", "port"):
        s = _Served(pkg, str(tmp_path / pkg), tag_arrays=True)
        try:
            assert _req(s.port, "POST", "/query",
                        q="CREATE DATABASE db")[0] == 200
            st, body = _req(s.port, "POST", "/write", TAG_LINES.encode(),
                            db="db")
            assert st == 204, body
            got[pkg] = _answers(s.port)
        finally:
            # no flush: the rows live in the WAL and the memtable
            s.svc.stop()
            s.engine.close()
    assert got["port"] == got["jax"]
    counts = {s["tags"]["host"]: s["values"][0][1]
              for s in got["jax"][0]["results"][0]["series"]}
    assert counts["c"] == 40 and counts["solo"] == 1 and len(counts) == 9
    # a restart replays the WAL, also a WAL the other package wrote
    for pkg in ("jax", "port"):
        s = _Served(reopen, str(tmp_path / pkg), tag_arrays=True)
        try:
            assert _answers(s.port) == got["jax"], (pkg, reopen)
        finally:
            s.close()


def test_tag_arrays_off_keep_brackets_literal_in_both(tmp_path):
    got = []
    for pkg in ("jax", "port"):
        s = _Served(pkg, str(tmp_path / pkg))
        try:
            _req(s.port, "POST", "/query", q="CREATE DATABASE db")
            got.append((
                _req(s.port, "POST", "/write",
                     f"cpu,host=[ab] v=1 {BASE * NS}".encode(), db="db"),
                _req(s.port, "POST", "/write",
                     f"cpu,host=[a,b] v=1 {BASE * NS}".encode(), db="db"),
                _req(s.port, "GET", "/query", db="db", q="SHOW SERIES")))
        finally:
            s.close()
    assert got[1] == got[0]
    assert got[0][0][0] == 204 and got[0][1][0] == 400


def _show(port, q):
    return json.loads(_req(port, "GET", "/query", db="db", q=q)[1])


def test_show_stats_and_diagnostics_answer_under_the_reference_names(
        tmp_path):
    docs = {}
    for pkg in ("jax", "port"):
        s = _Served(pkg, str(tmp_path / pkg))
        try:
            _req(s.port, "POST", "/query", q="CREATE DATABASE db")
            _req(s.port, "POST", "/write",
                 f"m,host=a v=1 {BASE * NS}".encode(), db="db")
            _req(s.port, "GET", "/query", db="db",
                 q="SELECT mean(v) FROM m GROUP BY time(1s)")
            docs[pkg] = (_show(s.port, "SHOW STATS"),
                         _show(s.port, "SHOW DIAGNOSTICS"))
        finally:
            s.close()
    (jstats, jdiag), (tstats, tdiag) = docs["jax"], docs["port"]
    jsec = {s["name"]: s for s in jstats["results"][0]["series"]}
    tsec = {s["name"]: s for s in tstats["results"][0]["series"]}
    # the sections this workload touches in both, with their columns
    for name in ("write", "wal", "executor", "durability", "query_stages"):
        assert name in jsec and name in tsec, name
        assert tsec[name]["columns"] == jsec[name]["columns"] == [
            "statistic", "value"]
    assert {r[0] for r in tsec["wal"]["values"]} >= {"appends", "bytes"}
    assert {r[0] for r in tsec["write"]["values"]} == \
        {r[0] for r in jsec["write"]["values"]}
    js = jdiag["results"][0]["series"]
    ts = tdiag["results"][0]["series"]
    assert [(s["name"], s["columns"]) for s in ts] == \
        [(s["name"], s["columns"]) for s in js]
    jrows, trows = dict(js[0]["values"]), dict(ts[0]["values"])
    assert [k if k != "torch" else "jax" for k in trows] == list(jrows)
    assert trows["torch"] == torch.__version__
    assert trows["backend"] == "cpu" and trows["devices"] == "1"
    for k in ("version", "python", "platform"):
        assert trows[k] == jrows[k], k


CONSUME_LINES = "\n".join(
    f'logs,host=h{i % 3} msg="line {i}",v={i}i {(BASE + i // 2) * NS}'
    for i in range(30))


@pytest.mark.parametrize("limit", [1, 4, 7, 100])
def test_consume_pages_like_jax(tmp_path, limit):
    pages = {}
    for pkg in ("jax", "port"):
        s = _Served(pkg, str(tmp_path / pkg))
        try:
            _req(s.port, "POST", "/query", q="CREATE DATABASE db")
            _req(s.port, "POST", "/write", CONSUME_LINES.encode(), db="db")
            s.engine.flush_all()
            out, cursor = [], ""
            for _ in range(40):
                st, body = _req(s.port, "GET", "/api/v1/consume", db="db",
                                measurement="logs", limit=str(limit),
                                **({"cursor": cursor} if cursor else {}))
                doc = json.loads(body)
                out.append((st, doc))
                cursor = doc["cursor"]
                if doc["exhausted"]:
                    break
            out.append(_req(s.port, "GET", "/api/v1/consume", db="db",
                            measurement="logs", cursor="x:y"))
            out.append(_req(s.port, "GET", "/api/v1/consume", db="nodb",
                            measurement="logs"))
            pages[pkg] = out
        finally:
            s.close()
    assert pages["port"] == pages["jax"]
    rows = [r for st, doc in pages["jax"][:-2] for r in doc["rows"]]
    assert len(rows) == 30


def test_delete_off_repo_answers_404_json_in_both(tmp_path):
    for pkg in ("jax", "port"):
        s = _Served(pkg, str(tmp_path / pkg))
        try:
            for path in ("/query", "/write", "/nope", "/repo"):
                st, body = _req(s.port, "DELETE", path)
                assert (st, json.loads(body)) == \
                    (404, {"error": "not found"}), (pkg, path)
            st, body = _req(s.port, "DELETE", "/repo/absent")
            assert st == 404 and "error" in json.loads(body)
        finally:
            s.close()
