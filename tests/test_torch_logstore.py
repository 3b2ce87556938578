"""The port's log mode (server/logstore.py, sql/logparser.py) against the
JAX package's, on the CPU.

Every case of the reference's tests/test_logstore.py runs on the port
(``mirror_reference``). Besides, each of its HTTP cases runs through
both packages' ``HttpService`` with every request and answer recorded:
the two records must be equal (``took_ms``, a wall time, left out). The
PPL grammar compiles a corpus of queries to the same InfluxQL WHERE in
both packages, and a log root written by either package answers alike
when the other reopens it.
"""

from __future__ import annotations

import inspect
import json
import os
import re
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.sql import logparser as jlp
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.sql import logparser as tlp
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))

globals().update(mirror_reference("test_logstore"))


def _reference_module(port: bool) -> dict:
    """tests/test_logstore.py executed as a module of one package."""
    path = os.path.join(_HERE, "test_logstore.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    if port:
        src = re.sub(r"\bopengemini_tpu\b", "opengemini_tpu_torch", src)
        src = re.sub(r"(?<![\w.])Engine\(", "_CpuEngine(", src)
    ns = {"__name__": "test_logstore_" + ("port" if port else "jax"),
          "__file__": path, "_CpuEngine": CpuEngine}
    exec(compile(src, path, "exec"), ns)  # noqa: S102
    return ns


_JNS = _reference_module(False)
_TNS = _reference_module(True)
HTTP_CASES = sorted(
    name for name, fn in _JNS.items()
    if name.startswith("test_") and callable(fn)
    and list(inspect.signature(fn).parameters) == ["server"])


def _drop_walls(obj):
    if isinstance(obj, dict):
        return {k: _drop_walls(v) for k, v in obj.items() if k != "took_ms"}
    if isinstance(obj, list):
        return [_drop_walls(v) for v in obj]
    return obj


def _recorded(ns: dict, name: str, root: str, engine_cls, svc_cls):
    """Run one HTTP case of `ns` on a fresh server; every request's
    (method, path, params, status, answer) in order."""
    calls = []
    orig = ns["_req"]

    def recording(svc, method, path, body=None, headers=None, **params):
        st, out = orig(svc, method, path, body, headers, **params)
        calls.append((method, path, sorted(params.items()), st,
                      _drop_walls(out)))
        return st, out

    ns["_req"] = recording
    engine = engine_cls(root)
    svc = svc_cls(engine, "127.0.0.1", 0)
    svc.start()
    try:
        ns[name](svc)
    finally:
        ns["_req"] = orig
        svc.stop()
        engine.close()
    return calls


@pytest.mark.parametrize("name", HTTP_CASES)
def test_reference_case_answers_equal_in_both_packages(tmp_path, name):
    j = _recorded(_JNS, name, str(tmp_path / "j"), JEngine, JHttpService)
    t = _recorded(_TNS, name, str(tmp_path / "t"), CpuEngine, THttpService)
    assert j, name
    assert t == j


PPL_CORPUS = [
    "error",
    "error timeout",
    "error AND timeout",
    'level: warn or (error and "disk full")',
    "latency > 100 and size in [10 200)",
    "latency >= 1.5 or latency < -2",
    "status: 500",
    "NOT level: info",
    "host: web* and error",
    '"connection reset" or "broken pipe"',
    "*",
    "",
    "size in (1 5]",
    'service: api | EXTRACT(content: "took (\\d+)ms") AS(took) | took: 12',
    "error and level: warn and latency > 5",
]


@pytest.mark.parametrize("text", PPL_CORPUS)
def test_ppl_compiles_to_the_same_influxql(text):
    outs = []
    for lp in (jlp, tlp):
        try:
            q = lp.parse_log_query(text)
        except lp.LogParseError as e:
            outs.append(("error", str(e)))
            continue
        aliases = set(q.aliases)
        outs.append((lp.to_influxql_where(q.cond, aliases),
                     lp.to_influxql_where(q.cond), sorted(aliases)))
    assert outs[1] == outs[0]


def _req(port, method, path, body=None, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, _drop_walls(json.loads(r.read() or b"{}"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


BASE_MS = 1_700_000_040_000
READS = [
    ("logs", {"q": "error", "limit": 100}),
    ("logs", {"q": "*", "limit": 7}),
    ("histogram", {"q": "*", "interval": "10s"}),
    ("analytics", {"q": "*", "group_by": "host", "agg": "count"}),
    ("analytics", {"q": "*", "agg": "max", "field": "latency"}),
    ("context", {"timestamp": BASE_MS + 20_000, "backward": 2,
                 "forward": 2}),
]


def _serve(engine_cls, svc_cls, root):
    engine = engine_cls(root)
    svc = svc_cls(engine, "127.0.0.1", 0)
    svc.start()
    return engine, svc


def _reads(port):
    span = {"from": BASE_MS, "to": BASE_MS + 60_000}
    return [_req(port, "GET", f"/repo/myrepo/logstreams/app/{ep}",
                 **params, **span) for ep, params in READS]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_root_written_by_one_package_reads_in_the_other(tmp_path,
                                                              writer):
    root = str(tmp_path / "logs")
    pkgs = {"jax": (JEngine, JHttpService, _JNS),
            "port": (CpuEngine, THttpService, _TNS)}
    eng_cls, svc_cls, ns = pkgs[writer]
    engine, svc = _serve(eng_cls, svc_cls, root)
    try:
        ns["_setup_logs"](svc)
        engine.flush_all()
        before = _reads(svc.port)
    finally:
        svc.stop()
        engine.close()
    reader = "port" if writer == "jax" else "jax"
    eng_cls, svc_cls, _ns = pkgs[reader]
    engine, svc = _serve(eng_cls, svc_cls, root)
    try:
        after = _reads(svc.port)
    finally:
        svc.stop()
        engine.close()
    assert all(st == 200 for st, _ in before), before
    assert after == before
