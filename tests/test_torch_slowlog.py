"""The port's slow-query log (utils/slowlog.py), GET /debug/slow and
/debug/ctrl?mod=obs, against the JAX package, on the CPU.

The same statements go to both packages' HTTP services (the port's over
``Engine(device="cpu")``) with both slow logs armed at a threshold every
query crosses: /debug/slow must hold the same entries in the same order
(statement, database, tenant, the stage names, the PromQL ``kind``, the
governor's ledger while it is on), and mod=obs must tune and answer
alike. Times, query ids and stage durations differ by nature and are
compared by their presence and type only. Both slow logs are process
globals: the ``slowlogs`` fixture restores their configuration and
empties them.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.server.http import HttpService as JHttp
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import governor as jgov
from opengemini_tpu.utils import slowlog as jslow
from opengemini_tpu.utils import tracing as jtracing
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.server.http import HttpService as THttp
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils import governor as tgov
from opengemini_tpu_torch.utils import slowlog as tslow
from opengemini_tpu_torch.utils import tracing as ttracing
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040

PKGS = (
    ("jax", JEngine, JHttp, jslow.GLOBAL, jgov.GOVERNOR, jtracing, JSTATS, {}),
    ("torch", TEngine, THttp, tslow.GLOBAL, tgov.GOVERNOR, ttracing, TSTATS,
     {"device": "cpu"}),
)


@pytest.fixture
def slowlogs():
    prev = [(p[3].threshold_ms, p[3].max_records, p[5].trace_enabled())
            for p in PKGS]
    for p in PKGS:
        p[3].clear()
    yield
    for p, (thr, mx, tr) in zip(PKGS, prev):
        p[3].configure(slow_ms=thr, slow_max=mx)
        p[3].clear()
        p[5].set_trace_enabled(tr)


def _post(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def _each(tmp_path, body):
    """`body(port, name, slowlog, governor)` against each package's
    server; returns the outcomes."""
    outs = []
    for name, eng_cls, http_cls, slow, gov, _tr, _st, kw in PKGS:
        e = eng_cls(str(tmp_path / name), **kw)
        e.create_database("db")
        e.create_database("prom")
        e.write_lines("db", "\n".join(
            f"cpu,host=h{i % 3} v={i} {(BASE + i * 10) * NS}"
            for i in range(60)))
        e.write_lines("prom", "\n".join(
            f"up,job=j{i % 2} value={i % 2} {(BASE + i * 15) * NS}"
            for i in range(20)))
        svc = http_cls(e, "127.0.0.1", 0)
        svc.start()
        try:
            outs.append(body(svc.port, name, slow, gov))
        finally:
            svc.stop()
            e.close()
    return outs


def _shape(rec):
    """A slow-log record with its run-dependent values reduced to their
    types and the stage names kept."""
    out = dict(rec)
    assert isinstance(out.pop("qid"), int)
    assert isinstance(out.pop("time"), str)
    assert isinstance(out.pop("duration_ms"), float)
    out["stages_ms"] = sorted(out["stages_ms"])
    if out.get("governor") is not None:
        gov = out["governor"]
        out["governor"] = {"enabled": gov["enabled"],
                           "config": gov["config"],
                           "ledger": sorted(gov["ledger"])}
    if out.get("trace") is not None:
        out["trace"] = _span_names(out["trace"]["root"])
    return out


def _span_names(span):
    return [span["name"], [_span_names(c) for c in span["children"]]]


STATEMENTS = (
    "SELECT mean(v) FROM cpu GROUP BY host",
    "SELECT count(v) FROM cpu WHERE time >= 0 GROUP BY time(1m)",
    "SHOW MEASUREMENTS",
)


def test_debug_slow_holds_the_reference_entries(tmp_path, slowlogs):
    def body(port, name, slow, gov):
        code, doc = _post(port, "/debug/ctrl", mod="obs", slow_ms="0",
                          slow_max="16")
        assert code == 200 and doc["slow_ms"] == 0.0
        for q in STATEMENTS:
            _get(port, "/query", db="db", q=q)
        _get(port, "/api/v1/query", db="prom", query="sum(up)",
             time=str(BASE + 300))
        snap = _get(port, "/debug/slow")
        recs = [_shape(r) for r in snap["records"]]
        assert [r["statement"] for r in recs[:3]] == list(STATEMENTS)
        assert recs[-1]["kind"] == "promql"
        assert len(recs) == len(STATEMENTS) + 1
        return snap["threshold_ms"], snap["max_records"], recs

    outs = _each(tmp_path, body)
    assert outs[1] == outs[0]


def test_threshold_and_ring_bound(tmp_path, slowlogs):
    def body(port, name, slow, gov):
        # `captured` counts every record the process ever took
        base = _get(port, "/debug/slow")["captured"]
        _post(port, "/debug/ctrl", mod="obs", slow_ms="off")
        _get(port, "/query", db="db", q=STATEMENTS[0])
        off = _get(port, "/debug/slow")
        assert off["captured"] == base and off["threshold_ms"] is None
        # an unreachable threshold records nothing either
        _post(port, "/debug/ctrl", mod="obs", slow_ms="3600000")
        _get(port, "/query", db="db", q=STATEMENTS[0])
        high = _get(port, "/debug/slow")["captured"] - base
        assert high == 0
        _post(port, "/debug/ctrl", mod="obs", slow_ms="0", slow_max="2")
        for q in STATEMENTS:
            _get(port, "/query", db="db", q=q)
        ring = _get(port, "/debug/slow")
        # the ring keeps the newest two, the count all three
        assert ring["captured"] - base == 3 and len(ring["records"]) == 2
        assert [r["statement"] for r in ring["records"]] == \
            list(STATEMENTS[1:])
        code, cleared = _post(port, "/debug/ctrl", mod="obs", clear="1")
        cleared["slow_captured"] -= base
        after = _get(port, "/debug/slow")
        assert after["records"] == []
        return (off["threshold_ms"], off["records"], high,
                ring["max_records"], ring["threshold_ms"], cleared)

    outs = _each(tmp_path, body)
    assert outs[1] == outs[0]


def test_obs_ctrl_status_and_errors(tmp_path, slowlogs):
    def body(port, name, slow, gov):
        code0, status = _post(port, "/debug/ctrl", mod="obs")
        code1, traced = _post(port, "/debug/ctrl", mod="obs", trace="1")
        assert code1 == 200 and traced["trace"] is True
        code2, bad = _post(port, "/debug/ctrl", mod="obs", slow_ms="soon")
        assert code2 == 400
        code3, bad_max = _post(port, "/debug/ctrl", mod="obs",
                               slow_max="many")
        assert code3 == 400
        code4, off = _post(port, "/debug/ctrl", mod="obs", trace="0")
        for doc in (status, traced, off):
            # a process-wide count: only its type is comparable
            assert isinstance(doc.pop("slow_captured"), int)
        return (code0, status, code1, traced, code2, bad, code3, bad_max,
                code4, off)

    outs = _each(tmp_path, body)
    assert outs[1] == outs[0]


def test_slow_record_carries_trace_and_governor(tmp_path, slowlogs):
    """With tracing armed a record carries its span tree, and with the
    governor on, the ledger at completion."""
    def body(port, name, slow, gov):
        prev = gov.config()
        _post(port, "/debug/ctrl", mod="obs", slow_ms="0", trace="1")
        try:
            gov.reset()
            gov.configure(budget_mb=64)
            _get(port, "/query", db="db", q=STATEMENTS[1])
        finally:
            gov.configure(**prev)
            gov.reset()
        [rec] = _get(port, "/debug/slow")["records"]
        assert rec["trace"]["root"]["name"] == "query"
        assert rec["governor"]["enabled"] is True
        return _shape(rec)

    outs = _each(tmp_path, body)
    assert outs[1] == outs[0]


def test_slowlog_counter_and_direct_note(slowlogs):
    """note() below the threshold records nothing; a record counts in the
    ``slowlog`` statistics section."""
    got = []
    for _name, _e, _h, slow, _g, _tr, stats, _kw in PKGS:
        slow.configure(slow_ms=5.0)
        before = stats.counters("slowlog").get("captured", 0)
        assert slow.note(1, "SELECT 1", "db", 4.9) is False
        assert slow.note(2, "SELECT 2 WITH PASSWORD 'x'", "db", 5.0,
                         extra={"kind": "test"}) is True
        rec = slow.snapshot()["records"][-1]
        assert stats.counters("slowlog")["captured"] == before + 1
        got.append(_shape(rec))
    assert got[1] == got[0]
