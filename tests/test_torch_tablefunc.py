"""The port's table functions (query/tablefunc.py, the ``rca`` fault
demarcation) against the JAX package, on the CPU: the reference's
tests/test_tablefunc.py cases, unit-level on the same rows in both
modules (equal graphs and equal errors) and through both executors on
the same writes (equal answers)."""

from __future__ import annotations

import json

import pytest
import torch

from opengemini_tpu.query import tablefunc as jtf
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import tablefunc as ttf
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
BASE_MS = 1_700_000_000_000


def ev(entity, etype, ann, rid="e1"):
    return {"id": rid, "name": rid, "entity_id": entity, "type": etype,
            "annotations": json.dumps(ann)}


def topo(edges):
    nodes = sorted({e[0] for e in edges} | {e[1] for e in edges})
    return {"nodes": [{"uid": n} for n in nodes],
            "edges": [{"source": a, "target": b} for a, b in edges]}


def params(core, edges, hop=2, narrow=False):
    return {"hop_count": hop, "bfs_narrow": narrow,
            "task": {"metadata": {"core_entity_id": core}},
            "topology": topo(edges)}


def both(fn_name, *args):
    """The function of both modules on the same arguments: equal."""
    got = getattr(ttf, fn_name)(*args)
    assert got == getattr(jtf, fn_name)(*args)
    return got


def test_chain_correlated():
    rows = [ev("core", "anomaly", {"timestamps": [BASE_MS]}),
            ev("a", "anomaly", {"timestamps": [BASE_MS + 60_000]}),
            ev("b", "anomaly", {"timestamps": [BASE_MS + 10 * 3600 * 1000]})]
    g = both("fault_demarcation", rows,
             params("core", [("core", "a"), ("a", "b")]))
    assert {n["uid"] for n in g["nodes"]} == {"core", "a", "b"}
    assert len(g["edges"]) == 2


def test_uncorrelated_neighbor_stops_expansion():
    rows = [ev("core", "anomaly", {"timestamps": [BASE_MS]}),
            ev("far", "anomaly", {"timestamps": [BASE_MS + 9 * 3600 * 1000]})]
    g = both("fault_demarcation", rows,
             params("core", [("core", "a"), ("a", "far")], hop=1))
    assert {n["uid"] for n in g["nodes"]} == {"core", "a"}


def test_alarm_window_rules():
    rows = [ev("core", "anomaly", {"timestamps": [BASE_MS]}),
            ev("a", "alarm", {"start_time": BASE_MS + 90 * 60 * 1000})]
    assert both("_is_anomaly", [BASE_MS], "a", ttf._index_rows(rows))
    rows[1] = ev("a", "alarm", {"start_time": BASE_MS + 90 * 60 * 1000,
                                "end_time": BASE_MS + 95 * 60 * 1000})
    assert not both("_is_anomaly", [BASE_MS], "a", ttf._index_rows(rows))


def test_event_fallback_chain():
    rows = [ev("a", "event", {"create_time": BASE_MS + 60 * 60 * 1000})]
    assert both("_is_anomaly", [BASE_MS], "a", ttf._index_rows(rows))
    rows = [ev("a", "event", {"end_time": BASE_MS + 60 * 60 * 1000})]
    assert not both("_is_anomaly", [BASE_MS], "a", ttf._index_rows(rows))


def test_bfs_narrow_shrinks_radius():
    rows = [ev("core", "anomaly", {"timestamps": [BASE_MS]}),
            ev("a", "anomaly", {"timestamps": [BASE_MS + 1000]})]
    edges = [("core", "a"), ("a", "b"), ("b", "c"), ("c", "d")]
    wide = both("fault_demarcation", rows, params("core", edges, hop=3))
    narrow = both("fault_demarcation", rows,
                  params("core", edges, hop=3, narrow=True))
    assert {n["uid"] for n in narrow["nodes"]} < {n["uid"] for n in wide["nodes"]}


@pytest.mark.parametrize("fn,args", [
    ("fault_demarcation", ([], {"task": {}})),
    ("run_rca", ([], "not-json{")),
    ("run_rca", ([], "[1, 2]")),
    ("fault_demarcation", ([ev("core", "anomaly", {})],
                           params("core", [("core", "a")]))),
    ("fault_demarcation", ([ev("core", "anomaly", {"timestamps": [1]}),
                            ev("a", "alarm", {})],
                           params("core", [("core", "a")]))),
])
def test_errors_match_jax(fn, args):
    with pytest.raises(ttf.TableFunctionError) as got:
        getattr(ttf, fn)(*args)
    with pytest.raises(jtf.TableFunctionError) as want:
        getattr(jtf, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.fixture
def pair(tmp_path):
    engines = (JEngine(str(tmp_path / "jax"), sync_wal=False),
               TEngine(str(tmp_path / "torch"), device="cpu", sync_wal=False))
    t_ns = BASE_MS * 1_000_000
    lines = []
    for i, (ent, ts_off) in enumerate(
            [("core", 0), ("svc-a", 30_000), ("svc-b", 8 * 3600 * 1000)]):
        ann = json.dumps({"timestamps": [BASE_MS + ts_off]}).replace('"', '\\"')
        lines.append(f'events id="e{i}",name="n{i}",entity_id="{ent}",'
                     f'type="anomaly",annotations="{ann}" {t_ns + i * NS}')
    for e in engines:
        e.create_database("db")
        e.write_lines("db", "\n".join(lines))
    yield engines, t_ns
    for e in engines:
        e.close()


@pytest.mark.parametrize("hop,uids", [(1, {"core", "svc-a", "svc-b"}),
                                      (2, {"core", "svc-a", "svc-b"})])
def test_select_rca(pair, hop, uids):
    (je, te), t_ns = pair
    p = json.dumps({"hop_count": hop,
                    "task": {"metadata": {"core_entity_id": "core"}},
                    "topology": topo([("core", "svc-a"), ("svc-a", "svc-b")])}
                   ).replace("'", "\\'")
    q = (f"SELECT rca('{p}') FROM events WHERE time >= {t_ns - NS} "
         f"AND time < {t_ns + 10 * NS}")
    got = TExecutor(te).execute(q, db="db", now_ns=t_ns + 20 * NS)
    assert got == JExecutor(je).execute(q, db="db", now_ns=t_ns + 20 * NS)
    stmt = got["results"][0]
    assert "error" not in stmt, stmt
    graph = json.loads(stmt["series"][0]["values"][0][0])
    assert {n["uid"] for n in graph["nodes"]} == uids


@pytest.mark.parametrize("q", [
    "SELECT rca('{}') FROM events",
    "SELECT rca(1) FROM events",
    "SELECT rca('a', 'b') FROM events",
    "SELECT rca('not json') FROM events",
])
def test_sql_errors_match_jax(pair, q):
    (je, te), t_ns = pair
    got = TExecutor(te).execute(q, db="db", now_ns=t_ns + 20 * NS)
    assert "error" in got["results"][0]
    assert got == JExecutor(je).execute(q, db="db", now_ns=t_ns + 20 * NS)
