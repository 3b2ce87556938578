"""The port's tools (opengemini_tpu_torch/tools/: backup, export,
mcp_server, monitor_agent) against the JAX package's, on the CPU.

The reference's cases run on the port (``mirror_reference``): the
incremental backup and restore of tests/test_auth_delete.py, the
parquet export of tests/test_services.py and every case of
tests/test_mcp.py. Besides, on the same root both packages' backups
list the same files and restore to roots that both packages read
alike, both exports write the same rows line for line (``main`` of the
port's export opens the port's engine), both MCP servers answer the
same JSON-RPC, and both monitor agents collect the same series from one
server.
"""

from __future__ import annotations

import json
import os
import re

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.tools import backup as jbk
from opengemini_tpu.tools import mcp_server as jmcp
from opengemini_tpu.tools import monitor_agent as jmon
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.tools import backup as tbk
from opengemini_tpu_torch.tools import export as texp
from opengemini_tpu_torch.tools import mcp_server as tmcp
from opengemini_tpu_torch.tools import monitor_agent as tmon
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_auth_delete", names={
    "TestReviewRegressions.test_incremental_restore_prunes_deleted_files"}))
globals().update(mirror_reference("test_services", names={
    "TestParquetExport",
    "TestHierarchicalRegressions.test_export_includes_all_rps"}))
globals().update(mirror_reference("test_mcp"))

NS = 1_000_000_000
BASE = 1_700_000_000
Q = "SELECT count(v), sum(v), max(n) FROM cpu GROUP BY host"


def _root(path, eng_cls=JEngine):
    e = eng_cls(path)
    e.create_database("db")
    e.write_lines("db", "\n".join(
        f'cpu,host=h{i % 3} v={i * 0.5},n={i}i,msg="m{i}" {(BASE + i) * NS}'
        for i in range(40)))
    e.flush_all()
    e.write_lines("db", f"cpu,host=h9 v=1.0,n=1i {(BASE + 99) * NS}")
    return e


def _files(manifest):
    return sorted(manifest["files"]), sorted(manifest["all_files"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_backup_and_restore_match_jax(tmp_path, writer):
    eng_cls = JEngine if writer == "jax" else CpuEngine
    e = _root(str(tmp_path / "data"), eng_cls)
    e.flush_all()
    e.close()
    mj = jbk.backup(str(tmp_path / "data"), str(tmp_path / "bj"))
    mt = tbk.backup(str(tmp_path / "data"), str(tmp_path / "bt"))
    assert _files(mt) == _files(mj) and mt["kind"] == mj["kind"] == "full"
    assert tbk.restore(str(tmp_path / "bt"), str(tmp_path / "rt")) == \
        jbk.restore(str(tmp_path / "bj"), str(tmp_path / "rj"))
    answers = []
    for root in ("rj", "rt"):
        for eng_cls, ex_cls in ((JEngine, JExecutor), (CpuEngine, TExecutor)):
            e2 = eng_cls(str(tmp_path / root))
            answers.append(ex_cls(e2).execute(Q, db="db"))
            e2.close()
    assert all(a == answers[0] for a in answers)
    assert answers[0]["results"][0]["series"]


def test_backup_main_round_trips(tmp_path):
    e = _root(str(tmp_path / "data"), CpuEngine)
    e.flush_all()
    want = TExecutor(e).execute(Q, db="db")
    e.close()
    assert tbk.main(["backup", "-data", str(tmp_path / "data"),
                     "-out", str(tmp_path / "b")]) == 0
    assert tbk.main(["restore", "-backup", str(tmp_path / "b"),
                     "-data", str(tmp_path / "r")]) == 0
    e2 = CpuEngine(str(tmp_path / "r"))
    assert TExecutor(e2).execute(Q, db="db") == want
    e2.close()


def _rows(path):
    pq = pytest.importorskip("pyarrow.parquet")
    d = pq.read_table(path).to_pydict()
    cols = sorted(d)
    return cols, sorted(zip(*(d[c] for c in cols)), key=repr)


def test_export_writes_the_same_rows_as_jax(tmp_path):
    pytest.importorskip("pyarrow")
    from opengemini_tpu.tools import export as jexp

    e = _root(str(tmp_path / "data"))
    nj = jexp.export_measurement(e, "db", "cpu", str(tmp_path / "j.parquet"))
    e.close()
    e = CpuEngine(str(tmp_path / "data"))
    nt = texp.export_measurement(e, "db", "cpu", str(tmp_path / "t.parquet"))
    e.close()
    assert nt == nj == 41
    assert _rows(tmp_path / "t.parquet") == _rows(tmp_path / "j.parquet")
    assert texp.main(["-data", str(tmp_path / "data"), "-db", "db",
                      "-out", str(tmp_path / "out"), "-device", "cpu"]) == 0
    assert _rows(tmp_path / "out" / "cpu.parquet") == \
        _rows(tmp_path / "j.parquet")


MCP_CALLS = [
    ("initialize", {}),
    ("tools/list", {}),
    ("tools/call", {"name": "list_databases", "arguments": {}}),
    ("tools/call", {"name": "list_measurements", "arguments": {"db": "db"}}),
    ("tools/call", {"name": "query", "arguments": {"q": Q, "db": "db"}}),
    ("tools/call", {"name": "query", "arguments": {
        "q": "DROP DATABASE db", "db": "db"}}),
    ("tools/call", {"name": "write", "arguments": {
        "db": "db", "lines": f"cpu,host=hz v=3 {(BASE + 200) * NS}"}}),
    ("tools/call", {"name": "query", "arguments": {
        "q": "SELECT count(v) FROM cpu WHERE host = 'hz'", "db": "db"}}),
    ("tools/call", {"name": "nope", "arguments": {}}),
    ("nope/method", {}),
]


def _serve(tmp_path, sub, eng_cls, svc_cls):
    e = _root(str(tmp_path / sub), eng_cls)
    svc = svc_cls(e, "127.0.0.1", 0)
    svc.start()
    return e, svc


def test_mcp_servers_answer_the_same_rpc(tmp_path):
    answers = []
    for sub, eng_cls, svc_cls, mcp in (("j", JEngine, JHttpService, jmcp),
                                       ("t", CpuEngine, THttpService, tmcp)):
        e, svc = _serve(tmp_path, sub, eng_cls, svc_cls)
        try:
            backend = mcp.Backend(f"http://127.0.0.1:{svc.port}")
            answers.append([
                mcp.handle(backend, {"jsonrpc": "2.0", "id": i,
                                     "method": m, "params": p})
                for i, (m, p) in enumerate(MCP_CALLS)])
        finally:
            svc.stop()
            e.close()
    assert answers[1] == answers[0]


def _series_of(text):
    """collect_once's lines with the wall-clock fields left out."""
    out = []
    for line in text.splitlines():
        head, fields, ts = re.split(r"(?<!\\) ", line)
        pairs = [f.split("=", 1) for f in re.split(r"(?<!\\),", fields)]
        keys = sorted(k for k, _v in pairs)
        if head.startswith("ogmonitor_up"):
            keys = [k for k in keys if k != "ping_ms"] + [dict(pairs)["up"]]
        out.append((head, keys, ts))
    return out


def test_monitor_agents_collect_the_same_series(tmp_path):
    e, svc = _serve(tmp_path, "t", CpuEngine, THttpService)
    try:
        target = f"127.0.0.1:{svc.port}"
        pid = tmp_path / "pid"
        pid.write_text(str(os.getpid()))
        got = [_series_of(mod.collect_once(
            [target, "127.0.0.1:1"], pidfiles={target: str(pid)},
            now_ns=BASE * NS, timeout=2.0)) for mod in (jmon, tmon)]
    finally:
        svc.stop()
        e.close()
    # counters come and go between the two rounds; the series and their
    # tags do not
    assert [(h, t) for h, _k, t in got[1]] == [(h, t) for h, _k, t in got[0]]
    heads = [h for h, _k, _t in got[1]]
    assert f"ogmonitor_up,target={target}" in heads
    assert f"ogmonitor_stats,target={target}" in heads
    assert f"ogmonitor_proc,target={target}" in heads
    down = [k for h, k, _t in got[1] if h == "ogmonitor_up,target=127.0.0.1:1"]
    assert down == [["up", "0i"]]


def test_monitor_agent_reports_into_the_port(tmp_path):
    e, svc = _serve(tmp_path, "t", CpuEngine, THttpService)
    try:
        target = f"127.0.0.1:{svc.port}"
        tmon.ensure_db(target, "monitor")
        assert tmon.report(target, "monitor", tmon.collect_once(
            [target], now_ns=BASE * NS))
        out = TExecutor(e).execute(
            "SELECT up FROM ogmonitor_up", db="monitor")
        assert out["results"][0]["series"][0]["values"] == [[BASE * NS, 1]]
    finally:
        svc.stop()
        e.close()
    assert json.loads(json.dumps(out))  # plain JSON
