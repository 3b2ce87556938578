"""The port's Arrow Flight surface (server/flight.py) against the JAX
package's, on the CPU.

Every case of the reference's tests/test_flight.py runs on the port
(``mirror_reference``). Besides, the same DoPut batches and DoGet
tickets go to both packages' ``FlightService``: the tables and the
errors they answer are equal, and so are the rows each engine holds.
Skipped where pyarrow is absent, as the reference's tests are.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

pa = pytest.importorskip("pyarrow")
fl = pytest.importorskip("pyarrow.flight")

from opengemini_tpu.query.executor import Executor as JExecutor  # noqa: E402
from opengemini_tpu.server.flight import FlightService as JFlight  # noqa: E402
from opengemini_tpu.storage.engine import Engine as JEngine  # noqa: E402
from opengemini_tpu_torch.query.executor import Executor as TExecutor  # noqa: E402
from opengemini_tpu_torch.server.flight import FlightService as TFlight  # noqa: E402
from test_torch_raft import CpuEngine, mirror_reference  # noqa: E402

torch.set_num_threads(1)

globals().update(mirror_reference("test_flight"))

NS = 10**9
BASE = 1_700_000_000


def _serve(root, eng_cls, ex_cls, flight_cls):
    e = eng_cls(root)
    e.create_database("db")
    ex = ex_cls(e)
    svc = flight_cls(e, ex, "127.0.0.1", 0)
    svc.start()
    client = fl.connect(f"grpc://127.0.0.1:{svc.port}")
    for _ in range(100):
        try:
            list(client.do_action(fl.Action("ping", b"")))
            break
        except fl.FlightError:
            time.sleep(0.05)
    return e, ex, svc, client


def _put(client, meta, table):
    desc = fl.FlightDescriptor.for_command(json.dumps(meta).encode())
    writer, _ = client.do_put(desc, table.schema)
    writer.write_table(table)
    writer.close()


def _get(client, q):
    ticket = fl.Ticket(json.dumps({"db": "db", "q": q}).encode())
    try:
        return ("ok", client.do_get(ticket).read_all().to_pydict())
    except fl.FlightError as e:
        return ("error", type(e).__name__)


QUERIES = [
    "SELECT sum(v), sum(n) FROM cpu GROUP BY host",
    "SELECT * FROM cpu",
    "SELECT mean(v), max(v) FROM cpu WHERE time >= 0 GROUP BY time(2s), host",
    "SELECT count(msg) FROM cpu",
    "SELECT FROM",
    "DROP DATABASE db",
]


def test_the_same_batches_and_tickets_answer_alike(tmp_path):
    table = pa.table({
        "time": pa.array([(BASE + i) * NS for i in range(6)], pa.int64()),
        "host": pa.array(["a", "a", "b", "b", "c", "c"]),
        "v": pa.array([1.5, 2.5, 10.0, 20.0, None, 7.25], pa.float64()),
        "n": pa.array([1, 2, 3, None, 5, 6], pa.int64()),
        "msg": pa.array(["x", None, "y", "z", "w", "q"]),
    })
    answers = []
    for sub, cls in (("j", (JEngine, JExecutor, JFlight)),
                     ("t", (CpuEngine, TExecutor, TFlight))):
        e, ex, svc, client = _serve(str(tmp_path / sub), *cls)
        try:
            _put(client, {"db": "db", "measurement": "cpu",
                          "tag_columns": ["host"]}, table)
            answers.append([_get(client, q) for q in QUERIES]
                           + [ex.execute("SELECT * FROM cpu", db="db")])
        finally:
            client.close()
            svc.stop()
            e.close()
    assert answers[1] == answers[0]
    assert answers[0][0][0] == "ok" and answers[0][4][0] == "error"
