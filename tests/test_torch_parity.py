"""Result parity of the PyTorch port: the reference's black-box query
tables, replayed against the port's HTTP service on the CPU.

The same cases as tests/test_parity.py (tests/parity_cases.json,
transcribed from the reference's server_test.go), the same comparison
(parity_common.result_matches) and the same one-server-per-case module
fixture, with the port's ``HttpService`` over ``Engine(root,
device="cpu")``. Each query the reference suite does not skip is one
case, and every one of them must match: all 452. A query the port
could not answer yet would go into ``XFAIL`` below with the ROADMAP
item that ports what it needs; it must then fail with a statement
error saying so (never a wrong answer), and one that starts to pass
fails the test until it leaves the dict. The dict is empty.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

import pytest

import parity_common as pc

CASES = pc.load_cases()

# query id -> the ROADMAP item that ports what the query needs, for a
# query the port does not answer yet (none since subqueries, joins,
# unions, CTEs and SELECT INTO were ported)
XFAIL: dict[str, str] = {}


class PortParityServer(pc.ParityServer):
    """parity_common.ParityServer over the port: one Engine (on the CPU)
    and HttpService per case, the case's retention policy made through
    the port's own create_retention_policy."""

    def __init__(self, root: str):
        from opengemini_tpu_torch.server.http import HttpService
        from opengemini_tpu_torch.storage.engine import Engine

        self.engine = Engine(root, device="cpu")
        self.svc = HttpService(self.engine, "127.0.0.1", 0)
        self.svc.start()


@pytest.fixture(scope="module")
def server_for(tmp_path_factory):
    servers: dict[str, PortParityServer] = {}
    broken: dict[str, str] = {}

    def get(case: dict) -> PortParityServer:
        name = case["name"]
        if name in broken:
            pytest.fail(f"case setup failed earlier: {broken[name]}")
        if name not in servers:
            srv = PortParityServer(str(tmp_path_factory.mktemp(name)))
            try:
                srv.prepare(case)
            except AssertionError as e:
                srv.close()
                broken[name] = str(e)
                pytest.fail(f"case setup failed: {e}")
            servers[name] = srv
        return servers[name]

    yield get
    for srv in servers.values():
        srv.close()


def _params():
    return [
        pytest.param(case, q, f"{case['name']}#{i}",
                     id=f"{case['name']}-{i}")
        for case in CASES
        for i, q in enumerate(case["queries"])
        if not q.get("skip")
    ]


def _not_supported(actual: dict) -> bool:
    """Is every error in the answer the port's "not supported by this
    port yet" statement error (and no other answer wrong)?"""
    errors = [r["error"] for r in actual.get("results", []) if "error" in r]
    if "error" in actual:
        errors.append(actual["error"])
    return bool(errors) and all("not supported by this port yet" in e
                                for e in errors)


@pytest.mark.parametrize("case,q,qid", _params())
def test_torch_parity(case, q, qid, server_for):
    srv = server_for(case)
    actual = srv.query(q, case["db"])
    ok, why = pc.result_matches(q["exp"], actual)
    if qid in XFAIL:
        if ok:
            pytest.fail(f"unexpected pass (remove from XFAIL): {qid}")
        assert _not_supported(actual), (
            f"{qid} answers wrong instead of 'not supported': "
            f"{json.dumps(actual)[:300]}")
        pytest.xfail(f"not ported yet: {XFAIL[qid]}")
    assert ok, f"{qid}\n  q: {q['command']}\n  {why}"


def test_torch_parity_answers_get_and_post_alike(server_for):
    """A SHOW runs from a GET as from a POST; DDL needs the POST."""
    case = next(c for c in CASES if c["name"] == "TestServer_Query_ShowSeries")
    srv = server_for(case)

    def get(q):
        url = (f"http://127.0.0.1:{srv.svc.port}/query?"
               + urllib.parse.urlencode({"db": case["db"], "q": q}))
        with urllib.request.urlopen(url) as r:
            return json.loads(r.read())

    show = {"command": "SHOW SERIES", "params": {"db": case["db"]}}
    assert get("SHOW SERIES") == srv.query(show, case["db"])
    err = get("CREATE DATABASE never")["results"][0]["error"]
    assert "must be sent via POST" in err
    assert "never" not in srv.engine.databases
