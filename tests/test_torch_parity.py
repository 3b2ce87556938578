"""Result parity of the PyTorch port: the reference's black-box query
tables, replayed against the port's HTTP service on the CPU.

The same cases as tests/test_parity.py (tests/parity_cases.json,
transcribed from the reference's server_test.go), the same comparison
(parity_common.result_matches) and the same one-server-per-case module
fixture, with the port's ``HttpService`` over ``Engine(root,
device="cpu")``. Each query the reference suite does not skip is one
case. The queries the port does not answer yet stay in ``XFAIL`` below,
each with the ROADMAP item that ports what it needs: each one must fail
with a statement error saying so (never a wrong answer), and one that
starts to pass fails the test until it leaves the dict.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

import pytest

import parity_common as pc

CASES = pc.load_cases()

_SUBQUERY = "ROADMAP A4, next slice: subqueries (FROM (SELECT ...))"
_JOIN = "ROADMAP A4, next slice: joins"
_UNION = "ROADMAP A4, next slice: unions"
_INTO_CTE = "ROADMAP A4, next slice: SELECT INTO and WITH (CTEs)"
_MULTI_AGG = ("ROADMAP A4, next slice: aggregates over several sources "
              "(the reference's subquery rewrite)")

# query id -> why the port does not answer it yet
XFAIL: dict[str, str] = {
    "TestServer_CTE_Query#0": _INTO_CTE,
    "TestServer_CTE_Query#1": _INTO_CTE,
    "TestServer_CTE_Query#2": _INTO_CTE,
    "TestServer_CTE_Query#3": _INTO_CTE,
    "TestServer_CTE_Query#4": _INTO_CTE,
    "TestServer_CTE_Query#5": _INTO_CTE,
    "TestServer_FullJoin#0": _JOIN,
    "TestServer_HashJoin_Table#0": _JOIN,
    "TestServer_HashJoin_Table#1": _JOIN,
    "TestServer_HashJoin_Table#2": _JOIN,
    "TestServer_HashJoin_Table#3": _JOIN,
    "TestServer_HashJoin_Table#4": _JOIN,
    "TestServer_HashJoin_Table#5": _JOIN,
    "TestServer_HashJoin_Table#6": _JOIN,
    "TestServer_HashJoin_Table#7": _JOIN,
    "TestServer_Join_Table#0": _JOIN,
    "TestServer_Join_Table#1": _JOIN,
    "TestServer_Join_Table#10": _JOIN,
    "TestServer_Join_Table#11": _JOIN,
    "TestServer_Join_Table#12": _JOIN,
    "TestServer_Join_Table#13": _JOIN,
    "TestServer_Join_Table#14": _JOIN,
    "TestServer_Join_Table#15": _JOIN,
    "TestServer_Join_Table#16": _JOIN,
    "TestServer_Join_Table#17": _JOIN,
    "TestServer_Join_Table#18": _JOIN,
    "TestServer_Join_Table#19": _JOIN,
    "TestServer_Join_Table#2": _JOIN,
    "TestServer_Join_Table#20": _JOIN,
    "TestServer_Join_Table#21": _JOIN,
    "TestServer_Join_Table#22": _JOIN,
    "TestServer_Join_Table#23": _JOIN,
    "TestServer_Join_Table#24": _JOIN,
    "TestServer_Join_Table#25": _JOIN,
    "TestServer_Join_Table#26": _JOIN,
    "TestServer_Join_Table#27": _JOIN,
    "TestServer_Join_Table#28": _JOIN,
    "TestServer_Join_Table#29": _JOIN,
    "TestServer_Join_Table#3": _JOIN,
    "TestServer_Join_Table#30": _JOIN,
    "TestServer_Join_Table#31": _JOIN,
    "TestServer_Join_Table#4": _JOIN,
    "TestServer_Join_Table#5": _JOIN,
    "TestServer_Join_Table#6": _JOIN,
    "TestServer_Join_Table#7": _JOIN,
    "TestServer_Join_Table#8": _JOIN,
    "TestServer_Join_Table#9": _JOIN,
    "TestServer_Join_Table_With_Empty_Tag#0": _JOIN,
    "TestServer_Join_Table_With_Empty_Tag#1": _JOIN,
    "TestServer_Join_Table_With_Empty_Tag#2": _JOIN,
    "TestServer_Join_Table_With_Empty_Tag#3": _JOIN,
    "TestServer_Query_Constant_Column#0": _SUBQUERY,
    "TestServer_Query_For_BugList#4": _SUBQUERY,
    "TestServer_Query_MultiMeasurements#3": _MULTI_AGG,
    "TestServer_Query_MultiMeasurements#4": _MULTI_AGG,
    "TestServer_Query_MultiMeasurements#5": _MULTI_AGG,
    "TestServer_Query_MultiMeasurements#6": _MULTI_AGG,
    "TestServer_Query_MultiMeasurements#7": _SUBQUERY,
    "TestServer_Query_Null_Aggregate#10": _SUBQUERY,
    "TestServer_Query_Null_Aggregate#11": _SUBQUERY,
    "TestServer_Query_Null_Aggregate#12": _SUBQUERY,
    "TestServer_Query_Null_Aggregate#3": _SUBQUERY,
    "TestServer_Query_Null_Aggregate#5": _SUBQUERY,
    "TestServer_Query_Sliding_Window_Aggregate#10": _SUBQUERY,
    "TestServer_Query_Sliding_Window_Aggregate#11": _SUBQUERY,
    "TestServer_Query_Sliding_Window_Aggregate#8": _SUBQUERY,
    "TestServer_Query_Sliding_Window_Aggregate#9": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#0": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#1": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#2": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#3": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#4": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#5": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#6": _SUBQUERY,
    "TestServer_Query_SubqueryForLogicalOptimize#7": _SUBQUERY,
    "TestServer_Query_SubqueryMath#0": _SUBQUERY,
    "TestServer_Query_SubqueryWithGroupBy#0": _SUBQUERY,
    "TestServer_Query_SubqueryWithGroupBy#1": _SUBQUERY,
    "TestServer_Query_SubqueryWithGroupBy#2": _SUBQUERY,
    "TestServer_SubQuery_Top_Min#0": _SUBQUERY,
    "TestServer_Union_Table#0": _UNION,
    "TestServer_Union_Table#1": _UNION,
    "TestServer_Union_Table#10": _UNION,
    "TestServer_Union_Table#11": _UNION,
    "TestServer_Union_Table#13": _UNION,
    "TestServer_Union_Table#14": _UNION,
    "TestServer_Union_Table#15": _UNION,
    "TestServer_Union_Table#16": _UNION,
    "TestServer_Union_Table#18": _UNION,
    "TestServer_Union_Table#21": _UNION,
    "TestServer_Union_Table#22": _UNION,
    "TestServer_Union_Table#23": _UNION,
    "TestServer_Union_Table#24": _UNION,
    "TestServer_Union_Table#25": _UNION,
    "TestServer_Union_Table#26": _UNION,
    "TestServer_Union_Table#28": _UNION,
    "TestServer_Union_Table#29": _UNION,
    "TestServer_Union_Table#3": _UNION,
    "TestServer_Union_Table#6": _UNION,
    "TestServer_Union_Table#7": _UNION,
    "TestServer_Union_Table#8": _UNION,
    "TestServer_Union_Table#9": _UNION,
    "TestServer_top_bottom_nul_column#0": _SUBQUERY,
    "TestServer_top_bottom_nul_column#1": _SUBQUERY,
}


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
