"""The port's joins, unions, CTEs, IN (SELECT ...), SELECT INTO and
aggregates over several sources against the JAX package, on the CPU.

The JAX ``Engine``/``Executor`` and the port's ``Engine(device="cpu")``/
``Executor`` take the same line protocol, and their answers must be
equal (floats at rel 1e-12). The cases are the reference's
tests/test_join_union.py (but its auth case, which is ROADMAP A8's),
each also held to the reference's own expectation, then SELECT INTO
(the written count and a read-back, top() writing its tag column back
as a tag, a missing target database, a GET refused), the four
aggregates over several sources of the reference's MultiMeasurements
table, and EXPLAIN of these statements.
"""

from __future__ import annotations

import json
import math
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000


def _close(a, b, path="$"):
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


class Pair:
    """One JAX and one port engine over the same writes."""

    def __init__(self, root):
        self.je = JEngine(str(root / "jax"))
        self.te = TEngine(str(root / "torch"), device="cpu")
        for e in (self.je, self.te):
            e.create_database("db")
        self.jx, self.tx = JExecutor(self.je), TExecutor(self.te)

    def write(self, lines: str):
        for e in (self.je, self.te):
            e.write_lines("db", lines)

    def query(self, text: str, **kw):
        """Both answers, compared; returns the port's."""
        want = self.jx.execute(text, db="db", now_ns=(BASE + 3600) * NS, **kw)
        got = self.tx.execute(text, db="db", now_ns=(BASE + 3600) * NS, **kw)
        _close(got, want)
        return got

    def close(self):
        self.je.close()
        self.te.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _series(res):
    return res["results"][0]["series"]


def _error(res):
    return res["results"][0]["error"]


# -- joins ------------------------------------------------------------------------

JOIN_LINES = "\n".join([
    f"a,tk=x v=1 {BASE * NS}",
    f"a,tk=y v=2 {BASE * NS}",
    f"b,tk=y w=20 {BASE * NS}",
    f"b,tk=z w=30 {BASE * NS}",
])


def test_inner_join_where_splits_per_side(pair):
    pair.write(JOIN_LINES)
    # a.v > 1 filters only the left side, and does not zero out b
    s = _series(pair.query("select a.v, b.w from a join b on a.tk=b.tk "
                           "where a.v > 1 group by tk"))
    assert len(s) == 1 and s[0]["tags"] == {"tk": "y"}
    assert s[0]["values"][0][1:] == [2.0, 20.0]


def test_join_where_unqualified_field_rejected(pair):
    pair.write(JOIN_LINES)
    res = pair.query("select a.v, b.w from a join b on a.tk=b.tk where v > 1")
    assert "qualify" in _error(res)


def test_join_on_field_rejected(pair):
    pair.write(JOIN_LINES)
    res = pair.query("select a.v, b.w from a join b on a.v=b.w")
    assert "tag keys only" in _error(res)


def test_outer_join_nulls_and_full_join_zero(pair):
    pair.write(JOIN_LINES)
    outer = _series(pair.query(
        "select a.v, b.w from a outer join b on a.tk=b.tk group by tk"))
    by_tag = {s["tags"]["tk"]: s["values"][0][1:] for s in outer}
    assert by_tag["x"] == [1.0, None]
    assert by_tag["z"] == [None, 30.0]
    full = _series(pair.query(
        "select a.v, b.w from a full join b on a.tk=b.tk group by tk"))
    by_tag = {s["tags"]["tk"]: s["values"][0][1:] for s in full}
    assert by_tag["x"] == [1.0, 0]
    assert by_tag["z"] == [0, 30.0]


@pytest.mark.parametrize("kind", ["inner", "left", "right", "outer", "full"])
def test_join_of_aggregate_subqueries_matches_jax(pair, kind):
    """Both sides aggregate (each through a subquery and its spill
    engine), as a dashboard's table of per-host figures does."""
    pair.write("\n".join(
        [f"cpu,host=h{i % 4} u={i * 1.5} {(BASE + i) * NS}"
         for i in range(40)]
        + [f"disk,host=h{1 + i % 4} r={i * 7}i {(BASE + i) * NS}"
           for i in range(40)]))
    res = pair.query(
        "SELECT c.m, d.r FROM (SELECT mean(u) AS m FROM cpu GROUP BY host) "
        f"AS c {kind} JOIN (SELECT max(r) AS r FROM disk GROUP BY host) AS d "
        "ON c.host = d.host GROUP BY host")
    # cpu has hosts h0-h3, disk h1-h4: one series per joined host
    assert len(_series(res)) == {"inner": 3, "left": 4, "right": 4,
                                 "outer": 5, "full": 5}[kind]


# -- unions -----------------------------------------------------------------------


def test_union_dedup_and_all(pair):
    pair.write("\n".join([f"u1 f=1 {BASE * NS}", f"u2 f=1 {BASE * NS}",
                          f"u2 f=2 {(BASE + 1) * NS}"]))
    s = _series(pair.query("select f from u1 union all select f from u2"))
    assert len(s[0]["values"]) == 3
    assert s[0]["name"] == "u1,u2"
    s = _series(pair.query("select f from u1 union select f from u2"))
    assert len(s[0]["values"]) == 2  # (t, 1) deduped across sides


def test_union_column_count_mismatch(pair):
    pair.write(f"u1 f=1 {BASE * NS}\nu2 f=1,g=2 {BASE * NS}")
    res = pair.query("select f from u1 union all select f, g from u2")
    assert "same number of result columns" in _error(res)


def test_union_in_a_subquery_keeps_repeated_rows(pair):
    """A raw projection over a union never goes through the spill
    engine, which would keep one row per (series, time)."""
    pair.write(f"u1 f=1 {BASE * NS}\nu2 f=1 {BASE * NS}")
    cte = "with u as (select f from u1 union all select f from u2) "
    s = _series(pair.query(cte + "select f from u"))
    assert len(s[0]["values"]) == 2
    # an aggregate over it materializes: the two rows share (series, time)
    res = pair.query(cte + "select count(f) from u")
    assert _series(res)[0]["values"][0][1] == 1


def test_compare_over_a_union_source(pair):
    pair.write("\n".join([f"u1 f={i} {(BASE + i * 60) * NS}"
                          for i in range(10)]
                         + [f"u2 f={i * 2} {(BASE + i * 60 + 1) * NS}"
                            for i in range(10)]))
    res = pair.query(
        "with u as (select f from u1 union all select f from u2) "
        f"select compare(f, 120) from u where time >= {(BASE + 120) * NS} "
        f"and time < {(BASE + 600) * NS}")
    assert "error" not in res["results"][0]


# -- CTEs and IN (SELECT ...) -------------------------------------------------------


def test_cte_and_in_subquery(pair):
    pair.write("\n".join([f"m,h=a f=1 {BASE * NS}", f"m,h=b f=5 {BASE * NS}",
                          f"allow v=5 {BASE * NS}"]))
    res = pair.query("with big as (select f from m where f > 2) "
                     "select f from big")
    assert _series(res)[0]["values"][0][1] == 5.0
    res = pair.query("select f from m where f in (select v from allow)")
    assert _series(res)[0]["values"][0][1] == 5.0


def test_cte_recursion_rejected(pair):
    pair.write(f"m f=1 {BASE * NS}")
    res = pair.query("with c as (select * from c) select * from c")
    assert "recursive call to itself c" in _error(res)


def test_empty_in_subquery_under_or_rejected(pair):
    pair.write(f"m,h=a f=1 {BASE * NS}")
    res = pair.query("select f from m where h = 'a' or f in "
                     "(select f from nosuch)")
    assert _error(res) == ("IN (empty subquery result) under OR is not "
                           "supported")
    # an empty IN under AND only: no rows and no error
    res = pair.query("select f from m where f in (select f from nosuch)")
    assert res["results"][0] == {"statement_id": 0}


# -- SELECT INTO --------------------------------------------------------------------


def test_select_into_writes_and_reads_back(pair):
    pair.write("\n".join(f"cpu,host=h{i % 3} v={i}.5 {(BASE + i * 20) * NS}"
                         for i in range(30)))
    res = pair.query("SELECT mean(v) AS v INTO cpu_1m FROM cpu WHERE time >= "
                     f"{BASE * NS} AND time < {(BASE + 600) * NS} "
                     "GROUP BY time(1m), host")
    assert _series(res) == [{"name": "result", "columns": ["time", "written"],
                             "values": [[0, 30]]}]
    res = pair.query("SELECT count(v) FROM cpu_1m")
    assert _series(res)[0]["values"][0][1] == 30
    pair.query("SELECT * FROM cpu_1m GROUP BY *")


def test_top_into_writes_the_tag_column_back_as_a_tag(pair):
    pair.write(f"cpu,host=server01 value=2.0 {BASE * NS}\n"
               f"cpu,host=server02 value=3.0 {(BASE + 10) * NS}\n"
               f"cpu,host=server03 value=4.0 {(BASE + 20) * NS}")
    res = pair.query("SELECT top(value, host, 2) INTO cpu_top FROM cpu")
    assert _series(res)[0]["values"] == [[0, 2]]
    s = _series(pair.query("SELECT * FROM cpu_top GROUP BY *"))
    assert sorted(x["tags"]["host"] for x in s) == ["server02", "server03"]
    pair.query("SHOW TAG KEYS FROM cpu_top")


def test_into_a_missing_database(pair):
    pair.write(f"cpu v=1 {BASE * NS}")
    res = pair.query("SELECT v INTO nodb..cpu_copy FROM cpu")
    assert _error(res) == "database not found: nodb"


def test_select_into_from_a_get_is_refused(pair):
    """influx 1.x: only a POST may write; a GET of SELECT INTO (or of
    EXPLAIN ANALYZE of one) is refused, and nothing is written."""
    from opengemini_tpu_torch.server.http import HttpService

    pair.write(f"cpu v=1 {BASE * NS}")
    for q in ("SELECT v INTO cpu_copy FROM cpu",
              "EXPLAIN ANALYZE SELECT v INTO cpu_copy FROM cpu"):
        res = pair.query(q, read_only=True)
        assert "must be sent via POST" in _error(res)
    svc = HttpService(pair.te, "127.0.0.1", 0)
    svc.start()
    try:
        url = (f"http://127.0.0.1:{svc.port}/query?" + urllib.parse.urlencode(
            {"db": "db", "q": "SELECT v INTO cpu_copy FROM cpu"}))
        with urllib.request.urlopen(url) as r:
            doc = json.loads(r.read())
    finally:
        svc.stop()
    assert doc == pair.jx.execute("SELECT v INTO cpu_copy FROM cpu",
                                  db="db", read_only=True)
    assert "series" not in pair.query("SELECT * FROM cpu_copy")["results"][0]


# -- aggregates over several sources ------------------------------------------------

MULTI_LINES = "\n".join([
    "mst,country=china,name=azhu age=12.3,height=70i 1629129600000000000",
    "mst,country=american,name=alan age=20.5,height=80i 1629129601000000000",
    "mst,country=germany,name=alang age=3.4,height=90i 1629129602000000000",
    "mst,country=japan,name=ahui age=30,height=121i 1629129603000000000",
    "mst,country=canada,name=aqiu age=35,height=138i 1629129604000000000",
    "mst,country=china,name=agang age=48.8,height=149i 1629129605000000000",
    "mst1,country=china,name=ada age=15 1625558240121000000",
    "mst1,country=china,name=billy age=27 1625558240122000000",
    "mst1,country=american,name=ben age=37 1625558240123000000",
])

MULTI_AGG_CASES = [
    "select sum(a),sum(b) from (select min(age) as a from mst1),"
    "(select sum(age) as b from mst1)",
    "select sum(a)+sum(b) from (select sum(age) as a from mst1),"
    "(select sum(age) as b from mst1)",
    "select sum(a),sum(b) from (select count(age) as a from mst where "
    "country='china' and time >= 1629129600000000000 and time <= "
    "1629129611000000000 group by time(1s)),(select count(age) as b from mst "
    "where country='china' and time >= 1629129600000000000 and time <= "
    "1629129611000000000 group by time(1s))",
    "SELECT count(age) FROM mst,mst1",
]


@pytest.mark.parametrize("text", MULTI_AGG_CASES)
def test_aggregates_over_several_sources_match_jax(pair, text):
    pair.write(MULTI_LINES)
    res = pair.query(text)
    assert "error" not in res["results"][0] and _series(res)


# -- EXPLAIN ------------------------------------------------------------------------


def test_explain_of_a_subquery_answers_as_jax(pair):
    pair.write(JOIN_LINES)
    res = pair.query("EXPLAIN SELECT count(v) FROM (SELECT v FROM a)")
    assert _error(res) == "subqueries are not supported yet"


def test_explain_analyze_of_a_subquery_shows_its_span(pair):
    pair.write(JOIN_LINES)
    q = "EXPLAIN ANALYZE SELECT count(v) FROM (SELECT v FROM a)"
    lines = [r[0] for r in _series(pair.tx.execute(q, db="db"))[0]["values"]]
    assert any(line.strip().startswith("subquery") for line in lines), lines
    assert "error" not in pair.jx.execute(q, db="db")["results"][0]


def test_explain_of_a_join_answers_a_statement_error(pair):
    """The JAX package raises AttributeError out of execute() here (its
    EXPLAIN reads a join source's database); the port answers the
    statement error of its EXPLAIN of a subquery."""
    pair.write(JOIN_LINES)
    q = "EXPLAIN select a.v, b.w from a join b on a.tk=b.tk"
    with pytest.raises(AttributeError):
        pair.jx.execute(q, db="db")
    assert _error(pair.tx.execute(q, db="db")) == (
        "subqueries are not supported yet")
