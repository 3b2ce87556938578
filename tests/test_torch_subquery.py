"""The port's subqueries (query/subquery.py) against the JAX package, on
the CPU.

The JAX ``Engine``/``Executor`` and the port's ``Engine(device="cpu")``/
``Executor`` take the same seeded line protocol, and their answers must
be equal (floats at rel 1e-12):
- the reference's subquery cases (tests/test_subquery_stream.py
  ``TestSubqueries`` and the time pushdown), each also held to the
  reference's own expectation;
- the chunked inner evaluation: single-shot against chunked with the
  chunk constants monkeypatched alike in both packages, a transform
  inner that must not chunk, and the row cap's error text;
- ``_subquery_chunk_safe`` of both packages on the same statements;
- the spill engine: it runs on the caller's device (a sentinel makes
  every public ``torch.cuda`` function raise meanwhile), and no
  subquery leaves a thread or a temporary directory behind, errors
  included.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading

import pytest
import torch

from opengemini_tpu.query import subquery as jsq
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.sql.parser import parse_one as jparse
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import subquery as tsq
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.sql.parser import parse_one as tparse
from opengemini_tpu_torch.storage import engine as tengine_mod
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_040


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

    def write(self, lines: str, flush: bool = False):
        for e in (self.je, self.te):
            e.write_lines("db", lines)
            if flush:
                e.flush_all()

    def query(self, text: str, now_s: int = BASE + 10_000):
        """Both answers, compared; returns the port's."""
        want = self.jx.execute(text, db="db", now_ns=now_s * NS)
        got = self.tx.execute(text, db="db", now_ns=now_s * NS)
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


def _rows(res, i=0):
    return res["results"][0]["series"][i]["values"]


# -- the reference's subquery cases ---------------------------------------------


def test_agg_over_subquery_agg(pair):
    pair.write("\n".join(
        f"cpu,host=h{i % 3} v={(i % 3) * 10 + i % 5} {(BASE + i * 10) * NS}"
        for i in range(18)))
    where = f"time >= {BASE * NS} AND time < {(BASE + 180) * NS}"
    res = pair.query(f"SELECT max(mean) FROM (SELECT mean(v) FROM cpu WHERE "
                     f"{where} GROUP BY time(1m), host)")
    inner = pair.query(f"SELECT mean(v) FROM cpu WHERE {where} "
                       "GROUP BY time(1m), host")
    best = max(v for s in inner["results"][0]["series"]
               for _t, v in s["values"])
    assert _rows(res)[0][1] == pytest.approx(best)


def test_subquery_preserves_tags_for_group_by(pair):
    pair.write("\n".join([f"m,h=a v=1 {BASE * NS}",
                          f"m,h=a v=3 {(BASE + 1) * NS}",
                          f"m,h=b v=10 {BASE * NS}"]))
    res = pair.query("SELECT sum(v) FROM (SELECT v FROM m) GROUP BY h")
    got = {s["tags"]["h"]: s["values"][0][1]
           for s in res["results"][0]["series"]}
    assert got == {"a": 4.0, "b": 10.0}


def test_nested_subquery(pair):
    pair.write("\n".join(f"m v={i} {(BASE + i) * NS}" for i in range(10)))
    res = pair.query("SELECT count(v) FROM (SELECT v FROM (SELECT v FROM m))")
    assert _rows(res)[0][1] == 10


def test_subquery_where_on_inner_column(pair):
    pair.write("\n".join(f"m v={i} {(BASE + i) * NS}" for i in range(10)))
    res = pair.query("SELECT count(v) FROM (SELECT v FROM m) WHERE v >= 5")
    assert _rows(res)[0][1] == 5


def test_subquery_time_pushdown_correct(pair):
    week = 7 * 24 * 3600
    pair.write(f"m v=1 {BASE * NS}\nm v=2 {(BASE + week) * NS}")
    res = pair.query("SELECT count(v) FROM (SELECT v FROM m) WHERE time >= "
                     f"{(BASE + week - 60) * NS}", now_s=BASE + week + 100)
    assert _rows(res)[0][1] == 1


def test_order_by_desc_reverses_series_once(pair):
    """The series order reverses at the statement boundary only, never
    again inside the subquery's recursion."""
    pair.write("\n".join(f"m,h=h{i % 3} v={i} {(BASE + i) * NS}"
                         for i in range(12)))
    res = pair.query("SELECT max(v) FROM (SELECT v FROM m) GROUP BY h "
                     "ORDER BY time DESC")
    assert [s["tags"]["h"] for s in res["results"][0]["series"]] == [
        "h2", "h1", "h0"]


# -- chunked inner evaluation -----------------------------------------------------


def _write_hosts(pair, hosts=4, points=2500):
    pair.write("\n".join(
        f"cpu,host=h{i % hosts} v={(i % 7) + (i % hosts)} {(BASE + i) * NS}"
        for i in range(points * hosts)), flush=True)


def _single_and_chunked(pair, query, monkeypatch):
    single = pair.query(query)
    for mod in (jsq, tsq):
        monkeypatch.setattr(mod, "SUBQUERY_CHUNK_ROWS", 100)
        monkeypatch.setattr(mod, "SUBQUERY_CHUNK_TARGET", 500)
    plans = {}  # package -> the chunk plans it made
    for mod in (jsq, tsq):
        real = mod.SubqueryMixin._plan_subquery_chunks

        def plan(self, *a, _real=real, _out=plans.setdefault(mod, [])):
            out = _real(self, *a)
            _out.append(out)
            return out

        monkeypatch.setattr(mod.SubqueryMixin, "_plan_subquery_chunks", plan)
    chunked = pair.query(query)
    assert plans[tsq] == plans[jsq]
    return single, chunked, plans[tsq]


def test_chunked_agg_outer_over_agg_inner(pair, monkeypatch):
    _write_hosts(pair)
    where = f"time >= {BASE * NS} AND time < {(BASE + 10000) * NS}"
    query = (f"SELECT max(mean), count(mean) FROM (SELECT mean(v) FROM cpu "
             f"WHERE {where} GROUP BY time(1m), host) WHERE {where} "
             "GROUP BY time(10m)")
    single, chunked, plans = _single_and_chunked(pair, query, monkeypatch)
    assert "error" not in single["results"][0]
    assert single == chunked
    # 10000 rows over a target of 500 a chunk: 20 chunks, cut to 19 of 9
    # windows each on the 167 windows of the 1m grid
    assert len(plans) == 1 and len(plans[0]) == 19


def test_chunked_raw_inner_with_filter_outer(pair, monkeypatch):
    _write_hosts(pair)
    query = (f"SELECT count(v) FROM (SELECT v FROM cpu WHERE time >= "
             f"{BASE * NS} AND time < {(BASE + 10000) * NS}) WHERE v > 3")
    single, chunked, plans = _single_and_chunked(pair, query, monkeypatch)
    assert single == chunked
    # no GROUP BY time(): 20 equal spans of the range
    assert len(plans) == 1 and len(plans[0]) == 20


def test_transform_inner_not_chunked(pair, monkeypatch):
    """difference() needs neighbours across chunk edges: the planner
    must not chunk it, and the answer stays the single-shot one."""
    _write_hosts(pair, hosts=1, points=500)
    query = ("SELECT max(difference) FROM (SELECT difference(mean(v)) AS "
             f"difference FROM cpu WHERE time >= {BASE * NS} AND time < "
             f"{(BASE + 1000) * NS} GROUP BY time(1m))")
    single, chunked, plans = _single_and_chunked(pair, query, monkeypatch)
    assert single == chunked
    assert plans == []  # never planned: _subquery_chunk_safe said no


def test_row_cap_fails_loudly(pair, monkeypatch):
    _write_hosts(pair, hosts=2, points=300)
    for mod in (jsq, tsq):
        monkeypatch.setattr(mod, "SUBQUERY_MAX_ROWS", 100)
    res = pair.query("SELECT count(v) FROM (SELECT v FROM cpu)")
    assert res["results"][0]["error"] == (
        "subquery materialized more than 100 rows; narrow the inner time "
        "range (OGTPU_SUBQUERY_MAX_ROWS)")


def test_chunk_constants_read_the_same_environment():
    assert (tsq.SUBQUERY_CHUNK_ROWS, tsq.SUBQUERY_CHUNK_TARGET,
            tsq.SUBQUERY_MAX_ROWS) == (jsq.SUBQUERY_CHUNK_ROWS,
                                       jsq.SUBQUERY_CHUNK_TARGET,
                                       jsq.SUBQUERY_MAX_ROWS)


W = f"time >= {BASE * NS} AND time < {(BASE + 1000) * NS}"
CHUNK_SAFE_CASES = [
    f"SELECT mean(v) FROM cpu WHERE {W} GROUP BY time(1m), host",
    f"SELECT v FROM cpu WHERE {W}",
    "SELECT v FROM cpu",
    f"SELECT mean(v) FROM cpu WHERE {W}",
    f"SELECT mean(v) FROM cpu WHERE {W} GROUP BY time(1m) LIMIT 3",
    f"SELECT mean(v) FROM cpu WHERE {W} GROUP BY time(1m) fill(previous)",
    f"SELECT mean(v) FROM cpu WHERE {W} GROUP BY time(1m) fill(0)",
    f"SELECT mean(v) FROM cpu WHERE {W} GROUP BY time(1m) fill(none)",
    f"SELECT difference(mean(v)) FROM cpu WHERE {W} GROUP BY time(1m)",
    f"SELECT moving_average(mean(v), 2) FROM cpu WHERE {W} "
    "GROUP BY time(1m)",
    f"SELECT mean(v) FROM (SELECT v FROM cpu) WHERE {W} GROUP BY time(1m)",
    f"SELECT max(v) FROM cpu WHERE {W} GROUP BY time(1m) SLIMIT 1",
]


@pytest.mark.parametrize("text", CHUNK_SAFE_CASES)
def test_chunk_safe_matches_jax(text):
    assert tsq._subquery_chunk_safe(tparse(text)) == \
        jsq._subquery_chunk_safe(jparse(text))


# -- the spill engine -------------------------------------------------------------


class _NoCuda:
    """Makes every public torch.cuda function raise while entered."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def __enter__(self):
        def boom(*_a, **_k):
            raise AssertionError("torch.cuda was called during a CPU query")

        for name in dir(torch.cuda):
            obj = getattr(torch.cuda, name)
            if (not name.startswith("_") and callable(obj)
                    and not isinstance(obj, type)):
                self.mp.setattr(torch.cuda, name, boom)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _spill_devices(monkeypatch):
    """The devices of the engines opened under the temporary directory
    (the spill engines)."""
    seen = []
    real = tengine_mod.Engine.__init__

    def init(self, root, *a, **k):
        real(self, root, *a, **k)
        if os.path.basename(root).startswith("ogtpu-sub-"):
            seen.append(self.device)

    monkeypatch.setattr(tengine_mod.Engine, "__init__", init)
    return seen


def test_spill_engine_runs_on_the_callers_device(pair, monkeypatch):
    _write_hosts(pair, hosts=3, points=400)
    seen = _spill_devices(monkeypatch)
    where = f"time >= {BASE * NS} AND time < {(BASE + 1200) * NS}"
    queries = [
        "SELECT sum(v) FROM (SELECT v FROM cpu) GROUP BY host",
        f"SELECT max(mean) FROM (SELECT mean(v) FROM cpu WHERE {where} "
        "GROUP BY time(1m), host) GROUP BY time(5m)",
    ]
    want = [pair.jx.execute(q, db="db", now_ns=(BASE + 10_000) * NS)
            for q in queries]
    for mod in (jsq, tsq):  # the second query takes the chunked path
        monkeypatch.setattr(mod, "SUBQUERY_CHUNK_ROWS", 100)
        monkeypatch.setattr(mod, "SUBQUERY_CHUNK_TARGET", 300)
    with _NoCuda(pytest.MonkeyPatch()):
        got = [pair.tx.execute(q, db="db", now_ns=(BASE + 10_000) * NS)
               for q in queries]
    _close(got, want)
    assert seen and all(d == torch.device("cpu") for d in seen), seen


def test_no_thread_or_directory_left_behind(pair, monkeypatch, tmp_path):
    _write_hosts(pair, hosts=3, points=200)
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spill))
    seen = _spill_devices(monkeypatch)
    queries = [
        "SELECT sum(v) FROM (SELECT v FROM cpu) GROUP BY host",
        "SELECT count(v) FROM (SELECT v FROM cpu WHERE v > 2)",
        # errors inside the spill engine: an unknown outer function and
        # the row cap
        "SELECT nosuchfn(v) FROM (SELECT v FROM cpu)",
    ]
    pair.tx.execute(queries[0], db="db")  # the process-wide pools start
    start = threading.active_count()
    for i in range(20):
        q = queries[i % len(queries)]
        res = pair.tx.execute(q, db="db")
        assert ("error" in res["results"][0]) == q.startswith(
            "SELECT nosuchfn")
    monkeypatch.setattr(tsq, "SUBQUERY_MAX_ROWS", 10)
    res = pair.tx.execute(queries[0], db="db")
    assert "more than 10 rows" in res["results"][0]["error"]
    assert len(seen) == 22
    assert threading.active_count() == start
    assert os.listdir(spill) == []
