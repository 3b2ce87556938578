"""Query stage timing of the port against the JAX package, on the CPU:
EXPLAIN answers the reference's lines, EXPLAIN ANALYZE the reference's
span tree (names, nesting and the fields that do not measure time), and
every span adds to the ``query_stages`` counters. Also the pieces the
tracing rests on: the statistics registry's histograms, the trace
renderer and the errno taxonomy, each held to the reference's on the
same inputs.
"""

import re

import numpy as np
import pytest
import torch

from opengemini_tpu.ingest import line_protocol as jlp
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.query.qhelpers import QueryError as JQueryError
from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.record import FieldTypeConflict as JFieldTypeConflict
from opengemini_tpu.storage.engine import DatabaseNotFound as JDatabaseNotFound
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.engine import WriteError as JWriteError
from opengemini_tpu.utils import errno as jerrno
from opengemini_tpu.utils import stats as jstats
from opengemini_tpu.utils import tracing as jtracing
from opengemini_tpu_torch.ingest import line_protocol as tlp
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.query.qhelpers import QueryError as TQueryError
from opengemini_tpu_torch.record import FieldType as TFieldType
from opengemini_tpu_torch.record import FieldTypeConflict as TFieldTypeConflict
from opengemini_tpu_torch.storage.engine import DatabaseNotFound as TDatabaseNotFound
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.engine import WriteError as TWriteError
from opengemini_tpu_torch.utils import errno as terrno
from opengemini_tpu_torch.utils import stats as tstats
from opengemini_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000
NOW = (BASE + 4000) * NS
WHERE = f"time >= {BASE * NS} AND time < {(BASE + 3600) * NS}"
QUERIES = {
    "grid": f"SELECT mean(u), max(u), count(u) FROM cpu WHERE {WHERE} "
            "GROUP BY time(1m)",
    "by_host": f"SELECT mean(u) FROM cpu WHERE {WHERE} "
               "GROUP BY time(10m), host",
    "buckets": f"SELECT first(u), last(u), stddev(u) FROM cpu WHERE {WHERE} "
               "GROUP BY host",
    "regex": f"SELECT count(u) FROM /c.*/ WHERE host =~ /h[12]/ AND {WHERE}",
    "no_match": f"SELECT count(u) FROM cpu WHERE host = 'nobody' AND {WHERE}",
    "filtered": f"SELECT sum(n) FROM cpu WHERE n > 0 AND {WHERE} "
                "GROUP BY time(30m)",
}
SPAN_NAMES = {"EXPLAIN ANALYZE", "select: cpu", "map_shards", "scan",
              "colcache", "device_compute", "render"}
# fields that do not measure time or process-wide state
STABLE_FIELDS = {"shards", "series", "groups x windows", "rows",
                 "aggregates", "segments", "batch_rows", "layouts"}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(11)
    lines = [f"cpu,host=h{h} u={rng.normal():.17g},"
             f"n={int(rng.integers(-9, 9))}i {(BASE + 10 * p) * NS}"
             for p in range(360) for h in range(4)]
    je = JEngine(str(root / "jax"))
    te = TEngine(str(root / "torch"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.write_lines("db", "\n".join(lines))
        e.flush_all()  # two files: the scan reads files and memtable
        e.write_lines("db", "\n".join(lines[: len(lines) // 3]))
    yield je, te
    je.close()
    te.close()


def _lines(res: dict) -> list[str]:
    r = res["results"][0]
    assert "error" not in r, r
    return [row[0] for row in r["series"][0]["values"]]


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_explain_lines_match_jax(engines, qname):
    je, te = engines
    q = "EXPLAIN " + QUERIES[qname]
    want = JExecutor(je).execute(q, db="db", now_ns=NOW)
    got = TExecutor(te).execute(q, db="db", now_ns=NOW)
    assert got == want
    assert _lines(got)[0].startswith("QUERY PLAN for ")


_SPAN_RE = re.compile(r"^(?P<name>.+?): [0-9.]+(ns|µs|ms|s)$")


def _tree(lines: list[str]) -> list[tuple]:
    """(depth, span name, {stable field: value}) per span, in order."""
    out = []
    for line in lines:
        depth = (len(line) - len(line.lstrip(" "))) // 4
        text = line.strip()
        m = _SPAN_RE.match(text)
        if m and m.group("name") in SPAN_NAMES:
            out.append((depth, m.group("name"), {}))
            continue
        key, _, value = text.partition(": ")
        assert out and depth == out[-1][0] + 1, line
        if key in STABLE_FIELDS:
            out[-1][2][key] = value
    return out


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_explain_analyze_tree_matches_jax(engines, qname, monkeypatch):
    # both packages' result caches off: a repeated query would be a hit
    # in one package and a scan in the other
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je, te = engines
    q = "EXPLAIN ANALYZE " + QUERIES[qname]
    want = _tree(_lines(JExecutor(je).execute(q, db="db", now_ns=NOW)))
    got = _tree(_lines(TExecutor(te).execute(q, db="db", now_ns=NOW)))
    assert got == want
    assert [name for _d, name, _f in got][:2] == ["EXPLAIN ANALYZE",
                                                  "select: cpu"]


def test_explain_over_get_and_errors_match_jax(engines):
    je, te = engines
    for q in ("EXPLAIN " + QUERIES["grid"],
              "EXPLAIN SELECT count(u) FROM cpu",
              "EXPLAIN SELECT count(u) FROM nodb..cpu"):
        want = JExecutor(je).execute(q, db="db", now_ns=NOW, read_only=True)
        got = TExecutor(te).execute(q, db="db", now_ns=NOW, read_only=True)
        assert got == want, q


STAGES = ("select: cpu", "map_shards", "scan", "colcache", "device_compute",
          "render")


@pytest.mark.parametrize("qname", ["grid", "buckets"])
def test_query_stages_rise_per_stage(engines, qname):
    _je, te = engines
    before = tstats.GLOBAL.counters("query_stages")
    res = TExecutor(te).execute(QUERIES[qname], db="db", now_ns=NOW)
    assert "error" not in res["results"][0]
    after = tstats.GLOBAL.counters("query_stages")
    for stage in ("parse", "plan", *STAGES):
        assert after[f"{stage}_count"] == before.get(f"{stage}_count", 0) + 1
        assert after[f"{stage}_ns"] > before.get(f"{stage}_ns", 0)
    hist = dict(((n, lab), h) for n, lab, h in tstats.histograms_snapshot())
    assert hist[("query_stage_seconds", (("stage", "scan"),))]["count"] >= 1


def test_per_query_tree_when_armed(engines):
    _je, te = engines
    ttracing.set_trace_enabled(True)
    try:
        TExecutor(te).execute(QUERIES["grid"], db="db", now_ns=NOW)
    finally:
        ttracing.set_trace_enabled(False)
    newest = ttracing.recent_traces()[0]
    doc = ttracing.get_trace(newest["qid"])
    root = doc["trace"]["root"]
    assert root["name"] == "query" and newest["database"] == "db"
    [sel] = root["children"]
    assert sel["name"] == "select: cpu"
    # a GROUP BY time() aggregate merges the result cache before render
    assert [c["name"] for c in sel["children"]] == [*STAGES[1:-1],
                                                    "inc_cache", "render"]
    assert ttracing.get_trace(trace_id=doc["trace_id"]) is doc


def test_render_and_fmt_match_jax():
    for ns in (0, 999, 1000, 1234567, 999_999_999, 1_000_000_000,
               98_765_432_101):
        assert ttracing._fmt_ns(ns) == jtracing._fmt_ns(ns)

    def build(mod):
        t = mod.Trace("EXPLAIN ANALYZE")
        with t.span("select: m"):
            with t.span("scan") as sp:
                sp.add_field("rows", 7)
            with t.span("render"):
                pass
        t.finish()
        for i, span in enumerate((t.root, t.root.children[0],
                                  *t.root.children[0].children)):
            span.elapsed_ns = 10 ** (3 * i + 1) + i
        return t.render()

    assert build(ttracing) == build(jtracing)


def test_histograms_match_jax():
    rng = np.random.default_rng(3)
    ns = [0, 1, 1023, 1024, 1025, 2**35, 2**35 + 1, 2**40,
          *rng.integers(0, 2**36, 500).tolist()]
    th, jh = tstats.Histogram("x"), jstats.Histogram("x")
    for v in ns:
        th.observe_ns(v)
        jh.observe_ns(v)
    assert th.snapshot() == jh.snapshot()


def test_statistics_registry():
    reg = tstats.Statistics()
    reg.incr("m", "a")
    reg.incr("m", "a", 4)
    reg.set("m", "b", 9)
    reg.incr("n", "c", 2)
    assert reg.counters("m") == {"a": 5, "b": 9}
    assert reg.counters("absent") == {}
    assert reg.snapshot() == {"m": {"a": 5, "b": 9}, "n": {"c": 2}}


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return e
    raise AssertionError("did not raise")


ERRORS = {
    "parse": (lambda: jlp.parse_lines("m f=abc"),
              lambda: tlp.parse_lines("m f=abc")),
    "conflict": (lambda: _raise(JFieldTypeConflict("f", JFieldType.FLOAT,
                                                   JFieldType.INT)),
                 lambda: _raise(TFieldTypeConflict("f", TFieldType.FLOAT,
                                                   TFieldType.INT))),
    "no_db": (lambda: _raise(JDatabaseNotFound("x")),
              lambda: _raise(TDatabaseNotFound("x"))),
    "write_rp": (lambda: _raise(JWriteError("retention policy not found")),
                 lambda: _raise(TWriteError("retention policy not found"))),
    "write_disabled": (lambda: _raise(JWriteError("writes are disabled")),
                       lambda: _raise(TWriteError("writes are disabled"))),
    "write_other": (lambda: _raise(JWriteError("invalid name")),
                    lambda: _raise(TWriteError("invalid name"))),
    "measurement": (lambda: _raise(JQueryError("measurement not found")),
                    lambda: _raise(TQueryError("measurement not found"))),
    "buckets": (lambda: _raise(JQueryError("time range too large")),
                lambda: _raise(TQueryError("time range too large"))),
    "unsupported": (lambda: _raise(JQueryError("x is not supported")),
                    lambda: _raise(TQueryError("x is not supported"))),
    "query_parse": (lambda: _raise(JQueryError("expected FROM")),
                    lambda: _raise(TQueryError("expected FROM"))),
    "query_other": (lambda: _raise(JQueryError("bad")),
                    lambda: _raise(TQueryError("bad"))),
    "os": (lambda: _raise(OSError("x")), lambda: _raise(OSError("x"))),
    "other": (lambda: _raise(KeyError("x")), lambda: _raise(KeyError("x"))),
}


def _raise(exc):
    raise exc


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errno_classify_matches_jax(case):
    jfn, tfn = ERRORS[case]
    jcode, jmod = jerrno.classify(_raises(jfn))
    tcode, tmod = terrno.classify(_raises(tfn))
    assert (tcode, tmod.name) == (jcode, jmod.name)
    assert terrno.tag(_raises(tfn)) == jerrno.tag(_raises(jfn))


def test_errno_explicit_pin():
    e = ValueError("x")
    e.og_errno = 4242
    e.og_module = terrno.Module.STORAGE
    assert terrno.classify(e) == (4242, terrno.Module.STORAGE)
