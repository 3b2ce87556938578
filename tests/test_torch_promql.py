"""The port's PromQL parser and engine against the JAX package's, on the
CPU.

- The parser: every expression that the reference's own PromQL tests
  parse or evaluate gives the same tree (the dataclasses' repr), or the
  same error class and message.
- PromEngine end to end: both packages write the same line protocol into
  roots of their own; a corpus of range and instant queries (every
  function the engine names, the aggregations, on/ignoring/group_left,
  set operators, offset, subqueries, histogram_quantile, NaN and +-Inf
  samples) must answer alike:
  - with host kernels pinned on ("1"): the host route of both, the same
    JSON bit for bit;
  - with host kernels pinned off ("0"): the port's torch route on the
    CPU against the reference's jax.numpy route; the labels, timestamps
    and special values ("NaN", "+Inf") equal, numbers at rel 1e-9
    (absolute 1e-6 where a sum cancels to ~0);
  - over a flushed device-profile root under "0", where both packages
    take the encoded decode of the value matrix and the device/decode_*
    counters move alike.
- Errors: the same message for the same bad query.
"""

import json
import math

import numpy as np
import pytest
import torch

from opengemini_tpu.promql import parser as jpp
from opengemini_tpu.promql.engine import PromEngine as JProm
from opengemini_tpu.query import offload as joffload
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.promql import parser as tpp
from opengemini_tpu_torch.promql.engine import PromEngine as TProm
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000
REL = 1e-9
ABS = 1e-6

# every expression the reference's tests/test_promql.py and
# tests/test_promql_funcs.py parse or evaluate
PARSE_CORPUS = [
    '-2^2', '1 > 2', '1 > bool 2', '2^3^2', 'a + b * 2', 'a + bool b',
    'a + ignoring(code) b', 'a / group_left b',
    'a / on(job, instance) group_left(mode) b', 'a / on(x) group_left(x) b',
    'a > bool b', 'a and b', 'a and on(x) group_left b', 'a atan2 bool b',
    'absent(ghost{job="api", code=~"5.."})', 'absent(http_requests_total)',
    'absent(nothing_here)', 'absent_over_time(m[1m])',
    'absent_over_time(nosuch{job="x"}[1m])',
    'avg_over_time(rate(reqs[1m])[9m:30s])', 'bottomk(2, gauge_metric)',
    'changes(m[2m])', 'clamp(m, 1, 3)', 'clamp(m, 3, 1)',
    'count_values by (dc) ("val", m2)', 'count_values("v", gauge_metric)',
    'deg(m)', 'deriv(m[1m])', 'deriv(m[2m])',
    'errors_total / http_requests_total', 'histogram_quantile(-1, b_bucket)',
    'histogram_quantile(0.1, nb_bucket)',
    'histogram_quantile(0.5, http_req_bucket)',
    'histogram_quantile(0.9, http_req_bucket)',
    'histogram_quantile(0.99, b_bucket)', 'histogram_quantile(1.5, b_bucket)',
    'holt_winters(m[1m], 1.5, 0.3)', 'holt_winters(m[3m], 0.5, 0.3)',
    'hour()', 'http_errors * on(method) group_left(mode) capacity',
    'http_errors / ignoring(code) group_left http_requests',
    'http_errors / ignoring(code) group_right http_requests',
    'http_errors / ignoring(code) http_requests',
    'http_errors / on(method) group_left http_requests',
    'http_errors and on(method) http_requests',
    'http_errors unless on(method) http_requests',
    'http_errors{code="500"} / ignoring(code) http_requests',
    'http_errors{code="500"} / on(method) http_requests',
    'http_errors{code="500"} > bool on(method) http_requests',
    'http_requests / on(method) group_right http_errors',
    'http_requests > 100', 'http_requests > bool 100',
    'http_requests atan2 http_requests', 'http_requests or http_errors',
    'http_requests or on(method) http_errors', 'http_requests_total',
    'http_requests_total * 2', 'http_requests_total > 3',
    'http_requests_total{instance="a"}', 'http_requests_total{instance=~"["}',
    'http_requests_total{instance=~"web.*"}',
    'http_requests_total{instance=~"web1"}',
    'http_requests_total{job="api", code=~"5.."}',
    'label_join(m, "combined", "-", "instance", "__name__")',
    'label_replace(m, "host", "$1", "instance", "(db)-.*")',
    'label_replace(m, "host", "$1", "instance", "(web)-.*")',
    'label_replace(m, "~bad~", "x", "instance", ".*")',
    'last_over_time(m[1m])', 'm[10m:30s] offset 2m', 'm[5m:1m]',
    'mad_over_time(m[2m])', 'max_over_time((2)[5m:1m])',
    'max_over_time(m[5m:0s])', 'max_over_time(m[5m:1m][10m:1m])',
    'max_over_time(max_over_time(m[2m:30s])[5m:1m])',
    'max_over_time(rate(reqs[1m])[5m:30s])',
    'max_over_time(sum(g)[5m:30s])', 'm{a="b"} offset 5m', 'pi()',
    'predict_linear(m[2m], 60)', 'present_over_time(m[1m])',
    'quantile(0.9, gauge_metric)', 'quantile(0/0, gauge_metric)',
    'quantile_over_time(0.25, m[2m])', 'quantile_over_time(0.5, m[2m])',
    'quantile_over_time(1.5, m[2m])', 'rate(http_requests_total[2m])',
    'rate(http_requests_total[5m])', 'rate(m[1m])[10m:1m]', 'resets(m[2m])',
    'scalar(http_requests_total)', 'sgn(m)', 'sin(m)', 'sort(m)',
    'sort_by_label_desc(m, "instance")', 'sort_desc(m)',
    'stddev_over_time(m[2m])', 'stdvar_over_time(m[2m])',
    'sum by (job) (rate(http_requests_total[2m]))',
    'sum by (job) (rate(m[1m]))', 'sum(m)[5m:]',
    'sum(rate(m[1m])) by (job)', 'topk(-1, gauge_metric)',
    'topk(1, gauge_metric)', 'topk(2, http_requests_total)',
    'topk(3, gauge_metric)', 'topk(3, rate(m[5m]))', 'up',
    # the parser's error paths
    'rate(', 'sum by (job', 'm{a=}', 'm[5x]', '1 +', '"unterminated',
    'm offset', 'foo{a="b"', ')', 'm @ 5',
]


def _outcome(fn, *args):
    try:
        return True, repr(fn(*args))
    except Exception as e:  # noqa: BLE001 — the class is what we compare
        return False, (type(e).__name__, str(e))


@pytest.mark.parametrize("text", PARSE_CORPUS)
def test_parser_trees(text):
    assert _outcome(tpp.parse, text) == _outcome(jpp.parse, text)


@pytest.mark.parametrize("dur", ["5m", "1h30m", "90s", "1.5h", "2d", "1w",
                                 "1y", "250ms", "", "5", "x"])
def test_parse_duration(dur):
    assert _outcome(tpp.parse_duration_s, dur) == \
        _outcome(jpp.parse_duration_s, dur)


# -- the engine corpus --------------------------------------------------------------


def _lines(rng) -> str:
    out = []
    jobs = ("api", "web", "db")
    for i in range(9):
        job = jobs[i % 3]
        inst = f"{job}-{i}"
        c = 0.0
        g = 50.0
        for k in range(80):
            if rng.random() < 0.08:
                continue
            t = (BASE + 15 * k) * NS + int(rng.integers(0, 900)) * 10**6
            c += float(rng.integers(0, 40))
            if rng.random() < 0.03:
                c = float(rng.integers(0, 5))  # a counter reset
            g += float(rng.normal(0, 3))
            gv = g
            if i == 4 and k in (10, 30):
                gv = float("nan")
            if i == 5 and k == 20:
                gv = float("inf")
            if i == 5 and k == 50:
                gv = float("-inf")
            code = "500" if i % 2 else "200"
            out.append(f"http_requests_total,code={code},instance={inst},"
                       f"job={job} value={c} {t}")
            out.append(f"m,instance={inst},job={job} value={gv!r} {t}"
                       .replace("value=nan", "value=NaN")
                       .replace("value=inf", "value=Inf")
                       .replace("value=-inf", "value=-Inf"))
            if k % 2 == 0:
                out.append(f"http_requests,method=m{i % 3},instance={inst} "
                           f"value={100 + k + i} {t}")
                out.append(f"http_errors,method=m{i % 3},code={code},"
                           f"instance={inst} value={k % 7 + i} {t}")
        for le, frac in (("0.1", 0.2), ("0.5", 0.55), ("1", 0.8),
                         ("+Inf", 1.0)):
            for k in range(0, 80, 4):
                t = (BASE + 15 * k) * NS
                out.append(f"req_bucket,job={job},le={le} "
                           f"value={math.floor((k + 1) * 10 * frac + i)} {t}")
    # one long series among short ones: the padded (S, N) value matrix
    # outweighs the encoded blocks, so the decode's cost gate lets the
    # rows matrix decode on the device route
    for i in range(8):
        n = 600 if i == 0 else 12
        for k in range(n):
            t = (BASE + 2 * k + (0 if i == 0 else 40 * k)) * NS
            out.append(f"ragged,series=r{i} value={float((k * 7 + i) % 50)} "
                       f"{t}")
    out.append(f"capacity,method=m1,mode=rw value=10 {(BASE + 600) * NS}")
    out.append(f"up,job=solo value=1 {(BASE + 300) * NS}")
    return "\n".join(l for l in out if "value=nan" not in l)


RANGE_QUERIES = [
    "rate(http_requests_total[2m])", "increase(http_requests_total[3m])",
    "delta(m[2m])", "irate(http_requests_total[1m])", "idelta(m[90s])",
    "changes(m[3m])", "resets(http_requests_total[5m])", "deriv(m[2m])",
    "predict_linear(m[2m], 120)",
    *[f"{f}_over_time(m[2m])" for f in ("sum", "avg", "count", "last",
                                        "present", "stddev", "stdvar",
                                        "min", "max")],
    "quantile_over_time(0.75, m[3m])", "mad_over_time(m[2m])",
    "holt_winters(m[5m], 0.4, 0.6)",
    "double_exponential_smoothing(m[5m], 0.3, 0.2)",
    "absent_over_time(m{job=\"nope\"}[1m])",
    "m", "m offset 2m", "abs(m)", "ceil(m)", "floor(m)", "exp(m / 100)",
    "ln(m)", "log2(m)", "log10(m)", "sqrt(m)", "round(m)", "sgn(m)",
    "sin(m)", "cos(m)", "tan(m)", "asin(m / 1000)", "acos(m / 1000)",
    "atan(m)", "sinh(m / 100)", "cosh(m / 100)", "tanh(m)",
    "asinh(m)", "acosh(m)", "atanh(m / 1000)", "deg(m)", "rad(m)",
    "clamp_min(m, 50)", "clamp_max(m, 50)", "clamp(m, 45, 55)",
    "timestamp(m)", "pi()", "time()", "minute()", "hour(m)",
    "day_of_week()", "day_of_month()", "day_of_year()", "days_in_month()",
    "month()", "year()", "scalar(up)", "vector(1)",
    "sum(m)", "avg by (job) (m)", "count(m)", "stddev(m)", "stdvar(m)",
    "group by (job) (m)", "min by (job) (m)", "max without (instance) (m)",
    "sum by (job) (rate(http_requests_total[2m]))",
    "topk(2, m)", "bottomk(2, m)", "topk by (job) (1, m)",
    "quantile(0.5, m)", "quantile by (job) (0.9, m)",
    "count_values(\"v\", round(m / 10))",
    "m * 2", "2 - m", "m / 0", "m % 7", "m ^ 2", "m atan2 m",
    "m > 50", "m > bool 50", "1 < bool 2",
    "http_errors / ignoring(code) group_left http_requests",
    "http_errors * on(method) group_left(mode) capacity",
    "http_requests / on(method) group_right http_errors",
    "http_errors{code=\"500\"} / on(method, instance) http_requests",
    "http_errors and on(method) http_requests",
    "http_errors unless on(method) http_requests",
    "http_requests or http_errors",
    "http_errors{code=\"500\"} > bool on(method, instance) http_requests",
    "histogram_quantile(0.9, req_bucket)",
    "histogram_quantile(0.5, rate(req_bucket[2m]))",
    "histogram_quantile(1.5, req_bucket)",
    "label_replace(m, \"host\", \"$1\", \"instance\", \"(web)-.*\")",
    "label_join(m, \"combined\", \"-\", \"instance\", \"job\")",
    "max_over_time(rate(http_requests_total[1m])[5m:30s])",
    "avg_over_time(sum(m)[4m:1m])", "min_over_time(m[5m:1m] offset 1m)",
    "sum by (job) (rate(http_requests_total{job=~\"a.*|w.*\"}[2m]))",
    "m{instance!~\"web-.*\", job!=\"db\"}",
    "absent(nothing_here{job=\"x\"})", "absent(m)",
    "http_requests / http_errors",
]

# the functions that always take the dense kernels (torch on the
# engine's device in the port, jax.numpy in the reference): no route
# answers them in numpy, so even under host kernels "1" they compare at
# the tolerance
DENSE = ("quantile_over_time", "mad_over_time", "holt_winters",
         "double_exponential_smoothing")

INSTANT_QUERIES = [
    "m", "sort(m)", "sort_desc(m)", "sort_by_label(m, \"instance\")",
    "sort_by_label_desc(m, \"job\", \"instance\")", "topk(3, m)",
    "rate(http_requests_total[5m])", "scalar(up)", "1 + 2", "pi()",
    "count_values by (job) (\"v\", round(m))",
    "max_over_time(m[10m])", "quantile_over_time(0.99, m[5m])",
    "m{job=\"api\"} offset 1m",
]

ERRORS = [
    "rate(m)", "m[5m]", "holt_winters(m[1m], 1.5, 0.3)",
    "label_replace(m, \"~bad~\", \"x\", \"instance\", \".*\")",
    "m{instance=~\"[\"}", "nosuchfunc(m)", "sort_by_label(m)",
    "1 > 2", "topk(0/0, m)",
    "max_over_time(m[5m:0s])", "{job=\"api\"}",
]


def _both_roots(tmp_path, monkeypatch, profile: bool):
    if profile:
        monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    body = _lines(np.random.default_rng(12))
    for e in (je, te):
        e.create_database("prom")
        e.write_lines("prom", body)
        if profile:
            e.flush_all()
    return je, te


@pytest.fixture
def roots(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je, te = _both_roots(tmp_path, monkeypatch, profile=False)
    yield JProm(je), TProm(te)
    je.close()
    te.close()


@pytest.fixture
def host_kernels():
    """Pin both packages' host-kernels switch, then restore 'auto'."""
    def pin(mode):
        joffload.set_prom_host_kernels_mode(mode)
        toffload.set_prom_host_kernels_mode(mode)

    yield pin
    pin("")


def _num(s):
    return float(s)


def _assert_same(got, want, exact):
    if exact:
        assert json.dumps(got) == json.dumps(want)
        return
    assert got["resultType"] == want["resultType"]
    if want["resultType"] == "scalar":
        _assert_value(got["result"], want["result"])
        return
    gr, wr = got["result"], want["result"]
    assert [r["metric"] for r in gr] == [r["metric"] for r in wr]
    for g, w in zip(gr, wr):
        if "values" in w:
            assert len(g["values"]) == len(w["values"])
            for a, b in zip(g["values"], w["values"]):
                _assert_value(a, b)
        else:
            _assert_value(g["value"], w["value"])


def _assert_value(a, b):
    assert a[0] == b[0]
    if a[1] in ("NaN", "+Inf", "-Inf") or b[1] in ("NaN", "+Inf", "-Inf"):
        assert a[1] == b[1]
        return
    fa, fb = _num(a[1]), _num(b[1])
    assert math.isclose(fa, fb, rel_tol=REL, abs_tol=ABS), (a, b)


def _outcome_q(fn, *args):
    try:
        return True, fn(*args)
    except Exception as e:  # noqa: BLE001 — the class is what we compare
        return False, (type(e).__name__, str(e))


@pytest.mark.parametrize("mode", ["1", "0"])
@pytest.mark.parametrize("query", RANGE_QUERIES)
def test_query_range_corpus(roots, host_kernels, mode, query):
    jp, tp = roots
    host_kernels(mode)
    args = (query, BASE + 120, BASE + 1260, 45, "prom")
    ok_w, want = _outcome_q(jp.query_range, *args)
    ok_g, got = _outcome_q(tp.query_range, *args)
    assert ok_g == ok_w, (got, want)
    if not ok_w:
        assert got == want
        return
    _assert_same(got, want, exact=(mode == "1" and not any(
        f in query for f in DENSE)))


@pytest.mark.parametrize("mode", ["1", "0"])
@pytest.mark.parametrize("query", INSTANT_QUERIES)
def test_query_instant_corpus(roots, host_kernels, mode, query):
    jp, tp = roots
    host_kernels(mode)
    for t in (BASE + 700, BASE + 1199.5):
        want = jp.query_instant(query, t, "prom")
        got = tp.query_instant(query, t, "prom")
        _assert_same(got, want, exact=(mode == "1" and not any(
            f in query for f in DENSE)))


@pytest.mark.parametrize("query", ERRORS)
def test_errors_like_the_reference(roots, query):
    jp, tp = roots
    for fn in ("query_range", "query_instant"):
        args = ((query, BASE + 120, BASE + 600, 60, "prom")
                if fn == "query_range" else (query, BASE + 600, "prom"))
        want = _outcome_q(getattr(jp, fn), *args)
        got = _outcome_q(getattr(tp, fn), *args)
        assert got[0] == want[0] is False, (query, got, want)
        assert got[1][1] == want[1][1]


def test_bad_step_ranges_like_the_reference(roots):
    jp, tp = roots
    for args in (("m", BASE, BASE + 10, 0, "prom"),
                 ("m", BASE, BASE + 10, float("inf"), "prom"),
                 ("m", BASE + 10, BASE, 1, "prom"),
                 ("m", BASE, BASE + 20_000, 1, "prom")):
        want = _outcome_q(jp.query_range, *args)
        got = _outcome_q(tp.query_range, *args)
        assert got == want


@pytest.mark.parametrize("selector", [
    'm', 'm{job="api"}', '{__name__=~"http_.*"}', '{__name__!="m",job="web"}',
    'http_errors{code!="500"}', '{job="db"}'])
def test_series_labels(roots, selector):
    jp, tp = roots
    want = _outcome_q(jp.series_labels, jpp.parse(selector), "prom")
    got = _outcome_q(tp.series_labels, tpp.parse(selector), "prom")
    assert got == want


def test_lazy_aggregation_fast_path(tmp_path, monkeypatch):
    """topk/count_values over a bare selector of >= 4096 series take the
    label-free bulk path in both packages."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    lines = "\n".join(
        f"hc,pod=p{i} value={(i * 7919) % 1000} {(BASE + 30) * NS}"
        for i in range(4200))
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    for e in (je, te):
        e.create_database("prom")
        e.write_lines("prom", lines)
    jp, tp = JProm(je), TProm(te)
    for q in ("topk(5, hc)", "bottomk(3, hc)", "count_values(\"v\", hc)"):
        assert json.dumps(tp.query_instant(q, BASE + 60, "prom")) == \
            json.dumps(jp.query_instant(q, BASE + 60, "prom"))
    je.close()
    te.close()


def test_tiled_and_dense_knobs(roots, host_kernels, monkeypatch):
    """OGT_PROM_TILED=0 sends every range function to the dense kernels;
    OGT_PROM_TILE_CELLS and OGT_PROM_BULK_SIDS read as in the
    reference."""
    jp, tp = roots
    host_kernels("0")
    for env in ({"OGT_PROM_TILED": "0"}, {"OGT_PROM_TILE_CELLS": "1"},
                {"OGT_PROM_BULK_SIDS": "1000000"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        dense = TSTATS.counters("prom").get("dense_kernels", 0)
        for q in ("rate(http_requests_total[2m])", "max_over_time(m[2m])",
                  "sum_over_time(m[90s])"):
            args = (q, BASE + 120, BASE + 1260, 45, "prom")
            _assert_same(tp.query_range(*args), jp.query_range(*args),
                         exact=False)
        if "OGT_PROM_TILED" in env:
            assert TSTATS.counters("prom")["dense_kernels"] == dense + 3
        for k in env:
            monkeypatch.delenv(k)


def test_stages_recorded(roots):
    _jp, tp = roots
    before = TSTATS.counters("query_stages")
    tp.query_range("rate(http_requests_total[2m])", BASE + 120, BASE + 1260,
                   45, "prom")
    after = TSTATS.counters("query_stages")
    for stage in ("prom_collect", "prom_prepare", "prom_kernel", "render"):
        assert after.get(f"{stage}_count", 0) > before.get(
            f"{stage}_count", 0), stage


def test_delete_then_query(tmp_path, monkeypatch):
    """A DELETE through each package's executor: the label tier's
    snapshot goes stale and the next PromQL answer drops the series."""
    from opengemini_tpu.query.executor import Executor as JExec
    from opengemini_tpu_torch.query.executor import Executor as TExec

    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je, te = _both_roots(tmp_path, monkeypatch, profile=False)
    jp, tp = JProm(je), TProm(te)
    q = 'count by (job) (m{instance=~".*-[0-4]"})'
    assert json.dumps(tp.query_instant(q, BASE + 900, "prom")) == \
        json.dumps(jp.query_instant(q, BASE + 900, "prom"))
    for ex in (JExec(je), TExec(te)):
        ex.execute("DROP SERIES FROM m WHERE instance = 'web-1'", db="prom")
    want = jp.query_instant(q, BASE + 900, "prom")
    assert json.dumps(tp.query_instant(q, BASE + 900, "prom")) == \
        json.dumps(want)
    assert "web-1" not in json.dumps(tp.series_labels(tpp.parse("m"),
                                                      "prom"))
    # a write of a new series after the delete shows up at once
    for e in (je, te):
        e.write_lines("prom", f"m,instance=web-9,job=web value=3 "
                              f"{(BASE + 890) * NS}")
    assert json.dumps(tp.query_instant("count(m)", BASE + 900, "prom")) == \
        json.dumps(jp.query_instant("count(m)", BASE + 900, "prom"))
    je.close()
    te.close()


def test_flushed_root_encoded_decode(tmp_path, monkeypatch, host_kernels):
    """Under host kernels "0" over a flushed device-profile root both
    packages keep the value column encoded and decode the rows matrix
    on the device route (the port's torch decode on the CPU); answers
    and the device/decode_* counters agree."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je, te = _both_roots(tmp_path, monkeypatch, profile=True)
    jp, tp = JProm(je), TProm(te)
    host_kernels("0")
    keys = ("decode_blocks_total", "decode_rows_total",
            "decode_payload_bytes_total", "decode_fallbacks_total")

    def snap(stats):
        c = stats.counters("device")
        return {k: c.get(k, 0) for k in keys}

    j0, t0 = snap(JSTATS), snap(TSTATS)
    for q in ("max_over_time(m[2m])", "rate(http_requests_total[3m])",
              "avg_over_time(ragged[1m])", "changes(ragged[5m])",
              "sum_over_time(ragged[2m])"):
        args = (q, BASE + 120, BASE + 1200, 60, "prom")
        _assert_same(tp.query_range(*args), jp.query_range(*args),
                     exact=False)
    j1, t1 = snap(JSTATS), snap(TSTATS)
    dj = {k: j1[k] - j0[k] for k in keys}
    dt = {k: t1[k] - t0[k] for k in keys}
    assert dt == dj
    assert dt["decode_rows_total"] > 0
    je.close()
    te.close()
