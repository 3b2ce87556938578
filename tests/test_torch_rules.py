"""The port's PromQL rule engine (promql/rules.py, services/rules.py)
and its tile partials (ops/prom.py) against the JAX package, on the CPU.

Every case of the reference's tests/test_rules.py runs in both packages
on the same seeded writes (the JAX ``Engine`` and the port's
``Engine(device="cpu")``, each with its own ``RuleManager``), with the
from-scratch verify leg on (``OGT_RULES_VERIFY=1``) and held to the
reference test's own checks; besides, the port's tick outputs, rule
state files, ``status()`` and the ``/api/v1/rules`` and
``/api/v1/alerts`` documents equal the JAX package's: tiled rules bit
for bit, fallback rules within rel 1e-12 (the wall-clock fields,
``last_tick_ms`` and ``evaluationTime``, aside). The clustered
service's leader-only tick is ROADMAP A8's and has no case here.

The tile partials (``empty_tile_partials``, ``fold_tile_partials``,
``merge_tile_partials``, ``partials_answer``) equal the reference's bit
for bit over every ``PARTIAL_*`` function, under hypothesis on empty
tiles, single samples, counter resets and NaN.
"""

from __future__ import annotations

import json
import math
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from opengemini_tpu.ops import prom as jprom
from opengemini_tpu.promql import engine as jpe
from opengemini_tpu.promql import rules as jrules
from opengemini_tpu.server import http as jhttp
from opengemini_tpu.services import rules as jsvc
from opengemini_tpu.storage import engine as jeng
from opengemini_tpu.utils import failpoint as jfp
from opengemini_tpu.utils.governor import GOVERNOR as JGOV
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.ops import prom as tprom
from opengemini_tpu_torch.promql import engine as tpe
from opengemini_tpu_torch.promql import rules as trules
from opengemini_tpu_torch.server import http as thttp
from opengemini_tpu_torch.services import rules as tsvc
from opengemini_tpu_torch.storage import engine as teng
from opengemini_tpu_torch.utils import failpoint as tfp
from opengemini_tpu_torch.utils.governor import GOVERNOR as TGOV
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040  # minute-aligned


class Pkg:
    def __init__(self, name, eng, rules, pe, svc, http, fp, stats, gov, kw):
        self.name = name
        self.eng = eng
        self.rules = rules
        self.pe = pe
        self.svc = svc
        self.http = http
        self.fp = fp
        self.stats = stats
        self.gov = gov
        self.kw = kw

    def engine(self, root):
        return self.eng.Engine(str(root), **self.kw)

    def mgr(self, e):
        return self.rules.RuleManager(e)

    def rule(self, *a, **k):
        return self.rules.Rule(*a, **k)

    def abandon(self, mgr):
        """A crash: drop the manager without the close-time save."""
        self.stats.unregister_provider("rules", mgr._stats_provider)
        if getattr(mgr.engine, "rules_hook", None) is mgr:
            mgr.engine.rules_hook = None
        mgr._closed = True


JAX = Pkg("jax", jeng, jrules, jpe, jsvc, jhttp, jfp, JSTATS, JGOV, {})
PORT = Pkg("torch", teng, trules, tpe, tsvc, thttp, tfp, TSTATS, TGOV,
           {"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _verify_on(monkeypatch):
    # every tick runs the from-scratch verify leg in both packages
    monkeypatch.setenv("OGT_RULES_VERIFY", "1")
    yield
    jfp.disable_all()
    tfp.disable_all()


def same(a, b, rel=0.0, path="$"):
    """Equal documents: floats bit for bit (NaN equal), or within `rel`."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        elif rel:
            assert math.isclose(a, b, rel_tol=rel, abs_tol=0), (path, a, b)
        else:
            assert a == b, (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a, key=repr) == sorted(b, key=repr), (path, a, b)
        for k in a:
            same(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, rel, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def results_of(g) -> dict:
    """A group's last tick: {rule: sorted [(labels, value)]}."""
    return {name: sorted(res.items()) for name, res in g.last_results.items()}


def status_of(mgr) -> dict:
    out = mgr.status()
    for st_ in out.values():
        st_.pop("last_tick_ms")
    return out


def rules_doc(doc: dict) -> dict:
    for g in doc.get("data", doc).get("groups", []):
        for r in g["rules"]:
            r.pop("evaluationTime", None)
    return doc


def state_files(root) -> dict:
    out = {}
    base = root / "rules"
    if base.is_dir():
        for p in sorted(base.rglob("*.json")):
            out[str(p.relative_to(base))] = json.loads(p.read_text())
    return out


def write_counter(e, rng, n=200, hosts=3, base=BASE, jitter=True,
                  mst="http_requests_total"):
    """Ragged counter series with resets (the reference test's writer)."""
    lines = []
    for h in range(hosts):
        t = float(base)
        v = rng.random() * 5
        for _ in range(n):
            t += float(rng.integers(1, 5)) if jitter else 2.0
            v += float(rng.random() * 10)
            if rng.random() < 0.03:
                v = float(rng.random())  # counter reset
            lines.append(f"{mst},job=api,host=h{h} value={v} "
                         f"{int(t * NS)}")
    e.write_lines("db", "\n".join(lines))


def both(tmp_path, scenario, rel=0.0):
    """`scenario(pkg, root)` in both packages on the same seeds; the
    port's outcome equals the JAX package's."""
    outs = [scenario(p, tmp_path / p.name) for p in PKGS]
    same(outs[1], outs[0], rel)
    return outs[1]


def with_engine(p, root, fn):
    e = p.engine(root)
    e.create_database("db")
    try:
        return fn(e)
    finally:
        e.close()


# -- the compiler -----------------------------------------------------------

TILED = [
    ("rate(m[5m])", "rate", None, None),
    ("increase(m{a=\"b\"}[60s])", "increase", None, None),
    ("sum by (job) (rate(m[1m]))", "rate", "sum", None),
    ("avg_over_time(m[2m]) > 5", "avg", None, ">"),
    ("max by (host) (delta(m[30s])) <= 0", "delta", "max", "<="),
    ("changes(m[1m])", "changes", None, None),
    ("5 < min_over_time(m[90s])", "min", None, "<"),
    ("count without (host) (resets(m[45s]))", "resets", "count", None),
]
FALLBACK = [
    "histogram_quantile(0.9, rate(m[5m]))",  # unsupported function
    "rate(m[5m] offset 1m)",                 # offset
    "topk(3, rate(m[5m]))",                  # param aggregation
    "rate(m[5m]) / rate(n[5m])",             # vector/vector binop
    "m",                                     # bare instant vector
    "rate(m[1h]) * 2",                       # arithmetic on the result
]


def _compiled(c) -> dict:
    return {k: (getattr(c, k) if k != "matchers" else
                [(m.name, m.op, m.value) for m in c.matchers])
            for k in ("tiled", "metric", "matchers", "window_s", "func",
                      "agg_op", "agg_grouping", "agg_without", "cmp_op",
                      "cmp_thr", "cmp_flip")}


@pytest.mark.parametrize("expr,func,agg,cmp_op", TILED)
def test_tiled_shapes(expr, func, agg, cmp_op):
    c = trules.compile_expr(expr)
    assert c.tiled and c.func == func
    assert c.agg_op == agg and c.cmp_op == cmp_op
    assert _compiled(c) == _compiled(jrules.compile_expr(expr))


@pytest.mark.parametrize("expr", FALLBACK)
def test_fallback_shapes(expr):
    c = trules.compile_expr(expr)
    assert not c.tiled
    assert _compiled(c) == _compiled(jrules.compile_expr(expr))


@pytest.mark.parametrize("args,kw", [
    (("r", "rate(m[5m"), {}),              # a parse error at declare
    (("bad name!", "rate(m[5m])"), {}),
    (("r", "m"), {"kind": "nonsense"}),
    (("", "m"), {}),
])
def test_bad_rules_rejected(args, kw):
    errs = []
    for p in PKGS:
        with pytest.raises(Exception) as ei:
            p.rule(*args, **kw)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0]
    if args[0] != "r" or kw:
        assert errs[1][0] == "RuleError"


# -- incremental against rescan ----------------------------------------------

EXPRS = [
    "rate(http_requests_total[60s])",
    "increase(http_requests_total[45s])",
    "sum by (job) (rate(http_requests_total[90s]))",
    "avg_over_time(http_requests_total[60s])",
    "max_over_time(http_requests_total[30s])",
    "stddev_over_time(http_requests_total[60s])",
    "resets(http_requests_total[90s])",
    "changes(http_requests_total[60s])",
    "count_over_time(http_requests_total[45s])",
    "delta(http_requests_total[60s])",
    "stdvar_over_time(http_requests_total[45s])",
    "last_over_time(http_requests_total[30s])",
    "present_over_time(http_requests_total[60s])",
    "sum_over_time(http_requests_total[90s])",
    "min by (host) (min_over_time(http_requests_total[60s]))",
    "avg without (host) (rate(http_requests_total[60s])) > 1",
]


def test_incremental_matches_rescan_over_rounds(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(11)
            mgr = p.mgr(e)
            try:
                mgr.add_rules("db", "g", [p.rule(f"rec_{i}", expr)
                                          for i, expr in enumerate(EXPRS)],
                              interval_s=15)
                c0 = dict(p.stats.counters("rules"))
                now = BASE
                ticks = []
                for _round in range(6):
                    write_counter(e, rng, n=60, base=now)
                    now += 120
                    assert mgr.tick(int(now * NS)) == 1
                    ticks.append(results_of(mgr.groups_for("db")[0]))
                    # late data into tiles already folded, then a tick
                    write_counter(e, rng, n=20, base=now - 300)
                    now += 15
                    assert mgr.tick(int(now * NS)) == 1
                    ticks.append(results_of(mgr.groups_for("db")[0]))
                c = p.stats.counters("rules")
                delta = {k: c.get(k, 0) - c0.get(k, 0)
                         for k in ("verify_ticks", "verify_failures",
                                   "tiles_folded", "ticks",
                                   "series_written", "dirty_marks")}
                assert delta["verify_ticks"] == 12
                assert delta["verify_failures"] == 0
                assert delta["tiles_folded"] > 0
                return {"ticks": ticks, "counters": delta,
                        "status": status_of(mgr)}
            finally:
                mgr.close()

        out = with_engine(p, root, run)
        out["state"] = state_files(root)
        return out

    both(tmp_path, scenario)


def test_late_data_redirties(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(3)
            mgr = p.mgr(e)
            try:
                mgr.add_rule("db", "g",
                             p.rule("r", "rate(http_requests_total[60s])"),
                             interval_s=15)
                write_counter(e, rng, n=100)
                now = BASE + 260
                mgr.tick(int(now * NS))
                folded0 = p.stats.counters("rules")["tiles_folded"]
                first = results_of(mgr.groups_for("db")[0])
                # an in-window late write dirties covered tiles
                e.write_lines("db", "http_requests_total,job=api,host=h0 "
                                    f"value=7 {int((now - 30) * NS)}")
                g = mgr.groups_for("db")[0]
                dirty = sorted(t for s in g._sels.values() for t in s.dirty)
                assert dirty
                mgr.tick(int((now + 15) * NS))
                folded = p.stats.counters("rules")["tiles_folded"] - folded0
                assert folded > 0
                return {"first": first, "dirty": dirty, "folded": folded,
                        "after": results_of(g)}
            finally:
                mgr.close()

        return with_engine(p, root, run)

    both(tmp_path, scenario)


def test_recorded_series_match_on_demand(tmp_path):
    """Recording output read back through the query path agrees with the
    expression evaluated at the same timestamp (rel 1e-6, the reference
    test's), and the port's recorded and on-demand answers equal the JAX
    package's."""
    expr = "sum by (job) (rate(http_requests_total[60s]))"

    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(5)
            mgr = p.mgr(e)
            try:
                mgr.add_rule("db", "g", p.rule("job:http:rate1m", expr),
                             interval_s=15)
                write_counter(e, rng, n=120)
                now = BASE + 250
                mgr.tick(int(now * NS))
                te = mgr.eval_time(mgr.groups_for("db")[0], int(now * NS))
                pe = p.pe.PromEngine(e)
                rec = pe.query_instant("job:http:rate1m", te / 1e9, "db")
                ond = pe.query_instant(expr, te / 1e9, "db")
                assert rec["result"] and ond["result"]
                got = float(rec["result"][0]["value"][1])
                want = float(ond["result"][0]["value"][1])
                assert got == pytest.approx(want, rel=1e-6)
                return {"recorded": rec, "tick": results_of(
                    mgr.groups_for("db")[0])}, ond
            finally:
                mgr.close()

        return with_engine(p, root, run)

    outs = [scenario(p, tmp_path / p.name) for p in PKGS]
    same(outs[1][0], outs[0][0])
    same(outs[1][1], outs[0][1], rel=1e-12)


def test_fallback_rules_still_evaluate(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(9)
            mgr = p.mgr(e)
            try:
                mgr.add_rules("db", "g", [
                    p.rule("r", "topk(2, rate(http_requests_total[60s]))"),
                    p.rule("q", "rate(http_requests_total[60s]) / "
                                "rate(http_requests_total[30s])")],
                    interval_s=15)
                g = mgr.groups_for("db")[0]
                assert not any(r.compiled.tiled for r in g.rules)
                write_counter(e, rng, n=80)
                base0 = p.stats.counters("rules").get("fallback_evals", 0)
                mgr.tick(int((BASE + 200) * NS))
                n_fb = p.stats.counters("rules")["fallback_evals"] - base0
                assert n_fb == 2
                got = p.pe.PromEngine(e).query_instant("r", BASE + 200, "db")
                assert got["result"]
                return {"tick": results_of(g), "read": got}
            finally:
                mgr.close()

        return with_engine(p, root, run)

    both(tmp_path, scenario, rel=1e-12)


# -- the alert state machine --------------------------------------------------

ALERT = "sum by (job) (rate(http_requests_total[60s])) > 0.01"


def _alerting(p, e, for_s=30.0):
    mgr = p.mgr(e)
    mgr.add_rule("db", "g", p.rule("high", ALERT, kind="alerting",
                                   for_s=for_s,
                                   labels={"severity": "page"},
                                   annotations={"summary": "hot"}),
                 interval_s=15)
    return mgr


def test_pending_firing_resolved(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(21)
            mgr = _alerting(p, e)
            docs = []
            try:
                write_counter(e, rng, n=100)
                now = BASE + 230
                mgr.tick(int(now * NS))
                st_ = mgr.status()["db.g"]
                assert st_["alerts_pending"] == 1 and st_["alerts_firing"] == 0
                docs.append((status_of(mgr), mgr.alerts_api(),
                             rules_doc(mgr.rules_api())))
                mgr.tick(int((now + 15) * NS))  # 15 s < for=30 s
                assert mgr.status()["db.g"]["alerts_pending"] == 1
                mgr.tick(int((now + 30) * NS))  # the for-duration met
                st_ = mgr.status()["db.g"]
                assert st_["alerts_firing"] == 1
                assert st_["fires"] == {"high": 1}
                al = mgr.alerts_api()["alerts"]
                assert al[0]["state"] == "firing"
                assert al[0]["labels"]["alertname"] == "high"
                assert al[0]["labels"]["severity"] == "page"
                docs.append((status_of(mgr), mgr.alerts_api(),
                             rules_doc(mgr.rules_api())))
                # traffic stops: the window empties -> resolved
                mgr.tick(int((now + 400) * NS))
                st_ = mgr.status()["db.g"]
                assert st_["alerts_firing"] == 0
                assert st_["resolves"] == {"high": 1}
                assert mgr.alerts_api()["alerts"] == []
                docs.append((status_of(mgr), mgr.alerts_api(),
                             rules_doc(mgr.rules_api())))
                return docs
            finally:
                mgr.close()

        out = with_engine(p, root, run)
        return {"docs": out, "state": state_files(root)}

    both(tmp_path, scenario)


def test_state_survives_restart(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(22)
            mgr = _alerting(p, e)
            write_counter(e, rng, n=100)
            now = BASE + 230
            mgr.tick(int(now * NS))
            assert mgr.status()["db.g"]["alerts_pending"] == 1
            mgr.close()  # a clean shutdown keeps pending and the watermark
            mgr2 = p.mgr(e)
            try:
                st_ = mgr2.status()["db.g"]
                assert st_["alerts_pending"] == 1
                mgr2.tick(int((now + 30) * NS))
                st_ = mgr2.status()["db.g"]
                # active_since kept: the for-duration spans the restart
                assert st_["alerts_firing"] == 1
                assert st_["fires"] == {"high": 1}
                return status_of(mgr2), mgr2.alerts_api()
            finally:
                mgr2.close()

        return with_engine(p, root, run), state_files(root)

    both(tmp_path, scenario)


def test_crash_at_mark_edge_never_double_fires(tmp_path):
    """A tick killed at the durable-claim edge, a restart and the same
    eval time again: exactly one fire, the firing state intact."""
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(23)
            mgr = _alerting(p, e, for_s=0.0)  # fires on the first breach
            write_counter(e, rng, n=100)
            now = BASE + 230
            p.fp.enable("rules-mark-before-eval", "error")
            with pytest.raises(p.fp.FailpointError):
                mgr.tick(int(now * NS))
            p.fp.disable_all()
            claimed = state_files(root)
            p.abandon(mgr)
            mgr2 = p.mgr(e)
            g = mgr2.groups_for("db")[0]
            assert g.claimed_ns is not None and g.last_eval_ns is None
            assert mgr2.status()["db.g"]["fires"] == {}
            mgr2.tick(int(now * NS))  # the re-run of the claimed tick
            st_ = mgr2.status()["db.g"]
            assert st_["alerts_firing"] == 1 and st_["fires"] == {"high": 1}
            mgr2.close()
            mgr3 = p.mgr(e)
            try:
                mgr3.tick(int(now * NS))  # the watermark moved: a no-op
                assert mgr3.status()["db.g"]["fires"] == {"high": 1}
                return claimed, status_of(mgr3), mgr3.alerts_api()
            finally:
                mgr3.close()

        return with_engine(p, root, run), state_files(root)

    both(tmp_path, scenario)


def test_firing_state_survives_kill_after_fire(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(24)
            mgr = _alerting(p, e, for_s=0.0)
            write_counter(e, rng, n=100)
            now = BASE + 230
            mgr.tick(int(now * NS))
            assert mgr.status()["db.g"]["fires"] == {"high": 1}
            p.abandon(mgr)  # a crash, no clean shutdown
            mgr2 = p.mgr(e)
            try:
                st_ = mgr2.status()["db.g"]
                assert st_["alerts_firing"] == 1
                assert st_["fires"] == {"high": 1}
                return status_of(mgr2), mgr2.alerts_api()
            finally:
                mgr2.close()

        return with_engine(p, root, run)

    both(tmp_path, scenario)


# -- the service ----------------------------------------------------------------

def test_service_ticks_on_one_node(tmp_path):
    """On one node the port's service ticks every group (the clustered
    lease is ROADMAP A8's), as the reference's does without a router."""
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(31)
            mgr = p.mgr(e)
            try:
                mgr.add_rule("db", "g",
                             p.rule("r", "rate(http_requests_total[60s])"),
                             interval_s=15)
                write_counter(e, rng, n=60)
                svc = p.svc.RulesService(e, manager=mgr)
                n = [svc.handle(int((BASE + 200) * NS)),
                     svc.handle(int((BASE + 200) * NS)),
                     svc.handle(int((BASE + 230) * NS))]
                assert n == [1, 0, 1]
                # the engine's hook stands in for a manager not passed
                assert p.svc.RulesService(e).handle(
                    int((BASE + 260) * NS)) == 1
                return n, results_of(mgr.groups_for("db")[0])
            finally:
                mgr.close()

        return with_engine(p, root, run)

    both(tmp_path, scenario)


def test_tenant_charging(tmp_path):
    def scenario(p, root):
        def run(e):
            rng = np.random.default_rng(32)
            mgr = p.mgr(e)
            p.gov.configure(budget_mb=64)
            p.gov.reset()  # drop accounts charged by earlier tests
            try:
                mgr.add_rule("db", "g",
                             p.rule("r", "rate(http_requests_total[60s])"),
                             interval_s=15)
                write_counter(e, rng, n=60)
                svc = p.svc.RulesService(e, manager=mgr)
                assert svc.handle(int((BASE + 200) * NS)) == 1
                acct = p.gov.tenant_accounts()["db"]
                assert acct["rules_groups"] == 1
                assert "rules_ms" in acct
                return sorted(acct)
            finally:
                p.gov.configure(budget_mb=0)
                p.gov.reset()
                mgr.close()

        return with_engine(p, root, run)

    both(tmp_path, scenario)


def test_service_inert_without_manager(tmp_path):
    for p in PKGS:
        with_engine(p, tmp_path / p.name,
                    lambda e, p=p: p.svc.RulesService(e).handle() == 0
                    or pytest.fail(p.name))


# -- the HTTP surfaces ------------------------------------------------------------

def _post(port, path, **params):
    url = (f"http://127.0.0.1:{port}{path}?"
           + urllib.parse.urlencode(params))
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def _served(p, root, fn):
    e = p.engine(root)
    e.create_database("db")
    svc = p.http.HttpService(e, "127.0.0.1", 0)
    svc.start()
    try:
        return fn(svc, e)
    finally:
        if getattr(svc, "rules_manager", None) is not None:
            svc.rules_manager.close()
        svc.stop()
        e.close()


def _ctrl_docs(out: dict) -> dict:
    for g in out.get("groups", {}).values():
        g.pop("last_tick_ms", None)
    return out


def test_ctrl_declare_tick_status_drop(tmp_path):
    def scenario(p, root):
        def run(svc, engine):
            rng = np.random.default_rng(41)
            write_counter(engine, rng, n=80)
            docs = []
            code, out = _post(
                svc.port, "/debug/ctrl", mod="rules", op="declare", db="db",
                group="g", interval_s="15",
                record="job:rate", expr="rate(http_requests_total[60s])")
            assert code == 200 and out["enabled"]
            docs.append(_ctrl_docs(out))
            code, out = _post(
                svc.port, "/debug/ctrl", mod="rules", op="declare", db="db",
                group="g", alert="hot", expr=ALERT, for_s="0",
                labels=json.dumps({"severity": "page"}))
            assert code == 200
            assert {r["name"] for r in out["groups"]["db.g"]["rules"]} == \
                {"job:rate", "hot"}
            docs.append(_ctrl_docs(out))
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              op="tick", db="db",
                              now_ns=str((BASE + 230) * NS))
            assert code == 200 and out["ticked"] == 1
            st_ = out["groups"]["db.g"]
            assert st_["last_eval_ns"] is not None
            assert st_["alerts_firing"] == 1
            docs.append(_ctrl_docs(out))
            code, out = _get(svc.port, "/api/v1/rules")
            assert code == 200 and out["status"] == "success"
            grp = out["data"]["groups"][0]
            assert grp["name"] == "g" and grp["file"] == "db"
            kinds = {r["name"]: r["type"] for r in grp["rules"]}
            assert kinds == {"job:rate": "recording", "hot": "alerting"}
            hot = next(r for r in grp["rules"] if r["name"] == "hot")
            assert hot["state"] == "firing"
            docs.append(rules_doc(out))
            code, out = _get(svc.port, "/api/v1/alerts")
            assert code == 200
            assert out["data"]["alerts"][0]["labels"]["alertname"] == "hot"
            docs.append(out)
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              op="status")
            docs.append(_ctrl_docs(out))
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              op="drop", db="db", group="g", name="hot")
            assert code == 200
            assert [r["name"] for r in out["groups"]["db.g"]["rules"]] == \
                ["job:rate"]
            docs.append(_ctrl_docs(out))
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              op="drop", db="db", group="g")
            assert code == 200 and out["groups"] == {}
            docs.append(out)
            return docs

        return _served(p, root, run)

    both(tmp_path, scenario)


@pytest.mark.parametrize("params", [
    {"op": "declare", "db": "db", "group": "g", "record": "r",
     "expr": "rate(m[5m"},
    {"op": "declare", "db": "nope", "group": "g"},
    {"op": "frobnicate"},
    {"op": "declare", "db": "db"},
    {"op": "declare", "db": "db", "group": "g", "interval_s": "x"},
    {"op": "drop", "db": "db", "group": "g"},
])
def test_ctrl_errors(tmp_path, params):
    def scenario(p, root):
        def run(svc, _engine):
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              **params)
            assert code == 400 and "error" in out
            return code, sorted(out)

        return _served(p, root, run)

    both(tmp_path, scenario)


def test_disabled_inertness(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_RULES", "0")

    def scenario(p, root):
        assert not p.rules.enabled_by_env()

        def run(svc, engine):
            assert engine.rules_hook is None
            code, out = _post(svc.port, "/debug/ctrl", mod="rules",
                              op="declare", db="db", group="g")
            assert code == 400 and "disabled" in out["error"]
            docs = [out]
            code, out = _post(svc.port, "/debug/ctrl", mod="rules")
            assert code == 200 and out["groups"] == {}
            docs.append(out)
            code, out = _get(svc.port, "/api/v1/rules")
            assert code == 200 and out["data"] == {"groups": []}
            code, out = _get(svc.port, "/api/v1/alerts")
            assert code == 200 and out["data"] == {"alerts": []}
            # writes run with the hook None
            engine.write_lines("db", f"m,host=a value=1 {BASE * NS}")
            assert engine.rules_hook is None
            return docs

        return _served(p, root, run)

    both(tmp_path, scenario)


# -- configuration and persistence ---------------------------------------------

def test_groups_reload_after_restart(tmp_path):
    def scenario(p, root):
        def run(e):
            mgr = p.mgr(e)
            mgr.add_rule("db", "g",
                         p.rule("r", "rate(http_requests_total[60s])"),
                         interval_s=7, lateness_s=2)
            mgr.close()
            mgr2 = p.mgr(e)
            try:
                g = mgr2.groups_for("db")[0]
                assert g.name == "g" and g.interval_s == 7
                assert g.lateness_s == 2
                assert [r.name for r in g.rules] == ["r"]
                assert g.rules[0].compiled.tiled
                return status_of(mgr2)
            finally:
                mgr2.close()

        return with_engine(p, root, run), state_files(root)

    both(tmp_path, scenario)


def test_drop_database_clears_state(tmp_path):
    def scenario(p, root):
        def run(e):
            mgr = p.mgr(e)
            try:
                mgr.add_rule("db", "g",
                             p.rule("r", "rate(http_requests_total[60s])"))
                assert (root / "rules" / "db" / "g.json").exists()
                e.drop_database("db")
                assert mgr.groups_for("db") == []
                assert not (root / "rules" / "db").exists()
                e.create_database("db")
                assert mgr.groups_for("db") == []  # no inherited watermark
            finally:
                mgr.close()

        with_engine(p, root, run)
        # without a manager the directory goes too
        e = p.engine(root)
        try:
            mgr = p.mgr(e)
            mgr.add_rule("db", "g2",
                         p.rule("r", "rate(http_requests_total[60s])"))
            mgr.close()
            assert e.rules_hook is None
            e.drop_database("db")
            return sorted(str(x.relative_to(root))
                          for x in (root / "rules").rglob("*"))
        finally:
            e.close()

    both(tmp_path, scenario)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_state_reopens_in_the_other_package(tmp_path, writer, reader):
    """A root whose rule state one package wrote reopens in the other:
    the same groups, watermark and alerts, and the next tick gives the
    answers the writer's next tick gives."""
    root = tmp_path / "root"
    twin = tmp_path / "twin"

    def first(root_):
        e = writer.engine(root_)
        e.create_database("db")
        rng = np.random.default_rng(61)
        mgr = _alerting(writer, e)
        mgr.add_rule("db", "g", writer.rule(
            "rec", "increase(http_requests_total[60s])"))
        write_counter(e, rng, n=120)
        mgr.tick(int((BASE + 230) * NS))
        mgr.close()
        e.close()

    first(root)
    first(twin)
    outs = []
    for p, r in ((reader, root), (writer, twin)):
        e = p.engine(r)
        mgr = p.mgr(e)
        try:
            st0 = status_of(mgr)
            mgr.tick(int((BASE + 260) * NS))
            outs.append((st0, results_of(mgr.groups_for("db")[0]),
                         status_of(mgr), mgr.alerts_api()))
        finally:
            mgr.close()
            e.close()
    same(outs[0], outs[1])
    assert state_files(root) == state_files(twin)


# -- the tile partials ------------------------------------------------------------

PARTIAL_FUNCS = sorted(jprom.PARTIAL_RATE_FUNCS | jprom.PARTIAL_OVER_TIME
                       | jprom.PARTIAL_PAIR_FUNCS)


def test_partial_sets_and_fields():
    assert tprom.TILE_PARTIAL_FIELDS == jprom.TILE_PARTIAL_FIELDS
    assert tprom.PARTIAL_RATE_FUNCS == jprom.PARTIAL_RATE_FUNCS
    assert tprom.PARTIAL_OVER_TIME == jprom.PARTIAL_OVER_TIME
    assert tprom.PARTIAL_PAIR_FUNCS == jprom.PARTIAL_PAIR_FUNCS
    for s in (0, 1, 5):
        a, b = tprom.empty_tile_partials(s), jprom.empty_tile_partials(s)
        assert list(a) == list(b)
        for f in a:
            assert a[f].dtype == np.float64
            assert a[f].tobytes() == b[f].tobytes()


def _bits(d: dict) -> dict:
    return {k: v.tobytes() for k, v in d.items()}


@st.composite
def runs(draw):
    """Run-encoded samples: per-series lengths (empty series too),
    ascending ms times (gaps, one sample, many in one tile), values with
    counter resets and NaN."""
    n_series = draw(st.integers(1, 4))
    lens, t_all, v_all = [], [], []
    for _ in range(n_series):
        n = draw(st.integers(0, 12))
        gaps = draw(st.lists(st.integers(1, 40_000), min_size=n,
                             max_size=n))
        t = 1_000_000 + np.cumsum(np.asarray(gaps, np.int64))
        vals = draw(st.lists(st.one_of(
            st.floats(-1e6, 1e6, allow_nan=False),
            st.just(float("nan")), st.just(0.0)), min_size=n, max_size=n))
        lens.append(n)
        t_all.append(t)
        v_all.append(np.asarray(vals, np.float64))
    return (np.concatenate(t_all) if t_all else np.empty(0, np.int64),
            np.concatenate(v_all) if v_all else np.empty(0),
            np.asarray(lens, np.int64))


@settings(max_examples=60, deadline=None)
@given(runs(), st.sampled_from([1_000, 15_000, 60_000]),
       st.integers(0, 3), st.integers(1, 30))
def test_fold_merge_answer_equal_the_reference(data, g_ms, lo_off, span):
    t_ms, v, lens = data
    lo = 1_000_000 // g_ms + lo_off - 1
    hi = lo + span
    got = tprom.fold_tile_partials(t_ms, v, lens, 0, g_ms, lo, hi)
    want = jprom.fold_tile_partials(t_ms, v, lens, 0, g_ms, lo, hi)
    assert sorted(got) == sorted(want)
    for t in want:
        assert _bits(got[t]) == _bits(want[t])
    S = len(lens)
    tiles = [want.get(t) for t in range(lo, hi)]
    m_got = tprom.merge_tile_partials([got.get(t) for t in range(lo, hi)], S)
    m_want = jprom.merge_tile_partials(tiles, S)
    assert _bits(m_got) == _bits(m_want)
    ws, we = lo * g_ms, hi * g_ms
    for func in PARTIAL_FUNCS:
        with np.errstate(all="ignore"):
            a, av = tprom.partials_answer(m_got, func, ws, we)
            b, bv = jprom.partials_answer(m_want, func, ws, we)
        assert np.asarray(av).tobytes() == np.asarray(bv).tobytes(), func
        assert np.asarray(a, np.float64).tobytes() == \
            np.asarray(b, np.float64).tobytes(), func


@pytest.mark.parametrize("case", ["empty", "single", "reset", "nan"])
def test_partials_edge_cases(case):
    t = np.array([1_010_000, 1_020_000, 1_030_000, 1_075_000], np.int64)
    v = np.array([5.0, 9.0, 2.0, 4.0])
    lens = np.array([4], np.int64)
    if case == "empty":
        t, v, lens = t[:0], v[:0], np.array([0, 0], np.int64)
    elif case == "single":
        t, v, lens = t[:1], v[:1], np.array([1], np.int64)
    elif case == "nan":
        v = np.array([5.0, np.nan, 2.0, np.nan])
    got = tprom.fold_tile_partials(t, v, lens, 0, 60_000, 16, 19)
    want = jprom.fold_tile_partials(t, v, lens, 0, 60_000, 16, 19)
    assert sorted(got) == sorted(want)
    if case == "empty":
        assert got == {}
    for k in want:
        assert _bits(got[k]) == _bits(want[k])
    S = len(lens)
    m = tprom.merge_tile_partials([got.get(k) for k in range(16, 19)], S)
    mw = jprom.merge_tile_partials([want.get(k) for k in range(16, 19)], S)
    assert _bits(m) == _bits(mw)
    if case == "reset":
        assert m["resets"][0] == 1.0 and m["drop"][0] == 9.0
    for func in PARTIAL_FUNCS:
        with np.errstate(all="ignore"):
            a, av = tprom.partials_answer(m, func, 960_000, 1_140_000)
            b, bv = jprom.partials_answer(mw, func, 960_000, 1_140_000)
        assert np.asarray(av).tobytes() == np.asarray(bv).tobytes()
        assert np.asarray(a, np.float64).tobytes() == \
            np.asarray(b, np.float64).tobytes()
    with pytest.raises(ValueError):
        tprom.partials_answer(m, "quantile", 0, 1)
