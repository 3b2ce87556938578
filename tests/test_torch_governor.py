"""The port's resource governor (utils/governor.py) and its hooks,
against the JAX package, on the CPU.

The cases of the reference's tests/test_governor.py run on both
packages' process-wide governors, engines, executors and HTTP services
(the port's ``Engine(device="cpu")``), each held to the reference test's
own checks, with the outcomes compared where they are deterministic:
the ledger (the engine's memtable and WAL backlog across a flush, scan
reservations, the query path's reservation), admission (priority and
FIFO order, queue-full and deadline sheds, reentrancy), /query, the
PromQL query routes and remote read answering 503 with Retry-After,
the overdraft kill as a statement error, /write's 429 with the
reference's hysteresis, background throttling (pause, anti-starvation,
stop, IO alarm, the governed service's background class), the
pass-through (a disabled governor is inert, and answers are
bit-identical with it on and off), /debug/vars, /debug/queries and
/debug/ctrl?mod=governor, the shed-burst hook (with the sherlock
service's dump subscribed to it: the governor's ledger, the slow log
and the thread stacks on disk), and the quick overload soak against the
port's server. The cluster surfaces (/internal/*) are ROADMAP A8's, so
their cases are not here.

Both governors are process globals: the ``governed`` fixture configures
both and restores their configuration and state after each test.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttp
from opengemini_tpu.services.compaction import CompactionService as JCompact
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import failpoint as jfp
from opengemini_tpu.utils import governor as jgov
from opengemini_tpu.utils.querytracker import GLOBAL as JTRACKER
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttp
from opengemini_tpu_torch.services.compaction import (
    CompactionService as TCompact,
)
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils import failpoint as tfp
from opengemini_tpu_torch.utils import governor as tgov
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TTRACKER

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import loadgen  # noqa: E402

torch.set_num_threads(1)

GOVERNOR_SITES = (
    "governor-admit", "governor-queue", "governor-shed",
    "governor-overdraft-kill", "governor-backpressure-on",
    "governor-backpressure-off",
)


class Pkg:
    def __init__(self, name, gov_mod, fp, engine_cls, executor_cls,
                 http_cls, compact_cls, tracker, kw):
        self.name = name
        self.gov_mod = gov_mod
        self.gov = gov_mod.GOVERNOR
        self.fp = fp
        self.engine_cls = engine_cls
        self.executor_cls = executor_cls
        self.http_cls = http_cls
        self.compact_cls = compact_cls
        self.tracker = tracker
        self.kw = kw

    def engine(self, root, **kw):
        e = self.engine_cls(str(root), **self.kw, **kw)
        e.create_database("db")
        return e


JAX = Pkg("jax", jgov, jfp, JEngine, JExecutor, JHttp, JCompact, JTRACKER,
          {})
PORT = Pkg("torch", tgov, tfp, TEngine, TExecutor, THttp, TCompact,
           TTRACKER, {"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture
def governed():
    """Both governors on for one test, pass-through restored after; every
    governor failpoint site armed "off" (count only). Each governor's byte
    providers are set aside for the test and put back after it, so its
    ledger holds only what the test registers: engines and caches that
    other tests left open in the process do not count toward the test's
    budget or backlog. Yields the names that were registered before."""
    prev = [p.gov.config() for p in PKGS]
    providers = []
    for p in PKGS:
        with p.gov._lock:
            providers.append(p.gov._components)
            p.gov._components = {}
    for p in PKGS:
        p.gov.reset()
        p.gov.configure(budget_mb=64, max_concurrent=2, queue=4,
                        timeout_ms=2000, hiwat_pct=85, lowat_pct=60,
                        overdraft_pct=150, bg_pause_pct=50, bp_cache_ms=0)
        for site in GOVERNOR_SITES:
            p.fp.enable(site, "off")
    yield {p.name: sorted(comps) for p, comps in zip(PKGS, providers)}
    for p, cfg, comps in zip(PKGS, prev, providers):
        for site in GOVERNOR_SITES:
            p.fp.disable(site)
        p.gov.configure(**cfg)
        p.gov.reset()
        with p.gov._lock:
            p.gov._components = comps


@pytest.fixture
def engines(tmp_path):
    out = {p.name: p.engine(tmp_path / p.name) for p in PKGS}
    yield out
    for e in out.values():
        e.close()


def _hold_slot(gov, n=1):
    """Occupy n admission slots from helper threads (admission is
    reentrant per thread). Returns a release callable."""
    release_ev = threading.Event()
    ready = threading.Barrier(n + 1)

    def holder():
        tok = gov.admit()
        ready.wait(5)
        release_ev.wait(10)
        tok.release()

    threads = [threading.Thread(target=holder, daemon=True)
               for _ in range(n)]
    for t in threads:
        t.start()
    ready.wait(5)

    def release():
        release_ev.set()
        for t in threads:
            t.join(timeout=5)

    return release


def _served(p, engine, body):
    svc = p.http_cls(engine, "127.0.0.1", 0)
    svc.start()
    try:
        return body(svc)
    finally:
        svc.stop()


def _request(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _lines(n, step=100):
    return "\n".join(f"m,host=h{i % 4} v={i} {1000 + i * step}"
                     for i in range(n))


# -- ledger ----------------------------------------------------------------


def test_ledger_memtable_register_release_across_flush(governed, engines):
    out = []
    for p in PKGS:
        e = engines[p.name]
        base = p.gov.ledger()["memtable"]
        e.write_lines("db", _lines(500))
        after_write = p.gov.ledger()["memtable"]
        assert after_write > base
        assert after_write - base == e.mem_backlog_bytes()
        e.flush_all()
        assert p.gov.ledger()["memtable"] == base
        for sh in e.all_shards():
            sh.compact()
        assert p.gov.ledger()["memtable"] == base
        out.append(sorted(p.gov.ledger()))
    # the same ledger components in both packages, those the process
    # registered before the test too (caches and pools, at import)
    assert out[1] == out[0]
    assert [n for n in governed["torch"] if n != "memtable"] == \
        [n for n in governed["jax"] if n != "memtable"]


def test_ledger_reservation_register_release(governed):
    for p in PKGS:
        gov = p.gov
        before = gov.ledger()["reserved"]
        with gov.scan_reservation(qid=None, est_bytes=1 << 20):
            during = gov.ledger()["reserved"]
            assert during == before + (1 << 20)
            with gov.scan_reservation(qid=None, est_bytes=1 << 10):
                assert gov.ledger()["reserved"] == during + (1 << 10)
            assert gov.ledger()["reserved"] == during
        assert gov.ledger()["reserved"] == before


def test_ledger_query_path_reserves(governed, engines):
    seen_all = []
    answers = []
    for p in PKGS:
        e = engines[p.name]
        e.write_lines("db", _lines(2000))
        e.flush_all()
        ex = p.executor_cls(e)
        seen = []
        orig = p.gov.scan_reservation

        def spy(qid, est_bytes, orig=orig, seen=seen):
            seen.append((qid, est_bytes))
            return orig(qid, est_bytes)

        p.gov.scan_reservation = spy
        try:
            res = ex.execute(
                "SELECT mean(v) FROM m WHERE time >= 0 GROUP BY time(10u)",
                db="db")
        finally:
            del p.gov.scan_reservation
        assert "series" in res["results"][0]
        assert seen and seen[0][1] > 0
        assert seen[0][0] is not None
        assert p.gov.ledger()["reserved"] == 0
        seen_all.append([s[1] for s in seen])
        answers.append(res)
    # the same chunk-metadata estimate and the same answer
    assert seen_all[1] == seen_all[0]
    assert answers[1] == answers[0]


# -- admission -------------------------------------------------------------


def test_admission_fifo_order_and_priority(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=8)
        release = _hold_slot(gov)
        order = []

        def waiter(name, kind, gov=gov, order=order):
            tok = gov.admit(kind=kind)
            order.append(name)
            time.sleep(0.01)
            tok.release()

        threads = []
        for i, (name, kind) in enumerate((("bg1", "background"),
                                          ("i1", "interactive"),
                                          ("i2", "interactive"))):
            t = threading.Thread(target=waiter, args=(name, kind),
                                 daemon=True)
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 5
            while (len(gov.admission_snapshot()["queue"]) < i + 1
                   and time.monotonic() < deadline):
                time.sleep(0.005)
        release()
        for t in threads:
            t.join(timeout=5)
        assert order == ["i1", "i2", "bg1"], p.name


def test_admission_queue_full_sheds_with_retry_after(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=1, timeout_ms=3000)
        release = _hold_slot(gov)
        parked = threading.Thread(target=lambda gov=gov: gov.admit().release(),
                                  daemon=True)
        parked.start()
        for _ in range(200):
            if gov.admission_snapshot()["queue"]:
                break
            time.sleep(0.01)
        h0 = p.fp.hits("governor-shed")
        with pytest.raises(p.gov_mod.AdmissionRejected) as ei:
            gov.admit()
        assert ei.value.retry_after_s >= 1
        assert str(ei.value) == "query shed: admission queue full"
        assert p.fp.hits("governor-shed") == h0 + 1
        assert gov.gauges()["sheds_queue_full"] == 1
        release()
        parked.join(timeout=5)


def test_admission_deadline_sheds(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=4, timeout_ms=80)
        release = _hold_slot(gov)
        t0 = time.monotonic()
        with pytest.raises(p.gov_mod.AdmissionRejected) as ei:
            gov.admit()
        waited = time.monotonic() - t0
        assert 0.05 <= waited < 2.0
        assert "admission wait exceeded 80ms" in str(ei.value)
        assert gov.gauges()["sheds_timeout"] == 1
        release()


def test_admission_reentrant_same_thread(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=0)
        outer = gov.admit()
        inner = gov.admit()
        inner.release()
        outer.release()
        assert gov.gauges()["active_interactive"] == 0


def _shed_503(governed_pkg, engine, url_of, data=None, method=None):
    """Saturate the one slot, hit the surface (503 + Retry-After), then
    release and hit it again (200). Returns both answers."""
    p = governed_pkg

    def body(svc):
        p.gov.configure(max_concurrent=1, queue=0, timeout_ms=100)
        release = _hold_slot(p.gov)
        url = url_of(svc.port)
        try:
            status, headers, raw = _request(url, data, method)
        finally:
            release()
        assert status == 503, (p.name, url)
        assert int(headers["Retry-After"]) >= 1
        status2, _h, raw2 = _request(url, data, method)
        assert status2 == 200, (p.name, url)
        return raw, raw2

    return _served(p, engine, body)


def test_http_query_shed_maps_to_503(governed, engines):
    def url(port):
        return (f"http://127.0.0.1:{port}/query?"
                + urllib.parse.urlencode({"db": "db", "q": "SHOW DATABASES"}))

    got = []
    for p in PKGS:
        shed, ok = _shed_503(p, engines[p.name], url)
        assert "shed" in json.loads(shed)["error"]
        got.append((json.loads(shed), json.loads(ok)))
    assert got[1] == got[0]


def test_prom_query_surface_is_governed(governed, engines):
    got = []
    for path, params in (("/api/v1/query", {"query": "up"}),
                         ("/api/v1/query_range",
                          {"query": "up", "start": "1", "end": "10",
                           "step": "1"})):
        for p in PKGS:
            def url(port, path=path, params=params):
                return (f"http://127.0.0.1:{port}{path}?"
                        + urllib.parse.urlencode({"db": "db", **params}))

            shed, ok = _shed_503(p, engines[p.name], url)
            shed, ok = json.loads(shed), json.loads(ok)
            assert shed["errorType"] == "unavailable"
            assert ok["status"] == "success"
            got.append((p.name, path, shed, ok))
    assert [g[2:] for g in got if g[0] == "torch"] == \
        [g[2:] for g in got if g[0] == "jax"]


def test_remote_read_surface_is_governed(governed, engines):
    """An empty ReadRequest decodes to no queries, but the surface still
    takes (and sheds on) an admission slot."""
    got = []
    for p in PKGS:
        def url(port):
            return f"http://127.0.0.1:{port}/api/v1/prom/read?db=db"

        shed, ok = _shed_503(p, engines[p.name], url, data=b"",
                             method="POST")
        got.append((json.loads(shed), ok))
    assert got[1] == got[0]


def test_overdraft_kill_is_clean_query_error(governed, engines):
    errors = []
    for p in PKGS:
        e = engines[p.name]
        e.write_lines("db", _lines(2000))
        e.flush_all()
        ex = p.executor_cls(e)
        p.gov.configure(budget_mb=1, overdraft_pct=100)
        big = [64 << 20]

        def load_fn(big=big):
            return big[0]

        p.gov.register_component("testload", load_fn)
        h0 = p.fp.hits("governor-overdraft-kill")
        try:
            res = ex.execute(
                "SELECT mean(v) FROM m WHERE time >= 0 GROUP BY time(10u)",
                db="db")
            assert "killed" in res["results"][0]["error"]
            assert p.fp.hits("governor-overdraft-kill") == h0 + 1
            assert p.gov.gauges()["kills"] == 1
            big[0] = 0
            ok = ex.execute("SELECT mean(v) FROM m", db="db")
            assert "series" in ok["results"][0]
        finally:
            p.gov.unregister_component("testload", load_fn)
        assert "testload" not in p.gov.ledger()
        assert p.tracker.snapshot() == []
        errors.append((res["results"][0]["error"].split(" ")[0], ok))
    assert errors[1] == errors[0]


# -- write backpressure ----------------------------------------------------


def test_write_backpressure_hysteresis_and_429(governed, engines):
    trace = []
    for p in PKGS:
        fake = [0]
        p.gov.register_component("memtable", lambda fake=fake: fake[0])
        fn = p.gov._components["memtable"][-1]

        def body(svc, p=p, fake=fake):
            p.gov.configure(budget_mb=10, hiwat_pct=80, lowat_pct=40)
            steps = []

            def write(path="/write?db=db", data=b"m v=1 1000\n"):
                status, headers, raw = _request(
                    f"http://127.0.0.1:{svc.port}{path}", data, "POST")
                return status, headers, raw

            steps.append(write()[0])
            fake[0] = 9 << 20
            h_on = p.fp.hits("governor-backpressure-on")
            status, headers, raw = write()
            assert status == 429
            assert int(headers["Retry-After"]) >= 1
            assert p.fp.hits("governor-backpressure-on") == h_on + 1
            steps.append((status, json.loads(raw)))
            # every single-node write route sheds alike
            for path in ("/api/v2/write?bucket=db",
                         "/api/v1/prom/write?db=db",
                         "/api/v1/otlp/metrics?db=db"):
                steps.append((path, write(path)[0]))
            fake[0] = 6 << 20
            steps.append(write()[0])
            fake[0] = 3 << 20
            h_off = p.fp.hits("governor-backpressure-off")
            steps.append(write()[0])
            assert p.fp.hits("governor-backpressure-off") == h_off + 1
            assert p.gov.gauges()["bp_active"] == 0
            return steps

        try:
            steps = _served(p, engines[p.name], body)
        finally:
            p.gov.unregister_component("memtable", fn)
        assert steps[0] == 204 and steps[-2] == 429 and steps[-1] == 204
        trace.append(steps)
    assert trace[1] == trace[0]


# -- background throttling --------------------------------------------------


def test_background_pauses_under_interactive_load(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=2, bg_pause_pct=50)
        assert gov.background_allowed()
        release = _hold_slot(gov)
        assert not gov.background_allowed()
        got = []

        def bg(gov=gov, got=got):
            tok = gov.acquire_background("compaction", timeout_s=5.0)
            got.append(tok)
            if tok is not None:
                tok.release()

        t = threading.Thread(target=bg, daemon=True)
        t.start()
        time.sleep(0.15)
        assert not got
        release()
        t.join(timeout=5)
        assert got and got[0] is not None
        assert gov.gauges()["bg_pauses"] >= 1


def test_background_pause_is_bounded_anti_starvation(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=2, bg_pause_pct=50, bg_max_pause_s=0.2)
        release = _hold_slot(gov)
        try:
            t0 = time.monotonic()
            tok = gov.acquire_background("compaction")
            waited = time.monotonic() - t0
            assert tok is not None
            tok.release()
            assert 0.15 <= waited < 5.0
            assert gov.gauges()["bg_forced"] == 1
            assert gov.gauges()["bg_pauses"] >= 1
        finally:
            release()


def test_background_stop_event_aborts_pause(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, bg_pause_pct=50)
        release = _hold_slot(gov)
        stop = threading.Event()
        out = []

        def bg(gov=gov, out=out, stop=stop):
            out.append(gov.acquire_background("compaction", stop=stop))

        t = threading.Thread(target=bg, daemon=True)
        t.start()
        time.sleep(0.1)
        stop.set()
        t.join(timeout=5)
        assert out == [None]
        release()


def test_io_alarm_pauses_background(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=8, bg_pause_pct=99)
        assert gov.background_allowed()
        gov.note_io_alarm()
        assert not gov.background_allowed()
        gov._io_alarm_until = 0.0
        assert gov.background_allowed()


def test_governed_service_marks_thread_background(governed, engines):
    for p in PKGS:
        svc = p.compact_cls(engines[p.name], interval_s=3600)
        assert svc.governed
        kinds = []
        orig_handle = svc.handle
        svc.handle = (lambda gov=p.gov, kinds=kinds, orig=orig_handle:
                      kinds.append(gov.current_kind()) or orig())
        svc._governed_tick()
        assert kinds == ["background"]
        assert p.gov.current_kind() == "interactive"


def test_governed_service_thread_pauses_under_load(governed, engines):
    """A started governed service does not tick while interactive load
    holds the gate, ticks once it drains, and stop() joins it."""
    e = engines["torch"]
    PORT.gov.configure(max_concurrent=2, bg_pause_pct=50,
                       bg_max_pause_s=0)
    release = _hold_slot(PORT.gov)
    svc = PORT.compact_cls(e, interval_s=0.02)
    ticks = []
    svc.handle = lambda: ticks.append(PORT.gov.current_kind())
    svc.start()
    try:
        time.sleep(0.2)
        assert ticks == []  # paused behind the interactive query
        release()
        for _ in range(200):
            if ticks:
                break
            time.sleep(0.01)
        assert ticks and ticks[0] == "background"
    finally:
        release()
        svc.stop()
    assert svc._thread is None


# -- pass-through ----------------------------------------------------------


def test_passthrough_disabled_governor_is_inert(engines):
    for p in PKGS:
        gov = p.gov_mod.ResourceGovernor()
        assert not gov.enabled()
        toks = [gov.admit() for _ in range(100)]
        for t in toks:
            t.release()
        assert gov.gauges() == {}
        assert gov.write_backpressure() is None
        assert gov.background_allowed()
        tok = gov.acquire_background("compaction")
        assert tok is not None
        tok.release()
        with gov.scan_reservation(qid=1, est_bytes=1 << 40):
            pass
        assert gov.admission_snapshot()["enabled"] is False


def test_passthrough_query_results_bit_identical(engines):
    q = "SELECT mean(v), max(v), count(v) FROM m GROUP BY time(20u), host"
    got = []
    for p in PKGS:
        e = engines[p.name]
        e.write_lines("db", _lines(1000))
        e.flush_all()
        ex = p.executor_cls(e)
        assert not p.gov.enabled()
        counters0 = p.gov.gauges()
        off = ex.execute(q, db="db")
        assert p.gov.gauges() == counters0 == {}
        prev = p.gov.config()
        try:
            p.gov.configure(budget_mb=256)
            on = ex.execute(q, db="db")
            assert p.gov.gauges()["admitted"] == 1
        finally:
            p.gov.configure(**prev)
            p.gov.reset()
        assert json.dumps(off, sort_keys=True) == \
            json.dumps(on, sort_keys=True)
        got.append(off)
    assert got[1] == got[0]


def test_passthrough_debug_vars_have_no_governor_section(engines):
    for p in PKGS:
        def body(svc):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{svc.port}/debug/vars") as r:
                return json.loads(r.read())

        assert "governor" not in _served(p, engines[p.name], body)


def test_debug_vars_and_queries_expose_governor(governed, engines):
    docs = []
    for p in PKGS:
        def body(svc):
            base = f"http://127.0.0.1:{svc.port}"
            with urllib.request.urlopen(base + "/debug/vars") as r:
                doc = json.loads(r.read())
            assert "governor" in doc
            for key in ("budget_bytes", "ledger_memtable_bytes",
                        "ledger_total_bytes", "queue_depth", "admitted"):
                assert key in doc["governor"]
            with urllib.request.urlopen(base + "/debug/queries") as r:
                q = json.loads(r.read())
            assert q["admission"]["enabled"] is True
            assert q["admission"]["max_concurrent"] == 2
            status, _h, raw = _request(
                base + "/debug/ctrl?mod=governor&max_concurrent=7&queue=3",
                b"", "POST")
            cfg = json.loads(raw)["governor"]["config"]
            assert cfg["max_concurrent"] == 7 and cfg["queue"] == 3
            status, _h, raw = _request(
                base + "/debug/ctrl?mod=governor&bg_max_pause_s=2.5",
                b"", "POST")
            cfg = json.loads(raw)["governor"]["config"]
            assert cfg["bg_max_pause_s"] == 2.5
            bad = _request(base + "/debug/ctrl?mod=governor&queue=x",
                           b"", "POST")
            assert bad[0] == 400
            return (sorted(doc["governor"]), q["admission"]["max_concurrent"],
                    cfg, json.loads(bad[2]))

        docs.append(_served(p, engines[p.name], body))
    assert docs[1] == docs[0]


def test_shed_burst_triggers_diagnostic_hook(governed):
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=0, timeout_ms=50)
        prev_burst = gov._burst_n
        gov._burst_n = 5
        fired = []
        gov.set_diagnostic_hook(lambda reason, fired=fired:
                                fired.append(reason))
        try:
            release = _hold_slot(gov)
            for _ in range(8):
                t = threading.Thread(
                    target=lambda gov=gov, p=p: pytest.raises(
                        p.gov_mod.AdmissionRejected, gov.admit),
                    daemon=True)
                t.start()
                t.join(timeout=5)
            release()
            for _ in range(100):
                if fired:
                    break
                time.sleep(0.01)
            assert fired and "burst" in fired[0]
        finally:
            gov.set_diagnostic_hook(None)
            gov._burst_n = prev_burst


def test_overload_soak_quick(tmp_path):
    """The reference's tier-1 soak slice against the port's server: sheds
    carry Retry-After, acked writes are durable and readable exactly
    once, and admitted answers equal the ungoverned ones."""
    gov = PORT.gov
    eng = TEngine(str(tmp_path / "soak"), device="cpu",
                  flush_threshold_bytes=1 << 20)
    eng.create_database("load")
    svc = THttp(eng, "127.0.0.1", 0)
    svc.start()
    prev = gov.config()
    try:
        gov.configure(budget_mb=8, max_concurrent=2, queue=4,
                      timeout_ms=200, hiwat_pct=10, lowat_pct=4)
        out = loadgen.run_load(
            "127.0.0.1", svc.port, "load", clients=8, duration_s=2.0,
            write_frac=0.6, batch_rows=100, timeout_s=30.0)
        assert out["attempts"] > 0
        assert out["stuck_clients"] == 0
        assert out["errors"] == 0
        assert out["retry_after_seen"] == out["sheds_429"] + out["sheds_503"]
        gov.configure(budget_mb=0)
        ex = TExecutor(eng)
        res = ex.execute("SELECT count(v) FROM loadgen", db="load")
        series = res["results"][0].get("series", [])
        counted = series[0]["values"][0][1] if series else 0
        assert counted == out["acked_rows"]
        q = "SELECT count(v), max(v) FROM loadgen GROUP BY client"
        ungoverned = ex.execute(q, db="load")
        gov.configure(budget_mb=64, max_concurrent=2)
        governed_res = ex.execute(q, db="load")
        assert json.dumps(ungoverned, sort_keys=True) == \
            json.dumps(governed_res, sort_keys=True)
    finally:
        gov.configure(**prev)
        gov.reset()
        svc.stop()
        eng.close()


# -- the sherlock dump ---------------------------------------------------------

def _sherlock(p):
    if p is JAX:
        from opengemini_tpu.services import sherlock
    else:
        from opengemini_tpu_torch.services import sherlock
    return sherlock


def _stats(p):
    if p is JAX:
        from opengemini_tpu.utils.stats import GLOBAL
    else:
        from opengemini_tpu_torch.utils.stats import GLOBAL
    return GLOBAL


def _dump_sections(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("== ")]


def test_sherlock_dump_carries_governor_ledger(governed, engines):
    sections = []
    for p in PKGS:
        svc = _sherlock(p).SherlockService(engines[p.name], cooldown_s=0.0)
        try:
            before = _stats(p).counters("sherlock").get("sherlock_dumps", 0)
            path = svc.diagnose("governor shed/kill burst (test)")
            assert path is not None
            with open(path, encoding="utf-8") as f:
                text = f.read()
            assert "== governor ==" in text
            assert "ledger" in text
            assert "thread stacks" in text
            assert text.startswith("sherlock dump — trigger: governor "
                                   "shed/kill burst (test)\n")
            assert _stats(p).counters("sherlock")["sherlock_dumps"] \
                == before + 1
            sections.append(_dump_sections(text))
        finally:
            svc.stop()  # detaches the governor hook
    assert sections[1] == sections[0]


def test_shed_burst_fires_the_sherlock_dump(governed, engines):
    """A started sherlock service subscribes its dump to the governor's
    burst hook: a burst of sheds writes one dump, and a stopped service
    is detached again."""
    for p in PKGS:
        gov = p.gov
        gov.configure(max_concurrent=1, queue=0, timeout_ms=50)
        prev_burst = gov._burst_n
        gov._burst_n = 5
        svc = _sherlock(p).SherlockService(engines[p.name], interval_s=3600,
                                           cooldown_s=0.0)
        svc.start()
        try:
            assert gov._hook == svc.diagnose
            release = _hold_slot(gov)
            for _ in range(8):
                t = threading.Thread(
                    target=lambda gov=gov, p=p: pytest.raises(
                        p.gov_mod.AdmissionRejected, gov.admit),
                    daemon=True)
                t.start()
                t.join(timeout=5)
            release()
            for _ in range(200):
                if svc.dumps:
                    break
                time.sleep(0.01)
            assert svc.dumps >= 1
            out = os.path.join(engines[p.name].root, "sherlock")
            [name, *_more] = sorted(os.listdir(out))
            with open(os.path.join(out, name), encoding="utf-8") as f:
                assert "governor shed/kill burst" in f.readline()
        finally:
            svc.stop()
            gov._burst_n = prev_burst
        assert gov._hook is None


def test_sherlock_dump_embeds_the_slow_log(governed, engines):
    from opengemini_tpu.utils import slowlog as jslow
    from opengemini_tpu_torch.utils import slowlog as tslow

    for p in PKGS:
        slow = jslow.GLOBAL if p is JAX else tslow.GLOBAL
        prev = slow.snapshot()
        slow.configure(slow_ms=0.0)
        try:
            e = engines[p.name]
            e.write_lines("db", "m v=1 1700000000000000000")
            p.executor_cls(e).execute("SELECT count(v) FROM m", db="db")
            assert slow.snapshot()["records"]
            svc = _sherlock(p).SherlockService(e, cooldown_s=0.0)
            with open(svc.diagnose("test"), encoding="utf-8") as f:
                text = f.read()
            assert "== slow queries ==" in text
            assert "SELECT count(v) FROM m" in text
        finally:
            slow.configure(slow_ms=prev["threshold_ms"])
            slow.clear()
