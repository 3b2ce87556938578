"""The port's device observability (opengemini_tpu_torch/utils/devobs.py)
against the JAX package's, on the CPU.

The compile inventory and its tripwire, the device-memory ledger (with
the drop of an entry when its holder is collected), ``fetch_np``, the
transfer counters and per-site histograms, and the /debug/device
document, over both ``HttpService``s. The port defines a "compile" as a
site's first run at a (kernel, geometry); the tests of ``first_run``
hold it to that.

Key mapping of /debug/device (port <- reference): ``capabilities``
carries ``cuda_kernels`` (kernel 6's probe) where the reference carries
``pallas``, with the same {"supported", "reason"} shape; ``mesh``
answers as the reference's, from the port's own mesh runtime
(parallel/runtime.py), with and without a mesh set; ``devices`` rows carry the same keys, and the port's
``memory_stats`` are the caching allocator's figures (null on the CPU).
"""

import gc
import json
import os
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.parallel import distributed as jdist
from opengemini_tpu.parallel import runtime as jrt
from opengemini_tpu.query import offload as joff
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage import colcache as jcc
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import devobs as jdevobs
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.parallel import distributed as tdist
from opengemini_tpu_torch.parallel import runtime as trt
from opengemini_tpu_torch.query import offload as toff
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.storage import colcache as tcc
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils import devobs as tdevobs
from opengemini_tpu_torch.utils import stats as tstats
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

from test_observability import parse_prometheus_strict

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000
DEVOBS = (jdevobs, tdevobs)
OFFLOAD = (joff, toff)


@pytest.fixture(autouse=True)
def _devobs_state():
    """Both packages start disarmed with a clean ring, inventory and
    ledger, and with empty offload planners (a planner's kernel-wide
    samples would route a new geometry by walls, which differ between
    the packages); the process state is restored after."""
    prev = [d.enabled() for d in DEVOBS]
    for d, off in zip(DEVOBS, OFFLOAD):
        d.set_enabled(False)
        d.reset()
        d.LEDGER.clear()
        off.reset()
    yield
    for d, off, p in zip(DEVOBS, OFFLOAD, prev):
        d.set_enabled(p)
        d.reset()
        d.LEDGER.clear()
        off.reset()


def _ring(d):
    return [{k: v for k, v in e.items() if k != "uptime_s"}
            for e in d.recent_compiles()]


def _live_epoch(doc, epoch: int):
    """`doc` with every mesh epoch, each of which must be the package's
    live one, as "live": each package counts its own mesh assignments,
    and the other tests of a worker set the two meshes unequally often."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "mesh_epoch":
                assert v == epoch, (v, epoch)
                v = "live"
            out[k] = _live_epoch(v, epoch)
        return out
    if isinstance(doc, (list, tuple)):
        return [_live_epoch(v, epoch) for v in doc]
    return doc


# -- compile accounting and the tripwire ---------------------------------------


def test_inventory_ring_and_repeats_match():
    got = []
    for d, stats, rt in ((jdevobs, JSTATS, jrt), (tdevobs, TSTATS, trt)):
        c0 = stats.counters("device")
        d.note_compile("grid_basic", ((8, 4, 16), "float64"))
        d.note_compile("grid_basic", ((16, 4, 16), "float64"))
        d.note_compile("grid_basic", ((8, 4, 16), "float64"))  # repeat
        d.note_use("grid_basic", ((8, 4, 16), "float64"))
        c1 = stats.counters("device")
        got.append(_live_epoch(
            (d.jit_inventory(), d.inventory(), _ring(d),
             {k: c1.get(k, 0) - c0.get(k, 0)
              for k in ("compiles_total", "compile_cache_misses",
                        "repeat_compiles_total")}), rt.mesh_epoch()))
    assert got[1] == got[0]
    inv = got[1][0]["grid_basic"]
    assert (inv["compiles"], inv["distinct_geometries"],
            inv["repeat_compiles"]) == (3, 2, 1)
    assert got[1][2][0].get("repeat") is True


def test_recompile_tripwire_matches():
    got = []
    for d in DEVOBS:
        seen = []
        d.note_compile("k", (1,))
        seen.append(d.compiles_since_warm())
        d.mark_warm()
        seen.append(d.compiles_since_warm())
        d.note_compile("k", (2,))
        seen += [d.compiles_since_warm(),
                 d.recent_compiles()[0].get("after_warm")]
        d.clear_warm()
        d.note_compile("k", (3,))
        seen.append(d.compiles_since_warm())
        got.append(seen)
    assert got[1] == got[0] == [0, 0, 1, True, 0]


def test_first_run_is_the_compile(monkeypatch):
    """A site's first run at a (kernel, geometry) is counted as its
    compile; later runs are not. Armed, the first run's wall lands on
    the inventory record, the ring, the compile-wall sum and the
    device_compile_seconds histogram; disarmed, walls stay 0."""
    monkeypatch.setattr(tdevobs, "_ran", set())
    c0 = TSTATS.counters("device").get("compiles_total", 0)
    for _ in range(3):
        with tdevobs.first_run("site_a", (4, "f8"), "cpu"):
            pass
    inv = tdevobs.inventory()["site_a"]
    assert inv["compiles"] == 1
    assert inv["geometries"][0]["wall_ms"] == 0.0  # disarmed
    assert TSTATS.counters("device")["compiles_total"] == c0 + 1
    with tdevobs.armed():
        with tdevobs.first_run("site_b", (5,), "cpu") as first:
            assert first
            torch.ones(1000).sum()
        with tdevobs.first_run("site_b", (5,), "cpu") as first:
            assert not first
    geo = tdevobs.inventory()["site_b"]["geometries"][0]
    assert geo["compiles"] == 1 and geo["wall_ms"] > 0
    assert tdevobs.recent_compiles()[0]["wall_ms"] > 0
    assert tdevobs.span_snapshot()["compile_wall_ms"] > 0
    fams = {(n, dict(lab).get("kernel")) for n, lab, _s in
            tstats.histograms_snapshot()}
    assert ("device_compile_seconds", "site_b") in fams
    assert tdevobs.has_run("site_b", (5,))


def test_builds_are_inventory_entries():
    tdevobs.note_build("build:grid_window", ("sm_90a",), 2.5)
    geo = tdevobs.inventory()["build:grid_window"]["geometries"][0]
    assert geo["compiles"] == 1 and geo["wall_ms"] == 2500.0
    # a build wall is not a first-run wall: the planner family never
    # matches it
    from opengemini_tpu_torch.query import offload

    assert offload._compile_estimate_s("grid_decode") == 0.0


def _grid_rows(hosts=13, points=517):
    return "\n".join(
        f"m,host=h{h} v={(h * 7 + i * 3) % 101}i "
        f"{(BASE // 60 * 60 + 10 * i) * NS}"
        for i in range(points) for h in range(hosts))


def test_sites_feed_inventory(tmp_path, monkeypatch):
    """A GROUP BY time() scan through the grid runs its compile sites:
    the inventory gains grid_ entries in both packages."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    monkeypatch.setattr(tdevobs, "_ran", set())
    from opengemini_tpu.models.grid import _grid_jit

    _grid_jit.cache_clear()
    q = ("SELECT mean(v), count(v), max(v) FROM m WHERE "
         f"time >= {BASE // 60 * 60 * NS} AND "
         f"time < {(BASE // 60 * 60 + 6000) * NS} GROUP BY time(1m)")
    for name, eng, ex_cls, d in (
            ("j", JEngine, JExecutor, jdevobs),
            ("t", lambda p: TEngine(p, device="cpu"), TExecutor, tdevobs)):
        e = eng(str(tmp_path / name))
        e.create_database("db")
        e.write_lines("db", _grid_rows())
        e.flush_all()
        ex_cls(e).execute(q, db="db")
        assert any(k.startswith("grid_") for k in d.jit_inventory()), \
            d.jit_inventory()
        e.close()


# -- the device-memory ledger ---------------------------------------------------


def test_ledger_register_update_drop_armed_only():
    got = []
    for d in DEVOBS:
        seen = [d.LEDGER.register("x", 100)]  # disarmed: None
        d.set_enabled(True)
        h = d.LEDGER.register("x", 100, mesh_epoch=None, label="a")
        seen.append(d.LEDGER.total_bytes())
        d.LEDGER.update(h, 250)
        seen.append(d.LEDGER.by_owner())
        seen.append(d.LEDGER.entries())
        d.LEDGER.drop(h)
        d.LEDGER.drop(h)
        d.LEDGER.update(h, 1)
        seen.append(d.LEDGER.total_bytes())
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][0] is None and got[1][1] == 100 and got[1][4] == 0
    assert got[1][2] == {"x": {"bytes": 250, "entries": 1,
                               "stale_epoch_entries": 0}}


def test_ledger_entry_drops_when_its_holder_is_collected():
    got = []
    for d in DEVOBS:
        d.set_enabled(True)

        class Holder:
            pass

        holder = Holder()
        d.LEDGER.register("anchored", 64, anchor=holder)
        before = d.LEDGER.by_owner()["anchored"]["entries"]
        del holder
        gc.collect()
        got.append((before, "anchored" in d.LEDGER.by_owner()))
    assert got[1] == got[0] == (1, False)


def test_ledger_gauges_ride_the_registry():
    tdevobs.set_enabled(True)
    h = tdevobs.LEDGER.register("colcache_device", 4096)
    sect = TSTATS.snapshot()["device"]
    assert sect["ledger_bytes"] >= 4096
    assert sect["ledger_colcache_device_bytes"] >= 4096
    tdevobs.LEDGER.drop(h)
    tdevobs.set_enabled(False)
    assert "ledger_bytes" not in TSTATS.snapshot().get("device", {})


def test_ledger_reconciles_with_the_colcache_device_tier(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    prev = tcc.GLOBAL.config()
    tcc.GLOBAL.clear()
    tcc.GLOBAL.configure(budget_mb=64, device=True)
    tdevobs.set_enabled(True)
    try:
        e = TEngine(str(tmp_path / "t"), device="cpu")
        e.create_database("db")
        e.write_lines("db", _grid_rows(hosts=80, points=120))
        e.flush_all()
        q = ("SELECT count(v), max(v) FROM m WHERE "
             f"time >= {BASE // 60 * 60 * NS} AND "
             f"time < {(BASE // 60 * 60 + 1200) * NS} GROUP BY time(1m)")
        TExecutor(e).execute(q, db="db")
        owners = tdevobs.LEDGER.by_owner()
        assert owners["colcache_device"]["entries"] >= 1
        assert (owners["colcache_device"]["bytes"]
                == tcc.GLOBAL.counters()["device_bytes"])
        tcc.GLOBAL.clear()
        assert "colcache_device" not in tdevobs.LEDGER.by_owner()
        e.close()
    finally:
        tcc.GLOBAL.configure(**prev)
        tcc.GLOBAL.clear()


# -- transfers -------------------------------------------------------------------


def _hist_rows(stats_mod, prefix):
    return sorted((n, lab, s["count"], s["sum_ns"])
                  for n, lab, s in stats_mod.histograms_snapshot()
                  if n.startswith(prefix))


def test_note_transfer_counts_and_histograms_match():
    from opengemini_tpu.utils import stats as jstats

    got = []
    for d, smod, stats in ((jdevobs, jstats, JSTATS),
                           (tdevobs, tstats, TSTATS)):
        c0 = stats.counters("device")
        h0 = _hist_rows(smod, "device_")
        d.note_transfer("h2d", "zz-test-site", 4096)  # disarmed
        with d.armed():
            d.note_transfer("h2d", "zz-test-site", 2048, 0.001)
            d.note_transfer("d2h", "zz-test-site", 100)
            d.note_transfer("h2d", "zz-test-site", 512, 0.002, mesh=True)
        c1 = stats.counters("device")
        h1 = [r for r in _hist_rows(smod, "device_") if r not in h0]
        got.append(({k: c1.get(k, 0) - c0.get(k, 0)
                     for k in ("h2d_bytes_total", "d2h_bytes_total")}, h1))
    assert got[1] == got[0]
    assert got[1][0] == {"h2d_bytes_total": 4096 + 2048 + 512,
                         "d2h_bytes_total": 100}
    names = {(n, dict(lab).get("mesh")) for n, lab, _c, _s in got[1][1]}
    assert ("device_h2d_bytes", None) in names
    assert ("device_h2d_seconds", "on") in names


def test_fetch_np_counts_device_to_host():
    t = torch.arange(10, dtype=torch.float64)
    c0 = TSTATS.counters("device").get("d2h_bytes_total", 0)
    a = tdevobs.fetch_np(t)
    assert isinstance(a, np.ndarray) and a.tolist() == list(range(10))
    assert TSTATS.counters("device")["d2h_bytes_total"] == c0 + 80
    # host arrays pass through uncounted
    b = tdevobs.fetch_np(np.ones(4))
    assert b.tolist() == [1.0] * 4
    assert TSTATS.counters("device")["d2h_bytes_total"] == c0 + 80
    with tdevobs.armed():
        tdevobs.fetch_np(t, site="zz-fetch")
    rows = {dict(lab).get("site"): s["count"]
            for n, lab, s in tstats.histograms_snapshot()
            if n == "device_d2h_seconds"}
    assert rows.get("zz-fetch") == 1


# -- the cold scan over both services -----------------------------------------------


def _req(port, method, path, body=b"", **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(
        url, data=body if method == "POST" else None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("X-Ogt-Errno")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("X-Ogt-Errno")


@pytest.fixture
def services(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    prev = [c.GLOBAL.config() for c in (jcc, tcc)]
    for c in (jcc, tcc):
        c.GLOBAL.configure(budget_mb=0, device=False)
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.write_lines("db", _grid_rows(hosts=11, points=433))
        e.flush_all()
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    js.start()
    ts.start()
    yield js, ts
    js.stop()
    ts.stop()
    je.close()
    te.close()
    for c, cfg in zip((jcc, tcc), prev):
        c.GLOBAL.configure(**cfg)
        c.GLOBAL.clear()


_CQ = ("SELECT count(v), min(v), max(v) FROM m WHERE "
       f"time >= {BASE // 60 * 60 * NS} AND "
       f"time < {(BASE // 60 * 60 + 4330) * NS} GROUP BY time(1m)")


def _device_vars(port):
    return json.loads(_req(port, "GET", "/debug/vars")[1]).get("device", {})


def test_cold_scan_device_counters_match_jax(services):
    """The reference's transfer accounting: after the same cold scans
    (armed, as OGT_DEVOBS=1 runs them) both packages' /debug/vars
    ``device`` sections move the same keys by the same amounts, and both
    /metrics carry the per-site transfer histograms. One stated
    difference: h2d_bytes_total, since the port copies the FOR-delta
    blocks' (first, step, count) table where the reference ships every
    block's (first, step) and the window phase; both count the encoded
    payload and the scatter runs alike."""
    deltas, metrics = [], []
    for svc in services:
        _req(svc.port, "POST", "/debug/ctrl", mod="devobs", arm="1")
        try:
            d0 = _device_vars(svc.port)
            answers = {_req(svc.port, "GET", "/query", db="db", q=_CQ)[1]
                       for _ in range(3)}
            d1 = _device_vars(svc.port)
            metrics.append(parse_prometheus_strict(
                _req(svc.port, "GET", "/metrics")[1].decode()))
        finally:
            _req(svc.port, "POST", "/debug/ctrl", mod="devobs", arm="0")
        assert len(answers) == 1
        deltas.append({k: d1.get(k, 0) - d0.get(k, 0)
                       for k in set(d0) | set(d1)
                       if d1.get(k, 0) != d0.get(k, 0)})
    jd, td = deltas
    assert set(td) == set(jd)
    assert {k: v for k, v in td.items() if k != "h2d_bytes_total"} == \
        {k: v for k, v in jd.items() if k != "h2d_bytes_total"}
    assert td["h2d_bytes_total"] > 0 and jd["h2d_bytes_total"] > 0
    assert td["decode_rows_total"] == 3 * 11 * 433
    for fams in metrics:
        sites = {lab.get("site") for _n, lab, _v in
                 fams["ogt_device_h2d_bytes"]["samples"]}
        assert "device-decode" in sites
        assert fams["ogt_device_h2d_bytes_total"]["type"] == "counter"


def _shape(obj):
    """The key structure of a JSON document (values' types aside)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_debug_device_document_like_jax(services):
    js, ts = services
    # /debug/device answers the capabilities from the cache only: probe
    # both first, or the document depends on the tests that ran before
    jdevobs.backend_capabilities()
    tdevobs.backend_capabilities()
    docs = []
    for svc in (js, ts):
        status, body, _e = _req(svc.port, "GET", "/debug/device")
        assert status == 200
        docs.append(json.loads(body))
    jdoc, tdoc = docs
    assert set(tdoc) == set(jdoc)
    # the stated key mapping
    tcap = dict(tdoc["capabilities"])
    tcap["pallas"] = tcap.pop("cuda_kernels")
    assert set(tcap) == set(jdoc["capabilities"])
    assert set(tcap["pallas"]) == set(jdoc["capabilities"]["pallas"])
    assert tdoc["mesh"] == {"configured": False, "size": None,
                            "epoch": trt.mesh_epoch()}
    assert set(tdoc["mesh"]) == set(jdoc["mesh"])
    assert jdoc["mesh"]["configured"] is False and jdoc["mesh"]["size"] is None
    assert set(tdoc["devices"][0]) == set(jdoc["devices"][0])
    assert tdoc["devices"][0]["platform"] == "cpu"
    for doc in docs:
        # process-wide counters: their keys depend on earlier tests
        doc["planner"].pop("counters")
    for key in ("ledger", "warm", "profile", "planner"):
        assert _shape(tdoc[key]) == _shape(jdoc[key]), key
    assert (tdoc["ledger"]["total_bytes"]
            == sum(o["bytes"] for o in tdoc["ledger"]["by_owner"].values()))


def test_debug_device_mesh_section_with_a_mesh_like_jax(services):
    """With a mesh set in both packages, /debug/device says so alike:
    configured, its size, and each package's live epoch; the inventory
    keeps its records per (geometry, mesh epoch)."""
    js, ts = services
    trt.set_mesh(tdist.make_mesh(8, devices=["cpu"] * 8))
    jrt.set_mesh(jdist.make_mesh(8))
    try:
        tdevobs.note_compile("zz-mesh-site", ("g",))
        docs = []
        for svc in (js, ts):
            status, body, _e = _req(svc.port, "GET", "/debug/device")
            assert status == 200
            docs.append(json.loads(body))
        jdoc, tdoc = docs
        assert tdoc["mesh"] == {"configured": True, "size": 8,
                                "epoch": trt.mesh_epoch()}
        assert jdoc["mesh"] == {"configured": True, "size": 8,
                                "epoch": jrt.mesh_epoch()}
        recs = tdevobs.inventory()["zz-mesh-site"]["geometries"]
        assert any(r["mesh_epoch"] == trt.mesh_epoch() for r in recs)
    finally:
        trt.set_mesh(None)
        jrt.set_mesh(None)


DEVOBS_CTRL = [{}, {"arm": "1"}, {"op": "mark_warm"}, {"op": "clear_warm"},
               {"op": "wat"}, {"op": "profile", "seconds": "nope"},
               {"clear": "1"}, {"arm": "0"}]


@pytest.mark.parametrize("params", DEVOBS_CTRL,
                         ids=[json.dumps(p) for p in DEVOBS_CTRL])
def test_ctrl_devobs_answers_like_jax(services, params):
    got = []
    for svc in services:
        status, body, eno = _req(svc.port, "POST", "/debug/ctrl",
                                 mod="devobs", **params)
        doc = json.loads(body)
        got.append((status, doc, eno))
    assert got[1] == got[0]


def test_ctrl_profile_capture_is_guarded(services, tmp_path):
    _js, ts = services
    d = str(tmp_path / "prof")
    status, body, _e = _req(ts.port, "POST", "/debug/ctrl", mod="devobs",
                            op="profile", seconds="0.3", dir=d)
    assert status == 200, body
    assert json.loads(body)["profile"]["active"] is True
    st2, body2, _e = _req(ts.port, "POST", "/debug/ctrl", mod="devobs",
                          op="profile", seconds="0.3")
    assert st2 == 409 and b"already active" in body2
    import time

    deadline = time.perf_counter() + 20
    while time.perf_counter() < deadline:
        doc = json.loads(_req(ts.port, "POST", "/debug/ctrl",
                              mod="devobs")[1])
        if not doc["profile"]["active"]:
            break
        time.sleep(0.05)
    assert not doc["profile"]["active"]
    assert doc["profile"]["last"]["ok"] is True
    assert os.path.exists(os.path.join(d, "trace.json"))


def test_capabilities_probe_kernel_six():
    caps = tdevobs.backend_capabilities()
    assert caps["probed"] is True
    assert caps["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    ok, why = tdevobs.cuda_kernels_supported()
    assert ok is True and why == ""
    assert tdevobs.backend_capabilities() is caps
    assert tdevobs.backend_capabilities(probe_now=False) is caps
