"""The port's offload planner (opengemini_tpu_torch/query/offload.py)
against the JAX package's, on the CPU.

Every case of the reference's tests/test_offload.py runs through both
``Planner``s with the same injected ``observe`` seconds and compile
walls: the routes, the decision ring's records, the model snapshot,
``debug_doc`` and the ``offload`` counter deltas must be equal, and the
reference's own assertions hold on the port. Then the grid query on
both routes (forced host, forced device, the planner's own) against the
JAX package's answer, and the ``mod=offload`` switches over both
``HttpService``s.
"""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.query import offload as joff
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttpService
from opengemini_tpu.storage import colcache as jcc
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.utils import devobs as jdevobs
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.ops import cuda_segment as cs
from opengemini_tpu_torch.query import offload as toff
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttpService
from opengemini_tpu_torch.storage import colcache as tcc
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils import devobs as tdevobs
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 10**9
BASE = 1_700_000_000

GEO = ((8, 4, 16), "float64")
GEO2 = ((32, 4, 16), "float64")

PKGS = {"jax": (joff, jdevobs, JSTATS), "torch": (toff, tdevobs, TSTATS)}


@pytest.fixture(autouse=True)
def _offload_state():
    """Both planners enabled, empty and unfrozen at the reference's
    default knobs; the process state restored after."""
    prev = {k: off.enabled() for k, (off, _d, _s) in PKGS.items()}
    for off, _dv, _st in PKGS.values():
        off.reset()
        off.set_enabled(True)
        off.set_force(None)
        off.GLOBAL.configure(min_samples=2, explore_after=3,
                             amortize=4.0, ewma=0.3)
    yield
    for k, (off, dv, _st) in PKGS.items():
        off.reset()
        off.set_enabled(prev[k])
        off.set_force(None)
        dv.reset()


def _both(monkeypatch, scenario, compile_s=None):
    """Run ``scenario(off, devobs)`` against each package (with the
    compile estimate pinned to ``compile_s`` when given); the returned
    observables and the offload counter deltas must be equal. Returns
    the port's. Counters that did not move are left out: which keys a
    registry holds depends on the tests that ran before."""
    out = {}
    for name, (off, dv, stats) in PKGS.items():
        if compile_s is not None:
            monkeypatch.setattr(off, "_compile_estimate_s",
                                lambda k, _s=compile_s: float(_s))
        c0 = stats.counters("offload")
        got = scenario(off, dv)
        c1 = stats.counters("offload")
        out[name] = (got, {k: c1.get(k, 0) - c0.get(k, 0)
                           for k in set(c0) | set(c1)
                           if c1.get(k, 0) != c0.get(k, 0)})
    assert out["torch"] == out["jax"]
    return out["torch"]


def _planner_state(p):
    return {"decisions": p.decisions(), "model": p.model_snapshot()}


# -- model primitives ----------------------------------------------------------


def test_geo_cells_and_route_record_match():
    for geo in (((8, 4, 16), "float64"), (2, (3, (4,)), "f8", None),
                (True, 8, 0, -3), "float64"):
        assert toff._geo_cells(geo) == joff._geo_cells(geo)
    recs = []
    for off in (joff, toff):
        r = off._Route()
        for s in (2.0, 0.1, 0.3):
            r.add(s, alpha=0.5)
        recs.append((r.doc(), r.cold_s, r.ewma_s))
    assert recs[0] == recs[1]
    assert recs[1][2] == pytest.approx(0.1 * 0.5 + 0.3 * 0.5)


def test_compile_estimate_prefix_matches_inventory(monkeypatch):
    inv = {
        "grid_decode_fused": {"geometries": [
            {"geometry": "a", "wall_ms": 800.0},
            {"geometry": "b", "wall_ms": 1200.0}]},
        "grid_decode_imat": {"geometries": [
            {"geometry": "a", "wall_ms": 400.0}]},
        "build:grid_window": {"geometries": [
            {"geometry": "a", "wall_ms": 3000.0}]},
        "bucket_stats": {"geometries": [
            {"geometry": "a", "wall_ms": 50.0}]},
    }
    for off, dv, _st in PKGS.values():
        monkeypatch.setattr(dv, "inventory", lambda: inv)
    for kernel in ("grid_decode", "bucket_stats", "nope", ""):
        assert (toff._compile_estimate_s(kernel)
                == joff._compile_estimate_s(kernel))
    # the kernel builds never count as the planner family's compile
    assert toff._compile_estimate_s("grid_decode") == pytest.approx(
        (800 + 1200 + 400) / 3 / 1e3)


# -- the decision ladder ---------------------------------------------------------


def test_cold_model_mirrors_static_gate(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        routes = [p.decide("k", GEO, ("host", "device"), static=s)
                  for s in ("host", "device")]
        return routes, _planner_state(p)

    (routes, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["host", "device"]
    assert all(r["reason"] == "prior" for r in st["decisions"])


def test_disabled_planner_is_pass_through(monkeypatch):
    def sc(off, _dv):
        off.set_enabled(False)
        p = off.Planner()
        p.observe("k", GEO, "host", 0.5)
        route = p.decide("k", GEO, ("host", "device"), static="device")
        return route, _planner_state(p)

    (route, st), ctr = _both(monkeypatch, sc)
    assert route == "device"
    assert st == {"decisions": [], "model": []}
    assert not any(ctr.values())


def test_prior_to_measured_transition(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, explore_after=0)
        p.observe("k", GEO, "host", 0.010)
        r1 = p.decide("k", GEO, ("host", "device"), static="host")
        p.observe("k", GEO, "host", 0.010)
        p.observe("k", GEO, "device", 0.001)
        p.observe("k", GEO, "device", 0.001)
        r2 = p.decide("k", GEO, ("host", "device"), static="host")
        r3 = p.decide("k", GEO, ("host", "device"), static="device")
        return [r1, r2, r3], _planner_state(p)

    (routes, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["host", "device", "device"]
    assert [r["reason"] for r in reversed(st["decisions"])] == [
        "prior", "model", "model"]


def test_model_ties_resolve_to_static(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=1, explore_after=0)
        for route in ("host", "device"):
            p.observe("k", GEO, route, 0.005)
            p.observe("k", GEO, route, 0.005)
        return [p.decide("k", GEO, ("host", "device"), static=s)
                for s in ("host", "device")], _planner_state(p)

    (routes, _st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["host", "device"]


def test_explore_trials_unmeasured_candidate(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, explore_after=3)
        p.observe("k", GEO, "host", 0.010)
        p.observe("k", GEO, "host", 0.010)
        routes = [p.decide("k", GEO, ("host", "device"), static="host")
                  for _ in range(6)]
        return routes, _planner_state(p)

    (routes, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    reasons = [r["reason"] for r in reversed(st["decisions"])]
    first = reasons.index("explore")
    assert first >= 3 and routes[first] == "device"


def test_explore_deferred_by_amortization(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, explore_after=2, amortize=4.0)
        p.observe("k", GEO, "host", 0.010)
        p.observe("k", GEO, "host", 0.010)
        return [p.decide("k", GEO, ("host", "device"), static="host")
                for _ in range(8)], _planner_state(p)

    (routes, _st), ctr = _both(monkeypatch, sc, compile_s=1000.0)
    assert routes == ["host"] * 8
    assert ctr.get("explore_deferred_total", 0) >= 1


def test_kernel_wide_per_cell_prior_scales(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=1, explore_after=10**6)
        cells = off._geo_cells(GEO)
        p.observe("k", GEO, "host", 1e-6 * cells)
        p.observe("k", GEO, "host", 1e-6 * cells)
        p.observe("k", GEO, "device", 1e-8 * cells)
        p.observe("k", GEO, "device", 1e-8 * cells)
        p.observe("k", GEO2, "host", 1e-6 * off._geo_cells(GEO2))
        route = p.decide("k", GEO2, ("host", "device"), static="host")
        return route, _planner_state(p)

    (route, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert route == "device"
    rec = st["decisions"][0]
    assert rec["reason"] == "model"
    assert rec["est_ms"]["device"] < rec["est_ms"]["host"]


# -- amortization and the pre-warm flip --------------------------------------------


def test_amortize_holds_device_static_on_host(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, amortize=4.0)
        p.observe("k", GEO, "host", 0.050)
        p.observe("k", GEO, "host", 0.050)
        routes = [p.decide("k", GEO, ("host", "device"), static="device")
                  for _ in range(6)]
        return routes, _planner_state(p), off.wants_prewarm("k", GEO)

    (routes, st, wants), _c = _both(monkeypatch, sc, compile_s=1.0)
    assert routes == ["host"] * 6
    reasons = [r["reason"] for r in reversed(st["decisions"])]
    assert reasons[:4] == ["amortize"] * 4 and "prewarm" in reasons[4:]
    assert wants


def test_amortize_inert_without_compile_data(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        return (p.decide("k", GEO, ("host", "device"), static="device"),
                _planner_state(p))

    (route, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert route == "device" and st["decisions"][0]["reason"] == "prior"


def test_flip_waits_for_background_compile_then_lands(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, explore_after=10**6)
        p.observe("k", GEO, "host", 0.100)
        p.observe("k", GEO, "host", 0.100)
        hint = {"device": 1024}
        r1 = p.decide("k", GEO, ("host", "device"), static="host",
                      bytes_hint=hint)
        wants = off.wants_prewarm("k", GEO)
        built = []
        off.register_builder("k", GEO, lambda: built.append(1))
        deadline = time.time() + 5
        while not off.geometry_warm("k", GEO):
            assert time.time() < deadline, "background compile never ran"
            time.sleep(0.01)
        r2 = p.decide("k", GEO, ("host", "device"), static="host",
                      bytes_hint=hint)
        return ([r1, r2], wants, built, off.wants_prewarm("k", GEO),
                _planner_state(p))

    (routes, wants, built, after, st), _c = _both(monkeypatch, sc,
                                                  compile_s=0.5)
    assert routes == ["host", "device"]
    assert [r["reason"] for r in reversed(st["decisions"])] == [
        "prewarm", "model"]
    assert wants and built == [1] and not after


def test_prewarm_once_ranks_by_hits_and_arms_tripwire(monkeypatch):
    def sc(off, dv):
        built = []
        off.register_builder("hotk", GEO, lambda: built.append("hot"))
        off.register_builder("coldk", GEO, lambda: built.append("cold"))
        dv.note_compile("hotk", GEO)
        for _ in range(10):
            dv.note_use("hotk", GEO)
        dv.note_compile("coldk", GEO)
        ran = off.prewarm_once(topk=1)
        warm = [dv.compiles_since_warm()]
        dv.note_compile("late", ())
        warm.append(dv.compiles_since_warm())
        return (ran, built, off.geometry_warm("hotk", GEO),
                off.geometry_warm("coldk", GEO), warm,
                off.prewarm_status())

    (ran, built, hot, cold, warm, status), _c = _both(monkeypatch, sc)
    assert [r["kernel"] for r in ran] == ["hotk"] and ran[0]["ok"]
    assert built == ["hot"] and hot and not cold
    assert warm == [0, 1]
    assert status["registered"] == 2 and status["warm"] == 1
    assert status["last"] == {"ran": 1, "ok": 1}


def test_prewarm_once_one_bad_builder_does_not_starve(monkeypatch):
    def sc(off, _dv):
        def boom():
            raise RuntimeError("no backend")

        built = []
        off.register_builder("a", GEO, boom)
        off.register_builder("b", GEO, lambda: built.append("b"))
        return off.prewarm_once(topk=4), built

    (ran, built), _c = _both(monkeypatch, sc)
    by_k = {r["kernel"]: r for r in ran}
    assert not by_k["a"]["ok"] and "RuntimeError" in by_k["a"]["error"]
    assert by_k["b"]["ok"] and built == ["b"]


def test_start_stop_prewarmer_thread(monkeypatch):
    def sc(off, _dv):
        started = [off.start_prewarmer(interval_s=0.2),
                   off.start_prewarmer(interval_s=0.2)]
        alive = off.prewarm_status()["thread_alive"]
        off.stop_prewarmer()
        return started, alive, off.prewarm_status()["thread_alive"]

    (started, alive, after), _c = _both(monkeypatch, sc)
    assert started == [True, False] and alive and not after


# -- freeze, force and the gate prior -----------------------------------------------


def test_frozen_planner_is_pinned(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=1, explore_after=0)
        p.observe("k", GEO, "host", 0.010)
        p.observe("k", GEO, "device", 0.001)
        r1 = p.decide("k", GEO, ("host", "device"), static="host")
        p.set_frozen(True)
        p.observe("k", GEO, "device", 99.0)
        r2 = p.decide("k", GEO, ("host", "device"), static="host")
        frozen = p.model_snapshot()
        p.set_frozen(False)
        p.observe("k", GEO, "device", 0.002)
        return [r1, r2], frozen, _planner_state(p)

    (routes, frozen, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["device", "device"]
    assert frozen[0]["routes"]["device"]["count"] == 1
    assert frozen[0]["uses"] == 1
    assert st["model"][0]["routes"]["device"]["count"] == 2


def test_frozen_planner_does_not_explore(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        p.configure(min_samples=2, explore_after=0)
        p.observe("k", GEO, "host", 0.010)
        p.observe("k", GEO, "host", 0.010)
        p.set_frozen(True)
        return [p.decide("k", GEO, ("host", "device"), static="host")
                for _ in range(5)], _planner_state(p)

    (routes, st), _c = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["host"] * 5
    assert all(r["reason"] != "explore" for r in st["decisions"])


def test_forced_route_overrides_everything(monkeypatch):
    def sc(off, _dv):
        off.set_force("device")
        p = off.Planner()
        p.observe("k", GEO, "host", 0.001)
        p.observe("k", GEO, "host", 0.001)
        routes = [p.decide("k", GEO, ("host", "device"), static="host"),
                  p.decide("k", GEO, ("host",), static="host")]
        with pytest.raises(ValueError) as e:
            off.set_force("gpu")
        return routes, str(e.value), _planner_state(p)

    (routes, err, _st), ctr = _both(monkeypatch, sc, compile_s=0.0)
    assert routes == ["device", "host"]
    assert ctr["forced_total"] == 1
    assert "gpu" in err


def test_gate_prior_is_byte_inequality_until_measured(monkeypatch):
    def sc(off, _dv):
        p = off.Planner()
        got = [p.gate_prior("k", GEO, device_bytes=10, host_bytes=100),
               p.gate_prior("k", GEO, device_bytes=100, host_bytes=10)]
        p.observe("k", GEO, "device", 0.001)
        got += [p.gate_prior("k", GEO, device_bytes=100, host_bytes=10),
                p.gate_prior("k", GEO2, device_bytes=100, host_bytes=10)]
        off.set_force("device")
        got.append(off.Planner().gate_prior("k", GEO, device_bytes=100,
                                             host_bytes=10))
        return got

    got, ctr = _both(monkeypatch, sc)
    assert got == [True, False, True, False, True]
    assert ctr["gate_vetoes_total"] == 2


def test_prom_host_kernels_mode_validation(monkeypatch):
    def sc(off, _dv):
        modes = []
        for m in ("1", "auto", "0", "none"):
            off.set_prom_host_kernels_mode(m)
            modes.append(off.prom_host_kernels_mode())
        with pytest.raises(ValueError):
            off.set_prom_host_kernels_mode("maybe")
        return modes

    modes, _c = _both(monkeypatch, sc)
    assert modes == ["1", "", "0", ""]


def test_debug_doc_and_ring_match(monkeypatch):
    """The planner section of /debug/device, field for field, after the
    same observations and decisions (the process-wide counters aside,
    which the fixture's delta comparison covers)."""
    def sc(off, _dv):
        off.GLOBAL.observe("k", GEO, "host", 0.005)
        off.GLOBAL.observe("k", GEO, "device", 0.002)
        for static in ("host", "device", "host"):
            off.GLOBAL.decide("k", GEO, ("host", "device"), static=static,
                              stage="grid_decode")
        doc = off.GLOBAL.debug_doc()
        doc.pop("counters")
        return doc

    doc, _c = _both(monkeypatch, sc, compile_s=0.0)
    assert doc["decisions"][0]["stage"] == "grid_decode"
    assert set(doc["knobs"]) >= {"min_samples", "explore_after", "amortize",
                                 "ewma", "force", "prom_host_kernels"}


# -- the grid query on both routes -----------------------------------------------------


def _grid_lines(hosts=16, points=360):
    return "\n".join(
        f"m,host=h{h} v={((h * 7 + i * 3) % 101) + 0.25 * (h % 4)},"
        f"n={(h * 11 + i) % 53}i {(BASE // 60 * 60 + 10 * i) * NS}"
        for i in range(points) for h in range(hosts))


_GQ = ("SELECT count(n), min(n), max(n), mean(v), max(v) FROM m WHERE "
       f"time >= {BASE // 60 * 60 * NS} AND "
       f"time < {(BASE // 60 * 60 + 3600) * NS} GROUP BY time(1m)")
# one grid batch per run (C3's shape): one decision per query
_GQ1 = ("SELECT count(n), min(n), max(n) FROM m WHERE "
        f"time >= {BASE // 60 * 60 * NS} AND "
        f"time < {(BASE // 60 * 60 + 3600) * NS} GROUP BY time(1m)")


def _close_results(a, b):
    sa, sb = a["results"][0]["series"], b["results"][0]["series"]
    assert [s["columns"] for s in sa] == [s["columns"] for s in sb]
    for x, y in zip(sa, sb):
        assert len(x["values"]) == len(y["values"])
        for ra, rb in zip(x["values"], y["values"]):
            assert ra[:4] == rb[:4] and ra[5] == rb[5]
            assert ra[4] == pytest.approx(rb[4], rel=1e-9)


@pytest.fixture
def cold_engines(tmp_path, monkeypatch):
    """The same device-profile writes in both packages, both decoded-
    column caches and result caches off: every run is a cold scan."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    prev = [c.GLOBAL.config() for c in (jcc, tcc)]
    for c in (jcc, tcc):
        c.GLOBAL.configure(budget_mb=0, device=False)
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.write_lines("db", _grid_lines())
        e.flush_all()
    yield je, te
    je.close()
    te.close()
    for c, cfg in zip((jcc, tcc), prev):
        c.GLOBAL.configure(**cfg)
        c.GLOBAL.clear()


def _counting(monkeypatch):
    """Count the plain calls of kernels 3-5 on the CPU."""
    calls = {"grid_window_agg": 0, "widen_packed_segments": 0,
             "unpack_bits_segments": 0}
    for name in calls:
        fn = getattr(cs, name)

        def counted(*a, _fn=fn, _n=name, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cs, name, counted)
    return calls


def test_grid_query_same_answer_on_both_routes(cold_engines, monkeypatch):
    je, te = cold_engines
    want = JExecutor(je).execute(_GQ, db="db")
    ex = TExecutor(te)
    calls = _counting(monkeypatch)
    for force, decodes_on_card in (("host", False), ("device", True)):
        toff.set_force(force)
        before = dict(calls)
        got = ex.execute(_GQ, db="db")
        _close_results(got, want)
        launched = sum(calls[k] - before[k] for k in (
            "widen_packed_segments", "unpack_bits_segments"))
        assert (launched > 0) == decodes_on_card, (force, calls, before)
        assert calls["grid_window_agg"] > before["grid_window_agg"]
        rec = toff.GLOBAL.decisions()
        assert not rec or rec[0]["route"] == force


def test_grid_query_identical_planner_on_off(cold_engines):
    """The reference's bit-identity case: a cold planner and a disabled
    one give the same answers, in both packages alike."""
    je, te = cold_engines
    for ex, off in ((JExecutor(je), joff), (TExecutor(te), toff)):
        off.set_enabled(True)
        off.GLOBAL.clear()
        on_cold = [json.dumps(ex.execute(_GQ, db="db"), sort_keys=True)
                   for _ in range(3)]
        off.set_enabled(False)
        off_runs = [json.dumps(ex.execute(_GQ, db="db"), sort_keys=True)
                    for _ in range(3)]
        assert on_cold == off_runs
        assert len(set(on_cold)) == 1


def test_planner_sequence_matches_on_a_real_scan(cold_engines):
    """Eight runs of one cold grid scan with the planner on: both
    packages make the same decisions for the same reasons (the walls
    differ, so only a tie-free model rests on them: the decisions up to
    the first model choice between two measured routes, and the reasons
    of all)."""
    je, te = cold_engines
    seqs = {}
    for name, ex, off in (("jax", JExecutor(je), joff),
                          ("torch", TExecutor(te), toff)):
        off.GLOBAL.clear()
        for _ in range(8):
            ex.execute(_GQ1, db="db")
        seqs[name] = [(r["reason"], r["uses"], r["kernel"], r["geometry"])
                      for r in reversed(off.GLOBAL.decisions())]
    assert seqs["torch"] == seqs["jax"]
    reasons = [r[0] for r in seqs["torch"]]
    assert reasons[:3] == ["prior", "prior", "model"]
    assert "explore" in reasons


# -- the offload switches over both services -----------------------------------------------


def _req(port, method, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(
        url, data=b"" if method == "POST" else None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), r.headers.get("X-Ogt-Errno")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("X-Ogt-Errno")


@pytest.fixture
def services(tmp_path):
    je = JEngine(str(tmp_path / "j"))
    te = TEngine(str(tmp_path / "t"), device="cpu")
    for e in (je, te):
        e.create_database("db")
    js, ts = JHttpService(je, "127.0.0.1", 0), THttpService(te, port=0)
    js.start()
    ts.start()
    yield js, ts
    js.stop()
    ts.stop()
    je.close()
    te.close()


def _doc(body):
    doc = json.loads(body)
    doc.pop("counters", None)  # process-wide, compared as deltas above
    return doc


OFFLOAD_CTRL = [
    {},
    {"min_samples": "5", "amortize": "2.5", "freeze": "1",
     "host_kernels": "1", "force": "device"},
    {"arm": "0", "freeze": "0", "clear": "1", "force": "none",
     "host_kernels": "auto"},
    {"force": "gpu"},
    {"host_kernels": "maybe"},
    {"min_samples": "lots"},
    {"ewma": "x"},
    {"op": "frobnicate"},
    {"explore_after": "7", "ewma": "0.5", "arm": "1"},
]


@pytest.mark.parametrize("params", OFFLOAD_CTRL,
                         ids=[json.dumps(p) for p in OFFLOAD_CTRL])
def test_ctrl_offload_answers_like_jax(services, params):
    js, ts = services
    got = []
    for svc in (js, ts):
        status, body, eno = _req(svc.port, "POST", "/debug/ctrl",
                                 mod="offload", **params)
        got.append((status, _doc(body), eno))
    assert got[1] == got[0]


def test_ctrl_prewarm_op_answers_like_jax(services):
    js, ts = services
    got = []
    for svc, off in ((js, joff), (ts, toff)):
        built = []
        off.register_builder("k", GEO, lambda b=built: b.append(1))
        status, body, _e = _req(svc.port, "POST", "/debug/ctrl",
                                mod="offload", op="prewarm")
        got.append((status, json.loads(body), built))
    assert got[1] == got[0]
    assert got[1][1]["prewarmed"][0]["kernel"] == "k"


def test_debug_device_planner_section_like_jax(services):
    js, ts = services
    docs = []
    for svc, off in ((js, joff), (ts, toff)):
        off.GLOBAL.observe("k", GEO, "host", 0.005)
        off.GLOBAL.decide("k", GEO, ("host", "device"), static="host",
                          stage="grid_decode")
        status, body, _e = _req(svc.port, "GET", "/debug/device")
        assert status == 200
        pl = json.loads(body)["planner"]
        pl.pop("counters")
        docs.append(pl)
    assert docs[1] == docs[0]
    assert docs[1]["decisions"][0]["reason"] == "prior"


def test_routes_reach_the_query_tracker(cold_engines):
    """A planner decision inside a query lands in its tracker entry
    (``routes`` per stage, what /debug/queries shows)."""
    from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER

    _je, te = cold_engines
    seen = []
    orig = TRACKER.note_route

    def spy(qid, stage, route):
        seen.append((qid is not None, stage, route))
        return orig(qid, stage, route)

    TRACKER.note_route = spy
    try:
        TExecutor(te).execute(_GQ, db="db")
    finally:
        TRACKER.note_route = orig
    assert (True, "grid_decode", "device") in seen
    assert np.all([s[1] == "grid_decode" for s in seen])
