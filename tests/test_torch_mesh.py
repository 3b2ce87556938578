"""The port's device mesh against the JAX package's, on the CPU (the
counterparts of tests/test_multichip.py and tests/test_distributed.py).

The JAX package runs on the eight virtual CPU devices tests/conftest.py
forces; the port lays the same number of shards over the CPU device
(``make_mesh(n, devices=["cpu"] * n)``). Every case holds the port's
mesh answers to its own single-device answers and to the JAX package's
answers on its mesh of the same size: counts, extremes, selectors and
their times exactly, sums and means within rel 1e-9 (the reference's
tolerance, tests/test_multichip.py:175).
"""

import json
import math

import numpy as np
import pytest
import torch

from opengemini_tpu import native as jnative
from opengemini_tpu.ops import prom as jprom
from opengemini_tpu.parallel import distributed as jdist
from opengemini_tpu.parallel import runtime as jrt
from opengemini_tpu.promql.engine import PromEngine as JPromEngine
from opengemini_tpu.query import offload as joffload
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.index import labels as tlabels
from opengemini_tpu_torch.models.grid import GridBatch
from opengemini_tpu_torch.models.ragged import BucketedBatch
from opengemini_tpu_torch.ops import device_decode as tdd
from opengemini_tpu_torch.ops import prom as tprom
from opengemini_tpu_torch.ops import segment as tseg
from opengemini_tpu_torch.ops.aggregates import get as agg_get
from opengemini_tpu_torch.parallel import distributed as tdist
from opengemini_tpu_torch.parallel import runtime as trt
from opengemini_tpu_torch.promql import engine as tpengine
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import colcache as tcolcache
from opengemini_tpu_torch.storage import encoding as tenc
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 10**9
RTOL = 1e-9
MESH_SIZES = (8, 6, 4, 3)


def tmesh(n: int, axes=("shard",)):
    return tdist.make_mesh(n, axes, devices=["cpu"] * n)


def jmesh(n: int, axes=("shard",)):
    return jdist.make_mesh(n, axes)


def _counter(module, name):
    return TSTATS.snapshot().get(module, {}).get(name, 0)


@pytest.fixture(autouse=True)
def _no_leaked_mesh():
    """The mesh and the offload planner are process-global in both
    packages; other files run in the same worker. The planner keeps the
    walls this file's decodes observed per grid shape: left behind, the
    JAX planner routes a later test's grid of the same shape to the host
    (tests/test_multichip.py's TestMeshShardedDecode then sees no fused
    decode)."""
    yield
    trt.set_mesh(None)
    jrt.set_mesh(None)
    joffload.reset()
    toffload.reset()


def _same(a, b, what=""):
    """Two query answers equal: every number exact but floats within
    RTOL (sums and means merge in another order on a mesh)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], what)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-12), (what, a, b)
    else:
        assert a == b, (what, a, b)


# -- parallel/distributed: the merges ---------------------------------------


def make_batch(rng, n=4000, num_segments=37):
    values = rng.normal(size=n)
    rel_ns = np.sort(rng.integers(0, 2**40, size=n)).astype(np.int64)
    rel_hi = (rel_ns >> 30).astype(np.int32)
    rel_lo = (rel_ns & (2**30 - 1)).astype(np.int32)
    seg_ids = rng.integers(0, num_segments, size=n).astype(np.int32)
    mask = rng.random(n) > 0.15
    return values, rel_hi, rel_lo, seg_ids, mask


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("axes", [("shard",), ("shard", "time")])
def test_dist_agg_matches_single_device_and_jax(rng, axes):
    num_segments = 37
    arrays = make_batch(rng)
    got = tdist.build_dist_agg(tmesh(8, axes), num_segments)(
        *tdist.shard_rows(tmesh(8, axes), *arrays))
    got = {k: v.numpy() for k, v in got.items()}
    jm = jmesh(8, axes)
    want = {k: np.asarray(v) for k, v in jdist.build_dist_agg(
        jm, num_segments)(*jdist.shard_rows(jm, *arrays)).items()}
    v, h, lo, s, m = _t(arrays)
    cnt = tseg.seg_count(s, num_segments, m).numpy()
    np.testing.assert_array_equal(got["count"], cnt)
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["min"],
                                  tseg.seg_min(v, s, num_segments, m).numpy())
    np.testing.assert_array_equal(got["max"], want["max"])
    np.testing.assert_allclose(
        got["sum"], tseg.seg_sum(v, s, num_segments, m).numpy(), rtol=RTOL)
    valid = cnt > 0
    for name, fn in (("first", tseg.seg_first), ("last", tseg.seg_last)):
        one = fn(v, h, lo, s, num_segments, m)[0].numpy()
        np.testing.assert_array_equal(got[name][valid], one[valid])
        np.testing.assert_array_equal(got[name][valid], want[name][valid])
    np.testing.assert_allclose(got["mean"][valid], want["mean"][valid],
                               rtol=RTOL)


def _one_segment(rel_ns, values):
    n = len(values)
    return (values, (rel_ns >> 30).astype(np.int32),
            (rel_ns & (2**30 - 1)).astype(np.int32),
            np.zeros(n, np.int32), np.ones(n, bool))


def test_first_last_across_the_shard_boundary():
    """The global first lives on the last shard (times decrease)."""
    n = 800
    arrays = _one_segment(np.arange(n, 0, -1).astype(np.int64) * 1_000_000,
                          np.arange(n, dtype=np.float64))
    m = tmesh(8)
    out = tdist.build_dist_agg(m, 3)(*tdist.shard_rows(m, *arrays))
    assert out["first"][0] == n - 1
    assert out["last"][0] == 0


def test_first_tie_is_one_row_not_an_average():
    n = 800
    values = np.arange(n, dtype=np.float64)
    arrays = _one_segment(np.full(n, 1_000_000, np.int64), values)
    m = tmesh(8)
    out = tdist.build_dist_agg(m, 1)(*tdist.shard_rows(m, *arrays))
    assert out["first"][0] == values.max()
    assert out["last"][0] == values.max()


@pytest.mark.parametrize("n_shards", MESH_SIZES)
def test_batch_agg_selectors_with_ties_across_shards(n_shards):
    """Selector winners and their global rows: value and time ties that
    straddle shard boundaries must pick the row one device picks (the
    earliest time, then the larger value, then the lowest row)."""
    rng = np.random.default_rng(n_shards)
    n, G = 97, 5
    values = rng.integers(0, 4, n).astype(np.float64)  # many value ties
    rel_ns = rng.integers(0, 6, n).astype(np.int64) * NS  # many time ties
    seg_ids = (np.arange(n) * G // n).astype(np.int32)  # contiguous runs
    mask = rng.random(n) > 0.1
    arrays = (values, (rel_ns >> 30).astype(np.int32),
              (rel_ns & (2**30 - 1)).astype(np.int32), seg_ids, mask,
              np.arange(n, dtype=np.int32))
    tm, jm = tmesh(n_shards), jmesh(n_shards)
    v, h, lo, s, m, _g = _t(arrays)
    for name, fn in (("min", tseg.seg_min_selector),
                     ("max", tseg.seg_max_selector),
                     ("first", tseg.seg_first), ("last", tseg.seg_last)):
        got = tdist.batch_agg_jit(tm, G, (name,))(
            *tdist.shard_rows(tm, *arrays))
        want = jdist.batch_agg_jit(jm, G, (name,))(
            *jdist.shard_rows(jm, *arrays))
        one_v, one_sel = fn(v, h, lo, s, G, m)
        np.testing.assert_array_equal(got[name].numpy(), one_v.numpy())
        np.testing.assert_array_equal(got[name + "_sel"].numpy(),
                                      one_sel.numpy())
        np.testing.assert_array_equal(got[name + "_sel"].numpy(),
                                      np.asarray(want[name + "_sel"]))
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.asarray(want["count"]))


@pytest.mark.parametrize("n,k", [(8, 2), (12, 3), (6, 2), (7, 2), (1, 2)])
def test_mesh_geometry_is_the_references(n, k):
    assert tdist._factor(n, k) == jdist._factor(n, k)
    axes = ("shard", "time", "x")[:k]
    m = tdist.make_mesh(n, axes, devices=["cpu"] * n)
    assert m.size == n and m.axis_names == axes
    assert m.devices.shape == tdist._factor(n, k)
    assert len(m.shard_devices) == n


def test_make_mesh_refuses_more_shards_than_devices():
    with pytest.raises(ValueError):
        tdist.make_mesh(4, devices=["cpu"] * 3)


def test_reshard_relayouts_without_the_host():
    m8, m4 = tmesh(8), tmesh(4)
    a = np.arange(64 * 3, dtype=np.float64).reshape(64, 3)
    (s8,) = tdist.shard_leading_axis(m8, a)
    assert len(s8.parts) == 8 and s8.shape == (64, 3)
    r0 = _counter("device", "mesh_reshards")
    (s4,) = tdist.donate_reshard(m4, s8)
    assert len(s4.parts) == 4
    np.testing.assert_array_equal(s4.gather().numpy(), a)
    (one,) = tdist.donate_reshard(torch.device("cpu"), s4)
    np.testing.assert_array_equal(one.numpy(), a)
    assert _counter("device", "mesh_reshards") == r0 + 2


# -- the executor on a mesh ---------------------------------------------------


def _engines(tmp_path, lines, name="e"):
    je = JEngine(str(tmp_path / f"j{name}"))
    te = TEngine(str(tmp_path / f"t{name}"), device="cpu")
    for e in (je, te):
        e.create_database("db")
        e.write_lines("db", "\n".join(lines))
    return je, te


def _run_both(je, te, queries, n_shards):
    """(port solo, port mesh, JAX mesh) answers of `queries`."""
    jx, tx = JExecutor(je), TExecutor(te)
    solo = [tx.execute(q, db="db") for q in queries]
    trt.set_mesh(tmesh(n_shards))
    jrt.set_mesh(jmesh(n_shards))
    try:
        tx._inc_cache.clear()
        meshed = [tx.execute(q, db="db") for q in queries]
        jmeshed = [jx.execute(q, db="db") for q in queries]
    finally:
        trt.set_mesh(None)
        jrt.set_mesh(None)
    return solo, meshed, jmeshed


def test_executor_mesh_matches_single_device_and_jax(tmp_path):
    base = 1_700_000_040
    lines = [f"m,host=h{i % 5} v={(i * 37) % 11 - 3} "
             f"{(base + i * 7) * NS + (i % 97) * 1000 + 13}"
             for i in range(500)]
    je, te = _engines(tmp_path, lines)
    queries = [
        "SELECT count(v), sum(v), mean(v) FROM m GROUP BY time(5m)",
        "SELECT min(v), max(v), spread(v) FROM m GROUP BY host",
        "SELECT first(v) FROM m",
        "SELECT last(v) FROM m",
        "SELECT max(v) FROM m",  # bare selector: exact point time
    ]
    solo, meshed, jmeshed = _run_both(je, te, queries, 8)
    for q, a, b, c in zip(queries, solo, meshed, jmeshed):
        assert a == b, q
        assert b == c, q
    je.close()
    te.close()


def test_mesh_uses_dense_layouts(tmp_path):
    base = 1_700_000_040
    lines = [f"m,host=h{h} v={(h + i) % 9} {(base + i) * NS}"
             for i in range(60) for h in range(16)]
    te = TEngine(str(tmp_path / "dense"), device="cpu")
    te.create_database("db")
    te.write_lines("db", "\n".join(lines))
    ex = TExecutor(te)
    trt.set_mesh(tmesh(8))
    g0 = _counter("executor", "grid_batches")
    m0 = _counter("device", "mesh_dense_batches")
    res = ex.execute(
        "SELECT mean(v), count(v) FROM m GROUP BY time(1m), host", db="db")
    assert "series" in res["results"][0]
    assert _counter("executor", "grid_batches") > g0
    assert _counter("device", "mesh_dense_batches") > m0
    te.close()


UNEVEN_QUERIES = [
    # grid layout (GROUP BY time over regular data)
    "SELECT mean(v), count(v), max(v) FROM m GROUP BY time(1m), host",
    # grid selectors: the sharded sample-index grid
    "SELECT first(v), last(v) FROM m GROUP BY time(1m), host",
    # bucketed layout (bare selector, exact point time)
    "SELECT min(v) FROM m GROUP BY host",
    "SELECT first(v), last(v) FROM m",
]


@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("n_hosts", [5, 13, 20])
def test_grid_and_bucketed_uneven_rows(tmp_path, n_hosts, n_shards):
    """S not a multiple of the mesh size, and S below it, stay equal to
    one device (and to the JAX package's mesh) for both layouts."""
    base = 1_700_000_040
    lines = [f"m,host=h{h} v={(h * 13 + i) % 9} {(base + i) * NS}"
             for i in range(90) for h in range(n_hosts)]
    je, te = _engines(tmp_path, lines)
    solo, meshed, jmeshed = _run_both(je, te, UNEVEN_QUERIES, n_shards)
    for q, a, b, c in zip(UNEVEN_QUERIES, solo, meshed, jmeshed):
        assert a == b, q
        assert b == c, q
    je.close()
    te.close()


def test_rows_below_the_mesh_size_stay_on_one_device():
    m = tmesh(8)
    assert GridBatch._mesh_for_rows(m.size - 1) is None
    trt.set_mesh(m)
    assert GridBatch._mesh_for_rows(m.size - 1) is None
    assert GridBatch._mesh_for_rows(m.size) is m


def _grid_batch(rng, n_rows=16, W=8, every=60 * NS, step=8 * NS, n_pts=60):
    b = GridBatch(np.dtype(np.float64), W, every, "cpu")
    for s in range(n_rows):
        rel = np.arange(n_pts, dtype=np.int64) * step
        seg = (rel // every) % W
        b.add(rng.random(n_pts) * 10, rel, seg, np.ones(n_pts, bool), rel,
              sids=s)
    return b


def test_grid_batch_reshards_on_set_mesh():
    ref = _grid_batch(np.random.default_rng(99))
    b = _grid_batch(np.random.default_rng(99))
    out_ref = ref.run(agg_get("sum"), 8)[0]
    ssd_ref = ref.run(agg_get("stddev"), 8)[0]
    sel_ref = ref.run(agg_get("first"), 8)
    trt.set_mesh(tmesh(8))
    out_a = b.run(agg_get("sum"), 8)[0]  # basic kernel on 8 shards
    epoch_a = b._state["dev_epoch"]
    assert len(b._state["dev"][0].parts) == 8
    trt.set_mesh(tmesh(4))  # a reload between kernel groups
    ssd_b = b.run(agg_get("stddev"), 8)[0]
    sel_b = b.run(agg_get("first"), 8)
    assert b._state["dev_epoch"] != epoch_a
    assert len(b._state["dev"][0].parts) == 4
    np.testing.assert_allclose(out_a, out_ref, rtol=1e-12)
    np.testing.assert_allclose(ssd_b, ssd_ref, rtol=1e-12)
    np.testing.assert_array_equal(sel_b[0], sel_ref[0])
    np.testing.assert_array_equal(sel_b[1], sel_ref[1])


def test_bucket_reshards_on_set_mesh():
    def build():
        r = np.random.default_rng(7)
        b = BucketedBatch(np.float64, "cpu")
        for s in range(12):
            rel = np.arange(40, dtype=np.int64) * NS
            b.add(r.random(40), rel, np.full(40, s % 8, np.int64),
                  np.ones(40, bool), rel)
        return b

    ref = build()
    sum_ref = ref.run(agg_get("sum"), 8, want_sel=False)[0]
    first_ref = ref.run(agg_get("first"), 8)
    b = build()
    trt.set_mesh(tmesh(8))
    sum_a = b.run(agg_get("sum"), 8, want_sel=False)[0]
    trt.set_mesh(tmesh(4))  # hot reload
    first_b = b.run(agg_get("first"), 8)
    np.testing.assert_allclose(sum_a, sum_ref, rtol=1e-12)
    np.testing.assert_array_equal(first_b[0], first_ref[0])
    np.testing.assert_array_equal(first_b[1], first_ref[1])
    assert all(len(a.parts) == 4 for bk in b._frozen
               for a in (bk._mesh_arrays or ()))


# -- the colcache device tier on a mesh ---------------------------------------


@pytest.fixture
def cache_on():
    prior = tcolcache.GLOBAL.config()
    tcolcache.GLOBAL.clear()
    tcolcache.GLOBAL.configure(budget_mb=64, device=True, device_budget_mb=64)
    yield tcolcache.GLOBAL
    tcolcache.GLOBAL.clear()
    tcolcache.GLOBAL.configure(**prior)


def _warm_engine(tmp_path):
    base = 1_700_000_040
    te = TEngine(str(tmp_path / "cc"), device="cpu")
    te.create_database("db")
    te.write_lines("db", "\n".join(
        f"m,host=h{h} v={(h + i) % 7} {(base + i) * NS}"
        for i in range(120) for h in range(20)))
    te.flush_all()
    q = "SELECT mean(v), count(v), max(v) FROM m GROUP BY time(1m), host"
    return te, TExecutor(te), q


def test_warm_mesh_scan_is_transfer_free(tmp_path, cache_on):
    te, ex, q = _warm_engine(tmp_path)
    solo = ex.execute(q, db="db")
    m = tmesh(8)
    trt.set_mesh(m)
    ex._inc_cache.clear()
    cold = ex.execute(q, db="db")
    ex._inc_cache.clear()
    h2d0 = _counter("device", "mesh_h2d_bytes")
    hits0 = cache_on.counters()["device_hits"]
    warm = ex.execute(q, db="db")
    assert _counter("device", "mesh_h2d_bytes") == h2d0
    assert cache_on.counters()["device_hits"] > hits0
    assert solo == cold == warm
    ent = next(iter(cache_on._dev.values()))[0]
    assert ent["mesh"] is m
    assert len(ent["vt"].parts) == m.size
    te.close()


def test_mesh_swap_reshards_the_entry_in_place(tmp_path, cache_on):
    """8 -> 4 -> one device -> 4: the retained entry follows each mesh
    device to device (no host decode or transfer), the cache's resident
    bytes never grow, and every answer stays equal."""
    te, ex, q = _warm_engine(tmp_path)
    solo = ex.execute(q, db="db")
    trt.set_mesh(tmesh(8))
    ex._inc_cache.clear()
    ex.execute(q, db="db")  # cold: the sharded put at 8 shards
    resident = cache_on.device_ledger_bytes()
    h2d = _counter("device", "mesh_h2d_bytes")
    for mesh in (tmesh(4), None, tmesh(4)):
        trt.set_mesh(mesh)
        ex._inc_cache.clear()
        r0 = cache_on.counters()["device_reshards"]
        assert ex.execute(q, db="db") == solo
        assert cache_on.counters()["device_reshards"] == r0 + 1
        ent = next(iter(cache_on._dev.values()))[0]
        assert ent["mesh"] is mesh
        parts = getattr(ent["vt"], "parts", [ent["vt"]])
        assert len(parts) == (1 if mesh is None else mesh.size)
        assert cache_on.device_ledger_bytes() <= resident
    assert _counter("device", "mesh_h2d_bytes") == h2d
    te.close()


def test_grid_rebuilds_after_the_entry_drops(cache_on):
    """A swap onto a mesh the retained rows cannot split over drops the
    entry; a batch whose freeze hit it must rebuild from its rows."""
    def build(token):
        b = GridBatch(np.dtype(np.float64), 8, 60 * NS, "cpu")
        r = np.random.default_rng(3)
        for s in range(16):
            rel = np.arange(48, dtype=np.int64) * (10 * NS)
            b.add(r.random(48), rel, (rel // (60 * NS)) % 8,
                  np.ones(48, bool), rel, sids=s)
        b.device_cache_token = token
        return b

    out_ref = build(None).run(agg_get("sum"), 8)[0]
    trt.set_mesh(tmesh(8))
    out_a = build("tok-rebuild").run(agg_get("sum"), 8)[0]
    second = build("tok-rebuild")
    second._freeze(8)  # a device-tier hit: the host scatter skipped
    assert second._state["arrays"] is None
    trt.set_mesh(tmesh(3))  # 16 rows do not split over 3 shards
    drops0 = cache_on.counters()["device_reshard_drops"]
    out_b = second.run(agg_get("sum"), 8)[0]
    assert cache_on.counters()["device_reshard_drops"] > drops0
    np.testing.assert_allclose(out_a, out_ref, rtol=1e-12)
    np.testing.assert_allclose(out_b, out_ref, rtol=1e-12)


def test_downsample_records_match_solo_under_a_mesh():
    from opengemini_tpu_torch.record import Column, FieldType, Record
    from opengemini_tpu_torch.storage.downsample import downsample_records

    rng = np.random.default_rng(11)
    series = {}
    for sid in range(10):  # uneven against 8 shards
        n = 90
        times = (np.arange(n, dtype=np.int64) * NS + sid * 7_000_000
                 + 1_700_000_000 * NS)
        series[sid] = Record(times, {
            "f": Column(FieldType.FLOAT, rng.random(n) * 100,
                        rng.random(n) < 0.95),
            "i": Column(FieldType.INT, rng.integers(0, 1 << 30, n),
                        np.ones(n, bool)),
        })
    schema = {"f": FieldType.FLOAT, "i": FieldType.INT}
    tmin = int(min(r.times[0] for r in series.values()))
    tmax = int(max(r.times[-1] for r in series.values())) + 1
    args = (series, schema, tmin, tmax, 60 * NS)
    solo, solo_schema = downsample_records(*args, device="cpu")
    trt.set_mesh(tmesh(8))
    meshed, mesh_schema = downsample_records(*args, device="cpu")
    assert solo_schema == mesh_schema
    assert sorted(solo) == sorted(meshed)
    for sid in solo:
        a, b = solo[sid], meshed[sid]
        np.testing.assert_array_equal(a.times, b.times)
        for name in a.columns:
            ca, cb = a.columns[name], b.columns[name]
            np.testing.assert_array_equal(ca.valid, cb.valid)
            np.testing.assert_allclose(
                ca.values[ca.valid].astype(np.float64),
                cb.values[cb.valid].astype(np.float64), rtol=1e-12)


# -- the tiled PromQL kernels on a mesh ---------------------------------------


def _synth_series(rng, n_series, lo=40, hi=160, span=3_600_000, grid=250,
                  n_windows=24, every=150_000, width=300.0):
    lens = rng.integers(lo, hi, size=n_series)
    base_ms = 1_700_000_000_000
    t_parts, v_parts = [], []
    for length in lens:
        t = np.sort(rng.choice(np.arange(0, span, grid), size=length,
                               replace=False)) + base_ms
        v = np.cumsum(rng.random(length))
        v[length // 2:] -= v[length // 2] * 0.5  # a counter reset
        t_parts.append(t)
        v_parts.append(v)
    ends = (base_ms + np.arange(n_windows) * every + 2 * width * 1000) \
        / 1000.0
    return (np.concatenate(t_parts), np.concatenate(v_parts), lens, ends,
            width)


def _preps(rng, n_series, **kw):
    t_all, v_all, lens, ends, width = _synth_series(rng, n_series, **kw)
    out = []
    for mod, extra in ((tprom, {"device": "cpu"}), (jprom, {})):
        plan = mod.plan_tiles(ends - width, ends, int(t_all.min()),
                              int(t_all.max()), 1 << 20)
        out.append(mod.prepare_tiled(plan, t_all, v_all, lens,
                                     dtype=np.float64, **extra))
    return out


KERNELS = [
    ("rate", lambda s: s.rate(is_counter=True, is_rate=True), 0.0),
    ("delta", lambda s: s.rate(is_counter=False, is_rate=False), 0.0),
    ("irate", lambda s: s.instant_rate(per_second=True), 0.0),
    ("changes", lambda s: s.changes_resets(kind="changes"), 0.0),
    ("resets", lambda s: s.changes_resets(kind="resets"), 0.0),
    ("sum", lambda s: s.over_time(func="sum"), 0.0),
    ("min", lambda s: s.over_time(func="min"), 0.0),
    ("max", lambda s: s.over_time(func="max"), 0.0),
    ("last", lambda s: s.over_time(func="last"), 0.0),
    ("count", lambda s: s.over_time(func="count"), 0.0),
    # near-zero variance windows cancel in the last ulps
    ("stddev", lambda s: s.over_time(func="stddev"), 1e-6),
    ("stdvar", lambda s: s.over_time(func="stdvar"), 1e-6),
]


@pytest.mark.parametrize("n_series", [13, 5, 16])
def test_sharded_tiled_kernels_match_host_and_jax(rng, n_series):
    tp, jp = _preps(rng, n_series)
    tsh, jsh = tp.sharded(tmesh(8)), jp.sharded(jmesh(8))
    assert len(tsh.arrays["values"].parts) == 8
    S, kr = tp.S, tp.k_real
    for name, fn, atol in KERNELS:
        m_val, m_ok = (x.numpy()[:S, :kr] for x in fn(tsh))
        j_val, j_ok = (np.asarray(x)[:S, :kr] for x in fn(jsh))
        h_val, h_ok = fn(_HostKernels(tp))
        assert np.array_equal(np.asarray(h_ok), m_ok), name
        assert np.array_equal(j_ok, m_ok), name
        for want in (h_val, j_val):
            np.testing.assert_allclose(
                np.where(m_ok, want, 0), np.where(m_ok, m_val, 0),
                rtol=RTOL, atol=atol, err_msg=name)


class _HostKernels:
    """TiledPrepared's kernel methods on the host route, called like
    ShardedTiled's."""

    def __init__(self, prep):
        self.prep = prep

    def __getattr__(self, name):
        fn = getattr(self.prep, name)
        return lambda **kw: fn(np, **kw)


def test_sharded_tiled_six_shards_seven_series():
    """The reference's forced-device-count case (6 devices, S=7)."""
    rng = np.random.default_rng(3)
    tp, jp = _preps(rng, 7, lo=20, hi=40, span=600_000, grid=500,
                    n_windows=8, every=60_000, width=120.0)
    tsh, jsh = tp.sharded(tmesh(6)), jp.sharded(jmesh(6))
    assert len(tsh.arrays["values"].parts) == 6
    m, mk = (x.numpy()[:7, :tp.k_real]
             for x in tsh.rate(is_counter=True, is_rate=True))
    j, jk = (np.asarray(x)[:7, :tp.k_real]
             for x in jsh.rate(is_counter=True, is_rate=True))
    h, hk = tp.rate(np, is_counter=True, is_rate=True)
    assert np.array_equal(np.asarray(hk), mk) and np.array_equal(jk, mk)
    np.testing.assert_allclose(np.where(mk, h, 0), np.where(mk, m, 0),
                               rtol=RTOL)
    np.testing.assert_allclose(np.where(mk, j, 0), np.where(mk, m, 0),
                               rtol=RTOL)


def test_sharded_linear_regression_matches_host(rng):
    tp, _jp = _preps(rng, 13)
    sh = tp.sharded(tmesh(8))
    h_slope, h_icept, h_ok = tp.linear_regression(np)
    m_slope, m_icept, m_ok = (x.numpy()[:tp.S, :tp.k_real]
                              for x in sh.linear_regression())
    assert np.array_equal(np.asarray(h_ok), m_ok)
    for h, m in ((h_slope, m_slope), (h_icept, m_icept)):
        np.testing.assert_allclose(np.where(h_ok, h, 0),
                                   np.where(m_ok, m, 0), rtol=RTOL,
                                   atol=1e-9)


def test_sharded_view_cached_per_mesh(rng):
    tp, _jp = _preps(rng, 13)
    m8, m4 = tmesh(8), tmesh(4)
    assert tp.sharded(m8) is tp.sharded(m8)
    assert tp.sharded(m4) is not tp.sharded(m8)


def test_prom_engine_on_a_mesh_matches_solo_and_jax(tmp_path):
    base = 1_700_000_000
    lines = [f"reqs,host=h{s} value={i * 2 + s * 0.5} "
             f"{(base + i * 15 + (s % 3)) * NS}"
             for s in range(11) for i in range(120)]
    je, te = _engines(tmp_path, lines, "prom")
    tpe, jpe = tpengine.PromEngine(te), JPromEngine(je)
    for q in ("rate(reqs[5m])", "sum_over_time(reqs[10m])",
              "max_over_time(reqs[5m])", "deriv(reqs[5m])"):
        solo = tpe.query_range(q, base + 600, base + 1500, 60, db="db")
        before = _counter("prom", "tiled_mesh_kernels")
        trt.set_mesh(tmesh(8))
        jrt.set_mesh(jmesh(8))
        try:
            meshed = tpe.query_range(q, base + 600, base + 1500, 60, db="db")
            jmeshed = jpe.query_range(q, base + 600, base + 1500, 60,
                                      db="db")
        finally:
            trt.set_mesh(None)
            jrt.set_mesh(None)
        assert _counter("prom", "tiled_mesh_kernels") > before, q
        for other in (solo, jmeshed):
            assert len(other["result"]) == len(meshed["result"]), q
            for a, b in zip(other["result"], meshed["result"]):
                assert a["metric"] == b["metric"]
                assert len(a["values"]) == len(b["values"])
                for (ta, va), (tb, vb) in zip(a["values"], b["values"]):
                    assert ta == tb
                    assert math.isclose(float(va), float(vb), rel_tol=RTOL,
                                        abs_tol=1e-12), q
    je.close()
    te.close()


def test_prom_mesh_opt_out_knob(monkeypatch):
    m = tmesh(8)
    trt.set_mesh(m)
    monkeypatch.setenv("OGT_PROM_MESH", "0")
    assert tpengine._mesh_for_tiled() is None
    monkeypatch.delenv("OGT_PROM_MESH")
    assert tpengine._mesh_for_tiled() is m


# -- the label gather ---------------------------------------------------------


@pytest.mark.parametrize("n_shards", MESH_SIZES)
def test_label_gather_over_the_mesh(monkeypatch, n_shards):
    """Rows hash-partitioned by series id over the shards, each part
    gathered on its shard: bit-identical to the host gather and to the
    JAX package's mesh gather, which partitions the same way."""
    from opengemini_tpu.index import labels as jlabels
    from opengemini_tpu_torch.query import offload as toffload

    rng = np.random.default_rng(n_shards)
    n, nvals = 5000, 37
    sids = np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.int64)
    col = rng.integers(-1, nvals, n).astype(np.int32)
    lut = rng.random(nvals + 1) > 0.5
    col_idx = np.where(col < 0, np.int32(nvals), col)
    tsnap = tlabels._Snapshot(1, "m", sids, {})
    jsnap = jlabels._Snapshot(1, "m", sids, {})
    trt.set_mesh(tmesh(n_shards))
    jrt.set_mesh(jmesh(n_shards))
    got = tsnap._gather_mesh(col_idx, lut)
    np.testing.assert_array_equal(got, lut[col_idx])
    np.testing.assert_array_equal(got, jsnap._gather_mesh(col_idx, lut))
    parts = tsnap._hash_parts(n_shards)
    for a, b in zip(parts, jsnap._hash_parts(n_shards)):
        np.testing.assert_array_equal(a, b)
    assert tsnap._hash_parts(n_shards) is parts  # cached per epoch
    # with a mesh set, the device knob's static route is the mesh (the
    # planner off: its static choice verbatim)
    monkeypatch.setenv("OGT_LABEL_INDEX_DEVICE", "1")
    monkeypatch.setattr(tlabels, "_DEVICE_MIN_ROWS", 1)
    prior = toffload.enabled()
    toffload.set_enabled(False)
    try:
        assert tlabels._route_gather(n, nvals, "cpu") == "mesh"
        trt.set_mesh(None)
        assert tlabels._route_gather(n, nvals, "cpu") == "device"
    finally:
        toffload.set_enabled(prior)


# -- the mesh decode plan -----------------------------------------------------


def _profile_engines(tmp_path, monkeypatch, n_hosts, name="md"):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    if jnative.load() is None:
        assert jnative.build(), "g++ build of native/codecs.cpp failed"
    rng = np.random.default_rng(n_hosts)
    base = 1_700_000_000
    lines = []
    for h in range(n_hosts):
        for p in range(110):
            lines.append(
                f"cpu,host=h{h} vi={int(rng.integers(0, 250))}i,"
                f"vf={float(rng.standard_normal()):.6f} "
                f"{(base + p * 10) * NS}")
    je, te = _engines(tmp_path, lines, f"{name}{n_hosts}")
    je.flush_all()
    te.flush_all()
    return je, te


def _decode_queries():
    lo, hi = 1_700_000_000 * NS, 1_700_002_000 * NS
    return [
        f"SELECT count(vi), min(vi), max(vi) FROM cpu WHERE time >= {lo} "
        f"AND time < {hi} GROUP BY time(1m)",
        f"SELECT mean(vf), sum(vf), stddev(vf), first(vf), last(vf) "
        f"FROM cpu WHERE time >= {lo} AND time < {hi} "
        "GROUP BY time(90s), host",
    ]


@pytest.mark.parametrize("n_hosts", [64, 70, 13])
def test_mesh_decode_equals_one_device_and_jax(tmp_path, monkeypatch,
                                               n_hosts):
    monkeypatch.setenv("OGT_DEVICE_DECODE", "1")
    je, te = _profile_engines(tmp_path, monkeypatch, n_hosts)
    jx, tx = JExecutor(je), TExecutor(te)

    def run(ex, mesh, rt):
        rt.set_mesh(mesh)
        try:
            tcolcache.GLOBAL.clear()
            ex._inc_cache.clear()
            return ex.execute(q, db="db")
        finally:
            rt.set_mesh(None)

    f0 = _counter("executor", "grid_decode_fused")
    for q in _decode_queries():
        solo = run(tx, None, trt)
        meshed = run(tx, tmesh(8), trt)
        jmeshed = run(jx, jmesh(8), jrt)
        assert json.dumps(solo, sort_keys=True) == \
            json.dumps(meshed, sort_keys=True), q
        _same(meshed, jmeshed, q)
    assert _counter("executor", "grid_decode_fused") > f0
    je.close()
    te.close()


def test_mesh_decode_engages_and_the_warm_run_is_transfer_free(
        tmp_path, monkeypatch, cache_on):
    monkeypatch.setenv("OGT_DEVICE_DECODE", "1")
    je, te = _profile_engines(tmp_path, monkeypatch, 70, name="warm")
    je.close()
    ex = TExecutor(te)
    q = _decode_queries()[0]

    def counters():
        c = TSTATS.snapshot()
        return (c.get("device", {}).get("h2d_bytes_total", 0),
                c.get("device", {}).get("mesh_h2d_bytes", 0),
                c.get("executor", {}).get("grid_decode_fused", 0))

    trt.set_mesh(tmesh(8))
    h0, m0, f0 = counters()
    cold = ex.execute(q, db="db")
    h1, m1, f1 = counters()
    ex._inc_cache.clear()  # drop the result cache, keep the device tier
    warm = ex.execute(q, db="db")
    h2, m2, f2 = counters()
    assert f1 - f0 >= 1, "the mesh fused decode did not engage"
    assert m1 - m0 > 0, "the mesh-cold transfer is not counted"
    assert h2 - h1 == 0 and m2 == m1, "a warm mesh run must copy nothing"
    assert json.dumps(cold, sort_keys=True) == json.dumps(warm,
                                                          sort_keys=True)
    te.close()


def _cover_case(rng, kind, n):
    """Values and one block of `kind` holding them, built explicitly (the
    adaptive encoders pick by size)."""
    import struct

    from opengemini_tpu_torch import native as tnative

    if kind == "gorilla":
        v = np.round(rng.standard_normal(n), 2)
        v[10:20] = v[10]  # a repeat run across a cut
        return v, [struct.pack("<BI", tenc._T_GORILLA, n)
                   + tnative.gorilla_encode(v)]
    v = np.cumsum(rng.integers(0, 200, n)).astype(np.int64)
    if kind == "varint":
        return v, [struct.pack("<BI", tenc._T_VARINT, n)
                   + tnative.varint_delta_encode(v)]
    d = np.diff(v)
    return v, [struct.pack("<BIqqB", tenc._T_DELTA | tenc._DEV_FLAG, n,
                           int(v[0]), int(d.min()), 1)
               + (d - d.min()).astype(np.uint8).tobytes()]


@pytest.mark.parametrize("kind", ["varint", "delta", "gorilla"])
@pytest.mark.parametrize("n_shards", MESH_SIZES)
def test_mesh_plan_shards_cover_the_rows(kind, n_shards):
    """Every shard's plan covers its rows, each shard cuts the block
    mid-stream with its seed, and the sharded grid is bit-identical to
    the unsharded plan's (tests/test_multichip.py:696, :615)."""
    rng = np.random.default_rng(n_shards)
    # 64 lanes: each shard's grid outweighs its encoded bytes (the cost
    # gate every shard's plan passes through)
    S_pad, k, w_pad = 24, 1, 64
    v, blocks = _cover_case(rng, kind, n=S_pad * 4 - 5)
    n = len(v)
    rows = np.arange(n, dtype=np.int64) // 4
    flat = rows * k * w_pad + np.arange(n, dtype=np.int64) % 4
    views = [(blocks, np.array([[0, n]], np.int64), n)]
    mask = np.ones(n, bool)
    m = tmesh(n_shards)
    if S_pad % n_shards:
        S_pad += n_shards - S_pad % n_shards
    shape = (S_pad, k, w_pad)
    dt = np.float64
    mplan = tdd.build_mesh_grid_plan(views, flat, mask, shape, dt, m)
    assert mplan is not None
    assert len(mplan.shards) == n_shards
    assert sum(p.n for p in mplan.shards) == n
    stats, vt, mt, _ = tdd.run_mesh_grid_plan(mplan)
    assert len(vt.parts) == n_shards
    plan = tdd.build_grid_plan(views, flat, mask, shape, dt, "cpu")
    one_stats, one_vt, one_mt, _ = tdd.run_grid_plan(plan)
    assert np.array_equal(vt.gather().numpy().view(np.int64),
                          one_vt.numpy().view(np.int64))
    np.testing.assert_array_equal(mt.gather().numpy(), one_mt.numpy())
    want = np.zeros(shape)
    want.reshape(-1)[flat] = v
    np.testing.assert_array_equal(vt.gather().numpy(), want)
    for key in ("count", "min", "max"):
        np.testing.assert_array_equal(tdist.fetch_np(stats[key]),
                                      one_stats[key].numpy())
