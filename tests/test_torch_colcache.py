"""The port's decoded-column cache against the JAX package's, on the CPU
(the counterparts of tests/test_colcache.py).

Every scenario runs in both packages on the same seeded writes: the
reads must give the same rows, and the cache counters (hits, misses,
fills, invalidations, resident bytes) must move alike, since the port
keys, fills and evicts exactly as the reference does. The device tier
runs on the CPU device here; a gpu-marked test checks on the card that
an eviction gives the tier's memory back.
"""

import threading
import time

import numpy as np
import pytest
import torch

import opengemini_tpu.ingest.line_protocol as jlp
from opengemini_tpu import native as jnative
import opengemini_tpu_torch.ingest.line_protocol as tlp
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import colcache as jcolcache
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.shard import Shard as JShard
from opengemini_tpu.utils.querytracker import GLOBAL as JTRACKER
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import colcache as tcolcache
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TTRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

BASE = 1_700_000_000
NS = 10**9


class Pkg:
    """One package's shard, line parser and cache, for side-by-side
    scenarios."""

    def __init__(self, name, shard_cls, lp, cache, engine_cls, executor_cls,
                 tracker, stats, engine_kw):
        self.name = name
        self.shard_cls = shard_cls
        self.lp = lp
        self.cache = cache
        self.engine_cls = engine_cls
        self.executor_cls = executor_cls
        self.tracker = tracker
        self.stats = stats
        self.engine_kw = engine_kw

    def shard(self, path):
        return self.shard_cls(str(path / self.name), 0, 10**18)

    def write(self, sh, line: str) -> None:
        sh.write_points(self.lp.parse_lines(line), line.encode(), "ns", 0)

    def fill(self, sh, n_files=3, rows=50):
        for f in range(n_files):
            self.write(sh, "\n".join(
                f"cpu usage={f * rows + i} {(BASE + f * rows + i)}000000000"
                for i in range(rows)))
            sh.flush()

    def engine(self, path):
        return self.engine_cls(str(path / self.name), **self.engine_kw)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_codecs():
    """The JAX package writes native gorilla/varint blocks only when its
    codec library loads, and it remembers a failed load for the rest of
    the process: one attempt made while another process was still
    building the library leaves it on its zlib fallback, while the port
    (its own copy of the codecs) writes gorilla blocks, and the two
    caches then account different bytes for the same rows. Build and
    reload the library before any scenario, as the reference's own tests
    do."""
    for _ in range(10):
        if jnative.load() is not None or jnative.build():
            return
        time.sleep(0.5)  # another process may be mid-build
    pytest.fail("g++ build of native/codecs.cpp failed")


JAX = Pkg("jax", JShard, jlp, jcolcache.GLOBAL, JEngine, JExecutor,
          JTRACKER, JSTATS, {})
PORT = Pkg("torch", TShard, tlp, tcolcache.GLOBAL, TEngine, TExecutor,
           TTRACKER, TSTATS, {"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture
def caches():
    """Both process caches on at a test budget, restored after."""
    prev = [p.cache.config() for p in PKGS]
    for p in PKGS:
        p.cache.clear()
        p.cache.configure(budget_mb=64, device=False)
    yield
    for p, cfg in zip(PKGS, prev):
        p.cache.configure(**cfg)
        p.cache.clear()


COUNTERS = ("hits", "misses", "fills", "invalidations", "evictions",
            "bytes", "device_hits", "device_misses", "device_bytes",
            "entries", "device_entries")


def _delta(before, after):
    return {k: after[k] - before[k] for k in COUNTERS}


def _rec(rec):
    return (rec.times.tolist(),
            {n: (np.asarray(c.values).tolist(), np.asarray(c.valid).tolist())
             for n, c in sorted(rec.columns.items())})


def _both(tmp_path, scenario):
    """Run `scenario(pkg, tmp_path)` in both packages: the same return
    value, and the same cache counter deltas."""
    out = []
    for p in PKGS:
        c0 = p.cache.counters()
        got = scenario(p, tmp_path)
        out.append((got, _delta(c0, p.cache.counters())))
    (jgot, jd), (tgot, td) = out
    assert tgot == jgot
    assert td == jd
    return tgot, td


def test_warm_read_serves_from_cache(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.fill(sh)
        sid = sh.index.get_or_create("cpu", ())
        first = sh.read_series("cpu", sid)
        c0 = p.cache.counters()
        assert c0["fills"] > 0 and c0["bytes"] > 0
        second = sh.read_series("cpu", sid)
        c1 = p.cache.counters()
        # the repeat is served by consult-before-dispatch
        assert c1["hits"] > c0["hits"]
        assert (c1["misses"], c1["fills"]) == (c0["misses"], c0["fills"])
        sh.close()
        return _rec(first), _rec(second)

    (first, second), _d = _both(tmp_path, scenario)
    assert first == second


def test_write_flush_returns_fresh_data(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.write(sh, "cpu usage=1 1000000000")
        sh.flush()
        sid = sh.index.get_or_create("cpu", ())
        got = [sh.read_series("cpu", sid).columns["usage"].values.tolist()]
        # the memtable row wins over the cached chunk before the flush,
        # the new file after it
        p.write(sh, "cpu usage=9 1000000000")
        got.append(sh.read_series("cpu", sid).columns["usage"].values.tolist())
        sh.flush()
        got.append(sh.read_series("cpu", sid).columns["usage"].values.tolist())
        sh.close()
        return got

    got, _d = _both(tmp_path, scenario)
    assert got == [[1.0], [9.0], [9.0]]


def test_compaction_rewrite_evicts_and_refreshes(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.write(sh, "cpu usage=1 1000000000")
        sh.flush()
        p.write(sh, "cpu usage=2 2000000000\ncpu usage=9 1000000000")
        sh.flush()
        sid = sh.index.get_or_create("cpu", ())
        warm = sh.read_series("cpu", sid).columns["usage"].values.tolist()
        c0 = p.cache.counters()
        assert c0["bytes"] > 0
        assert sh.compact()
        c1 = p.cache.counters()
        assert c1["invalidations"] > c0["invalidations"]
        assert c1["bytes"] == 0
        got = sh.read_series("cpu", sid)
        sh.close()
        return warm, _rec(got)

    (warm, got), _d = _both(tmp_path, scenario)
    assert warm == [9.0, 2.0]
    assert got[0] == [1000000000, 2000000000]


def test_leveled_compaction_in_place_rewrite_evicts(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.fill(sh, n_files=4, rows=20)
        sid = sh.index.get_or_create("cpu", ())
        before = sh.read_series("cpu", sid)
        c0 = p.cache.counters()
        assert c0["bytes"] > 0
        assert sh.compact_level(fanout=4)
        c1 = p.cache.counters()
        assert c1["invalidations"] > c0["invalidations"]
        after = sh.read_series("cpu", sid)
        sh.close()
        return _rec(before), _rec(after)

    (before, after), _d = _both(tmp_path, scenario)
    assert before == after


def test_disabled_is_bit_identical_and_untouched(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.fill(sh, n_files=2, rows=30)
        sid = sh.index.get_or_create("cpu", ())
        warm = sh.read_series("cpu", sid)
        p.cache.configure(budget_mb=0)
        c0 = p.cache.counters()
        assert c0["bytes"] == 0  # disabling cleared the tier
        cold = sh.read_series("cpu", sid)
        c1 = p.cache.counters()
        assert (c1["hits"], c1["misses"], c1["fills"]) == (
            c0["hits"], c0["misses"], c0["fills"])
        assert cold.times.tobytes() == warm.times.tobytes()
        assert cold.columns["usage"].values.tobytes() == \
            warm.columns["usage"].values.tobytes()
        sh.close()
        return _rec(cold)

    _both(tmp_path, scenario)


def test_lru_budget_bounds_bytes(tmp_path, caches):
    def scenario(p, path):
        p.cache.configure(budget_mb=1)
        sh = p.shard(path)
        for f in range(4):  # ~3 MB decoded, far over the 1 MB budget
            p.write(sh, "\n".join(
                f"cpu usage={i}.5 {(BASE + f * 50_000 + i)}000000000"
                for i in range(50_000)))
            sh.flush()
        sid = sh.index.get_or_create("cpu", ())
        rec = sh.read_series("cpu", sid)
        c = p.cache.counters()
        assert c["bytes"] <= 1 << 20 and c["evictions"] > 0
        sh.close()
        return len(rec), float(rec.columns["usage"].values.sum())

    (n, _s), _d = _both(tmp_path, scenario)
    assert n == 200_000


def test_bulk_read_warm_hits(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.write(sh, "\n".join(  # >= PACK_MIN_SERIES: packed chunks
            f"cpu,host=h{s:03d} usage={s}.0 {(BASE + i)}000000000"
            for s in range(100) for i in range(20)))
        sh.flush()
        sids = np.asarray(sorted(sh.index.series_ids("cpu")), np.int64)
        s1, r1 = sh.read_series_bulk("cpu", sids)
        c0 = p.cache.counters()
        s2, r2 = sh.read_series_bulk("cpu", sids)
        c1 = p.cache.counters()
        assert c1["hits"] > c0["hits"] and c1["fills"] == c0["fills"]
        # another sid subset reuses the same cached packed columns
        s3, r3 = sh.read_series_bulk("cpu", sids[: len(sids) // 2])
        assert p.cache.counters()["fills"] == c1["fills"]
        sh.close()
        return [(s.tolist(), _rec(r)) for s, r in ((s1, r1), (s2, r2),
                                                   (s3, r3))]

    got, _d = _both(tmp_path, scenario)
    assert got[0] == got[1]
    assert set(got[2][0]) < set(got[0][0])


def test_put_after_invalidate_is_tombstoned(caches):
    for p in PKGS:
        key = (None, 987654321, 1, 0, "v")
        p.cache.invalidate_gens([987654321])
        p.cache.put(key, np.zeros(16))
        assert p.cache.peek(key) is None
        assert p.cache.counters()["bytes"] == 0


def test_configure_budget_keeps_device_budget(caches):
    for p in PKGS:
        p.cache.configure(budget_mb=64, device=True, device_budget_mb=128)
        p.cache.configure(budget_mb=32)  # must not clobber the 128 MB
        assert p.cache.config() == {"budget_mb": 32, "device": True,
                                    "device_budget_mb": 128}


def test_concurrent_readers_vs_invalidation(tmp_path, caches):
    """Readers racing compaction-driven invalidation see exactly the
    committed rows (values are a function of the timestamp) and never
    crash; the end state equals the reference's."""
    def scenario(p, path):
        sh = p.shard(path)
        rows = 200
        p.write(sh, "\n".join(f"cpu usage={i} {(BASE + i)}000000000"
                              for i in range(rows)))
        sh.flush()
        sid = sh.index.get_or_create("cpu", ())
        stop = threading.Event()
        errors: list = []

        def reader():
            try:
                while not stop.is_set():
                    rec = sh.read_series("cpu", sid)
                    t = (rec.times // NS) - BASE
                    np.testing.assert_array_equal(
                        rec.columns["usage"].values, t.astype(np.float64))
                    assert len(rec) == rows
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def churner():
            try:
                for _ in range(15):
                    p.write(sh, f"cpu usage=0 {BASE}000000000")
                    sh.flush()
                    sh.compact()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                stop.set()

        threads = [threading.Thread(target=reader) for _ in range(3)]
        threads.append(threading.Thread(target=churner))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        got = _rec(sh.read_series("cpu", sid))
        sh.close()
        return got

    out = [scenario(p, tmp_path) for p in PKGS]
    assert out[0] == out[1]


def _grid_rows(n_hosts=8, points=600):
    return [f"cpu,host=h{s} u={50 + (s + p) % 40} {(BASE + p) * NS}"
            for p in range(points) for s in range(n_hosts)]


def test_repeated_grid_scan_reuses_device_buffers(tmp_path, caches,
                                                  monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")  # the reference's scan path
    q = (f"SELECT mean(u), max(u) FROM cpu WHERE time >= {BASE * NS} "
         f"AND time < {(BASE + 600) * NS} GROUP BY time(1m), host")
    now = (BASE + 600) * NS

    def scenario(p, path):
        p.cache.configure(budget_mb=64, device=True)
        e = p.engine(path)
        e.create_database("db")
        e.write_lines("db", "\n".join(_grid_rows()))
        e.flush_all()
        ex = p.executor_cls(e)
        r1 = ex.execute(q, db="db", now_ns=now)
        c1 = p.cache.counters()
        assert c1["device_misses"] > 0 and c1["device_bytes"] > 0
        r2 = ex.execute(q, db="db", now_ns=now)
        c2 = p.cache.counters()
        assert c2["device_hits"] > c1["device_hits"]
        # a write bumps the shard's data_version: the next scan misses
        e.write_lines("db", f"cpu,host=h0 u=999 {(BASE + 1) * NS}")
        r3 = ex.execute(q, db="db", now_ns=now)
        c3 = p.cache.counters()
        assert c3["device_misses"] > c2["device_misses"]
        # ... and a flush keeps the signature: the next scan hits
        e.flush_all()
        r4 = ex.execute(q, db="db", now_ns=now)
        assert p.cache.counters()["device_hits"] > c3["device_hits"]
        e.close()
        return r1, r2, r3, r4

    (r1, r2, r3, r4), _d = _both(tmp_path, scenario)
    assert r1 == r2 and r3 != r1 and r4 == r3


def test_device_tier_hit_launches_no_decode(tmp_path, caches):
    """A warm hit on a device-profile cold scan: the grid kernel runs on
    the retained tensors, and neither the decode nor a transfer runs."""
    from opengemini_tpu_torch.ops import cuda_segment as cs

    PORT.cache.configure(budget_mb=64, device=True)
    q = (f"SELECT mean(u), max(u), count(u) FROM cpu WHERE "
         f"time >= {BASE * NS} AND time < {(BASE + 600) * NS} "
         "GROUP BY time(1m)")
    calls = {"widen": 0, "unpack": 0, "grid": 0}
    wrapped = {}
    for name, key in (("widen_packed_segments", "widen"),
                      ("unpack_bits_segments", "unpack"),
                      ("grid_window_agg", "grid")):
        fn = getattr(cs, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        wrapped[name] = fn
        setattr(cs, name, counted)
    mp = pytest.MonkeyPatch()
    mp.setenv("OGT_DEVICE_PROFILE", "1")
    # the result cache would answer the warm run before the device tier
    mp.setenv("OGT_RESULT_CACHE", "0")
    try:
        e = PORT.engine(tmp_path)
        e.create_database("db")
        rows = [f"cpu,host=h{s} u={(s * 7 + p) % 13 + 0.5} {(BASE + p) * NS}"
                for p in range(600) for s in range(80)]
        e.write_lines("db", "\n".join(rows))
        e.flush_all()
        ex = TExecutor(e)
        h2d = "h2d_bytes_total"
        fill0 = TSTATS.counters("device").get(h2d, 0)
        cold = ex.execute(q, db="db")
        assert TSTATS.counters("device").get(h2d, 0) > fill0
        assert calls["grid"] >= 1
        before = dict(calls)
        d0 = PORT.cache.counters()["device_hits"]
        x0 = TSTATS.counters("device").get(h2d, 0)
        warm = ex.execute(q, db="db")
        assert warm == cold
        assert PORT.cache.counters()["device_hits"] == d0 + 1
        assert calls["grid"] == before["grid"] + 1
        assert calls["widen"] == before["widen"]
        assert calls["unpack"] == before["unpack"]
        assert TSTATS.counters("device").get(h2d, 0) == x0
        e.close()
    finally:
        mp.undo()
        for name, fn in wrapped.items():
            setattr(cs, name, fn)


def test_device_tier_off_means_no_entries(tmp_path, caches):
    q = (f"SELECT mean(u) FROM cpu WHERE time >= {BASE * NS} "
         f"AND time < {(BASE + 300) * NS} GROUP BY time(1m)")

    def scenario(p, path):
        e = p.engine(path)
        e.create_database("db")
        e.write_lines("db", "\n".join(
            f"cpu u={i} {(BASE + i) * NS}" for i in range(300)))
        e.flush_all()
        res = p.executor_cls(e).execute(q, db="db",
                                        now_ns=(BASE + 300) * NS)
        c = p.cache.counters()
        assert c["device_bytes"] == 0 and c["device_entries"] == 0
        e.close()
        return res

    _both(tmp_path, scenario)


def test_device_budget_evicts_and_accounts(tmp_path, caches):
    """Entries count numel * element_size of every retained tensor, and
    a budget below two grids keeps one: the older entry is evicted."""
    PORT.cache.configure(budget_mb=64, device=True, device_budget_mb=1)
    e = PORT.engine(tmp_path)
    e.create_database("db")
    # a (64, 60, 24) grid: 829440 B of values and mask, two over 1 MiB
    e.write_lines("db", "\n".join(_grid_rows(n_hosts=64, points=2400)))
    ex = TExecutor(e)
    qs = [f"SELECT max(u) FROM cpu WHERE time >= {(BASE + lo) * NS} AND "
          f"time < {(BASE + lo + 1200) * NS} GROUP BY time(1m), host"
          for lo in (0, 1200)]
    ex.execute(qs[0], db="db")
    c = PORT.cache.counters()
    [(ent, nb)] = list(PORT.cache._dev.values())
    assert nb == c["device_bytes"] == sum(
        t.numel() * t.element_size() for t in (ent["vt"], ent["mt"]))
    ex.execute(qs[1], db="db")
    c2 = PORT.cache.counters()
    assert c2["device_entries"] == 1 and c2["evictions"] > c["evictions"]
    assert c2["device_bytes"] == PORT.cache.device_ledger_bytes() <= 1 << 20
    e.close()


def test_counters_exported_via_statistics(tmp_path, caches):
    def scenario(p, path):
        sh = p.shard(path)
        p.fill(sh, n_files=2, rows=20)
        sid = sh.index.get_or_create("cpu", ())
        sh.read_series("cpu", sid)
        sh.read_series("cpu", sid)
        snap = p.stats.snapshot().get("colcache", {})
        for key in ("hits", "fills", "bytes", "time_ns"):
            assert key in snap, f"missing colcache counter {key}"
        assert snap["hits"] > 0 and snap["bytes"] > 0
        sh.close()
        return snap["bytes"]

    _both(tmp_path, scenario)


def test_query_stage_attribution(tmp_path, caches):
    for p in PKGS:
        sh = p.shard(tmp_path)
        p.fill(sh, n_files=2, rows=20)
        sid = sh.index.get_or_create("cpu", ())
        qid = p.tracker.register("SELECT * FROM cpu", "db")
        try:
            sh.read_series("cpu", sid)
            sh.read_series("cpu", sid)
            snap = [q for q in p.tracker.snapshot() if q["qid"] == qid]
            assert snap and "colcache" in snap[0]["stages"]
        finally:
            p.tracker.unregister(qid)
        sh.close()


@pytest.mark.gpu
def test_device_evict_returns_card_memory(tmp_path, caches):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PORT.cache.configure(budget_mb=64, device=True, device_budget_mb=4096)
    e = TEngine(str(tmp_path / "gpu"))
    e.create_database("db")
    e.write_lines("db", "\n".join(_grid_rows(n_hosts=64, points=3600)))
    ex = TExecutor(e)
    q = (f"SELECT mean(u) FROM cpu WHERE time >= {BASE * NS} AND "
         f"time < {(BASE + 3600) * NS} GROUP BY time(1m), host")
    ex.execute(q, db="db")
    torch.cuda.synchronize()
    held = PORT.cache.counters()["device_bytes"]
    assert held > 0
    before = torch.cuda.memory_allocated()
    PORT.cache.configure(device_budget_mb=0)  # evicts every entry
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before - held
    e.close()
