"""The port's scan pool and scan pipeline (storage/scanpool.py) against
the JAX package, on the CPU.

The reference's tests/test_scanpool.py cases run on the port:
``map_ordered`` and ``prefetch_ordered`` yield in submission order
whatever order the work finishes in, a producer's error re-raises on the
consumer, an abandoned pipeline stops its producer, one worker (or
``forced_serial()`` on the calling thread) runs inline, and KILL QUERY
stops a pipelined bulk scan from the producer thread. Pooled and serial
scans answer bit for bit alike, and as the JAX package does on the same
writes (floats within rel 1e-9, everything else exactly), over the
reference's writes and over a scan of three shards whose bulk reads go
through the pipeline's producer thread.
"""

from __future__ import annotations

import math
import random
import threading
import time

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import scanpool as jscanpool
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import executor as texmod
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import scanpool
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER
from opengemini_tpu_torch.utils.querytracker import QueryKilled
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000
WEEK = 7 * 24 * 3600
RTOL = 1e-9


@pytest.fixture
def pool_on(monkeypatch):
    """The scan pool live with 4 workers, whatever the cores."""
    monkeypatch.setattr(scanpool, "WORKERS", 4)
    monkeypatch.setattr(scanpool, "_pool", None)
    yield
    pool = scanpool._pool
    monkeypatch.setattr(scanpool, "_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je = JEngine(str(tmp_path / "jax"), sync_wal=False)
    te = TEngine(str(tmp_path / "torch"), device="cpu", sync_wal=False)
    for e in (je, te):
        e.create_database("db")
    yield je, te
    je.close()
    te.close()


def _close(a, b, path="$"):
    """Floats within RTOL; counts, ints, strings and nulls exactly."""
    if isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=RTOL, abs_tol=0), (path, a, b)
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


# -- map_ordered -------------------------------------------------------------


def test_map_ordered_in_submission_order_despite_shuffled_completion(
        pool_on):
    rng = random.Random(7)
    delays = [rng.uniform(0, 0.01) for _ in range(40)]

    def mk(i):
        def job():
            time.sleep(delays[i])  # later jobs often finish first
            return i
        return job

    got = scanpool.map_ordered([mk(i) for i in range(40)], [1] * 40)
    assert list(got) == list(range(40))


def test_map_ordered_serial_fallback_matches(pool_on):
    jobs = [lambda i=i: i * i for i in range(10)]
    pooled = list(scanpool.map_ordered(jobs, [1] * 10))
    with scanpool.forced_serial():
        assert scanpool.pool() is None
        serial = list(scanpool.map_ordered(jobs, [1] * 10))
    assert pooled == serial == [i * i for i in range(10)]


def test_map_ordered_oversized_single_job_still_admitted(pool_on,
                                                         monkeypatch):
    monkeypatch.setattr(scanpool, "INFLIGHT_BYTES", 100)
    got = list(scanpool.map_ordered(
        [lambda: 1, lambda: 2, lambda: 3, lambda: 4], [10**9] * 4))
    assert got == [1, 2, 3, 4]


def test_map_ordered_consumer_exception_cancels_pending(pool_on):
    ran = []

    def mk(i):
        def job():
            time.sleep(0.005)
            ran.append(i)
            return i
        return job

    gen = scanpool.map_ordered([mk(i) for i in range(200)], [1] * 200)
    with pytest.raises(RuntimeError):
        for i in gen:
            if i == 3:
                raise RuntimeError("consumer bails")
    time.sleep(0.1)
    assert len(ran) < 100  # the pending futures were cancelled


# -- prefetch_ordered (the reference's TestPrefetchOrdered) --------------------


class TestPrefetchOrdered:
    def test_order_and_values(self, pool_on):
        names = set()

        def mk(i):
            def t():
                names.add(threading.current_thread().name)
                time.sleep(0.002)
                return i
            return t

        assert list(scanpool.prefetch_ordered(
            [mk(i) for i in range(20)])) == list(range(20))
        assert names == {"ogt-scan-prefetch"}  # the producer ran them

    def test_producer_error_propagates(self, pool_on):
        def boom():
            raise ValueError("decode failed")

        with pytest.raises(ValueError, match="decode failed"):
            list(scanpool.prefetch_ordered([lambda: 1, boom, lambda: 3]))

    def test_early_abandon_stops_producer(self, pool_on):
        ran = []

        def mk(i):
            def t():
                ran.append(i)
                time.sleep(0.005)
                return i
            return t

        gen = scanpool.prefetch_ordered([mk(i) for i in range(100)])
        assert next(gen) == 0
        gen.close()
        time.sleep(0.2)
        assert len(ran) < 20  # the producer saw the abandon and stopped
        assert not [t for t in threading.enumerate()
                    if t.name == "ogt-scan-prefetch"]

    def test_bounded_lookahead(self, pool_on):
        ran = []
        gen = scanpool.prefetch_ordered(
            [lambda i=i: ran.append(i) or i for i in range(50)], depth=2)
        assert next(gen) == 0
        time.sleep(0.2)
        # the one yielded, two queued and one blocked on the full queue
        assert len(ran) <= 4
        assert list(gen) == list(range(1, 50))

    def test_serial_runs_inline(self, pool_on):
        with scanpool.forced_serial():
            names = [x for x in scanpool.prefetch_ordered(
                [lambda: threading.current_thread().name] * 3)]
        assert set(names) == {threading.current_thread().name}
        # one thunk never starts a producer either
        assert list(scanpool.prefetch_ordered(
            [lambda: threading.current_thread().name])) == \
            [threading.current_thread().name]


def test_workers_one_means_serial(monkeypatch):
    monkeypatch.setattr(scanpool, "WORKERS", 1)
    assert not scanpool.enabled()
    assert scanpool.pool() is None
    # still functional, inline
    assert list(scanpool.map_ordered([lambda: 5], [1])) == [5]
    assert list(scanpool.prefetch_ordered([lambda: 5, lambda: 6])) == [5, 6]


def test_forced_serial_is_thread_local(pool_on):
    seen = []
    with scanpool.forced_serial():
        assert not scanpool.enabled()
        t = threading.Thread(target=lambda: seen.append(scanpool.enabled()))
        t.start()
        t.join()
    assert seen == [True] and scanpool.enabled()


def test_est_chunk_bytes():
    class C:
        rows = 100
        cols = {"a": None, "b": None}

    assert scanpool.est_chunk_bytes(C(), None) == 100 * 9 * 4
    assert scanpool.est_chunk_bytes(C(), 1) == 100 * 9 * 3
    assert jscanpool.est_chunk_bytes(C(), 1) == 100 * 9 * 3


# -- pooled scans against serial ones and the JAX package ----------------------


def _write_multi_chunk(engines, hosts=8, points=400, flushes=4):
    """Several TSF files, packed chunks and live memtable rows: every
    source a scan decodes."""
    per = points // flushes
    for f in range(flushes):
        lines = [f"cpu,host=h{h} v={(h * 13 + p) % 37}.25,u={p % 7}i "
                 f"{(BASE + p * 5) * NS}"
                 for p in range(f * per, (f + 1) * per) for h in range(hosts)]
        for e in engines:
            e.write_lines("db", "\n".join(lines))
            e.flush_all()
    tail = "\n".join(f"cpu,host=h0 v=99.5 {(BASE + points * 5 + i) * NS}"
                     for i in range(5))
    for e in engines:  # unflushed rows in the memtable
        e.write_lines("db", tail)


def _write_weeks(engines, hosts=70, weeks=3, points=30):
    """`hosts` series in each of `weeks` weekly shards: the monolithic
    scan's bulk reads make one unit per shard."""
    for w in range(weeks):
        lines = [f"cpu,host=h{h} v={(h * 7 + p + w) % 29}.5,u={p % 5}i "
                 f"{(BASE + w * WEEK + p * 60) * NS}"
                 for p in range(points) for h in range(hosts)]
        for e in engines:
            e.write_lines("db", "\n".join(lines))
            e.flush_all()


QUERIES = [
    "SELECT mean(v), max(v), count(v) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} GROUP BY time(1m)",
    "SELECT first(v), last(v), min(v) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} GROUP BY time(2m), host",
    "SELECT count(u), sum(u) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} AND v > 10 GROUP BY time(90s)",
    "SELECT max(v) FROM cpu",  # a selector's time without GROUP BY time
    "SELECT percentile(v, 90) FROM cpu GROUP BY host",
]


def _pooled_serial_jax(pair, q):
    je, te = pair
    tx = TExecutor(te)
    pooled = tx.execute(q, db="db")
    with scanpool.forced_serial():
        serial = tx.execute(q, db="db")
    want = JExecutor(je).execute(q, db="db")
    assert "error" not in str(pooled), pooled
    assert pooled == serial, q
    _close(pooled, want)
    return pooled


@pytest.mark.parametrize("qt", QUERIES)
def test_pooled_scan_equals_serial_and_jax(pair, pool_on, qt):
    _write_multi_chunk(pair)
    q = qt.format(lo=BASE * NS, hi=(BASE + 3000) * NS)
    _pooled_serial_jax(pair, q)


@pytest.mark.parametrize("qt", QUERIES)
def test_pipelined_bulk_scan_equals_serial_and_jax(pair, pool_on, qt):
    """Three weekly shards of 70 series: their bulk reads go through
    the producer thread, and the answers stay the serial ones."""
    _write_weeks(pair)
    q = qt.format(lo=BASE * NS, hi=(BASE + 3 * WEEK) * NS).replace(
        "time(1m)", "time(1h)").replace("time(2m)", "time(6h)").replace(
        "time(90s)", "time(3h)")
    n0 = TSTATS.counters("scanpool").get("prefetched_units", 0)
    got = _pooled_serial_jax(pair, q)
    assert got["results"][0].get("series")
    # the pooled run prefetched the three units, the serial run none
    if "percentile" not in q:
        assert TSTATS.counters("scanpool")["prefetched_units"] == n0 + 3


def test_mixed_type_field_across_shards(pair, pool_on):
    """A field numeric in one shard and a string in another dispatches
    per record, as the serial path does."""
    for e in pair:
        e.write_lines("db", f"m,host=a v=1.5,w=1 {BASE * NS}")
        e.write_lines("db", f'm,host=a v="s",w=2 {(BASE + WEEK) * NS}')
        e.flush_all()
    got = _pooled_serial_jax(pair, "SELECT count(v) FROM m WHERE w > 0")
    assert got["results"][0]["series"][0]["values"][0][1] == 2


def test_high_cardinality_packed(pair, pool_on):
    lines = "\n".join(f"hc,s=s{i} v={i % 101} {(BASE + i % 50) * NS}"
                      for i in range(300))
    for e in pair:  # > PACK_MIN_SERIES series in one flush: packed chunks
        e.write_lines("db", lines)
        e.flush_all()
    _pooled_serial_jax(
        pair, f"SELECT count(v), sum(v) FROM hc WHERE time >= {BASE * NS}")


# -- KILL ------------------------------------------------------------------------


def test_kill_interrupts_prefetch_pipeline(pair, pool_on, monkeypatch):
    """KILL QUERY stops a pipelined bulk scan promptly: the kill
    surfaces from the producer thread, which ran the bulk reads, and
    the next scan answers right."""
    je, te = pair
    _write_weeks(pair, weeks=4)
    orig = TShard.read_series_bulk
    threads = []

    def slow(self, *a, **k):
        threads.append(threading.current_thread().name)
        time.sleep(0.05)
        return orig(self, *a, **k)

    stmt = texmod.parse("SELECT mean(v) FROM cpu GROUP BY time(1h)")[0]
    now = (BASE + 5 * WEEK) * NS
    qid = TRACKER.register("pipeline scan", "db")
    killed_at = {}

    def killer():
        time.sleep(0.02)
        TRACKER.kill(qid)
        killed_at["t"] = time.monotonic()

    t = threading.Thread(target=killer)
    t.start()
    try:
        monkeypatch.setattr(TShard, "read_series_bulk", slow)
        with pytest.raises(QueryKilled):
            TExecutor(te)._select(stmt, "db", now)
        t_died = time.monotonic()
    finally:
        monkeypatch.setattr(TShard, "read_series_bulk", orig)
        TRACKER.unregister(qid)
        t.join()
    assert threads and set(threads) == {"ogt-scan-prefetch"}
    assert len(threads) < 4  # died mid-pipeline, not at its end
    assert t_died - killed_at["t"] < 0.5
    time.sleep(0.1)
    assert not [x for x in threading.enumerate()
                if x.name == "ogt-scan-prefetch"]
    q = (f"SELECT mean(v), count(v) FROM cpu WHERE time >= {BASE * NS} AND "
         f"time < {now} GROUP BY time(1h)")
    _close(TExecutor(te).execute(q, db="db"),
           JExecutor(je).execute(q, db="db"))
