"""The port's window-aligned sliced scan against its single scan and the
JAX package, on the CPU.

The reference's tests/test_sliced_scan.py cases run in both packages on
the same seeded writes with both packages' slice thresholds
monkeypatched alike (``SLICE_THRESHOLD_ROWS`` 1, ``SLICE_TARGET_ROWS``
200) and the result caches off: the port's sliced answer equals its
single-scan answer bit for bit (stitching only places windows; the
mean and stddev columns, which sum in the shapes of each slice's batch,
at rel 1e-12), and the JAX package's sliced answer (floats at rel
1e-12). The slice plans of
both packages are equal. Under ``scanpool.forced_serial()`` each slice
runs its kernels before the next one decodes; with the pipeline on
(the default) each slice's kernels are dispatched (``GridBatch.prefetch``)
before the next slice's first read, and settle one slice later. The
reference's six queries and its bucketed case answer alike overlapped,
serial and in one pass, and as the JAX package does (floats within rel
1e-9, counts, ints, strings and nulls exactly). After a prefetch, a
kernel group, a selector grid or a bucketed fallback that was not
declared raises the reference's RuntimeError.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from opengemini_tpu.models import grid as jgrid
from opengemini_tpu.ops import aggregates as jaggmod
from opengemini_tpu.query import executor as jexmod
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.models import grid as tgrid
from opengemini_tpu_torch.ops import aggregates as taggmod
from opengemini_tpu_torch.query import executor as texmod
from opengemini_tpu_torch.query import offload as toffload
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import colcache as tcolcache
from opengemini_tpu_torch.storage import scanpool
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000


def _close(a, b, path="$", rtol=1e-12):
    """Floats within `rtol`; counts, ints, strings and nulls exactly."""
    if isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=rtol, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", rtol)
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", rtol)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _same(a, b):
    """Bit for bit, but for the mean and stddev columns: those sum in
    the shapes of the batches they ran in, and a slice's batch has other
    shapes than the single scan's (rel 1e-12)."""
    for ra, rb in zip(a["results"], b["results"]):
        assert ra.keys() == rb.keys()
        for sa, sb in zip(ra.get("series", []), rb.get("series", [])):
            assert {k: v for k, v in sa.items() if k != "values"} == \
                {k: v for k, v in sb.items() if k != "values"}
            loose = [i for i, c in enumerate(sa["columns"])
                     if c in ("mean", "stddev")]
            assert len(sa["values"]) == len(sb["values"])
            for x, y in zip(sa["values"], sb["values"]):
                assert [v for i, v in enumerate(x) if i not in loose] == \
                    [v for i, v in enumerate(y) if i not in loose]
                _close([x[i] for i in loose], [y[i] for i in loose])
    assert len(a["results"]) == len(b["results"])


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


def _write(engines, lines):
    for e in engines:
        e.write_lines("db", "\n".join(lines))
        e.flush_all()


def _regular(hosts=6, points=600, step_s=10):
    return [f"cpu,host=h{h} v={(h * 7 + p) % 23}.5,u={p % 11}i "
            f"{(BASE + p * step_s) * NS}"
            for h in range(hosts) for p in range(points)]


def _irregular(hosts=5, points=500):
    rng = np.random.default_rng(7)
    lines, t = [], BASE
    for _p in range(points):
        t += int(rng.integers(1, 9))  # uneven spacing: bucketed layout
        for h in range(hosts):
            if rng.random() < 0.8:
                lines.append(f"mem,host=h{h} v={float(rng.random()) * 50} "
                             f"{t * NS}")
    return lines, t


def _sliced(monkeypatch, on: bool, target: int = 200):
    for mod in (jexmod, texmod):
        monkeypatch.setattr(mod, "SLICE_THRESHOLD_ROWS",
                            1 if on else 24_000_000)
        monkeypatch.setattr(mod, "SLICE_TARGET_ROWS",
                            target if on else 2_000_000)


def _run_both(pair, q, monkeypatch, target: int = 200):
    """The port's single-scan and sliced answers and JAX's sliced one;
    asserts the port sliced."""
    je, te = pair
    mono = TExecutor(te).execute(q, db="db")
    _sliced(monkeypatch, True, target)
    n0 = TSTATS.counters("executor").get("sliced_scans", 0)
    sliced = TExecutor(te).execute(q, db="db")
    assert TSTATS.counters("executor").get("sliced_scans", 0) == n0 + 1
    want = JExecutor(je).execute(q, db="db")
    _sliced(monkeypatch, False)
    return mono, sliced, want


QUERIES = [
    "SELECT mean(v), max(v), count(v) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} GROUP BY time(1m)",
    "SELECT min(v), sum(v), spread(v), stddev(v) FROM cpu WHERE "
    "time >= {lo} AND time < {hi} GROUP BY time(2m), host",
    "SELECT first(v), last(v) FROM cpu WHERE time >= {lo} AND time < {hi} "
    "GROUP BY time(90s) fill(previous)",
    "SELECT count(u), sum(u) FROM cpu WHERE time >= {lo} AND time < {hi} "
    "GROUP BY time(1m) fill(0)",
    # partial edge windows: the range is not aligned to the interval
    "SELECT mean(v), count(v) FROM cpu WHERE time >= {lo_off} AND "
    "time < {hi_off} GROUP BY time(1m)",
    # a field filter sends row masks through the sliced path
    "SELECT mean(v), count(v) FROM cpu WHERE time >= {lo} AND "
    "time < {hi} AND v > 10 GROUP BY time(1m), host",
]


@pytest.mark.parametrize("qt", QUERIES)
def test_regular(pair, monkeypatch, qt):
    _write(pair, _regular())
    lo, hi = BASE * NS, (BASE + 6000) * NS
    q = qt.format(lo=lo, hi=hi, lo_off=lo + 37 * NS, hi_off=hi - 41 * NS)
    mono, sliced, want = _run_both(pair, q, monkeypatch)
    assert "error" not in mono["results"][0], mono
    assert mono["results"][0].get("series")
    _same(sliced, mono)
    _close(sliced, want)


def test_irregular_bucketed(pair, monkeypatch):
    lines, t_end = _irregular()
    _write(pair, lines)
    q = (f"SELECT mean(v), count(v), max(v) FROM mem WHERE "
         f"time >= {BASE * NS} AND time < {(t_end + 1) * NS} "
         "GROUP BY time(30s), host")
    mono, sliced, want = _run_both(pair, q, monkeypatch)
    _same(sliced, mono)
    _close(sliced, want)


def test_memtable_rows_included(pair, monkeypatch):
    _write(pair, _regular(hosts=2, points=100))
    for e in pair:  # unflushed rows live only in the memtable
        e.write_lines("db", "\n".join(
            f"cpu,host=h0 v=99.5 {(BASE + 995 + i) * NS}" for i in range(5)))
    q = (f"SELECT mean(v), count(v), max(v) FROM cpu WHERE time >= "
         f"{BASE * NS} AND time < {(BASE + 1100) * NS} GROUP BY time(1m)")
    mono, sliced, want = _run_both(pair, q, monkeypatch, target=40)
    _same(sliced, mono)
    _close(sliced, want)


def test_slice_plan_without_shards_is_none():
    args = ([], "cpu", [], BASE * NS, 60 * NS, 100, BASE * NS,
            (BASE + 6000) * NS)
    assert texmod._plan_scan_slices(*args) is None
    assert jexmod._plan_scan_slices(*args) is None


@pytest.mark.parametrize("threshold,target,sliced", [
    (1, 200, True), (1, 5000, False), (3000, 200, True), (4000, 200, False)])
def test_slice_plans_match_jax(pair, monkeypatch, threshold, target, sliced):
    """The same chunk metadata and constants give the same plan (or
    none), over files and the memtable."""
    je, te = pair
    _write(pair, _regular())
    for e in pair:
        e.write_lines("db", f"cpu,host=h9 v=1 {(BASE + 5000) * NS}")
    for mod in (jexmod, texmod):
        monkeypatch.setattr(mod, "SLICE_THRESHOLD_ROWS", threshold)
        monkeypatch.setattr(mod, "SLICE_TARGET_ROWS", target)
    lo, hi = BASE * NS + 7, (BASE + 6000) * NS
    plans = []
    for mod, e in ((jexmod, je), (texmod, te)):
        shards = e.shards_for_range("db", None, lo, hi)
        plans.append(mod._plan_scan_slices(shards, "cpu", [], BASE * NS,
                                           60 * NS, 100, lo, hi))
    assert plans[0] == plans[1]
    assert (plans[1] is not None) == sliced


def test_each_slice_runs_before_the_next_decodes(pair, monkeypatch):
    """Under forced_serial the sliced scan interleaves: decode a slice,
    run its aggregates, then the next slice, and no slice's batch
    outlives its turn."""
    _write(pair, _regular())
    _sliced(monkeypatch, True)
    events = []
    orig_scan = texmod.Executor._scan_monolithic
    orig_run = texmod._grid.GridBatch.run

    def scan(self, *a, **k):
        events.append("decode")
        return orig_scan(self, *a, **k)

    def run(self, *a, **k):
        events.append("run")
        return orig_run(self, *a, **k)

    monkeypatch.setattr(texmod.Executor, "_scan_monolithic", scan)
    monkeypatch.setattr(texmod._grid.GridBatch, "run", run)
    q = (f"SELECT mean(v), max(v) FROM cpu WHERE time >= {BASE * NS} AND "
         f"time < {(BASE + 6000) * NS} GROUP BY time(1m)")
    with scanpool.forced_serial():
        TExecutor(pair[1]).execute(q, db="db")
    assert events[0] == "decode" and events.count("decode") > 2
    # two aggregates per slice, each slice's pair right after its decode
    assert events == ["decode", "run", "run"] * events.count("decode")


def test_sliced_layout_reported(pair, monkeypatch):
    _write(pair, _regular())
    _sliced(monkeypatch, True)
    q = (f"EXPLAIN ANALYZE SELECT mean(v) FROM cpu WHERE time >= {BASE * NS} "
         f"AND time < {(BASE + 6000) * NS} GROUP BY time(1m)")
    for ex in (JExecutor(pair[0]), TExecutor(pair[1])):
        txt = json.dumps(ex.execute(q, db="db"))
        assert "sliced[" in txt and "slices: " in txt, txt[:500]


def test_sliced_with_the_result_cache(pair, monkeypatch):
    """With the cache on, a sliced first run fills it and the repeat is a
    full hit with the same answer as JAX's."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "1")
    _write(pair, _regular())
    _sliced(monkeypatch, True)
    q = (f"SELECT mean(v), count(v) FROM cpu WHERE time >= {BASE * NS} AND "
         f"time < {(BASE + 6000) * NS} GROUP BY time(1m), host")
    jx, tx = JExecutor(pair[0]), TExecutor(pair[1])
    first = tx.execute(q, db="db")
    # 101 windows, the two partial edges always scanned again
    reused0 = TSTATS.counters("executor").get("inc_cache_windows_reused", 0)
    assert tx.execute(q, db="db") == first
    assert TSTATS.counters("executor").get(
        "inc_cache_windows_reused", 0) == reused0 + 99
    jx.execute(q, db="db")
    _close(first, jx.execute(q, db="db"))


# -- the pipeline: dispatch-ahead, its serial switch, one pass -----------------

# the pipeline's answers against the JAX package's: floats within this,
# everything else exactly
RTOL_PIPE = 1e-9


def _close_pipe(a, b):
    _close(a, b, rtol=RTOL_PIPE)


@pytest.fixture
def pool_on(monkeypatch):
    """The scan pool, and so the bulk reads' producer, live whatever
    the cores."""
    monkeypatch.setattr(scanpool, "WORKERS", 4)
    monkeypatch.setattr(scanpool, "_pool", None)
    yield
    pool = scanpool._pool
    monkeypatch.setattr(scanpool, "_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


def _ahead():
    return TSTATS.counters("executor").get("sliced_dispatched_ahead", 0)


def _three_ways(pair, q, monkeypatch, target=200):
    """(overlapped, serial, one pass, JAX sliced) answers of `q`, the
    port's three through its Executor; asserts both port runs sliced
    alike and that every slice but the last whose grid took it went
    ahead of the next slice's decode in the overlapped run, none in the
    serial one. Returns also the slices and the grid-laid ones."""
    je, te = pair
    mono = TExecutor(te).execute(q, db="db")
    _sliced(monkeypatch, True, target)
    outs = []
    orig = texmod.Executor._scan_sliced

    def sliced(self, *a):
        rows, out = orig(self, *a)
        outs.append(out)
        return rows, out

    monkeypatch.setattr(texmod.Executor, "_scan_sliced", sliced)
    a0 = _ahead()
    overlapped = TExecutor(te).execute(q, db="db")
    ahead = _ahead() - a0
    with scanpool.forced_serial():
        serial = TExecutor(te).execute(q, db="db")
    assert _ahead() - a0 == ahead  # the serial run dispatched none ahead
    want = JExecutor(je).execute(q, db="db")
    _sliced(monkeypatch, False)
    layouts = [[lay for _n, lay in info.values()]
               for _w0, _ws, _o, info in outs[0]]
    assert layouts == [[lay for _n, lay in info.values()]
                       for _w0, _ws, _o, info in outs[1]]
    grid = [i for i, lay in enumerate(layouts) if "grid" in lay]
    assert ahead == len([i for i in grid if i < len(layouts) - 1])
    return overlapped, serial, mono, want, len(layouts), len(grid)


@pytest.mark.parametrize("qt", QUERIES)
def test_overlap_serial_and_one_pass_match_jax(pair, pool_on, monkeypatch,
                                               qt):
    _write(pair, _regular())
    lo, hi = BASE * NS, (BASE + 6000) * NS
    q = qt.format(lo=lo, hi=hi, lo_off=lo + 37 * NS, hi_off=hi - 41 * NS)
    overlapped, serial, mono, want, slices, grid = _three_ways(
        pair, q, monkeypatch)
    assert "error" not in json.dumps(overlapped), overlapped
    assert overlapped["results"][0].get("series")
    # the same batches and kernels, only dispatched earlier
    assert overlapped == serial
    for got in (overlapped, serial, mono):
        _close_pipe(got, want)
    assert slices > 2
    if "sum(u)" not in q:  # int sums take the host's exact batch
        # the partial first window refuses the grid, the rest take it
        assert grid >= slices - 1


def test_overlap_irregular_bucketed_matches_jax(pair, pool_on, monkeypatch):
    """Uneven spacing: the slices whose grid refuses run their bucketed
    batches at their settle, the others go ahead, the answers stay."""
    lines, t_end = _irregular()
    _write(pair, lines)
    q = (f"SELECT mean(v), count(v), max(v) FROM mem WHERE "
         f"time >= {BASE * NS} AND time < {(t_end + 1) * NS} "
         "GROUP BY time(30s), host")
    overlapped, serial, mono, want, slices, grid = _three_ways(
        pair, q, monkeypatch)
    assert overlapped == serial
    for got in (overlapped, serial, mono):
        _close_pipe(got, want)
    assert slices > 2


def test_one_scan_worker_still_dispatches_ahead(pair, monkeypatch):
    """The dispatch-ahead needs no host thread: with a one-worker decode
    pool (a one-core host) the slices still go ahead, and only
    ``forced_serial()`` turns that off."""
    monkeypatch.setattr(scanpool, "WORKERS", 1)
    assert not scanpool.enabled()
    _write(pair, _regular())
    lo, hi = BASE * NS, (BASE + 6000) * NS
    q = QUERIES[0].format(lo=lo, hi=hi, lo_off=lo + 37 * NS,
                          hi_off=hi - 41 * NS)
    overlapped, serial, mono, want, slices, grid = _three_ways(
        pair, q, monkeypatch)
    assert grid >= slices - 1 > 1
    assert overlapped == serial
    for got in (overlapped, serial, mono):
        _close_pipe(got, want)


def test_slice_kernels_dispatch_before_the_next_slice_reads(
        pair, pool_on, monkeypatch):
    """With the pipeline on, slice k's kernel launches all come before
    slice k+1's first bulk read, and slice k's aggregates settle (run)
    only after slice k+1's launches: one slice of lag."""
    _write(pair, _regular(hosts=70, points=300))
    _sliced(monkeypatch, True, target=2500)
    events = []
    orig_read = TShard.read_series_bulk
    orig_launch = tgrid.GridBatch._launch
    orig_run = tgrid.GridBatch.run
    seq = iter(range(10**6))

    def tag(batch):  # a batch's number (an id() may be reused)
        if not hasattr(batch, "_order_tag"):
            batch._order_tag = next(seq)
        return batch._order_tag

    def read(self, *a, **k):
        events.append("read")
        return orig_read(self, *a, **k)

    def launch(self, kind, *a, **k):
        events.append(("launch", tag(self)))
        return orig_launch(self, kind, *a, **k)

    def run(self, *a, **k):
        events.append(("run", tag(self)))
        return orig_run(self, *a, **k)

    monkeypatch.setattr(TShard, "read_series_bulk", read)
    monkeypatch.setattr(tgrid.GridBatch, "_launch", launch)
    monkeypatch.setattr(tgrid.GridBatch, "run", run)
    # minute-aligned: every slice's windows are whole, the grid takes all
    lo = (BASE + 40) * NS
    q = (f"SELECT mean(v), max(v) FROM cpu WHERE time >= {lo} AND "
         f"time < {lo + 2880 * NS} GROUP BY time(1m)")
    got = TExecutor(pair[1]).execute(q, db="db")
    want = JExecutor(pair[0]).execute(q, db="db")
    _close_pipe(got, want)
    reads = [i for i, e in enumerate(events) if e == "read"]
    assert len(reads) > 2
    # slice k: the events from its read to the next slice's read
    bounds = reads + [len(events)]
    slices = [events[bounds[i]:bounds[i + 1]] for i in range(len(reads))]
    batch = [s[1][1] for s in slices]  # the batch each slice launched
    for k, sl in enumerate(slices):
        assert sl[1] == ("launch", batch[k]), sl  # one basic launch
        # before slice k+1's first read: no other launch of slice k
        assert [e for e in events[bounds[k + 1]:]
                if e == ("launch", batch[k])] == []
        # slice k-1's two aggregates settle right after slice k's
        # launch; the last slice's own settle after the loop
        want = [("run", batch[k - 1])] * 2 if k else []
        if k == len(slices) - 1:
            want += [("run", batch[k])] * 2
        assert sl[2:] == want, sl


def _fused():
    return TSTATS.counters("executor").get("grid_decode_fused", 0)


def test_cold_encoded_slices_decode_from_prefetch(pair, pool_on,
                                                  monkeypatch):
    """A cold scan of device-decodable blocks (the decoded-column cache
    off, the offload planner on its static gates): ten minutes a flush,
    so each ten-minute slice reads whole chunks, and each slice's fused
    decode (kernels 5 and 4, then kernel 3) dispatches from prefetch,
    once a slice as the serial sliced scan runs it from run; the answers
    stay."""
    monkeypatch.setenv("OGT_DEVICE_PROFILE", "1")
    lo = BASE + 40  # minute-aligned
    for k in range(4):
        _write(pair, [f"cpu,host=h{h} v={(h * 7 + p) % 23}.5 "
                      f"{(lo + k * 600 + p * 10) * NS}"
                      for h in range(70) for p in range(60)])
    q = (f"SELECT mean(v), max(v), count(v) FROM cpu WHERE "
         f"time >= {lo * NS} AND time < {(lo + 2400) * NS} GROUP BY time(1m)")
    cc = tcolcache.GLOBAL
    saved, planner = cc.config(), toffload.enabled()
    cc.configure(budget_mb=0)
    toffload.set_enabled(False)
    try:
        mono = TExecutor(pair[1]).execute(q, db="db")
        _sliced(monkeypatch, True, target=70 * 60)
        in_prefetch = []
        orig = tgrid.GridBatch.prefetch

        def prefetch(self, *a, **k):
            f0 = _fused()
            got = orig(self, *a, **k)
            in_prefetch.append(_fused() - f0)
            return got

        monkeypatch.setattr(tgrid.GridBatch, "prefetch", prefetch)
        f0, a0 = _fused(), _ahead()
        overlapped = TExecutor(pair[1]).execute(q, db="db")
        f1, a1 = _fused(), _ahead()
        with scanpool.forced_serial():
            serial = TExecutor(pair[1]).execute(q, db="db")
        f2 = _fused()
        want = JExecutor(pair[0]).execute(q, db="db")
    finally:
        cc.configure(**saved)
        toffload.set_enabled(planner)
    assert len(in_prefetch) == 4 and a1 - a0 == 3
    assert in_prefetch == [1] * 4
    assert f1 - f0 == f2 - f1 == 4
    assert overlapped == serial
    for got in (overlapped, serial, mono):
        _close_pipe(got, want)


# -- GridBatch.prefetch on its own ---------------------------------------------


def _grid_rows(S=6, W=7, k=3, every=30, groups=3, seed=11):
    """S series at one stride (k samples a window) over W windows, in
    `groups` groups: (adds, num_segments)."""
    rng = np.random.default_rng(seed)
    dt = every // k
    adds = []
    for s in range(S):
        rel = np.arange(W * k, dtype=np.int64) * dt
        seg = (s % groups) * W + rel // every
        vals = np.round(rng.random(W * k) * 8) / 2
        mask = rng.random(W * k) > 0.15
        adds.append((vals, rel, seg, mask, rel + 1_000, s))
    return adds, groups * W


def _batches(adds, W=7, every=30):
    t = tgrid.GridBatch(np.float64, W, every, torch.device("cpu"))
    j = jgrid.GridBatch(np.float64, W, every)
    for v, r, s, m, times, sid in adds:
        t.add(v, r, s, m, times, sids=sid)
        j.add(v, r, s, m, times, sids=sid)
    return t, j


GRID_DECLARED = ("count", "sum", "mean", "min", "max", "spread", "stddev",
                 "first", "last")


def test_prefetch_then_run_equals_run_and_jax():
    adds, nseg = _grid_rows()
    plain, _ = _batches(adds)
    t, j = _batches(adds)
    assert t.prefetch(nseg, GRID_DECLARED) is True
    assert set(t._pending) == {"basic", "ssd", "selectors"}
    j.prefetch(nseg, GRID_DECLARED)
    assert t._vals is None and t._state["dev"] is None
    assert t._state["arrays"] is None and t._state["flat"] is None
    for name in GRID_DECLARED:
        o, _sel, c = t.run(taggmod.get(name), nseg, want_sel=False)
        po, _psel, pc = plain.run(taggmod.get(name), nseg, want_sel=False)
        jo, _jsel, jc = j.run(jaggmod.get(name), nseg, want_sel=False)
        assert np.array_equal(c, pc) and np.array_equal(c, np.asarray(jc))
        assert np.array_equal(o, po, equal_nan=True), name
        np.testing.assert_allclose(o, np.asarray(jo), rtol=RTOL_PIPE,
                                   atol=0, equal_nan=True, err_msg=name)
    assert t._pending == {}
    assert t.layout_name() == "grid"


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_prefetch_guards_raise_as_the_reference(pkg):
    adds, nseg = _grid_rows()
    b = _batches(adds)[0 if pkg == "torch" else 1]
    agg = taggmod if pkg == "torch" else jaggmod
    assert b.prefetch(nseg, ("mean", "max")) in (True, None)
    b.run(agg.get("mean"), nseg, want_sel=False)
    with pytest.raises(RuntimeError, match="grid kernel 'selectors' needed "
                       "after prefetch dropped the host arrays"):
        b.run(agg.get("first"), nseg)
    with pytest.raises(RuntimeError, match="bucketed fallback requested "
                       "after prefetch"):
        b.host_value_multiset(nseg)
    with pytest.raises(RuntimeError, match="bucketed fallback requested "
                       "after prefetch"):
        b.run(agg.get("median"), nseg)


def test_prefetch_selector_grid_guard_with_the_device_tier():
    """With the device tier retaining the grid, an undeclared kernel
    group still launches from it, but the selector index grid needs the
    dropped scatter slots: the reference's RuntimeError."""
    adds, nseg = _grid_rows()
    cc = tcolcache.GLOBAL
    saved = cc.config()
    cc.configure(device=True, device_budget_mb=64)
    try:
        b, _ = _batches(adds)
        b.device_cache_token = "prefetch-guard"
        assert b.prefetch(nseg, ("mean",))
        assert b._state["dev"] is not None  # the tier's tensors
        plain, _ = _batches(adds)
        o, _s, _c = b.run(taggmod.get("stddev"), nseg)  # not declared
        po, _ps, _pc = plain.run(taggmod.get("stddev"), nseg)
        assert np.array_equal(o, po, equal_nan=True)
        with pytest.raises(RuntimeError, match="selector index grid needed "
                           "after prefetch dropped the host rows"):
            b.run(taggmod.get("last"), nseg)
    finally:
        cc.configure(**saved)


def test_prefetch_is_a_noop_where_the_reference_is():
    adds, nseg = _grid_rows()
    # an aggregate outside GRID_AGGS is coming: the rows stay
    t, _ = _batches(adds)
    assert t.prefetch(nseg, ("mean", "median")) is False
    assert t._pending == {} and t._vals is not None
    plain, _ = _batches(adds)
    o, _s, _c = t.run(taggmod.get("mean"), nseg)
    assert np.array_equal(o, plain.run(taggmod.get("mean"), nseg)[0])
    # the grid refuses (a duplicated time inside a run): the bucketed
    # fallback keeps its rows
    bad = [(v, np.where(np.arange(len(r)) == 2, r[1], r), s, m, tt, sid)
           for v, r, s, m, tt, sid in adds]
    t, _ = _batches(bad)
    assert t.prefetch(nseg, ("mean",)) is False
    assert t.layout_name() == "grid->bucketed"
    t.run(taggmod.get("mean"), nseg)
    # the batches without a grid have no prefetch at all
    from opengemini_tpu_torch.models import ragged

    assert not hasattr(ragged.BucketedBatch(np.float64, "cpu"), "prefetch")
    assert not hasattr(ragged.IntExactBatch(), "prefetch")
