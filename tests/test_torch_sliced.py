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
both packages are equal, and each slice runs its kernels before the next
one decodes.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from opengemini_tpu.query import executor as jexmod
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import executor as texmod
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000


def _close(a, b, path="$"):
    if isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
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
    """The sliced scan interleaves: decode a slice, run its aggregates,
    then the next slice, and no slice's batch outlives its turn."""
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
