"""The port's batch classes (opengemini_tpu_torch/models) against the JAX
package's on the same add() inputs, on the CPU: BucketedBatch, GridBatch
(regular data, and irregular data that must fall back to buckets) and
AggBatch, with equal layout_name() and the same grid counters.

Counts, min/max/spread/first/last values and every selector index must
match exactly; sum, mean and stddev within rtol 1e-12 (summation order).
"""

import numpy as np
import pytest
import torch

from opengemini_tpu.models import grid as jgrid
from opengemini_tpu.models import ragged as jragged
from opengemini_tpu.models import templates as jtemplates
from opengemini_tpu.ops import aggregates as jagg
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.models import grid as tgrid
from opengemini_tpu_torch.models import ragged as tragged
from opengemini_tpu_torch.models import templates as ttemplates
from opengemini_tpu_torch.ops import aggregates as tagg
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS


def _stat(key: str) -> int:
    """A port counter by its "module/name" key."""
    module, name = key.split("/", 1)
    return TSTATS.counters(module).get(name, 0)


torch.set_num_threads(1)

NS = 1_000_000_000
EVERY = 60 * NS
DT = 10 * NS
CPU = torch.device("cpu")
EXACT = {"count", "min", "max", "first", "last", "spread"}


def _ragged_chunks(rng, num_segments, sizes):
    """Per-segment ragged chunks: (vals, rel, seg, mask, times)."""
    out = []
    for s, n in enumerate(sizes):
        rel = np.sort(rng.integers(0, 2**36, n)).astype(np.int64)
        rel[: n // 3] = rel[0]  # exact time ties
        vals = np.floor(rng.normal(size=n) * 4)  # value ties
        mask = rng.random(n) > 0.2
        seg = np.full(n, s % num_segments, np.int64)
        out.append((vals, rel, seg, mask, rel + 1_700_000_000 * NS))
    return out


def _assert_run(name, got, want):
    g_out, g_sel, g_cnt = got
    w_out, w_sel, w_cnt = want
    np.testing.assert_array_equal(g_cnt, w_cnt, err_msg=f"{name} counts")
    present = w_cnt > 0
    a = np.asarray(g_out, np.float64)[present]
    b = np.asarray(w_out, np.float64)[present]
    if name in EXACT:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)
    assert (g_sel is None) == (w_sel is None), name
    if w_sel is not None:
        np.testing.assert_array_equal(np.asarray(g_sel)[present],
                                      np.asarray(w_sel)[present],
                                      err_msg=f"{name} sel")


@pytest.mark.parametrize("sizes", [
    [3, 17, 60, 200, 1, 900],           # every width of the ladder
    [2500, 40, 1030, 7],                # segments split into sub-rows
])
def test_bucketed_batch_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes) * 31 + sizes[0])
    num_segments = len(sizes) + 2  # two empty segments
    jb = jragged.BucketedBatch(np.float64)
    tb = tragged.BucketedBatch(np.float64, CPU)
    for vals, rel, seg, mask, times in _ragged_chunks(rng, num_segments, sizes):
        jb.add(vals, rel, seg, mask, times)
        tb.add(vals, rel, seg, mask, times)
    for name in sorted(jragged.DENSE_AGGS):
        _assert_run(name, tb.run(tagg.get(name), num_segments),
                    jb.run(jagg.get(name), num_segments))
    assert tb.layout_name() == jb.layout_name() == "bucketed"
    np.testing.assert_array_equal(tb.host_times(), jb.host_times())


def _regular_chunks(rng, n_series=7, groups=3, W=5, gap=False):
    chunks = []
    for s in range(n_series):
        gid = s % groups
        start_w = int(rng.integers(0, 2))
        n = (W - start_w) * (EVERY // DT)
        rel = start_w * EVERY + DT * np.arange(n, dtype=np.int64)
        if gap:
            keep = rng.random(n) > 0.3
            keep[0] = True
            rel = rel[keep]
            n = len(rel)
        vals = np.floor(rng.normal(size=n) * 10)
        mask = rng.random(n) > 0.15
        seg = (gid * W + rel // EVERY).astype(np.int64)
        chunks.append((vals, rel, seg, mask, rel + 1_700_000_000 * NS, s))
    return chunks


def _grid_pair(chunks, W):
    jb = jgrid.GridBatch(np.float64, W, EVERY)
    tb = tgrid.GridBatch(np.float64, W, EVERY, CPU)
    for vals, rel, seg, mask, times, sid in chunks:
        jb.add(vals, rel, seg, mask, times, sids=sid)
        tb.add(vals, rel, seg, mask, times, sids=sid)
    return jb, tb


def _grid_counters():
    j = JSTATS.snapshot().get("executor", {})
    return ((j.get("grid_batches", 0), j.get("grid_fallbacks", 0)),
            (_stat("executor/grid_batches"),
             _stat("executor/grid_fallbacks")))


@pytest.mark.parametrize("gap", [False, True])
def test_grid_batch_regular_matches_jax(gap):
    rng = np.random.default_rng(7 if gap else 8)
    W, groups = 5, 3
    num_segments = groups * W
    before = _grid_counters()
    for name in sorted(jgrid.GRID_AGGS):
        jb, tb = _grid_pair(_regular_chunks(rng, groups=groups, W=W,
                                            gap=gap), W)
        for want_sel in (False, True):
            _assert_run(name,
                        tb.run(tagg.get(name), num_segments,
                               want_sel=want_sel),
                        jb.run(jagg.get(name), num_segments,
                               want_sel=want_sel))
        assert tb.layout_name() == jb.layout_name() == "grid"
    after = _grid_counters()
    n = len(jgrid.GRID_AGGS)
    assert after[0][0] - before[0][0] == n and after[1][0] - before[1][0] == n
    assert after[0][1] == before[0][1] and after[1][1] == before[1][1]


def test_grid_batch_irregular_falls_back_like_jax():
    rng = np.random.default_rng(9)
    W, groups = 5, 2
    chunks = _regular_chunks(rng, n_series=4, groups=groups, W=W)
    vals, rel, seg, mask, times, sid = chunks[0]
    rel = rel.copy()
    rel[3] = rel[2]  # a duplicate time inside a run: not stride-regular
    chunks[0] = (vals, rel, seg, mask, rel + 1_700_000_000 * NS, sid)
    before = _grid_counters()
    jb, tb = _grid_pair(chunks, W)
    for name in ("mean", "max", "stddev", "first"):
        _assert_run(name, tb.run(tagg.get(name), groups * W),
                    jb.run(jagg.get(name), groups * W))
    assert tb.layout_name() == jb.layout_name() == "grid->bucketed"
    after = _grid_counters()
    assert after[0][1] - before[0][1] == 1 and after[1][1] - before[1][1] == 1
    assert after[0][0] == before[0][0] and after[1][0] == before[1][0]


@pytest.mark.parametrize("name,params", [
    ("median", ()), ("percentile", (90.0,)), ("count_distinct", ()),
    ("sum", ()), ("mean", ()), ("count", ()), ("stddev", ()),
    ("min", ()), ("max", ()), ("first", ()), ("last", ()), ("spread", ()),
])
def test_agg_batch_matches_jax(name, params):
    rng = np.random.default_rng(11)
    num_segments = 6
    jb = jtemplates.AggBatch(np.float64)
    tb = ttemplates.AggBatch(np.float64, CPU)
    for vals, rel, seg, mask, times in _ragged_chunks(
            rng, num_segments, [5, 40, 1, 77, 12]):
        jb.add(vals, rel, seg, mask, times)
        tb.add(vals, rel, seg, mask, times)
    got = tb.run(tagg.get(name), num_segments, params)
    want = jb.run(jagg.get(name), num_segments, params)
    _assert_run(name if name not in ("median", "percentile",
                                     "count_distinct") else "count",
                got, want)
    assert tb.layout_name() == jb.layout_name() == "scatter"


def test_int_exact_batch_matches_jax():
    rng = np.random.default_rng(12)
    jb, tb = jragged.IntExactBatch(), tragged.IntExactBatch()
    vals = rng.integers(-2**60, 2**60, 50)
    seg = rng.integers(0, 4, 50)
    mask = rng.random(50) > 0.3
    for b in (jb, tb):
        b.add(vals, seg * 0, seg, mask, seg * 0)
    for name in ("sum", "count", "mean"):
        g, w = tb.run(tagg.get(name), 4), jb.run(jagg.get(name), 4)
        np.testing.assert_array_equal(g[0], w[0], err_msg=name)
        np.testing.assert_array_equal(g[2], w[2], err_msg=name)
