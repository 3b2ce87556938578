"""The port's incremental result cache (query/resultcache.py) and the
shard mutation log it keys on, against the JAX package, on the CPU.

The JAX ``Engine``/``Executor`` and the port's ``Engine(device="cpu")``/
``Executor`` take the same seeded line protocol, both with their result
caches on (the default), and every answer must be equal (floats at rel
1e-12; a cached answer equals the port's own cache-off answer bit for
bit):
- the reference's tests/test_resultcache.py cases, with the reference's
  own checks on the port's scan counters;
- writes into a cached window, and flush and compaction, which change
  the layout and not the rows, so the cache keeps serving;
- fill(previous) and fill(linear) over windows merged from the cache and
  a fresh scan;
- ``Shard.changed_since`` of both packages over the same mutation
  sequence, its truncated history included.
"""

from __future__ import annotations

import math

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import shard as jshard_mod
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import shard as tshard_mod
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040  # 1m-aligned
RANGE = f"time >= {BASE * NS} AND time < {(BASE + 600) * NS}"
Q = f"SELECT mean(v), max(v), count(v) FROM cpu WHERE {RANGE} GROUP BY time(1m), host"


def _close(a, b, path="$"):
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
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


def counter(name):
    return TSTATS.counters("executor").get(name, 0)


class Pair:
    """One JAX and one port engine over the same writes."""

    def __init__(self, root):
        self.je = JEngine(str(root / "jax"), sync_wal=False)
        self.te = TEngine(str(root / "torch"), device="cpu", sync_wal=False)
        for e in (self.je, self.te):
            e.create_database("db")
        self.jx, self.tx = JExecutor(self.je), TExecutor(self.te)

    def write(self, lines: str):
        for e in (self.je, self.te):
            e.write_lines("db", lines)

    def each(self, fn):
        for e in (self.je, self.te):
            fn(e)

    def query(self, text: str):
        """Both answers, compared; returns the port's."""
        want = self.jx.execute(text, db="db")
        got = self.tx.execute(text, db="db")
        assert "error" not in got["results"][0], got
        _close(got, want)
        return got

    def close(self):
        self.je.close()
        self.te.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    lines = []
    for t in range(600):  # 10 windows of 1m
        for h in range(4):
            lines.append(f"cpu,host=h{h} v={(h * 3 + t) % 11},iv={t % 7}i "
                         f"{(BASE + t) * NS}")
    p.write("\n".join(lines))
    yield p
    p.close()


def _cache_off(pair, text, monkeypatch):
    """The port's answer to `text` with its result cache off."""
    with monkeypatch.context() as m:
        m.setenv("OGT_RESULT_CACHE", "0")
        return TExecutor(pair.te).execute(text, db="db")


# -- the reference's cases ------------------------------------------------------


def test_repeat_query_served_from_cache(pair):
    r1 = pair.query(Q)
    hits0, rows0 = counter("inc_cache_full_hits"), counter("rows_scanned")
    r2 = pair.query(Q)
    assert r1 == r2
    assert counter("inc_cache_full_hits") == hits0 + 1
    assert counter("rows_scanned") == rows0, "a cache hit must not scan"


def test_append_invalidates_only_trailing_windows(pair, monkeypatch):
    pair.query(Q)
    pair.write("\n".join(f"cpu,host=h0 v=3 {(BASE + 599) * NS + (i + 1) * 1000}"
                         for i in range(5)))
    rows0 = counter("rows_scanned")
    r = pair.query(Q)
    scanned = counter("rows_scanned") - rows0
    # only the trailing window rescans: 60 s x 4 hosts + 5 new points
    assert 0 < scanned <= 60 * 4 + 5, scanned
    for s in r["results"][0]["series"]:
        assert s["values"][-1][3] == (65 if s["tags"]["host"] == "h0" else 60)
    assert r == _cache_off(pair, Q, monkeypatch)


QUERIES = [
    Q,
    f"SELECT sum(iv), mean(iv) FROM cpu WHERE {RANGE} GROUP BY time(2m)",
    "SELECT first(v), last(v), min(v), max(v), stddev(v), spread(v) "
    f"FROM cpu WHERE {RANGE} GROUP BY time(1m)",
    f"SELECT count(v) FROM cpu WHERE {RANGE} GROUP BY time(1m) fill(0)",
    f"SELECT mean(v) FROM cpu WHERE host = 'h1' AND {RANGE} "
    "GROUP BY time(3m) fill(previous)",
]


@pytest.mark.parametrize("text", QUERIES)
def test_results_identical_with_and_without_cache(pair, text, monkeypatch):
    """Every aggregate family: the cached second run equals a fresh run
    on a cold executor and the cache-off run, bit for bit, and the JAX
    answers."""
    warm = pair.query(text)
    cached = pair.query(text)
    fresh = TExecutor(pair.te).execute(text, db="db")
    assert warm == cached == fresh == _cache_off(pair, text, monkeypatch)


def test_mid_range_write_invalidates_that_window(pair, monkeypatch):
    r1 = pair.query(Q)
    pair.write(f"cpu,host=h2 v=100 {(BASE + 3 * 60 + 30) * NS + 7}")
    r2 = pair.query(Q)
    for s1, s2 in zip(r1["results"][0]["series"], r2["results"][0]["series"]):
        for w, (row1, row2) in enumerate(zip(s1["values"], s2["values"])):
            if w == 3 and s2["tags"]["host"] == "h2":
                assert row2[3] == row1[3] + 1
            else:
                assert row1 == row2
    assert r2 == _cache_off(pair, Q, monkeypatch)


def test_unbounded_range_and_moving_window(pair):
    """A moving dashboard range reuses the old windows' entries (same
    fingerprint, absolute window keys)."""
    pair.query(f"SELECT count(v) FROM cpu WHERE time >= {BASE * NS} "
               f"AND time < {(BASE + 300) * NS} GROUP BY time(1m)")
    rows0 = counter("rows_scanned")
    r2 = pair.query(f"SELECT count(v) FROM cpu WHERE {RANGE} GROUP BY time(1m)")
    assert counter("rows_scanned") - rows0 <= 300 * 4
    vals = r2["results"][0]["series"][0]["values"]
    assert len(vals) == 10 and all(v[1] == 240 for v in vals)


def test_concurrent_writes_never_wrong(pair):
    """Interleaved writes and queries: every answer equals a cold
    executor's at that instant."""
    for i in range(5):
        pair.write(f"cpu,host=h1 v={i} {(BASE + 120 * i + 30) * NS + i}")
        got = pair.query(Q)
        assert got == TExecutor(pair.te).execute(Q, db="db")


def test_unaligned_range_scans_only_edges(pair):
    q = (f"SELECT count(v) FROM cpu WHERE time >= {(BASE + 30) * NS} "
         f"AND time < {(BASE + 570) * NS} GROUP BY time(1m)")
    r1 = pair.query(q)
    rows0 = counter("rows_scanned")
    r2 = pair.query(q)
    scanned = counter("rows_scanned") - rows0
    assert r1 == r2
    assert 0 < scanned <= 2 * 30 * 4, scanned  # the partial edge windows


# -- flush, compaction and fills over merged windows ------------------------------


def test_flush_and_compaction_keep_the_cache(pair, monkeypatch):
    """Flush and compaction change the layout, not the rows: the cached
    windows keep serving (no scan), and a write after them still
    invalidates its window."""
    r1 = pair.query(Q)
    for step in (lambda e: e.flush_all(),
                 lambda e: [sh.compact() for sh in e._shards.values()]):
        pair.write(f"cpu,host=h3 v=1 {(BASE + 700) * NS}")  # outside Q
        pair.each(step)
        hits0, rows0 = counter("inc_cache_full_hits"), counter("rows_scanned")
        assert pair.query(Q) == r1
        assert counter("inc_cache_full_hits") == hits0 + 1
        assert counter("rows_scanned") == rows0
    pair.write(f"cpu,host=h3 v=1000 {(BASE + 10) * NS + 1}")
    pair.each(lambda e: e.flush_all())
    rows0 = counter("rows_scanned")
    r2 = pair.query(Q)
    assert 0 < counter("rows_scanned") - rows0 <= 60 * 4 + 1
    assert r2 != r1 and r2 == _cache_off(pair, Q, monkeypatch)


@pytest.mark.parametrize("fill", ["previous", "linear", "0", "null"])
def test_fill_over_merged_windows(tmp_path, fill, monkeypatch):
    """Windows with gaps, half of them from the cache and half scanned
    again after a write: the fill runs over the merged sequence."""
    p = Pair(tmp_path)
    try:
        p.write("\n".join(f"m,host=h{h} v={t % 13 + h} {(BASE + t * 30) * NS}"
                          for h in range(2) for t in range(40)
                          if (t // 4) % 3 != 1))  # every third 2 m gap
        q = (f"SELECT mean(v), max(v) FROM m WHERE time >= {BASE * NS} AND "
             f"time < {(BASE + 1200) * NS} GROUP BY time(1m), host "
             f"fill({fill})")
        p.query(q)
        p.write(f"m,host=h1 v=99 {(BASE + 610) * NS}")  # window 10 again
        got = p.query(q)
        assert got == _cache_off(p, q, monkeypatch) == TExecutor(
            p.te).execute(q, db="db")
    finally:
        p.close()


# -- the shard mutation log ---------------------------------------------------------


def test_changed_since_matches_jax(tmp_path, monkeypatch):
    """The same mutations in both packages' shards answer the same
    changed_since questions, across the truncation of the bounded log."""
    monkeypatch.setattr(jshard_mod, "_MUT_LOG_MAX", 8)
    monkeypatch.setattr(tshard_mod, "_MUT_LOG_MAX", 8)
    shards = [jshard_mod.Shard(str(tmp_path / "j"), 0, 10_000),
              tshard_mod.Shard(str(tmp_path / "t"), 0, 10_000)]
    answers = []
    for sh in shards:
        marks = [sh.data_version]
        for k in range(20):
            lo = (k * 37) % 900
            sh._note_mutation(lo, lo + 50)
            marks.append(sh.data_version)
        answers.append([sh.changed_since(marks[i], lo, lo + w)
                        for i in range(len(marks))
                        for lo in range(0, 1000, 90) for w in (1, 60)])
        sh.close()
    assert answers[0] == answers[1]
    assert any(answers[1]) and not all(answers[1])
