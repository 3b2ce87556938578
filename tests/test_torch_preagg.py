"""The port's pre-aggregation path (executor._scan_preagg) against the
JAX package, on the CPU.

Fewer than 64 series a flush (tsf.PACK_MIN_SERIES), so every chunk is a
per-series chunk with its stored (count, sum): a whole-range
count/sum/mean without a field filter adds them without a decode. Both
packages take the same seeded writes and give the same answers (INT sums
exact past 2^53, float means at rel 1e-12), and the port's own answer
equals its answer with the pre-agg path turned off. Memtable rows in the
range, chunks that overlap each other and chunks cut by the range's
edges take the decode, as in the reference; so does a flush of 64 series
or more (packed chunks).
"""

from __future__ import annotations

import math

import pytest
import torch

from opengemini_tpu.query import qhelpers as jqh
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query import executor as texmod
from opengemini_tpu_torch.query import qhelpers as tqh
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.storage import tsf as ttsf
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040
BIG = 2**47 + 1  # 180 of these sum past 2^53: a float sum would round


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


class Probe:
    """Counts the series the port's pre-agg path served and the chunks
    it decoded."""

    def __init__(self, monkeypatch):
        self.served = 0
        self.decoded = 0
        orig_pre = texmod.Executor._scan_preagg
        orig_read = ttsf.TSFReader.read_chunk

        def pre(ex, *a, **k):
            handled, rows = orig_pre(ex, *a, **k)
            self.served += handled
            return handled, rows

        def read(r, *a, **k):
            self.decoded += 1
            return orig_read(r, *a, **k)

        monkeypatch.setattr(texmod.Executor, "_scan_preagg", pre)
        monkeypatch.setattr(ttsf.TSFReader, "read_chunk", read)


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


def _write(pair, lines, flush=True):
    for e in pair:
        e.write_lines("db", "\n".join(lines))
        if flush:
            e.flush_all()


def _hours(hosts=8, hours=3, per_hour=60):
    """One flush per hour of every host: per-series chunks that do not
    overlap; `n` carries odd INT values near 2^47."""
    for h in range(hours):
        yield [f"cpu,host=h{s},dc=d{s % 2} v={(s * 7 + p) % 13 + 0.25},"
               f"n={BIG + s * 1000 + p}i {(BASE + h * 3600 + p * 60) * NS}"
               for s in range(hosts) for p in range(per_hour)]


def _no_preagg(te, q, monkeypatch):
    """The port's answer with every series sent to the decode."""
    with monkeypatch.context() as m:
        m.setattr(texmod.Executor, "_scan_preagg",
                  lambda *a, **k: (False, 0))
        return TExecutor(te).execute(q, db="db")


def _both(pair, q):
    got = TExecutor(pair[1]).execute(q, db="db")
    want = JExecutor(pair[0]).execute(q, db="db")
    assert "error" not in got["results"][0], got
    assert got["results"][0].get("series"), got
    _close(got, want)
    return got


WHOLE = f"time >= {BASE * NS} AND time < {(BASE + 3 * 3600) * NS}"
QUERIES = [
    f"SELECT count(v), sum(v), mean(v) FROM cpu WHERE {WHOLE}",
    f"SELECT count(v), mean(v) FROM cpu WHERE {WHOLE} GROUP BY host",
    f"SELECT sum(n), mean(n), count(n) FROM cpu WHERE {WHOLE} GROUP BY dc",
    f"SELECT sum(n) FROM cpu WHERE {WHOLE}",
    "SELECT count(v), sum(n) FROM cpu GROUP BY host",
    f"SELECT mean(v) FROM cpu WHERE host = 'h3' AND {WHOLE}",
]


@pytest.mark.parametrize("q", QUERIES)
def test_covered_chunks_answer_from_metadata(pair, q, monkeypatch):
    for lines in _hours():
        _write(pair, lines)
    probe = Probe(monkeypatch)
    got = _both(pair, q)
    assert probe.served > 0 and probe.decoded == 0, vars(probe)
    assert got == _no_preagg(pair[1], q, monkeypatch)


def test_int_sums_stay_exact(pair, monkeypatch):
    for lines in _hours():
        _write(pair, lines)
    probe = Probe(monkeypatch)
    got = _both(pair, f"SELECT sum(n) FROM cpu WHERE {WHOLE} GROUP BY host")
    assert probe.served == 8
    for s in got["results"][0]["series"]:
        h = int(s["tags"]["host"][1:])
        want = sum(BIG + h * 1000 + p for p in range(60)) * 3
        assert s["values"][0][1] == want  # a Python int, exact


def test_edge_chunks_decode_the_range(pair, monkeypatch):
    """A range that cuts the first and last hour: the middle hour's
    chunks answer from metadata, the cut ones decode and slice."""
    for lines in _hours():
        _write(pair, lines)
    probe = Probe(monkeypatch)
    q = (f"SELECT count(v), sum(n), mean(v) FROM cpu WHERE time >= "
         f"{(BASE + 1800) * NS} AND time < {(BASE + 9000) * NS} "
         "GROUP BY host")
    got = _both(pair, q)
    assert probe.served == 8 and probe.decoded == 16
    assert got == _no_preagg(pair[1], q, monkeypatch)


def test_memtable_overlap_forces_the_decode(pair, monkeypatch):
    for lines in _hours():
        _write(pair, lines)
    # h0 rewrites a point of its first hour in the memtable (last write
    # wins) and h1 adds one: both series need the merged decode
    _write(pair, [f"cpu,host=h0,dc=d0 v=1000.5,n=7i {BASE * NS}",
                  f"cpu,host=h1,dc=d1 v=2.0,n=9i {(BASE + 30) * NS}"],
           flush=False)
    probe = Probe(monkeypatch)
    q = f"SELECT count(v), sum(v), sum(n) FROM cpu WHERE {WHOLE} GROUP BY host"
    got = _both(pair, q)
    assert probe.served == 6  # h2..h7
    assert got == _no_preagg(pair[1], q, monkeypatch)


def test_overlapping_chunks_force_the_decode(pair, monkeypatch):
    for lines in _hours():
        _write(pair, lines)
    # an out-of-order flush into the second hour of h2: its chunks overlap
    _write(pair, [f"cpu,host=h2,dc=d0 v=5.0,n=1i {(BASE + 3600 + 90) * NS}"])
    probe = Probe(monkeypatch)
    q = f"SELECT count(v), mean(v) FROM cpu WHERE {WHOLE} GROUP BY host"
    got = _both(pair, q)
    assert probe.served == 7
    assert got == _no_preagg(pair[1], q, monkeypatch)


def test_packed_chunks_take_the_decode(pair, monkeypatch):
    """64 series or more in one flush: packed chunks, whose pre-agg is
    chunk-wide, so every series decodes."""
    _write(pair, [f"big,s=s{i} v={i % 11} {(BASE + i % 50) * NS}"
                  for i in range(ttsf.PACK_MIN_SERIES * 2)])
    probe = Probe(monkeypatch)
    _both(pair, f"SELECT count(v), sum(v) FROM big WHERE time >= {BASE * NS}"
                f" AND time < {(BASE + 60) * NS} GROUP BY s")
    assert probe.served == 0 and probe.decoded > 0


def test_needs_merged_decode_matches_jax(pair):
    for lines in _hours(hosts=4):
        _write(pair, lines)
    _write(pair, [f"cpu,host=h2,dc=d0 v=5.0,n=1i {(BASE + 3600 + 90) * NS}"])
    _write(pair, [f"cpu,host=h1,dc=d1 v=2.0,n=9i {(BASE + 30) * NS}"],
           flush=False)
    je, te = pair
    for lo, hi in ((BASE, BASE + 3 * 3600), (BASE + 1800, BASE + 2000),
                   (BASE + 4000, BASE + 4100)):
        answers = []
        for qh, e in ((jqh, je), (tqh, te)):
            (sh,) = e.shards_for_range("db", None, lo * NS, hi * NS)
            row = []
            for sid in sorted(sh.index.series_ids("cpu")):
                need, srcs = qh._series_needs_merged_decode(
                    sh, "cpu", sid, lo * NS, hi * NS)
                row.append((need, None if srcs is None else
                            [(c.tmin, c.tmax, c.rows) for _r, c in srcs]))
            answers.append(row)
        assert answers[0] == answers[1]
