"""The port's compaction against the JAX package's, on the CPU.

The same seeded writes go into a root of each package (several flushes,
late rows that overlap earlier files, an overwrite); then each package
compacts its own root (``compact``, ``compact_level``,
``compact_out_of_order``, or a CompactionService tick). The two compacted
roots must hold the same files, byte for byte, give the same query
answers in either package, and each package must reopen the other's
root. Also the counterparts of tests/test_offlock_compact.py: a flush
published while a merge runs survives the swap and outranks the merged
rows, writes and reads never wait for a merge, and writers racing a
compaction loop lose no row — each held to the JAX package's result.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.record import FieldType as JFieldType
from opengemini_tpu.services.compaction import (
    CompactionService as JCompactionService,
)
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.shard import Shard as JShard
from opengemini_tpu.utils import failpoint
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.record import FieldType as TFieldType
from opengemini_tpu_torch.services.compaction import (
    CompactionService as TCompactionService,
)
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.shard import Shard as TShard
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 10**9
T0 = 1_700_000_000
NOW = (T0 + 10**5) * NS
WHERE = f"time >= {T0 * NS} AND time < {(T0 + 7200) * NS}"
QUERIES = [
    f"SELECT mean(u), max(u), count(u) FROM cpu WHERE {WHERE} "
    "GROUP BY time(5m)",
    f"SELECT mean(u), min(n) FROM cpu WHERE {WHERE} GROUP BY time(10m), host",
    f"SELECT first(u), last(u), spread(u), sum(n) FROM cpu WHERE {WHERE} "
    "GROUP BY host",
    f"SELECT count(u) FROM cpu WHERE host = 'h3' AND {WHERE}",
    f"SELECT max(r) FROM disk WHERE {WHERE} GROUP BY time(30m)",
]


def _loads(seed=3, hosts=80):
    """Line-protocol bodies, one per flush: in-order hours of `hosts`
    series (packed chunks), then late rows overlapping earlier files and
    an overwrite of one row."""
    rng = np.random.default_rng(seed)
    bodies = []
    for part in range(4):
        lines = []
        for p in range(90):
            t = (T0 + part * 900 + p * 10) * NS
            for h in range(hosts):
                lines.append(f"cpu,host=h{h} u={rng.normal():.17g},"
                             f"n={int(rng.integers(-99, 99))}i {t}")
            lines.append(f"disk,dev=d{p % 3} r={part * 1000 + p}i {t}")
        bodies.append("\n".join(lines))
    late = [f"cpu,host=h{h} u={rng.normal():.17g},n=1i "
            f"{(T0 + 5 + 60 * k) * NS}" for k in range(30) for h in (1, 3)]
    bodies.append("\n".join(late))
    bodies.append(f"cpu,host=h3 u=1234.5,n=7i {(T0 + 900) * NS}")
    return bodies


def _build(root, engine_cls, **kw):
    e = engine_cls(str(root), **kw)
    e.create_database("db")
    for body in _loads():
        e.write_lines("db", body)
        e.flush_all()
    return e


def _close(a, b, path="$"):
    """Equal, floats within rel 1e-12 (summation order)."""
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _answers(ex):
    out = [ex.execute(q, db="db", now_ns=NOW) for q in QUERIES]
    for r in out:
        assert "error" not in r["results"][0], r
        assert r["results"][0].get("series"), r
    return out


def _compact_all(e, op: str) -> int:
    n = 0
    for sh in e.all_shards():
        if op == "compact":
            n += bool(sh.compact())
        elif op == "compact_level":
            while sh.compact_level(fanout=2):
                n += 1
        elif op == "compact_out_of_order":
            while sh.has_time_overlap() and sh.compact_out_of_order(
                    max_files=3):
                n += 1
    return n


def _files(root):
    out = {}
    for d, _dirs, names in os.walk(root):
        for name in names:
            if name.endswith(".tsf"):
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = \
                        f.read()
    return out


@pytest.mark.parametrize("profile", ["0", "1"])
@pytest.mark.parametrize(
    "op", ["compact", "compact_level", "compact_out_of_order", "service"])
def test_compaction_matches_jax(tmp_path, monkeypatch, op, profile):
    monkeypatch.setenv("OGT_DEVICE_PROFILE", profile)
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je = _build(tmp_path / "jax", JEngine)
    te = _build(tmp_path / "torch", TEngine, device="cpu")
    before = _answers(TExecutor(te))
    _close(before, _answers(JExecutor(je)))
    files_before = sum(sh.file_count() for sh in te.all_shards())
    if op == "service":
        jn = JCompactionService(je, max_files=2).handle()
        tn = TCompactionService(te, max_files=2).handle()
    else:
        jn, tn = _compact_all(je, op), _compact_all(te, op)
    assert tn == jn and tn > 0
    files_after = sum(sh.file_count() for sh in te.all_shards())
    assert files_after < files_before
    assert files_after == sum(sh.file_count() for sh in je.all_shards())
    if op in ("compact", "compact_out_of_order"):
        assert not any(sh.has_time_overlap() for sh in te.all_shards())
    got = _answers(TExecutor(te))
    _close(got, before)
    _close(got, _answers(JExecutor(je)))
    je.close()
    te.close()
    # the same files, byte for byte, and no merge leftovers
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert not [n for _d, _s, names in os.walk(tmp_path / "torch")
                for n in names if n.endswith((".merge", ".tmp"))]
    # each package reopens the other's compacted root
    je2 = JEngine(str(tmp_path / "torch"))
    te2 = TEngine(str(tmp_path / "jax"), device="cpu")
    _close(_answers(JExecutor(je2)), before)
    _close(_answers(TExecutor(te2)), before)
    je2.close()
    te2.close()


def test_compaction_of_a_jax_root_removes_stale_sidecars(tmp_path):
    """The JAX package writes a text-index sidecar per file; the port's
    in-place merge must not leave the replaced path's old sidecar (it
    would describe the old file to the JAX package): the merged output's
    sidecar replaces it, equal to the one the JAX package's own merge of
    the same files writes, and a retired file's sidecar goes with it."""
    je = _build(tmp_path / "root", JEngine)
    je.close()
    import shutil

    shutil.copytree(tmp_path / "root", tmp_path / "jax")
    te = TEngine(str(tmp_path / "root"), device="cpu")
    [sh] = te.all_shards()
    assert [n for n in os.listdir(sh.path) if n.endswith(".tidx")], \
        "the JAX package wrote no sidecars"
    inode = {n: os.stat(os.path.join(sh.path, n)).st_ino
             for n in os.listdir(sh.path) if n.endswith(".tsf")}
    assert sh.compact_level(fanout=2)
    je2 = JEngine(str(tmp_path / "jax"))
    [jsh] = je2.all_shards()
    assert jsh.compact_level(fanout=2)
    names = set(os.listdir(sh.path))
    rewritten = [n for n in names if n.endswith(".tsf") and os.stat(
        os.path.join(sh.path, n)).st_ino != inode[n]]
    assert rewritten  # the in-place merge output
    for n in rewritten:
        with open(os.path.join(sh.path, n[:-4] + ".tidx")) as f:
            got = json.load(f)
        with open(os.path.join(jsh.path, n[:-4] + ".tidx")) as f:
            assert got == json.load(f)
    for n in [n for n in inode if n not in names]:
        assert n[:-4] + ".tidx" not in names
    je2.close()
    before = _answers(TExecutor(te))
    te.close()
    je2 = JEngine(str(tmp_path / "root"))
    _close(_answers(JExecutor(je2)), before)
    je2.close()


# -- off-lock merges: the counterparts of tests/test_offlock_compact.py -----


BASE = 1_700_000_000 * NS


def _pt(ftype, t, v):
    return ("m", (("host", "a"),), t, {"v": (ftype.FLOAT, v)})


def _mk_shard(shard_cls, ftype, path, n_files=3, rows_per=4):
    sh = shard_cls(str(path), BASE - NS, BASE + 10_000_000 * NS)
    for f in range(n_files):
        sh.write_points_structured(
            [_pt(ftype, BASE + (f * rows_per + k) * NS,
                 float(f * rows_per + k)) for k in range(rows_per)])
        sh.flush()
    return sh


def _series(sh):
    sid = sh.index.get_or_create("m", (("host", "a"),))
    rec = sh.read_series("m", sid)
    return {int((t - BASE) // NS): float(v)
            for t, v in zip(rec.times, rec.columns["v"].values)}


class _Parked:
    """sh.compact() on a thread, held after its merge (off both locks)
    until release(): for the JAX package at its compact-before-replace
    failpoint, for the port by holding its merge's return."""

    def __init__(self, sh, monkeypatch):
        self.out = {}
        self.go = threading.Event()
        reached = threading.Event()
        if isinstance(sh, JShard):
            failpoint.enable("compact-before-replace", "wait:swap#1")
            self._release = lambda: failpoint.set_event("swap")
            self._reached = lambda: failpoint.hits(
                "compact-before-replace") == 1
        else:
            merge = TShard._merge_readers

            def parked(readers, w, tidx):
                merge(readers, w, tidx)
                reached.set()
                assert self.go.wait(30)

            monkeypatch.setattr(TShard, "_merge_readers",
                                staticmethod(parked))
            self._release = self.go.set
            self._reached = reached.is_set

        def run():
            try:
                self.out["ok"] = sh.compact()
            except BaseException as e:  # noqa: BLE001 — read by the test
                self.out["exc"] = e

        self.th = threading.Thread(target=run, daemon=True)
        self.th.start()
        for _ in range(5000):
            if self._reached():
                break
            time.sleep(0.001)
        assert self._reached(), "compaction never reached the swap"

    def release(self):
        self._release()
        self.th.join(30)
        assert not self.th.is_alive()
        failpoint.disable_all()


SHARDS = [(JShard, JFieldType), (TShard, TFieldType)]


def test_flush_published_mid_merge_survives_the_swap(tmp_path, monkeypatch):
    got = []
    for shard_cls, ftype in SHARDS:
        path = tmp_path / shard_cls.__module__.split(".")[0]
        sh = _mk_shard(shard_cls, ftype, path)
        parked = _Parked(sh, monkeypatch)
        # a fresh row and an overwrite of a merged row, published while
        # the merge is off-lock
        sh.write_points_structured([_pt(ftype, BASE + 5 * NS, 99.0),
                                    _pt(ftype, BASE + 1000 * NS, 7.0)])
        sh.flush()
        assert sh.file_count() == 4
        parked.release()
        assert parked.out.get("ok") is True, parked.out
        assert sh.file_count() == 2  # the merged file + the mid-merge one
        assert not [f for f in os.listdir(sh.path) if f.endswith(".merge")]
        series = _series(sh)
        sh.close()
        # reopen: file order ranks the flush above the merged output
        sh2 = shard_cls(str(path), BASE - NS, BASE + 10_000_000 * NS)
        assert _series(sh2) == series
        sh2.close()
        got.append(series)
    want = {i: float(i) for i in range(12)}
    want[5] = 99.0
    want[1000] = 7.0
    assert got[0] == got[1] == want


def test_ingest_never_stalls_behind_a_parked_compaction(tmp_path,
                                                        monkeypatch):
    got = []
    for shard_cls, ftype in SHARDS:
        path = tmp_path / shard_cls.__module__.split(".")[0]
        sh = _mk_shard(shard_cls, ftype, path)
        parked = _Parked(sh, monkeypatch)
        t0 = time.perf_counter()
        sh.write_points_structured([_pt(ftype, BASE + 2000 * NS, 1.0)])
        series = _series(sh)
        elapsed = time.perf_counter() - t0
        # a write and read that waited for the merge would block until
        # release(), not return in milliseconds
        assert elapsed < 5.0
        parked.release()
        assert parked.out.get("ok") is True, parked.out
        got.append((series, _series(sh)))
        sh.close()
    assert got[0] == got[1]
    assert got[1][0][2000] == 1.0 and len(got[1][0]) == 13


def test_concurrent_writers_through_a_full_compaction(tmp_path):
    """Writers racing a compaction loop: every acked row reads back once
    afterwards, also after a reopen; the JAX package gives the same."""
    got = []
    for shard_cls, ftype in SHARDS:
        path = tmp_path / shard_cls.__module__.split(".")[0]
        sh = _mk_shard(shard_cls, ftype, path, n_files=4, rows_per=8)
        acked = {i: float(i) for i in range(32)}
        lock = threading.Lock()
        stop = threading.Event()

        def writer(k, sh=sh, ftype=ftype, acked=acked, lock=lock,
                   stop=stop):
            for i in range(200):
                if stop.is_set():
                    break
                t_idx = 10_000 + k * 1_000 + i
                sh.write_points_structured(
                    [_pt(ftype, BASE + t_idx * NS, float(t_idx))])
                with lock:
                    acked[t_idx] = float(t_idx)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        try:
            for _ in range(6):
                sh.flush()
                sh.compact()
        finally:
            stop.set()
            for t in threads:
                t.join(30)
        assert not any(t.is_alive() for t in threads)
        sh.flush()
        sh.compact()
        assert _series(sh) == acked
        sh.close()
        sh2 = shard_cls(str(path), BASE - NS, BASE + 10_000_000 * NS)
        assert _series(sh2) == acked
        sh2.close()
        got.append({k: v for k, v in acked.items() if k < 10_000})
    assert got[0] == got[1]


def test_compaction_counts_its_merges(tmp_path):
    sh = _mk_shard(TShard, TFieldType, tmp_path / "s", n_files=4)
    before = TSTATS.counters("compact").get("offlock_merges", 0)
    assert sh.compact_level(fanout=2)
    assert sh.compact()
    assert not sh.compact()  # one file left: nothing to do
    assert TSTATS.counters("compact")["offlock_merges"] == before + 2
    assert _series(sh) == {i: float(i) for i in range(16)}
    sh.close()


def test_service_compacts_on_its_tick(tmp_path, monkeypatch):
    """The service's thread merges a shard's files on its own tick; the
    answers stay the JAX package's."""
    monkeypatch.setenv("OGT_RESULT_CACHE", "0")
    je = _build(tmp_path / "jax", JEngine)
    te = _build(tmp_path / "torch", TEngine, device="cpu")
    [sh] = te.all_shards()
    before = sh.file_count()
    svc = TCompactionService(te, interval_s=0.05, max_files=2)
    svc.start()
    try:
        for _ in range(400):
            if TSTATS.counters("compaction").get("tick_ns") and \
                    sh.file_count() < before and not sh.has_time_overlap():
                break
            time.sleep(0.025)
    finally:
        svc.stop()
    assert svc._thread is None
    assert sh.file_count() < before
    _close(_answers(TExecutor(te)), _answers(JExecutor(je)))
    je.close()
    te.close()
