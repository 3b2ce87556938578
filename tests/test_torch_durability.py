"""The port's durability ledger (storage/shard.py ``DurabilityLedger``,
the engine's ``durability_snapshot`` and ``durability_check``, the
``durability`` stats provider, /debug/ctrl?mod=durability and the query
tracker's durability section) against the JAX package, on the CPU.

The cases of the reference's tests/test_torture.py for the online ledger
run in both packages on the same writes; besides, the snapshots (every
shard's and the totals) equal the reference's after each step of one
history: line-protocol, structured and bulk writes over several shards,
a threshold flush, a restart that replays the WAL, a compaction, a
delete rewrite, a downsample rewrite (both leave their shard dirty) and
DROP SERIES.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.record import FieldType as JFT
from opengemini_tpu.server import http as jhttp
from opengemini_tpu.storage import engine as jeng
from opengemini_tpu.utils import failpoint as jfp
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.record import FieldType as TFT
from opengemini_tpu_torch.server import http as thttp
from opengemini_tpu_torch.storage import engine as teng
from opengemini_tpu_torch.utils import failpoint as tfp

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_000
DAY = 24 * 3600


class Pkg:
    def __init__(self, name, eng, ex, ft, http, fp, kw):
        self.name, self.eng, self.ex, self.ft = name, eng, ex, ft
        self.http, self.fp, self.kw = http, fp, kw

    def engine(self, root, **kw):
        return self.eng.Engine(str(root), **self.kw, **kw)


JAX = Pkg("jax", jeng, JExecutor, JFT, jhttp, jfp, {})
PORT = Pkg("torch", teng, TExecutor, TFT, thttp, tfp, {"device": "cpu"})
PKGS = (JAX, PORT)


def both(tmp_path, scenario):
    outs = [scenario(p, tmp_path / p.name) for p in PKGS]
    assert outs[1] == outs[0]
    return outs[1]


def _shard(e):
    return e.all_shards()[0]


def test_ledger_tracks_flush_and_replay(tmp_path):
    def scenario(p, root):
        out = []
        eng = p.engine(root / "d")
        eng.create_database("db")
        eng.write_lines("db", "\n".join(
            f"m,w=a v={i}i {(BASE + i) * NS}" for i in range(40)))
        snap = eng.durability_snapshot()["totals"]
        assert snap["acked"] == 40 and snap["mem_rows"] == 40
        assert snap["missing"] == 0 and not eng.durability_check()
        out.append(snap)
        eng.flush_all()
        snap = eng.durability_snapshot()["totals"]
        assert snap["published"] == 40 and snap["tsf_rows"] == 40
        assert snap["mem_rows"] == 0 and snap["missing"] == 0
        out.append(snap)
        eng.close()
        # reopened: the WAL went with the flush, nothing replays
        eng2 = p.engine(root / "d")
        snap = eng2.durability_snapshot()["totals"]
        assert snap["replayed"] == 0 and snap["missing"] == 0
        out.append(snap)
        eng2.close()
        return out

    both(tmp_path, scenario)


def test_ledger_counts_replay(tmp_path):
    def scenario(p, root):
        eng = p.engine(root / "d")
        eng.create_database("db")
        eng.write_lines("db", "\n".join(
            f"m v={i}i {(BASE + i) * NS}" for i in range(10)))
        eng.close()  # the WAL survives (no flush)
        eng2 = p.engine(root / "d")
        try:
            snap = eng2.durability_snapshot()
            t = snap["totals"]
            assert t["replayed"] == 10 and t["acked"] == 0
            assert t["mem_rows"] == 10 and t["missing"] == 0
            assert not eng2.durability_check()
            return snap
        finally:
            eng2.close()

    both(tmp_path, scenario)


def test_ledger_detects_simulated_loss(tmp_path):
    """The checker fires: acked rows credited that reach neither the
    memtable nor a file (a dropped snapshot), or a double publish."""
    def scenario(p, root):
        eng = p.engine(root / "d")
        eng.create_database("db")
        try:
            eng.write_lines("db", f"m v=1i {BASE * NS}")
            sh = _shard(eng)
            sh.ledger.acked += 5  # five phantom acknowledged rows
            bad = eng.durability_check()
            assert len(bad) == 1 and bad[0]["missing"] == 5
            sh.ledger.acked -= 5
            sh.ledger.published += 2  # a snapshot counted twice
            snap = eng.durability_snapshot()
            bad2 = eng.durability_check(snap)
            assert bad2[0]["missing"] == -2
            assert snap["totals"]["missing"] == 2  # absolute values sum
            return bad, bad2, snap
        finally:
            eng.close()

    both(tmp_path, scenario)


def test_snapshots_over_one_history(tmp_path):
    """The same history in both packages: the whole snapshot (every
    shard and the totals) equal after each step."""
    def scenario(p, root):
        snaps = []

        def take(e, what):
            snap = e.durability_snapshot()
            snaps.append((what, snap, e.durability_check(snap)))

        rng = np.random.default_rng(7)
        e = p.engine(root / "d", flush_threshold_bytes=16 << 10)
        e.create_database("db")
        e.create_retention_policy("db", "short", 30 * DAY * NS,
                                  shard_duration_ns=DAY * NS, default=True)
        lines = [f"cpu,host=h{i % 5} u={rng.random():.6f},n={i}i "
                 f"{(BASE + i * 600) * NS}" for i in range(900)]
        e.write_lines("db", "\n".join(lines[:450]))
        take(e, "lines")
        e.write_lines("db", "\n".join(lines[450:]))
        take(e, "threshold flushes")
        e.write_rows("db", [("mem", (("host", "h1"),), (BASE + i) * NS,
                             {"used": (p.ft.FLOAT, float(i))})
                            for i in range(30)])
        # a duplicate timestamp: published counts it, tsf_rows does not
        e.write_lines("db", f"cpu,host=h0 u=9,n=9i {BASE * NS}")
        take(e, "rows and a duplicate")
        e.close()
        e = p.engine(root / "d", flush_threshold_bytes=16 << 10)
        take(e, "replayed")
        e.flush_all()
        take(e, "flushed")
        for sh in e.all_shards():
            while sh.compact_level():
                pass
            sh.compact()
        take(e, "compacted")
        ex = p.ex(e)
        ex.execute(f"DELETE FROM cpu WHERE time < {(BASE + 3600 * 30) * NS}",
                   db="db", now_ns=(BASE + 10 * DAY) * NS)
        take(e, "deleted")
        ex.execute("DROP SERIES FROM mem WHERE host = 'h1'", db="db",
                   now_ns=(BASE + 10 * DAY) * NS)
        take(e, "dropped series")
        e.write_lines("db", f"cpu,host=h9 u=1,n=1i {(BASE + 7 * DAY) * NS}")
        take(e, "after")
        e.close()
        return snaps

    snaps = both(tmp_path, scenario)
    last = snaps[-1][1]
    assert last["totals"]["dirty_shards"] >= 1
    assert all(not v for _w, _s, v in snaps)


def test_downsample_rewrite_dirties_its_shard(tmp_path):
    def scenario(p, root):
        e = p.engine(root / "d")
        e.create_database("db")
        try:
            e.write_lines("db", "\n".join(
                f"m v={i} {(BASE + i) * NS}" for i in range(120)))
            before = e.durability_snapshot()
            _shard(e).rewrite_downsampled(
                60 * NS, **({"device": e.device} if p is PORT else {}))
            after = e.durability_snapshot()
            assert not before["totals"]["dirty_shards"]
            assert after["totals"]["dirty_shards"] == 1
            assert after["totals"]["missing"] == 0
            return before, after
        finally:
            e.close()

    both(tmp_path, scenario)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_debug_vars_ctrl_and_queries_expose_durability(tmp_path):
    def scenario(p, root):
        eng = p.engine(root / "d")
        eng.create_database("db")
        eng.write_lines("db", f"m v=1i {BASE * NS}")
        svc = p.http.HttpService(eng, "127.0.0.1", 0)
        svc.start()
        base = f"http://127.0.0.1:{svc.port}"
        try:
            vars_ = _get(base + "/debug/vars")
            # /debug/vars sums every live engine of the process
            assert vars_["durability"]["acked"] >= 1
            assert vars_["durability"]["missing"] == 0
            req = urllib.request.Request(base + "/debug/ctrl?mod=durability",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                ctrl = json.loads(r.read())
            assert ctrl["status"] == "ok" and ctrl["violations"] == []
            assert ctrl["durability"]["totals"]["acked"] == 1
            qsnap = _get(base + "/debug/queries")
            assert qsnap["durability"]["totals"]["acked"] == 1
            assert qsnap["queries"] == []
            _shard(eng).ledger.acked += 3
            with urllib.request.urlopen(req, timeout=30) as r:
                bad = json.loads(r.read())
            assert bad["status"] == "violated"
            return ctrl, qsnap["durability"], bad
        finally:
            svc.stop()
            eng.close()

    both(tmp_path, scenario)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_closed_engine_detaches_from_the_tracker(tmp_path, p):
    from opengemini_tpu.utils.querytracker import GLOBAL as JT
    from opengemini_tpu_torch.utils.querytracker import GLOBAL as TT

    tracker = JT if p is JAX else TT
    eng = p.engine(tmp_path / "d")
    eng.create_database("db")
    eng.write_lines("db", f"m v=1i {BASE * NS}")
    svc = p.http.HttpService(eng, "127.0.0.1", 0)
    try:
        assert tracker.full_snapshot()["durability"]["totals"]["acked"] == 1
    finally:
        svc.httpd.server_close()
        eng.close()
    assert tracker.full_snapshot()["durability"] == {}
