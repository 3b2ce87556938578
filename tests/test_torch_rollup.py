"""The port's materialized rollups (storage/rollup.py, query/rollupplan.py,
services/rollup.py, /debug/ctrl?mod=rollup) against the JAX package, on
the CPU.

Every case of the reference's tests/test_rollup.py runs in both packages
on the same seeded writes: the JAX ``Engine``/``Executor`` and the port's
``Engine(device="cpu")``/``Executor``. Each package is held to the
reference test's own checks (the spliced answer equals that package's
unspliced answer, byte for byte as JSON; fold counts, watermarks, dirty
sets, counters), and the port's answers, fold counts, statuses and state
files equal the JAX package's (counts, extremes and first/last exact;
means and sums at rel 1e-12). Besides: a root written by either package,
with a spec, a folded watermark and a dirty window, reopens in the other
with the same state and answers.

The reference's ``test_service_ticks_and_tenant_charges`` depends on
order or time in the reference; the port is held to the contract the
test states (one governed tick folds the four closed windows and charges
them to the tenant), with an explicit ``now``.
"""

from __future__ import annotations

import base64
import json
import math
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.server.http import HttpService as JHttp
from opengemini_tpu.services.rollup import RollupService as JRollupService
from opengemini_tpu.storage import rollup as jrollup
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu.storage.engine import WriteError as JWriteError
from opengemini_tpu.utils import failpoint as jfp
from opengemini_tpu.utils.governor import GOVERNOR as JGOV
from opengemini_tpu.utils.stats import GLOBAL as JSTATS
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.server.http import HttpService as THttp
from opengemini_tpu_torch.services.rollup import RollupService as TRollupService
from opengemini_tpu_torch.storage import rollup as trollup
from opengemini_tpu_torch.storage.engine import Engine as TEngine
from opengemini_tpu_torch.storage.engine import WriteError as TWriteError
from opengemini_tpu_torch.utils import failpoint as tfp
from opengemini_tpu_torch.utils.governor import GOVERNOR as TGOV
from opengemini_tpu_torch.utils.stats import GLOBAL as TSTATS

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040  # minute-aligned

QUERY = (
    "SELECT mean(v), sum(v), count(v), min(f), max(f), percentile(f, 90) "
    "FROM cpu WHERE time >= {lo} AND time < {hi} GROUP BY time(1m), host"
)


class Pkg:
    def __init__(self, name, engine_cls, executor_cls, rollup, fp, stats,
                 service_cls, governor, http_cls, write_error, engine_kw):
        self.name = name
        self.engine_cls = engine_cls
        self.executor_cls = executor_cls
        self.rollup = rollup
        self.fp = fp
        self.stats = stats
        self.service_cls = service_cls
        self.governor = governor
        self.http_cls = http_cls
        self.write_error = write_error
        self.engine_kw = engine_kw

    def engine(self, root):
        return self.engine_cls(str(root), **self.engine_kw)


JAX = Pkg("jax", JEngine, JExecutor, jrollup, jfp, JSTATS, JRollupService,
          JGOV, JHttp, JWriteError, {})
PORT = Pkg("torch", TEngine, TExecutor, trollup, tfp, TSTATS,
           TRollupService, TGOV, THttp, TWriteError, {"device": "cpu"})
PKGS = (JAX, PORT)


def _close(a, b, path="$"):
    """Equal, floats at rel 1e-12 (a mean or a sum may differ in its
    last bits between the two packages' reduction orders)."""
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    for p in PKGS:
        p.fp.disable_all()


def both(tmp_path, scenario):
    """Run `scenario(pkg, root)` in both packages; the port's outcome
    equals the JAX package's."""
    outs = [scenario(p, tmp_path / p.name) for p in PKGS]
    _close(outs[1], outs[0])
    return outs[1]


def open_db(p, root):
    e = p.engine(root)
    e.create_database("db")
    return e


def declare(p, e, name="cpu_1m", mst="cpu", every_s=60, **kw):
    spec = p.rollup.RollupSpec(name, mst, every_s * NS, **kw)
    e.create_rollup("db", spec)
    return spec


def write_series(e, n=600, step_s=2, base=BASE, mst="cpu", hosts=3):
    e.write_lines("db", "\n".join(
        f"{mst},host=h{i % hosts} v={i}i,f={float(i % 7)} "
        f"{(base + i * step_s) * NS}"
        for i in range(n)))


def run(p, e, q, now):
    """A fresh executor: the raw oracle must not be answered from cells
    the splice seeded into a shared result cache."""
    return p.executor_cls(e).execute(q, db="db", now_ns=now)


def splice_vs_raw(p, e, q, now):
    spliced = run(p, e, q, now)
    e.rollup_mgr.read_enabled = False
    try:
        raw = run(p, e, q, now)
    finally:
        e.rollup_mgr.read_enabled = True
    return spliced, raw


def spliced_equal(p, e, q, now, expect_windows=None):
    """The spliced answer equals the raw one byte for byte; returns it
    and the windows served from rollup rows."""
    before = p.stats.counters("rollup").get("splice_windows", 0)
    spliced, raw = splice_vs_raw(p, e, q, now)
    assert json.dumps(spliced, sort_keys=True) == \
        json.dumps(raw, sort_keys=True), p.name
    served = p.stats.counters("rollup").get("splice_windows", 0) - before
    if expect_windows is not None:
        assert served == expect_windows, (p.name, served)
    return spliced, served


def rollup_rows(p, e, now, group=" GROUP BY host"):
    return p.executor_cls(e).execute(
        f'SELECT count(c_v) FROM "db"."{p.rollup.ROLLUP_RP}".cpu_1m{group}',
        db="db", now_ns=now)


class TestRollupMaintenance:
    def test_fold_and_status(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                folded = e.rollup_mgr.maintain(now_ns=now)
                assert folded == 20
                st = e.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                assert st["watermark_ns"] == (BASE + 1260) * NS
                assert st["dirty_windows"] == 0
                res = rollup_rows(p, e, now)
                series = res["results"][0]["series"]
                assert len(series) == 3
                assert all(s["values"][0][1] == 20 for s in series)
                return folded, st, res
            finally:
                e.close()

        both(tmp_path, scenario)

    @pytest.mark.parametrize("case", ["exact", "digest", "straddle"])
    def test_sketch_cells_equal_jax(self, tmp_path, case):
        """The sk_ cells, base64 of RollupSketch.serialize(), equal the
        JAX package's byte for byte: exact cells (a few values a window),
        t-digest cells (1000 values a window, past the 512 exact limit)
        and cells whose window straddles two shards of 1 h (a 7-minute
        rollup over 10 s points), whose values arrive shard by shard."""
        step_s, n, every_s = {"exact": (2, 600, 60),
                              "digest": (0.02, 9000, 60),
                              "straddle": (10, 1080, 420)}[case]
        base = 1_700_002_800  # on an hour; 7-minute windows are not
        rng = np.random.default_rng(13)
        vals = rng.normal(50.0, 20.0, n)
        ints = rng.integers(-1000, 1000, n)

        def scenario(p, root):
            e = open_db(p, root)
            try:
                if case == "straddle":
                    e.create_retention_policy("db", "hourly", 0,
                                              shard_duration_ns=3600 * NS,
                                              default=True)
                declare(p, e, every_s=every_s)
                e.write_lines("db", "\n".join(
                    f"cpu,host=h{i % 3} f={float(vals[i])!r},v={int(ints[i])}i "
                    f"{base * NS + int(i * step_s * NS)}"
                    for i in range(n)))
                now = (base + int(n * step_s) + 3 * every_s) * NS
                e.rollup_mgr.maintain(now_ns=now)
                res = p.executor_cls(e).execute(
                    f'SELECT sk_f, sk_v, c_f FROM "db"."{p.rollup.ROLLUP_RP}"'
                    f'.cpu_1m GROUP BY host', db="db", now_ns=now)
                series = res["results"][0]["series"]
                assert sum(len(s["values"]) for s in series) > 0
                return res
            finally:
                e.close()

        res = both(tmp_path, scenario)
        if case == "digest":
            cells = [r[1] for s in res["results"][0]["series"]
                     for r in s["values"]]
            # a cell past the exact limit serializes as a t-digest (b"\x01")
            assert any(base64.b64decode(c)[0] == 1 for c in cells)

    def test_spec_persists_across_reopen(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            declare(p, e, fields=["v"], sketch=False)
            write_series(e, n=120)
            now = (BASE + 400) * NS
            e.rollup_mgr.maintain(now_ns=now)
            wm = e.rollup_mgr.status(now_ns=now)["db.cpu_1m"]["watermark_ns"]
            e.close()
            e2 = p.engine(root)
            try:
                assert e2.rollup_mgr is not None
                spec = e2.databases["db"].rollups["cpu_1m"]
                assert spec.fields == ["v"] and spec.sketch is False
                st = e2.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                assert st["watermark_ns"] == wm
                assert e2.rollup_mgr.maintain(now_ns=now) == 0
                return wm, st
            finally:
                e2.close()

        both(tmp_path, scenario)

    def test_refold_is_idempotent(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                before = rollup_rows(p, e, now, group="")
                e.rollup_mgr.invalidate("db", "cpu_1m", BASE * NS,
                                        (BASE + 240) * NS)
                refolded = e.rollup_mgr.maintain(now_ns=now)
                assert refolded > 0
                after = rollup_rows(p, e, now, group="")
                assert before == after  # an overwrite: no duplicates
                spliced, _ = spliced_equal(
                    p, e, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now)
                return refolded, after, spliced
            finally:
                e.close()

        both(tmp_path, scenario)


class TestSplice:
    def test_equality_and_scan_shrink(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                e.flush_all()
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
                spliced, _ = spliced_equal(p, e, q, now, expect_windows=20)
                before = p.stats.counters("executor").get("rows_scanned", 0)
                run(p, e, q, now)
                # fully spliced: the raw scan read nothing
                assert p.stats.counters("executor").get(
                    "rows_scanned", 0) == before
                return spliced
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_coarser_grid_and_tag_filter(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                lo, hi = BASE * NS, (BASE + 1200) * NS
                a, _ = spliced_equal(
                    p, e, f"SELECT mean(v), percentile(v, 50) FROM cpu WHERE "
                          f"time >= {lo} AND time < {hi} GROUP BY time(3m)",
                    now)
                b, _ = spliced_equal(
                    p, e, f"SELECT sum(v), count(f) FROM cpu WHERE "
                          f"time >= {lo} AND time < {hi} AND host = 'h1' "
                          f"GROUP BY time(2m)", now)
                return a, b
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_raw_tail_beyond_watermark(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                # past the watermark: the tail comes from raw rows
                write_series(e, n=90, base=BASE + 1200)
                spliced, served = spliced_equal(
                    p, e, QUERY.format(lo=BASE * NS, hi=(BASE + 1400) * NS),
                    now)
                return spliced, served
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_ineligible_shapes_fall_through(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e, sketch=False)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                lo, hi = BASE * NS, (BASE + 240) * NS
                before = p.stats.counters("rollup").get("splice_hits", 0)
                out = []
                for q in (
                    f"SELECT sum(v) FROM cpu WHERE time >= {lo} AND "
                    f"time < {hi} AND v > 3 GROUP BY time(1m)",
                    f"SELECT stddev(v) FROM cpu WHERE time >= {lo} AND "
                    f"time < {hi} GROUP BY time(1m)",
                    f"SELECT sum(v) FROM cpu WHERE time >= {lo} AND "
                    f"time < {hi} GROUP BY time(90s)",
                    f"SELECT percentile(v, 50) FROM cpu WHERE time >= {lo} "
                    f"AND time < {hi} GROUP BY time(1m)",
                ):
                    s, r = splice_vs_raw(p, e, q, now)
                    assert json.dumps(s, sort_keys=True) == \
                        json.dumps(r, sort_keys=True)
                    out.append(s)
                assert p.stats.counters("rollup").get(
                    "splice_hits", 0) == before
                return out
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_composes_with_result_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("OGT_RESULT_CACHE", "1")

        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                ex = p.executor_cls(e)
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
                first = ex.execute(q, db="db", now_ns=now)
                hits = p.stats.counters("executor").get(
                    "inc_cache_full_hits", 0)
                second = ex.execute(q, db="db", now_ns=now)
                assert first == second
                # the cache persisted the spliced windows: a full hit
                assert p.stats.counters("executor").get(
                    "inc_cache_full_hits", 0) == hits + 1
                return second
            finally:
                e.close()

        both(tmp_path, scenario)


class TestLateData:
    def test_late_write_redirties_durably(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                e.write_lines(
                    "db", f"cpu,host=h1 v=99999i,f=3.0 {(BASE + 65) * NS}")
                st = e.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                assert st["dirty_windows"] == 1
                # the mark is on disk before the rows
                with open(root / "rollup" / "db" / "cpu_1m.json") as f:
                    state = json.load(f)
                assert state["dirty"] == [(BASE + 60) * NS]
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
                pre, _ = spliced_equal(p, e, q, now, expect_windows=19)
                assert e.rollup_mgr.maintain(now_ns=now) >= 1
                post, _ = spliced_equal(p, e, q, now, expect_windows=20)
                return st, state, pre, post
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_retention_trim_delete_invalidates(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                p.executor_cls(e).execute(
                    f"DELETE FROM cpu WHERE time < {(BASE + 300) * NS}",
                    db="db", now_ns=now)
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
                pre, _ = spliced_equal(p, e, q, now)
                e.rollup_mgr.maintain(now_ns=now)
                post, _ = spliced_equal(p, e, q, now, expect_windows=20)
                return pre, post
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_vanished_field_zero_fills(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                e.write_lines("db", "\n".join([
                    f"cpu,host=h0 u=5i {(BASE + 5) * NS}",
                    f"cpu,host=h0 v=7i {(BASE + 20) * NS}",
                ]))
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                p.executor_cls(e).execute(
                    f"DELETE FROM cpu WHERE time < {(BASE + 10) * NS}",
                    db="db", now_ns=now)
                e.rollup_mgr.maintain(now_ns=now)
                q = (f"SELECT count(u), sum(u), count(v) FROM cpu WHERE "
                     f"time >= {BASE * NS} AND time < {(BASE + 60) * NS} "
                     f"GROUP BY time(1m)")
                spliced, raw = splice_vs_raw(p, e, q, now)
                assert json.dumps(spliced, sort_keys=True) == \
                    json.dumps(raw, sort_keys=True)
                [row] = spliced["results"][0]["series"][0]["values"]
                assert row[1:] == [0, None, 1]
                return spliced
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_drop_measurement_blocks_fold_until_purge(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                p.executor_cls(e).execute("DROP MEASUREMENT cpu", db="db",
                                          now_ns=now)
                assert e.rollup_mgr.maintain(now_ns=now) == 0  # gated
                e.purge_dropped_measurements("db")
                e.write_lines("db",
                              f"cpu,host=h9 v=1i,f=1.0 {(BASE + 7) * NS}")
                e.rollup_mgr.maintain(now_ns=now)
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS)
                spliced, raw = splice_vs_raw(p, e, q, now)
                assert json.dumps(spliced, sort_keys=True) == \
                    json.dumps(raw, sort_keys=True)
                series = spliced["results"][0]["series"]
                assert [s["tags"]["host"] for s in series] == ["h9"]
                return spliced
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_drop_database_resets_rollup_state(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                e.drop_database("db")
                assert not (root / "rollup" / "db").exists()
                e.create_database("db")
                write_series(e, n=120)
                declare(p, e)
                e.rollup_mgr.maintain(now_ns=now)
                spliced, _ = spliced_equal(
                    p, e, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now, expect_windows=4)
                return spliced
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_drop_rollup_purges_target_rows(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                e.drop_rollup("db", "cpu_1m")
                e.purge_dropped_measurements("db")
                res = rollup_rows(p, e, now, group="")
                assert "series" not in res["results"][0]
                assert not (root / "rollup" / "db" / "cpu_1m.json").exists()
                return res
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_redeclare_rejected(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                with pytest.raises(p.write_error,
                                   match="already exists") as ei:
                    declare(p, e, every_s=300)
                with pytest.raises(p.write_error, match="must differ"):
                    declare(p, e, name="cpu")
                e.drop_rollup("db", "cpu_1m")
                declare(p, e, every_s=300)
                return str(ei.value), e.rollup_mgr.status(
                    now_ns=BASE * NS)
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_delete_invalidates(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e)
                now = (BASE + 1320) * NS
                e.rollup_mgr.maintain(now_ns=now)
                p.executor_cls(e).execute(
                    f"DELETE FROM cpu WHERE time >= {(BASE + 120) * NS} AND "
                    f"time < {(BASE + 240) * NS}", db="db", now_ns=now)
                dirty = e.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
                pre, _ = spliced_equal(p, e, q, now)
                e.rollup_mgr.maintain(now_ns=now)
                post, _ = spliced_equal(p, e, q, now, expect_windows=20)
                return dirty, pre, post
            finally:
                e.close()

        both(tmp_path, scenario)


class TestCrashDurability:
    def test_crash_between_fold_and_state_save(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            declare(p, e)
            write_series(e, n=120)
            now = (BASE + 400) * NS
            p.fp.enable("rollup-fold-after-write", "error")
            with pytest.raises(p.fp.FailpointError):
                e.rollup_mgr.maintain(now_ns=now)
            p.fp.disable("rollup-fold-after-write")
            e.close()
            e2 = p.engine(root)
            try:
                st = e2.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                assert st["watermark_ns"] is None  # never advanced
                assert e2.rollup_mgr.maintain(now_ns=now) == 4
                spliced, _ = spliced_equal(
                    p, e2, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now, expect_windows=4)
                res = rollup_rows(p, e2, now)
                # the double fold left one row per (series, window)
                assert all(s["values"][0][1] == 4
                           for s in res["results"][0]["series"])
                return st, spliced, res
            finally:
                e2.close()

        both(tmp_path, scenario)

    def test_crash_before_state_save_refolds(self, tmp_path):
        """The same contract at the state-save site: a kill after the
        rows and before the watermark's fsync re-folds after a restart."""
        def scenario(p, root):
            e = open_db(p, root)
            declare(p, e)
            write_series(e, n=120)
            now = (BASE + 400) * NS
            p.fp.enable("rollup-before-state-save", "error")
            with pytest.raises(p.fp.FailpointError):
                e.rollup_mgr.maintain(now_ns=now)
            p.fp.disable("rollup-before-state-save")
            e.close()
            e2 = p.engine(root)
            try:
                refolded = e2.rollup_mgr.maintain(now_ns=now)
                spliced, _ = spliced_equal(
                    p, e2, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now, expect_windows=4)
                return refolded, spliced, rollup_rows(p, e2, now)
            finally:
                e2.close()

        both(tmp_path, scenario)

    def test_crash_before_late_dirty_mark_aborts_write(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                p.fp.enable("rollup-mark-dirty", "error")
                with pytest.raises(p.fp.FailpointError):
                    e.write_lines(
                        "db", f"cpu,host=h0 v=7i,f=1.0 {(BASE + 5) * NS}")
                p.fp.disable("rollup-mark-dirty")
                spliced, _ = spliced_equal(
                    p, e, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now)
                return spliced
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_fold_before_write_failpoint_keeps_state(self, tmp_path):
        """A fold failing before its rows are written leaves the
        watermark unopened and the claimed windows dirty again."""
        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                write_series(e, n=120)
                now = (BASE + 400) * NS
                e.rollup_mgr.maintain(now_ns=now)
                e.write_lines("db", f"cpu,host=h0 v=7i,f=1.0 "
                                    f"{(BASE + 5) * NS}")
                p.fp.enable("rollup-fold-before-write", "error")
                with pytest.raises(p.fp.FailpointError):
                    e.rollup_mgr.maintain(now_ns=now)
                p.fp.disable("rollup-fold-before-write")
                st = e.rollup_mgr.status(now_ns=now)["db.cpu_1m"]
                assert st["dirty_windows"] == 1
                assert e.rollup_mgr.maintain(now_ns=now) == 1
                spliced, _ = spliced_equal(
                    p, e, QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS),
                    now, expect_windows=4)
                return st, spliced
            finally:
                e.close()

        both(tmp_path, scenario)


class TestPassThrough:
    def test_no_specs_is_inert(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                assert e.rollup_mgr is None
                before = p.stats.snapshot().get("rollup")
                write_series(e, n=60)
                res = p.executor_cls(e).execute(
                    f"SELECT mean(v) FROM cpu WHERE time >= {BASE * NS} AND "
                    f"time < {(BASE + 240) * NS} GROUP BY time(1m)",
                    db="db", now_ns=(BASE + 400) * NS)
                assert "error" not in res["results"][0]
                assert p.stats.snapshot().get("rollup") == before
                return res
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_env_kill_switch(self, tmp_path, monkeypatch):
        monkeypatch.setenv("OGT_ROLLUP", "0")

        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                assert e.rollup_mgr is None  # declared, switched off
                write_series(e, n=60)
                e.drop_rollup("db", "cpu_1m")
                return sorted(e.databases["db"].rollups)
            finally:
                e.close()

        both(tmp_path, scenario)

    def test_results_bit_identical_without_specs(self, tmp_path):
        now = (BASE + 400) * NS
        q = QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS)

        def scenario(p, root):
            outs = []
            for i, with_spec in enumerate((False, True)):
                e = open_db(p, root / f"eng{i}")
                try:
                    if with_spec:
                        declare(p, e)
                    write_series(e, n=120)
                    if with_spec:
                        e.rollup_mgr.maintain(now_ns=now)
                        e.rollup_mgr.read_enabled = False
                    outs.append(json.dumps(
                        p.executor_cls(e).execute(q, db="db", now_ns=now),
                        sort_keys=True))
                finally:
                    e.close()
            assert outs[0] == outs[1]
            return json.loads(outs[0])

        both(tmp_path, scenario)


class TestFuzz:
    def test_splice_equals_raw_under_churn(self, tmp_path):
        """Out-of-order and late writes racing maintenance ticks on
        another thread: every derivable aggregate answers the same
        through the splice as through a raw scan, at every step, in both
        packages, and the two packages answer alike."""
        queries = [
            QUERY,
            "SELECT sum(v), percentile(f, 25) FROM cpu WHERE time >= {lo} "
            "AND time < {hi} GROUP BY time(2m)",
            "SELECT count(v), max(v) FROM cpu WHERE time >= {lo} AND "
            "time < {hi} AND host = 'h0' GROUP BY time(1m), host",
        ]

        def scenario(p, root):
            e = open_db(p, root)
            try:
                declare(p, e)
                rng = np.random.default_rng(7)
                now_s = BASE
                maint_err: list = []
                answers = []
                served0 = p.stats.counters("rollup").get("splice_windows", 0)
                for round_i in range(8):
                    n = int(rng.integers(20, 40))
                    lines = []
                    for _k in range(n):
                        t = now_s + int(rng.integers(0, 120))
                        v = int(rng.integers(-50, 50))
                        lines.append(
                            f"cpu,host=h{int(rng.integers(0, 3))} "
                            f"v={v}i,f={float(int(rng.integers(0, 9)))} "
                            f"{t * NS}")
                    late = rng.random()
                    if round_i > 2 and late < 0.7:
                        t = BASE + int(rng.integers(
                            0, max(now_s - BASE - 120, 60)))
                        lines.append(f"cpu,host=h1 v=123i,f=4.0 {t * NS}")
                    flush = rng.random() < 0.3
                    step = int(rng.integers(60, 150))

                    def maint(now_s=now_s):
                        try:
                            e.rollup_mgr.maintain(now_ns=(now_s + 150) * NS)
                        except Exception as exc:  # noqa: BLE001
                            maint_err.append(exc)

                    th = threading.Thread(target=maint)
                    th.start()
                    e.write_lines("db", "\n".join(lines))
                    th.join()
                    assert not maint_err
                    if flush:
                        e.flush_all()
                    now_s += step
                    now = (now_s + 60) * NS
                    for q in queries:
                        text = q.format(lo=BASE * NS, hi=(now_s + 120) * NS)
                        s, r = splice_vs_raw(p, e, text, now)
                        assert json.dumps(s, sort_keys=True) == \
                            json.dumps(r, sort_keys=True), (round_i, text)
                        answers.append(s)
                assert p.stats.counters("rollup").get(
                    "splice_windows", 0) > served0
                return answers
            finally:
                e.close()

        both(tmp_path, scenario)


class TestServiceAndGovernor:
    def test_service_ticks_and_tenant_charges(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            gov = p.governor
            try:
                declare(p, e)
                write_series(e, n=120)
                svc = p.service_cls(e, interval_s=3600)
                gov.reset()
                gov.configure(budget_mb=64)
                folded = svc.handle(now_ns=(BASE + 400) * NS)
                assert folded == 4
                acct = gov.tenant_accounts()["db"]
                assert acct["rollup_windows"] == 4
                assert gov.gauges()["tenant_db_rollup_windows"] == 4
                return folded, acct["rollup_windows"]
            finally:
                gov.configure(budget_mb=0)
                gov.reset()
                e.close()

        both(tmp_path, scenario)

    def test_service_inert_without_manager(self, tmp_path):
        def scenario(p, root):
            e = open_db(p, root)
            try:
                return p.service_cls(e).handle()
            finally:
                e.close()

        assert both(tmp_path, scenario) == 0

    def test_service_thread_starts_and_stops(self, tmp_path):
        """A started service ticks on its own thread and stop() joins it:
        no ticker outlives the test."""
        e = open_db(PORT, tmp_path / "torch")
        try:
            declare(PORT, e)
            svc = PORT.service_cls(e, interval_s=0.01)
            svc.start()
            try:
                assert svc._thread is not None and svc._thread.is_alive()
            finally:
                svc.stop()
            assert svc._thread is None
            assert not any(t.name == "svc-rollup"
                           for t in threading.enumerate())
        finally:
            e.close()


class TestCrossPackage:
    @pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                             ids=["jax-to-torch", "torch-to-jax"])
    def test_root_reopens_in_other_package(self, tmp_path, writer, reader):
        """A spec, a folded watermark and a dirty window written by one
        package reopen in the other with the same state and answers."""
        root = tmp_path / "root"
        now = (BASE + 1320) * NS
        q = QUERY.format(lo=BASE * NS, hi=(BASE + 1200) * NS)
        e = open_db(writer, root)
        declare(writer, e)
        write_series(e)
        e.rollup_mgr.maintain(now_ns=now)
        e.write_lines("db", f"cpu,host=h1 v=99999i,f=3.0 {(BASE + 65) * NS}")
        st0 = e.rollup_mgr.status(now_ns=now)
        ans0, _ = spliced_equal(writer, e, q, now, expect_windows=19)
        e.close()
        with open(root / "meta.json") as f:
            meta0 = json.load(f)
        e2 = reader.engine(root)
        try:
            assert e2.rollup_mgr.status(now_ns=now) == st0
            spec = e2.databases["db"].rollups["cpu_1m"]
            assert spec.to_json() == meta0["databases"][0]["rollups"][0]
            ans1, _ = spliced_equal(reader, e2, q, now, expect_windows=19)
            _close(ans1, ans0)
            assert e2.rollup_mgr.maintain(now_ns=now) == 1
            ans2, _ = spliced_equal(reader, e2, q, now, expect_windows=20)
            _close(ans2, ans0)
        finally:
            e2.close()
        with open(root / "meta.json") as f:
            meta1 = json.load(f)
        # the reader saved nothing on its own, or saved the same document
        assert meta1 == meta0


class TestCtrlAndVars:
    @staticmethod
    def _post(svc, path, **params):
        url = (f"http://127.0.0.1:{svc.port}{path}?"
               + urllib.parse.urlencode(params))
        req = urllib.request.Request(url, data=b"", method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read() or b"{}")

    @staticmethod
    def _get(svc, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}{path}") as r:
            return json.loads(r.read())

    def _served(self, p, root, body):
        engine = open_db(p, root)
        svc = p.http_cls(engine, "127.0.0.1", 0)
        svc.start()
        try:
            return body(svc)
        finally:
            svc.stop()
            engine.close()

    def test_ctrl_rollup_lifecycle(self, tmp_path):
        def scenario(p, root):
            def body(svc):
                write_series(svc.engine, n=120)
                out = []
                code, doc = self._post(
                    svc, "/debug/ctrl", mod="rollup", op="declare", db="db",
                    name="cpu_1m", measurement="cpu", every_s="60")
                assert code == 200 and "db.cpu_1m" in doc["specs"]
                out.append((code, doc["specs"]["db.cpu_1m"]["every_ns"]))
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="flush")
                assert code == 200 and doc["folded"] > 0
                out.append((code, doc["folded"]))
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="invalidate", db="db",
                                       name="cpu_1m")
                assert code == 200 and doc["invalidated"] == 1
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="status")
                assert doc["specs"]["db.cpu_1m"]["watermark_ns"] is None
                out.append(doc["specs"]["db.cpu_1m"]["dirty_windows"])
                vars_doc = self._get(svc, "/debug/vars")
                assert vars_doc["rollup"]["windows_folded"] > 0
                out.append(sorted(vars_doc["rollup"]))
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="drop", db="db", name="cpu_1m")
                assert code == 200 and doc["specs"] == {}
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="bogus")
                assert code == 400
                out.append((code, doc))
                code, doc = self._post(svc, "/debug/ctrl", mod="rollup",
                                       op="declare", db="db")
                assert code == 400
                out.append((code, doc))
                return out

            return self._served(p, root, body)

        both(tmp_path, scenario)

    def test_query_stage_attribution(self, tmp_path):
        def scenario(p, root):
            def body(svc):
                write_series(svc.engine, n=120)
                self._post(svc, "/debug/ctrl", mod="rollup", op="declare",
                           db="db", name="cpu_1m", measurement="cpu",
                           every_s="60")
                self._post(svc, "/debug/ctrl", mod="rollup", op="flush")
                before = self._get(svc, "/debug/vars")["query_stages"].get(
                    "rollup_count", 0)
                q = QUERY.format(lo=BASE * NS, hi=(BASE + 240) * NS)
                url = (f"http://127.0.0.1:{svc.port}/query?"
                       + urllib.parse.urlencode({"db": "db", "q": q}))
                with urllib.request.urlopen(url) as r:
                    assert r.status == 200
                    answer = json.loads(r.read())
                after = self._get(svc, "/debug/vars")["query_stages"][
                    "rollup_count"]
                assert after >= before + 1
                return answer

            return self._served(p, root, body)

        both(tmp_path, scenario)
