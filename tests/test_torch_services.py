"""The port's continuous queries, downsample (the shard rewrite, the
policies and their SQL), retention, the iodetector and the read-only
gating of CQ and INTO statements, against the JAX package, on the CPU.

The cases of the reference's tests/test_services.py classes
TestContinuousQueries, TestDownsample, TestRetentionService,
TestReadOnlyGating, TestReviewRegressions, TestIoDetector and
TestDownsampleSQL run in both packages on the same writes (the JAX
``Engine``/``Executor`` and the port's ``Engine(device="cpu")``/
``Executor``), each held to the reference test's own checks; the port's
answers, errors, policies and ``meta.json`` equal the JAX package's
(counts, extremes and first/last exact; means and sums at rel 1e-12).
The downsampled int sum above 2^24 (and one above 2^53) must be exact,
and a failing CQ must not starve the others. Besides: a root written by
either package with CQs, streams, downsample policies, retention
policies and subscriptions reopens in the other with the same metadata
and answers, and writes ``meta.json`` back as read.

The reference's TestMonitorService, TestHierarchicalService,
TestHierarchicalRegressions and TestSherlock cases run the same way:
the monitor's ``_internal`` and ``_monitor`` points (each package's own
statistics, so the measurements and renamed gauges are compared, not
the counts), a shard moved to the cold tier (a symlink; reads, writes
and in-flight readers keep working, retention removes the cold copy
too) and the sherlock watermarks, cooldown and failed-dump retry.
"""

from __future__ import annotations

import json
import math
import threading
import time

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.services import iodetector as jiod
from opengemini_tpu.services.continuous import ContinuousQueryService as JCQ
from opengemini_tpu.services.downsample import DownsampleService as JDS
from opengemini_tpu.services.retention import RetentionService as JRet
from opengemini_tpu.storage import engine as jeng_mod
from opengemini_tpu.utils.governor import GOVERNOR as JGOV
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.services import iodetector as tiod
from opengemini_tpu_torch.services.continuous import (
    ContinuousQueryService as TCQ,
)
from opengemini_tpu_torch.services.downsample import DownsampleService as TDS
from opengemini_tpu_torch.services.retention import RetentionService as TRet
from opengemini_tpu_torch.storage import engine as teng_mod
from opengemini_tpu_torch.utils.governor import GOVERNOR as TGOV

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040  # minute-aligned
WEEK = 7 * 24 * 3600


class Pkg:
    def __init__(self, name, eng_mod, executor_cls, cq_cls, ds_cls, ret_cls,
                 iod, governor, engine_kw):
        self.name = name
        self.eng_mod = eng_mod
        self.executor_cls = executor_cls
        self.cq_cls = cq_cls
        self.ds_cls = ds_cls
        self.ret_cls = ret_cls
        self.iod = iod
        self.governor = governor
        self.engine_kw = engine_kw

    def engine(self, root):
        return self.eng_mod.Engine(str(root), **self.engine_kw)


JAX = Pkg("jax", jeng_mod, JExecutor, JCQ, JDS, JRet, jiod, JGOV, {})
PORT = Pkg("torch", teng_mod, TExecutor, TCQ, TDS, TRet, tiod, TGOV,
           {"device": "cpu"})
PKGS = (JAX, PORT)


def _close(a, b, path="$"):
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


class Env:
    def __init__(self, p, root):
        self.p = p
        self.root = root
        self.e = p.engine(root)
        self.e.create_database("db")
        self.ex = p.executor_cls(self.e)

    def q(self, text, now=None):
        return self.ex.execute(text, db="db",
                               now_ns=(now or (BASE + 10_000)) * NS)

    def meta(self):
        with open(self.root / "meta.json") as f:
            return json.load(f)


def both(tmp_path, scenario):
    """`scenario(env)` in both packages; the port's outcome equals the
    JAX package's."""
    outs = []
    for p in PKGS:
        env = Env(p, tmp_path / p.name)
        try:
            outs.append(scenario(env))
        finally:
            env.e.close()
    _close(outs[1], outs[0])
    return outs[1]


def vals(res, i=0):
    return res["results"][0]["series"][i]["values"]


CQ = ('CREATE CONTINUOUS QUERY cq1 ON db BEGIN '
      'SELECT mean(v) INTO cpu_1m FROM cpu GROUP BY time(1m), host END')


class TestContinuousQueries:
    def test_create_show_drop(self, tmp_path):
        def scenario(env):
            created = env.q(CQ)
            assert "error" not in created["results"][0]
            shown = env.q("SHOW CONTINUOUS QUERIES")
            series = {s["name"]: s for s in shown["results"][0]["series"]}
            assert series["db"]["values"][0][0] == "cq1"
            assert "SELECT mean(v) INTO cpu_1m" in series["db"]["values"][0][1]
            meta = env.meta()["databases"][0]["cqs"]
            env.q("DROP CONTINUOUS QUERY cq1 ON db")
            after = env.q("SHOW CONTINUOUS QUERIES")
            assert all(not s["values"]
                       for s in after["results"][0].get("series", []))
            missing = env.q("CREATE CONTINUOUS QUERY x ON nodb BEGIN SELECT "
                            "mean(v) INTO y FROM cpu GROUP BY time(1m) END")
            return created, shown, meta, after, missing

        both(tmp_path, scenario)

    def test_cq_persisted_across_reopen(self, tmp_path):
        def scenario(env):
            env.q(CQ)
            env.e.close()
            e2 = env.p.engine(env.root)
            try:
                cq = e2.databases["db"].continuous_queries["cq1"]
                return cq.to_json()
            finally:
                env.e = e2  # both() closes it

        both(tmp_path, scenario)

    def test_cq_service_materializes_windows(self, tmp_path):
        def scenario(env):
            env.q(CQ)
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h0 v={i} {(BASE + i * 10) * NS}"
                for i in range(24)))
            svc = env.p.cq_cls(env.e, env.ex, interval_s=3600)
            ran = [svc.handle(now_ns=(BASE + 180) * NS)]
            first = vals(env.q("SELECT mean FROM cpu_1m"))
            assert [v for _t, v in first] == [14.5]
            ran.append(svc.handle(now_ns=(BASE + 185) * NS))
            ran.append(svc.handle(now_ns=(BASE + 248) * NS))
            second = vals(env.q("SELECT mean FROM cpu_1m"))
            assert ran == [1, 0, 1]
            assert [v for _t, v in second] == [14.5, 20.5]
            last = env.e.databases["db"].continuous_queries["cq1"].last_run_ns
            return ran, first, second, last

        both(tmp_path, scenario)

    def test_cq_resample_for_extends_lookback(self, tmp_path):
        def scenario(env):
            env.q('CREATE CONTINUOUS QUERY cq2 ON db RESAMPLE FOR 3m BEGIN '
                  'SELECT mean(v) INTO cpu_1m_r FROM cpu GROUP BY time(1m) END')
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h0 v={i} {(BASE + i * 10) * NS}"
                for i in range(18)))
            svc = env.p.cq_cls(env.e, env.ex, interval_s=3600)
            assert svc.handle(now_ns=(BASE + 180) * NS) == 1
            out = vals(env.q("SELECT mean FROM cpu_1m_r"))
            assert [v for _t, v in out] == [2.5, 8.5, 14.5]
            return out

        both(tmp_path, scenario)

    def test_cq_group_by_star_over_seeded_hosts(self, tmp_path):
        """`mean(*) INTO ... GROUP BY time(5m), *`, the dashboard CQ of
        the smoke's phase 14, over many series and fields."""
        import numpy as np

        rng = np.random.default_rng(13)
        lines = []
        for h in range(12):
            for k in range(90):
                a, b = (float(x) for x in rng.normal(size=2))
                lines.append(f"cpu,hostname=host_{h},region=r{h % 3} "
                             f"usage_user={a!r},usage_system={b!r} "
                             f"{(BASE + k * 10) * NS}")
        body = "\n".join(lines)

        def scenario(env):
            env.e.write_lines("db", body)
            env.q("CREATE CONTINUOUS QUERY c5 ON db BEGIN SELECT mean(*) "
                  "INTO cpu_5m FROM cpu GROUP BY time(5m), * END")
            svc = env.p.cq_cls(env.e, env.ex, interval_s=3600)
            ran = svc.handle(now_ns=(BASE + 900) * NS)
            assert ran == 1
            return env.q("SELECT * FROM cpu_5m GROUP BY *")

        both(tmp_path, scenario)

    def test_cq_runs_under_governor_background_slot(self, tmp_path):
        """Governed, a CQ takes a background admission slot; a full
        queue sheds the run and leaves last_run_ns for the retry."""
        def scenario(env):
            gov = env.p.governor
            env.q(CQ)
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h0 v={i} {(BASE + i * 10) * NS}"
                for i in range(24)))
            svc = env.p.cq_cls(env.e, env.ex, interval_s=3600)
            gov.reset()
            gov.configure(budget_mb=64, max_concurrent=1, queue=0)
            # the one slot is held by another thread (admission is
            # reentrant on one thread)
            holding, done = threading.Event(), threading.Event()

            def hold():
                token = gov.admit()
                holding.set()
                done.wait(10)
                token.release()

            holder = threading.Thread(target=hold)
            holder.start()
            holding.wait(10)
            try:
                shed = svc.handle(now_ns=(BASE + 180) * NS)
                assert shed == 0
                assert env.e.databases["db"].continuous_queries[
                    "cq1"].last_run_ns == 0
            finally:
                done.set()
                holder.join()
            try:
                ran = svc.handle(now_ns=(BASE + 180) * NS)
                counters = gov.admission_snapshot()["counters"]
            finally:
                gov.configure(budget_mb=0, max_concurrent=16, queue=64)
                gov.reset()
            assert ran == 1
            return shed, ran, counters["sheds_queue_full"], vals(
                env.q("SELECT mean FROM cpu_1m"))

        both(tmp_path, scenario)


class TestDownsample:
    def test_rewrite_downsampled_means(self, tmp_path):
        def scenario(env):
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h{i % 2} v={i}.0,c={i}i {(BASE + i * 10) * NS}"
                for i in range(60)))
            [shard] = env.e.all_shards()
            kw = {"device": "cpu"} if env.p is PORT else {}
            written = shard.rewrite_downsampled(60 * NS, **kw)
            assert 0 < written < 60
            v = vals(env.q("SELECT v FROM cpu WHERE host = 'h0'"))
            assert v[0][1] == pytest.approx(2.0)
            c = vals(env.q("SELECT c FROM cpu WHERE host = 'h0'"))
            assert c[0][1] == 0 + 2 + 4 and isinstance(c[0][1], int)
            return written, v, c, env.q("SELECT * FROM cpu GROUP BY *")

        both(tmp_path, scenario)

    def test_downsample_policy_service_flow(self, tmp_path):
        def scenario(env):
            env.e.write_lines(
                "db", f"cpu v=1 {BASE * NS}\ncpu v=3 {(BASE + 30) * NS}")
            env.e.add_downsample_policy(
                "db", "autogen",
                env.p.eng_mod.DownsamplePolicy(age_ns=1 * NS,
                                               every_ns=60 * NS))
            now = (BASE + 2 * WEEK) * NS
            runs = [env.e.run_downsample(now_ns=now),
                    env.e.run_downsample(now_ns=now)]
            assert runs == [1, 0]  # idempotent: already at the level
            [row] = vals(env.q("SELECT v FROM cpu"))
            assert row[1] == pytest.approx(2.0)
            return runs, row

        both(tmp_path, scenario)

    def test_downsample_service_tick(self, tmp_path, monkeypatch):
        def scenario(env):
            env.e.write_lines(
                "db", f"cpu v=1 {BASE * NS}\ncpu v=3 {(BASE + 30) * NS}")
            env.e.add_downsample_policy(
                "db", "autogen",
                env.p.eng_mod.DownsamplePolicy(1 * NS, 60 * NS))
            monkeypatch.setattr(env.p.eng_mod._time, "time_ns",
                                lambda: (BASE + 2 * WEEK) * NS)
            svc = env.p.ds_cls(env.e, interval_s=3600)
            svc.tick()
            return vals(env.q("SELECT v FROM cpu"))

        both(tmp_path, scenario)

    def test_policy_persisted(self, tmp_path):
        def scenario(env):
            env.e.add_downsample_policy(
                "db", "autogen", env.p.eng_mod.DownsamplePolicy(1, 60 * NS))
            env.e.close()
            e2 = env.p.engine(env.root)
            env.e = e2
            pol = e2.databases["db"].downsample["autogen"][0]
            assert pol.every_ns == 60 * NS
            return pol.to_json()

        both(tmp_path, scenario)

    def test_rewrite_drops_colcache_entries(self, tmp_path):
        """The rewrite retires the old files: a query after it reads the
        new file, never a cached column of a retired one."""
        def scenario(env):
            env.e.write_lines("db", "\n".join(
                f"cpu v={i}.0 {(BASE + i * 10) * NS}" for i in range(60)))
            env.e.flush_all()
            before = vals(env.q("SELECT count(v), sum(v) FROM cpu"))
            env.q("SELECT count(v), sum(v) FROM cpu")  # warm the cache
            env.e.add_downsample_policy(
                "db", "autogen",
                env.p.eng_mod.DownsamplePolicy(1 * NS, 60 * NS))
            assert env.e.run_downsample(now_ns=(BASE + 2 * WEEK) * NS) == 1
            after = vals(env.q("SELECT count(v), sum(v) FROM cpu"))
            assert after[0][1] == 10  # ten one-minute windows
            return before, after

        both(tmp_path, scenario)


class TestRetentionService:
    def test_tick_drops_expired(self, tmp_path, monkeypatch):
        def scenario(env):
            env.e.create_retention_policy("db", "short",
                                          duration_ns=24 * 3600 * NS,
                                          default=True)
            env.e.write_lines("db", f"cpu v=1 {1 * NS}")  # ancient
            env.e.write_lines("db", f"cpu v=2 {(BASE + 9000) * NS}")
            svc = env.p.ret_cls(env.e, interval_s=3600)
            monkeypatch.setattr(env.p.eng_mod._time, "time_ns",
                                lambda: (BASE + 10_000) * NS)
            svc.tick()
            left = [sh.tmin for sh in env.e.shards_for_range(
                "db", "short", 0, 2**62)]
            assert len(left) == 1
            return left, vals(env.q("SELECT v FROM cpu"))

        both(tmp_path, scenario)

    def test_drop_expired_shards_explicit_now(self, tmp_path):
        def scenario(env):
            env.e.create_retention_policy("db", "short",
                                          duration_ns=24 * 3600 * NS,
                                          default=True)
            env.e.write_lines("db", "\n".join(
                f"cpu v={h} {(BASE + h * 3600) * NS}" for h in range(30)))
            before = len(env.e.all_shards())
            dropped = env.e.drop_expired_shards(
                now_ns=(BASE + 30 * 3600) * NS)
            after = vals(env.q("SELECT count(v) FROM cpu"))
            return before, sorted(dropped), after

        both(tmp_path, scenario)


class TestReadOnlyGating:
    def test_show_cq_allowed_on_get_into_rejected(self, tmp_path):
        def scenario(env):
            a = env.ex.execute("SHOW CONTINUOUS QUERIES", db="db",
                               read_only=True)
            assert "error" not in a["results"][0]
            b = env.ex.execute("SELECT mean(v) INTO x FROM cpu", db="db",
                               read_only=True)
            assert "must be sent via POST" in b["results"][0]["error"]
            c = env.ex.execute(CQ, db="db", read_only=True)
            assert "must be sent via POST" in c["results"][0]["error"]
            return a, b, c

        both(tmp_path, scenario)


class TestReviewRegressions:
    def test_downsample_int_sum_exact_above_f32(self, tmp_path):
        big = 100_000_001

        def scenario(env):
            env.e.write_lines(
                "db", f"m c={big}i {BASE * NS}\nm c={big}i {(BASE + 10) * NS}")
            [shard] = env.e.all_shards()
            kw = {"device": "cpu"} if env.p is PORT else {}
            shard.rewrite_downsampled(60 * NS, **kw)
            [row] = vals(env.q("SELECT c FROM m"))
            assert row[1] == 2 * big
            return row

        both(tmp_path, scenario)

    def test_downsample_int_sum_exact_above_f64(self, tmp_path):
        """The port computes in f64: integers past 2^53 must still come
        through the rewrite exactly (the host int64 path)."""
        big = 2**60 + 3

        def scenario(env):
            env.e.write_lines(
                "db", f"m c={big}i {BASE * NS}\nm c=5i {(BASE + 10) * NS}")
            [shard] = env.e.all_shards()
            kw = {"device": "cpu"} if env.p is PORT else {}
            shard.rewrite_downsampled(60 * NS, {"integer": "max"}, **kw)
            [row] = vals(env.q("SELECT c FROM m"))
            assert row[1] == big
            return row

        both(tmp_path, scenario)

    def test_failing_cq_does_not_starve_others(self, tmp_path):
        def scenario(env):
            env.q('CREATE CONTINUOUS QUERY a_bad ON db BEGIN '
                  'SELECT mean(v) INTO missing_db..x FROM cpu '
                  'GROUP BY time(1m) END')
            env.q('CREATE CONTINUOUS QUERY b_ok ON db BEGIN '
                  'SELECT mean(v) INTO ok_1m FROM cpu GROUP BY time(1m) END')
            env.e.write_lines("db", "\n".join(
                f"cpu v={i} {(BASE + i * 10) * NS}" for i in range(12)))
            svc = env.p.cq_cls(env.e, env.ex, interval_s=3600)
            ran = svc.handle(now_ns=(BASE + 120) * NS)
            assert ran == 1
            out = vals(env.q("SELECT mean FROM ok_1m"))
            assert out
            return ran, out

        both(tmp_path, scenario)


class TestIoDetector:
    @pytest.fixture(autouse=True)
    def _clear_io_alarms(self):
        """A probe that misses its deadline raises the process-wide
        governor's IO alarm, which pauses background work for
        OGT_BG_IO_PAUSE_S: clear both governors after each case, or a
        later test in this process that turns a governor on finds its
        background gate closed."""
        yield
        for p in PKGS:
            p.governor.reset()

    def test_probe_ok(self, tmp_path):
        def scenario(env):
            svc = env.p.iod.IoDetectorService(env.e, interval_s=3600,
                                              probe_timeout_s=5)
            return svc.handle(), svc.alarms

        assert both(tmp_path, scenario) == (True, 0)

    def test_hang_raises_alarm_and_pauses_background(self, tmp_path,
                                                     monkeypatch):
        def scenario(env):
            gov = env.p.governor
            gov.reset()
            gov.configure(budget_mb=64)
            svc = env.p.iod.IoDetectorService(env.e, interval_s=3600,
                                              probe_timeout_s=0.05)
            monkeypatch.setattr(env.p.iod.os, "fsync",
                                lambda fd: time.sleep(0.5))
            try:
                ok = svc.handle()
                allowed = gov.background_allowed()
                alarms = gov.gauges()["io_alarms"]
            finally:
                monkeypatch.undo()
                time.sleep(0.6)  # the stuck probe finishes
                gov.configure(budget_mb=0)
                gov.reset()
            assert ok is False and svc.alarms == 1
            assert allowed is False and alarms == 1
            return ok, svc.alarms, allowed, alarms

        both(tmp_path, scenario)

    def test_hung_probe_not_stacked(self, tmp_path, monkeypatch):
        def scenario(env):
            svc = env.p.iod.IoDetectorService(env.e, interval_s=3600,
                                              probe_timeout_s=0.05)
            release = threading.Event()
            monkeypatch.setattr(env.p.iod.os, "fsync",
                                lambda fd: release.wait(5))
            try:
                first = svc.handle()
                before = threading.active_count()
                second = svc.handle()
                assert threading.active_count() == before
            finally:
                release.set()
                monkeypatch.undo()
                time.sleep(0.05)
            assert svc.alarms == 2
            return first, second, svc.alarms

        both(tmp_path, scenario)


class TestDownsampleSQL:
    def test_create_show_drop(self, tmp_path):
        def scenario(env):
            res = env.q("CREATE DOWNSAMPLE ON autogen (float(mean), "
                        "integer(sum)) WITH TTL 30d SAMPLEINTERVAL 1h,25h "
                        "TIMEINTERVAL 1m,30m")
            assert "error" not in res["results"][0], res
            pols = env.e.databases["db"].downsample["autogen"]
            assert [(p.age_ns, p.every_ns) for p in pols] == [
                (3600 * NS, 60 * NS), (25 * 3600 * NS, 1800 * NS)]
            assert pols[0].field_aggs == {"float": "mean", "integer": "sum"}
            shown = env.q("SHOW DOWNSAMPLES")
            assert vals(shown) == [
                ["autogen", "float(mean),integer(sum)", "1h0m0s", "0h1m0s"],
                ["autogen", "float(mean),integer(sum)", "25h0m0s",
                 "0h30m0s"]]
            meta = env.meta()["databases"][0]
            dup = env.ex.execute("CREATE DOWNSAMPLE ON autogen WITH TTL 30d "
                                 "SAMPLEINTERVAL 1h TIMEINTERVAL 1m", db="db")
            assert "already exists" in dup["results"][0]["error"]
            env.q("DROP DOWNSAMPLE ON autogen")
            assert not env.e.databases["db"].downsample
            return res, shown, meta, dup

        both(tmp_path, scenario)

    def test_sql_policy_drives_rewrite(self, tmp_path):
        def scenario(env):
            env.e.write_lines(
                "db", f"cpu v=1 {BASE * NS}\ncpu v=3 {(BASE + 30) * NS}")
            env.q("CREATE DOWNSAMPLE ON autogen (float(mean)) WITH TTL 52w "
                  "SAMPLEINTERVAL 2m TIMEINTERVAL 1m")
            n = env.e.run_downsample(now_ns=(BASE + 2 * WEEK) * NS)
            assert n == 1
            return n, vals(env.q("SELECT v FROM cpu"))

        both(tmp_path, scenario)

    def test_validation_errors(self, tmp_path):
        def scenario(env):
            def err(sql):
                return env.ex.execute(sql, db="db")["results"][0]["error"]

            errs = [
                err("CREATE DOWNSAMPLE ON autogen WITH TTL 7d "
                    "SAMPLEINTERVAL 1h,25h TIMEINTERVAL 1m"),
                err("CREATE DOWNSAMPLE ON autogen WITH TTL 7d "
                    "SAMPLEINTERVAL 1h TIMEINTERVAL 2h"),
                err("CREATE DOWNSAMPLE ON autogen WITH TTL 7d "
                    "SAMPLEINTERVAL 25h,1h TIMEINTERVAL 1m,30m"),
                err("CREATE DOWNSAMPLE ON autogen WITH TTL 1h "
                    "SAMPLEINTERVAL 25h TIMEINTERVAL 1m"),
                err("CREATE DOWNSAMPLE ON autogen (string(mean)) WITH TTL 7d "
                    "SAMPLEINTERVAL 1h TIMEINTERVAL 1m"),
                err("CREATE DOWNSAMPLE ON autogen (float(bogus)) WITH TTL 7d "
                    "SAMPLEINTERVAL 1h TIMEINTERVAL 1m"),
                err("CREATE DOWNSAMPLE ON nope WITH TTL 7d "
                    "SAMPLEINTERVAL 1h TIMEINTERVAL 1m"),
            ]
            for e, want in zip(errs, (
                    "same number of levels", "must be finer", "ascending",
                    "TTL must cover", "unknown downsample field type",
                    "is not supported for", "retention policy not found")):
                assert want in e, e
            return errs

        both(tmp_path, scenario)

    def test_type_aggs_respected_in_rewrite(self, tmp_path):
        def scenario(env):
            env.e.write_lines(
                "db", f"cpu c=2i {BASE * NS}\ncpu c=5i {(BASE + 30) * NS}")
            env.q("CREATE DOWNSAMPLE ON autogen (integer(max)) WITH TTL 52w "
                  "SAMPLEINTERVAL 2m TIMEINTERVAL 1m")
            assert env.e.run_downsample(now_ns=(BASE + 2 * WEEK) * NS) == 1
            [row] = vals(env.q("SELECT c FROM cpu"))
            assert row[1] == 5
            return row

        both(tmp_path, scenario)

    def test_unexecutable_agg_rejected(self, tmp_path):
        def scenario(env):
            errs = []
            for sql in (
                "CREATE DOWNSAMPLE ON autogen (integer(count)) WITH TTL 7d "
                "SAMPLEINTERVAL 1h TIMEINTERVAL 1m",
                "CREATE DOWNSAMPLE ON autogen (float(percentile)) WITH TTL "
                "7d SAMPLEINTERVAL 1h TIMEINTERVAL 1m",
                "CREATE DOWNSAMPLE ON autogen (integer(spread)) WITH TTL 7d "
                "SAMPLEINTERVAL 1h TIMEINTERVAL 1m",
            ):
                e = env.ex.execute(sql, db="db")["results"][0]["error"]
                assert "is not supported for" in e, e
                errs.append(e)
            assert not env.e.databases["db"].downsample
            return errs

        both(tmp_path, scenario)

    def test_ttl_sets_rp_duration(self, tmp_path):
        def scenario(env):
            env.q("CREATE DOWNSAMPLE ON autogen (float(mean)) WITH TTL 30d "
                  "SAMPLEINTERVAL 1h TIMEINTERVAL 1m")
            d = env.e.databases["db"].rps["autogen"].duration_ns
            assert d == 30 * 86400 * NS
            return d

        both(tmp_path, scenario)

    def test_drop_rp_removes_policies(self, tmp_path):
        def scenario(env):
            env.q("CREATE RETENTION POLICY rpx ON db DURATION 90d "
                  "REPLICATION 1")
            env.q("CREATE DOWNSAMPLE ON db.rpx (float(mean)) WITH TTL 30d "
                  "SAMPLEINTERVAL 1h TIMEINTERVAL 1m")
            assert env.e.databases["db"].downsample["rpx"]
            env.q("DROP RETENTION POLICY rpx ON db")
            assert "rpx" not in env.e.databases["db"].downsample
            env.q("CREATE RETENTION POLICY rpx ON db DURATION 90d "
                  "REPLICATION 1")
            res = env.ex.execute(
                "CREATE DOWNSAMPLE ON db.rpx (float(mean)) WITH TTL 30d "
                "SAMPLEINTERVAL 1h TIMEINTERVAL 1m", db="db")
            assert "error" not in res["results"][0], res
            return res, env.meta()

        both(tmp_path, scenario)


class TestCrossPackageMeta:
    @pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                             ids=["jax-to-torch", "torch-to-jax"])
    def test_continuous_tier_root_reopens(self, tmp_path, writer, reader):
        root = tmp_path / "root"
        env = Env(writer, root)
        try:
            env.q(CQ)
            env.q("CREATE STREAM s1 ON SELECT mean(v) INTO cpu_s FROM cpu "
                  "GROUP BY time(1m), host DELAY 10s")
            env.q("CREATE DOWNSAMPLE ON autogen (float(mean)) WITH TTL 52w "
                  "SAMPLEINTERVAL 2m TIMEINTERVAL 1m")
            env.q("CREATE RETENTION POLICY short ON db DURATION 2d "
                  "REPLICATION 1")
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h{i % 2} v={i} {(BASE + i * 10) * NS}"
                for i in range(24)))
            svc = writer.cq_cls(env.e, env.ex, interval_s=3600)
            assert svc.handle(now_ns=(BASE + 180) * NS) == 1
            shows = [env.q(s) for s in ("SHOW CONTINUOUS QUERIES",
                                        "SHOW STREAMS", "SHOW DOWNSAMPLES",
                                        "SHOW RETENTION POLICIES",
                                        "SELECT * FROM cpu_1m GROUP BY *")]
        finally:
            env.e.close()
        meta0 = json.loads((root / "meta.json").read_text())
        # a subscription either package reads and writes back
        meta0["databases"][0]["subscriptions"] = [
            {"name": "sub0", "mode": "ALL",
             "destinations": ["http://127.0.0.1:1"]}]
        (root / "meta.json").write_text(json.dumps(meta0))
        e2 = reader.engine(root)
        try:
            ex2 = reader.executor_cls(e2)
            got = [ex2.execute(s, db="db", now_ns=(BASE + 10_000) * NS)
                   for s in ("SHOW CONTINUOUS QUERIES", "SHOW STREAMS",
                             "SHOW DOWNSAMPLES", "SHOW RETENTION POLICIES",
                             "SELECT * FROM cpu_1m GROUP BY *")]
            _close(got, shows)
            cq = e2.databases["db"].continuous_queries["cq1"]
            assert cq.last_run_ns == (BASE + 180) * NS
            e2.save_cq_state()
        finally:
            e2.close()
        meta1 = json.loads((root / "meta.json").read_text())
        assert meta1 == meta0


# -- monitor, hierarchical storage, sherlock ---------------------------------

def _svc_mod(env, name):
    import importlib

    pkg = "opengemini_tpu" if env.p is JAX else "opengemini_tpu_torch"
    return importlib.import_module(f"{pkg}.services.{name}")


class TestMonitorService:
    def test_stats_pushed_to_internal(self, tmp_path):
        def scenario(env):
            mon = _svc_mod(env, "monitor")
            mon.STATS.incr("executor", "queries", 5)
            svc = mon.MonitorService(env.e, interval_s=3600, hostname="n1")
            svc.tick()
            res = env.ex.execute("SELECT last(queries) FROM executor",
                                 db="_internal", now_ns=None)
            v = res["results"][0]["series"][0]["values"][0][1]
            assert v >= 5
            tags = env.ex.execute("SHOW TAG VALUES FROM executor WITH KEY "
                                  "= hostname", db="_internal")
            msts = env.ex.execute("SHOW MEASUREMENTS", db="_monitor")
            names = {r[0] for r in msts["results"][0]["series"][0]["values"]}
            assert "ogt" in names
            fields = env.ex.execute("SHOW FIELD KEYS FROM ogt",
                                    db="_monitor")
            keys = {r[0] for r in fields["results"][0]["series"][0]["values"]}
            assert "ogt_executor_queries" in keys
            # the stats each package keeps differ: the shape is compared
            return tags, sorted(env.e.databases), "ogt_executor_queries"

        both(tmp_path, scenario)

    def test_empty_snapshot_writes_nothing(self, tmp_path, monkeypatch):
        def scenario(env):
            mon = _svc_mod(env, "monitor")
            monkeypatch.setattr(mon.STATS, "snapshot", lambda: {})
            mon.MonitorService(env.e, interval_s=3600).tick()
            monkeypatch.undo()
            return sorted(env.e.databases)

        assert both(tmp_path, scenario) == ["db"]


WEEK_NS = WEEK * NS


class TestHierarchicalService:
    def test_cold_move_keeps_shard_usable(self, tmp_path):
        import os

        def scenario(env):
            hier = _svc_mod(env, "hierarchical")
            env.e.write_lines("db", f"m v=1 {BASE * NS}\nm v=3 "
                                    f"{(BASE + 1) * NS}")
            env.e.flush_all()
            cold = str(env.root / "cold")
            svc = hier.HierarchicalService(env.e, cold, age_ns=1,
                                           interval_s=3600)
            assert svc.handle(now_ns=BASE * NS + 2 * WEEK_NS) == 1
            [shard] = env.e.all_shards()
            assert os.path.islink(shard.path)
            out = [env.q("SELECT sum(v) FROM m")]
            assert vals(out[0])[0][1] == 4.0
            env.e.write_lines("db", f"m v=10 {(BASE + 2) * NS}")
            out.append(env.q("SELECT sum(v) FROM m"))
            assert vals(out[1])[0][1] == 14.0
            assert svc.handle(now_ns=BASE * NS + 2 * WEEK_NS) == 0
            env.e.flush_all()
            out.append(sorted(os.listdir(os.readlink(shard.path))))
            return out

        both(tmp_path, scenario)

    def test_relative_cold_dir_absolutized(self, tmp_path, monkeypatch):
        import os

        def scenario(env):
            hier = _svc_mod(env, "hierarchical")
            env.e.write_lines("db", f"m v=1 {BASE * NS}")
            env.e.flush_all()
            monkeypatch.chdir(env.root)
            svc = hier.HierarchicalService(env.e, "cold-rel", age_ns=1,
                                           interval_s=3600)
            assert svc.handle(now_ns=BASE * NS + 2 * WEEK_NS) == 1
            [shard] = env.e.all_shards()
            target = os.readlink(shard.path)
            assert os.path.isabs(target) and os.path.isdir(target)
            return env.q("SELECT count(v) FROM m")

        assert vals(both(tmp_path, scenario))[0][1] == 1

    def test_inflight_readers_survive_tiering(self, tmp_path):
        def scenario(env):
            hier = _svc_mod(env, "hierarchical")
            env.e.write_lines("db", f"m v=7 {BASE * NS}")
            env.e.flush_all()
            [shard] = env.e.all_shards()
            sid = shard.index.get_or_create("m", ())
            pairs = shard.file_chunks("m", {sid})
            svc = hier.HierarchicalService(env.e, str(env.root / "cold"),
                                           age_ns=1)
            assert svc.handle(now_ns=BASE * NS + 2 * WEEK_NS) == 1
            got = [r.read_chunk("m", c).columns["v"].values.tolist()
                   for r, c in pairs]
            assert got == [[7.0]]
            return got

        both(tmp_path, scenario)

    def test_retention_removes_cold_copy(self, tmp_path):
        import os

        def scenario(env):
            hier = _svc_mod(env, "hierarchical")
            env.e.create_retention_policy("db", "short",
                                          duration_ns=24 * 3600 * NS,
                                          default=True)
            env.e.write_lines("db", f"m v=1 {BASE * NS}")
            env.e.flush_all()
            cold = str(env.root / "cold")
            svc = hier.HierarchicalService(env.e, cold, age_ns=1)
            assert svc.handle(now_ns=BASE * NS + WEEK_NS) == 1
            dropped = env.e.drop_expired_shards(
                now_ns=BASE * NS + 10 * WEEK_NS)
            assert len(dropped) == 1
            # neither the symlink nor the cold copy remains
            assert not [f for _r, _d, fs in os.walk(cold) for f in fs]
            data_dir = os.path.join(env.e.root, "data", "db", "short")
            assert not os.path.exists(data_dir) or not os.listdir(data_dir)
            return dropped

        both(tmp_path, scenario)

    def test_drop_database_removes_cold_copy(self, tmp_path):
        import os

        def scenario(env):
            hier = _svc_mod(env, "hierarchical")
            env.e.write_lines("db", f"m v=1 {BASE * NS}")
            env.e.flush_all()
            cold = str(env.root / "cold")
            assert hier.HierarchicalService(env.e, cold, age_ns=1).handle(
                now_ns=BASE * NS + 2 * WEEK_NS) == 1
            env.e.drop_database("db")
            return [f for _r, _d, fs in os.walk(cold) for f in fs]

        assert both(tmp_path, scenario) == []


class TestSherlock:
    def test_below_watermark_no_dump(self, tmp_path):
        def scenario(env):
            sh = _svc_mod(env, "sherlock")
            svc = sh.SherlockService(env.e, mem_mb_watermark=10**6,
                                     thread_watermark=10**6)
            return svc.handle(), svc.dumps

        assert both(tmp_path, scenario) == (None, 0)

    @pytest.mark.parametrize("trigger", ["rss", "threads"])
    def test_watermark_dump_and_cooldown(self, tmp_path, trigger):
        import os

        def scenario(env):
            sh = _svc_mod(env, "sherlock")
            kw = ({"mem_mb_watermark": 0.001} if trigger == "rss"
                  else {"thread_watermark": 0})
            svc = sh.SherlockService(env.e, cooldown_s=600, **kw)
            path = svc.handle()
            assert path and os.path.exists(path)
            with open(path) as f:
                content = f.read()
            assert "thread stacks" in content
            assert f"trigger: {trigger}" in content
            # the cooldown suppresses the next dump
            assert svc.handle() is None
            return svc.dumps, os.path.dirname(path) == os.path.join(
                env.e.root, "sherlock")

        assert both(tmp_path, scenario) == (1, True)

    def test_first_dump_immediate_despite_cooldown(self, tmp_path):
        def scenario(env):
            sh = _svc_mod(env, "sherlock")
            svc = sh.SherlockService(env.e, mem_mb_watermark=0.001,
                                     cooldown_s=10**9)
            return svc.handle() is not None

        assert both(tmp_path, scenario) is True

    def test_failed_dump_does_not_burn_cooldown(self, tmp_path, monkeypatch):
        def scenario(env):
            sh = _svc_mod(env, "sherlock")
            svc = sh.SherlockService(env.e, mem_mb_watermark=0.001,
                                     cooldown_s=600)

            def boom(*a):
                raise OSError("disk full")

            monkeypatch.setattr(svc, "_dump", boom)
            with pytest.raises(OSError):
                svc.handle()
            assert svc.dumps == 0
            monkeypatch.undo()
            assert svc.handle() is not None  # retried at once
            return svc.dumps

        assert both(tmp_path, scenario) == 1
