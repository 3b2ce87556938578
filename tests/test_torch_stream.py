"""The port's stream engine (services/stream.py: window aggregation at
ingest) and its CREATE/SHOW/DROP STREAM, against the JAX package, on the
CPU.

The stream cases of the reference's tests/test_subquery_stream.py
(TestStream and the stream cases of TestReviewRegressions) run in both
packages on the same writes (the JAX ``Engine``/``Executor``/
``StreamService`` and the port's ``Engine(device="cpu")``/``Executor``/
``StreamService``), each held to the reference test's own checks; the
port's flush counts, window cells and errors equal the JAX package's
(counts, extremes and first/last exact; means and sums at rel 1e-12).
Besides: a seeded many-series stream over every accumulable aggregate,
and the bulk load's writes reach the stream like any other write.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.services.stream import StreamService as JStream
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.services.stream import StreamService as TStream
from opengemini_tpu_torch.storage.engine import Engine as TEngine

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040

CS = ("CREATE STREAM s1 ON SELECT sum(v), count(v) INTO cpu_1m FROM cpu "
      "GROUP BY time(1m), host")


class Pkg:
    def __init__(self, name, engine_cls, executor_cls, stream_cls, kw):
        self.name = name
        self.engine_cls = engine_cls
        self.executor_cls = executor_cls
        self.stream_cls = stream_cls
        self.kw = kw


JAX = Pkg("jax", JEngine, JExecutor, JStream, {})
PORT = Pkg("torch", TEngine, TExecutor, TStream, {"device": "cpu"})
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
        self.e = p.engine_cls(str(root), **p.kw)
        self.e.create_database("db")
        self.ex = p.executor_cls(self.e)

    def q(self, text):
        return self.ex.execute(text, db="db", now_ns=(BASE + 10_000) * NS)


def both(tmp_path, scenario):
    outs = []
    for p in PKGS:
        env = Env(p, tmp_path / p.name)
        try:
            outs.append(scenario(env))
        finally:
            env.e.close()
    _close(outs[1], outs[0])
    return outs[1]


def series_of(res, i=0):
    return res["results"][0]["series"][i]


class TestStream:
    def test_create_show_drop(self, tmp_path):
        def scenario(env):
            res = env.q(CS)
            assert "error" not in res["results"][0]
            shown = env.q("SHOW STREAMS")
            assert series_of(shown)["values"][0][0] == "s1"
            env.q("DROP STREAM s1")
            after = env.q("SHOW STREAMS")
            assert all(not s["values"]
                       for s in after["results"][0].get("series", []))
            return res, shown, after

        both(tmp_path, scenario)

    def test_stream_persisted(self, tmp_path):
        def scenario(env):
            env.q(CS)
            env.e.close()
            env.e = env.p.engine_cls(str(env.root), **env.p.kw)
            return env.e.databases["db"].streams["s1"].to_json()

        both(tmp_path, scenario)

    def test_unsupported_agg_rejected(self, tmp_path):
        def scenario(env):
            res = env.q("CREATE STREAM sx ON SELECT percentile(v, 99) INTO x "
                        "FROM cpu GROUP BY time(1m)")
            assert "supports only" in res["results"][0]["error"]
            other = [env.q(s)["results"][0]["error"] for s in (
                "CREATE STREAM sy ON SELECT sum(v) INTO x FROM cpu "
                "WHERE host = 'a' GROUP BY time(1m)",
                "CREATE STREAM sz ON SELECT sum(v) INTO x FROM cpu, mem "
                "GROUP BY time(1m)",
            )]
            return res, other

        both(tmp_path, scenario)

    def test_ingest_window_flush(self, tmp_path):
        def scenario(env):
            svc = env.p.stream_cls(env.e, interval_s=3600)
            env.q(CS)
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h0 v={i} {(BASE + i * 10) * NS}"
                for i in range(13)))
            flushed = [svc.handle(now_ns=(BASE + 125) * NS)]
            assert flushed == [2]
            out = env.q("SELECT sum, count FROM cpu_1m GROUP BY host")
            s = series_of(out)
            assert s["tags"]["host"] == "h0"
            vals = s["values"]
            assert vals[0][1] == sum(range(6)) and vals[0][2] == 6
            assert vals[1][1] == sum(range(6, 12)) and vals[1][2] == 6
            assert len(vals) == 2
            flushed.append(svc.handle(now_ns=(BASE + 240) * NS))
            assert flushed[1] == 1
            return flushed, out

        both(tmp_path, scenario)

    def test_delay_holds_window(self, tmp_path):
        def scenario(env):
            svc = env.p.stream_cls(env.e, interval_s=3600)
            env.q("CREATE STREAM s2 ON SELECT mean(v) INTO m_1m FROM m "
                  "GROUP BY time(1m) DELAY 30s")
            env.e.write_lines("db", f"m v=4 {BASE * NS}")
            held = svc.handle(now_ns=(BASE + 70) * NS)
            assert held == 0
            done = svc.handle(now_ns=(BASE + 95) * NS)
            assert done == 1
            out = env.q("SELECT mean FROM m_1m")
            assert series_of(out)["values"][0][1] == 4.0
            return held, done, out

        both(tmp_path, scenario)

    def test_seeded_hosts_every_accumulable_agg(self, tmp_path):
        rng = np.random.default_rng(29)
        lines = []
        for k in range(240):
            h = int(rng.integers(0, 16))
            v = float(rng.normal() * 100)
            lines.append(f"cpu,host=h{h},dc=d{h % 2} v={v!r} "
                         f"{(BASE + k * 2) * NS}")
        body = "\n".join(lines)

        def scenario(env):
            svc = env.p.stream_cls(env.e, interval_s=3600)
            env.q("CREATE STREAM s3 ON SELECT count(v), sum(v), min(v), "
                  "max(v), mean(v) INTO cpu_agg FROM cpu "
                  "GROUP BY time(1m), dc")
            env.e.write_lines("db", body)
            flushed = svc.handle(now_ns=(BASE + 600) * NS)
            return flushed, env.q("SELECT * FROM cpu_agg GROUP BY *")

        both(tmp_path, scenario)

    def test_bulk_load_feeds_the_stream(self, tmp_path):
        """The port's bulk load (convert.load_columnar) notifies the
        write observers like /write does: its rows reach the stream."""
        from opengemini_tpu_torch import convert

        env = Env(PORT, tmp_path / "torch")
        try:
            svc = PORT.stream_cls(env.e, interval_s=3600)
            env.q(CS)
            n = 12
            tables = {"cpu": {
                "series_keys": ["cpu,host=h0"],
                "series": np.zeros(n, np.int64),
                "times": (BASE + np.arange(n, dtype=np.int64) * 10) * NS,
                "fields": {"v": (np.arange(n, dtype=np.float64),
                                 np.ones(n, bool))},
            }}
            convert.load_columnar(env.e, "db", tables)
            assert svc.handle(now_ns=(BASE + 125) * NS) == 2
            vals = series_of(env.q("SELECT sum, count FROM cpu_1m"))["values"]
            assert [r[1:] for r in vals] == [[15.0, 6], [51.0, 6]]
        finally:
            env.e.close()


class TestReviewRegressions:
    def test_late_data_dropped_not_reaggregated(self, tmp_path):
        def scenario(env):
            svc = env.p.stream_cls(env.e, interval_s=3600)
            env.q(CS)
            env.e.write_lines("db", "\n".join(
                f"cpu,host=h0 v={i} {(BASE + i * 10) * NS}"
                for i in range(6)))
            first = svc.handle(now_ns=(BASE + 70) * NS)
            assert first == 1
            env.e.write_lines("db", f"cpu,host=h0 v=100 {(BASE + 5) * NS}")
            second = svc.handle(now_ns=(BASE + 130) * NS)
            assert second == 0
            out = env.q("SELECT sum FROM cpu_1m")
            vals = [r[1] for r in series_of(out)["values"]]
            assert vals == [sum(range(6))]
            return first, second, out

        both(tmp_path, scenario)

    def test_self_feed_rejected_even_qualified(self, tmp_path):
        def scenario(env):
            a = env.q("CREATE STREAM bad ON SELECT sum(v) INTO db..cpu FROM "
                      "cpu GROUP BY time(1m)")
            assert "differ from its source" in a["results"][0]["error"]
            b = env.q("CREATE STREAM bad2 ON SELECT sum(v) INTO x FROM "
                      "db2..cpu GROUP BY time(1m)")
            assert "unqualified" in b["results"][0]["error"]
            return a, b

        both(tmp_path, scenario)

    def test_concurrent_stream_ddl_does_not_break_ingest(self, tmp_path):
        def scenario(env):
            svc = env.p.stream_cls(env.e, interval_s=3600)
            env.q(CS)
            stop = threading.Event()

            def ddl_loop():
                i = 0
                while not stop.is_set():
                    env.q(f"CREATE STREAM tmp{i} ON SELECT sum(v) INTO t{i} "
                          f"FROM src GROUP BY time(1m)")
                    env.q(f"DROP STREAM tmp{i}")
                    i += 1

            t = threading.Thread(target=ddl_loop)
            t.start()
            try:
                for k in range(20):
                    env.e.write_lines("db",
                                      f"cpu,host=h0 v={k} {(BASE + k) * NS}")
            finally:
                stop.set()
                t.join()
            svc.handle(now_ns=(BASE + 200) * NS)
            out = env.q("SELECT count FROM cpu_1m")
            assert series_of(out)["values"][0][1] == 20
            return out

        both(tmp_path, scenario)
