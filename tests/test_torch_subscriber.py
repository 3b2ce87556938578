"""The port's subscriptions (services/subscriber.py, CREATE, SHOW and DROP
SUBSCRIPTION, the engine's meta.json) against the JAX package, on the
CPU.

The cases of the reference's tests/test_subscriber_chunked.py
TestSubscriptions run in both packages on the same writes (the JAX
``Engine``/``Executor`` and the port's ``Engine(device="cpu")``/
``Executor``), each held to the reference test's own checks; besides,
the bodies each package's ``SubscriberManager`` posts to a sink for the
same writes (line protocol, structured rows, several measurements, ALL
and ANY destinations) are equal, ``points_to_lines`` gives the
reference's text, the DDL's answers and URL errors are equal, and a root
with subscriptions written by either package reopens in the other.
Their replication through the cluster's meta service is ROADMAP A8's.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.record import FieldType as JFT
from opengemini_tpu.services import subscriber as jsub
from opengemini_tpu.storage import engine as jeng
from opengemini_tpu_torch.ingest import line_protocol as tlp
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.record import FieldType as TFT
from opengemini_tpu_torch.services import subscriber as tsub
from opengemini_tpu_torch.storage import engine as teng

torch.set_num_threads(1)

NS = 1_000_000_000
BASE = 1_700_000_040


class Sink:
    """A small HTTP sink recording each POST's path and body."""

    def __init__(self):
        self.posts = []
        sink = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                sink.posts.append((self.path, self.rfile.read(n).decode()))
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
        self._t.start()

    def wait(self, n: int, timeout: float = 10.0) -> list:
        deadline = time.time() + timeout
        while len(self.posts) < n and time.time() < deadline:
            time.sleep(0.02)
        return list(self.posts)

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._t.join(timeout=5)


class Env:
    def __init__(self, name, root):
        self.name = name
        if name == "jax":
            self.e = jeng.Engine(str(root))
            self.ex = JExecutor(self.e)
            self.sub = jsub
        else:
            self.e = teng.Engine(str(root), device="cpu")
            self.ex = TExecutor(self.e)
            self.sub = tsub
        if "db" not in self.e.databases:
            self.e.create_database("db")

    def q(self, text, db="db"):
        return self.ex.execute(text, db=db, now_ns=(BASE + 10_000) * NS)


def both(tmp_path, scenario):
    outs = []
    for name in ("jax", "torch"):
        env = Env(name, tmp_path / name)
        try:
            outs.append(scenario(env))
        finally:
            env.e.close()
    assert outs[1] == outs[0]
    return outs[1]


def test_ddl_and_persistence(tmp_path):
    def scenario(env):
        res = env.q("CREATE SUBSCRIPTION s1 ON db DESTINATIONS ALL "
                    "'http://h1:9', 'http://h2:9'")
        assert "error" not in res["results"][0]
        env.q("CREATE SUBSCRIPTION s2 ON db DESTINATIONS ANY "
              "'https://h3:9'")
        env.e.create_database("other")
        env.q("CREATE SUBSCRIPTION s3 ON other DESTINATIONS ALL "
              "'http://h4:9'")
        shown = env.q("SHOW SUBSCRIPTIONS")
        s = shown["results"][0]["series"][0]
        assert s["values"][0][0] == "s1" and s["values"][0][1] == "ALL"
        with open(env.e.root + "/meta.json") as f:
            meta = json.load(f)
        dropped = [env.q("DROP SUBSCRIPTION s1 ON db"),
                   env.q("DROP SUBSCRIPTION nope ON db"),
                   env.q("SHOW SUBSCRIPTIONS")]
        return shown, [d.get("subscriptions") for d in meta["databases"]], \
            dropped

    both(tmp_path, scenario)
    # either package reopens the root the other wrote with the same
    # subscriptions and writes them back unchanged
    for name, other in (("jax", "torch"), ("torch", "jax")):
        env = Env(name, tmp_path / other)
        try:
            assert sorted(env.e.databases["db"].subscriptions) == ["s2"]
            before = (tmp_path / other / "meta.json").read_text()
            env.e.save_cq_state()
            assert json.loads((tmp_path / other / "meta.json").read_text()) \
                == json.loads(before)
        finally:
            env.e.close()


@pytest.mark.parametrize("stmt", [
    "CREATE SUBSCRIPTION s ON db DESTINATIONS ALL 'udp://h:9'",
    "CREATE SUBSCRIPTION s ON db DESTINATIONS ALL 'h:9'",
    "CREATE SUBSCRIPTION s ON nope DESTINATIONS ALL 'http://h:9'",
])
def test_ddl_errors(tmp_path, stmt):
    def scenario(env):
        return env.q(stmt), env.q("SHOW SUBSCRIPTIONS")

    out = both(tmp_path, scenario)
    assert "error" in out[0]["results"][0]


def _run_writes(env, writes):
    for kind, arg in writes:
        if kind == "lines":
            env.e.write_lines("db", arg)
        else:
            FT = JFT if env.name == "jax" else TFT
            env.e.write_rows("db", [
                (m, tags, t, {k: (getattr(FT, ft), v)
                              for k, (ft, v) in fields.items()})
                for m, tags, t, fields in arg])


WRITES = [
    ("lines", f"cpu,host=h1 v=1.5 {BASE * NS}"),
    ("lines", "\n".join(
        f"cpu,host=h{i % 3},region=r{i % 2} v={i * 0.25},n={i}i "
        f"{(BASE + i) * NS}" for i in range(50))
     + f'\nlog,host=h1 msg="a b \\"c\\"",ok=true {(BASE + 60) * NS}'),
    ("rows", [("mem", (("host", "h 1"),), (BASE + 70) * NS,
               {"used": ("FLOAT", 0.1), "n": ("INT", -3)})]),
]


@pytest.mark.parametrize("mode", ["ALL", "ANY"])
def test_forwarding(tmp_path, mode):
    def scenario(env):
        sinks = [Sink(), Sink()]
        mgr = env.sub.SubscriberManager(env.e)
        try:
            dests = ", ".join(f"'{s.url}'" for s in sinks)
            env.q(f"CREATE SUBSCRIPTION fwd ON db DESTINATIONS {mode} "
                  f"{dests}")
            _run_writes(env, WRITES)
            if mode == "ALL":
                got = [s.wait(len(WRITES)) for s in sinks]
            else:
                # round robin: the first sink gets writes 1 and 3
                got = [sinks[0].wait(2), sinks[1].wait(1)]
            env.q("DROP SUBSCRIPTION fwd ON db")
            env.e.write_lines("db", f"cpu,host=h9 v=9 {(BASE + 99) * NS}")
            time.sleep(0.3)  # nothing more arrives after the drop
            assert [len(s.posts) for s in sinks] == [len(g) for g in got]
            return got
        finally:
            mgr.stop()
            for s in sinks:
                s.stop()

    got = both(tmp_path, scenario)
    assert got[0][0] == ("/write?db=db&rp=autogen",
                         f"cpu,host=h1 v=1.5 {BASE * NS}")
    # the forwarded lines are the written points, each once per sink (ALL)
    # or once in all (ANY)
    posts = got[0] if mode == "ALL" else got[0] + got[1]
    pts = tlp.parse_lines("\n".join(body for _p, body in posts))
    assert len(pts) == 1 + 51 + 1


def test_inert_without_subscriptions(tmp_path):
    def scenario(env):
        sink = Sink()
        mgr = env.sub.SubscriberManager(env.e)
        try:
            env.e.write_lines("db", f"cpu v=1 {BASE * NS}")
            time.sleep(0.3)
            return sink.posts, mgr._q.qsize()
        finally:
            mgr.stop()
            sink.stop()

    assert both(tmp_path, scenario) == ([], 0)


def test_points_to_lines_equals_the_reference():
    rows = [
        ("my mst", (("ta g", "v,1"),), 123,
         {"f=x": ("FLOAT", 1.5), "s": ("STRING", 'a "b" \\c'),
          "i": ("INT", -7), "b": ("BOOL", True)}),
        ("cpu", (), 5, {"v": ("FLOAT", 1e-300), "w": ("FLOAT", 2.0 ** 60)}),
        ("cpu", (("a", "="),), 6, {"b": ("BOOL", False)}),
        ("empty", (("k", "v"),), 7, {}),
    ]

    def pts(FT):
        return [(m, tags, t, {k: (getattr(FT, ft), v)
                              for k, (ft, v) in f.items()})
                for m, tags, t, f in rows]

    text = tsub.points_to_lines(pts(TFT))
    assert text == jsub.points_to_lines(pts(JFT))
    [(mst, tags, t, fields), *_rest] = tlp.parse_lines(text)
    assert mst == "my mst" and tags == (("ta g", "v,1"),)
    assert fields["f=x"] == (TFT.FLOAT, 1.5)
    assert fields["s"] == (TFT.STRING, 'a "b" \\c')
    assert fields["i"] == (TFT.INT, -7)
    assert fields["b"] == (TFT.BOOL, True)
    assert len(_rest) == 2  # a point without fields is left out


def test_subscription_json_round_trip():
    s = tsub.Subscription("s", "ANY", ["http://a:1", "http://b:2"])
    assert s.to_json() == jsub.Subscription(
        "s", "ANY", ["http://a:1", "http://b:2"]).to_json()
    assert tsub.Subscription.from_json(s.to_json()).to_json() == s.to_json()
