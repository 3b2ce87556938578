"""The port's ts-server main (opengemini_tpu_torch/server/app.py) against
the JAX package's (opengemini_tpu/server/app.py), on the CPU.

Both packages read the same TOML into the same config and build the
same services from it; the SIGHUP reload applies the same changes
(services, tests/test_services.py:977-1005; the device mesh,
tests/test_multichip.py:471-486). ``ha-policy = "replication"`` attaches
the port's DataReplication. ``[device] coordinator-address`` joins a
process group (``_init_distributed``): its missing-key messages are the
reference's, its backend follows the device (gloo on the CPU, NCCL on
the card, never gloo for a card). ``python -m opengemini_tpu_torch.server.app
-device cpu`` serves /ping, /write and /query in a subprocess and stops
on SIGTERM. Without CUDA and without ``-device cpu`` the port refuses to
start: the reference degrades to the CPU (tests/test_http.py:552), the
port never does.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import pytest

from opengemini_tpu.parallel import runtime as jrt
from opengemini_tpu.server import app as japp
from opengemini_tpu_torch.parallel import runtime as trt
from opengemini_tpu_torch.server import app as tapp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOML = """
[data]
dir = "{dir}"
wal-fsync = false
flush-threshold-mb = 16
[http]
bind-address = "127.0.0.1:{port}"
[services]
compact-interval-s = 600
compact-max-files = 4
retention-interval-s = 900
store-monitor = false
"""


@pytest.fixture(autouse=True)
def _no_leaked_mesh():
    yield
    trt.set_mesh(None)
    jrt.set_mesh(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(svc) -> None:
    """Tear down a built (never started) server."""
    svc.subscriber.stop()
    if getattr(svc, "rules_manager", None) is not None:
        svc.rules_manager.close()
    if svc.meta_store is not None:
        svc.meta_store.stop()
    if getattr(svc.router, "datarep", None) is not None:
        svc.router.datarep.stop()
    svc.httpd.server_close()
    svc.engine.close()


def test_load_config_reads_the_same_file(tmp_path):
    path = tmp_path / "x.toml"
    path.write_text(TOML.format(dir=tmp_path / "d", port=0)
                    + '[device]\nmesh-axes = ["shard"]\n')
    assert tapp.load_config(str(path)) == japp.load_config(str(path))
    assert tapp.load_config(None) == japp.load_config(None)


def test_build_makes_the_references_services(tmp_path):
    cfg = {"data": {"dir": str(tmp_path / "j")},
           "http": {"bind-address": "127.0.0.1:0"},
           "services": {"compact-interval-s": 120, "scrub-mb": 8}}
    jsvc = japp.build(cfg)
    tsvc = tapp.build(dict(cfg, data={"dir": str(tmp_path / "t")}),
                      device="cpu")
    try:
        assert [s.name for s in tsvc.services] == \
            [s.name for s in jsvc.services]
        for js, ts in zip(jsvc.services, tsvc.services):
            assert ts.interval_s == js.interval_s, ts.name
        assert str(tsvc.engine.device) == "cpu"
        assert tsvc.scrub_service is not None
        assert trt.get_mesh() is None
    finally:
        _close(tsvc)
        _close(jsvc)


def test_apply_runtime_config_as_the_reference(tmp_path):
    svcs = {}
    for name, mod, kw in (("jax", japp, {}), ("torch", tapp,
                                              {"device": "cpu"})):
        svcs[name] = mod.build({
            "data": {"dir": str(tmp_path / name)},
            "http": {"bind-address": "127.0.0.1:0"},
            "services": {"compact-interval-s": 600,
                         "compact-max-files": 4}}, **kw)
    try:
        steps = [
            {"services": {"compact-interval-s": 30, "compact-max-files": 8,
                          "retention-interval-s": 1800}},
            {"services": {"compact-interval-s": 30}},  # idempotent
        ]
        for cfg in steps:
            assert tapp._apply_runtime_config(svcs["torch"], cfg) == \
                japp._apply_runtime_config(svcs["jax"], cfg)
        comp = next(s for s in svcs["torch"].services
                    if s.name == "compaction")
        assert comp.interval_s == 30.0 and comp.max_files == 8
        # atomic: one bad value rejects the whole reload in both
        bad = {"services": {"retention-interval-s": 60,
                            "compact-max-files": "four"}}
        for name, mod in (("torch", tapp), ("jax", japp)):
            with pytest.raises(ValueError):
                mod._apply_runtime_config(svcs[name], bad)
            ret = next(s for s in svcs[name].services
                       if s.name == "retention")
            assert ret.interval_s == 1800.0
    finally:
        for svc in svcs.values():
            _close(svc)


def test_mesh_hot_reload_transitions_as_the_reference():
    """[device] is SIGHUP-reloadable: a geometry change swaps the mesh
    (the epoch rises, so sharded caches reshard), the same geometry is a
    no-op, and an empty section turns the mesh off."""
    steps = [{"mesh-axes": ["shard"], "mesh-devices": 8},
             {"mesh-axes": ["shard"], "mesh-devices": 8},
             {"mesh-axes": ["shard"], "mesh-devices": 4},
             {"mesh-axes": ["shard", "time"], "mesh-devices": 4},
             {}, {}]
    trt.set_mesh(None)
    jrt.set_mesh(None)
    for cfg in steps:
        e_t, e_j = trt.mesh_epoch(), jrt.mesh_epoch()
        got = tapp._apply_mesh_config(cfg, "cpu")
        assert got == japp._apply_mesh_config(cfg)
        assert (trt.mesh_epoch() != e_t) == bool(got)
        assert (jrt.mesh_epoch() != e_j) == bool(got)
        tm, jm = trt.get_mesh(), jrt.get_mesh()
        assert (tm is None) == (jm is None)
        if tm is not None:
            assert tm.size == jm.size
            assert tm.axis_names == tuple(jm.axis_names)
            assert tm.devices.shape == jm.devices.shape
    assert trt.get_mesh() is None


def test_build_configures_the_mesh_from_device(tmp_path):
    cfg = {"data": {"dir": str(tmp_path / "m")},
           "http": {"bind-address": "127.0.0.1:0"},
           "device": {"mesh-axes": ["shard"], "mesh-devices": 4}}
    svc = tapp.build(cfg, device="cpu")
    try:
        m = trt.get_mesh()
        assert m is not None and m.size == 4
        assert {str(d) for d in m.shard_devices} == {"cpu"}
    finally:
        _close(svc)
    # a config without [device] turns an inherited mesh off
    svc = tapp.build({"data": {"dir": str(tmp_path / "n")},
                      "http": {"bind-address": "127.0.0.1:0"}},
                     device="cpu")
    try:
        assert trt.get_mesh() is None
    finally:
        _close(svc)


def test_ha_policy_replication_attaches_data_replication(tmp_path):
    from opengemini_tpu_torch.parallel.datarep import DataReplication

    port = _free_port()
    cfg = {"data": {"dir": str(tmp_path / "r")},
           "http": {"bind-address": f"127.0.0.1:{port}"},
           "meta": {"node-id": "n1", "token": "t"},
           "cluster": {"data-routing": True, "ha-policy": "replication",
                       "hint-interval-s": 3600,
                       "balance-interval-s": 0}}
    svc = tapp.build(cfg, device="cpu")
    try:
        assert isinstance(svc.router.datarep, DataReplication)
        assert svc.executor.router is svc.router
        names = [s.name for s in svc.services]
        assert "hintreplay" in names and "migration" in names
    finally:
        _close(svc)
    cfg["data"] = {"dir": str(tmp_path / "w")}
    cfg["cluster"] = dict(cfg["cluster"], **{"ha-policy": "write-available"})
    svc = tapp.build(cfg, device="cpu")
    try:
        assert getattr(svc.router, "datarep", None) is None
    finally:
        _close(svc)


@pytest.fixture
def no_world(monkeypatch):
    """The process group state of server/app.py and the world of
    parallel/runtime.py, restored after the test."""
    monkeypatch.setattr(tapp, "_DISTRIBUTED_UP", False)
    yield
    trt.set_world(None)


@pytest.mark.parametrize("missing", [
    ("num-processes",), ("process-id",), ("num-processes", "process-id")])
def test_coordinator_without_its_keys_exits_like_the_reference(
        no_world, missing):
    dev_cfg = {"coordinator-address": "127.0.0.1:1234",
               "num-processes": 2, "process-id": 0}
    for k in missing:
        del dev_cfg[k]
    msgs = []
    for init in (tapp._init_distributed, japp._init_jax_distributed):
        with pytest.raises(SystemExit) as e:
            init(dev_cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "[device] coordinator-address requires " + " and ".join(missing))
    assert trt.get_world() is None


def _record_init(monkeypatch, fail: bool = False) -> list:
    """torch.distributed.init_process_group recording its calls (and
    raising when `fail`), with a card to set for the NCCL case."""
    import torch
    import torch.distributed as tdist

    calls = []

    def init(backend, **kw):
        calls.append(dict(kw, backend=backend))
        if fail:
            raise RuntimeError(f"{backend} init failed")

    monkeypatch.setattr(tdist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl")])
def test_init_distributed_backend_follows_the_device(
        monkeypatch, no_world, device, backend):
    calls = _record_init(monkeypatch)
    monkeypatch.setenv("OGT_DIST_TIMEOUT_S", "7")
    tapp._init_distributed({"coordinator-address": "10.0.0.1:9999",
                            "num-processes": 4, "process-id": 3}, device)
    assert len(calls) == 1
    got = calls[0]
    assert got["backend"] == backend
    assert got["init_method"] == "tcp://10.0.0.1:9999"
    assert (got["world_size"], got["rank"]) == (4, 3)
    assert got["timeout"].total_seconds() == 7
    world = trt.get_world()
    assert (world.rank, world.size, world.backend) == (3, 4, backend)
    assert world.device.type == device


def test_a_failed_nccl_init_raises_and_never_tries_gloo(monkeypatch,
                                                       no_world):
    calls = _record_init(monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="nccl init failed"):
        tapp._init_distributed({"coordinator-address": "127.0.0.1:1",
                                "num-processes": 2, "process-id": 0},
                               "cuda")
    assert [c["backend"] for c in calls] == ["nccl"]
    assert trt.get_world() is None and not tapp._DISTRIBUTED_UP


def test_init_distributed_is_idempotent(monkeypatch, no_world):
    calls = _record_init(monkeypatch)
    dev_cfg = {"coordinator-address": "127.0.0.1:1", "num-processes": 2,
               "process-id": 1}
    tapp._init_distributed(dev_cfg, "cpu")
    tapp._init_distributed(dev_cfg, "cpu")
    tapp._init_distributed({}, "cpu")
    assert len(calls) == 1 and trt.get_world().rank == 1


def test_build_joins_the_group_before_the_mesh(tmp_path, no_world):
    """build() with the [device] keys on the CPU: a gloo group of one
    process, then a global mesh over it (make_mesh's all_gather of the
    ranks' device counts), as one process on one card is under NCCL."""
    import torch.distributed as tdist

    cfg = {"data": {"dir": str(tmp_path / "x")},
           "http": {"bind-address": "127.0.0.1:0"},
           "services": {"store-monitor": False},
           "device": {"mesh-axes": ["shard"], "mesh-devices": 2,
                      "coordinator-address": f"127.0.0.1:{_free_port()}",
                      "num-processes": 1, "process-id": 0}}
    svc = tapp.build(cfg, device="cpu")
    try:
        world, mesh = trt.get_world(), trt.get_mesh()
        assert (world.size, world.backend) == (1, "gloo")
        assert mesh.world is world and mesh.size == 2
        assert mesh.local_shards == [0, 1] and mesh.shard_ranks == [0, 0]
    finally:
        _close(svc)
        # the main's shutdown leaves the group
        tapp._shutdown_distributed()
    assert not tdist.is_initialized() and not tapp._DISTRIBUTED_UP
    assert trt.get_world() is None and trt.get_mesh() is None


def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def _post(port, path, body: bytes, **params):
    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def _wait_listening(proc, port, pidfile, timeout=60.0):
    """Wait until the server answers /ping and has written its pidfile
    (main writes it after the listener starts, just before it prints
    that it listens)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{proc.stdout.read()}")
        try:
            if pidfile.exists() and pidfile.read_text() and \
                    _get(port, "/ping")[0] == 204:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("server did not answer /ping")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OGT_RULES"] = "0"
    return env


def test_main_on_the_cpu_serves_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    cfg = tmp_path / "x.toml"
    cfg.write_text(TOML.format(dir=tmp_path / "data", port=port))
    pidfile = tmp_path / "pid"
    proc = subprocess.Popen(
        [sys.executable, "-m", "opengemini_tpu_torch.server.app",
         "-config", str(cfg), "-device", "cpu", "-pidfile", str(pidfile)],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_listening(proc, port, pidfile)
        assert int(pidfile.read_text()) == proc.pid
        assert _post(port, "/query", b"", q="CREATE DATABASE db")[0] == 200
        assert _post(port, "/write", b"m,host=a v=1 1000000000\n"
                     b"m,host=a v=3 2000000000", db="db")[0] == 204
        status, body = _get(port, "/query", db="db",
                            q="SELECT sum(v), count(v) FROM m")
        assert status == 200
        series = json.loads(body)["results"][0]["series"][0]
        assert series["values"][0][1:] == [4, 2]
        # SIGHUP re-reads the file: a changed interval applies live
        cfg.write_text(TOML.format(dir=tmp_path / "data", port=port)
                       .replace("compact-interval-s = 600",
                                "compact-interval-s = 60"))
        proc.send_signal(signal.SIGHUP)
        time.sleep(0.5)
        assert _get(port, "/ping")[0] == 204
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "listening on http://" in out
    assert "config reloaded: compaction.interval_s=60.0" in out
    assert "shutting down" in out
    assert not pidfile.exists()


def test_main_without_cuda_refuses_to_start(tmp_path):
    """The reference degrades to the CPU when its accelerator is broken
    (tests/test_http.py:552); the port exits non-zero, naming the
    device, and never serves on the CPU unasked."""
    port = _free_port()
    cfg = tmp_path / "x.toml"
    cfg.write_text(TOML.format(dir=tmp_path / "data", port=port))
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine with one
    r = subprocess.run(
        [sys.executable, "-m", "opengemini_tpu_torch.server.app",
         "-config", str(cfg)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "'cuda'" in r.stderr and "-device cpu" in r.stderr
    assert "listening" not in r.stdout
    assert not (tmp_path / "data").exists()


BASE_NS = 1_600_000_000 * 10**9  # old enough for any age threshold


def _edge_case_flight(port, extra):
    fl = pytest.importorskip("pyarrow.flight")
    pa = pytest.importorskip("pyarrow")
    assert _post(port, "/query", b"", q="CREATE DATABASE db")[0] == 200
    client = fl.connect(f"grpc://127.0.0.1:{extra['flight']}")
    try:
        for _ in range(100):
            try:
                list(client.do_action(fl.Action("ping", b"")))
                break
            except fl.FlightError:
                time.sleep(0.05)
        table = pa.table({"time": pa.array([BASE_NS, BASE_NS + 1], pa.int64()),
                          "host": pa.array(["a", "b"]),
                          "v": pa.array([1.5, 2.5])})
        desc = fl.FlightDescriptor.for_command(json.dumps(
            {"db": "db", "measurement": "m", "tag_columns": ["host"]}
        ).encode())
        writer, _ = client.do_put(desc, table.schema)
        writer.write_table(table)
        writer.close()
        got = client.do_get(fl.Ticket(json.dumps(
            {"db": "db", "q": "SELECT sum(v) FROM m"}).encode())).read_all()
        assert got.column("sum").to_pylist() == [4.0]
    finally:
        client.close()


def _edge_case_obs(port, extra):
    assert _post(port, "/query", b"", q="CREATE DATABASE db")[0] == 200
    lines = "\n".join(f"m,host=h{i % 2} v={i} {BASE_NS + i * 86400 * 10**9}"
                      for i in range(4)).encode()
    assert _post(port, "/write", lines, db="db")[0] == 204
    assert _post(port, "/debug/ctrl", b"", mod="flush")[0] == 200
    deadline = time.monotonic() + 30
    while not extra["objects"]():
        assert time.monotonic() < deadline, "nothing was offloaded"
        time.sleep(0.1)


def _edge_case_hydrate(port, extra):
    """A query over the offloaded range hydrates it (the service does
    not tick in this run: its interval is an hour)."""
    status, body = _get(port, "/query", db="db",
                        q="SELECT count(v), sum(v) FROM m")
    assert status == 200
    row = json.loads(body)["results"][0]["series"][0]["values"][0]
    assert row[1:] == [4, 6]


def _edge_case_tag_array(port, extra):
    assert _post(port, "/query", b"", q="CREATE DATABASE db")[0] == 200
    assert _post(port, "/write", f"cpu,host=[a,b,c] v=2 {BASE_NS}".encode(),
                 db="db")[0] == 204
    status, body = _get(port, "/query", db="db",
                        q="SELECT count(v) FROM cpu GROUP BY host")
    series = json.loads(body)["results"][0]["series"]
    assert sorted(s["tags"]["host"] for s in series) == ["a", "b", "c"]


def _serve_main(tmp_path, text, run, extra):
    """Start ``main`` on the config `text`, call run(port, extra), stop
    it with SIGTERM; it must exit 0."""
    port = int(re.search(r'bind-address = "127.0.0.1:(\d+)"', text)[1])
    cfg = tmp_path / "x.toml"
    cfg.write_text(text)
    pidfile = tmp_path / "pid"
    proc = subprocess.Popen(
        [sys.executable, "-m", "opengemini_tpu_torch.server.app",
         "-config", str(cfg), "-device", "cpu", "-pidfile", str(pidfile)],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_listening(proc, port, pidfile)
        run(port, extra)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "shutting down" in out


@pytest.mark.parametrize("case", ["flight", "obs-dir", "obs-url",
                                  "enable-tag-array"])
def test_a9_settings_start_with_the_main_and_serve(tmp_path, case):
    """The settings the main refused before the edges were ported: each
    starts with ``main`` and serves what it configures. The object
    store: one run's service offloads the groups, the next run's query
    hydrates them."""
    from opengemini_tpu_torch.storage.objstore import MiniBucketServer

    text = TOML.format(dir=tmp_path / "data", port=_free_port())
    extra, bucket = {}, None
    try:
        if case == "flight":
            extra["flight"] = _free_port()
            text += ('[flight]\nbind-address = '
                     f'"127.0.0.1:{extra["flight"]}"\n')
            _serve_main(tmp_path, text, _edge_case_flight, extra)
        elif case in ("obs-dir", "obs-url"):
            if case == "obs-dir":
                obs = tmp_path / "bucket"
                line = f'obs-dir = "{obs}"'
                extra["objects"] = lambda: obs.exists() and any(
                    obs.rglob("*.tsf"))
            else:
                bucket = MiniBucketServer().start()
                line = f'obs-url = "{bucket.url}"'
                extra["objects"] = lambda: any(
                    k.endswith(".tsf") for k in list(bucket.objects))
            for interval, run in (("0.2", _edge_case_obs),
                                  ("3600", _edge_case_hydrate)):
                _serve_main(tmp_path, text.replace(
                    "[services]\n", f"[services]\n{line}\nobs-age-days = 1"
                    f"\nobs-interval-s = {interval}\n"), run, extra)
        else:
            _serve_main(tmp_path, text.replace(
                "[data]\n", "[data]\nenable-tag-array = true\n"),
                _edge_case_tag_array, extra)
    finally:
        if bucket is not None:
            bucket.stop()
