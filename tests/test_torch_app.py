"""The port's ts-server main (opengemini_tpu_torch/server/app.py) against
the JAX package's (opengemini_tpu/server/app.py), on the CPU.

Both packages read the same TOML into the same config and build the
same services from it; the SIGHUP reload applies the same changes
(services, tests/test_services.py:977-1005; the device mesh,
tests/test_multichip.py:471-486). ``ha-policy = "replication"`` attaches
the port's DataReplication. The services the port does not have yet
raise when configured. ``python -m opengemini_tpu_torch.server.app
-device cpu`` serves /ping, /write and /query in a subprocess and stops
on SIGTERM. Without CUDA and without ``-device cpu`` the port refuses to
start: the reference degrades to the CPU (tests/test_http.py:552), the
port never does.
"""

import json
import os
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


@pytest.mark.parametrize("section,key,value,item", [
    ("flight", "bind-address", "127.0.0.1:0", "A9"),
    ("services", "obs-dir", "/nonexistent/obs", "A9"),
    ("services", "obs-url", "http://127.0.0.1:1/b", "A9"),
    ("data", "enable-tag-array", True, "A9"),
    ("device", "coordinator-address", "127.0.0.1:1234", "A8.4"),
])
def test_features_not_ported_yet_raise(tmp_path, section, key, value, item):
    cfg = {"data": {"dir": str(tmp_path / "x")},
           "http": {"bind-address": "127.0.0.1:0"}}
    cfg.setdefault(section, {})[key] = value
    with pytest.raises(tapp.NotPorted,
                       match=f"not supported by this port yet "
                             rf"\(ROADMAP {item}\)"):
        tapp.build(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "x" / "meta.json")


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
