"""The port's object-store tier (storage/objstore.py, services/obstier.py
and the engine's offload and hydration) against the JAX package's, on
the CPU.

Every case of the reference's tests/test_objstore_remote.py (the HTTP
client against ``MiniBucketServer`` on localhost, and the failpoints on
the offload and hydration paths) and its ``TestObsTier`` (the FS and
the HTTP store) runs on the port (``mirror_reference``). A group
offloaded by one package hydrates in the other, with the same answers
and the same bucket keys. The three faults ADVICE.md names in the
reference's client (an unexpected status swallowed and retried, a
Range-ignoring 200 handed back unsliced, a 403/5xx HEAD read as
"absent") are each driven against a bucket that misbehaves so: the
reference's answer stands next to the port's, and both are the fixed
behaviour, so the port copies the reference without a departure.
"""

from __future__ import annotations

import http.server
import os
import threading

import pytest
import torch

from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage import objstore as jobj
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from opengemini_tpu_torch.services.obstier import ObsTierService
from opengemini_tpu_torch.storage import objstore as tobj
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_objstore_remote"))
globals().update(mirror_reference("test_services", names={"TestObsTier"}))

NS = 1_000_000_000
BASE = 1_700_000_040
WEEK = 7 * 86400
Q = "SELECT count(v), sum(v), max(v) FROM m GROUP BY host"


def _load(engine):
    engine.create_database("db")
    engine.write_lines("db", "\n".join(
        f"m,host=h{w % 2} v={w} {(BASE + w * WEEK) * NS}" for w in range(4)))
    engine.flush_all()


def _bucket_keys(root):
    out = []
    for d, _dirs, files in os.walk(root):
        out.extend(os.path.relpath(os.path.join(d, f), root) for f in files)
    return sorted(out)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("store", ["fs", "http"])
def test_a_group_offloaded_by_one_package_hydrates_in_the_other(
        tmp_path, writer, store):
    root = str(tmp_path / "data")
    srv = None
    if store == "http":
        srv = jobj.MiniBucketServer().start()
    try:
        def make(mod):
            if store == "fs":
                return mod.FSObjectStore(str(tmp_path / "bucket"))
            return mod.HTTPObjectStore(srv.url)

        pk = {"jax": (JEngine, JExecutor, jobj),
              "port": (CpuEngine, TExecutor, tobj)}
        eng_cls, ex_cls, mod = pk[writer]
        e = eng_cls(root)
        _load(e)
        want = ex_cls(e).execute(Q, db="db")
        e.attach_object_store(make(mod))
        for key in sorted(e._shards)[:2]:
            assert e.offload_shard(*key)
        offloaded = sorted(e.obs_shards)
        keys = (_bucket_keys(str(tmp_path / "bucket")) if store == "fs"
                else sorted(srv.objects))
        e.close()
        reader = "port" if writer == "jax" else "jax"
        eng_cls, ex_cls, mod = pk[reader]
        e2 = eng_cls(root)
        assert sorted(e2.obs_shards) == offloaded
        e2.attach_object_store(make(mod))
        got = ex_cls(e2).execute(Q, db="db")
        assert not e2.obs_shards  # hydrated back
        e2.close()
        assert got == want
        assert keys and all(k.startswith("shards/db/autogen/") for k in keys)
    finally:
        if srv is not None:
            srv.stop()


def test_both_packages_offload_the_same_keys(tmp_path):
    """The bucket layout is the reference's: the same files under the
    same keys for the same writes."""
    keys = []
    for sub, eng_cls, mod in (("j", JEngine, jobj), ("t", CpuEngine, tobj)):
        e = eng_cls(str(tmp_path / sub / "data"))
        _load(e)
        e.attach_object_store(mod.FSObjectStore(str(tmp_path / sub / "b")))
        for key in sorted(e._shards):
            assert e.offload_shard(*key)
        keys.append(_bucket_keys(str(tmp_path / sub / "b")))
        e.close()
    assert keys[1] == keys[0]
    assert tobj.shard_prefix("db", "rp", 5) == jobj.shard_prefix("db", "rp", 5)


def test_the_obstier_service_moves_the_same_groups_as_jax(tmp_path):
    from opengemini_tpu.services.obstier import ObsTierService as JObs

    moved = []
    for sub, eng_cls, mod, svc_cls in (
            ("j", JEngine, jobj, JObs), ("t", CpuEngine, tobj, ObsTierService)):
        e = eng_cls(str(tmp_path / sub))
        _load(e)
        e.attach_object_store(mod.FSObjectStore(str(tmp_path / sub / "b")))
        n = svc_cls(e, age_ns=2 * WEEK * NS).handle(
            now_ns=(BASE + 4 * WEEK) * NS)
        moved.append((n, sorted(e.obs_shards)))
        e.close()
    assert moved[1] == moved[0] and moved[0][0] == 2


class _OddBucket:
    """A bucket on localhost that misbehaves in one way: ``status`` for
    every GET, HEAD answering ``head_status``, or GETs that ignore the
    Range header and send the whole object with 200."""

    def __init__(self, body=b"0123456789", status=200, head_status=200):
        self.hits = 0
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                outer.hits += 1
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_HEAD(self):
                outer.hits += 1
                self.send_response(head_status)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _answer(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))


def test_advice_an_unexpected_success_status_raises_loudly_once():
    """objstore.py:147: a 201 to a GET is an ObjectStoreError naming the
    status at the first attempt, not a retried 'failed: ...'."""
    got = []
    for mod in (jobj, tobj):
        b = _OddBucket(status=201)
        try:
            got.append((_answer(lambda: mod.HTTPObjectStore(
                b.url, retries=3).get_range("k", 0, 4)), b.hits))
        finally:
            b.close()
    assert got[1] == got[0]
    assert got[0] == (("ObjectStoreError", "GET k: HTTP 201"), 1)


@pytest.mark.parametrize("start,length", [(2, 4), (6, 10), (0, 10)])
def test_advice_a_range_ignoring_200_is_sliced_on_status(start, length):
    """objstore.py:186: a tail read past the end of an object from a
    server that ignores Range returns the bytes from `start`, never
    from offset 0."""
    body = b"0123456789"
    got = []
    for mod in (jobj, tobj):
        b = _OddBucket(body=body)
        try:
            got.append(mod.HTTPObjectStore(b.url).get_range(
                "k", start, length))
        finally:
            b.close()
    assert got[1] == got[0] == body[start:start + length]


@pytest.mark.parametrize("status", [404, 403, 500])
def test_advice_exists_is_false_only_on_404(status):
    """objstore.py:199: only a 404 means absent; 403 and 5xx raise."""
    got = []
    for mod in (jobj, tobj):
        b = _OddBucket(head_status=status)
        try:
            got.append(_answer(
                lambda: mod.HTTPObjectStore(b.url).exists("k")))
        finally:
            b.close()
    assert got[1] == got[0]
    if status == 404:
        assert got[0] == ("ok", False)
    else:
        assert got[0] == ("ObjectStoreError", f"HEAD k: HTTP {status}")
