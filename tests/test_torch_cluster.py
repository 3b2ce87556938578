"""The port's cluster data plane (parallel/cluster.py, services/
hintreplay.py, the executor's router path, server/http.py's cluster
routes) against the JAX package, on the CPU.

Every case of the reference's tests/test_cluster_data.py runs on the
port (test_torch_raft.mirror_reference): placement, remote shard
proxies, the write split, rf 2 failover, the binary wire, hinted
handoff and its replay rules, health, the write-consistency levels, the
CQ on the leader and INTO routing.

Besides, whole clusters wired as the JAX package's server/app.py wires a
node (a ``MetaStore`` over ``HttpTransport`` with ``attach_engine`` and
``attach_users``, the ``register_node`` proposals, a ``DataRouter`` at
rf 2 and consistency "one", a ``HintReplayService``):
  - three port nodes and three JAX nodes take the same seeded writes
    through a coordinator's routed /write, and every query answers the
    same on both and as one JAX engine holding all the rows does (sums,
    means, stddev and derivatives rel 1e-12, everything else exact), also
    with a node down, and after
    its hints are replayed;
  - mixed clusters, a port coordinator with a JAX peer and a JAX
    coordinator with a port peer, answer the pushdown, the raw scans and
    the routed writes as the all-JAX cluster does;
  - hint files written by either package's router are replayed by the
    other's.
"""

from __future__ import annotations

import json
import math
import os
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.meta.service import HttpTransport as JTransport
from opengemini_tpu.meta.service import MetaStore as JMetaStore
from opengemini_tpu.parallel import cluster as jcluster
from opengemini_tpu.server.http import HttpService as JHttp
from opengemini_tpu.services.hintreplay import HintReplayService as JHints
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.meta.service import HttpTransport as TTransport
from opengemini_tpu_torch.meta.service import MetaStore as TMetaStore
from opengemini_tpu_torch.parallel import cluster as tcluster
from opengemini_tpu_torch.server.http import HttpService as THttp
from opengemini_tpu_torch.services.hintreplay import (
    HintReplayService as THints,
)
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_cluster_data"))

NS = 1_000_000_000
BASE = 1_700_002_800  # an hour boundary
TOKEN = "cluster-secret"


class Pkg:
    def __init__(self, name, engine, http, store, transport, cluster,
                 hints):
        self.name = name
        self.engine = engine
        self.http = http
        self.store = store
        self.transport = transport
        self.cluster = cluster
        self.hints = hints


JAX = Pkg("jax", JEngine, JHttp, JMetaStore, JTransport, jcluster, JHints)
PORT = Pkg("torch", CpuEngine, THttp, TMetaStore, TTransport, tcluster,
           THints)


class Node:
    """One node wired as the reference's server/app.py wires one."""

    def __init__(self, pkg, nid, root, port=0):
        self.pkg, self.nid, self.root = pkg, nid, str(root)
        self.engine = pkg.engine(self.root)
        self.svc = pkg.http(self.engine, "127.0.0.1", port)
        self.addr = f"127.0.0.1:{self.svc.port}"

    def wire(self, addrs, rf, consistency):
        p = self.pkg
        transport = p.transport(dict(addrs), token=TOKEN,
                                self_addr=self.addr)
        ms = p.store(self.nid, sorted(addrs), transport,
                     storage_path=os.path.join(self.root, "meta.raftlog"))
        ms.token = TOKEN
        ms.attach_engine(self.engine)
        ms.attach_users(self.svc.users)
        self.svc.meta_store = ms
        self.svc.executor.meta_store = ms
        self.router = p.cluster.DataRouter(
            self.engine, ms, self.nid, self.addr, token=TOKEN, rf=rf,
            write_consistency=consistency)
        self.svc.router = self.router
        self.svc.executor.router = self.router
        self.hints = p.hints(self.router, 3600.0)
        ms.start()
        self.svc.start()

    def stop(self):
        self.svc.stop()
        self.svc.meta_store.stop()
        self.engine.close()


def _hour_groups(engine) -> bool:
    """The replicated CREATE DATABASE ... WITH SHARD DURATION 1h has
    reached this engine (its create_rp applies after create_database)."""
    d = engine.databases.get("db")
    rp = d.rps.get(d.default_rp) if d is not None else None
    return rp is not None and rp.shard_duration_ns == 3600 * NS


class Cluster:
    def __init__(self, pkgs, tmp_path, rf=2, consistency="one",
                 nids=("n1", "n2", "n3")):
        self.nodes = {nid: Node(pkg, nid, tmp_path / nid)
                      for nid, pkg in zip(nids, pkgs)}
        addrs = {nid: n.addr for nid, n in self.nodes.items()}
        for n in self.nodes.values():
            n.wire(addrs, rf, consistency)
        leader = self.leader()
        for nid, n in sorted(self.nodes.items()):
            assert leader.svc.meta_store.propose_and_wait(
                {"op": "register_node", "id": nid, "addr": n.addr,
                 "role": "data"})
        res = leader.svc.executor.execute(
            "CREATE DATABASE db WITH SHARD DURATION 1h")
        assert "error" not in res["results"][0], res
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(_hour_groups(n.engine)
                   and len(n.svc.meta_store.fsm.nodes) == len(self.nodes)
                   for n in self.nodes.values()):
                break
            time.sleep(0.02)
        else:
            raise AssertionError("replicated DDL did not reach every node")

    def leader(self, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for n in self.nodes.values():
                if n.svc.meta_store.is_leader():
                    return n
            time.sleep(0.02)
        raise AssertionError("no meta leader")

    def write(self, nid, lines, **params):
        url = (f"http://{self.nodes[nid].addr}/write?"
               + urllib.parse.urlencode(dict(db="db", **params)))
        req = urllib.request.Request(url, data=lines.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status

    def query(self, nid, q):
        url = (f"http://{self.nodes[nid].addr}/query?"
               + urllib.parse.urlencode({"q": q, "db": "db", "epoch": "ns"}))
        with urllib.request.urlopen(url, timeout=120) as r:
            return json.loads(r.read())

    def close(self):
        for n in self.nodes.values():
            try:
                n.stop()
            except Exception:  # noqa: BLE001 — a node stopped already
                pass


def _lines(seed, hosts=6, hours=4, step_s=300, t0=BASE):
    """Seeded TSBS-like rows: two tags, a float and an int field."""
    rng = np.random.default_rng(seed)
    out = []
    for h in range(hosts):
        v = rng.normal(50, 10, size=hours * 3600 // step_s)
        c = rng.integers(0, 1000, size=len(v))
        for i in range(len(v)):
            t = (t0 + i * step_s) * NS + h
            out.append(f"cpu,host=h{h},region=r{h % 2} "
                       f"v={float(v[i])!r},c={int(c[i])}i {t}")
    return "\n".join(out)


QUERIES = [
    "SELECT count(v), sum(v), mean(v) FROM cpu",
    "SELECT min(v), max(v), spread(v), stddev(v) FROM cpu",
    "SELECT first(v), last(v) FROM cpu GROUP BY host",
    "SELECT sum(c), count(c) FROM cpu",
    "SELECT mean(v), max(v), count(v) FROM cpu "
    "WHERE time >= {t0} AND time < {t1} GROUP BY time(1m)",
    "SELECT mean(v) FROM cpu WHERE time >= {t0} AND time < {t1} "
    "GROUP BY time(1h), host",
    "SELECT percentile(c, 50), median(c) FROM cpu GROUP BY region",
    "SELECT sum(v) FROM cpu WHERE region = 'r1' AND v > 50",
    "SELECT v, c FROM cpu WHERE host = 'h3' AND time < {t1}",
    "SELECT derivative(mean(v), 1m) FROM cpu WHERE time >= {t0} "
    "AND time < {t1} GROUP BY time(10m)",
]


def _q(text, hours=4):
    return text.format(t0=BASE * NS, t1=(BASE + hours * 3600) * NS)


# float columns whose value depends on the summation order (rel 1e-12);
# every other value must be equal
_SUMMED = {"sum", "mean", "stddev", "derivative"}


def _close(a, b, path="$", rel=False):
    if isinstance(a, float) and isinstance(b, float) and rel:
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (path, a, b)
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            if k == "values" and "columns" in a:
                cols = a["columns"]
                assert len(a[k]) == len(b[k]), (path, len(a[k]), len(b[k]))
                for r, (ra, rb) in enumerate(zip(a[k], b[k])):
                    for j, (x, y) in enumerate(zip(ra, rb)):
                        _close(x, y, f"{path}.values[{r}][{j}]",
                               cols[j] in _SUMMED)
            else:
                _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _single(root, lines, hours):
    """The oracle: one JAX engine holding every row."""
    from opengemini_tpu.query.executor import Executor

    e = JEngine(str(root))
    e.create_database("db")
    e.create_retention_policy("db", "autogen", 0, 3600 * NS, True)
    e.write_lines("db", lines)
    ex = Executor(e)
    out = {q: ex.execute(_q(q, hours), db="db", now_ns=(BASE + 86400) * NS)
           for q in QUERIES}
    e.close()
    return out


def _answers(cl, nid, hours=4):
    return {q: cl.query(nid, _q(q, hours)) for q in QUERIES}


def _restart_http(node):
    """A stopped node's listener back on its address."""
    svc = node.pkg.http(node.engine, "127.0.0.1",
                        int(node.addr.rsplit(":", 1)[1]))
    svc.meta_store = node.svc.meta_store
    svc.executor.meta_store = node.svc.meta_store
    svc.router = node.router
    svc.executor.router = node.router
    node.svc = svc
    svc.start()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
def test_three_nodes_answer_as_one_engine(tmp_path, pkg):
    """Routed writes at rf 2, then every query through each coordinator;
    with n3's listener stopped, the same answers from the replicas, and
    the next hour's writes acknowledged with n3's copies hinted; after
    it returns, the hints drain and every coordinator answers as one
    engine holding all the rows."""
    lines = _lines(3)
    extra = _lines(4, hosts=3, hours=1, t0=BASE + 4 * 3600)
    want4 = _single(tmp_path / "single4", lines, 4)
    want5 = _single(tmp_path / "single5", lines + "\n" + extra, 5)
    cl = Cluster([pkg] * 3, tmp_path)
    try:
        assert cl.write("n1", lines) == 204
        for nid in cl.nodes:
            got = _answers(cl, nid)
            for q in QUERIES:
                _close(got[q], want4[q], f"{nid}:{q}")
        copies = sum(
            len(sh.read_series("cpu", sid).times)
            for n in cl.nodes.values()
            for sh in n.engine.shards_for_range("db", None, -(2**62), 2**62)
            for sid in sh.index.series_ids("cpu"))
        assert copies == 2 * len(lines.splitlines())
        n1, n3 = cl.nodes["n1"], cl.nodes["n3"]
        n3.svc.stop()
        n1.router.exchange_health()
        for q in QUERIES:
            _close(cl.query("n1", _q(q)), want4[q], f"n3 down:{q}")
        assert cl.write("n1", extra, consistency="one") == 204
        owed = sum(
            1 for ln in extra.splitlines()
            if "n3" in n1.router.group_owners(
                "db", "autogen",
                int(ln.rsplit(" ", 1)[1]) // (3600 * NS) * 3600 * NS))
        hinted = sum(
            len(json.loads(ln)["points"])
            for ln in open(os.path.join(n1.root, "hints", "n3.jsonl"))
        ) if owed else 0
        assert hinted == owed
        _restart_http(n3)
        assert n1.router.replay_hints() == owed
        assert not n1.router.pending_hint_nodes()
        n1.router.exchange_health()
        for nid in cl.nodes:
            got = _answers(cl, nid, 5)
            for q in QUERIES:
                _close(got[q], want5[q], f"{nid} after replay:{q}")
    finally:
        cl.close()


@pytest.fixture
def jax_answers(tmp_path):
    lines = _lines(5, hosts=4, hours=6)
    cl = Cluster([JAX, JAX], tmp_path / "ref", rf=1, nids=("n1", "n2"))
    try:
        assert cl.write("n1", lines) == 204
        return lines, {nid: _answers(cl, nid) for nid in cl.nodes}
    finally:
        cl.close()


@pytest.mark.parametrize("mix", [(PORT, JAX), (JAX, PORT)],
                         ids=["torch-coordinator", "jax-coordinator"])
def test_mixed_cluster_answers_as_all_jax(tmp_path, jax_answers, mix):
    """A port node and a JAX node serve each other: routed writes,
    /internal/select_meta and select_partials (the pushdown), and
    /internal/scan (raw selects) cross the packages."""
    lines, want = jax_answers
    cl = Cluster(list(mix), tmp_path / "mix", rf=1, nids=("n1", "n2"))
    try:
        assert cl.write("n1", lines) == 204
        for nid in cl.nodes:
            got = _answers(cl, nid)
            for q in QUERIES:
                _close(got[q], want[nid][q], f"{nid}:{q}")
        # both engines took rows: the coordinator routed a share away
        assert all(n.engine.shards_for_range("db", None, -(2**62), 2**62)
                   for n in cl.nodes.values())
    finally:
        cl.close()


class _Fsm:
    def __init__(self, nodes):
        self.nodes = nodes


class _Store:
    token = ""

    def __init__(self, nodes):
        self.fsm = _Fsm(nodes)


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["torch-hints", "jax-hints"])
def test_hint_files_replayed_by_the_other(tmp_path, writer, reader):
    """Hints queued by one package's router (hints/<node>.jsonl under the
    engine's root) are delivered by the other's replay, byte-compatible
    points included (strings with newlines, ints, bools)."""
    target = reader.engine(str(tmp_path / "target"))
    target.create_database("db")
    svc = reader.http(target, "127.0.0.1", 0)
    svc.start()
    nodes = {"nB": {"addr": f"127.0.0.1:{svc.port}", "role": "data"}}
    try:
        e = writer.engine(str(tmp_path / "coord"))
        e.create_database("db")
        r = writer.cluster.DataRouter(e, _Store(nodes), "nA", "hA:1")
        pts = writer.cluster.decode_points([
            ["m", [["host", "a"]], (BASE + i) * NS,
             {"v": ["FLOAT", i * 0.5], "n": ["INT", i],
              "s": ["STRING", f"x\n{i}"], "b": ["BOOL", i % 2 == 0]}]
            for i in range(5)])
        r.hint("nB", "db", None, pts)
        assert r.pending_hint_nodes() == {"nB"}
        e.close()
        e2 = reader.engine(str(tmp_path / "coord"))
        r2 = reader.cluster.DataRouter(e2, _Store(nodes), "nA", "hA:1")
        assert r2.pending_hint_nodes() == {"nB"}
        assert r2.replay_hints() == 5
        assert r2.pending_hint_nodes() == set()
        e2.close()
        got = svc.executor.execute("SELECT v, n, s, b FROM m", db="db")
        rows = got["results"][0]["series"][0]["values"]
        assert rows == [[(BASE + i) * NS, i * 0.5, i, f"x\n{i}", i % 2 == 0]
                        for i in range(5)]
    finally:
        svc.stop()
        target.close()
