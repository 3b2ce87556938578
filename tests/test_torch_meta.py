"""The port's meta plane (meta/service.py's MetaFSM and MetaStore with
attach_engine and attach_users, meta/raft.py's files) against the JAX
package, on the CPU.

The same command sequence through each package's MetaFSM gives the same
snapshot; the raft files one package writes (state, log segment,
snapshot sidecar) reload in the other with the same log and state; a
single-node MetaStore of each package, given the same DDL and user
statements through its executor, leaves engines and user stores that
answer alike, and each package's engine root and users.json reopen in
the other with the same databases, retention policies, registries and
credentials.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from opengemini_tpu.meta import raft as jraft
from opengemini_tpu.meta import service as jservice
from opengemini_tpu.meta import users as jusers
from opengemini_tpu.query.executor import Executor as JExecutor
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.meta import raft as traft
from opengemini_tpu_torch.meta import service as tservice
from opengemini_tpu_torch.meta import users as tusers
from opengemini_tpu_torch.query.executor import Executor as TExecutor
from test_torch_raft import CpuEngine

torch.set_num_threads(1)

JAX = {"raft": jraft, "service": jservice, "users": jusers,
       "engine": JEngine, "executor": JExecutor}
PORT = {"raft": traft, "service": tservice, "users": tusers,
        "engine": CpuEngine, "executor": TExecutor}

COMMANDS = [
    {"op": "create_database", "name": "db1"},
    {"op": "create_rp", "db": "db1", "name": "rp1", "duration_ns": 7200e9,
     "shard_duration_ns": 3600e9, "default": True},
    {"op": "alter_rp", "db": "db1", "name": "rp1", "duration_ns": 14400e9},
    {"op": "create_cq", "db": "db1", "cq": {"name": "c1", "select_text":
     "SELECT mean(v) INTO x FROM m GROUP BY time(1m)"}},
    {"op": "create_subscription", "db": "db1", "sub": {
        "name": "s1", "mode": "ALL", "destinations": ["http://h:1"]}},
    {"op": "register_node", "id": "n1", "addr": "127.0.0.1:1"},
    {"op": "set_placement", "key": "db1|rp1|0", "owners": ["n1"]},
    {"op": "raft_conf", "action": "add", "id": "n2", "addr": "h:2"},
    {"op": "create_user", "name": "u", "salt": "00", "hash": "ab",
     "admin": False},
    {"op": "grant", "user": "u", "db": "db1", "privilege": "READ"},
    {"op": "save_model", "name": "mod", "doc": {"algorithm": "mad"}},
    {"op": "drop_subscription", "db": "db1", "name": "s1"},
    {"op": "remove_node", "id": "n1"},
    {"op": "??future??"},
]


def test_fsm_same_snapshot():
    snaps = []
    for pkg in (JAX, PORT):
        fsm = pkg["service"].MetaFSM()
        for i, cmd in enumerate(COMMANDS, 1):
            fsm.apply(i, json.loads(json.dumps(cmd)))
        snaps.append(fsm.snapshot())
    assert snaps[0] == snaps[1]
    # and each restores the other's
    for pkg, snap in ((JAX, snaps[1]), (PORT, snaps[0])):
        fsm = pkg["service"].MetaFSM()
        fsm.restore(snap)
        assert fsm.snapshot() == snap


class _Null:
    def send(self, peer, msg):
        pass


def _write_raft_files(pkg, path, compact: bool):
    """A one-member raft of `pkg` that elects itself, commits COMMANDS
    and, with `compact`, snapshots half of them."""
    applied = []
    node = pkg["raft"].RaftNode("a", ["a"], _Null(),
                                apply_fn=lambda i, c: applied.append((i, c)),
                                storage_path=path,
                                restore_fn=lambda s: None)
    for _ in range(40):
        node.tick()
        if node.state == pkg["raft"].LEADER:
            break
    assert node.state == pkg["raft"].LEADER
    for cmd in COMMANDS:
        assert node.propose(cmd) is not None
    if compact:
        node.take_snapshot(lambda: {"applied": len(applied) // 2})
    return node


@pytest.mark.parametrize("compact", [False, True], ids=["log", "snapshot"])
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-files", "torch-files"])
def test_raft_files_reload_in_the_other(tmp_path, writer, reader, compact):
    path = str(tmp_path / "meta.raftlog")
    w = _write_raft_files(writer, path, compact)
    restored = []
    r = reader["raft"].RaftNode("a", ["a"], _Null(),
                                apply_fn=lambda i, c: None,
                                storage_path=path,
                                restore_fn=restored.append)
    assert r.current_term == w.current_term
    assert r.voted_for == w.voted_for
    assert (r.snap_index, r.snap_term) == (w.snap_index, w.snap_term)
    assert [(e.term, e.cmd) for e in r.log] == \
        [(e.term, e.cmd) for e in w.log]
    if compact:
        assert restored == [w.snap_state]


def _store(pkg, root):
    """A single-node MetaStore of `pkg` driving its engine and users."""
    eng = pkg["engine"](str(root / "data"))
    users = pkg["users"].UserStore(str(root / "data" / "users.json"))
    store = pkg["service"].MetaStore(
        "solo", ["solo"], storage_path=str(root / "meta.raftlog"),
        tick_s=0.01)
    store.attach_engine(eng)
    store.attach_users(users)
    store.start()
    deadline = time.time() + 5
    while not store.is_leader() and time.time() < deadline:
        time.sleep(0.01)
    assert store.is_leader()
    ex = pkg["executor"](eng, users=users, meta_store=store)
    return eng, users, store, ex


STATEMENTS = [
    "CREATE DATABASE d1 WITH DURATION 2d SHARD DURATION 1h NAME rp1h",
    "CREATE RETENTION POLICY rp2 ON d1 DURATION 1d REPLICATION 1",
    "ALTER RETENTION POLICY rp2 ON d1 DURATION 3d",
    "CREATE CONTINUOUS QUERY cq1 ON d1 BEGIN SELECT mean(v) INTO m1 "
    "FROM m GROUP BY time(1m) END",
    "CREATE SUBSCRIPTION s1 ON d1 DESTINATIONS ALL 'http://h:9'",
    "CREATE USER root WITH PASSWORD 'pw' WITH ALL PRIVILEGES",
    "CREATE USER bob WITH PASSWORD 'b'",
    "GRANT READ ON d1 TO bob",
    "SET PASSWORD FOR bob = 'b2'",
    "CREATE DATABASE d2",
    "DROP DATABASE d2",
    "SHOW USERS", "SHOW GRANTS FOR bob", "SHOW DATABASES",
    "SHOW RETENTION POLICIES ON d1", "SHOW CONTINUOUS QUERIES",
    "SHOW SUBSCRIPTIONS", "SHOW CLUSTER",
    "REVOKE READ ON d1 FROM bob", "SHOW GRANTS FOR bob",
    "CREATE USER bob WITH PASSWORD 'x'",
]


def _answers(pkg, root):
    eng, users, store, ex = _store(pkg, root)
    try:
        out = []
        for q in STATEMENTS:
            try:
                out.append(ex.execute(q, db="d1")["results"][0])
            except Exception as e:  # noqa: BLE001 — the AuthError's class
                out.append({"raised": type(e).__name__, "text": str(e)})
        d = eng.databases["d1"]
        state = {
            "dbs": sorted(eng.databases),
            "rps": {n: (r.duration_ns, r.shard_duration_ns)
                    for n, r in sorted(d.rps.items())},
            "default": d.default_rp,
            "cqs": sorted(d.continuous_queries),
            "subs": sorted(d.subscriptions),
            "users": {n: (u.admin, u.privileges)
                      for n, u in sorted(users.users.items())},
            "fsm": store.fsm.snapshot()["databases"],
        }
        assert users.authenticate("bob", "b2")
        return out, state
    finally:
        store.stop()
        eng.close()


def test_replicated_ddl_and_users_answer_alike(tmp_path):
    ja, js = _answers(JAX, tmp_path / "j")
    ta, ts = _answers(PORT, tmp_path / "t")
    assert ta == ja
    assert ts == js


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-root", "torch-root"])
def test_roots_and_users_reopen_in_the_other(tmp_path, writer, reader):
    """The engine's meta.json and the meta markers and users.json one
    package's store wrote reopen in the other: the same databases, RPs,
    registries and credentials, and a restarted store of the other
    package replays its log without enacting anything twice."""
    _answers(writer, tmp_path)
    eng, users, store, ex = _store(reader, tmp_path)
    try:
        deadline = time.time() + 5
        while store.fsm.applied_index < 1 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        d = eng.databases["d1"]
        assert sorted(eng.databases) == ["d1"]
        assert sorted(d.rps) == ["autogen", "rp1h", "rp2"]
        assert d.default_rp == "rp1h"
        assert d.rps["rp2"].duration_ns == 3 * 86400 * 10**9
        assert sorted(d.continuous_queries) == ["cq1"]
        assert sorted(d.subscriptions) == ["s1"]
        assert users.authenticate("root", "pw").admin
        assert users.authenticate("bob", "b2").privileges == {}
        res = ex.execute("SHOW USERS", db="d1")["results"][0]
        assert sorted(r[0] for r in res["series"][0]["values"]) == \
            ["bob", "root"]
    finally:
        store.stop()
        eng.close()
