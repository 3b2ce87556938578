"""The port's cluster operations (parallel/cluster.py's node add, forced
moves, the balancer, drain, decommission, two-phase migration and
anti-entropy; Shard.content_digest) against the JAX package, on the CPU,
in whole clusters wired as test_torch_cluster.Cluster wires them (meta
stores over HTTP, a DataRouter at rf 2 on every node).

- One seeded schedule runs through three JAX nodes and through three
  port nodes: a fourth node joins the meta group and ``op=add``
  registers it, ``op=move`` and ``op=migrate`` move a group onto it, a
  balance round at a skew set by hand moves another, a node drains until
  it holds no group, decommissions itself, and a dead peer is removed by
  force and its replicas repaired by anti-entropy. Both packages make the
  same decisions and placements at every step (the join's own rebalance
  included), leave no staging behind, and every query answers as one JAX
  engine holding all the rows.
- Mixed clusters: a port node migrates a group into a JAX node's staging
  and the other way round, and anti-entropy pulls a lost replica back
  across the packages.
- ``content_digest`` is equal across the packages for the same rows, in
  the memtable, flushed, and split between a file and the memtable.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from opengemini_tpu.storage.engine import Engine as JEngine
from test_torch_cluster import (
    BASE, JAX, NS, PORT, QUERIES, TOKEN, Cluster, Node, _close, _hour_groups,
    _lines, _q, _single,
)
from test_torch_raft import CpuEngine

torch.set_num_threads(1)

HOURS = 4


def _ctrl(at, **params) -> dict:
    url = (f"http://{at.addr}/debug/ctrl?"
           + urllib.parse.urlencode(dict(mod="cluster", **params)))
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


def _wait(what, cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def join(cl: Cluster, pkg, nid: str, root) -> Node:
    """A node that joins the running meta group as the reference's
    server/app.py joins one: a learner until its conf-add commits."""
    n = Node(pkg, nid, root)
    addrs = {k: v.addr for k, v in cl.nodes.items()}
    addrs[nid] = n.addr
    transport = pkg.transport(dict(addrs), token=TOKEN, self_addr=n.addr)
    ms = pkg.store(nid, sorted(addrs), transport,
                   storage_path=os.path.join(n.root, "meta.raftlog"))
    ms.token = TOKEN
    ms.attach_engine(n.engine)
    ms.attach_users(n.svc.users)
    ms.node.learner = True
    n.svc.meta_store = n.svc.executor.meta_store = ms
    rf = next(iter(cl.nodes.values())).router.rf
    n.router = pkg.cluster.DataRouter(
        n.engine, ms, nid, n.addr, token=TOKEN, rf=rf,
        write_consistency="one")
    n.svc.router = n.svc.executor.router = n.router
    n.hints = pkg.hints(n.router, 3600.0)
    ms.start()
    n.svc.start()
    assert cl.leader().svc.meta_store.propose_conf_change("add", nid, n.addr)
    cl.nodes[nid] = n
    return n


def _held(cl) -> dict:
    return {nid: sorted((s - BASE * NS) // (3600 * NS)
                        for (_db, _rp, s) in n.engine._shards)
            for nid, n in sorted(cl.nodes.items())}


def _hour_of(key: str) -> int:
    return (int(key.split("|")[2]) - BASE * NS) // (3600 * NS)


def _answers_ok(cl, want, nids, label):
    for nid in nids:
        for q in QUERIES:
            _close(cl.query(nid, _q(q, HOURS)), want[q], f"{label} {nid}:{q}")


def _placed(cl, move) -> None:
    """Wait until every node's meta store applied the move's override."""
    db, rp, start = move["group"].split("|")
    _wait(f"the placement of {move['group']}", lambda: all(
        n.router.group_owners(db, rp, int(start)) == move["owners"]
        for n in cl.nodes.values()))


def _agreed(cl, without: str = "") -> None:
    """Wait until every node routes every group held anywhere to the
    same owners (none of them `without`): the overrides a drain proposed
    have applied everywhere."""
    keys = {k for n in cl.nodes.values() for k in n.engine._shards}

    def same():
        views = [{k: n.router.group_owners(*k) for k in keys}
                 for n in cl.nodes.values()]
        return all(v == views[0] for v in views) and not any(
            without in o for o in views[0].values())

    _wait("the nodes' placements agree", same)


def _staging_empty(cl) -> bool:
    return all(not n.engine.staging_ids() for n in cl.nodes.values())


def _schedule(pkg, tmp_path, want) -> list:
    """The operations schedule on three `pkg` nodes; the trail of every
    decision, placement and roster it made (no address, id or wall)."""
    trail = []
    cl = Cluster([pkg] * 3, tmp_path)
    try:
        assert cl.write("n1", _lines(11, hours=HOURS)) == 204
        for n in cl.nodes.values():
            n.engine.flush_all()
            n.router.probe_health()
        trail.append(("loaded", _held(cl)))

        # a fourth node joins and op=add (on a follower) registers it
        n4 = join(cl, pkg, "n4", tmp_path / "n4")
        follower = next(n for n in cl.nodes.values()
                        if not n.svc.meta_store.is_leader()
                        and n.nid != "n4")
        doc = _ctrl(follower, op="add", id="n4", addr=n4.addr)
        _wait("n4 in every roster and the DDL on n4", lambda: all(
            "n4" in n.svc.meta_store.fsm.nodes for n in cl.nodes.values())
            and _hour_groups(n4.engine))
        trail.append(("add", doc["add"]["ok"],
                      sorted(cl.nodes["n1"].router.data_nodes())))
        for n in cl.nodes.values():
            n.router.probe_health()
        # the roster grew: each node pushes the groups it no longer owns
        moved = {nid: n.router.migrate_round()
                 for nid, n in sorted(cl.nodes.items())}
        trail.append(("rebalance", moved, _held(cl)))
        assert _staging_empty(cl)
        _answers_ok(cl, want, ("n1", "n4"), "n4 joined")

        # op=move onto n4, then op=migrate where ownership was lost
        doc = _ctrl(cl.nodes["n1"], op="move", db="db", dest="n4")
        move = doc["move"]
        trail.append(("move", _hour_of(move["group"]), move["from"],
                      move["to"], move["owners"]))
        _placed(cl, move)
        doc = _ctrl(cl.nodes["n1"], op="migrate")
        trail.append(("migrate", doc["moved"], doc["expired"],
                      doc["staging"], _held(cl)))
        assert doc["moved"] == 1 and _staging_empty(cl)
        _answers_ok(cl, want, ("n1", "n4"), "after the move")

        # a balance round at a skew set by hand: each node's load doc
        # sizes each group it holds by its hour; the primary of hour 0
        # carries 100 kB more (the hot node), a node outside hour 0's
        # owners nothing (the cold one)
        r1 = cl.nodes["n1"].router
        own0 = r1.group_owners("db", "autogen", BASE * NS)
        hot = own0[0]
        cold = min(n for n in cl.nodes if n not in own0)
        for nid, n in cl.nodes.items():
            def usage(n=n, nid=nid):
                groups = {f"{db}|{rp}|{s}": 1000 + _hour_of(
                    f"{db}|{rp}|{s}") for (db, rp, s) in n.engine._shards}
                total = sum(groups.values()) + (100_000 if nid == hot
                                                else 0)
                return {"total": 0 if nid == cold else total,
                        "groups": groups}
            n.engine.disk_usage = usage
        lead = cl.leader()
        move = lead.router.balance_round(min_skew_bytes=1, skew_ratio=1.05)
        assert move is not None
        trail.append(("balance", _hour_of(move["group"]), move["bytes"],
                      move["from"], move["to"], move["owners"]))
        for n in cl.nodes.values():
            del n.engine.disk_usage
        _placed(cl, move)
        moved = cl.nodes[move["from"]].router.migrate_round()
        trail.append(("balance migrate", moved, _held(cl)))
        assert moved == 1 and _staging_empty(cl)
        _answers_ok(cl, want, ("n1", "n4"), "after the balance")

        # n2 drains until it holds no group
        passes = []
        for _ in range(5):
            d = _ctrl(cl.nodes["n2"], op="drain")["drain"]
            passes.append({k: d[k] for k in (
                "migrated", "hints_replayed", "remaining_groups",
                "pending_hints", "dead_dests")})
            if d["remaining_groups"] == 0:
                break
        # a pass migrates only the groups whose override its node has
        # applied already (the meta plane's timing): the sums are the
        # schedule's, the passes are not
        trail.append(("drain", sum(p["migrated"] for p in passes),
                      {k: v for k, v in passes[-1].items()
                       if k != "migrated"}, _held(cl)))
        assert passes[-1]["remaining_groups"] == 0 and _staging_empty(cl)
        _agreed(cl, without="n2")
        _answers_ok(cl, want, ("n1", "n3", "n4"), "n2 drained")

        # n2 decommissions itself, then stops
        st = _ctrl(cl.nodes["n2"], op="decommission",
                   deadline_s=30)["decommission"]
        trail.append(("decommission", {k: st.get(k) for k in (
            "phase", "done", "migrated", "repaired", "roster_removed",
            "conf_removed")}))
        assert st["phase"] == "done"
        _wait("n2 out of every roster", lambda: all(
            "n2" not in n.svc.meta_store.fsm.nodes
            for nid, n in cl.nodes.items() if nid != "n2"))
        cl.nodes.pop("n2").stop()
        trail.append(("roster", sorted(cl.nodes["n1"].router.data_nodes())))
        _answers_ok(cl, want, ("n1", "n3", "n4"), "n2 decommissioned")

        # n3 dies; n1 removes it by force, and anti-entropy re-replicates
        # the groups whose new owners lack them
        cl.nodes.pop("n3").stop()
        _wait("a meta leader among n1 and n4", lambda: any(
            cl.nodes[k].svc.meta_store.is_leader() for k in ("n1", "n4")))
        for _ in range(5):
            st = _ctrl(cl.nodes["n1"], op="decommission", node="n3")
            st = st["decommission"]
            if st["roster_removed"]:
                break
            # no meta leader answered the removal (an election under
            # load): a clean False, retried as an operator would
            time.sleep(0.5)
        assert st["done"], st
        trail.append(("forced", {k: st.get(k) for k in (
            "phase", "forced", "done", "roster_removed", "conf_removed",
            "hints_replayed")}))
        _wait("n3 out of the rosters", lambda: all(
            "n3" not in n.svc.meta_store.fsm.nodes
            for n in cl.nodes.values()))
        for n in cl.nodes.values():
            n.router.probe_health()
        repaired = {nid: _ctrl(n, op="antientropy")["repaired"]
                    for nid, n in sorted(cl.nodes.items())}
        trail.append(("repaired", repaired, _held(cl)))
        _answers_ok(cl, want, ("n1", "n4"), "n3 removed")
        # every group the survivors own is on each of its owners, with
        # equal digests (an override that named n3 leaves its survivor)
        for key in {k for n in cl.nodes.values() for k in n.engine._shards}:
            held = [cl.nodes[o].engine._shards.get(key)
                    for o in cl.nodes["n1"].router.group_owners(*key)]
            assert None not in held, key
            assert len({json.dumps(sh.content_digest(), sort_keys=True)
                        for sh in held}) == 1, key
        return trail
    finally:
        cl.close()


def test_one_operations_schedule_in_both_packages(tmp_path):
    want = _single(tmp_path / "single", _lines(11, hours=HOURS), HOURS)
    jax = _schedule(JAX, tmp_path / "jax", want)
    port = _schedule(PORT, tmp_path / "torch", want)
    assert port == jax


# -- mixed clusters ------------------------------------------------------------


@pytest.mark.parametrize("mix", [(PORT, JAX), (JAX, PORT)],
                         ids=["torch-into-jax", "jax-into-torch"])
def test_a_migration_across_the_packages(tmp_path, mix):
    """n1 (one package) moves a group it holds to n2 (the other) through
    the two-phase migration: n2 stages it, commits it and n1 drops it;
    the rows and the digest arrive unchanged, and both coordinators
    answer as one JAX engine holding all the rows. A string field in
    every hour makes the staging and the fold take the structured path
    (no columnar batch carries one)."""
    lines = _lines(13, hours=HOURS) + "".join(
        f'\ncpu,host=h{h},region=r{h % 2} note="n {h}" '
        f'{(BASE + 3600 * hh + 60) * NS + h}'
        for hh in range(HOURS) for h in range(6))
    want = _single(tmp_path / "single", lines, HOURS)
    cl = Cluster(list(mix), tmp_path / "mix", rf=1, nids=("n1", "n2"))
    try:
        assert cl.write("n1", lines) == 204
        n1, n2 = cl.nodes["n1"], cl.nodes["n2"]
        n1.engine.flush_all()
        for n in cl.nodes.values():
            n.router.probe_health()
        before = {k: sh.content_digest() for k, sh in n1.engine._shards.items()}
        assert before
        move = _ctrl(n1, op="move", db="db", dest="n2")["move"]
        db, rp, start = move["group"].split("|")
        key = (db, rp, int(start))
        assert move["owners"] == ["n2"] and key in n1.engine._shards
        assert key not in n2.engine._shards
        _placed(cl, move)
        doc = _ctrl(n1, op="migrate")
        assert doc["moved"] == 1 and doc["staging"] == []
        assert key not in n1.engine._shards
        assert n2.engine.staging_ids() == []
        assert n2.engine._shards[key].content_digest() == before[key]
        staging = os.path.join(n2.root, "staging")
        assert [f for f in os.listdir(staging)
                if f.endswith(".committed")]  # the reference's marker
        _answers_ok(cl, want, ("n1", "n2"), "moved")
    finally:
        cl.close()


@pytest.mark.parametrize("mix", [(PORT, JAX), (JAX, PORT)],
                         ids=["torch-pulls-from-jax", "jax-pulls-from-torch"])
def test_anti_entropy_across_the_packages(tmp_path, mix):
    """Two replicas at rf 2, one of each package; the first loses its
    shard directories behind the system's back and its anti-entropy
    round pulls every measurement back from the other package's node."""
    lines = _lines(17, hours=2)
    cl = Cluster(list(mix), tmp_path / "mix", rf=2, nids=("n1", "n2"))
    try:
        assert cl.write("n2", lines) == 204
        n1, n2 = cl.nodes["n1"], cl.nodes["n2"]
        for n in cl.nodes.values():
            n.engine.flush_all()
            n.router.probe_health()
        want = {k: sh.content_digest() for k, sh in n2.engine._shards.items()}
        assert len(want) == 2
        for key, sh in list(n1.engine._shards.items()):
            sh.close()
            shutil.rmtree(sh.path)
            del n1.engine._shards[key]
        assert n1.router.anti_entropy_round() == len(want)
        got = {k: sh.content_digest() for k, sh in n1.engine._shards.items()}
        assert got == want
        assert n1.router.anti_entropy_round() == 0
        assert n2.router.anti_entropy_round() == 0
    finally:
        cl.close()


def test_a_migration_reads_one_chunk_at_a_time(tmp_path, monkeypatch):
    """A group of 40 series x 60 rows (2400 points) moves in pushes of at
    most MIGRATE_CHUNK (set to 500 here): no bulk read of the pushed
    shard returns more than one chunk's rows, and the group arrives
    whole."""
    from opengemini_tpu_torch.storage import shard as tshard

    lines = _lines(23, hosts=40, hours=1, step_s=60)
    cl = Cluster([PORT, PORT], tmp_path / "big", rf=1, nids=("n1", "n2"))
    try:
        assert cl.write("n1", lines) == 204
        n1, n2 = cl.nodes["n1"], cl.nodes["n2"]
        n1.engine.flush_all()
        for n in cl.nodes.values():
            n.router.probe_health()
        [(key, sh)] = n1.engine._shards.items()
        before = sh.content_digest()
        assert before["cpu"][0] == 2400
        chunk = 500
        n1.router.MIGRATE_CHUNK = chunk
        reads: list[int] = []
        pushes: list[int] = []
        bulk = tshard.Shard.read_series_bulk

        def counted_bulk(self, *args, **kwargs):
            out = bulk(self, *args, **kwargs)
            if self is sh:
                reads.append(len(out[1]))
            return out

        monkeypatch.setattr(tshard.Shard, "read_series_bulk", counted_bulk)
        rpc = n1.router._migrate_rpc

        def counted_rpc(peer, body):
            if body.get("phase") == "write":
                pushes.append(len(body["points"]))
            return rpc(peer, body)

        monkeypatch.setattr(n1.router, "_migrate_rpc", counted_rpc)
        move = _ctrl(n1, op="move", db="db", dest="n2")["move"]
        assert move["owners"] == ["n2"]
        _placed(cl, move)
        assert _ctrl(n1, op="migrate")["moved"] == 1
        assert sum(pushes) == 2400 and max(pushes) <= chunk
        assert len(pushes) >= 2400 // chunk
        assert len(reads) > 1 and max(reads) <= chunk
        assert key not in n1.engine._shards
        assert n2.engine._shards[key].content_digest() == before
    finally:
        cl.close()


@pytest.mark.parametrize("diverged", [False, True],
                         ids=["same-digest", "diverged"])
def test_a_retained_owner_with_our_digest_takes_no_push(tmp_path,
                                                        monkeypatch,
                                                        diverged):
    """rf 2 over three port nodes: a forced move keeps one owner and adds
    the third node. The migration pushes to the new node, and to the
    retained owner only where its copy's digest differs from the
    source's; every destination ends with the source's rows."""
    cl = Cluster([PORT, PORT, PORT], tmp_path / "rf2", rf=2,
                 nids=("n1", "n2", "n3"))
    try:
        assert cl.write("n1", _lines(29, hours=1)) == 204
        for n in cl.nodes.values():
            n.engine.flush_all()
            n.router.probe_health()
        r1 = cl.nodes["n1"].router
        [(db, rp, start)] = {k for n in cl.nodes.values()
                             for k in n.engine._shards}
        src, kept = r1.group_owners(db, rp, start)
        [new] = [nid for nid in cl.nodes if nid not in (src, kept)]
        if diverged:
            cl.nodes[kept].engine.write_lines(
                "db", f"cpu,host=h0,region=r0 v=1.5 {BASE * NS + 7}")
        want = cl.nodes[src].engine._shards[(db, rp, start)].content_digest()
        pushed: set = set()
        rpc = cl.nodes[src].router._migrate_rpc

        def counted_rpc(peer, body):
            if body.get("phase") == "write":
                pushed.add(peer)
            return rpc(peer, body)

        monkeypatch.setattr(cl.nodes[src].router, "_migrate_rpc",
                            counted_rpc)
        move = _ctrl(cl.nodes[src], op="move", db="db", dest=new)["move"]
        assert move["owners"] == [kept, new]
        _placed(cl, move)
        assert _ctrl(cl.nodes[src], op="migrate")["moved"] == 1
        assert pushed == ({kept, new} if diverged else {new})
        assert (db, rp, start) not in cl.nodes[src].engine._shards
        assert cl.nodes[new].engine._shards[
            (db, rp, start)].content_digest() == want
        got = cl.nodes[kept].engine._shards[(db, rp, start)].content_digest()
        assert (got != want) == diverged
    finally:
        cl.close()


@pytest.mark.parametrize("chunk", [1, 7, 100, 20_000])
@pytest.mark.parametrize("layout", ["memtable", "split"])
def test_structured_batches_equal_the_reference(tmp_path, layout, chunk):
    """iter_structured_batches yields the reference's points in the
    reference's order, in batches of at most `chunk`, over rows of every
    field type with holes, in the memtable and split across a file."""
    from opengemini_tpu.storage.shard import (
        iter_structured_batches as j_batches,
    )
    from opengemini_tpu_torch.storage.shard import (
        iter_structured_batches as t_batches,
    )

    lines = _digest_lines(9)
    got = []
    for make, batches, name in ((JEngine, j_batches, "jax"),
                                (CpuEngine, t_batches, "torch")):
        e = make(str(tmp_path / name))
        e.create_database("db")
        half = len(lines) // 2 if layout == "split" else len(lines)
        e.write_lines("db", "\n".join(lines[:half]))
        if layout != "memtable":
            e.flush_all()
        if half < len(lines):
            e.write_lines("db", "\n".join(lines[half:]))
        [sh] = e._shards.values()
        out = list(batches(sh, chunk))
        assert all(0 < len(b) <= chunk for b in out)
        got.append([p for b in out for p in b])
        e.close()
    assert got[0] == got[1]
    assert len(got[1]) > 0


# -- content digests -----------------------------------------------------------


def _digest_lines(seed: int) -> list[str]:
    """Rows of every field type, with holes, over two measurements."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        h = int(rng.integers(0, 7))
        t = (BASE + int(rng.integers(0, 3000))) * NS
        fields = []
        if rng.random() < 0.8:
            fields.append(f"f={float(rng.normal())!r}")
        if rng.random() < 0.6:
            fields.append(f"n={int(rng.integers(-99, 99))}i")
        if rng.random() < 0.4:
            fields.append(f"b={'true' if rng.random() < 0.5 else 'false'}")
        if rng.random() < 0.3:
            fields.append(f's="x{i} y"')
        if not fields:
            fields.append("f=0.5")
        out.append(f"{'cpu' if i % 3 else 'mem'},host=h{h},dc=d{h % 2} "
                   f"{','.join(fields)} {t}")
    return out


@pytest.mark.parametrize("layout", ["memtable", "flushed", "split"])
def test_content_digest_equal_across_packages(tmp_path, layout):
    lines = _digest_lines(5)
    digests = []
    for make, name in ((JEngine, "jax"), (CpuEngine, "torch")):
        e = make(str(tmp_path / name))
        e.create_database("db")
        half = len(lines) // 2 if layout == "split" else len(lines)
        e.write_lines("db", "\n".join(lines[:half]))
        if layout != "memtable":
            e.flush_all()
        if half < len(lines):
            e.write_lines("db", "\n".join(lines[half:]))
        digests.append({k: sh.content_digest()
                        for k, sh in e._shards.items()})
        e.close()
    assert digests[0] == digests[1]
    [d] = digests[0].values()
    assert set(d) == {"cpu", "mem"}
    assert sum(rows for rows, _h in d.values()) > 0
