"""ts-meta: the raft-replicated metadata service.

The port of ``opengemini_tpu/meta/service.py``, whole, with plain
``threading`` locks; its commands, snapshots, applied-index markers and
/raft/msg bodies are the JAX package's, so a port node and a JAX node
share one meta plane. Reference: app/ts-meta/meta (raft store + FSM store_fsm.go:77 Apply) and
lib/metaclient (every node's cached view). The FSM state is the cluster
data model: databases, retention policies, users' names, node registry.
Commands are JSON dicts applied deterministically on every replica.

Single-process embedding: `MetaStore` + `RaftNode` with a loopback
transport gives the standalone (ts-server) deployment the same code path
the clustered deployment uses; the HTTP transport + ticker run a real
multi-process quorum.
"""

from __future__ import annotations

import json
import threading
import urllib.request

from opengemini_tpu_torch.utils import peers
from opengemini_tpu_torch.meta.raft import LEADER, RaftNode
from opengemini_tpu_torch.utils import lockdep


# db-scoped registry commands (CQ / stream / subscription): FSM state key
# and the command field that carries the registered object's JSON payload
_REGISTRY_CREATE = {
    "create_cq": ("cqs", "cq"),
    "create_stream": ("streams", "task"),
    "create_subscription": ("subscriptions", "sub"),
}
_REGISTRY_DROP = {
    "drop_cq": "cqs",
    "drop_stream": "streams",
    "drop_subscription": "subscriptions",
}


class MetaFSM:
    """Deterministic state machine over cluster metadata commands.

    `listeners` receive every applied command AFTER the FSM state update —
    the hook through which each replica's local storage engine enacts
    replicated DDL (reference: store_fsm.go Apply driving the data model
    every node then observes via metaclient). Listener errors are logged,
    never poison the deterministic FSM state."""

    def __init__(self):
        self.databases: dict[str, dict] = {}
        self.nodes: dict[str, dict] = {}  # node id -> {addr, role}
        self.users: dict[str, dict] = {}  # name -> {admin, salt, hash,
        # privileges}: full credential material (pre-hashed at propose
        # time) so snapshots can rebuild a replica's UserStore; status()
        # strips salt/hash before anything leaves the process
        self.applied_index = 0
        self.meta_removed: set[str] = set()  # conf-change tombstones
        # raft members live separately from the data-node roster: the
        # all-in-one server registers the SAME id in both roles, and one
        # dict keyed by id would let each registration clobber the other
        self.meta_nodes: dict[str, str] = {}  # id -> addr
        self.models: dict[str, dict] = {}  # castor fitted-model artifacts
        # load-aware placement overrides: "db|rp|start" -> [owner ids];
        # groups listed here ignore rendezvous (reference:
        # app/ts-meta/meta/balance_manager.go moving PT ownership)
        self.placement: dict[str, list] = {}
        self.listeners: list = []
        # listener side effects DEFER here: apply() runs under the raft
        # lock and listener work (engine DDL = disk I/O) must not stall
        # heartbeats/elections. MetaStore drains outside the lock.
        self.pending = __import__("collections").deque()

    def apply(self, index: int, cmd: dict) -> None:
        op = cmd.get("op")
        if op == "create_database":
            self.databases.setdefault(cmd["name"], {"rps": {"autogen": {"duration_ns": 0}},
                                                    "default_rp": "autogen"})
        elif op == "drop_database":
            self.databases.pop(cmd["name"], None)
        elif op == "create_rp":
            db = self.databases.get(cmd["db"])
            if db is not None:
                db["rps"][cmd["name"]] = {
                    "duration_ns": cmd.get("duration_ns", 0),
                    "shard_duration_ns": cmd.get("shard_duration_ns"),
                }
                if cmd.get("default"):
                    db["default_rp"] = cmd["name"]
        elif op == "alter_rp":
            db = self.databases.get(cmd["db"])
            if db is not None and cmd["name"] in db["rps"]:
                rp = db["rps"][cmd["name"]]
                new_dur = rp.get("duration_ns", 0) \
                    if cmd.get("duration_ns") is None else cmd["duration_ns"]
                new_sd = rp.get("shard_duration_ns") \
                    if cmd.get("shard_duration_ns") is None \
                    else cmd["shard_duration_ns"]
                if not new_sd:
                    # CREATE RP without SHARD DURATION stores None here but
                    # the engine auto-computed one — mirror it so this guard
                    # agrees with the engine's own rejection (explicit 0 =
                    # recompute, same as the engine)
                    from opengemini_tpu_torch.storage.engine import (
                        _auto_shard_duration,
                    )

                    new_sd = _auto_shard_duration(
                        rp.get("duration_ns", 0)
                        if cmd.get("shard_duration_ns") != 0 else new_dur)
                if new_dur and new_sd and new_dur < new_sd:
                    # two alters validated against stale state can commit a
                    # violating combination; the engine rejects it too —
                    # no-op so FSM and engines stay consistent
                    pass
                else:
                    rp["duration_ns"] = new_dur
                    if new_sd is not None:
                        rp["shard_duration_ns"] = new_sd
                    if cmd.get("default"):
                        db["default_rp"] = cmd["name"]
        elif op == "drop_rp":
            db = self.databases.get(cmd["db"])
            if db is not None:
                db["rps"].pop(cmd["name"], None)
                db.get("downsample", {}).pop(cmd["name"], None)
        elif op == "add_downsample":
            db = self.databases.get(cmd["db"])
            if db is not None:
                db.setdefault("downsample", {})[cmd["rp"]] = cmd["policies"]
                if cmd.get("ttl_ns") and cmd["rp"] in db["rps"]:
                    db["rps"][cmd["rp"]]["duration_ns"] = cmd["ttl_ns"]
        elif op == "drop_downsample":
            db = self.databases.get(cmd["db"])
            if db is not None:
                if cmd.get("rp"):
                    db.get("downsample", {}).pop(cmd["rp"], None)
                else:
                    db.get("downsample", {}).clear()
        elif op in _REGISTRY_CREATE:
            key, payload = _REGISTRY_CREATE[op]
            db = self.databases.get(cmd["db"])
            if db is not None:
                db.setdefault(key, {})[cmd[payload]["name"]] = cmd[payload]
        elif op in _REGISTRY_DROP:
            db = self.databases.get(cmd["db"])
            if db is not None:
                db.get(_REGISTRY_DROP[op], {}).pop(cmd["name"], None)
        elif op == "set_placement":
            if cmd.get("owners"):
                self.placement[cmd["key"]] = list(cmd["owners"])
        elif op == "drop_placement":
            self.placement.pop(cmd["key"], None)
        elif op == "register_node":
            self.nodes[cmd["id"]] = {"addr": cmd["addr"], "role": cmd.get("role", "data")}
        elif op == "remove_node":
            self.nodes.pop(cmd["id"], None)
        elif op == "raft_conf":
            # single-server membership change (committed-entry semantics —
            # a simplification of the dissertation's apply-on-append that
            # is safe one change at a time with a majority up). Removals
            # leave a tombstone so snapshot restore can subtract members
            # that were in a replica's static seed config.
            if cmd.get("action") == "add":
                self.meta_nodes[cmd["id"]] = cmd["addr"]
                self.meta_removed.discard(cmd["id"])
            else:
                self.meta_nodes.pop(cmd["id"], None)
                self.meta_removed.add(cmd["id"])
        elif op == "create_user":
            # full credential material (pre-hashed at propose time) lives in
            # FSM state so a snapshot can rebuild a replica's UserStore
            self.users[cmd["name"]] = {
                "admin": cmd.get("admin", False),
                "salt": cmd.get("salt"), "hash": cmd.get("hash"),
                "privileges": {},
            }
        elif op == "drop_user":
            self.users.pop(cmd["name"], None)
        elif op == "set_password":
            u = self.users.get(cmd["name"])
            if u is not None:
                u["salt"], u["hash"] = cmd.get("salt"), cmd.get("hash")
        elif op == "grant":
            u = self.users.get(cmd["user"])
            if u is not None:
                u.setdefault("privileges", {})[cmd["db"]] = cmd["privilege"]
        elif op == "revoke":
            u = self.users.get(cmd["user"])
            if u is not None:
                u.setdefault("privileges", {}).pop(cmd["db"], None)
        elif op == "grant_admin":
            if cmd["user"] in self.users:
                self.users[cmd["user"]]["admin"] = cmd.get("admin", True)
        elif op == "save_model":
            self.models[cmd["name"]] = cmd["doc"]
        elif op == "drop_model":
            self.models.pop(cmd["name"], None)
        # unknown ops are ignored deterministically (forward compatibility)
        self.applied_index = index
        if self.listeners:
            self.pending.append((index, cmd))

    def snapshot(self) -> dict:
        """Deep-copied state for raft compaction (the raft node keeps the
        result; sharing live dicts would let later applies mutate it)."""
        import json as _json

        return _json.loads(_json.dumps({
            "databases": self.databases, "nodes": self.nodes,
            "users": self.users, "applied_index": self.applied_index,
            "meta_removed": sorted(self.meta_removed),
            "meta_nodes": self.meta_nodes,
            "models": self.models,
            "placement": self.placement,
        }))

    def restore(self, state: dict) -> None:
        """Replace FSM state from a snapshot (startup load or
        InstallSnapshot) and queue a __restore__ event so attached
        engine/user listeners fully re-sync — their per-op replay can
        never cover commands that were compacted away."""
        import json as _json

        state = _json.loads(_json.dumps(state))
        self.databases = state.get("databases", {})
        self.nodes = state.get("nodes", {})
        self.users = state.get("users", {})
        self.applied_index = state.get("applied_index", 0)
        self.meta_removed = set(state.get("meta_removed", []))
        self.meta_nodes = state.get("meta_nodes", {})
        self.models = state.get("models", {})
        self.placement = state.get("placement", {})
        self.pending.append(
            (self.applied_index, {"op": "__restore__", "state": state})
        )


def _marker_io(path: str | None):
    """(read, write) closures for a persisted applied-index marker with an
    in-memory cache (no per-command disk re-read). path=None -> no-op."""
    import os as _os

    cache = {"idx": None}

    def read() -> int:
        if cache["idx"] is not None:
            return cache["idx"]
        if not path:
            cache["idx"] = 0
            return 0
        try:
            with open(path, encoding="utf-8") as f:
                cache["idx"] = int(f.read().strip())
        except (OSError, ValueError):
            cache["idx"] = 0
        return cache["idx"]

    def write(index: int) -> None:
        cache["idx"] = index
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(index))
            f.flush()
            _os.fsync(f.fileno())
        _os.replace(tmp, path)

    return read, write


class LoopbackTransport:
    """Single-node transport: nothing to send (no peers)."""

    def send(self, peer: str, msg: dict) -> None:  # pragma: no cover
        pass


class MetaStore:
    """RaftNode + MetaFSM + a ticker thread. `propose` on the leader;
    followers redirect via leader_hint()."""

    def __init__(self, node_id: str, peers: list[str], transport=None,
                 storage_path: str | None = None, tick_s: float = 0.05,
                 compact_threshold: int = 512):
        self.fsm = MetaFSM()
        self.node = RaftNode(
            node_id, peers, transport or LoopbackTransport(),
            apply_fn=self.fsm.apply, storage_path=storage_path,
            restore_fn=self.fsm.restore,
        )
        self._tick_s = tick_s
        self._compact_threshold = compact_threshold
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._drain_lock = lockdep.Lock()
        self._inflight = 0  # propose_and_wait calls awaiting confirmation
        self._inflight_lock = lockdep.Lock()
        self.listener_applied = 0
        # live meta membership: seed config ± committed raft_conf changes
        self._addr_lock = lockdep.Lock()
        self._meta_addrs: dict[str, str] = dict(
            getattr(transport, "addr_of", {}) or {p: "" for p in peers}
        )
        self._meta_addrs.setdefault(node_id, "")
        self._conf_lock = lockdep.Lock()  # one membership change at a time
        self.fsm.listeners.append(self._on_conf_change)

    def meta_members(self) -> dict[str, str]:
        """Snapshot of the membership address book (safe to iterate)."""
        with self._addr_lock:
            return dict(self._meta_addrs)

    def _on_conf_change(self, index: int, cmd: dict) -> None:
        """Adopt committed membership changes: update the address book and
        the raft peer set (idempotent — safe under restart replay)."""
        op = cmd.get("op")
        with self._addr_lock:
            if op == "raft_conf":
                if cmd.get("action") == "add":
                    self._meta_addrs[cmd["id"]] = cmd["addr"]
                    if cmd["id"] == self.node.id:
                        self.node.learner = False  # our join committed
                else:
                    self._meta_addrs.pop(cmd["id"], None)
            elif op == "__restore__":
                state = cmd["state"]
                for nid, addr in state.get("meta_nodes", {}).items():
                    self._meta_addrs[nid] = addr
                for nid in state.get("meta_removed", []):
                    self._meta_addrs.pop(nid, None)
                if self.node.id in state.get("meta_removed", []):
                    self.node.learner = True
            else:
                return
            members = dict(self._meta_addrs)
        addr_of = getattr(self.node.transport, "addr_of", None)
        if addr_of is not None:
            for nid, addr in members.items():
                if addr:
                    addr_of[nid] = addr
            for nid in list(addr_of):
                if nid not in members:
                    addr_of.pop(nid, None)
        self.node.set_peers(sorted(members))

    def bootstrap_membership(self) -> None:
        """Record the seed membership in the FSM (leader, once): joiners
        and snapshot-restored replicas must be able to derive the FULL
        member set from replicated state alone — a partial seed view would
        give them a smaller quorum and permit split-brain commits."""
        if not self.is_leader():
            return
        if self.fsm.meta_nodes:
            return
        for nid, addr in sorted(self.meta_members().items()):
            self.node.propose(
                {"op": "raft_conf", "action": "add", "id": nid, "addr": addr}
            )

    def propose_conf_change(self, action: str, nid: str, addr: str = "") -> bool:
        """Leader-side single-server membership change, serialized: raft's
        single-server correctness argument requires one change at a time."""
        with self._conf_lock:
            if not self.is_leader():
                return False
            return self.propose_and_wait(
                {"op": "raft_conf", "action": action, "id": nid, "addr": addr}
            )

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"raft-{self.node.id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._tick_s):
            self.node.tick()
            self.drain_listeners()
            self.bootstrap_membership()
            self.maybe_compact()

    def maybe_compact(self) -> None:
        """Snapshot + truncate when the log outgrows the threshold. Skipped
        while any propose_and_wait is confirming: compaction would erase
        the (index, term) it checks survival against."""
        if len(self.node.log) <= self._compact_threshold:
            return
        with self._inflight_lock:
            if self._inflight:
                return
            # only compact what listeners have fully enacted: a snapshot
            # index beyond listener progress would strand their side effects
            if self.fsm.listeners and self.listener_applied < self.node.last_applied:
                return
            self.node.take_snapshot(self.fsm.snapshot)

    def drain_listeners(self) -> None:
        """Run deferred listener side effects OUTSIDE the raft lock (disk
        I/O here must never stall heartbeats/elections)."""
        import logging

        with self._drain_lock:
            while self.fsm.pending:
                index, cmd = self.fsm.pending.popleft()
                for fn in self.fsm.listeners:
                    try:
                        fn(index, cmd)
                    except Exception:  # noqa: BLE001
                        logging.getLogger("opengemini_tpu_torch.meta").exception(
                            "meta listener failed at index %d", index
                        )
                self.listener_applied = index

    def propose(self, cmd: dict) -> bool:
        ok = self.node.propose(cmd) is not None
        self.drain_listeners()
        return ok

    def propose_and_wait(self, cmd: dict, timeout_s: float = 5.0) -> bool:
        """Propose and block until the entry APPLIES locally, including
        listener side effects (influx meta ops are synchronous). Verifies
        the entry SURVIVED at (index, term) — a deposed leader's entry can
        be overwritten at the same index by a successor."""
        import time as _t

        with self._inflight_lock:
            got = self.node.propose_with_term(cmd)
            if got is None:
                return False
            self._inflight += 1
        idx, term = got
        try:
            deadline = _t.monotonic() + timeout_s
            while True:
                self.drain_listeners()
                if self.node.entry_term(idx) != term:
                    return False  # overwritten after a leader change
                applied = (
                    self.node.last_applied >= idx
                    and (not self.fsm.listeners or self.listener_applied >= idx)
                )
                if applied:
                    return True
                if _t.monotonic() > deadline:
                    return False
                _t.sleep(0.01)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def attach_engine(self, engine) -> None:
        """Enact replicated DDL on the local storage engine — every
        replica's engine converges on the FSM's database set.

        Replay safety: raft re-applies the WHOLE log after restart
        (commit index is volatile). Engine side effects are guarded by a
        persisted applied-index marker, so a drop/re-create history can
        never replay a destructive drop over live data."""
        import os as _os

        _read_marker, _write_marker = _marker_io(
            _os.path.join(engine.root, "meta.applied")
        )

        def _full_sync(state: dict) -> None:
            """Reconcile the engine to a snapshot's database set: per-op
            replay can never cover commands compacted into the snapshot.
            Engine-local dbs starting with '_' (e.g. _internal) are not
            raft-managed and are left alone."""
            from opengemini_tpu_torch.services.subscriber import Subscription
            from opengemini_tpu_torch.storage.engine import (
                ContinuousQuery, DownsamplePolicy, StreamTask,
            )

            dbs = state.get("databases", {})
            # engine._lock is an RLock: hold it across the whole multi-step
            # reconcile so background CQ/retention/subscriber scans never
            # observe torn registries mid-restore (nested engine calls
            # re-enter the same lock)
            with engine._lock:
                for name in list(engine.databases):
                    if name not in dbs and not name.startswith("_"):
                        engine.drop_database(name)
                for name, meta in dbs.items():
                    if name not in engine.databases:
                        engine.create_database(name)
                    d = engine.databases[name]
                    rps = meta.get("rps", {})
                    for rp, rpmeta in rps.items():
                        if rp not in d.rps:
                            engine.create_retention_policy(
                                name, rp, rpmeta.get("duration_ns", 0),
                                rpmeta.get("shard_duration_ns"),
                                rp == meta.get("default_rp"),
                            )
                        else:
                            d.rps[rp].duration_ns = rpmeta.get("duration_ns", 0)
                            # shard duration is mutable via ALTER RETENTION
                            # POLICY — sync it too, or a snapshot-restored
                            # replica lays out new shard groups differently
                            sd = rpmeta.get("shard_duration_ns")
                            if sd:
                                d.rps[rp].shard_duration_ns = sd
                    for rp in list(d.rps):
                        if rp not in rps:
                            engine.drop_retention_policy(name, rp)
                    if meta.get("default_rp") in d.rps:
                        d.default_rp = meta["default_rp"]
                    # registries replace wholesale, keeping local CQ progress
                    old_cqs = d.continuous_queries
                    d.continuous_queries = {}
                    for n, j in meta.get("cqs", {}).items():
                        cq = ContinuousQuery.from_json(j)
                        prev = old_cqs.get(n)
                        if prev is not None and prev.select_text == cq.select_text:
                            cq.last_run_ns = prev.last_run_ns
                        d.continuous_queries[n] = cq
                    d.streams = {
                        n: StreamTask.from_json(j)
                        for n, j in meta.get("streams", {}).items()
                    }
                    d.subscriptions = {
                        n: Subscription.from_json(j)
                        for n, j in meta.get("subscriptions", {}).items()
                    }
                    d.downsample = {
                        rp: [DownsamplePolicy.from_json(p) for p in pols]
                        for rp, pols in meta.get("downsample", {}).items()
                    }
                engine.save_cq_state()  # persists meta.json (re-entrant lock)
            # fitted models reconcile to the snapshot's set
            want = state.get("models", {})
            for name in engine.models.names():
                if name not in want:
                    engine.models.drop(name)
            for name, doc in want.items():
                engine.models.save(name, doc)

        def on_apply(index: int, cmd: dict) -> None:
            if index <= _read_marker():
                return  # already enacted before a restart
            op = cmd.get("op")
            if op == "__restore__":
                _full_sync(cmd["state"])
                _write_marker(index)
                return
            if op == "create_database":
                engine.create_database(cmd["name"])
            elif op == "drop_database":
                engine.drop_database(cmd["name"])
            elif op == "create_rp":
                if cmd["db"] in engine.databases:
                    engine.create_retention_policy(
                        cmd["db"], cmd["name"], cmd.get("duration_ns", 0),
                        cmd.get("shard_duration_ns"), cmd.get("default", False),
                    )
            elif op == "alter_rp":
                if cmd["db"] in engine.databases:
                    try:
                        engine.alter_retention_policy(
                            cmd["db"], cmd["name"], cmd.get("duration_ns"),
                            cmd.get("shard_duration_ns"),
                            cmd.get("default", False),
                        )
                    except ValueError as e:
                        # rp vanished between commit and apply, or a
                        # stale-validated alter the FSM also no-opped —
                        # log it; silently diverging would be worse
                        import logging

                        logging.getLogger("opengemini_tpu_torch.meta").warning(
                            "alter_rp skipped by engine: %s", e)
            elif op == "drop_rp":
                engine.drop_retention_policy(cmd["db"], cmd["name"])
            elif op == "create_cq":
                if cmd["db"] in engine.databases:
                    from opengemini_tpu_torch.storage.engine import ContinuousQuery

                    engine.create_continuous_query(
                        cmd["db"], ContinuousQuery.from_json(cmd["cq"])
                    )
            elif op == "drop_cq":
                engine.drop_continuous_query(cmd["db"], cmd["name"])
            elif op == "create_stream":
                if cmd["db"] in engine.databases:
                    from opengemini_tpu_torch.storage.engine import StreamTask

                    engine.create_stream(
                        cmd["db"], StreamTask.from_json(cmd["task"])
                    )
            elif op == "drop_stream":
                engine.drop_stream(cmd["db"], cmd["name"])
            elif op == "create_subscription":
                if cmd["db"] in engine.databases:
                    from opengemini_tpu_torch.services.subscriber import Subscription

                    engine.create_subscription(
                        cmd["db"], Subscription.from_json(cmd["sub"])
                    )
            elif op == "drop_subscription":
                engine.drop_subscription(cmd["db"], cmd["name"])
            elif op == "save_model":
                engine.models.save(cmd["name"], cmd["doc"])
            elif op == "drop_model":
                engine.models.drop(cmd["name"])
            elif op == "add_downsample":
                if cmd["db"] in engine.databases:
                    from opengemini_tpu_torch.storage.engine import DownsamplePolicy

                    engine.set_downsample_policies(
                        cmd["db"], cmd["rp"],
                        [DownsamplePolicy.from_json(p) for p in cmd["policies"]],
                        ttl_ns=cmd.get("ttl_ns", 0),
                    )
            elif op == "drop_downsample":
                engine.drop_downsample_policies(cmd["db"], cmd.get("rp"))
            _write_marker(index)

        self.fsm.listeners.append(on_apply)

    def attach_users(self, user_store) -> None:
        """Enact replicated user commands on the local UserStore (same
        replay-safe marker discipline as attach_engine, via a sibling
        marker next to the user store)."""
        base = user_store.path or ""
        _read_marker, _write_marker = _marker_io(
            (base + ".applied") if base else None
        )

        user_ops = {"create_user", "drop_user", "set_password", "grant",
                    "revoke", "grant_admin"}

        def on_apply(index: int, cmd: dict) -> None:
            op = cmd.get("op")
            if op == "__restore__":
                if index <= _read_marker():
                    return
                user_store.restore_replicated(cmd["state"].get("users", {}))
                _write_marker(index)
                return
            if op not in user_ops:
                return
            if index <= _read_marker():
                return
            user_store.apply_replicated(cmd)
            _write_marker(index)

        self.fsm.listeners.append(on_apply)

    def is_leader(self) -> bool:
        return self.node.state == LEADER

    def leader_hint(self) -> str | None:
        return self.node.leader_id

    def status(self) -> dict:
        import copy

        with self.node._lock:  # FSM mutates under this lock (apply_fn)
            s = self.node.status()
            s["fsm"] = copy.deepcopy(self.fsm.snapshot())
        # never expose credential material (salt/PBKDF2 hash) through the
        # status surface — /raft/status has no admin gate
        s["fsm"]["users"] = {
            n: {"admin": u.get("admin", False)}
            for n, u in s["fsm"].get("users", {}).items()
        }
        return s


class HttpTransport:
    """Raft messages over HTTP POST /raft/msg (the control-plane analogue
    of the reference's meta RPC; the data plane is parallel/cluster.py's
    /internal/* routes).

    One long-lived sender thread per peer with a bounded queue: preserves
    per-peer ordering, caps memory when a peer is down, and avoids
    spawning a thread per heartbeat. `token` (shared cluster secret,
    config meta.token) authenticates intra-cluster messages."""

    def __init__(self, addr_of: dict[str, str], timeout_s: float = 0.5,
                 token: str = "", max_queue: int = 256, self_addr: str = "",
                 path: str = "/raft/msg"):
        import queue

        self.addr_of = addr_of
        self.timeout_s = timeout_s
        self.token = token
        self.path = path
        # advertised in every outgoing message so receivers can learn our
        # address: a joiner only knows its seed, yet must answer the
        # leader's appends — without this, catch-up deadlocks
        self.self_addr = self_addr
        self._queues: dict[str, queue.Queue] = {}
        self._lock = lockdep.Lock()
        self._max_queue = max_queue

    def send(self, peer: str, msg: dict) -> None:
        import queue

        addr = self.addr_of.get(peer)
        if not addr:
            return
        with self._lock:
            q = self._queues.get(peer)
            if q is None:
                q = queue.Queue(maxsize=self._max_queue)
                self._queues[peer] = q
                threading.Thread(
                    target=self._sender, args=(peer, q), daemon=True,
                    name=f"raft-send-{peer}",
                ).start()
        if self.token or self.self_addr:
            msg = dict(msg, token=self.token, addr=self.self_addr)
        try:
            q.put_nowait(msg)
        except queue.Full:
            pass  # drop under backpressure; raft retries via heartbeats

    def _sender(self, peer: str, q) -> None:
        while True:
            msg = q.get()
            # resolve per message: conf changes can re-address a peer while
            # this thread lives (a re-joined member would otherwise get
            # raft traffic at its dead old address forever)
            addr = self.addr_of.get(peer)
            if not addr:
                continue
            try:
                req = urllib.request.Request(
                    peers.url(addr, self.path),
                    data=json.dumps(msg).encode("utf-8"),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                peers.urlopen(req, timeout=self.timeout_s).read()
            except OSError:
                pass  # unreachable peers are raft's normal case
