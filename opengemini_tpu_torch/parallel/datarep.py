"""Strict-consistency data replication: raft-committed writes.

The port of ``opengemini_tpu/parallel/datarep.py``, whole, with a plain
``threading`` lock, over the port's meta/raft.py. Its /internal/raftdata
messages, proposals and raft files (``<root>/raftdata/<group>.log``) are
the JAX package's, so a port node and a JAX node share a replica group.
Beyond the reference, the same writes commit sooner: a committed batch
applies to the engine as one columnar batch where parallel/cluster.py
``write_points`` can (the rows of the reference's structured write), a
group's sender waits ``GROUP_SEND_TIMEOUT_S`` for a peer to take a
message and drops appends that a newer one supersedes or that the peer
already took (``_coalesced``; the meta plane's transport sends as the
reference does), and a write's owner sets are computed once per shard
group.

Reference: the replication HA policy's etcd-raft data path — one raft
group per replica group, writes commit through its log before the client
ACKs (lib/raftconn/node.go:108 StartNode, engine/partition_raft.go).
Here a replica group is a DISTINCT rf-owner set from rendezvous
placement; its members run one RaftNode (the same from-scratch raft as
the meta plane, meta/raft.py) whose FSM applies committed write batches
to each member's local engine. Engine writes are LWW-idempotent, so
restart log replay needs no applied markers — re-applying a batch
converges to the same state.

Contrast with the default write-available policy (hinted handoff +
anti-entropy, parallel/cluster.py): replication trades availability for
consistency — a write ACKs only after a RAFT MAJORITY of the owner set
has durably logged it, and with rf=2 one dead owner blocks writes to its
groups (the strict mode's defining property). Reads stay primary-
filtered; replicas are consistent by construction.

Catch-up beyond log compaction: the write FSM's raft snapshot carries no
rows (state lives in the engine), so a straggler needing compacted
entries converges through the rf>1 anti-entropy digest repair instead —
the compact threshold is set high to make that rare.

Membership changes: owner sets are a pure function of the roster, so a
roster change simply routes new writes to a NEW group over the new set;
the old group idles (its log compacts to a marker) and the data itself
moves via the two-phase migration service. SHOW DIAGNOSTICS lists the
live groups with their raft state.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time as _time
import urllib.request

from opengemini_tpu_torch.meta.raft import LEADER, RaftNode
from opengemini_tpu_torch.meta.service import HttpTransport
from opengemini_tpu_torch.parallel.cluster import (
    RemoteScanError, decode_points, encode_points, write_points,
)
from opengemini_tpu_torch.utils import peers
from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

logger = logging.getLogger("opengemini_tpu_torch.datarep")

_TICK_S = 0.05
_COMPACT = 4096
# how long a replica group's sender waits for a peer to take one message
GROUP_SEND_TIMEOUT_S = 5.0


def gid_of(owner_set: tuple) -> str:
    return "rg:" + ",".join(owner_set)


class _WriteFSM:
    """apply = the engine's write (cluster.write_points). A batch a
    replica cannot apply (schema conflict discovered only here) is
    logged and skipped — the group must keep applying; the coordinator
    validated against its own engine before proposing, so divergence
    means operator intervention either way and anti-entropy will surface
    it."""

    def __init__(self, engine):
        self.engine = engine
        self.applied = 0

    def apply(self, index: int, cmd: dict) -> None:
        if cmd.get("op") == "write":
            try:
                write_points(self.engine, cmd["db"],
                             decode_points(cmd["points"]),
                             cmd.get("rp") or None)
            except Exception:  # noqa: BLE001 — the group must advance
                logger.exception("datarep apply failed at index %d", index)
        self.applied = index

    def snapshot(self) -> dict:
        # rows live in the engine; the snapshot is only a compaction
        # marker (see module docstring re: straggler catch-up)
        return {"applied": self.applied}

    def restore(self, state: dict) -> None:
        self.applied = int(state.get("applied", 0))


class ReplicaGroup:
    """One raft group over one owner set: RaftNode + write FSM + ticker."""

    def __init__(self, gid: str, self_id: str, owner_set: tuple,
                 addr_of: dict, engine, token: str, self_addr: str):
        self.gid = gid
        self.owner_set = owner_set
        self.fsm = _WriteFSM(engine)
        safe = gid.replace(":", "_").replace(",", "-")
        storage_dir = os.path.join(engine.root, "raftdata")
        os.makedirs(storage_dir, exist_ok=True)
        transport = _GroupTransport(gid, owner_set, addr_of, token,
                                    self_addr)
        self.node = RaftNode(
            self_id, sorted(owner_set), transport,
            apply_fn=self.fsm.apply,
            storage_path=os.path.join(storage_dir, safe + ".log"),
            restore_fn=self.fsm.restore,
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"datarep-{gid}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(_TICK_S):
            self.node.tick()
            if len(self.node.log) > _COMPACT:
                self.node.take_snapshot(self.fsm.snapshot)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def is_leader(self) -> bool:
        return self.node.state == LEADER

    def propose_and_wait(self, cmd: dict, timeout_s: float = 10.0) -> bool:
        got = self.node.propose_with_term(cmd)
        if got is None:
            return False
        idx, term = got
        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            t = self.node.entry_term(idx)
            if t == term:
                if self.node.last_applied >= idx:
                    # re-check the term AFTER observing applied: an
                    # overwrite + apply can land between the two reads
                    # (compacted-now reads None -> conservative False)
                    return self.node.entry_term(idx) == term
            else:
                # t different: overwritten after a leader change — an
                # applied-first order would falsely ACK once the
                # OVERWRITING entry applies (a lost write acked). t None:
                # compacted before we confirmed the term — conservatively
                # report False; the retry is LWW-idempotent, a false ACK
                # is not recoverable.
                return False
            _time.sleep(_TICK_S / 2)
        return False


class _GroupTransport(HttpTransport):
    """Raft messages for one replica group ride /internal/raftdata with
    the group id + owner set attached (the receiver creates its member
    lazily on first delivery)."""

    def __init__(self, gid: str, owner_set: tuple, addr_of: dict,
                 token: str, self_addr: str):
        # the reference waits 0.5 s, as the meta plane does; a write
        # batch's append (24 000 points are about 17 MB of JSON) takes the
        # peer longer to parse and log, and an answer that misses the
        # wait makes the sender resend the entries whole
        super().__init__(addr_of, timeout_s=GROUP_SEND_TIMEOUT_S,
                         token=token, self_addr=self_addr,
                         path="/internal/raftdata")
        self._gid = gid
        self._owners = list(owner_set)

    def send(self, peer: str, msg: dict) -> None:
        super().send(peer, dict(msg, group=self._gid,
                                owners=self._owners))

    def _sender(self, peer: str, q) -> None:
        # (term, prev_log_index, last index) of the newest append this
        # peer took whole (its answer came back; the acknowledgement is
        # on its way): a resend of those entries goes as a heartbeat
        # without them. The peer's match only rises (the leader keeps the
        # larger), and its commit catches up at the next append
        delivered = None
        while True:
            for msg in _coalesced(q):
                # resolve per message, as the meta plane's sender does
                addr = self.addr_of.get(peer)
                if not addr:
                    continue
                span = _append_span(msg)
                if span is not None and delivered is not None \
                        and span[:2] == delivered[:2] \
                        and span[2] <= delivered[2]:
                    msg = dict(msg, entries=[])
                    span = None
                try:
                    req = urllib.request.Request(
                        peers.url(addr, self.path),
                        data=json.dumps(msg).encode("utf-8"),
                        headers={"Content-Type": "application/json"},
                        method="POST",
                    )
                    peers.urlopen(req, timeout=self.timeout_s).read()
                    if span is not None:
                        delivered = span
                except OSError:
                    pass  # unreachable peers are raft's normal case


def _append_span(msg: dict):
    """(term, prev_log_index, last index) of an append_entries message
    that carries entries, else None."""
    if msg.get("type") != "append_entries" or not msg.get("entries"):
        return None
    prev = msg["prev_log_index"]
    return (msg["term"], prev, prev + len(msg["entries"]))


def _coalesced(q) -> list:
    """The next message and every one queued behind it, with only the
    newest append_entries of them kept (last, after the others in their
    order). A leader resends every unacknowledged entry at each heartbeat,
    so while one write batch's append (about 17 MB of JSON for 24 000
    points) is on the wire the queue fills with copies that the newest
    supersedes; raft tolerates the dropped and reordered messages as it
    tolerates a lossy network. Every body sent is one the reference
    sends."""
    msgs = [q.get()]
    while True:
        try:
            msgs.append(q.get_nowait())
        except queue.Empty:
            break
    appends = [m for m in msgs if m.get("type") == "append_entries"]
    out = [m for m in msgs if m.get("type") != "append_entries"]
    return out + appends[-1:]


class DataReplication:
    """Manager: lazy replica groups + the strict write path."""

    def __init__(self, router, token: str = ""):
        self.router = router
        self.engine = router.engine
        self.token = token
        self.groups: dict[str, ReplicaGroup] = {}
        self._lock = lockdep.Lock()
        # live address book shared (by reference) with every group
        # transport; refreshed from the roster on ensure/deliver
        self._addr_of: dict[str, str] = {}

    def _refresh_addrs(self) -> None:
        for nid, addr in self.router.data_nodes().items():
            if addr:
                self._addr_of[nid] = addr

    def ensure_group(self, owner_set: tuple) -> ReplicaGroup:
        gid = gid_of(owner_set)
        with self._lock:
            grp = self.groups.get(gid)
            if grp is None:
                self._refresh_addrs()
                grp = ReplicaGroup(
                    gid, self.router.self_id, owner_set, self._addr_of,
                    self.engine, self.token, self.router.self_addr)
                self.groups[gid] = grp
        return grp

    def deliver(self, msg: dict) -> bool:
        owner_set = tuple(msg.pop("owners", ()))
        gid = msg.pop("group", "")
        if self.router.self_id not in owner_set or gid != gid_of(owner_set):
            return False
        self._refresh_addrs()
        self.ensure_group(owner_set).node.deliver(msg)
        return True

    def stop(self) -> None:
        with self._lock:
            for grp in self.groups.values():
                grp.stop()
            self.groups.clear()

    def group_status(self) -> list[list]:
        """Snapshot rows for SHOW DIAGNOSTICS (taken under the lock —
        lazy group creation mutates self.groups concurrently)."""
        with self._lock:
            items = list(self.groups.items())
        return [
            [gid, ",".join(g.owner_set), g.node.state,
             g.node.leader_id or "", len(g.node.log), g.node.last_applied]
            for gid, g in sorted(items)
        ]

    # -- write path -------------------------------------------------------

    def write(self, db: str, rp, points: list) -> int:
        """Raft-committed write: every point's batch commits through its
        owner set's raft group before the ACK. Raises RemoteScanError
        when any group cannot commit (strict mode: no hints)."""
        d = self.engine.databases.get(db)
        if d is None:
            from opengemini_tpu_torch.storage.engine import DatabaseNotFound

            raise DatabaseNotFound(db)
        rp_name = rp or d.default_rp
        ids = sorted(self.router.data_nodes())
        # group_owners (not raw rendezvous), once per shard group: a
        # balancer placement override must steer writes to the same
        # owners migration moves the data to
        dest_of = self.router._owners_memo(db, rp, rp_name, ids)
        buckets: dict[tuple, list] = {}
        for p in points:
            # SORTED owner set: rendezvous order varies per group start,
            # and order-variant tuples must share ONE raft group per
            # distinct membership (not rf! of them)
            own = tuple(sorted(dest_of(p[2])))
            buckets.setdefault(own, []).append(p)
        # buckets commit through INDEPENDENT raft groups: run them
        # concurrently (a serial walk would multiply cold-group election
        # waits by the bucket count), all-or-error semantics unchanged
        errors: list[Exception] = []

        def commit(owner_set: tuple, pts: list) -> None:
            cmd = {"op": "write", "db": db, "rp": rp_name,
                   "points": encode_points(pts)}
            try:
                if self.router.self_id in owner_set:
                    if not self._commit_local(owner_set, cmd):
                        raise RemoteScanError(
                            f"replication commit failed for group "
                            f"{gid_of(owner_set)} (no quorum?)")
                else:
                    self._commit_remote(owner_set, cmd)
                STATS.incr("cluster", "raft_write_batches")
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        items = sorted(buckets.items())
        if len(items) == 1:
            commit(*items[0])
        else:
            threads = [
                threading.Thread(target=commit, args=(own, pts),
                                 daemon=True)
                for own, pts in items
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0] if isinstance(
                errors[0], RemoteScanError) else RemoteScanError(
                str(errors[0]))
        return sum(len(pts) for _own, pts in items)

    def _commit_local(self, owner_set: tuple, cmd: dict) -> bool:
        grp = self.ensure_group(owner_set)
        deadline = _time.monotonic() + 10.0
        while _time.monotonic() < deadline:
            if grp.is_leader():
                remaining = max(deadline - _time.monotonic(), 0.5)
                if grp.propose_and_wait(cmd, timeout_s=remaining):
                    return True
                # deposed between check and propose (or the entry was
                # overwritten): retrying is LWW-idempotent — keep going
                # until the deadline instead of failing a live group
                continue
            hint = grp.node.leader_id
            if hint and hint != self.router.self_id:
                addr = self._addr_of.get(hint)
                try:
                    if addr and self._propose_at(addr, owner_set, cmd):
                        return True
                except OSError:
                    pass  # hinted leader died: re-election is in flight
            _time.sleep(0.1)  # election in progress: wait, re-check
        return False

    def _commit_remote(self, owner_set: tuple, cmd: dict) -> None:
        self._refresh_addrs()
        last = None
        deadline = _time.monotonic() + 10.0
        while _time.monotonic() < deadline:
            # retry across members until the group's (possibly FIRST)
            # election settles — a cold group answers not-leader from
            # every member for ~1s
            for peer in owner_set:
                addr = self._addr_of.get(peer)
                if not addr:
                    continue
                try:
                    if self._propose_at(addr, owner_set, cmd):
                        return
                except OSError as e:
                    last = e
            _time.sleep(0.2)
        raise RemoteScanError(
            f"no owner of {gid_of(owner_set)} accepted the raft write"
            + (f": {last}" if last else ""))

    def _propose_at(self, addr: str, owner_set: tuple, cmd: dict,
                    hops: int = 3) -> bool:
        """POST the proposal to a member; follow leader redirects."""
        body = dict(cmd, owners=list(owner_set), token=self.token)
        for _ in range(hops):
            got = self.router._post(addr, "/internal/raftdata_propose",
                                    body, timeout=15.0)
            if got.get("ok"):
                return True
            nxt = got.get("leader_addr")
            if not nxt or nxt == addr:
                return False
            addr = nxt
        return False

    def handle_propose(self, req: dict) -> dict:
        """Server side of /internal/raftdata_propose."""
        owner_set = tuple(req.get("owners", ()))
        if self.router.self_id not in owner_set:
            return {"ok": False, "error": "not an owner"}
        grp = self.ensure_group(owner_set)
        cmd = {"op": "write", "db": req["db"], "rp": req.get("rp"),
               "points": req.get("points", [])}
        if grp.is_leader():
            return {"ok": grp.propose_and_wait(cmd)}
        hint = grp.node.leader_id
        self._refresh_addrs()
        return {"ok": False,
                "leader_addr": self._addr_of.get(hint or "", "")}
