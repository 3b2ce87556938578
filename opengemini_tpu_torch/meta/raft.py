"""Raft consensus for the metadata plane.

The port of ``opengemini_tpu/meta/raft.py``, whole, with a plain
``threading`` lock; its state file, log segment and snapshot sidecar are
the JAX package's, byte for byte. Reference: app/ts-meta uses hashicorp/raft (store.go:36, NewStore:437,
storeFSM.Apply store_fsm.go:77) to replicate the cluster data model.
This is a from-scratch Raft (election + log replication + persistence)
with a pluggable transport: tests drive an in-memory bus (with partitions
and message drops); deployments use the HTTP transport in meta/service.py.

Scope: leader election with randomized timeouts, AppendEntries log
replication with consistency checks and follower log repair, majority
commit, persisted (term, votedFor, log) — the Figure-2 core — plus log
compaction (§7): take_snapshot() truncates the applied prefix and an
InstallSnapshot RPC catches up followers whose needed entries were
compacted away. Log indices stay 1-based and ABSOLUTE; the in-memory
list holds entries (snap_index, snap_index+len(log)].

The node is DRIVEN: call tick() on a timer thread and deliver_* from the
transport; no internal threads, which keeps tests deterministic.
"""

from __future__ import annotations

import json
import os
import random
import struct
import threading
import zlib

from opengemini_tpu_torch.utils import lockdep

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class LogEntry:
    __slots__ = ("term", "cmd")

    def __init__(self, term: int, cmd):
        self.term = term
        self.cmd = cmd

    def to_json(self):
        return [self.term, self.cmd]


class RaftNode:
    def __init__(self, node_id: str, peers: list[str], transport,
                 apply_fn, storage_path: str | None = None,
                 election_ticks: tuple[int, int] = (10, 20),
                 heartbeat_ticks: int = 3, restore_fn=None):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.transport = transport
        self.apply_fn = apply_fn
        self.restore_fn = restore_fn  # state-machine full restore (snapshots)
        self.storage_path = storage_path
        self._lock = lockdep.RLock()

        # persistent state
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []
        self.snap_index = 0  # last log index covered by the snapshot
        self.snap_term = 0
        self.snap_state = None  # opaque state-machine snapshot
        self._load()

        # volatile
        self.state = FOLLOWER
        self.commit_index = self.snap_index  # 1-based; 0 = nothing
        self.last_applied = self.snap_index
        self.leader_id: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.votes: set[str] = set()

        self._election_ticks = election_ticks
        self._heartbeat_ticks = heartbeat_ticks
        self._ticks_until_election = self._rand_election()
        self._ticks_until_heartbeat = 0
        # learner: replicates but never campaigns. Set on joining nodes
        # (until their conf-add commits) and on removed nodes — both would
        # otherwise self-elect / zombie-campaign with inflated terms.
        self.learner = False
        if self.snap_state is not None and self.restore_fn:
            self.restore_fn(self.snap_state)

    # -- persistence ------------------------------------------------------
    #
    # Three files (reference: the raft log store, lib/raftlog wal.go —
    # hashicorp raft uses a real log store, not a rewritten blob):
    #   <path>       small JSON: term, voted_for, snap_index/term —
    #                rewritten only on the RARE events (votes, term bumps,
    #                compaction)
    #   <path>.seg   append-only framed entries [u32 len|u32 crc32|
    #                json([abs_index, term, cmd])] — the HOT path appends
    #                + fsyncs only the
    #                new suffix, O(1) per entry; rewritten only on suffix
    #                truncation (conflict repair) or compaction
    #   <path>.snap  opaque state-machine snapshot (compaction/install)
    # A torn tail in .seg (crash mid-append) is dropped at replay like the
    # storage WAL; raft re-replicates anything uncommitted.

    def _load(self) -> None:
        if not self.storage_path or not os.path.exists(self.storage_path):
            return
        with open(self.storage_path, encoding="utf-8") as f:
            j = json.load(f)
        self.current_term = j["term"]
        self.voted_for = j["voted_for"]
        self.snap_index = j.get("snap_index", 0)
        self.snap_term = j.get("snap_term", 0)
        if "log" in j:  # pre-segment format: migrate in place
            self.log = [LogEntry(t, c) for t, c in j["log"]]
            self._rewrite_log()
            self._persist_state()
        else:
            self.log = self._read_segment()
        # snapshot state lives in a sidecar written only on compaction /
        # install: hot paths must stay O(new data), not O(state)
        snap_path = self.storage_path + ".snap"
        if self.snap_index and os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                self.snap_state = json.load(f)

    def _read_segment(self) -> list:
        seg = self.storage_path + ".seg"
        out: list[LogEntry] = []
        if not os.path.exists(seg):
            return out
        with open(seg, "rb") as f:
            data = f.read()
        pos, expect = 0, self.snap_index + 1
        while pos + 8 <= len(data):
            length, crc = struct.unpack_from("<II", data, pos)
            payload = data[pos + 8 : pos + 8 + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                break  # torn tail: drop the rest
            idx, term, cmd = json.loads(payload)
            if idx == expect:  # skip compacted/stale prefixes
                out.append(LogEntry(term, cmd))
                expect += 1
            pos += 8 + length
        if pos < len(data):
            # truncate the torn tail NOW: later appends open with "ab" and
            # anything written after the garbage would be unreachable on
            # the next replay (committed entries silently regressing)
            with open(seg, "r+b") as f:
                f.truncate(pos)
                f.flush()
                os.fsync(f.fileno())
        return out

    def _append_segment(self, first_abs_index: int, entries) -> None:
        """Append-only persist of a new log suffix (the hot path)."""
        if not self.storage_path or not entries:
            return
        buf = bytearray()
        for i, e in enumerate(entries):
            payload = json.dumps([first_abs_index + i, e.term, e.cmd]).encode()
            buf += struct.pack("<II", len(payload), zlib.crc32(payload))
            buf += payload
        with open(self.storage_path + ".seg", "ab") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())

    def _rewrite_log(self) -> None:
        """Full segment rewrite — only on conflict truncation/compaction."""
        if not self.storage_path:
            return
        tmp = self.storage_path + ".seg.tmp"
        with open(tmp, "wb") as f:
            for i, e in enumerate(self.log):
                payload = json.dumps(
                    [self.snap_index + 1 + i, e.term, e.cmd]
                ).encode()
                f.write(struct.pack("<II", len(payload), zlib.crc32(payload)))
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.storage_path + ".seg")

    def _persist_state(self) -> None:
        if not self.storage_path:
            return
        tmp = self.storage_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({
                "term": self.current_term,
                "voted_for": self.voted_for,
                "snap_index": self.snap_index,
                "snap_term": self.snap_term,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.storage_path)

    def _persist_snapshot(self) -> None:
        """Write the sidecar FIRST, then the log file referencing it: a
        crash between the two leaves a snap file with no pointer (harmless)
        rather than a pointer with no state."""
        if not self.storage_path:
            return
        snap_path = self.storage_path + ".snap"
        tmp = snap_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.snap_state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap_path)

    # -- helpers ----------------------------------------------------------

    def _rand_election(self) -> int:
        return random.randint(*self._election_ticks)

    def _abs_last(self) -> int:
        """Absolute index of the last log entry (snapshot included)."""
        return self.snap_index + len(self.log)

    def _term_at(self, idx: int) -> int | None:
        """Term of the entry at absolute index idx; snap_term at the
        snapshot boundary; None outside the known range."""
        if idx == self.snap_index:
            return self.snap_term
        pos = idx - self.snap_index
        if 1 <= pos <= len(self.log):
            return self.log[pos - 1].term
        return None

    def _last_log(self) -> tuple[int, int]:
        """(index, term), 1-based absolute index, (0, 0) when empty."""
        if not self.log:
            return self.snap_index, self.snap_term
        return self._abs_last(), self.log[-1].term

    def _become_follower(self, term: int, leader: str | None = None) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_state()
        self.state = FOLLOWER
        self.leader_id = leader
        self.votes = set()

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # -- public API --------------------------------------------------------

    def propose(self, cmd) -> int | None:
        """Append a command (leader only). Returns its log index or None."""
        got = self.propose_with_term(cmd)
        return got[0] if got else None

    def propose_with_term(self, cmd) -> tuple[int, int] | None:
        """Like propose, but returns (index, term) so callers can verify
        the entry SURVIVED (a deposed leader's uncommitted entries can be
        overwritten at the same index by a new leader)."""
        with self._lock:
            if self.state != LEADER:
                return None
            self.log.append(LogEntry(self.current_term, cmd))
            self._append_segment(self._abs_last(), [self.log[-1]])
            idx = self._abs_last()
            term = self.current_term
            self.match_index[self.id] = idx
            self._broadcast_append()
            self._maybe_commit()  # single-node clusters commit immediately
            return idx, term

    def entry_term(self, idx: int) -> int | None:
        with self._lock:
            return self._term_at(idx)

    def set_peers(self, peers: list[str]) -> None:
        """Adopt a new peer set (committed conf change). Quorum follows
        automatically (quorum() derives from len(peers)). A node removed
        from its own cluster steps down and goes permanently quiet
        (learner mode — it must never campaign against the live cluster)."""
        with self._lock:
            new = [p for p in peers if p != self.id]
            removed = [p for p in self.peers if p not in new]
            if self.state == LEADER:
                # final notify: ship the committed removal to departing
                # members BEFORE forgetting them, so they learn of their
                # own removal and stop campaigning (instead of zombieing)
                for p in removed:
                    self._send_append(p)
            self.peers = new
            for p in removed:
                self.next_index.pop(p, None)
                self.match_index.pop(p, None)
            if self.state == LEADER:
                for p in new:
                    self.next_index.setdefault(p, self._abs_last() + 1)
                    self.match_index.setdefault(p, 0)
            if self.id not in peers:
                self.state = FOLLOWER
                self.leader_id = None
                self.learner = True

    def take_snapshot(self, state_fn) -> bool:
        """Compact the applied log prefix. state_fn() is called UNDER the
        raft lock so the captured state-machine state corresponds exactly
        to last_applied (apply_fn runs under this lock too)."""
        with self._lock:
            if self.last_applied <= self.snap_index:
                return False
            idx = self.last_applied
            term = self._term_at(idx)
            state = state_fn()
            del self.log[: idx - self.snap_index]
            self.snap_index = idx
            self.snap_term = term
            self.snap_state = state
            # ordering: sidecar, then state (new snap_index), then the
            # segment rewrite — a crash leaving the OLD segment with the
            # NEW snap_index is safe (stale prefix frames are skipped at
            # replay), while the reverse would drop the retained suffix
            self._persist_snapshot()
            self._persist_state()
            self._rewrite_log()
            return True

    def tick(self) -> None:
        """Advance timers: election timeout / leader heartbeat."""
        with self._lock:
            if self.state == LEADER:
                self._ticks_until_heartbeat -= 1
                if self._ticks_until_heartbeat <= 0:
                    self._ticks_until_heartbeat = self._heartbeat_ticks
                    self._broadcast_append()
                return
            self._ticks_until_election -= 1
            if self._ticks_until_election <= 0:
                if self.learner:
                    self._ticks_until_election = self._rand_election()
                    return
                self._start_election()

    # -- election ----------------------------------------------------------

    def _start_election(self) -> None:
        self.state = CANDIDATE
        self.current_term += 1
        self.voted_for = self.id
        self._persist_state()
        self.votes = {self.id}
        self.leader_id = None
        self._ticks_until_election = self._rand_election()
        last_idx, last_term = self._last_log()
        if len(self.votes) >= self.quorum():  # single-node cluster
            self._become_leader()
            return
        for p in self.peers:
            self.transport.send(p, {
                "type": "request_vote", "from": self.id,
                "term": self.current_term,
                "last_log_index": last_idx, "last_log_term": last_term,
            })

    _REQUIRED_FIELDS = {
        "request_vote": ("from", "term", "last_log_index", "last_log_term"),
        "request_vote_reply": ("from", "term", "granted"),
        "append_entries": ("from", "term", "prev_log_index", "prev_log_term",
                           "entries", "leader_commit"),
        "append_entries_reply": ("from", "term", "ok", "match_index"),
        "install_snapshot": ("from", "term", "snap_index", "snap_term",
                             "state"),
    }

    @classmethod
    def valid_message(cls, msg) -> bool:
        if not isinstance(msg, dict):
            return False
        req = cls._REQUIRED_FIELDS.get(msg.get("type"))
        return req is not None and all(k in msg for k in req)

    def deliver(self, msg: dict) -> None:
        """Transport entry point for every message type; malformed
        messages are dropped (the HTTP layer also 400s them)."""
        if not self.valid_message(msg):
            return
        # a REMOVED member keeps timing out and campaigning with ever
        # higher terms; ignoring vote traffic from non-members stops it
        # deposing live leaders (§6 disruption problem). Append/install
        # from unknown senders stay allowed so a joining node with a
        # partial seed view can still be caught up by the leader.
        if msg["type"].startswith("request_vote") and msg["from"] not in self.peers:
            return
        handlers = {
            "request_vote": self._on_request_vote,
            "request_vote_reply": self._on_request_vote_reply,
            "append_entries": self._on_append_entries,
            "append_entries_reply": self._on_append_entries_reply,
            "install_snapshot": self._on_install_snapshot,
        }
        with self._lock:
            handlers[msg["type"]](msg)

    def _on_request_vote(self, m: dict) -> None:
        if m["term"] > self.current_term:
            self._become_follower(m["term"])
        granted = False
        if m["term"] == self.current_term and self.voted_for in (None, m["from"]):
            last_idx, last_term = self._last_log()
            up_to_date = (m["last_log_term"], m["last_log_index"]) >= (last_term, last_idx)
            if up_to_date:
                granted = True
                self.voted_for = m["from"]
                self._persist_state()
                self._ticks_until_election = self._rand_election()
        self.transport.send(m["from"], {
            "type": "request_vote_reply", "from": self.id,
            "term": self.current_term, "granted": granted,
        })

    def _on_request_vote_reply(self, m: dict) -> None:
        if m["term"] > self.current_term:
            self._become_follower(m["term"])
            return
        if self.state != CANDIDATE or m["term"] != self.current_term:
            return
        if m["granted"]:
            self.votes.add(m["from"])
            if len(self.votes) >= self.quorum():
                self._become_leader()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        # commit a no-op immediately: entries from previous terms can only
        # commit indirectly through a current-term entry (Raft §8) —
        # without this, previously-replicated entries stall until the next
        # client proposal
        self.log.append(LogEntry(self.current_term, {"op": "noop"}))
        self._append_segment(self._abs_last(), [self.log[-1]])
        last_idx, _ = self._last_log()
        self.next_index = {p: last_idx for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.match_index[self.id] = last_idx
        self._ticks_until_heartbeat = 0
        self._maybe_commit()  # single-node clusters
        self._broadcast_append()

    # -- replication -------------------------------------------------------

    def _broadcast_append(self) -> None:
        for p in self.peers:
            self._send_append(p)

    def _send_append(self, peer: str) -> None:
        ni = self.next_index.get(peer, self.snap_index + 1)
        if ni <= self.snap_index:
            # the entries the follower needs were compacted away: ship the
            # whole snapshot instead (Raft §7 InstallSnapshot)
            self.transport.send(peer, {
                "type": "install_snapshot", "from": self.id,
                "term": self.current_term,
                "snap_index": self.snap_index, "snap_term": self.snap_term,
                "state": self.snap_state,
            })
            return
        prev_idx = ni - 1
        prev_term = self._term_at(prev_idx) or 0
        entries = [e.to_json() for e in self.log[ni - self.snap_index - 1 :]]
        self.transport.send(peer, {
            "type": "append_entries", "from": self.id,
            "term": self.current_term,
            "prev_log_index": prev_idx, "prev_log_term": prev_term,
            "entries": entries, "leader_commit": self.commit_index,
        })

    def _on_append_entries(self, m: dict) -> None:
        if m["term"] > self.current_term:
            self._become_follower(m["term"], m["from"])
        ok = False
        match_idx = 0
        if m["term"] == self.current_term:
            self.state = FOLLOWER
            self.leader_id = m["from"]
            self._ticks_until_election = self._rand_election()
            prev_idx = m["prev_log_index"]
            if prev_idx < self.snap_index:
                prev_ok = True  # snapshot covers it: committed by definition
            elif prev_idx == self.snap_index:
                prev_ok = prev_idx == 0 or m["prev_log_term"] == self.snap_term
            else:
                prev_ok = self._term_at(prev_idx) == m["prev_log_term"]
            if prev_ok:
                ok = True
                # overwrite conflicting suffix, append new entries
                idx = prev_idx
                truncated = False
                appended_from: int | None = None  # in-memory log position
                for term, cmd in m["entries"]:
                    idx += 1
                    if idx <= self.snap_index:
                        continue  # already compacted (committed) here
                    pos = idx - self.snap_index
                    if pos <= len(self.log):
                        if self.log[pos - 1].term != term:
                            del self.log[pos - 1 :]
                            self.log.append(LogEntry(term, cmd))
                            truncated = True
                            if appended_from is None:
                                appended_from = pos - 1
                    else:
                        self.log.append(LogEntry(term, cmd))
                        if appended_from is None:
                            appended_from = pos - 1
                if truncated:
                    self._rewrite_log()  # conflict repair: rare
                elif appended_from is not None:
                    self._append_segment(
                        self.snap_index + appended_from + 1,
                        self.log[appended_from:],
                    )
                match_idx = max(idx, self.snap_index)
                if m["leader_commit"] > self.commit_index:
                    self.commit_index = min(m["leader_commit"], self._abs_last())
                    self._apply_committed()
        self.transport.send(m["from"], {
            "type": "append_entries_reply", "from": self.id,
            "term": self.current_term, "ok": ok, "match_index": match_idx,
            "hint_next": self._abs_last() + 1,
        })

    def _on_install_snapshot(self, m: dict) -> None:
        if m["term"] > self.current_term:
            self._become_follower(m["term"], m["from"])
        ok = False
        if m["term"] == self.current_term:
            self.state = FOLLOWER
            self.leader_id = m["from"]
            self._ticks_until_election = self._rand_election()
            ok = True
            si, st = m["snap_index"], m["snap_term"]
            if si > self.last_applied:
                # adopt: replace state wholesale; keep a log suffix only
                # when it provably follows the snapshot
                if self._term_at(si) == st:
                    del self.log[: si - self.snap_index]
                else:
                    self.log = []
                self.snap_index, self.snap_term = si, st
                self.snap_state = m["state"]
                self.commit_index = max(self.commit_index, si)
                self.last_applied = si
                if self.restore_fn:
                    self.restore_fn(m["state"])
                self._persist_snapshot()
                self._persist_state()
                self._rewrite_log()
                self._apply_committed()  # retained suffix up to commit
        self.transport.send(m["from"], {
            "type": "append_entries_reply", "from": self.id,
            "term": self.current_term, "ok": ok,
            "match_index": self.last_applied if ok else 0,
            "hint_next": self._abs_last() + 1,
        })

    def _on_append_entries_reply(self, m: dict) -> None:
        if m["term"] > self.current_term:
            self._become_follower(m["term"])
            return
        if self.state != LEADER or m["term"] != self.current_term:
            return
        peer = m["from"]
        if m["ok"]:
            self.match_index[peer] = max(self.match_index.get(peer, 0), m["match_index"])
            self.next_index[peer] = self.match_index[peer] + 1
            self._maybe_commit()
        else:
            # log repair: back off (bounded by the follower's hint)
            self.next_index[peer] = max(
                1, min(self.next_index.get(peer, 1) - 1, m.get("hint_next", 1))
            )
            self._send_append(peer)

    def _maybe_commit(self) -> None:
        for idx in range(self._abs_last(), self.commit_index, -1):
            if self._term_at(idx) != self.current_term:
                break  # only commit entries from the current term (§5.4.2)
            votes = sum(1 for mi in self.match_index.values() if mi >= idx)
            if votes >= self.quorum():
                self.commit_index = idx
                self._apply_committed()
                break

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self.log[self.last_applied - self.snap_index - 1]
            self.apply_fn(self.last_applied, entry.cmd)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "id": self.id, "state": self.state, "term": self.current_term,
                "leader": self.leader_id, "log_len": len(self.log),
                "commit_index": self.commit_index,
                "snap_index": self.snap_index,
            }
