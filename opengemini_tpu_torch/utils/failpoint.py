"""Failpoint-style fault injection.

The port of ``opengemini_tpu/utils/failpoint.py``, whole. Sites are free
at runtime when no failpoint is armed (one truthiness check of an empty
dict).

Arming:
  - code:      failpoint.enable("shard-flush-before-publish", "error")
  - env:       OGTPU_FAILPOINTS="wal-before-sync=error;flush=sleep:0.5"
  - HTTP:      POST /debug/ctrl?mod=failpoint&name=...&action=...

Actions:
  - "error"            raise FailpointError
  - "panic"            os._exit(13): a hard crash the recovery paths must
                       survive
  - "sleep:<seconds>"  widen a race window
  - "wait:<event>"     block until another site (or the test) fires
                       "set:<event>"; bounded by WAIT_TIMEOUT_S, raising
                       on timeout so a mis-paired schedule fails instead
                       of hanging
  - "set:<event>"      release every waiter of <event> (idempotent)
  - "barrier:<n>"      rendezvous of n hits across threads (the site name
                       scopes the barrier); bounded like wait
  - "off"              disarm (counts hits only)
  - callable           registered via enable(); return value ignored
Any action may carry a "#<k>" suffix: fire only on the k-th hit of the
site (1-based) and count hits otherwise.

The sites of the port: the WAL (wal-after-append, wal-before-sync,
wal-rotate-before-rename, wal-rotate-after-rename), the memtable
(memtable-freeze, memtable-consolidate-before-store), the shard's flush
(shard-flush-after-rotate, -before-encode, -before-publish,
-after-publish, -before-wal-truncate, -after-wal-truncate), compaction
(compact-before-replace, compact-after-replace, compact-before-retire),
quarantine (quarantine-before-mark) and the engine's write path
(engine-before-wal-commit, engine-before-threshold-flush).

Counts are recorded per site, and every hit of an armed site (of every
site with record_all(True)) is appended to an ordering log of (seq,
site, thread) so schedule tests can assert which interleaving ran.
"""

from __future__ import annotations

import os
import threading
import time

from opengemini_tpu_torch.utils import lockdep

_lock = lockdep.Lock()
_active: dict[str, object] = {}
_hits: dict[str, int] = {}
_events: dict[str, threading.Event] = {}
# site -> [arrival count, Condition, poisoned]; poisoned releases every
# parked waiter (disable_all teardown must never leave a product thread
# blocked at a barrier for the full wait timeout)
_barriers: dict[str, list] = {}
_hit_log: list[tuple[int, str, str]] = []
_record_all = False
_LOG_MAX = 8192  # bounded: schedule assertions read the prefix

# a mis-paired wait:/barrier: must fail the test, not hang the suite
WAIT_TIMEOUT_S = float(os.environ.get("OGTPU_FAILPOINT_WAIT_S", "30"))


class FailpointError(RuntimeError):
    def __init__(self, name: str):
        super().__init__(f"failpoint {name!r} injected error")
        self.name = name


def _load_env() -> None:
    spec = os.environ.get("OGTPU_FAILPOINTS", "")
    for part in spec.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, action = part.partition("=")
        _active[name.strip()] = action.strip()


_load_env()


def enable(name: str, action) -> None:
    with _lock:
        _active[name] = action


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def disable_all() -> None:
    global _record_all
    with _lock:
        _active.clear()
        _hits.clear()
        _hit_log.clear()
        for st in _barriers.values():
            st[2] = True  # poison: parked waiters wake and proceed
            st[1].notify_all()
        _barriers.clear()
        for ev in _events.values():
            ev.set()  # release stranded waiters before forgetting them
        _events.clear()
        _record_all = False


def active() -> dict:
    with _lock:
        return dict(_active)


def hits(name: str) -> int:
    with _lock:
        return _hits.get(name, 0)


def all_hits() -> dict[str, int]:
    """Per-site hit counts (exported at /debug/vars)."""
    with _lock:
        return dict(_hits)


def record_all(on: bool = True) -> None:
    """Log EVERY site reached (not just armed ones) into the ordering
    log — schedule tests use this to assert the interleaving that ran."""
    global _record_all
    with _lock:
        _record_all = on


def hit_log() -> list[tuple[int, str, str]]:
    """Ordered (seq, site, thread-name) hits recorded so far."""
    with _lock:
        return list(_hit_log)


def set_event(event: str) -> None:
    """Release every "wait:<event>" site (and future ones)."""
    _event(event).set()


def clear_event(event: str) -> None:
    _event(event).clear()


def _event(name: str) -> threading.Event:
    with _lock:
        ev = _events.get(name)
        if ev is None:
            ev = _events[name] = threading.Event()
        return ev


def _barrier_wait(site: str, parties: int) -> None:
    with _lock:
        st = _barriers.get(site)
        if st is None:
            st = _barriers[site] = [0, lockdep.Condition(_lock), False]
        st[0] += 1
        cond = st[1]
        if st[0] % parties == 0:
            cond.notify_all()
            return
        gen = st[0] // parties
        deadline = time.monotonic() + WAIT_TIMEOUT_S
        while (not st[2] and st[0] // parties <= gen
               and st[0] % parties != 0):
            left = deadline - time.monotonic()
            if left <= 0 or not cond.wait(left):
                raise RuntimeError(
                    f"failpoint barrier {site!r} timed out "
                    f"({st[0] % parties}/{parties} arrived)")


def inject(name: str) -> None:
    """The site hook. No-op unless `name` is armed (or record_all)."""
    if not _active and not _record_all:  # fast path: nothing armed
        return
    with _lock:
        action = _active.get(name)
        if action is None and not _record_all:
            return
        _hits[name] = _hits.get(name, 0) + 1
        if len(_hit_log) < _LOG_MAX:
            _hit_log.append(
                (len(_hit_log) + 1, name, threading.current_thread().name))
        if action is None:
            return
        count = _hits[name]
    if isinstance(action, str) and "#" in action:
        base, _, nth = action.rpartition("#")
        if nth.isdigit():  # a non-numeric tail is part of the action
            if count != int(nth):
                return
            action = base
    if callable(action):
        action()
        return
    if action == "error":
        raise FailpointError(name)
    if action == "panic":
        os._exit(13)
    if isinstance(action, str):
        if action.startswith("sleep:"):
            # a sleep: action exists to WIDEN race windows, deliberately
            # also under hot locks
            with lockdep.allow_blocking("failpoint sleep action"):
                time.sleep(float(action.split(":", 1)[1]))
            return
        if action.startswith("wait:"):
            ev = _event(action.split(":", 1)[1])
            if not ev.wait(WAIT_TIMEOUT_S):
                raise RuntimeError(
                    f"failpoint {name!r} wait on {action!r} timed out")
            return
        if action.startswith("set:"):
            _event(action.split(":", 1)[1]).set()
            return
        if action.startswith("barrier:"):
            _barrier_wait(name, max(2, int(action.split(":", 1)[1])))
            return
        if action == "off":
            return
    raise ValueError(f"unknown failpoint action {action!r}")
