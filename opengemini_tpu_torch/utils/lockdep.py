"""Runtime lock-order validation (the Linux lockdep analogue), the
port of the reference's utils/lockdep.py.

The lock invariants of the storage engine live in comments:
`_flush_lock -> _lock` (storage/shard.py), "fsync runs off the shard
lock", "no blocking call under a hot lock".  This module enforces them
mechanically, the way Linux lockdep proves lock-class ordering: armed
via ``OGT_LOCKDEP=1``, every ``lockdep.Lock()``/``RLock()``/
``Condition()`` in the tree becomes a tracked wrapper; unset, the names
are plain CLASS ALIASES for ``threading.Lock``/``RLock``/``Condition``
— zero per-acquisition work (tests/test_torch_lockdep.py).

What the armed mode proves, per process:

- **Order-graph cycles.**  Locks are grouped into CLASSES by their
  construction site (every per-shard ``_lock`` is one class), like
  lockdep's lock classes.  Acquiring B while holding A records the edge
  A -> B with one representative acquisition stack per side; a new edge
  that closes a cycle (B already reaches A) is a potential deadlock and
  is reported with BOTH stack pairs — the classic "possible circular
  locking dependency" report — even if the two threads never actually
  collided in this run.  Same-class nesting (two shards' locks) is
  ignored: instance order within a class is the engine's sorted-
  iteration business, not a class-order fact.
- **Blocking under a hot lock.**  ``os.fsync``, ``time.sleep``,
  ``subprocess.Popen`` and socket connect/send/recv are patched (armed
  mode only) to flag execution while the thread holds a HOT lock class
  (``mark_hot``: the shard lock, the engine lock, the rollup manager
  lock).  Audited exceptions wrap the call in
  ``with lockdep.allow_blocking("why"):`` — e.g. the WAL rotate fsync,
  which MUST run under the shard lock because that lock is what fences
  concurrent appends.
- **Hold-time budgets.**  ``OGT_LOCKDEP_HOLD_MS=<ms>`` (0/unset = off)
  records any single hold of a tracked lock longer than the budget into
  ``hold_reports()`` — advisory (a GIL-starved CI box makes wall-clock
  holds noisy), never part of ``check()``.

Violations are recorded process-globally (``violations()``) and printed
to stderr once per unique report; ``check()`` raises ``LockdepError``
with every report attached, so a test suite run armed doubles as a
deadlock regression test.  A ``lockdep`` stats section (violations/
edges/classes) rides /debug/vars via utils/stats.py so a harness can
assert zero findings on live nodes.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

__all__ = [
    "Lock", "RLock", "Condition", "LockdepError", "enabled", "mark_hot",
    "name_class", "held_classes", "allow_blocking", "violations",
    "hold_reports", "check", "reset", "stats_snapshot",
    "RETIRED_EXEMPTIONS",
]

_ARMED = os.environ.get("OGT_LOCKDEP", "") not in ("", "0")
HOLD_BUDGET_MS = float(os.environ.get("OGT_LOCKDEP_HOLD_MS", "0") or 0)


class LockdepError(RuntimeError):
    """Raised by check(): at least one ordering/blocking violation."""


# Exemption reasons that USED to be audited and were then eliminated by
# restructuring the code (the off-lock compaction rework moved every
# compaction merge/fsync off the hot shard lock).  Re-registering one is
# a regression — the invariant is now "compaction never blocks under the
# shard lock", and it is enforced here in BOTH modes (armed and not) so
# the cheap unarmed tree still refuses the exemption at the call site.
RETIRED_EXEMPTIONS = frozenset({
    "compact merge under shard lock",
    "level-compact merge under shard lock",
    "out-of-order compact merge under shard lock",
})


def _check_retired(reason: str) -> None:
    if reason in RETIRED_EXEMPTIONS:
        raise LockdepError(
            f"lockdep exemption {reason!r} is retired: compaction must "
            "merge/fsync OFF the shard lock (snapshot -> off-lock merge "
            "-> revalidated swap), not under an audited exemption")


def enabled() -> bool:
    return _ARMED


if not _ARMED:
    # Pass-through: plain aliases, NOT shims — the unarmed tree pays
    # zero per-acquisition (and zero per-construction) work.  Asserted
    # identity (`lockdep.Lock is threading.Lock`) in tests and bench.
    Lock = threading.Lock
    RLock = threading.RLock
    Condition = threading.Condition

    def mark_hot(lock, name: str):
        return lock

    def name_class(lock, name: str):
        return lock

    def held_classes() -> list:
        return []

    class _NullCtx:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _NULL_CTX = _NullCtx()

    def allow_blocking(reason: str = ""):
        _check_retired(reason)
        return _NULL_CTX

    def violations() -> list:
        return []

    def hold_reports() -> list:
        return []

    def check() -> None:
        return None

    def reset() -> None:
        return None

    def stats_snapshot() -> dict:
        return {}

else:
    _THIS_FILE = os.path.abspath(__file__)

    # -- process-global order graph (all guarded by _STATE_LOCK) ------
    _STATE_LOCK = threading.Lock()
    _CLASSES: dict[tuple, "_LockClass"] = {}   # site -> class
    _SUCC: dict[object, set] = {}              # class -> set(class)
    _EDGES: dict[tuple, tuple] = {}            # (a, b) -> (stack_a, stack_b)
    _VIOLATIONS: list[str] = []
    _HOLDS: list[str] = []
    _SEEN: set = set()                         # dedupe keys for reports
    _STACK_MEMO: dict[tuple, str] = {}         # (class, site) -> stack text

    _TLS = threading.local()

    class _LockClass:
        """One lock CLASS: every lock constructed at one code site."""

        __slots__ = ("site", "name", "hot")

        def __init__(self, site: tuple):
            self.site = site          # (filename, lineno)
            self.name = f"{_short(site[0])}:{site[1]}"
            self.hot = False

        def __repr__(self):
            return self.name

    def _short(path: str) -> str:
        for mark in ("opengemini_tpu_torch", "tools", "tests"):
            i = path.find(os.sep + mark + os.sep)
            if i >= 0:
                return path[i + 1:]
        return os.path.basename(path)

    def _held():
        h = getattr(_TLS, "held", None)
        if h is None:
            h = _TLS.held = []
        return h

    def _caller_site() -> tuple:
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename == _THIS_FILE:
            f = f.f_back
        if f is None:  # pragma: no cover - interpreter teardown
            return ("<unknown>", 0)
        return (f.f_code.co_filename, f.f_lineno)

    def _site_stack(cls: "_LockClass", site: tuple) -> str:
        """One REPRESENTATIVE formatted stack per (class, acquire-site).
        Captured on the first acquisition through that site and memoized
        — steady-state acquire cost is a dict hit, not a stack walk."""
        key = (cls, site)
        st = _STACK_MEMO.get(key)
        if st is None:
            frames = [f for f in traceback.extract_stack()
                      if f.filename != _THIS_FILE]
            st = "".join(traceback.format_list(frames[-12:]))
            with _STATE_LOCK:
                st = _STACK_MEMO.setdefault(key, st)
        return st

    def _report(kind: str, key: tuple, text: str) -> None:
        with _STATE_LOCK:
            if key in _SEEN:
                return
            _SEEN.add(key)
            _VIOLATIONS.append(text)
        sys.stderr.write(text + "\n")

    def _reaches(src, dst) -> bool:
        """True when dst is reachable from src in the edge graph.
        Caller holds _STATE_LOCK."""
        seen = {src}
        stack = [src]
        while stack:
            node = stack.pop()
            if node is dst:
                return True
            for nxt in _SUCC.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    def _cycle_path(src, dst) -> list:
        """One src ~> dst edge path (caller holds _STATE_LOCK)."""
        prev = {src: None}
        queue = [src]
        while queue:
            node = queue.pop(0)
            if node is dst:
                path = [node]
                while prev[node] is not None:
                    node = prev[node]
                    path.append(node)
                return list(reversed(path))
            for nxt in _SUCC.get(node, ()):
                if nxt not in prev:
                    prev[nxt] = node
                    queue.append(nxt)
        return [src, dst]

    def _add_edge(a_hold, b_cls, b_stack: str) -> None:
        a_cls = a_hold.cls
        pair = (a_cls, b_cls)
        if pair in _EDGES:  # fast path: dependency already proven
            return
        with _STATE_LOCK:
            if pair in _EDGES:
                return
            cycle = _reaches(b_cls, a_cls)
            path = _cycle_path(b_cls, a_cls) if cycle else None
            _EDGES[pair] = (a_hold.stack, b_stack)
            _SUCC.setdefault(a_cls, set()).add(b_cls)
        if not cycle:
            return
        # the lockdep report: the edge that closed the cycle, plus the
        # previously witnessed reverse chain — both stack pairs
        lines = [
            "LOCKDEP: possible circular locking dependency",
            f"  new dependency: {a_cls} -> {b_cls}",
            f"  while holding {a_cls}, acquired at:",
            _indent(a_hold.stack),
            f"  acquiring {b_cls} at:",
            _indent(b_stack),
            f"  but the inverse chain {' -> '.join(map(str, path))} "
            "was already witnessed:",
        ]
        for i in range(len(path) - 1):
            e = _EDGES.get((path[i], path[i + 1]))
            if not e:
                continue
            lines.append(f"  edge {path[i]} -> {path[i + 1]}: "
                         f"{path[i]} held at:")
            lines.append(_indent(e[0]))
            lines.append(f"  {path[i + 1]} acquired at:")
            lines.append(_indent(e[1]))
        _report("cycle", ("cycle",) + tuple(sorted((a_cls.name, b_cls.name))),
                "\n".join(lines))

    def _indent(text: str) -> str:
        return "\n".join("    " + ln for ln in text.rstrip().splitlines())

    class _Hold:
        __slots__ = ("lock", "cls", "stack", "site", "t0", "depth")

        def __init__(self, lock, cls, stack, site):
            self.lock = lock
            self.cls = cls
            self.stack = stack
            self.site = site
            self.t0 = time.perf_counter()
            self.depth = 1

    class _TrackedBase:
        """Shared acquire/release bookkeeping for Lock/RLock wrappers."""

        __slots__ = ("_inner", "_cls")

        def __init__(self):
            site = _caller_site()
            with _STATE_LOCK:
                cls = _CLASSES.get(site)
                if cls is None:
                    cls = _CLASSES[site] = _LockClass(site)
            self._cls = cls

        def _note_acquire(self) -> None:
            held = _held()
            for h in held:
                if h.lock is self:   # reentrant re-acquire: depth only
                    h.depth += 1
                    return
            site = _caller_site()
            stack = _site_stack(self._cls, site)
            for h in held:
                if h.cls is not self._cls:
                    _add_edge(h, self._cls, stack)
            held.append(_Hold(self, self._cls, stack, site))

        def _note_release(self) -> int:
            """Returns remaining depth (0 = fully released)."""
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                h = held[i]
                if h.lock is self:
                    if h.depth > 1:
                        h.depth -= 1
                        return h.depth
                    del held[i]
                    if HOLD_BUDGET_MS > 0:
                        ms = (time.perf_counter() - h.t0) * 1e3
                        if ms >= HOLD_BUDGET_MS:
                            _note_hold(h, ms)
                    return 0
            return 0  # release of a lock acquired pre-tracking: ignore

        def _untrack_for_wait(self) -> int:
            """Condition-wait release: drop the hold entirely, return
            its depth so _retrack_after_wait can restore it."""
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is self:
                    depth = held[i].depth
                    del held[i]
                    return depth
            return 1

        def _retrack_after_wait(self, depth: int) -> None:
            # reacquire after wait: the original acquire already
            # recorded this class's edges; no new dependency fact
            h = _Hold(self, self._cls, _site_stack(self._cls, self._cls.site),
                      self._cls.site)
            h.depth = depth
            _held().append(h)

        def locked(self):
            return self._inner.locked()

        def __repr__(self):
            return f"<lockdep {type(self).__name__} {self._cls.name}>"

    def _note_hold(h: "_Hold", ms: float) -> None:
        key = ("hold", h.cls, h.site)
        with _STATE_LOCK:
            if key in _SEEN:
                return
            _SEEN.add(key)
            _HOLDS.append(
                f"LOCKDEP: {h.cls} held {ms:.1f}ms "
                f"(budget {HOLD_BUDGET_MS:.0f}ms), acquired at:\n"
                + _indent(h.stack))

    class Lock(_TrackedBase):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            self._inner = threading.Lock()

        def acquire(self, blocking: bool = True, timeout: float = -1):
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._note_acquire()
            return ok

        def release(self):
            self._note_release()
            self._inner.release()

        def __enter__(self):
            return self.acquire()

        def __exit__(self, *exc):
            self.release()
            return False

        # threading.Condition protocol (wait releases the lock: the
        # tracker must see it leave and re-enter the held set)
        def _release_save(self):
            self._untrack_for_wait()
            self._inner.release()
            return 1

        def _acquire_restore(self, depth):
            self._inner.acquire()
            self._retrack_after_wait(depth or 1)

        def _is_owned(self):
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True

    class RLock(_TrackedBase):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            self._inner = threading.RLock()

        def acquire(self, blocking: bool = True, timeout: float = -1):
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._note_acquire()
            return ok

        def release(self):
            self._note_release()
            self._inner.release()

        def __enter__(self):
            return self.acquire()

        def __exit__(self, *exc):
            self.release()
            return False

        def _release_save(self):
            depth = self._untrack_for_wait()
            return (self._inner._release_save(), depth)

        def _acquire_restore(self, state):
            inner_state, depth = state
            self._inner._acquire_restore(inner_state)
            self._retrack_after_wait(depth)

        def _is_owned(self):
            return self._inner._is_owned()

        def locked(self):  # RLock has no locked() before 3.12
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True

    class Condition(threading.Condition):
        """threading.Condition over a tracked lock: wait() routes
        through the wrapper's _release_save/_acquire_restore, so the
        held-set stays truthful across the release/reacquire."""

        def __init__(self, lock=None):
            if lock is None:
                lock = RLock()
            super().__init__(lock)

    def mark_hot(lock, name: str):
        """Name a lock's CLASS and mark it hot: blocking calls (fsync/
        sleep/socket/subprocess) while holding it are violations unless
        inside allow_blocking().  Returns the lock (assignment chains)."""
        cls = getattr(lock, "_cls", None)
        if cls is not None:
            cls.name = name
            cls.hot = True
        return lock

    def name_class(lock, name: str):
        """Friendly class name in reports, without the hot marking."""
        cls = getattr(lock, "_cls", None)
        if cls is not None:
            cls.name = name
        return lock

    def held_classes() -> list[str]:
        """Class names the CURRENT thread holds right now (tests)."""
        return [h.cls.name for h in getattr(_TLS, "held", ())]

    class _AllowCtx:
        __slots__ = ("reason",)

        def __init__(self, reason: str):
            self.reason = reason

        def __enter__(self):
            _TLS.allow = getattr(_TLS, "allow", 0) + 1
            return self

        def __exit__(self, *exc):
            _TLS.allow -= 1
            return False

    def allow_blocking(reason: str = ""):
        """Annotate an AUDITED blocking call under a hot lock (e.g. the
        WAL rotate fsync, fenced by the shard lock by design)."""
        _check_retired(reason)
        return _AllowCtx(reason)

    def _check_blocking(kind: str) -> None:
        held = getattr(_TLS, "held", None)
        if not held or getattr(_TLS, "allow", 0):
            return
        for h in held:
            if h.cls.hot:
                site = _caller_site()
                frames = [f for f in traceback.extract_stack()
                          if f.filename != _THIS_FILE]
                here = "".join(traceback.format_list(frames[-12:]))
                _report(
                    "blocking", ("blocking", kind, h.cls, site),
                    f"LOCKDEP: blocking call {kind} while holding hot "
                    f"lock {h.cls}\n  {h.cls} acquired at:\n"
                    + _indent(h.stack)
                    + f"\n  {kind} called at:\n" + _indent(here))
                return

    # -- blocking-call tripwires (armed process only) -----------------
    _orig_fsync = os.fsync
    _orig_sleep = time.sleep

    def _fsync(fd):
        _check_blocking("os.fsync")
        return _orig_fsync(fd)

    def _sleep(secs):
        _check_blocking("time.sleep")
        return _orig_sleep(secs)

    os.fsync = _fsync
    time.sleep = _sleep

    import socket as _socket_mod
    import subprocess as _subprocess_mod

    _orig_popen_init = _subprocess_mod.Popen.__init__

    def _popen_init(self, *a, **kw):
        _check_blocking("subprocess.Popen")
        return _orig_popen_init(self, *a, **kw)

    _subprocess_mod.Popen.__init__ = _popen_init

    def _patch_sock(name: str):
        orig = getattr(_socket_mod.socket, name, None)
        if orig is None:  # pragma: no cover - platform variance
            return

        def wrapper(self, *a, __orig=orig, __kind="socket." + name, **kw):
            _check_blocking(__kind)
            return __orig(self, *a, **kw)

        wrapper.__name__ = name
        setattr(_socket_mod.socket, name, wrapper)

    for _n in ("connect", "sendall", "recv", "recv_into", "accept"):
        _patch_sock(_n)
    del _n

    # -- reporting API ------------------------------------------------
    def violations() -> list[str]:
        with _STATE_LOCK:
            return list(_VIOLATIONS)

    def hold_reports() -> list[str]:
        with _STATE_LOCK:
            return list(_HOLDS)

    def check() -> None:
        """Raise LockdepError when any cycle/blocking violation was
        recorded (hold-budget reports are advisory, not failures)."""
        v = violations()
        if v:
            raise LockdepError(
                f"{len(v)} lockdep violation(s):\n\n" + "\n\n".join(v))

    def reset() -> None:
        """Forget the graph and every report (tests only)."""
        with _STATE_LOCK:
            _CLASSES.clear()
            _SUCC.clear()
            _EDGES.clear()
            _VIOLATIONS.clear()
            _HOLDS.clear()
            _SEEN.clear()
            _STACK_MEMO.clear()

    def stats_snapshot() -> dict:
        """`lockdep` gauge section for /debug/vars: the cluster torture
        harness asserts violations == 0 on every live node."""
        with _STATE_LOCK:
            return {
                "violations": len(_VIOLATIONS),
                "hold_reports": len(_HOLDS),
                "edges": len(_EDGES),
                "classes": len(_CLASSES),
            }
