"""Process-wide resource governor: the unified memory ledger, query
admission control, write-path backpressure and background throttling.

The port of ``opengemini_tpu/utils/governor.py``, whole, with plain
``threading`` locks and conditions (the reference's lock-order checker
is ROADMAP A9's). Every piece is pass-through while
``OGT_MEM_BUDGET_MB`` is unset (or ``budget_mb=0`` through
/debug/ctrl?mod=governor): each hook checks ``enabled()`` first and
does nothing, so every answer is bit-identical to an ungoverned engine.

  Unified memory ledger
      Byte providers registered under one ceiling: the engines'
      memtable and WAL backlog (storage/engine.py), the decoded-column
      cache's host and device tiers (storage/colcache.py), the scan and
      encode pools' in-flight bytes, plus per-query scan reservations
      estimated from chunk metadata before the scan dispatches
      (query/executor.py, qhelpers ``estimate_scan_bytes``).

  Query admission control
      Interactive queries before background work (CQs), concurrency
      slots (``OGT_MAX_CONCURRENT_QUERIES``) and a bounded FIFO wait
      queue with a deadline (``OGT_ADMIT_QUEUE``,
      ``OGT_ADMIT_TIMEOUT_MS``). A full queue or an expired deadline
      sheds with ``AdmissionRejected``, which /query, the PromQL routes
      and remote read answer with 503 and ``Retry-After``. A reservation
      that would overdraw the ledger past ``OGT_OVERDRAFT_PCT`` kills the
      query through the query tracker (a statement error).

  Write-path backpressure
      Over the high watermark (``OGT_WRITE_HIWAT_PCT`` of the budget)
      /write answers 429 with ``Retry-After`` until the backlog drains
      below ``OGT_WRITE_LOWAT_PCT`` (failpoints
      ``governor-backpressure-on`` / ``-off``).

  Background throttling
      Governed services (compaction, downsample, rollup, CQs, streams)
      take a low-priority token per tick and pause while interactive
      occupancy is high (``OGT_BG_PAUSE_PCT`` of the slots) or an IO
      alarm is recent (services/iodetector.py ``note_io_alarm``).

Failpoints at every decision edge: governor-admit, governor-queue,
governor-shed, governor-overdraft-kill, governor-backpressure-on,
governor-backpressure-off. Gauges and counters ride /debug/vars (the
``governor`` stats provider), an admission section rides
/debug/queries (the query tracker's provider), and the admission wait
lands in the ``admission_wait`` query stage. The shed-burst diagnostic
hook has no subscriber until the sherlock service is ported (ROADMAP
A7.2).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

from opengemini_tpu_torch.utils.failpoint import inject as _fp

_INTERACTIVE = "interactive"
_BACKGROUND = "background"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class AdmissionRejected(Exception):
    """A query was shed by admission control (HTTP 503 + Retry-After)."""

    def __init__(self, reason: str, retry_after_s: int):
        super().__init__(f"query shed: {reason}")
        self.reason = reason
        self.retry_after_s = retry_after_s


class _NoopToken:
    """Admission token of the disabled (pass-through) governor."""

    __slots__ = ()
    waited_ns = 0
    kind = _INTERACTIVE

    def release(self) -> None:
        pass


_NOOP_TOKEN = _NoopToken()


class _AdmitToken:
    __slots__ = ("_gov", "kind", "waited_ns", "_released", "_nested")

    def __init__(self, gov: "ResourceGovernor", kind: str, waited_ns: int,
                 nested: bool = False):
        self._gov = gov
        self.kind = kind
        self.waited_ns = waited_ns
        self._released = False
        self._nested = nested

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._gov._release_token(self)


class _BgToken:
    """Low-priority background token: marks the holding thread's query
    class as background (queries it runs classify accordingly) and rides
    the bg occupancy gauge."""

    __slots__ = ("_gov", "name", "_prev_kind", "_released")

    def __init__(self, gov: "ResourceGovernor", name: str):
        self._gov = gov
        self.name = name
        self._prev_kind = getattr(gov._local, "kind", None)
        gov._local.kind = _BACKGROUND
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._gov._local.kind = self._prev_kind
        with self._gov._cond:
            self._gov._bg_tokens = max(0, self._gov._bg_tokens - 1)


class ResourceGovernor:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._local = threading.local()
        # -- config (runtime-tunable via configure()) --
        self._budget = _env_int("OGT_MEM_BUDGET_MB", 0) << 20
        self._max_concurrent = max(1, _env_int("OGT_MAX_CONCURRENT_QUERIES", 16))
        self._queue_max = max(0, _env_int("OGT_ADMIT_QUEUE", 64))
        self._timeout_s = max(0.0, _env_int("OGT_ADMIT_TIMEOUT_MS", 3000) / 1000.0)
        self._hiwat_pct = max(1, _env_int("OGT_WRITE_HIWAT_PCT", 85))
        self._lowat_pct = max(0, _env_int("OGT_WRITE_LOWAT_PCT", 60))
        self._normalize_watermarks()
        self._overdraft_pct = _env_int("OGT_OVERDRAFT_PCT", 150)
        self._bg_pause_pct = _env_int("OGT_BG_PAUSE_PCT", 50)
        # anti-starvation bound on a background pause: sustained
        # interactive saturation must not stall compaction/downsample
        # forever (file counts and read amplification grow exactly when
        # the system is busiest) — after this many seconds a paused tick
        # is granted anyway.  0 = pause indefinitely.
        self._bg_max_pause_s = float(max(0, _env_int("OGT_BG_MAX_PAUSE_S", 30)))
        self._retry_after_s = max(1, _env_int("OGT_RETRY_AFTER_S", 1))
        # -- ledger --
        self._components: dict[str, list] = {}
        self._reserved = 0
        self._res_by_qid: dict[int, int] = {}
        # -- admission --
        self._active = {_INTERACTIVE: 0, _BACKGROUND: 0}
        # FIFO entries [event, kind, enqueued_monotonic]; interactive
        # waiters are granted before background ones, FIFO within a class
        self._waiting: deque = deque()
        self._bg_tokens = 0
        # -- backpressure hysteresis --
        self._bp_active = False
        # backlog sweep TTL: every governed write otherwise walks each
        # shard's memtable parts under the engine lock (O(shards) per
        # request on the hot ingest path).  0 = sweep every request.
        self._bp_cache_s = max(0, _env_int("OGT_WRITE_BP_CACHE_MS", 50)) / 1000.0
        self._bp_backlog_cached = 0
        self._bp_backlog_at = float("-inf")
        self._io_alarm_until = 0.0
        self._io_pause_s = max(0, _env_int("OGT_BG_IO_PAUSE_S", 30))
        # -- counters (ints; exported at /debug/vars) --
        self._counters = {
            "admitted": 0, "queued": 0, "sheds_queue_full": 0,
            "sheds_timeout": 0, "sheds_backpressure": 0, "kills": 0,
            "bp_on": 0, "bp_off": 0, "bg_pauses": 0, "bg_forced": 0,
            "io_alarms": 0,
        }
        # -- per-tenant (database) accounting: background maintenance
        # work charged to its owner (rollup folds, sheds) — surfaced in
        # gauges()/describe() so a hostile tenant's churn is attributable
        self._tenants: dict[str, dict[str, int]] = {}
        # -- shed/kill burst -> diagnostic hook (sherlock) --
        self._hook = None
        self._shed_times: deque = deque()
        self._burst_n = max(1, _env_int("OGT_SHED_BURST", 25))
        self._burst_window_s = 10.0
        self._hook_cooldown_s = max(0, _env_int("OGT_SHED_BURST_COOLDOWN_S", 120))
        self._last_hook = float("-inf")

    # -- config --------------------------------------------------------------

    def enabled(self) -> bool:
        return self._budget > 0

    def configure(self, budget_mb: int | None = None,
                  max_concurrent: int | None = None,
                  queue: int | None = None,
                  timeout_ms: int | None = None,
                  hiwat_pct: int | None = None,
                  lowat_pct: int | None = None,
                  overdraft_pct: int | None = None,
                  bg_pause_pct: int | None = None,
                  bg_max_pause_s: float | None = None,
                  bp_cache_ms: int | None = None) -> None:
        """Runtime tuning (POST /debug/ctrl?mod=governor). Each knob
        changes only when passed; growing the slot count grants waiters
        immediately; setting budget_mb=0 disables (pass-through)."""
        with self._cond:
            if budget_mb is not None:
                self._budget = max(0, int(budget_mb)) << 20
            if max_concurrent is not None:
                self._max_concurrent = max(1, int(max_concurrent))
            if queue is not None:
                self._queue_max = max(0, int(queue))
            if timeout_ms is not None:
                self._timeout_s = max(0.0, int(timeout_ms) / 1000.0)
            if hiwat_pct is not None:
                self._hiwat_pct = max(1, int(hiwat_pct))
            if lowat_pct is not None:
                self._lowat_pct = max(0, int(lowat_pct))
            self._normalize_watermarks()
            if overdraft_pct is not None:
                self._overdraft_pct = max(100, int(overdraft_pct))
            if bg_pause_pct is not None:
                self._bg_pause_pct = max(1, int(bg_pause_pct))
            if bg_max_pause_s is not None:
                self._bg_max_pause_s = max(0.0, float(bg_max_pause_s))
            if bp_cache_ms is not None:
                self._bp_cache_s = max(0, int(bp_cache_ms)) / 1000.0
                self._bp_backlog_at = float("-inf")  # take effect now
            self._grant_waiters_locked()
            self._cond.notify_all()

    def _normalize_watermarks(self) -> None:
        """The hysteresis band requires lowat STRICTLY below hiwat — an
        inverted band would flip backpressure on/off per request, which
        is exactly the oscillation the band exists to prevent.  Clamp
        rather than reject: /debug/ctrl sets knobs one at a time and a
        transient inversion mid-tuning must not error out."""
        if self._lowat_pct >= self._hiwat_pct:
            self._lowat_pct = self._hiwat_pct - 1

    def config(self) -> dict:
        return {
            "budget_mb": self._budget >> 20,
            "max_concurrent": self._max_concurrent,
            "queue": self._queue_max,
            "timeout_ms": int(self._timeout_s * 1000),
            "hiwat_pct": self._hiwat_pct,
            "lowat_pct": self._lowat_pct,
            "overdraft_pct": self._overdraft_pct,
            "bg_pause_pct": self._bg_pause_pct,
            "bg_max_pause_s": self._bg_max_pause_s,
            "bp_cache_ms": int(self._bp_cache_s * 1000),
        }

    def reset(self) -> None:
        """Zero counters and transient state (tests / operator reset).
        Only safe while no queries are in flight — held tokens released
        after a reset guard against going negative but their slot
        accounting is forfeited."""
        with self._cond:
            for k in self._counters:
                self._counters[k] = 0
            self._active = {_INTERACTIVE: 0, _BACKGROUND: 0}
            for entry in self._waiting:
                entry[0].set()  # never strand a parked waiter
            self._waiting.clear()
            self._reserved = 0
            self._res_by_qid.clear()
            self._bp_active = False
            self._bp_backlog_at = float("-inf")
            self._io_alarm_until = 0.0
            self._bg_tokens = 0
            self._tenants.clear()
            self._shed_times.clear()
            self._last_hook = float("-inf")
            self._cond.notify_all()

    # -- unified memory ledger ----------------------------------------------

    def register_component(self, name: str, fn) -> None:
        """Attach a live byte provider (fn() -> int). Multiple providers
        of one name sum (several engines report one memtable total)."""
        with self._lock:
            self._components.setdefault(name, []).append(fn)

    def unregister_component(self, name: str, fn) -> None:
        with self._lock:
            fns = self._components.get(name)
            if fns and fn in fns:
                fns.remove(fn)
            if fns is not None and not fns:
                del self._components[name]

    def _component_bytes(self, name: str) -> int:
        with self._lock:
            fns = list(self._components.get(name, ()))
        total = 0
        for fn in fns:  # outside the lock: providers lock their own state
            try:
                total += int(fn())
            except Exception:  # noqa: BLE001 — a dying provider (closed
                continue       # engine) must not break governance
        return total

    def ledger(self) -> dict:
        """Per-component live bytes + reservations (ints)."""
        with self._lock:
            names = list(self._components)
            reserved = self._reserved
        out = {name: self._component_bytes(name) for name in names}
        out["reserved"] = reserved
        return out

    def ledger_total(self) -> int:
        led = self.ledger()
        return sum(led.values())

    @contextlib.contextmanager
    def scan_reservation(self, qid: int | None, est_bytes: int):
        """Reserve a query's estimated working set (from chunk metadata)
        for the duration of its scan.  A reservation that would overdraw
        the ledger past the kill threshold cancels the query through the
        QueryTracker — the next cancellation point raises QueryKilled,
        which surfaces as a clean query error.

        The reservation stays charged at its full estimate while the scan
        runs, so bytes the query has already materialized are counted
        TWICE (once here, once by the scanpool/colcache gauges).  This is
        deliberate: the estimate cannot be decayed safely without knowing
        which gauge bytes belong to which query, and over-counting sheds
        a query early instead of OOMing late — size OGT_OVERDRAFT_PCT
        with that headroom in mind."""
        if self._budget <= 0 or est_bytes <= 0:
            yield
            return
        est_bytes = int(est_bytes)
        kill_at = self._budget * self._overdraft_pct // 100
        # charge FIRST, then check: each concurrent reservation sees the
        # others' charge in the ledger, so N queries reserving at once
        # cannot jointly blow past the kill threshold through a
        # read-then-charge race (the cost is killing one query too many
        # under a genuine race — shed early beats OOM late)
        with self._lock:
            self._reserved += est_bytes
            if qid is not None:
                self._res_by_qid[qid] = self._res_by_qid.get(qid, 0) + est_bytes
        if qid is not None and self.ledger_total() > kill_at:
            from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER

            self._release_reservation(qid, est_bytes)
            with self._lock:
                self._counters["kills"] += 1
            self._note_shed("overdraft kill")
            _fp("governor-overdraft-kill")
            _TRACKER.kill(qid)
            _TRACKER.raise_if_killed(qid)
        try:
            yield
        finally:
            self._release_reservation(qid, est_bytes)

    def _release_reservation(self, qid: int | None, est_bytes: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - est_bytes)
            if qid is not None:
                left = self._res_by_qid.get(qid, 0) - est_bytes
                if left > 0:
                    self._res_by_qid[qid] = left
                else:
                    self._res_by_qid.pop(qid, None)

    # -- admission control ---------------------------------------------------

    def current_kind(self) -> str:
        return getattr(self._local, "kind", None) or _INTERACTIVE

    def admit(self, kind: str | None = None):
        """Admit one query; returns a token to release() when the query
        finishes.  Raises AdmissionRejected (queue full / deadline) —
        the HTTP layer maps it to 503 + Retry-After.  Reentrant: a query
        executed from within an admitted query (logstore, CQ re-entry)
        rides the outer slot."""
        if self._budget <= 0:
            return _NOOP_TOKEN
        depth = getattr(self._local, "admit_depth", 0)
        if depth > 0:
            self._local.admit_depth = depth + 1
            return _AdmitToken(self, self.current_kind(), 0, nested=True)
        if kind is None:
            kind = self.current_kind()
        _fp("governor-admit")
        entry = None
        t0 = time.monotonic()
        with self._cond:
            if self._can_admit_locked(kind):
                self._active[kind] += 1
                self._counters["admitted"] += 1
                self._local.admit_depth = 1
                return _AdmitToken(self, kind, 0)
            if len(self._waiting) >= self._queue_max:
                self._counters["sheds_queue_full"] += 1
            else:
                entry = [threading.Event(), kind, t0]
                self._waiting.append(entry)
                self._counters["queued"] += 1
        if entry is None:
            self._note_shed("admission queue full")
            _fp("governor-shed")
            raise AdmissionRejected("admission queue full",
                                    self._retry_after())
        _fp("governor-queue")
        granted = entry[0].wait(self._timeout_s)
        if not granted:
            with self._cond:
                # re-check under the lock: a grant can race the timeout
                if entry[0].is_set():
                    granted = True
                else:
                    try:
                        self._waiting.remove(entry)
                    except ValueError:
                        pass
                    self._counters["sheds_timeout"] += 1
        waited_ns = int((time.monotonic() - t0) * 1e9)
        if not granted:
            self._note_shed("admission wait deadline")
            _fp("governor-shed")
            raise AdmissionRejected(
                f"admission wait exceeded {int(self._timeout_s * 1000)}ms",
                self._retry_after())
        self._local.admit_depth = 1
        return _AdmitToken(self, kind, waited_ns)

    @contextlib.contextmanager
    def admitted(self, kind: str | None = None):
        """Context-manager form of admit()/release() for call sites that
        wrap a single scan (the PromQL read surface)."""
        token = self.admit(kind)
        try:
            yield token
        finally:
            token.release()

    def _can_admit_locked(self, kind: str) -> bool:
        free = (self._active[_INTERACTIVE] + self._active[_BACKGROUND]
                < self._max_concurrent)
        if not free:
            return False
        if kind == _INTERACTIVE:
            # strict FIFO among interactive waiters; background waiters
            # never block an interactive grant (priority)
            return not any(e[1] == _INTERACTIVE for e in self._waiting)
        return not self._waiting

    def _grant_waiters_locked(self) -> None:
        while self._waiting and (
            self._active[_INTERACTIVE] + self._active[_BACKGROUND]
            < self._max_concurrent
        ):
            entry = next((e for e in self._waiting if e[1] == _INTERACTIVE),
                         self._waiting[0])
            self._waiting.remove(entry)
            self._active[entry[1]] += 1
            self._counters["admitted"] += 1
            entry[0].set()

    def _release_token(self, token: "_AdmitToken") -> None:
        depth = getattr(self._local, "admit_depth", 0)
        if depth > 1 or token._nested:
            self._local.admit_depth = max(0, depth - 1)
            return
        self._local.admit_depth = 0
        with self._cond:
            self._active[token.kind] = max(0, self._active[token.kind] - 1)
            self._grant_waiters_locked()
            self._cond.notify_all()

    def _retry_after(self) -> int:
        return max(self._retry_after_s, int(self._timeout_s))

    # -- write-path backpressure ---------------------------------------------

    def _backlog_bytes_cached(self) -> int:
        """Memtable+WAL backlog for the watermark check, swept at most
        once per OGT_WRITE_BP_CACHE_MS (bp_cache_ms=0 disables caching —
        tests pin it so a provider change is visible on the very next
        write).  A ≤TTL-stale reading only delays a watermark flip by
        that much; the hysteresis band already tolerates far more."""
        ttl = self._bp_cache_s
        if ttl <= 0:
            return self._component_bytes("memtable")
        now = time.monotonic()
        with self._lock:
            if now - self._bp_backlog_at < ttl:
                return self._bp_backlog_cached
        backlog = self._component_bytes("memtable")
        with self._lock:
            self._bp_backlog_cached = backlog
            self._bp_backlog_at = now
        return backlog

    def write_backpressure(self) -> int | None:
        """Retry-After seconds when the memtable+WAL backlog is over the
        high watermark (429 the write instead of growing RSS), None to
        admit the write.  Hysteresis: once active, sheds until the
        backlog drains below the LOW watermark."""
        if self._budget <= 0:
            return None
        backlog = self._backlog_bytes_cached()
        hi = self._budget * self._hiwat_pct // 100
        lo = self._budget * self._lowat_pct // 100
        flipped_on = flipped_off = False
        with self._lock:
            if self._bp_active:
                if backlog <= lo:
                    self._bp_active = False
                    self._counters["bp_off"] += 1
                    flipped_off = True
            elif backlog >= hi:
                self._bp_active = True
                self._counters["bp_on"] += 1
                flipped_on = True
            active = self._bp_active
            if active:
                self._counters["sheds_backpressure"] += 1
        if flipped_on:
            _fp("governor-backpressure-on")
        if flipped_off:
            _fp("governor-backpressure-off")
        if active:
            self._note_shed("write backpressure")
            _fp("governor-shed")
            return self._retry_after_s
        return None

    # -- background throttling -----------------------------------------------

    def note_io_alarm(self) -> None:
        """iodetector hook: a hung-disk alarm pauses background work for
        OGT_BG_IO_PAUSE_S so interactive traffic and flushes get the
        recovering volume first."""
        with self._cond:
            self._counters["io_alarms"] += 1
            self._io_alarm_until = time.monotonic() + self._io_pause_s
            # no notify: the pause only ever delays background waiters

    def background_allowed(self) -> bool:
        if self._budget <= 0:
            return True
        with self._lock:  # Condition wraps this same lock
            return self._background_allowed_locked()

    def acquire_background(self, name: str, stop=None,
                           timeout_s: float | None = None):
        """Low-priority token for one background tick (compaction,
        downsample, stream).  Blocks while interactive occupancy is high
        or an IO alarm is recent; returns None when `stop` (an Event)
        was set — or `timeout_s` expired — before clearance.  The token
        marks the thread's query class as background (queries the
        service runs classify accordingly) until release().

        Anti-starvation: a pause is bounded by OGT_BG_MAX_PAUSE_S
        (config bg_max_pause_s; 0 = unbounded) — after that the token is
        granted regardless, so sustained interactive saturation can only
        throttle maintenance to a trickle, never stall it outright."""
        if self._budget <= 0:
            return _NoopBgToken()
        now = time.monotonic()
        deadline = now + timeout_s if timeout_s is not None else None
        force_at = (now + self._bg_max_pause_s
                    if self._bg_max_pause_s > 0 else None)
        paused = False
        with self._cond:
            while not self._background_allowed_locked():
                if not paused:
                    paused = True
                    self._counters["bg_pauses"] += 1
                if stop is not None and stop.is_set():
                    return None
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                if force_at is not None and time.monotonic() >= force_at:
                    self._counters["bg_forced"] += 1
                    break
                # bounded wait: io-alarm expiry is time-based, not
                # notified, so the gate re-polls
                self._cond.wait(0.05)
            self._bg_tokens += 1
        return _BgToken(self, name)

    def _background_allowed_locked(self) -> bool:
        if time.monotonic() < self._io_alarm_until:
            return False
        busy = self._active[_INTERACTIVE] + sum(
            1 for e in self._waiting if e[1] == _INTERACTIVE)
        pause_at = max(1, (self._max_concurrent * self._bg_pause_pct + 99) // 100)
        return busy < pause_at

    # -- per-tenant accounting -------------------------------------------------

    def charge_tenant(self, tenant: str, key: str, delta: int = 1) -> None:
        """Attribute background maintenance work (or a shed) to the
        owning tenant (database).  Always counted — cheap — but only
        SURFACED in gauges() while the governor is enabled, so the
        disabled governor keeps /debug/vars byte-identical."""
        if delta == 0:
            return
        with self._lock:
            acct = self._tenants.setdefault(tenant, {})
            acct[key] = acct.get(key, 0) + int(delta)

    def tenant_accounts(self) -> dict:
        with self._lock:
            return {t: dict(a) for t, a in self._tenants.items()}

    # -- shed/kill burst -> diagnostics ---------------------------------------

    def set_diagnostic_hook(self, fn) -> None:
        """fn(reason: str) — called (rate-limited, off-thread) when a
        shed/kill burst is detected.  services/sherlock.py registers its
        dump here; None detaches."""
        self._hook = fn

    def detach_diagnostic_hook(self, fn) -> None:
        if self._hook == fn:
            self._hook = None

    def trigger_diagnostic(self, reason: str) -> None:
        """Fire the diagnostic hook directly, off-thread (sherlock's own
        cooldown still rate-limits the dump).  Non-governor emergencies
        use this — the storage tier's first corruption/quarantine event
        wants thread stacks + the ledger on disk while the evidence is
        fresh."""
        hook = self._hook
        if hook is None:
            return

        def fire():
            try:
                hook(reason)
            except Exception:  # noqa: BLE001 — diagnostics never take
                pass           # down the detecting path
        threading.Thread(target=fire, daemon=True,
                         name="storage-diag").start()

    def _note_shed(self, reason: str) -> None:
        hook = None
        now = time.monotonic()
        with self._lock:
            self._shed_times.append(now)
            while self._shed_times and \
                    self._shed_times[0] < now - self._burst_window_s:
                self._shed_times.popleft()
            if (len(self._shed_times) >= self._burst_n
                    and now - self._last_hook >= self._hook_cooldown_s
                    and self._hook is not None):
                self._last_hook = now
                hook = self._hook
        if hook is not None:
            def fire():
                try:
                    hook(f"governor shed/kill burst ({reason})")
                except Exception:  # noqa: BLE001 — diagnostics never
                    pass           # take down the serving path
            threading.Thread(target=fire, daemon=True,
                             name="governor-diag").start()

    # -- observability --------------------------------------------------------

    def gauges(self) -> dict:
        """Stats-provider section for /debug/vars (ints only; empty when
        disabled so pass-through keeps /debug/vars byte-identical)."""
        if self._budget <= 0:
            return {}
        led = self.ledger()
        with self._lock:
            out = {
                "budget_bytes": self._budget,
                "active_interactive": self._active[_INTERACTIVE],
                "active_background": self._active[_BACKGROUND],
                "queue_depth": len(self._waiting),
                "bg_tokens": self._bg_tokens,
                "bp_active": int(self._bp_active),
                **self._counters,
            }
        for name, nb in led.items():
            out[f"ledger_{name}_bytes"] = nb
        out["ledger_total_bytes"] = sum(led.values())
        with self._lock:
            for tenant, acct in self._tenants.items():
                for key, v in acct.items():
                    out[f"tenant_{tenant}_{key}"] = v
        return out

    def admission_snapshot(self) -> dict:
        """Admission section of /debug/queries (querytracker provider)."""
        now = time.monotonic()
        with self._lock:
            return {
                "enabled": self._budget > 0,
                "max_concurrent": self._max_concurrent,
                "active": dict(self._active),
                "queue": [
                    {"kind": e[1], "waited_ms": int((now - e[2]) * 1000)}
                    for e in self._waiting
                ],
                "reservations": dict(self._res_by_qid),
                "counters": dict(self._counters),
            }

    def describe(self) -> dict:
        """Full status for /debug/ctrl?mod=governor."""
        return {
            "enabled": self.enabled(),
            "config": self.config(),
            "ledger": self.ledger(),
            "admission": self.admission_snapshot(),
            "tenants": self.tenant_accounts(),
        }


class _NoopBgToken:
    __slots__ = ()
    name = ""

    def release(self) -> None:
        pass


class InflightGauge:
    """Thread-safe in-flight byte gauge a worker-pool module registers
    with the ledger (scanpool/encodepool: one instance per module, so an
    accounting fix lands in both instead of drifting across copies)."""

    __slots__ = ("_lock", "_total")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total = 0

    def note(self, delta: int) -> None:
        with self._lock:
            self._total += delta

    def total(self) -> int:
        with self._lock:
            return max(0, self._total)


# process-wide governor (the reference's resource allocator singletons)
GOVERNOR = ResourceGovernor()


def _attach_admission_provider() -> None:
    # /debug/queries pairs in-flight queries with the admission state;
    # lazy so utils.governor has no import-time querytracker dependency
    from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER

    _TRACKER.set_admission_provider(GOVERNOR.admission_snapshot)


_attach_admission_provider()
