"""Sherlock: watermark-triggered self-diagnostics.

The port of ``opengemini_tpu/services/sherlock.py``, whole, with a
plain ``threading`` lock; ``start()`` subscribes ``diagnose`` to the
resource governor's shed/kill burst hook (utils/governor.py).

Reference: lib/sherlock (sherlock.go:30, Start:109, startDumpLoop:125) —
a continuous CPU/memory/goroutine monitor that auto-dumps pprof profiles
when watermarks are crossed. Python equivalent: RSS and thread-count
watermarks; on crossing, dump every thread's stack plus a tracemalloc
top-allocations report into `<data>/sherlock/`, rate-limited with a
cooldown so a sustained spike produces one dump, not hundreds.
"""

from __future__ import annotations

import os
import sys
import threading
import time as _time
import traceback

from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.utils import lockdep


def _rss_mb() -> float:
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except (OSError, ValueError, IndexError):  # pragma: no cover
        return 0.0


class SherlockService(Service):
    name = "sherlock"

    def __init__(self, engine, interval_s: float = 30.0,
                 mem_mb_watermark: float = 4096.0,
                 thread_watermark: int = 200,
                 cooldown_s: float = 600.0,
                 enable_tracemalloc: bool = False):
        super().__init__(interval_s)
        self.engine = engine
        self.mem_mb_watermark = mem_mb_watermark
        self.thread_watermark = thread_watermark
        self.cooldown_s = cooldown_s
        self._last_dump = float("-inf")  # monotonic() epoch is arbitrary
        self.dumps = 0
        # serializes the cooldown check+commit AND the dump itself: the
        # governor burst hook (diagnose, its own thread) races the
        # service tick (handle), and one window must yield ONE dump
        self._dump_lock = lockdep.Lock()
        if enable_tracemalloc:  # ~2x alloc overhead; opt-in like pprof heap
            import tracemalloc

            tracemalloc.start(10)

    def start(self) -> None:
        # a governor shed/kill burst triggers a dump (already rate-limited
        # on the governor side; our own cooldown still applies): the
        # moment load is being shed is exactly when the operator needs
        # thread stacks + the ledger on disk.  Registered here, not in
        # __init__: the process-global hook must not outlive (or pin) an
        # instance that was never run
        from opengemini_tpu_torch.utils.governor import GOVERNOR

        GOVERNOR.set_diagnostic_hook(self.diagnose)
        super().start()

    def stop(self) -> None:
        from opengemini_tpu_torch.utils.governor import GOVERNOR

        GOVERNOR.detach_diagnostic_hook(self.diagnose)
        super().stop()

    def diagnose(self, reason: str) -> str | None:
        """Force a diagnostic dump for an external trigger (the governor's
        shed/kill burst hook).  Honors the dump cooldown."""
        return self._maybe_dump(reason, _rss_mb(), threading.active_count())

    def _maybe_dump(self, trigger: str, rss: float,
                    n_threads: int) -> str | None:
        """Cooldown-gated dump, safe against handle()/diagnose() racing
        from different threads.  The cooldown/counter commit only after
        the dump lands on disk: a failed dump (disk full) must not burn
        the window unretried."""
        with self._dump_lock:
            if _time.monotonic() - self._last_dump < self.cooldown_s:
                return None
            path = self._dump(trigger, rss, n_threads)
            self._last_dump = _time.monotonic()
            self.dumps += 1
            return path

    def handle(self) -> str | None:
        rss = _rss_mb()
        n_threads = threading.active_count()
        trigger = None
        if rss > self.mem_mb_watermark:
            trigger = f"rss {rss:.0f}MB > {self.mem_mb_watermark:.0f}MB"
        elif n_threads > self.thread_watermark:
            trigger = f"threads {n_threads} > {self.thread_watermark}"
        if trigger is None:
            return None
        return self._maybe_dump(trigger, rss, n_threads)

    def _dump(self, trigger: str, rss: float, n_threads: int) -> str:
        out_dir = os.path.join(self.engine.root, "sherlock")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"dump-{_time.strftime('%Y%m%dT%H%M%S')}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"sherlock dump — trigger: {trigger}\n")
            f.write(f"rss_mb={rss:.1f} threads={n_threads}\n\n")
            try:
                # the governor ledger snapshot: which component holds the
                # memory / what the admission state was at dump time
                from opengemini_tpu_torch.utils.governor import GOVERNOR

                f.write("== governor ==\n")
                import json as _json

                f.write(_json.dumps(GOVERNOR.describe(), indent=1))
                f.write("\n\n")
            except Exception:  # noqa: BLE001 — diagnostics best-effort
                pass
            try:
                # recent slow queries (utils/slowlog): the statements —
                # with stage/span attribution — that were dragging when
                # the watermark tripped
                from opengemini_tpu_torch.utils.slowlog import GLOBAL as _SLOW

                slow = _SLOW.snapshot()
                if slow["records"]:
                    import json as _json

                    f.write("== slow queries ==\n")
                    f.write(_json.dumps(slow, indent=1, default=str))
                    f.write("\n\n")
            except Exception:  # noqa: BLE001 — diagnostics best-effort
                pass
            f.write("== thread stacks ==\n")
            for tid, frame in sys._current_frames().items():
                f.write(f"\n-- thread {tid} --\n")
                f.write("".join(traceback.format_stack(frame)))
            try:
                import tracemalloc

                if tracemalloc.is_tracing():
                    f.write("\n== top allocations ==\n")
                    snap = tracemalloc.take_snapshot()
                    for stat in snap.statistics("lineno")[:25]:
                        f.write(f"{stat}\n")
            except Exception:  # noqa: BLE001
                pass
        from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

        _STATS.incr("sherlock", "sherlock_dumps")
        logger.warning("sherlock: dumped diagnostics to %s (%s)", path, trigger)
        return path
