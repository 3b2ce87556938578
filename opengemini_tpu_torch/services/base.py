"""Service base: a background worker ticked at an interval.

The port of ``opengemini_tpu/services/base.py``: a service is a ticker
loop with a start/stop lifecycle; a tick's error is logged with its
errno tag (utils/errno.py), never fatal to the process. A ``governed``
service (compaction, downsample, rollup, continuous queries, streams)
takes a low-priority token from the resource governor for each timed
tick and pauses while interactive occupancy is high or an IO alarm is
recent (utils/governor.py ``acquire_background``; pass-through while
the governor is disabled); ``stop()`` ends a paused tick. ``tick()``
runs one iteration at once and ungated (a manual trigger, and the
tests' deterministic ticks).
"""

from __future__ import annotations

import logging
import threading

from opengemini_tpu_torch.utils import errno as _errno
from opengemini_tpu_torch.utils.governor import GOVERNOR

logger = logging.getLogger("opengemini_tpu_torch.services")


class Service:
    name = "service"
    # watchdog services (iodetector) stay ungoverned: pausing them under
    # load would blind them exactly when they matter
    governed = False

    def __init__(self, interval_s: float):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def handle(self) -> None:  # override
        raise NotImplementedError

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"svc-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def tick(self) -> None:
        """Run one iteration synchronously, ungated."""
        self.handle()

    def _governed_tick(self) -> None:
        if not self.governed:
            self.handle()
            return
        token = GOVERNOR.acquire_background(self.name, stop=self._stop)
        if token is None:
            return  # stopping while paused: skip the tick
        try:
            self.handle()
        finally:
            token.release()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._governed_tick()
            except Exception as e:  # noqa: BLE001 — service loops never die
                try:
                    note = _errno.tag(e)
                except Exception:  # noqa: BLE001 — classify() must never
                    note = "errno=?"  # kill the loop it annotates
                logger.exception("service %s tick failed [%s]", self.name,
                                 note)
