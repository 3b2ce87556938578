"""Service base: a background worker ticked at an interval.

The port of ``opengemini_tpu/services/base.py``: a service is a ticker
loop with a start/stop lifecycle; a tick's error is logged with its
errno tag (utils/errno.py), never fatal to the process.

Not in this port yet: the resource governor's throttling of background
services (the reference's ``governed`` services pause under interactive
load; ROADMAP A7). Every tick here runs ungated.
"""

from __future__ import annotations

import logging
import threading

from opengemini_tpu_torch.utils import errno as _errno

logger = logging.getLogger("opengemini_tpu_torch.services")


class Service:
    name = "service"

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

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.handle()
            except Exception as e:  # noqa: BLE001 — service loops never die
                try:
                    note = _errno.tag(e)
                except Exception:  # noqa: BLE001 — classify() must never
                    note = "errno=?"  # kill the loop it annotates
                logger.exception("service %s tick failed [%s]", self.name,
                                 note)
