"""IO-hang watchdog: a stuck disk raises an alarm, or with ``fatal``
exits the process so orchestration fails over instead of limping.

The port of ``opengemini_tpu/services/iodetector.py``, whole. Every
alarm feeds the resource governor (``note_io_alarm``), which pauses the
governed background services for ``OGT_BG_IO_PAUSE_S``.

Each tick performs a small write+fsync probe in the data directory FROM A
SEPARATE THREAD with a deadline; a probe that misses the deadline means
the volume is hanging and the configured action fires (log alarm, or
`fatal=True` process exit so orchestration restarts/fails over the node).
"""

from __future__ import annotations

import os
import threading
import time as _time

from opengemini_tpu_torch.services.base import Service, logger


class IoDetectorService(Service):
    name = "iodetector"

    def __init__(self, engine, interval_s: float = 30.0,
                 probe_timeout_s: float = 10.0, fatal: bool = False):
        super().__init__(interval_s)
        self.engine = engine
        self.probe_timeout_s = probe_timeout_s
        self.fatal = fatal
        self.alarms = 0
        self._probe_thread: threading.Thread | None = None

    def handle(self) -> bool:
        """Returns True when the probe completed in time."""
        if self._probe_thread is not None and self._probe_thread.is_alive():
            # previous probe still stuck in fsync: the disk is still hung;
            # count the repeat alarm but don't stack another blocked thread
            self.alarms += 1
            self._note_alarm()
            logger.error("iodetector: previous probe still hung (alarm #%d)",
                         self.alarms)
            if self.fatal:
                logger.critical("iodetector: fatal — exiting for failover")
                os._exit(3)
            return False
        done = threading.Event()
        err: list = []

        def probe():
            try:
                path = os.path.join(self.engine.root, ".iodetector")
                with open(path, "w", encoding="utf-8") as f:
                    f.write(str(_time.time_ns()))
                    f.flush()
                    os.fsync(f.fileno())
                done.set()
            except OSError as e:  # pragma: no cover - disk failure
                err.append(e)
                done.set()

        t = threading.Thread(target=probe, daemon=True, name="io-probe")
        self._probe_thread = t
        t.start()
        ok = done.wait(self.probe_timeout_s) and not err
        if not ok:
            self.alarms += 1
            self._note_alarm()
            logger.error(
                "iodetector: disk probe %s after %.1fs (alarm #%d)",
                "failed" if err else "hung", self.probe_timeout_s, self.alarms,
            )
            if self.fatal:
                logger.critical("iodetector: fatal — exiting for failover")
                os._exit(3)
        return ok

    @staticmethod
    def _note_alarm() -> None:
        """Feed the resource governor: a hung disk pauses background
        compaction/downsample/stream work so the recovering volume serves
        interactive traffic and flushes first (utils/governor.py)."""
        from opengemini_tpu_torch.utils.governor import GOVERNOR

        GOVERNOR.note_io_alarm()
