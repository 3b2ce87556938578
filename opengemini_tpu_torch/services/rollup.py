"""Rollup maintenance service: governed background folding.

The port of ``opengemini_tpu/services/rollup.py``. A tick folds the
dirty and newly closed windows of every declared rollup
(storage/rollup.py), one database (tenant) at a time. Ticks are
governed (services/base.py); inside a tick, a tenant met after the
background gate closed is shed for this round and charged
``rollup_sheds``, and each folded tenant is charged its windows and fold
milliseconds in the governor's per-tenant accounts.
"""

from __future__ import annotations

import time as _time

from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.utils.governor import GOVERNOR
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


class RollupService(Service):
    name = "rollup"
    governed = True

    def __init__(self, engine, interval_s: float = 5.0):
        super().__init__(interval_s)
        self.engine = engine

    def handle(self, now_ns: int | None = None) -> int:
        mgr = self.engine.rollup_mgr
        if mgr is None:
            return 0
        folded = 0
        for db in mgr.dbs_with_specs():
            if self._stop.is_set():
                break
            if not GOVERNOR.background_allowed():
                # the gate closed mid-tick: remaining tenants are shed
                # this round (retried next tick) and the shed is charged
                # to THEM — their maintenance lag is their signal
                GOVERNOR.charge_tenant(db, "rollup_sheds", 1)
                STATS.incr("rollup", "tick_sheds")
                continue
            t0 = _time.perf_counter_ns()
            try:
                n = mgr.maintain_db(db, now_ns)
            except Exception:  # noqa: BLE001 — one tenant's bad fold
                logger.exception("rollup maintenance for %s failed", db)
                continue  # never starves the others
            folded += n
            GOVERNOR.charge_tenant(db, "rollup_windows", n)
            GOVERNOR.charge_tenant(
                db, "rollup_ms", (_time.perf_counter_ns() - t0) // 1_000_000)
        return folded
