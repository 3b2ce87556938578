"""Continuous rule service: governed ticks for the PromQL rule engine.

The port of ``opengemini_tpu/services/rules.py`` for one node.
Reference: the Prometheus rule manager's group scheduler
(rules/manager.go — each group evaluates on its interval), run here as a
governed background service like rollup/continuousquery: under
interactive saturation or an IO alarm the whole tick pauses, and inside
a tick each tenant (database) is CHARGED separately — tick time and
group counts land in the governor's per-tenant accounts, and a tenant
whose groups are skipped because the background gate closed mid-tick
gets a shed mark (the Taurus per-tenant governance argument,
arXiv:2506.20010).

In a cluster with a data router only the meta leader ticks (each
node's rules read the whole cluster, so every node ticking would write
every recording again); without one every node ticks its own groups.

The actual evaluation — incremental tile maintenance, durable claim/
final-save ordering, the verify leg — lives in promql/rules.py
(RuleManager.tick_group); this module is only the scheduler skin.
"""

from __future__ import annotations

import time as _time

from opengemini_tpu_torch.services.base import Service, logger
from opengemini_tpu_torch.utils.governor import GOVERNOR
from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


class RulesService(Service):
    name = "rules"
    governed = True

    def __init__(self, engine, interval_s: float = 5.0, manager=None,
                 meta_store=None, router=None):
        super().__init__(interval_s)
        self.engine = engine
        # manager may be constructed lazily (the OGT_RULES gate, the
        # first /debug/ctrl declare); falling back to engine.rules_hook
        # keeps ctrl-declared groups ticking even when the service was
        # built first
        self._manager = manager
        # the lease: with a data router, only the meta leader ticks
        self.meta_store = meta_store
        self.router = router

    @property
    def manager(self):
        return self._manager if self._manager is not None \
            else getattr(self.engine, "rules_hook", None)

    def handle(self, now_ns: int | None = None) -> int:
        mgr = self.manager
        if mgr is None:
            return 0
        if (self.meta_store is not None and self.router is not None
                and not self.meta_store.is_leader()):
            return 0
        if now_ns is None:
            now_ns = _time.time_ns()
        ran = 0
        for db in mgr.dbs_with_groups():
            if self._stop.is_set():
                break
            if not GOVERNOR.background_allowed():
                # gate closed mid-tick: this tenant's groups are shed
                # this round (retried next tick) and the shed is charged
                # to THEM — rule lag is their signal
                GOVERNOR.charge_tenant(db, "rules_sheds", 1)
                STATS.incr("rules", "tick_sheds")
                continue
            t0 = _time.perf_counter_ns()
            try:
                n = mgr.tick(now_ns, db=db, stop=self._stop)
            except Exception:  # noqa: BLE001 — one tenant's bad group
                logger.exception("rule tick for %s failed", db)
                continue  # never starves the others
            ran += n
            GOVERNOR.charge_tenant(db, "rules_groups", n)
            GOVERNOR.charge_tenant(
                db, "rules_ms", (_time.perf_counter_ns() - t0) // 1_000_000)
        return ran
