"""Load-aware balance service: periodic skew check on the meta leader.
The port of ``opengemini_tpu/services/balancer.py``, whole.

Reference: app/ts-meta/meta/balance_manager.go +
master_pt_balance_manager.go — the reference's balance managers react to
load reports and move PT ownership; rendezvous placement here already
self-balances on membership change, so this service covers the OTHER
case: byte-size skew between nodes with stable membership. Decisions are
raft-replicated placement overrides; the data moves when the shedding
node's own MigrationService observes it no longer owns the group.

Each pass runs under a perf_counter deadline (half the service interval,
capped at 30s): collect_loads stops polling peers once the budget is
spent, and breaker-open peers fail fast via CircuitOpen instead of
eating a full RPC timeout each — so a dead node can never stretch a
balance pass across the next scheduled one.
"""

from __future__ import annotations

from time import perf_counter

from opengemini_tpu_torch.services.base import Service, logger


class BalanceService(Service):
    name = "balancer"

    def __init__(self, router, meta_store, interval_s: float = 3600.0,
                 min_skew_mb: int = 64, skew_ratio: float = 1.3):
        super().__init__(interval_s)
        self.router = router
        self.meta_store = meta_store
        self.min_skew_bytes = int(min_skew_mb) << 20
        self.skew_ratio = float(skew_ratio)
        self.budget_s = min(30.0, max(1.0, interval_s / 2.0))

    def handle(self) -> int:
        if not getattr(self.meta_store, "is_leader", lambda: True)():
            return 0  # one decision-maker per cluster
        t0 = perf_counter()
        move = self.router.balance_round(
            min_skew_bytes=self.min_skew_bytes,
            skew_ratio=self.skew_ratio,
            budget_s=self.budget_s,
        )
        elapsed = perf_counter() - t0
        if elapsed > self.budget_s:
            logger.warning("balance: pass took %.1fs (budget %.1fs) — "
                           "slow peers truncated the load poll",
                           elapsed, self.budget_s)
        if move:
            logger.info(
                "balance: group %s (%d bytes) %s -> %s (owners %s) in %.2fs",
                move["group"], move["bytes"], move["from"], move["to"],
                move["owners"], elapsed)
            return 1
        return 0
