"""Shard migration service (the port of
``opengemini_tpu/services/migration.py``, whole): pushes shard groups
whose rendezvous ownership moved away (membership change) to their new
owners and drops the local copies, after expiring the staging areas
older than its TTL (reference: app/ts-meta/meta/migrate_state_machine.go,
the balancer + engine_ha.go segment moves)."""

from __future__ import annotations

from opengemini_tpu_torch.services.base import Service, logger


class MigrationService(Service):
    name = "migration"

    def __init__(self, router, interval_s: float = 60.0,
                 staging_ttl_s: float = 900.0):
        super().__init__(interval_s)
        self.router = router
        self.staging_ttl_s = staging_ttl_s

    def handle(self) -> int:
        # janitor first: expire staging left by pushers that died
        # mid-stream (the Rollback that survives coordinator death)
        expired = self.router.engine.expire_staging(self.staging_ttl_s)
        if expired:
            logger.info("migration: expired %d stale staging areas", expired)
        n = self.router.migrate_round()
        if n:
            logger.info("migration: moved %d shard groups to new owners", n)
        return n
