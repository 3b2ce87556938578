"""Hint replay service, the port of
``opengemini_tpu/services/hintreplay.py`` (reference: the HA writer's
hinted-handoff drainer): each tick exchanges the failure view (the
health probes SHOW CLUSTER reads) and delivers the queued replica
copies to recovered nodes."""

from __future__ import annotations

from opengemini_tpu_torch.services.base import Service, logger


class HintReplayService(Service):
    name = "hintreplay"

    def __init__(self, router, interval_s: float = 30.0):
        super().__init__(interval_s)
        self.router = router

    def handle(self) -> int:
        # member liveness: quorum-agreed failure view (SHOW CLUSTER status,
        # migration gates, read-primary demotion)
        self.router.exchange_health()
        n = self.router.replay_hints()
        if n:
            logger.info("hinted handoff: delivered %d points", n)
        return n
