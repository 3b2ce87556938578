"""Anti-entropy service: rf>1 replica digest exchange + read repair.
The port of ``opengemini_tpu/services/antientropy.py``, whole.

Reference: the raft-replicated data path keeps replicas consistent by
construction (engine/engine_replication.go, lib/raftconn); the
rendezvous+LWW data plane heals known-down nodes with hinted handoff but
a SILENTLY diverged replica (partial disk loss, dropped hint file) would
otherwise never reconverge. This service compares per-(shard-group,
measurement) content digests between owners and pulls diverged
measurements back for last-write-wins merge."""

from __future__ import annotations

from opengemini_tpu_torch.services.base import Service, logger


class AntiEntropyService(Service):
    name = "antientropy"

    def __init__(self, router, interval_s: float = 300.0):
        super().__init__(interval_s)
        self.router = router

    def handle(self) -> int:
        n = self.router.anti_entropy_round()
        if n:
            logger.info("anti-entropy: repaired %d (group, measurement) "
                        "divergences", n)
        return n
