"""The port's two-phase migration and balancer (parallel/cluster.py's
operations, storage/engine.py's staging, server/http.py's
/internal/migrate and /internal/load) against the reference, on the CPU.

Every case of the reference's tests/test_migration.py runs on the port
(test_torch_raft.mirror_reference): a node join rebalancing its groups,
a migration waiting for a down owner, staging invisible until commit,
abort and TTL expiry, every partial failure of the commit (a lost ack,
a re-commit racing the fold, a crash between fold and ack, an abort
after a partial commit), the load balancer's moves and placement
overrides, and the namespace names refused.
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_migration"))
