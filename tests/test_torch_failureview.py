"""The port's quorum failure view (DataRouter.probe_health,
exchange_health, node_up, /cluster/health, SHOW CLUSTER) against the JAX
package, on the CPU.

Every case of the reference's tests/test_failureview.py runs on the port
(test_torch_raft.mirror_reference).
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_failureview"))
