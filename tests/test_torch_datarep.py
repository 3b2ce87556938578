"""The port's strict data replication (parallel/datarep.py,
/internal/raftdata, /internal/raftdata_propose) against the reference,
on the CPU: every case of the reference's tests/test_datarep.py runs on
the port (test_torch_raft.mirror_reference): a write acknowledged only
once every replica holds it, rf 3 committing on a majority with a member
down, a restart replaying the raft log idempotently, and a coordinator
outside the owner set.
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_datarep"))
