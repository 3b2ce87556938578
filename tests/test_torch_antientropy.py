"""The port's anti-entropy (DataRouter.anti_entropy_round,
Shard.content_digest, /internal/digest) against the reference, on the
CPU: every case of the reference's tests/test_antientropy.py runs on the
port (test_torch_raft.mirror_reference): a replica that lost its shard
directory reconverges, a partial divergence repairs last-write-wins, and
rf 1 never runs a round.
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_antientropy"))
