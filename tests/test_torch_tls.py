"""The port's TLS listener (HttpService(tls=...)) and the peers' https
transport (utils/peers.py) against the JAX package, on the CPU.

Every case of the reference's tests/test_tls.py runs on the port
(test_torch_raft.mirror_reference).
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_tls"))
