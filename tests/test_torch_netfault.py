"""The port's transport fault rules (parallel/netfault.py), the router's
circuit breaker and RPC knobs, and /debug/ctrl?mod=netfault and
mod=cluster, against the JAX package, on the CPU.

Every case of the reference's tests/test_netfault.py runs on the port
(test_torch_raft.mirror_reference).
"""

from __future__ import annotations

import torch

from test_torch_raft import mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_netfault"))
