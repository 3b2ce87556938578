"""Host/device routing of the encoded cold scan: the zero-sample prior
of ``opengemini_tpu/query/offload.py``.

The JAX planner learns per (kernel, geometry) from measured walls; with
no samples it makes exactly the static choices below, and that cold
behaviour is what the port carries. So the port routes every query as a
cold JAX planner does:

- ``static_route``: a grid freeze whose value columns are all still
  encoded goes to the device (the fused decode program); once any of
  them has been decoded on the host, it scatters on the host
  (models/grid.py).
- ``gate_prior``: the device route ships the encoded bytes only when
  they undercut the decoded buffer they replace (for the grid: cells x
  9 bytes, an 8-byte value and a mask byte per padded cell).

The adaptive part (samples, exploration, the compile pre-warmer) is not
ported yet.
"""

from __future__ import annotations

from opengemini_tpu_torch.utils.stats import GLOBAL as STATS


def static_route(any_decoded: bool) -> str:
    """Route of an encoded grid freeze: "host" once any column was
    decoded on the host, else "device"."""
    return "host" if any_decoded else "device"


def gate_prior(device_bytes: int, host_bytes: int) -> bool:
    """Ship encoded iff the encoded transfer undercuts the decoded buffer
    it replaces; a veto is counted (offload/gate_vetoes_total)."""
    ok = int(device_bytes) < int(host_bytes)
    if not ok:
        STATS.incr("offload", "gate_vetoes_total")
    return ok
