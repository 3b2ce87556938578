"""Device observability: the capability probe and the transfer counters.

The port of the part of ``opengemini_tpu/utils/devobs.py`` that the cold
scan uses:

- ``probe(device)`` runs the capability probe once per process and
  device type: kernel 6, ``cuda_segment.probe_count``, the masked row
  count of the 8 x 8 all-ones int8 matrix, which must count 8 in every
  row. ops/device_decode.py calls it before it routes the widen and
  bit-unpack steps through kernels 4 and 5 (the reference gates them on
  ``pallas_supported``). A probe that fails or counts wrong RAISES: the
  port never routes around a kernel that does not work.
- ``note_transfer`` counts host-to-device bytes and copies per site in
  ``utils.stats.GLOBAL`` (module ``devobs``: ``h2d_bytes/<site>``,
  ``h2d_copies/<site>``).

The compile inventory, the device-memory ledger and the profiler
capture of the reference are not ported yet.
"""

from __future__ import annotations

import threading

import torch

from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

_probe_lock = threading.Lock()
_probed: set[str] = set()


def probe(device) -> None:
    """Run kernel 6 on `device` once per process and device type; raise
    unless it counts 8 in every row."""
    dev = torch.device(device)
    with _probe_lock:
        if dev.type in _probed:
            return
        from opengemini_tpu_torch.ops import cuda_segment

        m = torch.ones((8, 8), dtype=torch.int8, device=dev)
        counts = cuda_segment.probe_count(m).cpu()
        if counts.shape != (8, 1) or not bool((counts == 8).all()):
            raise RuntimeError(
                f"capability probe computed a wrong count on {dev}: "
                f"{counts.reshape(-1).tolist()}")
        _probed.add(dev.type)


def note_transfer(direction: str, site: str, nbytes: int) -> None:
    """Count one copy of `nbytes` in `direction` ("h2d") at `site`."""
    STATS.incr("devobs", f"{direction}_bytes/{site}", int(nbytes))
    STATS.incr("devobs", f"{direction}_copies/{site}")


def reset() -> None:
    """Forget which devices were probed, so the next decode probes again
    — what a new process starts with (chip_smoke.py restarts the engine
    in one process)."""
    with _probe_lock:
        _probed.clear()
