"""Parallel chunk-encode pool: the ordered encode pipe TSFWriter drains.

The port of ``opengemini_tpu/storage/encodepool.py``, with the
in-flight byte gauge the resource governor's ledger reads
(``encodepool``, utils/governor.py). Column encodes (zlib, the native gorilla and
varint codecs, numpy packing) release the GIL, so a flush fans them over
a shared thread pool:

  OrderedEncodePipe(consume)
      submit(job, est_bytes) runs the pure encode jobs on the pool (one
      worker per core, at most 16); results drain FIFO — in submission
      order — into `consume` on the submitting thread (which owns the
      file offsets), so output files are byte-identical to a serial
      encode. In-flight encode-input bytes are bounded by a 256 MiB
      budget (submission stalls and drains until under it). On one core
      the job runs inline.

The reference's OGT_ENCODE_WORKERS / OGT_ENCODE_INFLIGHT_MB knobs are
not ported: the defaults are constants here.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.governor import GOVERNOR, InflightGauge


def _auto_workers() -> int:
    if hasattr(os, "sched_getaffinity"):
        n = len(os.sched_getaffinity(0))
    else:
        n = os.cpu_count() or 1
    return max(1, min(n, 16))


WORKERS = _auto_workers()
INFLIGHT_BYTES = 256 << 20

_pool: ThreadPoolExecutor | None = None
_pool_lock = lockdep.Lock()

# encode-input bytes in flight across every open pipe: the resource
# governor's ledger component "encodepool"
_inflight = InflightGauge()
_note_inflight = _inflight.note


def total_inflight_bytes() -> int:
    """Estimated encode-input bytes in flight across all pipes."""
    return _inflight.total()


def enabled() -> bool:
    return WORKERS >= 2


def pool() -> ThreadPoolExecutor | None:
    global _pool
    if not enabled():
        return None
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=WORKERS, thread_name_prefix="ogt-encode")
    return _pool


class OrderedEncodePipe:
    """Ordered encode pipeline for ONE output file: jobs (argless pure
    callables returning an encoded payload) fan across the shared pool;
    results drain FIFO into `consume` on the submitting thread, so block
    offsets — and therefore file bytes — are identical to the serial
    path. One writer thread owns one pipe."""

    def __init__(self, consume):
        self._consume = consume
        self._p = pool()
        self._pending: deque = deque()
        self._inflight = 0
        self._max_pending = 4 * WORKERS

    def submit(self, job, est_bytes: int) -> None:
        """Queue one encode job; may drain older completed jobs into
        `consume` to stay under the in-flight budget (a single oversized
        job is still admitted alone, so progress is always possible)."""
        if self._p is None:
            self._consume(job())  # the exact serial encode+write order
            return
        while self._pending and (
            self._inflight + est_bytes > INFLIGHT_BYTES
            or len(self._pending) >= self._max_pending
        ):
            self._drain_one()
        self._pending.append((self._p.submit(job), est_bytes))
        self._inflight += est_bytes
        _note_inflight(est_bytes)

    def _drain_one(self) -> None:
        fut, nb = self._pending.popleft()
        try:
            out = fut.result()  # worker exceptions surface on the writer thread
        finally:
            self._inflight -= nb
            _note_inflight(-nb)
        self._consume(out)

    def drain(self) -> None:
        """Write out every pending job in submission order (finish())."""
        while self._pending:
            self._drain_one()

    def abort(self) -> None:
        """Cancel pending jobs (writer abort); running jobs finish into
        discarded futures whose results are never consumed."""
        for fut, _nb in self._pending:
            fut.cancel()
        self._pending.clear()
        _note_inflight(-self._inflight)
        self._inflight = 0


GOVERNOR.register_component("encodepool", total_inflight_bytes)
