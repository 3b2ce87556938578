"""Parallel chunk-decode pool for the shard scans.

The port of ``opengemini_tpu/storage/scanpool.py``'s ``map_ordered`` and
``est_chunk_bytes``, with the query tracker's kill points (a job runs
bound to its query's id: a killed query's queued jobs raise instead of
decoding, and the consumer stops at the next result) and with the
in-flight byte gauge the resource governor's ledger reads
(``scanpool``, utils/governor.py). TSF chunk decodes (zlib, the native codecs,
numpy) release the GIL, so a scan fans them over a shared worker pool
and yields the results in submission order: bit-identical to a serial
decode. One worker per core (at most 16), a 256 MiB in-flight budget of
decoded bytes; the reference's OGT_SCAN_WORKERS / OGT_SCAN_INFLIGHT_MB
knobs are not ported.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from opengemini_tpu_torch.utils.governor import GOVERNOR, InflightGauge
from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER


def _auto_workers() -> int:
    if hasattr(os, "sched_getaffinity"):
        n = len(os.sched_getaffinity(0))
    else:
        n = os.cpu_count() or 1
    return max(1, min(n, 16))


WORKERS = _auto_workers()
INFLIGHT_BYTES = 256 << 20
# below this many jobs the pool's dispatch overhead exceeds the decode
MIN_POOL_JOBS = 4

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()

# decoded bytes in flight across every scan: the resource governor's
# ledger component "scanpool"
_inflight = InflightGauge()
_note_inflight = _inflight.note


def total_inflight_bytes() -> int:
    """Estimated decoded bytes in flight across all scans."""
    return _inflight.total()


def pool() -> ThreadPoolExecutor | None:
    global _pool
    if WORKERS < 2:
        return None
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=WORKERS, thread_name_prefix="ogt-scan")
    return _pool


def map_ordered(jobs, est_bytes):
    """Run `jobs` (argless callables) on the pool; yield results in
    SUBMISSION order regardless of completion order. `est_bytes[i]` is
    the estimated decoded size of job i — the sum over submitted but
    unconsumed jobs stays under the in-flight budget (a single oversized
    job is still admitted alone). Few jobs, or a disabled pool, run
    inline: identical results either way, since every decode job is
    pure."""
    jobs = list(jobs)
    p = pool()
    if p is None or len(jobs) < MIN_POOL_JOBS:
        for job in jobs:
            _TRACKER.check()
            yield job()
        return
    est = list(est_bytes)
    if len(est) != len(jobs):
        raise ValueError("est_bytes length must match jobs")
    qid = _TRACKER.current_qid()

    def bound(job):
        # stage time a job adds (the decoded-column cache's lookups and
        # fills) goes to the query that submitted it, and a killed
        # query stops paying for decodes it would discard
        _TRACKER.bind(qid)
        _TRACKER.raise_if_killed(qid)
        return job()

    pending: deque = deque()
    inflight = 0
    i = 0
    max_pending = 4 * WORKERS
    try:
        while i < len(jobs) or pending:
            while i < len(jobs) and (
                not pending
                or (inflight + est[i] <= INFLIGHT_BYTES
                    and len(pending) < max_pending)
            ):
                _TRACKER.check()
                pending.append((p.submit(bound, jobs[i]), est[i]))
                inflight += est[i]
                _note_inflight(est[i])
                i += 1
            fut, nb = pending.popleft()
            try:
                out = fut.result()
            finally:
                inflight -= nb
                _note_inflight(-nb)
            _TRACKER.check()
            yield out
    finally:
        # consumer abandoned mid-scan: cancel everything not yet running
        for fut, nb in pending:
            fut.cancel()
            _note_inflight(-nb)


def est_chunk_bytes(chunk, n_fields: int | None) -> int:
    """Decoded-size estimate of one TSF chunk from its metadata alone:
    rows x 9 bytes (8-byte value + mask bit) per column, +1 column for
    the time (and sid, when packed) arrays."""
    cols = (n_fields if n_fields is not None else max(len(chunk.cols), 1)) + 2
    return chunk.rows * 9 * cols


GOVERNOR.register_component("scanpool", total_inflight_bytes)
