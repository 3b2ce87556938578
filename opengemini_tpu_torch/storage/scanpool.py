"""Parallel chunk-decode pool and scan pipeline for the shard scans.

The port of ``opengemini_tpu/storage/scanpool.py``. Two primitives, both
yielding in submission order, so results are bit-identical to a serial
scan:

  map_ordered(jobs, est_bytes)
      TSF chunk decodes (zlib, the native codecs, numpy) release the
      GIL: a scan fans them over a shared worker pool. In-flight decoded
      bytes stay under a budget (submission stalls until the consumer
      drains).

  prefetch_ordered(thunks)
      Double-buffered pipeline: a dedicated producer thread runs thunk
      N+1 (the executor's next bulk shard read) while the consumer feeds
      thunk N's rows into the device batches. A bounded queue bounds the
      look-ahead.

Both carry the query tracker's kill points: the helper threads run
bound to the calling query's id, so KILL QUERY interrupts a scan
mid-decode or mid-pipeline. The in-flight byte gauge feeds the resource
governor's ledger (``scanpool``, utils/governor.py). ``forced_serial()``
degrades the calling thread to the serial path (inline decodes, no
producer thread; the executor's sliced scan then also settles each slice
before the next one decodes): the A-B switch of the pipeline. One worker
per core (at most 16), a 256 MiB in-flight budget of decoded bytes; the
reference's OGT_SCAN_WORKERS / OGT_SCAN_INFLIGHT_MB knobs are not
ported (tests patch ``WORKERS``).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.governor import GOVERNOR, InflightGauge
from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS


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
_pool_lock = lockdep.Lock()
# thread-local, not process-wide: an A-B block must not degrade the
# concurrent queries of other server threads to the serial path
_serial_local = threading.local()

# decoded bytes in flight across every scan: the resource governor's
# ledger component "scanpool"
_inflight = InflightGauge()
_note_inflight = _inflight.note


def total_inflight_bytes() -> int:
    """Estimated decoded bytes in flight across all scans."""
    return _inflight.total()


def serial_forced() -> bool:
    """Whether the calling thread is inside ``forced_serial()``."""
    return getattr(_serial_local, "forced", False)


def enabled() -> bool:
    return WORKERS >= 2 and not serial_forced()


@contextlib.contextmanager
def forced_serial():
    """Degrade the CALLING THREAD to the serial scan path (the A-B
    switch; one worker is the same process-wide)."""
    prev = getattr(_serial_local, "forced", False)
    _serial_local.forced = True
    try:
        yield
    finally:
        _serial_local.forced = prev


def pool() -> ThreadPoolExecutor | None:
    global _pool
    if not enabled():
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


def prefetch_ordered(thunks, depth: int = 2):
    """Double-buffered pipeline over `thunks` (argless callables): a
    dedicated producer thread computes up to `depth` results ahead while
    the consumer processes the current one; results yield in order. A
    producer error re-raises on the consumer, and a consumer that stops
    early (an exception, a KILL, a close) stops the producer.

    The producer is not a pool worker, so thunks may fan their chunk
    decodes into map_ordered without deadlock. Disabled (or under two
    thunks) the thunks run inline."""
    thunks = list(thunks)
    if not enabled() or len(thunks) < 2:
        for t in thunks:
            _TRACKER.check()
            yield t()
        return
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    qid = _TRACKER.current_qid()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        _TRACKER.bind(qid)  # the thunks' kill checks fire here too
        try:
            for t in thunks:
                if stop.is_set() or _TRACKER.is_killed(qid):
                    break
                got = t()
                _STATS.incr("scanpool", "prefetched_units")
                if not put(("ok", got)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            put(("err", e))
            return
        put(("end", None))

    worker = threading.Thread(target=produce, name="ogt-scan-prefetch",
                              daemon=True)
    worker.start()
    try:
        while True:
            kind, val = q.get()
            if kind == "end":
                break
            if kind == "err":
                raise val
            _TRACKER.check()
            yield val
    finally:
        stop.set()
        while True:  # drain, so that a blocked producer wakes and exits
            try:
                q.get_nowait()
            except queue.Empty:
                break
        worker.join(timeout=5.0)


def est_chunk_bytes(chunk, n_fields: int | None) -> int:
    """Decoded-size estimate of one TSF chunk from its metadata alone:
    rows x 9 bytes (8-byte value + mask bit) per column, +1 column for
    the time (and sid, when packed) arrays."""
    cols = (n_fields if n_fields is not None else max(len(chunk.cols), 1)) + 2
    return chunk.rows * 9 * cols


GOVERNOR.register_component("scanpool", total_inflight_bytes)
