"""The port's one counter dict, keyed "section/name".

It stands in for the JAX package's STATS/devobs/tracker counters, which
the port does not carry. It holds what tests and chip_smoke.py read:
executor/grid_batches and executor/grid_fallbacks (which layout a GROUP
BY time() batch took), executor/queries, executor/rows_scanned and
write/points. HTTP handler threads share it, so updates go through
incr().
"""

from __future__ import annotations

import collections
import threading

STATS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()


def incr(key: str, n: int = 1) -> None:
    with _LOCK:
        STATS[key] += n
