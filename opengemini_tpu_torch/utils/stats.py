"""Self-monitoring statistics registry and latency histograms.

The port of ``opengemini_tpu/utils/stats.py``: a process-wide registry
of named counters grouped by module (``GLOBAL.incr("executor",
"grid_batches")``), served at ``/debug/vars`` (server/http.py), and
fixed-log-bucket latency Histograms (``observe_ns``), which the query
stage timing (utils/tracing.py ``record_stage``) feeds per stage.

Sections the port fills: ``executor`` (queries, rows_scanned,
grid_batches, grid_fallbacks, grid_decode_fused,
grid_decode_fallbacks), ``write`` (points), ``device`` (the device
decode's block and byte counts), ``devobs`` (transfer bytes and copies
per site), ``offload`` (gate vetoes), ``colcache`` (storage/colcache.py),
``compact`` and ``compaction`` (storage/shard.py,
services/compaction.py), ``quarantine`` (the files quarantined, and the
engines' ``files_current`` gauge) and ``query_stages`` (``<stage>_ns``
and ``<stage>_count`` per query stage). HTTP handler threads share the
registry, so every update takes its lock.

Gauge providers (``register_provider``) add live sections to every
snapshot: the failpoints' hit counts (``failpoints``) and each engine's
quarantine gauge; the providers of one module sum their shared keys.

Not in this port yet: the governor's gauges (utils/governor.py is not
ported) and the Prometheus text export (``/metrics``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict


class Statistics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        self._providers: dict[str, list] = defaultdict(list)
        # uptime is a duration: perf_counter, not the wall clock
        self.started_pc = time.perf_counter()

    def incr(self, module: str, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[module][name] += delta

    def set(self, module: str, name: str, value: int) -> None:
        with self._lock:
            self._counters[module][name] = value

    def register_provider(self, module: str, fn) -> None:
        """Attach a live gauge section to every snapshot(). Providers of
        one module merge by summing shared keys (several engines in one
        process report process-wide totals)."""
        with self._lock:
            self._providers[module].append(fn)

    def unregister_provider(self, module: str, fn) -> None:
        with self._lock:
            fns = self._providers.get(module)
            if fns and fn in fns:
                fns.remove(fn)
            if fns is not None and not fns:
                del self._providers[module]

    def counters(self, module: str) -> dict:
        """One module's raw counter section (a copy): no provider runs."""
        with self._lock:
            return dict(self._counters.get(module, ()))

    def snapshot(self) -> dict:
        """Every section (copies) with the providers' gauges: what
        /debug/vars serves."""
        with self._lock:
            out = {m: dict(vals) for m, vals in self._counters.items()}
            providers = [(m, fn) for m, fns in self._providers.items()
                         for fn in fns]
        for module, fn in providers:  # outside the lock: providers take
            try:                      # their own locks (shard locks)
                vals = fn()
            except Exception:  # noqa: BLE001 — a closed engine's provider
                continue       # must not break /debug/vars
            if not vals:
                continue
            sect = out.setdefault(module, {})
            for k, v in vals.items():
                sect[k] = sect.get(k, 0) + int(v)
        return out


# process-wide registry (the reference's statistics singletons)
GLOBAL = Statistics()


def _failpoint_hits() -> dict:
    from opengemini_tpu_torch.utils import failpoint

    return failpoint.all_hits()


# failpoint hit counts ride every snapshot (/debug/vars): which armed
# sites actually fired
GLOBAL.register_provider("failpoints", _failpoint_hits)


# -- latency histograms ------------------------------------------------------
# Fixed log2 buckets over nanoseconds: bounds 2^10 ns (~1us) .. 2^35 ns
# (~34 s), 26 finite buckets and an overflow bucket, the reference's
# layout.

_H_LO = 10                      # first bound: 2^10 ns
_NBOUNDS = 26                   # bounds 2^10 .. 2^35

# histogram arming: OGT_TRACE=0 turns every observe() into one global
# read; unset or 1 keeps them armed
_OBS_ON = os.environ.get("OGT_TRACE", "") != "0"


class Histogram:
    """Fixed-bucket latency histogram. observe_ns computes the bucket
    outside the lock and holds it for three int updates; the lock keeps
    concurrent counts exact."""

    __slots__ = ("name", "labels", "_lock", "counts", "count", "sum_ns",
                 "unit")

    def __init__(self, name: str, labels: tuple = (),
                 unit: str = "seconds"):
        self.name = name
        self.labels = labels  # sorted ((k, v), ...): the family identity
        self.unit = unit
        self._lock = threading.Lock()
        self.counts = [0] * (_NBOUNDS + 1)  # [+Inf] last
        self.count = 0
        self.sum_ns = 0

    def observe_ns(self, ns: int) -> None:
        if not _OBS_ON:
            return
        ns = max(int(ns), 0)
        # smallest bound >= ns: (ns-1).bit_length() rounds exact powers
        # of two down into their own bucket (le is inclusive)
        idx = min(max((ns - 1).bit_length() - _H_LO, 0), _NBOUNDS)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum_ns += ns

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self.counts), "count": self.count,
                    "sum_ns": self.sum_ns, "unit": self.unit}


_HIST_LOCK = threading.Lock()
_HISTOGRAMS: dict[tuple, Histogram] = {}


def histogram(name: str, unit: str = "seconds", **labels) -> Histogram:
    """Get or create the process-wide histogram for (name, labels);
    ``unit`` is fixed at first creation."""
    key = (name, tuple(sorted(labels.items())))
    h = _HISTOGRAMS.get(key)
    if h is None:
        with _HIST_LOCK:
            h = _HISTOGRAMS.get(key)
            if h is None:
                h = Histogram(name, key[1], unit=unit)
                _HISTOGRAMS[key] = h
    return h


def observe_ns(name: str, ns: int, **labels) -> None:
    if not _OBS_ON:
        return
    histogram(name, **labels).observe_ns(ns)


def histograms_snapshot() -> list[tuple[str, tuple, dict]]:
    """Every registered histogram as (name, labels, snapshot), sorted."""
    with _HIST_LOCK:
        items = sorted(_HISTOGRAMS.items())
    return [(name, labels, h.snapshot()) for (name, labels), h in items]
