"""Self-monitoring statistics registry and latency histograms.

The port of ``opengemini_tpu/utils/stats.py``: a process-wide registry
of named counters grouped by module (``GLOBAL.incr("executor",
"grid_batches")``), served at ``/debug/vars`` (server/http.py), and
fixed-log-bucket latency Histograms (``observe_ns``), which the query
stage timing (utils/tracing.py ``record_stage``) feeds per stage.

Sections the port fills: ``executor`` (queries, rows_scanned,
grid_batches, grid_fallbacks, grid_decode_fused,
grid_decode_fallbacks), ``write`` (points), ``device`` (the device
decode's block and byte counts, the transfer byte totals, the compile
inventory's counts and, armed, the device-memory ledger's gauges:
utils/devobs.py), ``offload`` (the planner's decisions by reason and
route: query/offload.py), ``colcache`` (storage/colcache.py),
``compact`` and ``compaction`` (storage/shard.py,
services/compaction.py), ``quarantine`` (the files quarantined, and the
engines' ``files_current`` gauge) and ``query_stages`` (``<stage>_ns``
and ``<stage>_count`` per query stage). HTTP handler threads share the
registry, so every update takes its lock.

Gauge providers (``register_provider``) add live sections to every
snapshot: the failpoints' hit counts (``failpoints``), each engine's
quarantine gauge and the ledger's gauges (``device``); the providers of
one module sum their shared keys. The resource governor's provider
(``governor``) answers {} while the governor is disabled, so an
ungoverned /debug/vars has no such section.

``render_prometheus`` exports every counter and gauge section and every
histogram in the Prometheus text format 0.0.4 under ``ogt_*`` names
(GET /metrics). ``OGT_TRACE=0`` disarms the histograms (one global read
per observe); ``set_obs_enabled`` flips that at run time.
"""

from __future__ import annotations

import os
import re
import time
from collections import defaultdict

from opengemini_tpu_torch.utils import lockdep


class Statistics:
    def __init__(self) -> None:
        self._lock = lockdep.Lock()
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

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


# process-wide registry (the reference's statistics singletons)
GLOBAL = Statistics()


def _failpoint_hits() -> dict:
    from opengemini_tpu_torch.utils import failpoint

    return failpoint.all_hits()


# failpoint hit counts ride every snapshot (/debug/vars): which armed
# sites actually fired
GLOBAL.register_provider("failpoints", _failpoint_hits)


def _governor_gauges() -> dict:
    """The resource governor's ledger and admission gauges
    (utils/governor.py); {} while it is disabled."""
    from opengemini_tpu_torch.utils import governor

    return governor.GOVERNOR.gauges()


GLOBAL.register_provider("governor", _governor_gauges)

# the lock-order validator's findings (OGT_LOCKDEP=1 only)
if lockdep.enabled():
    GLOBAL.register_provider("lockdep", lockdep.stats_snapshot)


# -- latency histograms ------------------------------------------------------
# Fixed log2 buckets over nanoseconds: bounds 2^10 ns (~1us) .. 2^35 ns
# (~34 s), 26 finite buckets and an overflow bucket, the reference's
# layout.

_H_LO = 10                      # first bound: 2^10 ns
_NBOUNDS = 26                   # bounds 2^10 .. 2^35
_BOUNDS_NS = [1 << (_H_LO + i) for i in range(_NBOUNDS)]
_BOUNDS_S = [b / 1e9 for b in _BOUNDS_NS]

# histogram arming: OGT_TRACE=0 turns every observe() into one global
# read; unset or 1 keeps them armed
_OBS_ON = os.environ.get("OGT_TRACE", "") != "0"


def obs_enabled() -> bool:
    return _OBS_ON


def set_obs_enabled(on: bool) -> None:
    global _OBS_ON
    _OBS_ON = bool(on)


class Histogram:
    """Fixed-bucket latency histogram. observe_ns computes the bucket
    outside the lock and holds it for three int updates; the lock keeps
    concurrent counts exact.

    ``unit`` selects how the fixed 2^10..2^35 bounds export: "seconds"
    (values are nanoseconds; bounds and sum scale by 1e-9) or "bytes"
    (raw bytes, bounds 1 KiB..32 GiB unscaled: the devobs transfer-size
    families)."""

    __slots__ = ("name", "labels", "_lock", "counts", "count", "sum_ns",
                 "unit")

    def __init__(self, name: str, labels: tuple = (),
                 unit: str = "seconds"):
        self.name = name
        self.labels = labels  # sorted ((k, v), ...): the family identity
        self.unit = unit
        self._lock = lockdep.Lock()
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

    def merge(self, other: "Histogram") -> None:
        """Element-wise fold of `other` into self (exact: one shared
        bucket layout)."""
        with other._lock:
            oc = list(other.counts)
            ocount, osum = other.count, other.sum_ns
        with self._lock:
            for i, c in enumerate(oc):
                self.counts[i] += c
            self.count += ocount
            self.sum_ns += osum

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self.counts), "count": self.count,
                    "sum_ns": self.sum_ns, "unit": self.unit}

    def percentile_s(self, q: float) -> float:
        return snapshot_percentile_s(self.snapshot(), q)


def snapshot_percentile_s(hsnap: dict, q: float) -> float:
    """Approximate quantile in seconds from a Histogram.snapshot(): the
    upper bound of the bucket holding the rank (the overflow bucket
    reports the last finite bound doubled). Good to one log2 bucket."""
    return snapshot_percentile(dict(hsnap, unit="seconds"), q)


def snapshot_percentile(hsnap: dict, q: float) -> float:
    """Quantile in the histogram's own unit (seconds for latency
    families, raw bytes for the transfer-size families)."""
    bounds = _BOUNDS_S if hsnap.get("unit", "seconds") == "seconds" \
        else _BOUNDS_NS
    total = hsnap["count"]
    if total <= 0:
        return 0.0
    rank = max(1, int(q / 100.0 * total + 0.5))
    acc = 0
    for i, c in enumerate(hsnap["counts"]):
        acc += c
        if acc >= rank:
            return bounds[i] if i < _NBOUNDS else bounds[-1] * 2
    return bounds[-1] * 2


_HIST_LOCK = lockdep.Lock()
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


def reset_histograms() -> None:
    with _HIST_LOCK:
        _HISTOGRAMS.clear()


# -- Prometheus text-format export (GET /metrics) ----------------------------
# every counter and gauge section of the registry plus the histograms,
# under ogt_* names, text format 0.0.4

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

# registry keys with an explicit stable spelling; every other key
# derives as ogt_<module>_<key>
_RENAMES = {
    ("write", "points"): ("ogt_write_rows_total", "counter"),
}


def _san(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_san(str(k))}="{_esc_label(str(v))}"'
                     for k, v in labels)
    return "{" + inner + "}"


def _fmt_val(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus(version: str = "") -> str:
    """The whole registry as Prometheus text. Two registry keys that
    sanitize to one family name keep the first (a duplicate TYPE line
    fails a strict scraper); histogram families share one TYPE header
    across their label sets."""
    lines: list[str] = []
    if version:
        lines.append("# HELP ogt_build_info build metadata")
        lines.append("# TYPE ogt_build_info gauge")
        lines.append(
            f'ogt_build_info{{version="{_esc_label(version)}"}} 1')
    lines.append("# HELP ogt_uptime_seconds process uptime")
    lines.append("# TYPE ogt_uptime_seconds gauge")
    lines.append(
        f"ogt_uptime_seconds "
        f"{_fmt_val(time.perf_counter() - GLOBAL.started_pc)}")

    seen: set[str] = {"ogt_build_info", "ogt_uptime_seconds"}
    snap = GLOBAL.snapshot()
    for module in sorted(snap):
        sect = snap[module]
        for key in sorted(sect):
            val = sect[key]
            if not isinstance(val, (int, float)):
                continue
            renamed = _RENAMES.get((module, key))
            if renamed:
                fam, typ = renamed
            else:
                fam = _san(f"ogt_{module}_{key}")
                typ = "counter" if key.endswith("_total") else "gauge"
            if fam in seen:
                continue
            seen.add(fam)
            lines.append(f"# TYPE {fam} {typ}")
            lines.append(f"{fam} {_fmt_val(val)}")

    prev_fam = None
    skip_fam = None
    for name, labels, hsnap in histograms_snapshot():
        fam = _san(f"ogt_{name}")
        if fam == skip_fam:
            continue
        if fam != prev_fam:
            if fam in seen:  # name collision with a scalar family
                skip_fam = fam
                continue
            seen.add(fam)
            lines.append(f"# TYPE {fam} histogram")
            prev_fam = fam
        seconds = hsnap.get("unit", "seconds") == "seconds"
        bounds = _BOUNDS_S if seconds else _BOUNDS_NS
        acc = 0
        for i, c in enumerate(hsnap["counts"]):
            acc += c
            le = ("+Inf" if i == _NBOUNDS
                  else repr(bounds[i]) if seconds else str(bounds[i]))
            lab = _fmt_labels(tuple(labels) + (("le", le),))
            lines.append(f"{fam}_bucket{lab} {acc}")
        lab = _fmt_labels(labels)
        total = hsnap["sum_ns"] / 1e9 if seconds else hsnap["sum_ns"]
        lines.append(f"{fam}_sum{lab} {_fmt_val(total)}")
        lines.append(f"{fam}_count{lab} {hsnap['count']}")
    return "\n".join(lines) + "\n"
