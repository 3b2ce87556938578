"""Adaptive host/device offload planner: the devobs telemetry as a
per-stage cost model.

The port of ``opengemini_tpu/query/offload.py``. The route of the
encoded cold scan (models/grid.py: decode on the card through kernels
4, 5 and 3, or on the host and scatter) is a planner decision fed by
measured walls:

  cost model   per (kernel, geometry) one record per candidate route
      (host / device / mesh): sample count, the cold first-run wall and
      a warm EWMA. A route without measurements estimates from a byte
      hint at the measured ``device-decode`` H2D throughput (a fixed
      default without measurements, which reduces the comparison to the
      plain byte inequality), then from the kernel-wide per-cell
      aggregate; else it is not estimable.

  decision     decide() picks the route per stage:
      prior    the static gate's choice, verbatim: while the incumbent
               has fewer than `min_samples` samples, whenever the
               planner is off (`OGT_OFFLOAD=0`), and on ties. A cold
               planner makes exactly the static choices; both routes
               give the same answers, so it is the same result.
      amortize a geometry that never ran on the static device route
               stays on the host until its recurrence covers the
               family's measured first-run wall (compile_s <= amortize
               x host_cost x uses), then waits for the background
               pre-warmer ("prewarm"). Inert with no measured walls
               (devobs disarmed: utils/devobs.py defines a "compile" on
               the card).
      explore  once a geometry has recurred more than `explore_after`
               times, one trial of a candidate with fewer than
               `min_samples` samples, gated by the same amortization.
      model    every candidate estimable: argmin of the estimates, ties
               to the static choice.

  observation  call sites time the routed stage and feed observe(); a
      frozen planner (ctrl freeze=1) drops samples and stops exploring.

  pre-warm     sites register zero-argument builders per (kernel,
      geometry); a builder runs its site once on zeros of the plan's
      shapes (never on a query's tensors). prewarm_once() runs the top-K
      by inventory hits and arms the recompile tripwire.
      `OGT_OFFLOAD_PREWARM=1` sweeps on a background thread.

Decisions land in the per-query tracker (routes per stage in
/debug/queries), the bounded decision ring and the model in
/debug/device's `planner` section, and `ogt_offload_*` counters in
/metrics. `POST /debug/ctrl?mod=offload` arms, clears, freezes, forces
and tunes it live. The "mesh" route joins a site's candidates once a
device mesh is set (parallel/runtime.py): the grid decode
(models/grid.py), the tiled PromQL kernels (promql/engine.py) and the
label gather (index/labels.py) offer it, and it is their static prior
where the reference's is. On a rank of a mesh across processes a site
that offers "mesh" takes its static route: every rank must take the
same route's collectives, which each rank's own walls could not ensure.

Knobs: OGT_OFFLOAD (0 = static gates), OGT_OFFLOAD_MIN_SAMPLES (2),
OGT_OFFLOAD_EXPLORE_AFTER (3), OGT_OFFLOAD_AMORTIZE (4.0),
OGT_OFFLOAD_EWMA (0.3), OGT_OFFLOAD_RING (128), OGT_OFFLOAD_FORCE
(host/device), OGT_OFFLOAD_PREWARM, OGT_OFFLOAD_PREWARM_TOPK (4),
OGT_OFFLOAD_PREWARM_S (5.0). OGT_PROM_HOST_KERNELS resolves here too
(once, ctrl-reloadable) for the PromQL engine.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict, deque

from opengemini_tpu_torch.utils import lockdep
from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

ROUTES = ("host", "device", "mesh")

_ON = os.environ.get("OGT_OFFLOAD", "1") not in ("", "0")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# resolved ONCE at import, for the PromQL engine (not ported yet): "" =
# auto (a CPU backend answers host), "1"/"0" force.  Hot-reloadable via /debug/ctrl?mod=offload.
_PROM_HOST_KERNELS = os.environ.get("OGT_PROM_HOST_KERNELS", "")

# forced route for A/B work (bench legs, forced-all-host vs
# forced-all-device): decide() answers this route whenever it is a
# candidate, and gate_prior() stands aside for it
_FORCE = os.environ.get("OGT_OFFLOAD_FORCE", "") or None

# model-state bound: past this many live (kernel, geometry) records the
# oldest is evicted (a fleet churning thousands of distinct geometries
# is exactly the workload the static priors serve fine)
_GEO_MAX = 512

# unmeasured-transfer prior: one fixed throughput for EVERY route, so a
# byte-hinted comparison with zero measurements reduces to the exact
# byte inequality the static gates used
_DEFAULT_BYTES_PER_S = 1 << 30


def enabled() -> bool:
    return _ON


def set_enabled(on: bool) -> None:
    global _ON
    _ON = bool(on)


def force_route() -> str | None:
    return _FORCE


def set_force(route: str | None) -> None:
    global _FORCE
    if route is not None and route not in ROUTES:
        raise ValueError(f"bad forced route {route!r} (want one of "
                         f"{'/'.join(ROUTES)} or none)")
    _FORCE = route


def prom_host_kernels_mode() -> str:
    """The resolved OGT_PROM_HOST_KERNELS override: "1" pins the tiled
    kernels to host numpy, "0" pins them off-host, "" auto (backend
    decides).  One mechanism: the engine's _host_kernels() static
    default AND the planner's candidate pruning both read this."""
    return _PROM_HOST_KERNELS


def set_prom_host_kernels_mode(mode: str) -> None:
    global _PROM_HOST_KERNELS
    if mode in ("auto", "none"):
        mode = ""
    if mode not in ("", "0", "1"):
        raise ValueError(f"bad host_kernels mode {mode!r} "
                         "(want 0, 1, or auto)")
    _PROM_HOST_KERNELS = mode


def geo_key(geometry) -> str:
    """Stable string key for a geometry — matches str(geometry) so the
    planner's keys line up with the devobs inventory's."""
    return str(geometry)


def _geo_cells(geometry) -> int:
    """Product of the numeric extents in a geometry (nested tuples
    flattened, non-numeric entries like dtype strings ignored) — the
    size proxy that lets one kernel-wide PER-CELL cost aggregate prior
    geometries of very different scales: a heavy scan's samples must
    not make every tiny dashboard shape look expensive."""
    n = 1
    stack = [geometry]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif not isinstance(x, bool) and hasattr(x, "__index__"):
            v = int(x)
            if v > 0:
                n *= v
    return n


def _world_set() -> bool:
    """Whether this process is one rank of a mesh across processes
    (parallel/runtime.py)."""
    from opengemini_tpu_torch.parallel import runtime

    return runtime.get_world() is not None


class _Route:
    """Per-route sample record: cold first run (carries compile +
    first-touch transfer), warm EWMA of the rest."""

    __slots__ = ("count", "cold_s", "ewma_s", "last_s")

    def __init__(self) -> None:
        self.count = 0
        self.cold_s = None
        self.ewma_s = None
        self.last_s = None

    def add(self, seconds: float, alpha: float) -> None:
        seconds = max(0.0, float(seconds))
        self.count += 1
        self.last_s = seconds
        if self.count == 1:
            self.cold_s = seconds
            self.ewma_s = seconds
        elif self.count == 2:
            # the cold sample carries the compile + first-touch
            # transfers: the first WARM sample replaces it outright so
            # the warm estimate is not compile-poisoned for the next
            # hundred decisions (cold cost is amortization's job)
            self.ewma_s = seconds
        else:
            self.ewma_s = self.ewma_s * (1.0 - alpha) + seconds * alpha

    def doc(self) -> dict:
        return {
            "count": self.count,
            "cold_ms": None if self.cold_s is None
            else round(self.cold_s * 1e3, 3),
            "ewma_ms": None if self.ewma_s is None
            else round(self.ewma_s * 1e3, 3),
            "last_ms": None if self.last_s is None
            else round(self.last_s * 1e3, 3),
        }


class Planner:
    """The process-wide offload planner (GLOBAL below)."""

    def __init__(self) -> None:
        self._lock = lockdep.Lock()
        self._geo: OrderedDict[tuple, dict] = OrderedDict()
        self._kernel_routes: dict[str, dict[str, _Route]] = {}
        self._ring: deque = deque(
            maxlen=max(16, _env_int("OGT_OFFLOAD_RING", 128)))
        self._frozen = False
        self.min_samples = max(1, _env_int("OGT_OFFLOAD_MIN_SAMPLES", 2))
        self.explore_after = max(
            0, _env_int("OGT_OFFLOAD_EXPLORE_AFTER", 3))
        self.amortize = max(0.0, _env_float("OGT_OFFLOAD_AMORTIZE", 4.0))
        self.ewma = min(1.0, max(
            0.01, _env_float("OGT_OFFLOAD_EWMA", 0.3)))

    # -- knobs ----------------------------------------------------------

    def configure(self, min_samples: int | None = None,
                  explore_after: int | None = None,
                  amortize: float | None = None,
                  ewma: float | None = None) -> None:
        with self._lock:
            if min_samples is not None:
                self.min_samples = max(1, int(min_samples))
            if explore_after is not None:
                self.explore_after = max(0, int(explore_after))
            if amortize is not None:
                self.amortize = max(0.0, float(amortize))
            if ewma is not None:
                self.ewma = min(1.0, max(0.01, float(ewma)))

    def frozen(self) -> bool:
        return self._frozen

    def set_frozen(self, on: bool) -> None:
        with self._lock:
            self._frozen = bool(on)

    def clear(self) -> None:
        """Drop the model and the decision ring (ctrl clear=1, tests)."""
        with self._lock:
            self._geo.clear()
            self._kernel_routes.clear()
            self._ring.clear()

    # -- model ----------------------------------------------------------

    def _state_locked(self, kernel: str, geo: str) -> dict:
        key = (kernel, geo)
        g = self._geo.get(key)
        if g is None:
            if len(self._geo) >= _GEO_MAX:
                self._geo.popitem(last=False)
                _STATS.incr("offload", "state_evictions_total")
            g = self._geo[key] = {"uses": 0, "routes": {}}
        return g

    def _estimate_locked(self, g: dict, kernel: str, route: str,
                         bytes_hint: dict | None,
                         cells: int) -> float | None:
        """Warm per-use cost estimate for one route, best data first:
        this geometry's measurements, then a byte hint at measured
        throughput, then the kernel-wide PER-CELL aggregate scaled to
        this geometry's cell count (a new geometry of a known kernel
        inherits the family's typical per-cell cost, not the absolute
        wall of whatever scale happened to be measured first)."""
        r = g["routes"].get(route)
        if r is not None and r.count >= 1:
            return r.ewma_s
        if bytes_hint is not None and route in bytes_hint:
            return bytes_hint[route] / _measured_throughput()
        kr = self._kernel_routes.get(kernel, {}).get(route)
        if kr is not None and kr.count >= 1:
            return kr.ewma_s * cells
        return None

    def observe(self, kernel: str, geometry, route: str,
                seconds: float) -> None:
        """One measured wall sample for the routed stage.  Dropped when
        the planner is off (zero-overhead pass-through) or frozen (the
        pinned model must not drift during an A/B).  Feeds both the
        per-geometry record and the kernel-wide PER-CELL aggregate (the
        prior for geometries not yet seen)."""
        if not _ON or self._frozen:
            return
        with self._lock:
            g = self._state_locked(kernel, geo_key(geometry))
            r = g["routes"].get(route)
            if r is None:
                r = g["routes"][route] = _Route()
            r.add(seconds, self.ewma)
            kr = self._kernel_routes.setdefault(kernel, {}).get(route)
            if kr is None:
                kr = self._kernel_routes[kernel][route] = _Route()
            kr.add(seconds / _geo_cells(geometry), self.ewma)
        _STATS.incr("offload", "observations_total")

    def decide(self, kernel: str, geometry, candidates, static: str,
               stage: str | None = None,
               bytes_hint: dict | None = None) -> str:
        """Pick the route for one stage.  `static` is the pre-planner
        gate's choice and is returned verbatim whenever the planner is
        off, the model is cold, or the estimates tie — the bit-identity
        contract.  `bytes_hint` maps routes to their transfer byte
        volume when the call site knows it (the decode gates), giving
        unmeasured routes a throughput-based prior estimate."""
        if _FORCE is not None and _FORCE in candidates:
            _STATS.incr("offload", "forced_total")
            self._note_tracker(stage or kernel, _FORCE)
            return _FORCE
        if not _ON or len(candidates) <= 1:
            return static
        if "mesh" in candidates and _world_set():
            # across processes every rank must take a mesh route's
            # collectives, and each rank's own walls could route it
            # apart from the others: the static route, on every rank
            return static
        geo = geo_key(geometry)
        cells = _geo_cells(geometry)
        with self._lock:
            g = self._state_locked(kernel, geo)
            if not self._frozen:
                g["uses"] += 1
            uses = g["uses"]
            est = {c: self._estimate_locked(g, kernel, c, bytes_hint,
                                            cells)
                   for c in candidates}
            inc = g["routes"].get(static)
            inc_n = inc.count if inc is not None else 0
            route, reason = static, "prior"
            amort = self._amortize_locked(
                kernel, geo, g, candidates, static, est, uses)
            if amort is not None:
                route, reason = amort
            elif inc_n >= self.min_samples:
                if not self._frozen:
                    route, reason = self._explore_locked(
                        kernel, g, candidates, static, est, uses)
                if reason == "prior":
                    route, reason = self._model_locked(
                        candidates, static, est)
                if (route != "host" and route != static
                        and not self._frozen):
                    rr = g["routes"].get(route)
                    if ((rr is None or rr.count == 0)
                            and (kernel, geo) not in _pw_warm
                            and _compile_estimate_s(kernel) > 0.0):
                        # the flip away from the static host route is
                        # justified, but this geometry's device program
                        # never compiled: no query pays that first
                        # compile inline — stay on the host and hand
                        # the compile to the background pre-warmer
                        route, reason = "host", "prewarm"
            rec = {
                "kernel": kernel, "geometry": geo,
                "route": route, "reason": reason, "uses": uses,
                "est_ms": {c: None if e is None else round(e * 1e3, 3)
                           for c, e in est.items()},
            }
            if stage:
                rec["stage"] = stage
            self._ring.append(rec)
        if reason == "prewarm" and not self._frozen:
            _request_prewarm(kernel, geo)
        _STATS.incr("offload", "decisions_total")
        _STATS.incr("offload", reason + "_total")
        if route in ROUTES:
            _STATS.incr("offload", "route_" + route + "_total")
        self._note_tracker(stage or kernel, route)
        return route

    def _amortize_locked(self, kernel, geo, g, candidates, static, est,
                         uses):
        """Up-front amortization for a geometry that has NEVER run on
        the static device/mesh route: its first run pays the kernel
        family's measured compile wall, so stay on the host until the
        observed recurrence covers it (C <= amortize x per-use x uses)
        — and even then, stay on the host until the BACKGROUND
        pre-warmer has compiled the program ("prewarm"): no query ever
        pays a first compile inline.  Returns None to let the normal
        prior/explore/model flow decide: when the static route is the
        host, when the geometry already compiled (its first sample
        exists, or the pre-warmer marked it warm), or when the model is
        truly cold (no compile data anywhere — the bit-identity
        contract says a cold planner must mirror the static gates
        exactly)."""
        if static == "host" or "host" not in candidates:
            return None
        r = g["routes"].get(static)
        if r is not None and r.count >= 1:
            return None
        comp = _compile_estimate_s(kernel)
        if comp <= 0.0:
            return None
        if (kernel, geo) in _pw_warm:
            return None
        per_use = est.get("host")
        if per_use is None:
            # No host data yet for this kernel: assume a 1ms host run.
            # The very first amortize->host decision produces a real
            # host sample, so this default decides one routing at most.
            per_use = 1e-3
        if comp > self.amortize * max(per_use, 1e-9) * uses:
            return "host", "amortize"
        return "host", "prewarm"

    def _explore_locked(self, kernel, g, candidates, static, est, uses):
        """ONE trial of the least-sampled unmeasured candidate — gated
        on recurrence (uses > explore_after) and on the amortization
        contract: the candidate's predicted first-run overhead (the
        kernel-family compile wall measured by devobs) spread over the
        observed recurrence must stay within `amortize` x the
        incumbent's per-use cost.  No compile data -> no predicted
        overhead -> recurrence alone gates the trial."""
        if uses <= self.explore_after:
            return static, "prior"
        under = [c for c in candidates
                 if c != static
                 and (g["routes"].get(c) is None
                      or g["routes"][c].count < self.min_samples)]
        if not under:
            return static, "prior"
        inc_est = est.get(static)
        if inc_est is None:
            return static, "prior"
        under.sort(key=lambda c: (g["routes"][c].count
                                  if c in g["routes"] else 0))
        cand = under[0]
        first_cost = (0.0 if cand == "host"
                      else _compile_estimate_s(kernel))
        if first_cost > self.amortize * max(inc_est, 1e-9) * uses:
            _STATS.incr("offload", "explore_deferred_total")
            return static, "prior"
        return cand, "explore"

    def _model_locked(self, candidates, static, est):
        """Argmin of estimated cost over the estimable candidates; ties
        (and an un-estimable field) resolve to the static choice."""
        best, best_e = static, est.get(static)
        if best_e is None:
            return static, "prior"
        for c in candidates:
            e = est.get(c)
            if e is not None and e < best_e:
                best, best_e = c, e
        return best, "model"

    @staticmethod
    def _note_tracker(stage: str, route: str) -> None:
        from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER

        _TRACKER.note_route(_TRACKER.current_qid(), stage, route)

    # -- the static decode gates, as zero-sample priors ------------------

    def gate_prior(self, kernel: str, geometry, device_bytes: int,
                   host_bytes: int, route: str = "device") -> bool:
        """The device-decode cost gates, subsumed: with NO measured
        samples for `route` on this (kernel, geometry) this is EXACTLY
        the pre-planner byte inequality (ship encoded iff the encoded
        transfer undercuts the decoded buffer it replaces).  Once the
        route has real wall samples, decide() owns the choice and the
        byte rule stops second-guessing it — one mechanism, not two."""
        if _FORCE == route:
            return True
        if _ON:
            with self._lock:
                g = self._geo.get((kernel, geo_key(geometry)))
                r = g["routes"].get(route) if g is not None else None
                if r is not None and r.count >= 1:
                    return True
        ok = int(device_bytes) < int(host_bytes)
        if not ok:
            _STATS.incr("offload", "gate_vetoes_total")
        return ok

    # -- introspection ---------------------------------------------------

    def decisions(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in reversed(self._ring)]

    def model_snapshot(self, limit: int = 64) -> list[dict]:
        with self._lock:
            rows = sorted(self._geo.items(),
                          key=lambda kv: -kv[1]["uses"])[:limit]
            return [
                {"kernel": k, "geometry": geo, "uses": g["uses"],
                 "routes": {r: st.doc() for r, st in g["routes"].items()}}
                for (k, geo), g in rows
            ]

    def debug_doc(self) -> dict:
        """The `planner` section of GET /debug/device."""
        return {
            "enabled": _ON,
            "frozen": self._frozen,
            "knobs": {
                "min_samples": self.min_samples,
                "explore_after": self.explore_after,
                "amortize": self.amortize,
                "ewma": self.ewma,
                "prom_host_kernels": _PROM_HOST_KERNELS or "auto",
                "force": _FORCE or "none",
            },
            "counters": _STATS.counters("offload"),
            "model": self.model_snapshot(),
            "decisions": self.decisions(),
            "prewarm": prewarm_status(),
        }


def _measured_throughput() -> float:
    """Measured device H2D throughput (bytes/s) across the armed
    per-site histograms, defaulting so unmeasured comparisons reduce to
    the plain byte inequality."""
    try:
        from opengemini_tpu_torch.utils.stats import histograms_snapshot

        by_site: dict[tuple, list] = {}
        for name, labels, snap in histograms_snapshot():
            if name in ("device_h2d_bytes", "device_h2d_seconds"):
                by_site.setdefault(labels, [0.0, 0.0])
                if name == "device_h2d_bytes":
                    by_site[labels][0] += snap["sum_ns"]
                else:
                    by_site[labels][1] += snap["sum_ns"] / 1e9
        nbytes = sum(v[0] for v in by_site.values())
        secs = sum(v[1] for v in by_site.values())
        if nbytes > 0 and secs > 1e-6:
            return nbytes / secs
    except Exception:  # noqa: BLE001 — a broken estimate is no estimate
        pass
    return float(_DEFAULT_BYTES_PER_S)


def _compile_estimate_s(kernel: str) -> float:
    """Predicted first-compile wall for a kernel family, from the devobs
    inventory's measured walls (prefix match: the planner's
    `grid_decode` label covers the `grid_decode_fused` /
    `grid_decode_imat` compile sites).  0.0 with no data — recurrence
    alone gates exploration then."""
    if not kernel:
        return 0.0
    from opengemini_tpu_torch.utils import devobs

    walls = []
    for k, doc in devobs.inventory().items():
        if not k.startswith(kernel):
            continue
        walls.extend(g["wall_ms"] for g in doc["geometries"]
                     if g["wall_ms"] > 0)
    if not walls:
        return 0.0
    return (sum(walls) / len(walls)) / 1e3


GLOBAL = Planner()


# -- pre-warmer ---------------------------------------------------------------

_pw_lock = lockdep.Lock()
_builders: OrderedDict[tuple, object] = OrderedDict()
_BUILDERS_MAX = 256
_pw_thread: threading.Thread | None = None
_pw_stop = threading.Event()
_pw_last: dict = {}
# flip-justified geometries move host -> device through these three
# states: the planner WANTS the compile (decide() said the recurrence
# covers it), a kick is INFLIGHT on a background thread, the key is
# WARM (program compiled; decide() may now route to the device without
# an inline first-compile).  Reads are GIL-atomic set membership; all
# transitions happen under _pw_lock.
_pw_want: set = set()
_pw_inflight: set = set()
_pw_warm: set = set()


def geometry_warm(kernel: str, geometry) -> bool:
    """Whether the pre-warmer has compiled this (kernel, geometry) —
    the planner only flips a never-run geometry onto the device once
    this is true, so no query ever pays the first compile inline."""
    return (kernel, geo_key(geometry)) in _pw_warm


def wants_prewarm(kernel: str, geometry) -> bool:
    """Whether decide() flagged this (kernel, geometry) as
    flip-justified but has no builder yet.  Call sites that can build
    the device program cheaply (the plan is already in hand) check this
    after a "host" decision and register_builder() — which kicks the
    background compile immediately."""
    key = (kernel, geo_key(geometry))
    with _pw_lock:
        return (key in _pw_want and key not in _pw_inflight
                and key not in _pw_warm)


def _request_prewarm(kernel: str, geo: str) -> None:
    """decide() said the recurrence covers the compile: kick the
    background compile if a builder is registered, else leave the want
    flag for the call site (wants_prewarm -> register_builder)."""
    key = (kernel, geo)
    with _pw_lock:
        if key in _pw_warm or key in _pw_inflight:
            return
        builder = _builders.get(key)
        if builder is None:
            _pw_want.add(key)
            return
        _pw_want.discard(key)
        _pw_inflight.add(key)
    _spawn_kick(key, builder)


def _spawn_kick(key: tuple, builder) -> None:
    def run():
        try:
            builder()
        except Exception:  # noqa: BLE001 — an advisory compile; the
            pass           # geometry just stays on the host route
        else:
            _pw_warm.add(key)
            _STATS.incr("offload", "prewarm_compiles_total")
        finally:
            with _pw_lock:
                _pw_inflight.discard(key)

    threading.Thread(target=run, name="offload-prewarm-kick",
                     daemon=True).start()


def register_builder(kernel: str, geometry, builder) -> None:
    """Register the zero-arg program builder for one (kernel, geometry)
    so the pre-warmer can compile it off the query path.  Builders are
    idempotent (a builder whose site already ran returns at once);
    the registry is bounded and keeps the most recent geometries.  A
    builder arriving for a key decide() already flagged flip-justified
    (wants_prewarm) kicks its background compile right away."""
    key = (kernel, geo_key(geometry))
    kick = False
    with _pw_lock:
        _builders.pop(key, None)
        _builders[key] = builder
        while len(_builders) > _BUILDERS_MAX:
            _builders.popitem(last=False)
        if (key in _pw_want and key not in _pw_inflight
                and key not in _pw_warm):
            _pw_want.discard(key)
            _pw_inflight.add(key)
            kick = True
    if kick:
        _spawn_kick(key, builder)
    if os.environ.get("OGT_OFFLOAD_PREWARM", "") in ("1", "true"):
        start_prewarmer()


def prewarm_once(topk: int | None = None) -> list[dict]:
    """One sweep: rank the registered builders by devobs inventory hit
    counts, compile the top-K, then mark the tripwire warm — queries
    arriving after the sweep must not compile these geometries inline.
    Returns the (kernel, geometry, ok) records of what ran."""
    from opengemini_tpu_torch.utils import devobs

    if topk is None:
        topk = max(1, _env_int("OGT_OFFLOAD_PREWARM_TOPK", 4))
    hits: dict[tuple, int] = {}
    for k, doc in devobs.inventory().items():
        for g in doc["geometries"]:
            hits[(k, g["geometry"])] = hits.get(
                (k, g["geometry"]), 0) + g["hits"]
    with _pw_lock:
        ranked = sorted(_builders.items(),
                        key=lambda kv: -hits.get(kv[0], 0))[:topk]
    ran = []
    for (kernel, geo), builder in ranked:
        rec = {"kernel": kernel, "geometry": geo,
               "hits": hits.get((kernel, geo), 0), "ok": True}
        try:
            builder()
            _STATS.incr("offload", "prewarm_compiles_total")
            _pw_warm.add((kernel, geo))
        except Exception as e:  # noqa: BLE001 — one bad builder must
            rec["ok"] = False    # not starve the rest of the sweep
            rec["error"] = f"{type(e).__name__}: {e}"
        ran.append(rec)
    devobs.mark_warm()
    with _pw_lock:
        _pw_last.clear()
        _pw_last.update(ran=len(ran),
                        ok=sum(1 for r in ran if r["ok"]))
    return ran


def start_prewarmer(interval_s: float | None = None) -> bool:
    """Start the background sweep thread (idempotent).  Returns whether
    a new thread started."""
    global _pw_thread
    if interval_s is None:
        interval_s = max(0.2, _env_float("OGT_OFFLOAD_PREWARM_S", 5.0))
    with _pw_lock:
        if _pw_thread is not None and _pw_thread.is_alive():
            return False
        _pw_stop.clear()

        def run():
            while not _pw_stop.wait(interval_s):
                try:
                    prewarm_once()
                except Exception:  # noqa: BLE001 — the warmer is advisory
                    pass

        _pw_thread = threading.Thread(
            target=run, name="offload-prewarm", daemon=True)
        _pw_thread.start()
    return True


def stop_prewarmer() -> None:
    global _pw_thread
    _pw_stop.set()
    t = _pw_thread
    if t is not None:
        t.join(timeout=2)
    _pw_thread = None


def prewarm_status() -> dict:
    with _pw_lock:
        return {
            "registered": len(_builders),
            "warm": len(_pw_warm),
            "wanted": len(_pw_want),
            "inflight": len(_pw_inflight),
            "thread_alive": (_pw_thread is not None
                             and _pw_thread.is_alive()),
            "last": dict(_pw_last),
        }


def reset() -> None:
    """Test hygiene: model, ring, builders, frozen flag, and the resolved
    host-kernels override back to the environment's answer."""
    global _PROM_HOST_KERNELS, _FORCE
    GLOBAL.clear()
    GLOBAL.set_frozen(False)
    stop_prewarmer()
    with _pw_lock:
        _builders.clear()
        _pw_last.clear()
        _pw_want.clear()
        _pw_inflight.clear()
        _pw_warm.clear()
    _PROM_HOST_KERNELS = os.environ.get("OGT_PROM_HOST_KERNELS", "")
    _FORCE = os.environ.get("OGT_OFFLOAD_FORCE", "") or None
