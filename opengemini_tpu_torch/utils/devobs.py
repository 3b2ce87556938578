"""Device-runtime telemetry: compile, transfer and device-memory
accounting for the CUDA tier, and the capability probe.

The port of ``opengemini_tpu/utils/devobs.py``. One arming model, as the
reference's: ``OGT_DEVOBS=1``, or ``/debug/ctrl?mod=devobs&arm=1`` at
run time. Answers are the same armed or not.

  compile accounting   PyTorch runs eagerly and the kernels are built
      once per process, so the port has no program per geometry. A
      "compile" here is defined so:

      - a site's FIRST run at a (kernel, geometry) in this process is
        its compile (``first_run``): it is counted always
        (``device/compiles_total``, the per-(kernel, geometry)
        inventory, the bounded recent-compile ring, the tripwire);
      - armed, its wall is measured: CUDA events around the first run,
        then a synchronize (perf_counter on the CPU). The wall lands on
        the inventory record, the ring entry, the
        ``device_compile_seconds`` histogram and the running query's
        ``device_compile`` stage;
      - later runs are ``note_use`` (the recurrence count the offload
        planner and the pre-warmer rank by), their launch walls, armed,
        the query's ``device_exec`` stage;
      - disarmed, walls stay 0, so the planner's amortize and prewarm
        rules stay inert exactly as the reference's do without
        ``OGT_DEVOBS=1`` (query/offload.py);
      - the ``nvcc`` build of each ``csrc/*.cu`` is an inventory entry of
        its own, ``build:<source stem>`` (``note_build``), with its
        build wall, recorded armed or not. The planner never reads
        those: a build happens once a process, whatever the route.

      The tripwire: ``mark_warm`` says "everything is compiled now"; a
      first run after it counts ``recompiles_after_warm_total``. A
      second compile of one (kernel, geometry) counts
      ``repeat_compiles_total``.

  transfer accounting  ``note_transfer(direction, site, nbytes,
      seconds, mesh)`` always counts ``device/{h2d,d2h}_bytes_total``;
      armed it adds the per-site ``device_{h2d,d2h}_{bytes,seconds}``
      histograms and the ``device_transfer`` stage. ``fetch_np`` is
      ``Tensor.cpu()`` with d2h accounting (site ``result-fetch``).

  device-memory ledger every retained device buffer registers (owner,
      nbytes): the decoded-column cache's device tier
      (storage/colcache.py). Entries anchor to their holder with
      ``weakref.finalize``, so a dropped holder never leaks a row.
      Armed only: ``register`` answers None disarmed.

  capability probe     ``probe(device)`` runs kernel 6
      (``cuda_segment.probe_count``, the masked row count of the 8 x 8
      all-ones int8 matrix) once per process and device type; the
      device decode calls it before it routes the widen and bit-unpack
      steps through kernels 4 and 5, and a probe that fails or counts
      wrong RAISES there. ``backend_capabilities`` reports the same
      probe as ``cuda_kernels`` ({"supported", "reason"}, the shape of
      the reference's ``pallas`` key).

``start_profile`` runs one ``torch.profiler`` capture for N seconds on
a background thread (one at a time; the profiler starts and stops on
that thread) and writes a Chrome trace into its directory.
``debug_doc`` is the GET /debug/device payload; its ``mesh`` section
says whether a device mesh is configured (parallel/runtime.py), its
size and its epoch.

Knobs: OGT_DEVOBS (1 = armed), OGT_DEVOBS_RING (recent-compile ring
bound, default 256).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager

import numpy as _np
import torch

from opengemini_tpu_torch.utils.stats import GLOBAL as _STATS

_ON = os.environ.get("OGT_DEVOBS", "") in ("1", "true")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


_RING_MAX = max(16, _env_int("OGT_DEVOBS_RING", 256))

# geometry-inventory bound per kernel: past this only the count grows
_GEOMETRIES_MAX = 512

_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_MAX)
_inventory: dict[str, dict] = {}   # kernel -> {compiles, geometries: {},
#                                    geometry_overflow, repeats}
_warm_marked = False
_compiles_since_warm = 0
_compile_wall_ns = 0               # armed-only accumulation
_started_pc = time.perf_counter()
# (kernel, geometry) pairs whose site has run in this process: the
# port's program cache (reset() keeps it, as the reference's compiled
# programs outlive its reset)
_ran: set = set()

# the ring and inventory entries of the last compile noted on this
# thread: the first run's wall, measured right after, lands on them
_tls = threading.local()


def enabled() -> bool:
    return _ON


def set_enabled(on: bool) -> None:
    global _ON
    _ON = bool(on)


def _note_stage(name: str, ns: int) -> None:
    """Attribute device time to the running query (tracker stages ->
    /debug/queries) and the cumulative stage stats (query_stages)."""
    from opengemini_tpu_torch.utils import tracing
    from opengemini_tpu_torch.utils.querytracker import GLOBAL as _TRACKER

    tracing.record_stage(name, ns)
    _TRACKER.add_stage_ns(_TRACKER.current_qid(), name, ns)


# per-(family, site) histogram cache: note_transfer runs on the armed
# hot path
_hist_cache: dict[tuple, object] = {}


def _hist(family: str, site: str, unit: str, mesh: bool = False):
    key = (family, site, mesh)
    h = _hist_cache.get(key)
    if h is None:
        from opengemini_tpu_torch.utils.stats import histogram

        labels = {"site": site}
        if mesh:
            # only sharded transfers carry the mesh label, so every
            # single-device site keeps its exact label set
            labels["mesh"] = "on"
        h = _hist_cache[key] = histogram(family, unit=unit, **labels)
    return h


# -- compile accounting -------------------------------------------------------


def _mesh_epoch() -> int:
    """The device mesh's epoch (parallel/runtime.py)."""
    from opengemini_tpu_torch.parallel import runtime

    return runtime.mesh_epoch()


def note_compile(kernel: str, geometry=()) -> None:
    """Record one compile (a site's first run, or a kernel build) of
    (kernel, geometry). Always on: compiles are rare, and the inventory
    and the tripwire are what one needs when nobody armed anything."""
    global _compiles_since_warm
    geo = str(geometry)
    epoch = _mesh_epoch()
    _STATS.incr("device", "compiles_total")
    _STATS.incr("device", "compile_cache_misses")
    entry = {
        "kernel": kernel, "geometry": geo, "mesh_epoch": epoch,
        "uptime_s": round(time.perf_counter() - _started_pc, 3),
    }
    with _lock:
        geo_ent = _geo_entry_locked(kernel, geo, epoch)
        inv = _inventory[kernel]
        inv["compiles"] += 1
        if geo_ent is not None:
            if geo_ent["compiles"]:
                inv["repeats"] += 1
                entry["repeat"] = True
                _STATS.incr("device", "repeat_compiles_total")
            geo_ent["compiles"] += 1
        if _warm_marked:
            _compiles_since_warm += 1
            entry["after_warm"] = True
            _STATS.incr("device", "recompiles_after_warm_total")
        _ring.append(entry)
        _tls.kernel = kernel
        _tls.ring_entry = entry
        _tls.geo_entry = geo_ent


def _add_wall_locked(ns: int) -> None:
    ms = ns / 1e6
    ent = getattr(_tls, "ring_entry", None)
    if ent is not None:
        ent["wall_ms"] = round(ent.get("wall_ms", 0.0) + ms, 3)
    geo = getattr(_tls, "geo_entry", None)
    if geo is not None:
        # the offload planner's compile-cost prior reads this per
        # (kernel, geometry) from inventory()
        geo["wall_ms"] = round(geo.get("wall_ms", 0.0) + ms, 3)


def note_compile_wall(ns: int) -> None:
    """Armed: attribute a measured first-run wall to the compile this
    thread noted last."""
    if not _ON:
        return
    global _compile_wall_ns
    ns = int(ns)
    kernel = getattr(_tls, "kernel", None) or "other"
    with _lock:
        _compile_wall_ns += ns
        _add_wall_locked(ns)
    from opengemini_tpu_torch.utils.stats import observe_ns

    observe_ns("device_compile_seconds", ns, kernel=kernel)
    _note_stage("device_compile", ns)


def note_build(kernel: str, geometry, seconds: float) -> None:
    """One kernel library build (``build:<stem>``) with its wall, kept on
    its inventory record whether armed or not."""
    note_compile(kernel, geometry)
    with _lock:
        _add_wall_locked(int(seconds * 1e9))


def has_run(kernel: str, geometry=()) -> bool:
    """Whether the site ran at (kernel, geometry) in this process."""
    return (kernel, str(geometry)) in _ran


@contextmanager
def first_run(kernel: str, geometry=(), device=None):
    """Wrap one run of a site. The first run at (kernel, geometry) in
    this process is its compile: counted (note_compile) and, armed,
    timed with CUDA events around it and a synchronize (perf_counter on
    the CPU). Armed, a later run's launch wall goes to the running
    query's ``device_exec`` stage (t0/note_exec). Yields whether this
    run is the first."""
    key = (kernel, str(geometry))
    with _lock:
        first = key not in _ran
        _ran.add(key)
    if not first:
        t = t0()
        yield False
        if t:
            note_exec(t)
        return
    note_compile(kernel, geometry)
    if not _ON:
        yield True
        return
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield True
        end.record()
        end.synchronize()
        ns = int(start.elapsed_time(end) * 1e6)
    else:
        start_ns = time.perf_counter_ns()
        yield True
        ns = time.perf_counter_ns() - start_ns
    note_compile_wall(ns)


def _geo_entry_locked(kernel: str, geo: str, epoch) -> dict | None:
    """The per-(geometry, mesh-epoch) inventory record of one kernel
    (created on first sight, None past the per-kernel bound). Caller
    holds _lock."""
    inv = _inventory.get(kernel)
    if inv is None:
        inv = _inventory[kernel] = {
            "compiles": 0, "geometries": OrderedDict(),
            "geometry_overflow": 0, "repeats": 0}
    key = (geo, epoch)
    ent = inv["geometries"].get(key)
    if ent is None:
        if len(inv["geometries"]) >= _GEOMETRIES_MAX:
            inv["geometry_overflow"] += 1
            return None
        ent = inv["geometries"][key] = {
            "compiles": 0, "hits": 0, "wall_ms": 0.0}
    return ent


def note_use(kernel: str, geometry=()) -> None:
    """Record one run of (kernel, geometry): the recurrence signal the
    offload planner's amortization and the pre-warmer's top-K read."""
    with _lock:
        ent = _geo_entry_locked(kernel, str(geometry), _mesh_epoch())
        if ent is not None:
            ent["hits"] += 1


def mark_warm() -> None:
    """Arm the recompile tripwire: every compile from here on is
    flagged."""
    global _warm_marked, _compiles_since_warm
    with _lock:
        _warm_marked = True
        _compiles_since_warm = 0


def clear_warm() -> None:
    global _warm_marked, _compiles_since_warm
    with _lock:
        _warm_marked = False
        _compiles_since_warm = 0


def compiles_since_warm() -> int:
    """Compiles since mark_warm() (0 when never marked)."""
    with _lock:
        return _compiles_since_warm


def jit_inventory() -> dict:
    """Per-kernel view: compile counts, distinct geometries, repeats."""
    with _lock:
        return {
            k: {
                "compiles": v["compiles"],
                "distinct_geometries": sum(
                    1 for e in v["geometries"].values() if e["compiles"]),
                "geometry_overflow": v["geometry_overflow"],
                "repeat_compiles": v["repeats"],
            }
            for k, v in sorted(_inventory.items())
        }


def inventory() -> dict:
    """Per-(kernel, geometry) snapshot for the offload planner's cost
    model: each kernel's counts plus one record per (geometry, mesh
    epoch) with its compiles, hits (note_use) and first-run wall."""
    with _lock:
        return {
            k: {
                "compiles": v["compiles"],
                "repeat_compiles": v["repeats"],
                "geometry_overflow": v["geometry_overflow"],
                "geometries": [
                    {"geometry": geo, "mesh_epoch": epoch,
                     "compiles": e["compiles"], "hits": e["hits"],
                     "wall_ms": e["wall_ms"]}
                    for (geo, epoch), e in v["geometries"].items()
                ],
            }
            for k, v in sorted(_inventory.items())
        }


def recent_compiles() -> list[dict]:
    """Newest-first bounded ring of recent compiles."""
    with _lock:
        return [dict(e) for e in reversed(_ring)]


# -- transfer accounting ------------------------------------------------------


def note_transfer(direction: str, site: str, nbytes: int,
                  seconds: float | None = None,
                  mesh: bool = False) -> None:
    """The one chokepoint of device transfer accounting. Always counts
    ``device/<direction>_bytes_total``; armed it adds the per-site byte
    (and, given ``seconds``, latency) histograms and the running query's
    ``device_transfer`` stage. ``mesh=True`` labels a transfer made
    under a device mesh (``mesh="on"``)."""
    nbytes = int(nbytes)
    # spelled *_total so the unlabeled family name stays free for the
    # per-site histogram of the same quantity
    _STATS.incr("device", direction + "_bytes_total", nbytes)
    if not _ON:
        return
    _hist("device_" + direction + "_bytes", site, "bytes",
          mesh).observe_ns(nbytes)
    if seconds is not None:
        ns = int(seconds * 1e9)
        _hist("device_" + direction + "_seconds", site, "seconds",
              mesh).observe_ns(ns)
        _note_stage("device_transfer", ns)


def fetch_np(x, site: str = "result-fetch") -> _np.ndarray:
    """``Tensor.cpu()`` as numpy with d2h accounting (armed, with its
    wall); anything else passes through np.asarray."""
    if not isinstance(x, torch.Tensor):
        return _np.asarray(x)
    if not _ON:
        a = x.detach().cpu().numpy()
        note_transfer("d2h", site, a.nbytes)
        return a
    t0 = time.perf_counter_ns()
    a = x.detach().cpu().numpy()
    note_transfer("d2h", site, a.nbytes,
                  (time.perf_counter_ns() - t0) / 1e9)
    return a


def t0() -> int:
    """perf_counter_ns when armed, 0 disarmed: the one-branch guard of
    exec-time attribution at a launch site."""
    return time.perf_counter_ns() if _ON else 0


def note_exec(t0_ns: int) -> None:
    """Attribute the launch wall since ``t0_ns`` to the running query's
    ``device_exec`` stage."""
    _note_stage("device_exec", time.perf_counter_ns() - t0_ns)


def span_snapshot() -> dict:
    """Counters-only snapshot for per-span deltas."""
    snap = _STATS.counters("device")
    with _lock:
        wall = _compile_wall_ns
    return {
        "compiles": snap.get("compiles_total", 0),
        "compile_wall_ms": round(wall / 1e6, 3),
        "h2d_bytes": snap.get("h2d_bytes_total", 0),
        "d2h_bytes": snap.get("d2h_bytes_total", 0),
        "reshard_bytes": snap.get("reshard_bytes_total", 0),
        "recompiles_after_warm": snap.get("recompiles_after_warm_total", 0),
    }


# -- device-memory ledger -----------------------------------------------------


class DeviceLedger:
    """Registry of retained device buffers: (owner, nbytes, mesh_epoch)
    per entry. An entry registered with an ``anchor`` drops when the
    anchor is collected. The finalizer takes no lock (a GC pass can run
    it inside a ledger method that holds it): it appends the handle to
    a deque drained at the next ledger operation. Armed only:
    register() answers None disarmed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 1
        self._entries: dict[int, dict] = {}
        self._pending_drops: deque = deque()

    def _drain_locked(self) -> None:
        while True:
            try:
                handle = self._pending_drops.popleft()
            except IndexError:
                return
            self._entries.pop(handle, None)

    def register(self, owner: str, nbytes: int, mesh_epoch=None,
                 label: str = "", anchor=None) -> int | None:
        if not _ON:
            return None
        with self._lock:
            self._drain_locked()
            handle = self._next
            self._next += 1
            self._entries[handle] = {
                "owner": owner, "nbytes": int(nbytes),
                "mesh_epoch": mesh_epoch, "label": label,
            }
        if anchor is not None:
            weakref.finalize(anchor, self._pending_drops.append, handle)
        return handle

    def update(self, handle: int | None, nbytes: int | None = None,
               mesh_epoch=...) -> None:
        if handle is None:
            return
        with self._lock:
            self._drain_locked()
            ent = self._entries.get(handle)
            if ent is None:
                return
            if nbytes is not None:
                ent["nbytes"] = int(nbytes)
            if mesh_epoch is not ...:
                ent["mesh_epoch"] = mesh_epoch

    def drop(self, handle: int | None) -> None:
        if handle is None:
            return
        with self._lock:
            self._drain_locked()
            self._entries.pop(handle, None)

    def total_bytes(self) -> int:
        with self._lock:
            self._drain_locked()
            return sum(e["nbytes"] for e in self._entries.values())

    def by_owner(self) -> dict:
        """{owner: {bytes, entries, stale_epoch_entries}}: the
        /debug/device residency answer (stale: laid out for a mesh epoch
        that is no longer live)."""
        live = _mesh_epoch()
        out: dict[str, dict] = {}
        with self._lock:
            self._drain_locked()
            for e in self._entries.values():
                o = out.setdefault(e["owner"], {
                    "bytes": 0, "entries": 0, "stale_epoch_entries": 0})
                o["bytes"] += e["nbytes"]
                o["entries"] += 1
                if e["mesh_epoch"] is not None and e["mesh_epoch"] != live:
                    o["stale_epoch_entries"] += 1
        return out

    def entries(self, limit: int = 256) -> list[dict]:
        with self._lock:
            self._drain_locked()
            rows = sorted(self._entries.values(),
                          key=lambda e: -e["nbytes"])[:limit]
            return [dict(e) for e in rows]

    def clear(self) -> None:
        with self._lock:
            self._drain_locked()
            self._entries.clear()


LEDGER = DeviceLedger()


def _ledger_gauges() -> dict:
    """Stats provider: the ledger's residency gauges (module ``device``,
    ogt_device_ledger_* in /metrics) when armed; {} disarmed."""
    if not _ON:
        return {}
    out = {"ledger_bytes": LEDGER.total_bytes()}
    for owner, doc in LEDGER.by_owner().items():
        safe = "".join(c if c.isalnum() else "_" for c in owner.lower())
        out["ledger_" + safe + "_bytes"] = doc["bytes"]
        out["ledger_" + safe + "_entries"] = doc["entries"]
    return out


_STATS.register_provider("device", _ledger_gauges)


# -- capability probe ---------------------------------------------------------

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


def reset_probe() -> None:
    """Forget which devices were probed, so the next decode probes again
    (what a new process starts with)."""
    with _probe_lock:
        _probed.clear()


_caps_lock = threading.Lock()
_caps: dict | None = None


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend_capabilities(probe_now: bool = True) -> dict:
    """What this process can run, probed once: ``cuda_kernels`` is
    kernel 6's probe on the default device (the card, else the CPU's
    plain version). ``probe_now=False`` answers from the cache only
    (the /debug/device handler never runs a kernel inline)."""
    global _caps
    with _caps_lock:
        if _caps is not None:
            return _caps
    if not probe_now:
        return {"probed": False, "cuda_kernels": {
            "supported": None,
            "reason": "unprobed (cuda_kernels_supported() runs the "
                      "probe)"}}
    dev = _default_device()
    caps: dict = {"probed": True, "backend": dev.type,
                  "device_count": (torch.cuda.device_count()
                                   if dev.type == "cuda" else 1)}
    try:
        probe(dev)
        caps["cuda_kernels"] = {"supported": True, "reason": ""}
    except Exception as e:  # noqa: BLE001 — a failed probe is an answer
        caps["cuda_kernels"] = {
            "supported": False,
            "reason": f"kernel probe failed on {dev}: "
                      f"{type(e).__name__}: {e}"}
    with _caps_lock:
        _caps = caps
    return caps


def cuda_kernels_supported() -> tuple[bool, str]:
    """(supported, reason) of the kernel probe."""
    cap = backend_capabilities()["cuda_kernels"]
    return cap["supported"], cap["reason"]


# -- on-demand profiler capture ----------------------------------------------

_profile_lock = threading.Lock()
_profile = {"active": False, "dir": None, "started_uptime_s": None,
            "seconds": None, "last": None}


def start_profile(seconds: float, logdir: str | None = None) -> dict:
    """Start one torch.profiler capture of ``seconds`` (clamped to
    [0.05, 120]) on a background thread, which starts the profiler,
    sleeps, stops it and writes ``<dir>/trace.json`` (Chrome trace
    format): the profiler starts and stops on one thread. Raises
    RuntimeError while a capture is active or when the profiler does
    not start. Returns the status once the capture runs."""
    import tempfile

    seconds = min(max(float(seconds), 0.05), 120.0)
    with _profile_lock:
        if _profile["active"]:
            raise RuntimeError(
                f"profiler capture already active in {_profile['dir']}")
        if logdir is None:
            logdir = tempfile.mkdtemp(prefix="ogt-devobs-profile-")
        os.makedirs(logdir, exist_ok=True)
        _profile.update(active=True, dir=logdir, seconds=seconds,
                        started_uptime_s=round(
                            time.perf_counter() - _started_pc, 3))
    started = threading.Event()
    failed: list = []

    def _run():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — surfaced by the caller
            failed.append(e)
            with _profile_lock:
                _profile.update(active=False, last={
                    "dir": logdir, "ok": False,
                    "error": f"{type(e).__name__}: {e}"})
            started.set()
            return
        started.set()
        time.sleep(seconds)
        doc = {"dir": logdir, "seconds": seconds, "ok": True}
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        except Exception as e:  # noqa: BLE001
            doc = {"dir": logdir, "seconds": seconds, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        with _profile_lock:
            _profile.update(active=False, last=doc)

    threading.Thread(target=_run, name="devobs-profile",
                     daemon=True).start()
    started.wait(30)
    if failed:
        raise RuntimeError(f"profiler start failed: {failed[0]}")
    return profile_status()


def profile_status() -> dict:
    with _profile_lock:
        return dict(_profile)


# -- /debug/device ------------------------------------------------------------


def device_table() -> list[dict]:
    """One row per device, with the caching allocator's memory figures
    on a card (the cross-check of the ledger); the CPU answers null."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu",
                 "memory_stats": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        row = {"id": i, "platform": "gpu",
               "device_kind": torch.cuda.get_device_name(i)}
        try:
            row["memory_stats"] = {
                "bytes_in_use": torch.cuda.memory_allocated(i),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_reserved": torch.cuda.memory_reserved(i),
                "bytes_limit": torch.cuda.get_device_properties(
                    i).total_memory,
            }
        except Exception:  # noqa: BLE001 — optional per device
            row["memory_stats"] = None
        out.append(row)
    return out


def debug_doc() -> dict:
    """The GET /debug/device payload."""
    from opengemini_tpu_torch.parallel import runtime

    mesh = runtime.get_mesh()
    with _lock:
        warm = {"marked": _warm_marked,
                "compiles_since_warm": _compiles_since_warm}
        wall_ms = round(_compile_wall_ns / 1e6, 3)
    return {
        "enabled": _ON,
        # cache only: a scrape never runs the probe inline
        "capabilities": backend_capabilities(probe_now=False),
        "devices": device_table(),
        "mesh": {"configured": mesh is not None,
                 "size": getattr(mesh, "size", None),
                 "epoch": runtime.mesh_epoch()},
        "counters": _STATS.counters("device"),
        "compile_wall_ms": wall_ms,
        "jit_cache": jit_inventory(),
        "recent_compiles": recent_compiles(),
        "warm": warm,
        "ledger": {
            "total_bytes": LEDGER.total_bytes(),
            "by_owner": LEDGER.by_owner(),
            "entries": LEDGER.entries(),
        },
        "profile": profile_status(),
    }


def reset() -> None:
    """Clear the ring, the inventory, the warm mark and the compile-wall
    sum (the stats registry's counters are the registry's to reset)."""
    global _compile_wall_ns
    with _lock:
        _ring.clear()
        _inventory.clear()
        _compile_wall_ns = 0
    clear_warm()


@contextmanager
def armed(on: bool = True):
    """Scoped arm/disarm (tests, A/B legs)."""
    prev = _ON
    set_enabled(on)
    try:
        yield
    finally:
        set_enabled(prev)
