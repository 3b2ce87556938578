"""ts-server: the single-process all-in-one server binary.

The port of ``opengemini_tpu/server/app.py`` (reference: app/ts-server,
run/run.go:38, and the app.Command lifecycle, app/command.go:39-58).

    python -m opengemini_tpu_torch.server.app -config x.toml
    python -m opengemini_tpu_torch.server.app -config x.toml -device cpu

or ``opengemini_tpu_torch.server.app.main([...])``. The server runs on
``-device`` (default ``cuda``): ``build(cfg, device=None)`` takes the
device explicitly, down to the engine, and the config has no device key.

Config (TOML, the reference's lib/config style, the same file the JAX
package's ts-server reads):
    [data]
    dir = "/var/lib/opengemini-tpu"
    wal-fsync = false
    flush-threshold-mb = 64
    [http]
    bind-address = "127.0.0.1:8086"
    tls-cert = "/etc/ogt/node.crt"   # serve https (client + peer traffic)
    tls-key = "/etc/ogt/node.key"
    tls-ca = "/etc/ogt/ca.crt"       # peer-client trust (else system CAs)
    tls-insecure-skip-verify = false # self-signed lab clusters
    [device]
    mesh-axes = ["shard"]           # enables the multi-shard aggregate path
    mesh-devices = 0                # 0/absent = every visible CUDA device
    coordinator-address = "10.0.0.1:9999"  # a mesh across processes
    num-processes = 4
    process-id = 0

SIGHUP re-reads the file and hot-applies the reloadable subset: the
services' intervals and watermarks and the ``[device]`` mesh
(``_apply_runtime_config``, ``_apply_mesh_config``).

Departure from the reference: its ``_ensure_device_backend`` probes the
accelerator in a subprocess and degrades the whole server to the CPU when
the probe fails. The port never falls back to the CPU: without a working
CUDA device ``main`` exits non-zero with a message naming the device,
unless ``-device cpu`` asked for the CPU (ROADMAP C).

``[data] enable-tag-array`` opens the engine in the tag-array write
mode; ``[flight] bind-address`` serves Arrow Flight (server/flight.py,
started by ``main``; pyarrow is imported when it is built); ``[services]
obs-dir`` or ``obs-url`` attaches an object store (a directory, or an
S3-compatible bucket with ``obs-token``) and runs services/obstier.py.

``[device] coordinator-address``, ``num-processes`` and ``process-id``
make this process one rank of a mesh across processes
(``_init_distributed``, the port of the reference's
``_init_jax_distributed``): one process per card (each sees its own
through ``CUDA_VISIBLE_DEVICES``), every rank started with the same
``[data]`` and the same writes, the mesh global over every rank's cards
(``mesh-devices`` counts all of them) and its merges ``torch.distributed``
collectives, NCCL for a server on the card and gloo for one started with
``-device cpu``. Every rank must receive the same queries in the same
order (multi-controller SPMD, as the reference); ``OGT_DIST_TIMEOUT_S``
(default 120) bounds a collective, so a rank out of step raises rather
than hangs.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

try:
    import tomllib  # py311+
except ModuleNotFoundError:  # pragma: no cover — exercised on py<3.11
    try:
        import tomli as tomllib  # the pre-3.11 backport, same API
    except ModuleNotFoundError:
        tomllib = None  # config loading degrades to defaults-only

from opengemini_tpu_torch.server.http import HttpService
from opengemini_tpu_torch.storage.engine import Engine
from opengemini_tpu_torch.utils import peers as peernet

DEFAULTS = {
    "data": {"dir": "./ogtpu-data", "wal-fsync": False, "flush-threshold-mb": 64},
    "http": {"bind-address": "127.0.0.1:8086"},
}


def load_config(path: str | None) -> dict:
    cfg = {k: dict(v) for k, v in DEFAULTS.items()}
    if path:
        if tomllib is None:
            raise SystemExit(
                "-config requires a TOML parser: Python >= 3.11 "
                "(tomllib) or the tomli package"
            )
        with open(path, "rb") as f:
            user = tomllib.load(f)
        for section, vals in user.items():
            cfg.setdefault(section, {}).update(vals)
    return cfg


def _configure_device_mesh(dev_cfg: dict, device=None) -> None:
    """[device] mesh-axes -> a process-wide device mesh: every dense
    batch (grid, bucketed), AggBatch and the tiled PromQL kernels then
    run over its shards (parallel/runtime.set_mesh). A config without
    mesh-axes turns the mesh off (the mesh is process-global, and a
    build() must not inherit one from an earlier build() in the same
    process)."""
    from opengemini_tpu_torch.parallel import runtime

    # joining the process group is independent of the mesh config: a
    # coordinator address alone still makes this process a rank
    _init_distributed(dev_cfg, device)
    if not dev_cfg.get("mesh-axes"):
        runtime.set_mesh(None)
        return
    with runtime.mesh_program():
        mesh = _build_mesh(dev_cfg, _mesh_devices(dev_cfg, device))
        runtime.set_mesh(mesh)
    print(f"device mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}"
          + ("" if mesh.world is None else
             f", shards {mesh.local_shards} of {mesh.size} on process "
             f"{mesh.world.rank}/{mesh.world.size}"), flush=True)


_DISTRIBUTED_UP = False


def _init_distributed(dev_cfg: dict, device=None) -> None:
    """[device] coordinator-address + num-processes + process-id -> this
    process joins the mesh's process group (torch.distributed, rank
    0 hosting its store at the coordinator address), so that make_mesh
    builds a global mesh over every rank's cards and the mesh's merges
    run as collectives. The backend follows the server's device: NCCL on
    the card (torch.cuda.set_device first), gloo on the CPU; a failed
    NCCL init raises, nothing retries on gloo. Idempotent per process."""
    global _DISTRIBUTED_UP
    coord = dev_cfg.get("coordinator-address")
    if not coord or _DISTRIBUTED_UP:
        return
    missing = [k for k in ("num-processes", "process-id")
               if dev_cfg.get(k) is None]
    if missing:
        raise SystemExit(
            "[device] coordinator-address requires "
            + " and ".join(missing))
    import datetime

    import torch
    import torch.distributed as tdist

    from opengemini_tpu_torch.parallel import runtime

    size = int(dev_cfg["num-processes"])
    rank = int(dev_cfg["process-id"])
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        backend, coll_dev = "gloo", torch.device("cpu")
    else:
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
        backend = "nccl"
        coll_dev = torch.device("cuda", torch.cuda.current_device())
        # a collective a peer never joins raises in the waiting thread
        # at the group's timeout instead of hanging it
        os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
    timeout_s = float(os.environ.get("OGT_DIST_TIMEOUT_S", "120"))
    tdist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    runtime.set_world(runtime.World(rank, size, tdist.group.WORLD, backend,
                                    coll_dev))
    _DISTRIBUTED_UP = True
    print(f"torch.distributed up: process {rank}/{size} via {coord} "
          f"({backend})", flush=True)


def _shutdown_distributed() -> None:
    """Leave the process group at the main's shutdown (an NCCL
    communicator is released before the interpreter ends, not after)."""
    global _DISTRIBUTED_UP
    if not _DISTRIBUTED_UP:
        return
    import torch.distributed as tdist

    from opengemini_tpu_torch.parallel import runtime

    runtime.set_mesh(None)
    runtime.set_world(None)
    tdist.destroy_process_group()
    _DISTRIBUTED_UP = False


def _mesh_devices(dev_cfg: dict, device=None):
    """The devices a server on `device` lays its mesh over: every
    visible CUDA device (None, make_mesh's default) for a server on the
    card; for a server on the CPU, mesh-devices shards (default 1), all
    on the CPU, as the reference's CPU tests fake host devices (across
    processes each rank offers as many, and holds its share of them)."""
    if device is not None and str(device).split(":")[0] == "cpu":
        n = int(dev_cfg.get("mesh-devices", 0)) or 1
        return ["cpu"] * n
    return None


def _build_mesh(dev_cfg: dict, devices=None):
    """mesh-axes/mesh-devices -> a Mesh over `devices` (default: the
    visible CUDA devices): the one [device] parsing boot and SIGHUP
    share, so both build the same geometry for the same file."""
    from opengemini_tpu_torch.parallel import distributed

    n = int(dev_cfg.get("mesh-devices", 0)) or None
    return distributed.make_mesh(n, tuple(dev_cfg.get("mesh-axes")),
                                 devices=devices)


def build(cfg: dict, device=None) -> HttpService:
    """The configured server, not yet started, on `device` (None: CUDA,
    which raises without one)."""
    hint_service = None
    data = cfg["data"]
    _configure_device_mesh(cfg.get("device", {}), device)
    engine = Engine(
        data["dir"], device=device,
        sync_wal=bool(data.get("wal-fsync", False)),
        flush_threshold_bytes=int(data.get("flush-threshold-mb", 64)) << 20,
        tag_arrays=bool(data.get("enable-tag-array", False)),
    )
    host, _, port = cfg["http"]["bind-address"].partition(":")
    http_cfg = cfg["http"]
    tls = None
    if http_cfg.get("tls-cert") and http_cfg.get("tls-key"):
        # [http] tls-cert/tls-key serve the listener over https
        tls = {"certfile": http_cfg["tls-cert"],
               "keyfile": http_cfg["tls-key"]}
    if tls or http_cfg.get("tls-ca") or http_cfg.get(
            "tls-insecure-skip-verify"):
        # peer clients (raft, /internal/*, registrar) speak https whenever
        # ANY tls-* key is set: a node behind a TLS-terminating proxy (no
        # serving cert of its own) still needs https to its peers
        peernet.configure_tls(
            ca_file=http_cfg.get("tls-ca") or None,
            skip_verify=bool(http_cfg.get("tls-insecure-skip-verify",
                                          False)),
        )
    else:
        # process-global, like the device mesh: a config without TLS must
        # not inherit https peer mode from an earlier build()
        peernet.reset()
    svc = HttpService(
        engine, host or "127.0.0.1", int(port or 8086),
        auth_enabled=bool(http_cfg.get("auth-enabled", False)),
        tls=tls,
    )
    meta_cfg = cfg.get("meta")
    if meta_cfg and meta_cfg.get("node-id"):
        # clustered meta plane (reference ts-meta): peers are "id@host:port"
        from opengemini_tpu_torch.meta.service import HttpTransport, MetaStore

        peers = {}
        for p in meta_cfg.get("peers", []):
            pid, sep, addr = p.partition("@")
            if not sep or not pid or ":" not in addr:
                raise ValueError(
                    f"meta.peers entries must be 'id@host:port', got {p!r}"
                )
            peers[pid] = addr
        node_id = meta_cfg["node-id"]
        token = meta_cfg.get("token", "")
        transport = HttpTransport(
            peers, token=token,
            self_addr=meta_cfg.get("advertise", cfg["http"]["bind-address"]),
        )
        svc.meta_store = MetaStore(
            node_id, sorted(set(peers) | {node_id}), transport,
            storage_path=os.path.join(engine.root, "meta.raftlog"),
            compact_threshold=int(meta_cfg.get("compact-threshold", 512)),
        )
        svc.meta_store.token = token
        svc.meta_store.attach_engine(engine)  # replicated DDL -> local engine
        svc.meta_store.attach_users(svc.users)  # replicated user commands
        svc.executor.meta_store = svc.meta_store
        if meta_cfg.get("join"):
            # passive until our conf-add commits: a joiner must never
            # self-elect off its partial seed view
            svc.meta_store.node.learner = True
        svc.meta_store.start()
        if meta_cfg.get("join"):
            # new node: ask the existing cluster's leader to add us, then
            # raft catches us up (snapshot or log) automatically
            _spawn_joiner(
                meta_cfg["join"], node_id,
                meta_cfg.get("advertise", cfg["http"]["bind-address"]), token,
            )
    flight_cfg = cfg.get("flight", {})
    if flight_cfg.get("bind-address"):
        from opengemini_tpu_torch.server.flight import FlightService

        fhost, _, fport = flight_cfg["bind-address"].partition(":")
        svc.flight = FlightService(
            engine, svc.executor, fhost or "127.0.0.1", int(fport or 8087),
            users=svc.users,
            auth_enabled=bool(cfg["http"].get("auth-enabled", False)),
        )
    cluster_cfg = cfg.get("cluster", {})
    if cluster_cfg.get("data-routing") and svc.meta_store is not None:
        from opengemini_tpu_torch.parallel.cluster import DataRouter

        meta_cfg = cfg.get("meta", {})
        advertise = meta_cfg.get("advertise", cfg["http"]["bind-address"])
        svc.router = DataRouter(
            engine, svc.meta_store, meta_cfg["node-id"], advertise,
            token=meta_cfg.get("token", ""),
            rf=int(cluster_cfg.get("replication-factor", 1)),
            write_consistency=str(
                cluster_cfg.get("write-consistency", "one")),
        )
        svc.executor.router = svc.router
        if str(cluster_cfg.get("ha-policy", "write-available")) == \
                "replication":
            # strict mode: raft-committed writes per replica group
            from opengemini_tpu_torch.parallel.datarep import DataReplication

            svc.router.datarep = DataReplication(
                svc.router, token=meta_cfg.get("token", ""))
        if svc.flight is not None:
            svc.flight.router = svc.router
        _spawn_registrar(svc.meta_store, meta_cfg["node-id"], advertise,
                         meta_cfg.get("token", ""))
        from opengemini_tpu_torch.services.hintreplay import HintReplayService

        # at rf=1 there are never hints to replay, but the same ticker
        # drives member health probes for SHOW CLUSTER
        hint_service = HintReplayService(
            svc.router, float(cluster_cfg.get("hint-interval-s", 30)))
    svc.services = _build_services(cfg, svc)
    if hint_service is not None:
        svc.services.append(hint_service)
    if svc.router is not None and svc.router.rf > 1:
        from opengemini_tpu_torch.services.antientropy import AntiEntropyService

        svc.services.append(AntiEntropyService(
            svc.router,
            float(cluster_cfg.get("anti-entropy-interval-s", 300))))
    if svc.router is not None:
        from opengemini_tpu_torch.services.migration import MigrationService

        svc.services.append(MigrationService(
            svc.router,
            float(cluster_cfg.get("migration-interval-s", 60)),
            staging_ttl_s=float(
                cluster_cfg.get("migration-staging-ttl-s", 900)),
        ))
    if svc.router is not None and svc.meta_store is not None and \
            float(cluster_cfg.get("balance-interval-s", 3600)) > 0:
        from opengemini_tpu_torch.services.balancer import BalanceService

        svc.services.append(BalanceService(
            svc.router, svc.meta_store,
            float(cluster_cfg.get("balance-interval-s", 3600)),
            min_skew_mb=int(cluster_cfg.get("balance-min-skew-mb", 64)),
            skew_ratio=float(cluster_cfg.get("balance-skew-ratio", 1.3)),
        ))
    return svc


def _spawn_registrar(meta_store, node_id: str, addr: str, token: str) -> None:
    """Register this node in the FSM data-node roster (leader-routed,
    retried until the cluster has a leader)."""
    import json as _json
    import urllib.request as _rq

    def run():
        import time as _time

        cmd = {"op": "register_node", "id": node_id, "addr": addr,
               "role": "data"}
        for _ in range(300):
            if meta_store.fsm.nodes.get(node_id, {}).get("addr") == addr:
                return  # already registered (replayed log or prior run)
            if meta_store.is_leader():
                if meta_store.propose_and_wait(cmd):
                    return
            else:
                hint = meta_store.leader_hint()
                laddr = meta_store.meta_members().get(hint or "", "")
                if laddr:
                    try:
                        req = _rq.Request(
                            peernet.url(laddr, "/cluster/register"),
                            data=_json.dumps({
                                "id": node_id, "addr": addr,
                                "role": "data", "token": token,
                            }).encode(),
                            headers={"Content-Type": "application/json"},
                            method="POST",
                        )
                        with peernet.urlopen(req, timeout=3) as r:
                            if r.status == 200:
                                return
                    except OSError:
                        pass
            _time.sleep(1)

    threading.Thread(target=run, daemon=True, name="data-register").start()


def _spawn_joiner(seed: str, node_id: str, addr: str, token: str) -> None:
    import json as _json
    import urllib.request as _rq

    def run():
        import time as _time

        target = seed
        body = {"id": node_id, "addr": addr, "token": token}
        for _ in range(120):
            try:
                req = _rq.Request(
                    peernet.url(target, "/raft/join"),
                    data=_json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with peernet.urlopen(req, timeout=3) as r:
                    if r.status == 200:
                        print(f"joined meta cluster via {target}", flush=True)
                        return
            except OSError as e:
                # a 409 from a follower carries the leader's address
                if hasattr(e, "read"):
                    try:
                        hint = _json.loads(e.read()).get("leader_addr")
                        if hint:
                            target = hint
                    except Exception:  # noqa: BLE001
                        target = seed
            _time.sleep(1)
        print("meta join failed after retries", flush=True)

    threading.Thread(target=run, daemon=True, name="meta-join").start()


def _build_services(cfg: dict, svc: HttpService) -> list:
    from opengemini_tpu_torch.services.continuous import ContinuousQueryService
    from opengemini_tpu_torch.services.downsample import DownsampleService
    from opengemini_tpu_torch.services.monitor import MonitorService
    from opengemini_tpu_torch.services.retention import RetentionService

    sc = cfg.get("services", {})
    out = [
        RetentionService(svc.engine, float(sc.get("retention-interval-s", 1800))),
        DownsampleService(svc.engine, float(sc.get("downsample-interval-s", 3600))),
        ContinuousQueryService(
            svc.engine, svc.executor, float(sc.get("cq-interval-s", 10)),
            meta_store=svc.meta_store,
        ),
    ]
    if sc.get("store-monitor", True):
        out.append(MonitorService(svc.engine, float(sc.get("monitor-interval-s", 10))))
    from opengemini_tpu_torch.services.compaction import CompactionService
    from opengemini_tpu_torch.services.stream import StreamService

    out.append(StreamService(svc.engine, float(sc.get("stream-interval-s", 5))))
    from opengemini_tpu_torch.services.rollup import RollupService

    # inert (one None check per tick) until a rollup spec is declared
    out.append(RollupService(
        svc.engine, float(sc.get("rollup-interval-s", 5))))
    from opengemini_tpu_torch.promql.rules import enabled_by_env as _rules_on
    from opengemini_tpu_torch.services.rules import RulesService

    if _rules_on():
        from opengemini_tpu_torch.promql.rules import RuleManager

        # constructed eagerly so persisted groups resume ticking after a
        # restart (the durable claim/watermark contract needs the
        # manager live before traffic); OGT_RULES=0 keeps rules_hook
        # None and every write path as it is
        svc.rules_manager = RuleManager(svc.engine, prom=svc.prom)
        out.append(RulesService(
            svc.engine, float(sc.get("rules-interval-s", 5)),
            manager=svc.rules_manager, meta_store=svc.meta_store,
            router=svc.router))
    out.append(CompactionService(
        svc.engine, float(sc.get("compact-interval-s", 600)),
        int(sc.get("compact-max-files", 4)),
    ))
    from opengemini_tpu_torch.services.scrub import ScrubService

    # background integrity scrub (block CRC verification feeding
    # quarantine + rf>1 anti-entropy repair); OGT_SCRUB=0 disables.
    # Registered on svc so /debug/ctrl?mod=scrub controls THIS instance.
    svc.scrub_service = ScrubService(
        svc.engine,
        float(sc.get("scrub-interval-s", 0) or 0) or None,
        router=svc.router,
        mb_per_tick=(int(sc["scrub-mb"]) if "scrub-mb" in sc else None),
    )
    out.append(svc.scrub_service)
    from opengemini_tpu_torch.services.subscriber import SubscriberManager

    svc.subscriber = SubscriberManager(svc.engine)
    from opengemini_tpu_torch.services.iodetector import IoDetectorService
    from opengemini_tpu_torch.services.sherlock import SherlockService

    out.append(IoDetectorService(
        svc.engine, float(sc.get("iodetector-interval-s", 30)),
        float(sc.get("iodetector-timeout-s", 10)),
        bool(sc.get("iodetector-fatal", False)),
    ))
    out.append(SherlockService(
        svc.engine, float(sc.get("sherlock-interval-s", 30)),
        float(sc.get("sherlock-mem-mb", 4096)),
        int(sc.get("sherlock-threads", 200)),
        float(sc.get("sherlock-cooldown-s", 600)),
        bool(sc.get("sherlock-tracemalloc", False)),
    ))
    if sc.get("castor-udf-dir"):
        from opengemini_tpu_torch.services.castor import load_udfs

        names = load_udfs(sc["castor-udf-dir"])
        if names:
            print(f"castor udfs loaded: {', '.join(names)}", flush=True)
    if sc.get("obs-dir") or sc.get("obs-url"):
        from opengemini_tpu_torch.services.obstier import ObsTierService

        if sc.get("obs-url"):
            # an S3-compatible bucket endpoint
            from opengemini_tpu_torch.storage.objstore import HTTPObjectStore

            store = HTTPObjectStore(
                sc["obs-url"], token=sc.get("obs-token") or None)
        else:
            from opengemini_tpu_torch.storage.objstore import FSObjectStore

            store = FSObjectStore(sc["obs-dir"])
        svc.engine.attach_object_store(store)
        out.append(ObsTierService(
            svc.engine,
            int(float(sc.get("obs-age-days", 90)) * 86400e9),
            float(sc.get("obs-interval-s", 3600)),
        ))
    if sc.get("cold-dir"):
        from opengemini_tpu_torch.services.hierarchical import HierarchicalService

        out.append(HierarchicalService(
            svc.engine, sc["cold-dir"],
            int(float(sc.get("cold-age-days", 30)) * 86400e9),
            float(sc.get("hierarchical-interval-s", 3600)),
        ))
    return out


def _apply_runtime_config(svc: HttpService, cfg: dict,
                          device=None) -> list[str]:
    """Hot-apply the reloadable subset of [services] to running services
    (reference: lib/config runtimecfg — SIGHUP re-reads the file; only
    tick intervals and watermark-style knobs change live, topology
    doesn't). Returns a list of 'service.field=value' changes."""
    sc = cfg.get("services", {})
    plans = {
        "retention": {"interval_s": ("retention-interval-s", float)},
        "downsample": {"interval_s": ("downsample-interval-s", float)},
        "continuousquery": {"interval_s": ("cq-interval-s", float)},
        "monitor": {"interval_s": ("monitor-interval-s", float)},
        "stream": {"interval_s": ("stream-interval-s", float)},
        "compaction": {"interval_s": ("compact-interval-s", float),
                       "max_files": ("compact-max-files", int)},
        "hierarchical": {"interval_s": ("hierarchical-interval-s", float)},
        "iodetector": {"interval_s": ("iodetector-interval-s", float),
                       "probe_timeout_s": ("iodetector-timeout-s", float),
                       "fatal": ("iodetector-fatal", bool)},
        "sherlock": {"interval_s": ("sherlock-interval-s", float),
                     "mem_mb_watermark": ("sherlock-mem-mb", float),
                     "thread_watermark": ("sherlock-threads", int),
                     "cooldown_s": ("sherlock-cooldown-s", float)},
        "scrub": {"interval_s": ("scrub-interval-s", float),
                  "mb_per_tick": ("scrub-mb", int)},
    }
    # two-phase: convert EVERYTHING first so a bad value rejects the whole
    # reload instead of leaving a half-applied config behind an error
    staged = []
    for s in svc.services:
        plan = plans.get(s.name)
        if not plan:
            continue
        for attr, (key, conv) in plan.items():
            if key in sc:
                staged.append((s, attr, conv(sc[key])))
    changed = []
    for s, attr, new in staged:
        if getattr(s, attr, None) != new:
            setattr(s, attr, new)
            changed.append(f"{s.name}.{attr}={new}")
    # NOTE: a shortened interval takes effect after the service's current
    # wait expires (the ticker re-reads interval_s each iteration)
    changed.extend(_apply_mesh_config(cfg.get("device", {}), device))
    return changed


def _apply_mesh_config(dev_cfg: dict, device=None,
                       devices=None) -> list[str]:
    """Hot-apply a changed [device] mesh on SIGHUP. Every cache of
    sharded tensors keys on runtime.mesh_epoch() (models/grid.py,
    models/ragged.py) and the colcache device tier reshards retained
    entries with their stale tensors donated, so a live swap reshards
    and never serves a dead mesh. A no-op when the mesh's geometry is
    unchanged (rebuilding an identical mesh would bump the epoch and
    make every cache reshard for nothing). `device` is the server's
    (see _mesh_devices); `devices` overrides the devices the mesh lays
    its shards over, as make_mesh's does. Across processes every rank
    reloads the same [device] section between the same two queries: the
    reshards move rows between the ranks over the process group."""
    import torch

    from opengemini_tpu_torch.parallel import runtime

    axes = tuple(dev_cfg.get("mesh-axes") or ())
    cur = runtime.get_mesh()
    if not axes:
        if cur is None:
            return []
        runtime.set_mesh(None)
        return ["device.mesh=off"]
    if devices is None:
        devices = _mesh_devices(dev_cfg, device)
    world = runtime.get_world()
    n = int(dev_cfg.get("mesh-devices", 0)) or (
        (len(devices) if devices is not None else torch.cuda.device_count())
        * (1 if world is None else world.size))
    if cur is not None and tuple(cur.axis_names) == axes and cur.size == n:
        return []
    # make_mesh's all_gather must not cut into a query's collectives
    with runtime.mesh_program():
        mesh = _build_mesh(dev_cfg, devices)
        runtime.set_mesh(mesh)
    return ["device.mesh="
            + str(dict(zip(mesh.axis_names, mesh.devices.shape)))]


def _require_device(device: str) -> None:
    """Refuse to start on a device that does not work: the port never
    falls back to the CPU (the reference's _ensure_device_backend
    degrades to it)."""
    import torch

    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise SystemExit(f"ts-server: bad -device {device!r}: {e}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(
            f"ts-server: device {device!r} is not available (CUDA "
            f"available: {torch.cuda.is_available()}); pass -device cpu "
            "to serve on the CPU")
    try:
        torch.ones(2, device=dev).sum().item()
    except RuntimeError as e:
        raise SystemExit(f"ts-server: device {device!r} does not work: {e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ts-server", description="opengemini-tpu all-in-one server (PyTorch port)")
    ap.add_argument("-config", default=None, help="TOML config path")
    ap.add_argument("-pidfile", default=None, help="write process id to this file")
    ap.add_argument("-device", default="cuda",
                    help="the torch device to serve on (default cuda; "
                         "cpu to run on the host)")
    args = ap.parse_args(argv)
    _require_device(args.device)
    svc = build(load_config(args.config), device=args.device)
    svc.start()
    if svc.flight is not None:
        svc.flight.start()
    for s in svc.services:
        s.start()
    stop_event = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop_event.set())

    # installed BEFORE the pidfile exists: a supervisor that reads the
    # pidfile and fires an immediate reload must not hit the default
    # SIGHUP disposition (terminate)
    def on_hup(*_):
        try:
            changed = _apply_runtime_config(svc, load_config(args.config),
                                            args.device)
            print("config reloaded: " + (", ".join(changed) or "no changes"),
                  flush=True)
        except Exception as e:  # noqa: BLE001 — a bad file must not kill us
            print(f"config reload failed: {e}", flush=True)

    signal.signal(signal.SIGHUP, on_hup)
    if args.pidfile:
        with open(args.pidfile, "w", encoding="utf-8") as f:
            f.write(str(os.getpid()))
    scheme = "https" if svc.tls_enabled else "http"
    print(f"opengemini-tpu ts-server listening on {scheme}://:{svc.port}",
          flush=True)
    stop_event.wait()
    print("shutting down", flush=True)
    for s in svc.services:
        s.stop()
    svc.subscriber.stop()
    if svc.flight is not None:
        svc.flight.stop()
    if svc.meta_store is not None:
        svc.meta_store.stop()
    if getattr(svc.router, "datarep", None) is not None:
        svc.router.datarep.stop()
    if svc.rules_manager is not None:
        svc.rules_manager.close()  # final state fsync + hook detach
    svc.stop()
    svc.engine.close()
    _shutdown_distributed()
    if args.pidfile:
        try:
            os.remove(args.pidfile)
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
